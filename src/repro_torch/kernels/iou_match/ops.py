"""Dispatch for kernel B3: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel, or raises if it cannot.  ``iou`` takes one matrix's boxes
(``[D, 4]``, ``[R, 4]``) or a batch of them (``[Q, D, 4]``,
``[Q, R, 4]``), one launch either way; ``match_update`` one ring or Q of
them (a leading ``[Q]``), also one launch either way.
"""
from __future__ import annotations

from repro_torch.kernels.iou_match.kernel import iou_matrix, iou_matrix_batched
from repro_torch.kernels.iou_match.kernel import match_update as _match_update_kernel
from repro_torch.kernels.iou_match.kernel import match_update_batched
from repro_torch.kernels.iou_match.ref import MatchResult, iou_ref, match_update_ref


def iou(boxes_a, boxes_b):
    if boxes_a.device.type == "cpu":
        return iou_ref(boxes_a, boxes_b)
    if boxes_a.device.type == "cuda":
        return (iou_matrix_batched if boxes_a.dim() == 3 else iou_matrix)(boxes_a.contiguous(), boxes_b.contiguous())
    raise ValueError(f"no IoU matrix for device {boxes_a.device}")


def match_update(state, boxes, feats, valid, video_id, frame_id, chunk_id) -> MatchResult:
    """The IoU-only matcher step (``state.feat_thresh`` off) on the state's
    device."""
    dev = state.times_seen.device
    if dev.type == "cpu":
        return match_update_ref(state, boxes, feats, valid, video_id, frame_id, chunk_id)
    if dev.type == "cuda":
        fn = match_update_batched if state.times_seen.dim() == 2 else _match_update_kernel
        return fn(state, boxes, feats, valid, video_id, frame_id, chunk_id)
    raise ValueError(f"no matcher step for device {dev}")
