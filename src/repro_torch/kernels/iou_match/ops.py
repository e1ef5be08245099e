"""Dispatch for the IoU matrix: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel, or raises if it cannot.  ``iou`` takes one matrix's boxes
(``[D, 4]``, ``[R, 4]``) or a batch of them (``[Q, D, 4]``,
``[Q, R, 4]``), one launch either way.
"""
from __future__ import annotations

from repro_torch.kernels.iou_match.kernel import iou_matrix, iou_matrix_batched
from repro_torch.kernels.iou_match.ref import iou_ref


def iou(boxes_a, boxes_b):
    if boxes_a.device.type == "cpu":
        return iou_ref(boxes_a, boxes_b)
    if boxes_a.device.type == "cuda":
        return (iou_matrix_batched if boxes_a.dim() == 3 else iou_matrix)(boxes_a.contiguous(), boxes_b.contiguous())
    raise ValueError(f"no IoU matrix for device {boxes_a.device}")
