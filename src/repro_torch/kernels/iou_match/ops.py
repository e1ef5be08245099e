"""Dispatch for the IoU matrix: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel, or raises if it cannot.
"""
from __future__ import annotations

from repro_torch.kernels.iou_match.kernel import iou_matrix
from repro_torch.kernels.iou_match.ref import iou_ref


def iou(boxes_a, boxes_b):
    if boxes_a.device.type == "cpu":
        return iou_ref(boxes_a, boxes_b)
    if boxes_a.device.type == "cuda":
        return iou_matrix(boxes_a.contiguous(), boxes_b.contiguous())
    raise ValueError(f"no IoU matrix for device {boxes_a.device}")
