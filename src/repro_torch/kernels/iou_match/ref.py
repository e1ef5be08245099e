"""Plain PyTorch IoU matrix: the matcher's own ``pairwise_iou``.

It follows ``repro.core.matcher.pairwise_iou`` as the jitted reference
computes it: XLA's CPU backend fuses area_b's multiply into
``area_a + area_b`` (one FMA), so this version does the same with an exact
float32 FMA and agrees with it bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import fma32


def iou_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix f32[..., D, R] of boxes a f32[..., D, 4], b f32[..., R, 4]
    (x0, y0, x1, y1); leading axes (the multi kind's ``[Q]``) broadcast."""
    aw = torch.clamp_min(a[..., 2] - a[..., 0], 0.0)
    ah = torch.clamp_min(a[..., 3] - a[..., 1], 0.0)
    bw = torch.clamp_min(b[..., 2] - b[..., 0], 0.0)
    bh = torch.clamp_min(b[..., 3] - b[..., 1], 0.0)
    area_a = aw * ah
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = fma32(bw[..., None, :].expand(inter.shape), bh[..., None, :], area_a[..., :, None]) - inter
    return inter / torch.clamp_min(union, 1e-9)
