"""Dispatch for the Thompson choice: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel, or raises if it cannot.
"""
from __future__ import annotations

from repro_torch.kernels.thompson.kernel import thompson_choose, thompson_choose_batched
from repro_torch.kernels.thompson.ref import thompson_ref


def choose(alpha, beta, z):
    if z.device.type == "cpu":
        return thompson_ref(alpha, beta, z)
    if z.device.type == "cuda":
        return thompson_choose(alpha.contiguous(), beta.contiguous(), z.contiguous())
    raise ValueError(f"no Thompson choice for device {z.device}")


def choose_batched(alpha, beta, z):
    """Multi-query choice: alpha/beta f32[Q, M], z f32[Q, C, M] →
    (idx i32[Q, C], val f32[Q, C]) in one launch of kernel B2."""
    if z.device.type == "cpu":
        return thompson_ref(alpha, beta, z)
    if z.device.type == "cuda":
        return thompson_choose_batched(alpha.contiguous(), beta.contiguous(), z.contiguous())
    raise ValueError(f"no Thompson choice for device {z.device}")
