"""Dispatch for the Thompson choice: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel, or raises if it cannot.
"""
from __future__ import annotations

from repro_torch.kernels.thompson.kernel import thompson_choose
from repro_torch.kernels.thompson.ref import thompson_ref


def choose(alpha, beta, z):
    if z.device.type == "cpu":
        return thompson_ref(alpha, beta, z)
    if z.device.type == "cuda":
        return thompson_choose(alpha.contiguous(), beta.contiguous(), z.contiguous())
    raise ValueError(f"no Thompson choice for device {z.device}")
