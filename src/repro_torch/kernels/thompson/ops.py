"""Dispatch for the Thompson choice: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel, or raises if it cannot.
"""
from __future__ import annotations

from repro_torch.kernels.thompson.kernel import (thompson_choose, thompson_choose_batched, thompson_round,
                                                 thompson_round_batched)
from repro_torch.kernels.thompson.ref import thompson_ref, thompson_round_ref


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


def choose_round(key, state, cohorts: int):
    """The whole choice of a round from its key: key int64[2] and a
    ``SamplerState`` of M chunks → (idx i32[C], val f32[C]), in one launch
    of the fused round on the card."""
    dev = state.n1.device
    if dev.type == "cpu":
        return thompson_round_ref(key, state, cohorts)
    if dev.type == "cuda":
        return thompson_round(key, state, cohorts)
    raise ValueError(f"no Thompson choice for device {dev}")


def choose_round_batched(keys, state, cohorts: int):
    """``choose_round`` for Q queries: keys int64[Q, 2], statistics [Q, M]
    → (idx i32[Q, C], val f32[Q, C]), in one launch on the card."""
    dev = state.n1.device
    if dev.type == "cpu":
        return thompson_round_ref(keys, state, cohorts)
    if dev.type == "cuda":
        return thompson_round_batched(keys, state, cohorts)
    raise ValueError(f"no Thompson choice for device {dev}")
