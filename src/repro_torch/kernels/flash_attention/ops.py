"""Dispatch for attention: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
kernel B4, or raises if it cannot (an unsupported head dim or dtype is an
error, never a fallback).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q, k, v, *, causal: bool = True):
    """q [B,S,H,d]; k, v [B,T,KV,d] → [B,S,H,d] in q.dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal)
    raise ValueError(f"no attention for device {q.device}")
