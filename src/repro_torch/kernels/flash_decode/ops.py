"""Dispatch for flash decode: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
kernel B5, or raises if it cannot.  B5 has no backward: a CUDA input
that requires a gradient raises (ROADMAP A13.6b) rather than cut the
gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.kernel import flash_decode
from repro_torch.kernels.flash_decode.ref import decode_ref


def decode(q, k_cache, v_cache, cache_len):
    """q [B,H,d]; caches [B,T,KV,d]; cache_len int32[B] → [B,H,d]."""
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, cache_len)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_cache, v_cache)):
            raise NotImplementedError("flash decode's backward on the card (kernel B5) is ROADMAP A13.6b")
        return flash_decode(q, k_cache, v_cache, cache_len)
    raise ValueError(f"no flash decode for device {q.device}")
