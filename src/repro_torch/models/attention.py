"""Attention entry points of the model: prefill and decode.

Counterpart of ``repro.models.attention``.  The reference evaluates both
in plain jnp (``blocked_attention``'s tiled online softmax and
``decode_attention``'s one softmax over the cache); those are the oracles
of its Pallas kernels B4 and B5, and the port routes both through its
CUDA counterparts instead: ``blocked_attention`` → kernel B4 (GQA by head
index inside the kernel, so K/V arrive un-repeated; differentiable, its
backward a kernel of its own on the card), ``decode_attention``
→ kernel B5 (no backward: under a gradient on the card it raises).  On a CPU tensor the kernels' plain versions run.  The two
agree with the reference within float tolerance, not bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as attention_ops
from repro_torch.kernels.flash_decode import ops as decode_ops


def blocked_attention(
    q: torch.Tensor,                   # [B, S, H, D]
    k: torch.Tensor,                   # [B, T, KV, D]  (not repeated)
    v: torch.Tensor,                   # [B, T, KV, D]
    *,
    causal: bool = True,
    q_offset: int = 0,
    probs_bf16: bool = False,
) -> torch.Tensor:
    """Flash attention over the whole sequence; [B, S, H, D] in q.dtype.
    Causal masking is the kernel's: row i sees column j iff i >= j."""
    if q_offset != 0:
        raise NotImplementedError("q_offset != 0 (chunked prefill) is not on the port's path")
    if probs_bf16:
        raise NotImplementedError("probs_bf16 is not on the port's path")
    return attention_ops.attention(q, k, v, causal=causal)


def decode_attention(
    q: torch.Tensor,                   # [B, 1, H, D]
    k_cache: torch.Tensor,             # [B, T, KV, D]
    v_cache: torch.Tensor,             # [B, T, KV, D]
    *,
    cache_len: torch.Tensor,
) -> torch.Tensor:
    """One query token per sequence against the cache; [B, 1, H, D].
    ``cache_len`` int32[B] on the cache's device."""
    return decode_ops.decode(q[:, 0], k_cache, v_cache, cache_len)[:, None]
