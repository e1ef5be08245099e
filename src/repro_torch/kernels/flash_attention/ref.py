"""Plain PyTorch attention: the function kernel B4 computes.

Counterpart of ``repro.kernels.flash_attention.ref.attention_ref`` with the
causal rule of the Pallas kernel (``flash_attention/kernel.py``: query row
i sees key column j iff i >= j, counted from the top left).  At S == T,
the only case prefill uses, that is the oracle's own rule; at S != T the
oracle aligns the diagonal bottom-right instead and the kernel and its
oracle disagree (ROADMAP C4).  Query head h reads KV head h // (H / KV).
Float32 math throughout; the output has q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q [B,S,H,d]; k, v [B,T,KV,d] → [B,S,H,d] in q.dtype."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV heads")
    group = h // kv
    k = k.float().repeat_interleave(group, dim=2)
    v = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(d)
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        scores = torch.where(rows >= cols, scores, NEG_INF)
    p = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)
