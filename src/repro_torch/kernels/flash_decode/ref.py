"""Plain PyTorch flash decode: the function kernel B5 computes.

Counterpart of ``repro.kernels.flash_decode.ref.decode_ref``, which is
``repro.models.attention.decode_attention``: GQA by reshape (query head
h = kv·G + g reads KV head kv), positions at or beyond ``cache_len[b]``
masked to -1e30, one softmax over the whole cache in float32 with the
``max(l, 1e-30)`` guard.  With ``cache_len = 0`` every score is -1e30, so
every weight is exp(0) = 1 and the output is the mean of V over all T
positions, as in the reference.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               cache_len: torch.Tensor) -> torch.Tensor:
    """q [B,H,d]; caches [B,T,KV,d]; cache_len int[B] → [B,H,d] in q.dtype."""
    b, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV heads")
    g = h // kv
    qg = q.reshape(b, kv, g, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * (1.0 / math.sqrt(d))
    pos = torch.arange(t, device=q.device)
    live = pos[None, None, None, :] < cache_len.to(q.device)[:, None, None, None]
    s = torch.where(live, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgt,btkd->bkgd", p / torch.clamp_min(l, 1e-30), v_cache.float())
    return o.reshape(b, h, d).to(q.dtype)
