"""Plain PyTorch flash decode: the function kernel B5 computes, and the
kernel's split of the cache with its combine (``decode_split_ref``).

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


def split_ranges(cache_len: torch.Tensor, t: int, splits: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Kernel B5's share of the live range for each split, per sequence:
    live = min(cache_len, t), or t where cache_len <= 0; split i covers
    [i·p, min((i+1)·p, live)), p = ceil(live / splits) (empty past live)."""
    n = cache_len.to(torch.int64)
    live = torch.where(n > 0, torch.clamp_max(n, t), torch.full_like(n, t))
    per = (live + splits - 1) // splits
    return [(torch.minimum(i * per, live), torch.minimum((i + 1) * per, live)) for i in range(splits)]


def decode_split_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, splits: int) -> torch.Tensor:
    """``decode_ref`` as kernel B5 decomposes it: each of ``splits`` ranges
    (``split_ranges``) keeps its own float32 (m, l, acc) per head, then
    out = Σ_i exp(m_i − M)·acc_i / max(Σ_i exp(m_i − M)·l_i, 1e-30),
    M = max_i m_i over the splits that did work (an empty split adds
    nothing).  Used by the tests alone."""
    b, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV heads")
    qg = q.reshape(b, kv, h // kv, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * (1.0 / math.sqrt(d))
    pos = torch.arange(t, device=q.device)
    lens = cache_len.to(q.device)
    s = torch.where(pos[None, None, None, :] < lens[:, None, None, None], s, NEG_INF)
    parts = []
    for lo, hi in split_ranges(lens, t, splits):
        inside = ((pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None]))[:, None, None, :]
        si = torch.where(inside, s, -math.inf)
        m = torch.amax(si, dim=-1, keepdim=True)                          # -inf where empty
        p = torch.where(inside, torch.exp(si - torch.where(torch.isinf(m), 0.0, m)), 0.0)
        parts.append((m, p.sum(dim=-1, keepdim=True), torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())))
    big_m = torch.amax(torch.stack([torch.where(l > 0, m, -math.inf) for m, l, _ in parts]), dim=0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - big_m), 0.0)
        num = num + w * acc
        den = den + w * l
    return (num / torch.clamp_min(den, 1e-30)).reshape(b, h, d).to(q.dtype)
