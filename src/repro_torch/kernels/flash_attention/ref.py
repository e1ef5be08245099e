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


def _repeated_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K and V in float32 with each KV head repeated for its G = H/KV
    query heads ([B,T,H,d]), and G."""
    h, kv = q.shape[2], k.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV heads")
    group = h // kv
    return k.float().repeat_interleave(group, dim=2), v.float().repeat_interleave(group, dim=2), group


def _scores(q: torch.Tensor, kr: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """q·Kᵀ/√d [B,H,S,T] in float32, masked (NEG_INF) by the top-left rule."""
    s, t, d = q.shape[1], kr.shape[1], q.shape[3]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / math.sqrt(d)
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        scores = torch.where(rows >= cols, scores, NEG_INF)
    return scores


def _probs(q: torch.Tensor, kr: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """softmax(q·Kᵀ/√d) [B,H,S,T] in float32, masked by the top-left rule."""
    scores = _scores(q, kr, causal=causal)
    p = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    return p / torch.sum(p, dim=-1, keepdim=True)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled, masked scores, [B,H,S] float32
    (natural log): ``softmax(scores)[j] = exp(scores[j] − lse)``.  B4's
    "wgmma_f32" body writes it in base 2, ``lse·log2(e)``."""
    kr, _, _ = _repeated_kv(q, k, k)
    return torch.logsumexp(_scores(q, kr, causal=causal), dim=-1)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q [B,S,H,d]; k, v [B,T,KV,d] → [B,S,H,d] in q.dtype."""
    kr, vr, _ = _repeated_kv(q, k, v)
    return torch.einsum("bhqk,bkhd->bqhd", _probs(q, kr, causal=causal), vr).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                      do: torch.Tensor, *, causal: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``attention_ref(q, k, v, causal=causal)``
    = ``o`` for the output gradient ``do``, written out (not through
    autograd): P recomputed as ``attention_ref`` forms it, dP = dO·Vᵀ, D =
    rowsum(dO∘O), dS = P∘(dP − D), dQ = dS·K/√d, and dK = dSᵀ·Q/√d, dV =
    Pᵀ·dO each summed over the G = H/KV query heads of its KV head.  Float32
    math; each gradient in its input's dtype."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    kr, vr, group = _repeated_kv(q, k, v)
    qf, dof = q.float(), do.float()
    p = _probs(q, kr, causal=causal)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    delta = torch.sum(dof * o.float(), dim=-1).transpose(1, 2)              # [B, H, S]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) / math.sqrt(d)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) / math.sqrt(d)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, t, kv, group, d).sum(dim=3)
    dv = dv.reshape(b, t, kv, group, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
