"""Plain PyTorch version of the fused Thompson choice (B1, and B2 over a
leading query axis).

Counterpart of ``repro.kernels.thompson.ref`` with one deliberate
difference: a row whose chunks are all exhausted returns index -1 and
value -1e30, as the TPU kernel does.  The JAX ``thompson_ref`` returns
index 0 there (argmax of an all-equal row).  The single-query drivers
never reach that row, because their exit test runs first; the
multi-query driver does, for a query that has exhausted every chunk while
others go on, and masks those ids before it uses them.
"""
from __future__ import annotations

import torch

from repro_torch.core.thompson import wilson_hilferty

NEG_INF = -1e30


def thompson_ref(alpha: torch.Tensor, beta: torch.Tensor, z: torch.Tensor):
    """alpha/beta f32[..., M] (alpha<=0 ⇒ exhausted), z f32[..., C, M] →
    (idx i32[..., C], val f32[..., C])."""
    live = alpha > 0.0
    a = torch.clamp_min(alpha, 1e-6)
    draw = wilson_hilferty(a[..., None, :], z) / torch.clamp_min(beta, 1e-9)[..., None, :]
    score = torch.where(live[..., None, :], draw, torch.full_like(draw, NEG_INF))
    val, idx = score.max(dim=-1)
    # first index of the maximum, stated explicitly rather than relying on
    # max()'s tie order
    m = score.shape[-1]
    cols = torch.arange(m, device=score.device).expand_as(score)
    idx = torch.where(score == val[..., None], cols, torch.full_like(cols, m)).amin(dim=-1)
    idx = torch.where(val > NEG_INF, idx, torch.full_like(idx, -1))
    return idx.int(), val
