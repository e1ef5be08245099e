"""Plain PyTorch version of the fused Thompson choice (B1, and B2 over a
leading query axis), and of the fused round that makes the normals from
the choice key (``thompson_round``).

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

from repro_torch.core.thompson import _kernel_inputs, wilson_hilferty

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


def thompson_round_ref(key: torch.Tensor, state, cohorts: int):
    """The fused round's plain version: ``gamma_params`` with exhaustion as
    α = −1, ``prng.normal(key, (cohorts, M))``, then ``thompson_ref``; keys
    int64[2] or [Q, 2] with statistics [M] or [Q, M] → (idx i32[..., C],
    val f32[..., C])."""
    return thompson_ref(*_kernel_inputs(key, state, cohorts))


def thompson_round_split_ref(key: torch.Tensor, state, cohorts: int, splits: int):
    """``thompson_round_ref`` as the kernel decomposes it: each row's M
    chunks in ``splits`` contiguous pieces of ceil(M / splits) (the last
    ones short or empty), each piece's first maximum (value, index), the
    partials combined in piece order with the larger value winning and, on
    equal values, the lower index."""
    alpha, beta, z = _kernel_inputs(key, state, cohorts)
    m = alpha.shape[-1]
    piece = -(-m // splits)
    best_v = torch.full(z.shape[:-1], NEG_INF, dtype=torch.float32, device=z.device)
    best_i = torch.full(z.shape[:-1], -1, dtype=torch.int32, device=z.device)
    for s in range(splits):
        lo, hi = min(m, s * piece), min(m, (s + 1) * piece)
        if lo == hi:
            continue
        i, v = thompson_ref(alpha[..., lo:hi], beta[..., lo:hi], z[..., lo:hi])
        i = torch.where(i >= 0, i + lo, i)
        better = (v > best_v) | ((v == best_v) & (i < best_i))
        best_v = torch.where(better, v, best_v)
        best_i = torch.where(better, i, best_i)
    return best_i, best_v
