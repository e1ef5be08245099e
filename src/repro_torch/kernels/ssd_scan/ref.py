"""Plain PyTorch SSD chunk scan: the function kernel B6 computes.

Counterpart of ``repro.models.mamba2._chunk_terms`` and ``ssd_scan``,
which is the oracle of the Pallas kernel (``repro.kernels.ssd_scan.ref``).
Per chunk of Q positions, with ``acs`` the inclusive cumulative sum of the
log-decays ``dt·a`` inside the chunk:

    y_t  = Σ_{s≤t} (C_t·B_s) exp(acs_t − acs_s) x_s dt_s      (intra-chunk)
         + exp(acs_t) C_t·h                                   (inter-chunk)
    h   ← exp(acs_Q) h + Σ_s exp(acs_Q − acs_s) (x_s dt_s) ⊗ B_s

with the causal mask set to −inf before the exp and the chunks in order.
One difference from the reference: ``acs`` is summed in float64 and
rounded once to float32 (PyTorch's own float32 ``cumsum`` on the CPU
already accumulates in float64).  At the serve shape ``acs`` reaches about
−2,000 at the end of a chunk of 1,024, where a float32 running sum carries
an error of ~1e-3 that depends on the order of the adds; the kernel
computes ``acs`` the same way, so the two agree on it.

The model's layout: x [B,S,H,P], dt [B,S,H], B/C [B,S,N] shared by the
H heads, a [H]; the state starts at zero.  Everything is float32 on the
model's paths; ``ssd_ref`` and ``ssd_bwd_ref`` keep float64 inputs in
float64 (the tests hold the backward's algebra that way).

``ssd_chunked_ref`` computes the same function as kernel B6 decomposes it:
the chunks' own terms all at once and only the state's carry in order (see
``csrc/ssd_scan.cu``).
"""
from __future__ import annotations

import torch


def chunk_len(s: int, chunk: int) -> int:
    """The chunk length Q = min(chunk, S); S must be a multiple of it."""
    q = min(chunk, s)
    if q <= 0 or s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {q}")
    return q


def ssd_ref(x, dt, bmat, cmat, a, *, chunk: int, states: bool = False):
    """x [B,S,H,P], dt [B,S,H], B/C [B,S,N], a [H] → (y [B,S,H,P], final
    state [B,H,P,N]), and with ``states`` also each chunk's incoming state
    h_in [B,nc,H,P,N] (what the backward reads; y's bits do not change).
    ``a`` may also be [B,H], a decay per batch row: the Pallas kernel's
    [BH, S, .] rows are B = BH, H = 1 with their own a."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = chunk_len(s, chunk)
    la = dt * a.unsqueeze(-2)                                 # [B,S,H] log-decay ≤ 0
    hs = x.new_zeros((b, h, p, n))
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys, h_in = [], []
    for c in range(s // q):
        h_in.append(hs)
        sl = slice(c * q, (c + 1) * q)
        xc, dtc, bc, cc = x[:, sl], dt[:, sl], bmat[:, sl], cmat[:, sl]
        acs = torch.cumsum(la[:, sl], dim=1, dtype=torch.float64).to(x.dtype)   # [B,Q,H]
        rel = acs[:, :, None, :] - acs[:, None, :, :]                       # [B,Q,Q,H]
        rel = torch.where(tri[None, :, :, None], rel, float("-inf"))
        scores = torch.einsum("bqn,bsn->bqs", cc, bc)[..., None] * torch.exp(rel)
        xdt = xc * dtc[..., None]                                           # [B,Q,H,P]
        y_intra = torch.einsum("bqsh,bshp->bqhp", scores, xdt)
        decay_to_end = torch.exp(acs[:, -1:, :] - acs)                      # [B,Q,H]
        state = torch.einsum("bsh,bsn,bshp->bhpn", decay_to_end, bc, xdt)
        y_inter = torch.einsum("bqn,bqh,bhpn->bqhp", cc, torch.exp(acs), hs)
        hs = torch.exp(acs[:, -1])[..., None, None] * hs + state
        ys.append(y_intra + y_inter)
    if states:
        return torch.cat(ys, dim=1), hs, torch.stack(h_in, dim=1)
    return torch.cat(ys, dim=1), hs


def ssd_chunked_ref(x, dt, bmat, cmat, a, *, chunk: int):
    """``ssd_ref``'s function in kernel B6's five phases, every chunk at
    once but for the carry of phase 4:

    1. acs: the inclusive cumulative sum of dt·a in each chunk (float64,
       rounded once to float32);
    2. cb: C·Bᵀ of each chunk, once for all heads;
    3. chunk_state: S_c = Σ_s dt_s exp(acs_end − acs_s) x_s ⊗ B_s, the
       state chunk c adds from a zero start;
    4. state_pass: h_in[0] = 0, h_in[c+1] = exp(acs_end_c) h_in[c] + S_c,
       the only sequential step; the last is the final state;
    5. chunk_scan: y_t = exp(acs_t) C_t·h_in[c] + Σ_{s≤t} CB[t,s]
       exp(acs_t − acs_s) dt_s x_s, the decay the exp of each pair's
       difference, never exp(acs_t)·exp(−acs_s) (which overflows).

    Same arguments and result as ``ssd_ref``."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = chunk_len(s, chunk)
    nc = s // q
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bc, cc = bmat.reshape(b, nc, q, n), cmat.reshape(b, nc, q, n)
    la = dt * a.unsqueeze(-2)                                               # [B,S,H]
    acs = torch.cumsum(la.reshape(b, nc, q, h), dim=2, dtype=torch.float64).float()
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)                            # [B,nc,Q,Q]
    w = dtc * torch.exp(acs[:, :, -1:] - acs)                               # [B,nc,Q,H]
    states = torch.einsum("bcsh,bcshp,bcsn->bchpn", w, xc, bc)              # [B,nc,H,P,N]
    decay = torch.exp(acs[:, :, -1])                                        # [B,nc,H]
    h_in = torch.empty_like(states)
    hs = x.new_zeros((b, h, p, n), dtype=torch.float32)
    for c in range(nc):
        h_in[:, c] = hs
        hs = decay[:, c, :, None, None] * hs + states[:, c]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    rel = acs[:, :, :, None, :] - acs[:, :, None, :, :]                     # [B,nc,Q,Q,H]
    lmat = torch.exp(torch.where(tri[:, :, None], rel, float("-inf")))
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, lmat, xc * dtc[..., None])
    y_inter = torch.exp(acs)[..., None] * torch.einsum("bcin,bchpn->bcihp", cc, h_in)
    return (y_intra + y_inter).reshape(b, s, h, p), hs


def ssd_bwd_ref(x, dt, bmat, cmat, a, dy, dh_final, h_in, *, chunk: int):
    """The gradient of ``ssd_ref`` (what ``jax.grad`` takes through
    ``repro.models.mamba2.ssd_scan``), in kernel B6's decomposition run in
    reverse: x, dt, B, C, a as the forward's, dy [B,S,H,P] the gradient of
    y, ``dh_final`` [B,H,P,N] that of the final state (None: zero), h_in
    [B,nc,H,P,N] the forward's incoming states (``ssd_ref(...,
    states=True)``) → (dx, ddt, dB, dC, da), dB and dC dense [B,S,N]; a
    is [H] only (no caller takes the gradient of a per-row decay).

    1. G_c = Σ_t exp(acs_t) dy_t ⊗ C_t, the gradient into chunk c's
       incoming state from its own outputs;
    2. the only sequential step, in reverse: dh[nc] = d(final), dS_c =
       dh[c+1], dh[c] = exp(acs_end_c) dh[c+1] + G_c; the decay's gradient
       is Σ dS_c ∘ h_in[c];
    3. every chunk at once: d(x·dt)_s = Σ_{t≥s} CB[t,s] L[t,s] dy_t +
       exp(acs_end − acs_s) dS_c·B_s; dCB[t,s] = Σ_h L_h[t,s] (dy_t·xdt_s)_h
       (the heads share B and C), dC = dCB·B + Σ_h exp(acs_t) dy_t·h_in,
       dB = dCBᵀ·C + Σ_h exp(acs_end − acs_s) xdt_s·dS_c; d(acs) from the
       pairs M = CB∘L∘(dy·xdt) (+ row sums, − column sums, the diagonal,
       which cancels, left out), from exp(acs_t) in the inter term, from
       the state weight (the last position's, which cancels, left out) and
       from the decay;
    4. d(log-decay) = the reverse cumulative sum of d(acs) in each chunk,
       in float64 and rounded once (as the forward's cumsum); then ddt =
       x·d(x·dt) + d(log-decay)·a; da sums each term of d(acs) times its
       own span of dt (a pair's Σ_{s<u≤t} dt_u, ...), in float64.
    The masked pairs are set to −inf before the exp, never exp(acs_t)·
    exp(−acs_s) (C7)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = chunk_len(s, chunk)
    nc = s // q
    xc, dyc = x.reshape(b, nc, q, h, p), dy.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bc, cc = bmat.reshape(b, nc, q, n), cmat.reshape(b, nc, q, n)
    la = dt * a
    acs = torch.cumsum(la.reshape(b, nc, q, h), dim=2, dtype=torch.float64).to(x.dtype)   # [B,nc,Q,H]
    e = torch.exp(acs)                                                              # exp(acs_t)
    e_end = torch.exp(acs[:, :, -1:] - acs)                                         # exp(acs_end − acs_s)
    decay = torch.exp(acs[:, :, -1])                                                # [B,nc,H]
    xdt = xc * dtc[..., None]

    # 1. and 2.
    g = torch.einsum("bcth,bcthp,bctn->bchpn", e, dyc, cc)
    d_s = torch.empty_like(g)
    d_decay = torch.empty_like(decay)
    dh = torch.zeros_like(g[:, 0]) if dh_final is None else dh_final
    for c in reversed(range(nc)):
        d_s[:, c] = dh
        d_decay[:, c] = (dh * h_in[:, c]).sum(dim=(-2, -1))
        dh = decay[:, c, :, None, None] * dh + g[:, c]

    # 3.
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    rel = acs[:, :, :, None, :] - acs[:, :, None, :, :]                              # [B,nc,Q(t),Q(s),H]
    lmat = torch.exp(torch.where(tri[:, :, None], rel, float("-inf")))
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)
    scores = cb[..., None] * lmat
    state_rows = e_end[..., None] * torch.einsum("bcsn,bchpn->bcshp", bc, d_s)       # exp(acs_end − acs_s) dS·B_s
    dxdt = torch.einsum("bctsh,bcthp->bcshp", scores, dyc) + state_rows
    pair = torch.einsum("bcthp,bcshp->bctsh", dyc, xdt)                             # dy_t · xdt_s per head
    dcb = (lmat * pair).sum(dim=-1)
    d_c = torch.einsum("bcts,bcsn->bctn", dcb, bc) + torch.einsum("bcth,bcthp,bchpn->bctn", e, dyc, h_in)
    d_b = torch.einsum("bcts,bctn->bcsn", dcb, cc) + torch.einsum("bcsh,bcshp,bchpn->bcsn", e_end, xdt, d_s)
    m = scores * pair * torch.tril(torch.ones((q, q), device=x.device), diagonal=-1)[:, :, None]
    dacs = m.sum(dim=3) - m.sum(dim=2)
    inter = e * torch.einsum("bcthp,bctn,bchpn->bcth", dyc, cc, h_in)
    dacs = dacs + inter
    # the state's weights exp(acs_end − acs_s): −w_s at s, +Σ_s w_s at the end, where the last
    # position's own term cancels exactly and is left out (it is the largest: exp(0))
    state_w = (xdt * state_rows).sum(dim=-1)                                        # [B,nc,Q,H]
    dacs[:, :, :-1] -= state_w[:, :, :-1]
    dacs[:, :, -1] += state_w[:, :, :-1].sum(dim=2) + decay * d_decay

    # 4.
    dla = torch.flip(torch.cumsum(torch.flip(dacs, (2,)), dim=2, dtype=torch.float64), (2,)).to(x.dtype)
    ddt = (dxdt * xc).sum(dim=-1) + dla * a
    # da = Σ_t d(acs)_t ∂acs_t/∂a, ∂acs_t/∂a = cum_t = Σ_{u≤t} dt_u, each term weighted by its own
    # span of dt: the pairs by cum_t − cum_s, the inter term by cum_t, the state weights by
    # cum_end − cum_s, the decay by cum_end (summing d(la)·dt instead weights every position's
    # rounding by the chunk's cum and costs da ~1e-4 of its size at a chunk of 1,024)
    cum = torch.cumsum(dtc, dim=2, dtype=torch.float64)                             # [B,nc,Q,H]
    span = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(x.dtype)              # cum_t − cum_s
    da_row = ((m * span).sum(dim=(2, 3), dtype=torch.float64) + (inter * cum).sum(dim=2)
              + (state_w[:, :, :-1] * (cum[:, :, -1:] - cum)[:, :, :-1]).sum(dim=2)
              + cum[:, :, -1] * decay * d_decay)                                   # [B,nc,H]
    da = da_row.sum(dim=(0, 1)).to(x.dtype)
    return ((dxdt * dtc[..., None]).reshape(b, s, h, p), ddt.reshape(b, s, h),
            d_b.reshape(b, s, n), d_c.reshape(b, s, n), da)
