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
H heads, a [H]; the state starts at zero.  Everything is float32.

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


def ssd_ref(x, dt, bmat, cmat, a, *, chunk: int):
    """x [B,S,H,P], dt [B,S,H], B/C [B,S,N], a [H] → (y [B,S,H,P], final
    state [B,H,P,N]).  ``a`` may also be [B,H], a decay per batch row: the
    Pallas kernel's [BH, S, .] rows are B = BH, H = 1 with their own a."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = chunk_len(s, chunk)
    la = dt * a.unsqueeze(-2)                                 # [B,S,H] log-decay ≤ 0
    hs = x.new_zeros((b, h, p, n), dtype=torch.float32)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(s // q):
        sl = slice(c * q, (c + 1) * q)
        xc, dtc, bc, cc = x[:, sl], dt[:, sl], bmat[:, sl], cmat[:, sl]
        acs = torch.cumsum(la[:, sl], dim=1, dtype=torch.float64).float()   # [B,Q,H]
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
