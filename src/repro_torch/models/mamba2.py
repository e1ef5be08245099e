"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block.

Counterpart of ``repro.models.mamba2``.  Prefill runs the chunked SSD
through kernel B6 (``kernels/ssd_scan``), one launch per layer, where the
reference evaluates the same chunked algorithm in plain jnp (the oracle
of its Pallas kernel).  The SSD reads x, B and C where the projections
and convolutions leave them: B and C are column slices of one [B, S, 2N]
tensor, shared by the heads.  Decode is the reference's O(1) state update
in plain PyTorch (the reference has no kernel there).  Float32 inside the
SSD and the state, whatever the parameters' dtype, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import ParamSpec, Schema


def mamba_dims(d_model: int, cfg: SSMConfig) -> tuple[int, int, int]:
    d_inner = cfg.expand * d_model
    nheads = d_inner // cfg.head_dim
    return d_inner, nheads, cfg.state_dim


def mamba_schema(d_model: int, cfg: SSMConfig) -> Schema:
    """The reference's split projections: z/x/dt per inner channel or
    head, B/C one group (ngroups = 1) shared by the heads."""
    d_inner, nheads, n = mamba_dims(d_model, cfg)
    return {
        "wz": ParamSpec((d_model, d_inner)),
        "wx": ParamSpec((d_model, d_inner)),
        "wbc": ParamSpec((d_model, 2 * n)),
        "wdt": ParamSpec((d_model, nheads)),
        "conv_x_w": ParamSpec((cfg.conv_width, d_inner), scale=1.0),
        "conv_x_b": ParamSpec((d_inner,), init="zeros"),
        "conv_bc_w": ParamSpec((cfg.conv_width, 2 * n), scale=1.0),
        "conv_bc_b": ParamSpec((2 * n,), init="zeros"),
        "dt_bias": ParamSpec((nheads,), init="zeros"),
        "a_log": ParamSpec((nheads,), init="ones"),
        "d_skip": ParamSpec((nheads,), init="ones"),
        "norm_g": ParamSpec((d_inner,), init="ones"),
        "out_proj": ParamSpec((d_inner, d_model)),
    }


class MambaCache(NamedTuple):
    conv: torch.Tensor     # [B, W-1, d_inner + 2N]: the rolling conv window, in the parameters' dtype
    ssm: torch.Tensor      # [B, H, P, N]: the recurrent state, float32


def init_cache(batch: int, d_model: int, cfg: SSMConfig, dtype, device) -> MambaCache:
    d_inner, nheads, n = mamba_dims(d_model, cfg)
    return MambaCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, d_inner + 2 * n), dtype=dtype, device=device),
        ssm=torch.zeros((batch, nheads, cfg.head_dim, n), dtype=torch.float32, device=device),
    )


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it, ``logaddexp(x, 0)``
    (no linear cut-off above 20, unlike ``F.softplus``)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x [B,S,C], w [W,C] → silu(conv + b) [B,S,C]."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + s] * w[i][None, None, :] for i in range(width))
    return F.silu(out + b[None, None, :])


def _project(params, x: torch.Tensor):
    """x [B,S,D] → (z, x_ssm, bc, dt) via the split projections."""
    return x @ params["wz"], x @ params["wx"], x @ params["wbc"], x @ params["wdt"]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             a_log: torch.Tensor, *, chunk: int):
    """Chunked SSD from a zero state: x [B,S,H,P], dt [B,S,H] (after
    softplus), B/C [B,S,N], a_log [H], all float32 → (y [B,S,H,P], final
    state [B,H,P,N]).  S must be a multiple of min(chunk, S) (ValueError
    otherwise).  Kernel B6 on a CUDA tensor."""
    return ssd_ops.ssd(x, dt, bmat, cmat, -torch.exp(a_log), chunk=chunk)


def _gated_norm(params, y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """Mamba-2's gated RMSNorm, norm(y · silu(z)), eps 1e-6, in float32."""
    y = y.to(dtype) * F.silu(z)
    yf = y.float()
    return (yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
            * params["norm_g"].float()).to(dtype)


def apply_mamba(params, x: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    """Full Mamba-2 block (prefill): x [B,S,D] → [B,S,D]."""
    b, s, d = x.shape
    d_inner, nheads, n = mamba_dims(d, cfg)
    z, xc, bc, dt = _project(params, x)
    xc = _causal_conv(xc, params["conv_x_w"], params["conv_x_b"])
    bc = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"])
    bmat, cmat = bc[..., :n], bc[..., n:]
    dt = _softplus(dt.float() + params["dt_bias"].float())
    xh = xc.reshape(b, s, nheads, cfg.head_dim).float()
    y, _ = ssd_scan(xh, dt, bmat.float(), cmat.float(), params["a_log"].float(),
                    chunk=cfg.chunk_len)
    y = y + params["d_skip"].float()[None, None, :, None] * xh
    y = _gated_norm(params, y.reshape(b, s, d_inner), z, x.dtype)
    return y @ params["out_proj"]


def apply_mamba_decode(params, x: torch.Tensor, cache: MambaCache,
                       cfg: SSMConfig) -> tuple[torch.Tensor, MambaCache]:
    """One token: x [B,1,D] → ([B,1,D], the cache one token on), with the
    O(1) state update h ← exp(dt·a)·h + dt·(x ⊗ B)."""
    b, _, d = x.shape
    d_inner, nheads, n = mamba_dims(d, cfg)
    z, xc, bc, dt = _project(params, x)
    xbc_new = torch.cat([xc, bc], dim=-1)[:, 0]                          # [B, C]
    window = torch.cat([cache.conv, xbc_new[:, None]], dim=1)            # [B, W, C]
    conv_w = torch.cat([params["conv_x_w"], params["conv_bc_w"]], dim=1)
    conv_b = torch.cat([params["conv_x_b"], params["conv_bc_b"]], dim=0)
    xbc = F.silu(torch.einsum("bwc,wc->bc", window, conv_w) + conv_b)
    xc1, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt1 = _softplus(dt[:, 0].float() + params["dt_bias"].float())        # [B, H]
    decay = torch.exp(dt1 * (-torch.exp(params["a_log"]))[None, :])
    xh = xc1.reshape(b, nheads, cfg.head_dim).float()
    upd = torch.einsum("bh,bn,bhp->bhpn", dt1, bmat.float(), xh)
    h_new = decay[..., None, None] * cache.ssm + upd
    y = torch.einsum("bn,bhpn->bhp", cmat.float(), h_new)
    y = y + params["d_skip"].float()[None, :, None] * xh
    y = _gated_norm(params, y.reshape(b, 1, d_inner), z, x.dtype)
    return y @ params["out_proj"], MambaCache(conv=window[:, 1:], ssm=h_new)


def mamba_flops(tokens: int, d_model: int, cfg: SSMConfig) -> float:
    """Analytic FLOPs per token span (projections + SSD terms), the
    reference's count."""
    d_inner, nheads, n = mamba_dims(d_model, cfg)
    proj = 2.0 * tokens * d_model * (2 * d_inner + 2 * n + nheads)
    out = 2.0 * tokens * d_inner * d_model
    q = cfg.chunk_len
    intra = 2.0 * tokens * q * (n + nheads * cfg.head_dim)   # scores + apply
    inter = 4.0 * tokens * n * d_inner                        # state build + read
    return proj + out + intra + inter
