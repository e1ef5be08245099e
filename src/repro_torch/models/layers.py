"""Shared neural building blocks and the parameter schema.

Counterpart of ``repro.models.layers``.  Parameters keep the reference's
layout (a projection is ``x @ w`` with ``w`` of shape ``(in, out)``), so a
parameter tree converts key for key with no transposes.  Every leaf is
declared once as a ``ParamSpec``; ``materialize`` fills it in place from a
``torch.Generator`` seeded by the parameter's path through ``zlib.crc32``
(the reference seeds with Python's ``hash``, which changes from process
to process), so one seed gives the same weights in every process.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones | embed_normal
    scale: float = 1.0

    def std(self) -> float:
        if self.init == "embed_normal":
            # tied unembedding: rows ~ N(0, 1/d) keep init logits O(1)
            return 1.0 / math.sqrt(self.shape[-1])
        fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[0], 1)
        return self.scale / math.sqrt(fan_in)


Schema = dict[str, Any]  # nested dict of ParamSpec


class ParamNode(torch.nn.Module):
    """One level of the parameter tree: leaves are ``nn.Parameter``s and
    inner nodes ``ParamNode``s, named as the reference's dict keys, so
    ``named_parameters()`` gives the reference's paths (``layer_0.attn.wq``).
    ``p["wq"]`` and ``"bq" in p`` read as the reference's dicts do."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def empty_params(schema: Schema, dtype, device) -> ParamNode:
    """The tree of ``schema`` with uninitialised tensors on ``device``."""
    node = ParamNode()
    for name, spec in schema.items():
        if isinstance(spec, ParamSpec):
            t = torch.empty(spec.shape, dtype=dtype, device=device)
            node.register_parameter(name, torch.nn.Parameter(t, requires_grad=False))
        else:
            node.add_module(name, empty_params(spec, dtype, device))
    return node


def flat_specs(schema: Schema, prefix: str = "") -> dict[str, ParamSpec]:
    out = {}
    for name, spec in schema.items():
        path = f"{prefix}{name}"
        if isinstance(spec, ParamSpec):
            out[path] = spec
        else:
            out.update(flat_specs(spec, path + "."))
    return out


@torch.no_grad()
def materialize(schema: Schema, seed: int, dtype, device) -> ParamNode:
    """Initialise every parameter of ``schema`` on ``device``: normal draws
    (float32, times the spec's std, then cast) from a generator on the
    device seeded by ``seed`` and the path's CRC-32."""
    params = empty_params(schema, dtype, device)
    named = dict(params.named_parameters())
    for path, spec in flat_specs(schema).items():
        p = named[path]
        if spec.init == "zeros":
            p.zero_()
        elif spec.init == "ones":
            p.fill_(1.0)
        else:
            g = torch.Generator(device=device)
            g.manual_seed(zlib.crc32(f"{seed}:{path}".encode()))
            p.copy_(torch.empty(spec.shape, device=device).normal_(0.0, spec.std(), generator=g))
    return params


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the mean of squares in float32, the scale cast back to
    ``x.dtype`` before the elementwise product (the reference's order)."""
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * gamma.to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    mu = torch.mean(x, dim=-1, keepdim=True, dtype=torch.float32)
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=torch.float32)
    var = ms - mu * mu
    inv = torch.rsqrt(var + eps).to(x.dtype)
    mu = mu.to(x.dtype)
    return (x - mu) * inv * gamma.to(x.dtype) + beta.to(x.dtype)


def norm_schema(cfg_norm: str, d: int) -> Schema:
    if cfg_norm == "rmsnorm":
        return {"gamma": ParamSpec((d,), init="ones")}
    return {
        "gamma": ParamSpec((d,), init="ones"),
        "beta": ParamSpec((d,), init="zeros"),
    }


def apply_norm(cfg_norm: str, p, x: torch.Tensor) -> torch.Tensor:
    if cfg_norm == "rmsnorm":
        return rmsnorm(x, p["gamma"])
    return layernorm(x, p["gamma"], p["beta"])


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it on the card would be
    # a synchronous host-to-device copy on every call
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exponents)  # f32[head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, D]; positions int[..., S] (broadcastable).  cos/sin
    are cast to ``x.dtype`` before the product, as in the reference."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    angles = positions[..., :, None, None].to(torch.float32) * freqs   # [..., S, 1, D/2]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------------
# MLP / GLU
# --------------------------------------------------------------------------

def mlp_schema(d_model: int, d_ff: int, kind: str) -> Schema:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d_model, d_ff)),
            "w_up": ParamSpec((d_model, d_ff)),
            "w_down": ParamSpec((d_ff, d_model)),
        }
    return {
        "w_up": ParamSpec((d_model, d_ff)),
        "w_down": ParamSpec((d_ff, d_model)),
    }


def apply_mlp(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------

def embed_schema(vocab: int, d_model: int) -> Schema:
    return {"table": ParamSpec((vocab, d_model), init="embed_normal")}


def apply_embed(p, tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    return F.embedding(tokens, p["table"]) * (1.0 / math.sqrt(d_model))


def apply_unembed(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T
