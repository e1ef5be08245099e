"""Mixture-of-Experts block: grouped top-k routing with capacity dispatch.

Counterpart of ``repro.models.moe``.  Tokens come pre-grouped into G
groups ([G, T, D]) and every dispatch index is group-local.  Capacity
follows GShard/Switch: per group and expert C = ceil(T · top_k ·
capacity_factor / E) slots; a token over an expert's capacity is dropped
from that expert (combine weight 0), and empty slots stay zero.  The
router runs in float32 whatever the activations' dtype.

The block is four steps, each a function of its own: ``route`` (softmax,
top-k, the token-major capacity ranks and the slot owners), ``dispatch``
(the gather into [G, E, C, D]), ``expert_ffn`` (batched matrix products
over the experts, as the reference's ``einsum``s; no kernel) and
``combine`` (each expert's weighted outputs scattered into its own
[G, E, T+1, D] slab, then the sum over E).  A token picks an expert at
most once, so each real row of a slab takes at most one contribution and
the card's scatter is deterministic; dropped entries all land on the pad
row T, which is sliced off.  The top-k is a stable descending sort, so
ties go to the lowest expert index, as ``jax.lax.top_k`` gives them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import prng
from repro_torch.models.layers import ParamSpec, Schema


def moe_schema(d_model: int, cfg: MoEConfig, mlp_kind: str) -> Schema:
    e, f = cfg.num_experts, cfg.d_ff
    schema: Schema = {"router": ParamSpec((d_model, e), scale=0.1)}
    if mlp_kind in ("swiglu", "geglu"):
        schema.update(
            w_gate=ParamSpec((e, d_model, f)),
            w_up=ParamSpec((e, d_model, f)),
            w_down=ParamSpec((e, f, d_model)),
        )
    else:
        schema.update(
            w_up=ParamSpec((e, d_model, f)),
            w_down=ParamSpec((e, f, d_model)),
        )
    return schema


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor          # Switch load-balancing loss (scalar)
    dropped_fraction: torch.Tensor


class Routing(NamedTuple):
    probs: torch.Tensor             # f32[G, T, E]: the router's softmax
    top_p: torch.Tensor             # f32[G, T, K]: renormalised over the top k
    top_e: torch.Tensor             # int64[G, T, K]: the experts, by falling probability
    flat_pos: torch.Tensor          # int32[G, T·K]: rank of (token, k) within its expert
    keep: torch.Tensor              # bool[G, T·K]: within the expert's capacity
    src: torch.Tensor               # int64[G, E·C]: the (token, k) index owning each slot; T·K if empty


def capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(int(c), 1)


def router_logits(params, x: torch.Tensor, cfg: MoEConfig,
                  router_key: torch.Tensor | None = None) -> torch.Tensor:
    """x [G, T, D] → float32 logits [G, T, E] (operands upcast to float32,
    as the reference's float32 accumulation of its products), plus
    ``router_jitter`` times JAX's normals from ``router_key`` when both
    are set."""
    logits = x.float() @ params["router"].float()
    if cfg.router_jitter and router_key is not None:
        logits = logits + cfg.router_jitter * prng.normal(router_key, tuple(logits.shape))
    return logits


def route(logits: torch.Tensor, cfg: MoEConfig, c: int) -> Routing:
    """Top-k routing and the capacity slots of ``logits`` [G, T, E]:
    earlier tokens (token-major over (T, K)) win an expert's C slots."""
    g, t, e = logits.shape
    k = cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)

    # the rank of each (token, k) entry within its expert: the entries routed there before it.
    # The one-hot is expert-major so that the cumsum runs along its contiguous T·K axis (a scan
    # along a strided axis runs serially on the card); the counts are the reference's.
    flat_e = top_e.reshape(g, t * k)
    experts = torch.arange(e, device=logits.device)
    onehot = (flat_e[:, None, :] == experts[:, None]).to(torch.int32)   # [G, E, TK]
    count = torch.cumsum(onehot, dim=-1, dtype=torch.int32)
    flat_pos = count.gather(1, flat_e[:, None, :])[:, 0] - 1
    keep = flat_pos < c

    slot_id = flat_e * c + torch.clamp(flat_pos, max=c - 1)
    slot_id = torch.where(keep, slot_id, e * c)                     # dropped → the pad slot
    src = torch.full((g, e * c + 1), t * k, dtype=torch.int64, device=logits.device)
    owners = torch.arange(t * k, device=logits.device).expand(g, -1)
    src = src.scatter(1, slot_id, owners)[:, : e * c]               # kept slot ids are unique
    return Routing(probs=probs, top_p=top_p, top_e=top_e, flat_pos=flat_pos, keep=keep, src=src)


def dispatch(x: torch.Tensor, r: Routing, cfg: MoEConfig, c: int) -> torch.Tensor:
    """Each slot's token: x [G, T, D] → [G, E, C, D] (an empty slot the
    zero pad row)."""
    g, t, d = x.shape
    src_token = r.src // cfg.top_k                                  # T for an empty slot
    x_pad = torch.cat([x, x.new_zeros((g, 1, d))], dim=1)
    xe = torch.gather(x_pad, 1, src_token[..., None].expand(-1, -1, d))
    return xe.reshape(g, cfg.num_experts, c, d)


def expert_ffn(params, xe: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    """The experts' MLPs on their slots: [G, E, C, D] → [G, E, C, D], one
    batched matrix product over E for each weight."""
    g, e, c, d = xe.shape
    xs = xe.transpose(0, 1).reshape(e, g * c, d)                    # [E, G·C, D]
    if mlp_kind == "swiglu":
        h = F.silu(torch.bmm(xs, params["w_gate"])) * torch.bmm(xs, params["w_up"])
    elif mlp_kind == "geglu":
        h = F.gelu(torch.bmm(xs, params["w_gate"]), approximate="tanh") * torch.bmm(xs, params["w_up"])
    else:
        h = F.gelu(torch.bmm(xs, params["w_up"]), approximate="tanh")
    ye = torch.bmm(h, params["w_down"])                             # [E, G·C, D]
    return ye.reshape(e, g, c, d).transpose(0, 1)


def combine(ye: torch.Tensor, r: Routing, t: int) -> torch.Tensor:
    """Each slot's output times its routing weight, scattered into its
    expert's [T+1, D] slab and summed over E: → [G, T, D]."""
    g, e, c, d = ye.shape
    tk = r.keep.shape[1]
    w_flat = (r.top_p.reshape(g, tk) * r.keep).to(ye.dtype)
    w_slots = torch.where(r.src < tk, torch.gather(w_flat, 1, torch.clamp(r.src, max=tk - 1)), 0.0)
    contrib = ye * w_slots.reshape(g, e, c)[..., None]
    tgt = (r.src // r.top_e.shape[-1]).reshape(g, e, c)             # token of each slot; T = pad
    out_e = ye.new_zeros((g, e, t + 1, d))
    out_e.scatter_add_(2, tgt[..., None].expand(-1, -1, -1, d), contrib)
    return out_e[:, :, :t].sum(dim=1)


def moe_stats(r: Routing, e: int) -> MoEStats:
    frac_per_expert = F.one_hot(r.top_e[..., 0], e).float().mean(dim=(0, 1))
    mean_prob = r.probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_per_expert * mean_prob)
    # the mean as JAX's eager jnp.mean takes it: the sum times the float32 reciprocal of the count
    dropped = 1.0 - r.keep.float().sum() * float(np.float32(1) / np.float32(r.keep.numel()))
    return MoEStats(aux_loss=aux, dropped_fraction=dropped)


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig, *, mlp_kind: str,
              router_key: torch.Tensor | None = None) -> tuple[torch.Tensor, MoEStats]:
    """x [G, T, D] (pre-grouped tokens) → ([G, T, D] in x's dtype, stats)."""
    t = x.shape[1]
    c = capacity(t, cfg)
    r = route(router_logits(params, x, cfg, router_key), cfg, c)
    ye = expert_ffn(params, dispatch(x, r, cfg, c), mlp_kind)
    return combine(ye, r, t).to(x.dtype), moe_stats(r, cfg.num_experts)


def moe_flops(tokens: int, d_model: int, cfg: MoEConfig, mlp_kind: str) -> float:
    """Active-expert FLOPs (top_k experts a token; capacity padding is
    not counted)."""
    mats = 3 if mlp_kind in ("swiglu", "geglu") else 2
    return 2.0 * tokens * cfg.top_k * d_model * cfg.d_ff * mats
