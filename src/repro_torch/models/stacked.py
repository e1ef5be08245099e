"""The forward over layers stacked by their pattern period.

Counterpart of ``repro.models.stacked``.  The layer types of every
supported arch repeat with a period (``pattern_period``: jamba's
attention every 8th layer and MoE every 2nd give 8), so the layers of one
position in the period share a schema and stack into one leaf with a
leading ``[num_groups]`` axis, under ``groups.pos_{j}``.  The reference
runs the groups under ``lax.scan``; here they are a Python loop, and
group ``g`` runs the unrolled forward's operations on the ``[g]`` slices
of the stacked leaves (contiguous views, no copies).  The vlm's patch
projector and the audio encoder's layers stay unstacked, as in the
reference: the encoder runs once, before the groups, and each group's
cross-attention projects its own K/V from the encoder's output.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.layers import (
    ParamNode,
    ParamSpec,
    Schema,
    apply_norm,
    apply_unembed,
    embed_schema,
    empty_params,
    norm_schema,
)
from repro_torch.models.transformer import (
    _cross_kv,
    _decoder_layer,
    _decoder_layer_schema,
    embed_inputs,
    encode,
    encoder_schema,
    grad_mode,
    patch_proj_schema,
    remat_layers,
)


def pattern_period(cfg: ModelConfig) -> int:
    """Smallest p such that layer schemas repeat with period p."""
    p = 1
    if cfg.attn_every_k > 1:
        p = cfg.attn_every_k
    if cfg.moe is not None and cfg.moe.every_k_layers > 1:
        p = math.lcm(p, cfg.moe.every_k_layers)
    return p


def _stack(schema: Schema, ng: int) -> Schema:
    return {name: (ParamSpec((ng,) + spec.shape, init=spec.init, scale=spec.scale)
                   if isinstance(spec, ParamSpec) else _stack(spec, ng))
            for name, spec in schema.items()}


def stack_schema(cfg: ModelConfig) -> tuple[Schema, int, int]:
    """(schema, group_size, num_groups).  Layer parameters live under
    ``groups.pos_{j}`` with a leading ``[num_groups]`` axis; the patch
    projector and the encoder's layers are the unrolled tree's."""
    gs = pattern_period(cfg)
    if cfg.num_layers % gs:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole groups of {gs}")
    ng = cfg.num_layers // gs
    s: Schema = {"embed": embed_schema(cfg.vocab, cfg.d_model), **patch_proj_schema(cfg)}
    s["groups"] = {f"pos_{j}": _stack(_decoder_layer_schema(cfg, j), ng) for j in range(gs)}
    s["norm_f"] = norm_schema(cfg.norm, cfg.d_model)
    s.update(encoder_schema(cfg))
    return s, gs, ng


@torch.no_grad()
def stack_params(params, cfg: ModelConfig) -> ParamNode:
    """The unrolled tree's weights (``layer_{i}``) as the stacked tree:
    layer ``g·p + j`` is slice ``g`` of ``groups.pos_{j}``."""
    schema, gs, _ = stack_schema(cfg)
    dtype, device = params["norm_f"]["gamma"].dtype, params["norm_f"]["gamma"].device
    out = empty_params(schema, dtype, device)
    layers = dict(params.named_parameters())
    for path, p in out.named_parameters():
        if path.startswith("groups."):
            _, pos, rest = path.split(".", 2)
            j = int(pos[len("pos_"):])
            for g in range(p.shape[0]):
                p[g].copy_(layers[f"layer_{g * gs + j}.{rest}"])
        else:
            p.copy_(layers[path])
    return out


def _group(node, g: int) -> dict:
    """Slice ``g`` of every stacked leaf under ``node``, as a nested dict."""
    return {name: (leaf[g] if isinstance(leaf, torch.Tensor) else _group(leaf, g))
            for name, leaf in list(node.named_parameters(recurse=False)) + list(node.named_children())}


def forward_lm_stacked(params, batch: dict, cfg: ModelConfig, run: RunConfig, *,
                       mode: str = "train", moe_groups: int = 1, last_only: bool = False,
                       moe_stats: list | None = None) -> torch.Tensor:
    """``forward_lm``'s semantics on the stacked tree (``stack_schema``);
    with ``run.remat`` in ``train`` mode each group is recomputed in the
    backward, as the reference's per-group ``jax.checkpoint``."""
    gs = pattern_period(cfg)
    with grad_mode(mode):
        x = embed_inputs(params, batch, cfg)
        cross_out = encode(params, batch, cfg, run)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        remat = remat_layers(mode, run)
        for g in range(cfg.num_layers // gs):

            def group(x, cross_out, g=g):
                for j in range(gs):
                    pl = _group(params["groups"][f"pos_{j}"], g)
                    cross_kv = None if cross_out is None else _cross_kv(pl["cross"], cross_out, cfg)
                    x = _decoder_layer(pl, x, cfg, run, j, positions=positions, moe_groups=moe_groups,
                                       moe_stats=moe_stats, cross_kv=cross_kv)
                return x

            x = checkpoint(group, x, cross_out, use_reentrant=False) if remat else group(x, cross_out)
        x = apply_norm(cfg.norm, params["norm_f"], x)
        if last_only:
            x = x[:, -1:]
        return apply_unembed(params["embed"], x)
