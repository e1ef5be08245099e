"""The decoder-only LM of the serving path: prefill and decode.

Counterpart of the dense, ssm, moe and hybrid subsets of
``repro.models.transformer`` (phi3, qwen2.5 with its QKV bias,
granite-20b's MQA, gemma's GeGLU and wide heads; mamba2's attention-free
stack; dbrx's and granite-moe's experts; jamba's Mamba-2/attention
interleave with experts on every second layer).  Parameters are a
``ParamNode`` tree whose names are the reference's paths
(``layer_{i}.attn.wq``, ``layer_{i}.mamba.wx``, ``layer_{i}.moe.w_up``,
...) in the reference's orientation (``x @ w``), so
``repro_torch.convert`` copies a reference parameter tree key for key.
A layer is attention or Mamba-2 as ``cfg.is_attn_layer`` says, followed
by the MoE block where ``cfg.is_moe_layer`` says so and else by a dense
MLP when ``d_ff > 0``.  Prefill attention runs through kernel B4 and the
Mamba-2 SSD through kernel B6, one launch per layer each; decode
attention through kernel B5, one launch per layer and token.  The MoE
block (``models.moe``) routes the layer's B·S tokens in ``moe_groups``
groups and runs no kernel of its own.  The vlm and audio families raise
``NotImplementedError``.

Decode keeps the position as a host ``int`` and writes the new K/V rows
into the cache in place (the reference's ``dynamic_update_slice`` returns
a new cache; here the returned ``DecodeCache`` holds the same tensors).
A Mamba-2 layer's cache is replaced by a new ``MambaCache`` each step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve
from repro_torch.models import mamba2
from repro_torch.models.attention import blocked_attention, decode_attention
from repro_torch.models.layers import (
    ParamNode,
    ParamSpec,
    Schema,
    apply_embed,
    apply_mlp,
    apply_norm,
    apply_rope,
    apply_unembed,
    embed_schema,
    empty_params,
    materialize,
    mlp_schema,
    norm_schema,
)
from repro_torch.models.moe import apply_moe, moe_schema

SUPPORTED_FAMILIES = ("dense", "ssm", "moe", "hybrid")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in SUPPORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port runs "
            f"the {' and '.join(SUPPORTED_FAMILIES)} families only")


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------

def _attn_schema(cfg: ModelConfig) -> Schema:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s: Schema = {
        "wq": ParamSpec((d, h * hd)),
        "wk": ParamSpec((d, kv * hd)),
        "wv": ParamSpec((d, kv * hd)),
        "wo": ParamSpec((h * hd, d)),
    }
    if cfg.qkv_bias:
        s.update(
            bq=ParamSpec((h * hd,), init="zeros"),
            bk=ParamSpec((kv * hd,), init="zeros"),
            bv=ParamSpec((kv * hd,), init="zeros"),
        )
    return s


def _decoder_layer_schema(cfg: ModelConfig, layer: int) -> Schema:
    s: Schema = {"norm1": norm_schema(cfg.norm, cfg.d_model)}
    if cfg.is_attn_layer(layer):
        s["attn"] = _attn_schema(cfg)
    else:
        s["mamba"] = mamba2.mamba_schema(cfg.d_model, cfg.ssm)
    if cfg.is_moe_layer(layer):
        s["norm2"] = norm_schema(cfg.norm, cfg.d_model)
        s["moe"] = moe_schema(cfg.d_model, cfg.moe, cfg.mlp)
    elif cfg.d_ff > 0:
        s["norm2"] = norm_schema(cfg.norm, cfg.d_model)
        s["mlp"] = mlp_schema(cfg.d_model, cfg.d_ff, cfg.mlp)
    return s


def backbone_schema(cfg: ModelConfig) -> Schema:
    require_ported(cfg)
    s: Schema = {"embed": embed_schema(cfg.vocab, cfg.d_model)}
    for i in range(cfg.num_layers):
        s[f"layer_{i}"] = _decoder_layer_schema(cfg, i)
    s["norm_f"] = norm_schema(cfg.norm, cfg.d_model)
    return s


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None) -> ParamNode:
    """Random weights from ``seed``, made on ``device`` (default: the card)."""
    return materialize(backbone_schema(cfg), seed, dtype, resolve(device))


def empty_model(cfg: ModelConfig, dtype=torch.float32, device=None) -> ParamNode:
    """The parameter tree with uninitialised tensors (filled by ``convert``)."""
    return empty_params(backbone_schema(cfg), dtype, resolve(device))


# --------------------------------------------------------------------------
# sublayers
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor     # [B, T, KV, hd]
    v: torch.Tensor


def _qkv(p, h_in: torch.Tensor, cfg: ModelConfig):
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b, s, _ = h_in.shape
    q = h_in @ p["wq"]
    k = h_in @ p["wk"]
    v = h_in @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd)


def _self_attention(p, x_norm: torch.Tensor, cfg: ModelConfig, run: RunConfig, *,
                    causal: bool, positions: torch.Tensor) -> torch.Tensor:
    q, k, v = _qkv(p, x_norm, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = blocked_attention(q, k, v, causal=causal, probs_bf16=run.probs_bf16)
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ p["wo"]


def _ffn(pl, x: torch.Tensor, cfg: ModelConfig, layer: int, moe_groups: int,
         moe_stats: list | None) -> torch.Tensor:
    """Post-mixer feed-forward sublayer (dense MLP or MoE), with residual;
    none when d_ff = 0.  The MoE routes the B·S tokens as ``g = max(min(
    moe_groups, B·S), 1)`` groups of B·S/g and appends its ``MoEStats`` to
    ``moe_stats`` when given (which changes no output)."""
    if cfg.is_moe_layer(layer):
        h = apply_norm(cfg.norm, pl["norm2"], x)
        b, s, d = h.shape
        g = max(min(moe_groups, b * s), 1)
        if (b * s) % g:
            raise ValueError(f"moe_groups {g} does not divide the {b * s} tokens of the batch")
        y, stats = apply_moe(pl["moe"], h.reshape(g, (b * s) // g, d), cfg.moe, mlp_kind=cfg.mlp)
        if moe_stats is not None:
            moe_stats.append(stats)
        return x + y.reshape(b, s, d)
    if "mlp" in pl:
        h = apply_norm(cfg.norm, pl["norm2"], x)
        return x + apply_mlp(pl["mlp"], h, cfg.mlp)
    return x


def _decoder_layer(pl, x: torch.Tensor, cfg: ModelConfig, run: RunConfig, layer: int, *,
                   positions: torch.Tensor, moe_groups: int,
                   moe_stats: list | None) -> torch.Tensor:
    h = apply_norm(cfg.norm, pl["norm1"], x)
    if cfg.is_attn_layer(layer):
        x = x + _self_attention(pl["attn"], h, cfg, run, causal=True, positions=positions)
    else:
        x = x + mamba2.apply_mamba(pl["mamba"], h, cfg.ssm)
    return _ffn(pl, x, cfg, layer, moe_groups, moe_stats)


# --------------------------------------------------------------------------
# full forward passes
# --------------------------------------------------------------------------

def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return apply_embed(params["embed"], tokens, cfg.d_model)


@torch.no_grad()
def forward_lm(params, batch: dict, cfg: ModelConfig, run: RunConfig, *,
               mode: str = "train", moe_groups: int = 1, last_only: bool = False,
               moe_stats: list | None = None) -> torch.Tensor:
    """Causal LM forward → logits [B, S, V] ([B, 1, V] with ``last_only``).
    ``batch["tokens"]`` int[B, S]; modes ``train`` and ``prefill`` run the
    same forward (no remat or sequence sharding in the port).  Each MoE
    layer appends its ``MoEStats`` to ``moe_stats`` when given."""
    require_ported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    x = embed_tokens(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.num_layers):
        x = _decoder_layer(params[f"layer_{i}"], x, cfg, run, i, positions=positions,
                           moe_groups=moe_groups, moe_stats=moe_stats)
    x = apply_norm(cfg.norm, params["norm_f"], x)
    if last_only:
        x = x[:, -1:]              # only the next-token position matters
    return apply_unembed(params["embed"], x)


# --------------------------------------------------------------------------
# decode path (serve_step)
# --------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Per-layer caches and the number of tokens already in them (the
    same for every sequence of the batch), a host int.  The reference's
    ``cross`` (encoder-decoder caches) has no use in the dense family."""

    layers: tuple          # per layer: KVCache (attention) or MambaCache (Mamba-2)
    pos: int


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device=None) -> DecodeCache:
    require_ported(cfg)
    dev = resolve(device)
    hd = cfg.resolved_head_dim if cfg.num_heads else 0
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    layers = tuple(
        KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                v=torch.zeros(shape, dtype=dtype, device=dev))
        if cfg.is_attn_layer(i) else mamba2.init_cache(batch, cfg.d_model, cfg.ssm, dtype, dev)
        for i in range(cfg.num_layers))
    return DecodeCache(layers=layers, pos=0)


@torch.no_grad()
def forward_decode(params, token: torch.Tensor, cache: DecodeCache, cfg: ModelConfig,
                   run: RunConfig, *, moe_groups: int = 1,
                   moe_stats: list | None = None) -> tuple[torch.Tensor, DecodeCache]:
    """One autoregressive step: token int[B, 1] → (logits [B, V], the cache
    one position longer).  The new K/V rows are written in place; a Mamba-2
    layer's cache is replaced.  An MoE layer routes the step's B tokens
    (capacity from B, not from the cache) and appends its ``MoEStats`` to
    ``moe_stats`` when given."""
    require_ported(cfg)
    b = token.shape[0]
    pos = cache.pos
    kv_len = next((c.k.shape[1] for c in cache.layers if isinstance(c, KVCache)), None)
    if kv_len is not None and pos >= kv_len:
        raise ValueError(f"decode cache full: position {pos} of {kv_len}")
    x = embed_tokens(params, token, cfg)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    layers = []
    for i in range(cfg.num_layers):
        pl = params[f"layer_{i}"]
        h = apply_norm(cfg.norm, pl["norm1"], x)
        if cfg.is_attn_layer(i):
            q, k_new, v_new = _qkv(pl["attn"], h, cfg)
            q = apply_rope(q, positions, cfg.rope_theta)
            k_new = apply_rope(k_new, positions, cfg.rope_theta)
            kc: KVCache = cache.layers[i]
            kc.k[:, pos:pos + 1] = k_new.to(kc.k.dtype)
            kc.v[:, pos:pos + 1] = v_new.to(kc.v.dtype)
            o = decode_attention(q, kc.k, kc.v, cache_len=cache_len)
            x = x + o.reshape(b, 1, -1) @ pl["attn"]["wo"]
            layers.append(kc)
        else:
            y, mc = mamba2.apply_mamba_decode(pl["mamba"], h, cache.layers[i], cfg.ssm)
            x = x + y
            layers.append(mc)
        x = _ffn(pl, x, cfg, i, moe_groups, moe_stats)
    x = apply_norm(cfg.norm, params["norm_f"], x)
    logits = apply_unembed(params["embed"], x)[:, 0]
    return logits, DecodeCache(layers=tuple(layers), pos=pos + 1)
