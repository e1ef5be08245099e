"""The LM of the serving and training paths: the forward, decode and the
loss, every family of ``ARCHS``.

Counterpart of ``repro.models.transformer`` (phi3, qwen2.5 with its QKV
bias, granite-20b's MQA, gemma's GeGLU and wide heads; mamba2's
attention-free stack; dbrx's and granite-moe's experts; jamba's
Mamba-2/attention interleave with experts on every second layer;
phi-3-vision's patch projector before the token rows; whisper's
bidirectional encoder over frame embeddings and the decoder's
cross-attention to it).  Parameters are a ``ParamNode`` tree whose names
are the reference's paths (``layer_{i}.attn.wq``, ``layer_{i}.cross.wq``,
``enc_{i}.mlp.w_up``, ``patch_proj.w``, ...) in the reference's
orientation (``x @ w``), so ``repro_torch.convert`` copies a reference
parameter tree key for key.  A layer is attention or Mamba-2 as
``cfg.is_attn_layer`` says, then (with ``cfg.cross_attention`` and an
encoder output) the cross-attention block, then the MoE block where
``cfg.is_moe_layer`` says so and else a dense MLP when ``d_ff > 0``.
Prefill attention runs through kernel B4 (causal in the decoder, full in
the encoder and the cross-attention, whose K/V arrive un-repeated) and
the Mamba-2 SSD through kernel B6, one launch per layer each; decode
attention through kernel B5, one launch per layer and token, and one more
per cross-attention layer and token over the whole cross cache.  The MoE
block (``models.moe``) routes the layer's B·S tokens in ``moe_groups``
groups and runs no kernel of its own.  The forward's ``train`` mode is
differentiable (B4's autograd function pairs it with its backward kernel
on the card), with ``run.remat`` recomputing each layer in the backward;
``prefill`` and decode run under ``torch.no_grad``.  ``lm_loss``,
``pad_heads`` and ``pad_vocab`` are the reference's.

Decode keeps the position as a host ``int`` and writes the new K/V rows
into the cache in place (the reference's ``dynamic_update_slice`` returns
a new cache; here the returned ``DecodeCache`` holds the same tensors).
A Mamba-2 layer's cache is replaced by a new ``MambaCache`` each step.
The cross caches are zeros of ``encoder_len`` rows from
``init_decode_cache`` and are returned unchanged, as in the reference:
nothing fills them, so a decode step never reads the frames (ROADMAP C14).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

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
    materialize,
    mlp_schema,
    norm_schema,
)
from repro_torch.models.moe import apply_moe, moe_schema

# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------

def _attn_schema(cfg: ModelConfig, *, cross: bool = False) -> Schema:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s: Schema = {
        "wq": ParamSpec((d, h * hd)),
        "wk": ParamSpec((d, kv * hd)),
        "wv": ParamSpec((d, kv * hd)),
        "wo": ParamSpec((h * hd, d)),
    }
    if cfg.qkv_bias and not cross:
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
    if cfg.cross_attention:
        s["norm_x"] = norm_schema(cfg.norm, cfg.d_model)
        s["cross"] = _attn_schema(cfg, cross=True)
    if cfg.is_moe_layer(layer):
        s["norm2"] = norm_schema(cfg.norm, cfg.d_model)
        s["moe"] = moe_schema(cfg.d_model, cfg.moe, cfg.mlp)
    elif cfg.d_ff > 0:
        s["norm2"] = norm_schema(cfg.norm, cfg.d_model)
        s["mlp"] = mlp_schema(cfg.d_model, cfg.d_ff, cfg.mlp)
    return s


def _encoder_layer_schema(cfg: ModelConfig) -> Schema:
    return {
        "norm1": norm_schema(cfg.norm, cfg.d_model),
        "attn": _attn_schema(cfg),
        "norm2": norm_schema(cfg.norm, cfg.d_model),
        "mlp": mlp_schema(cfg.d_model, cfg.d_ff, cfg.mlp),
    }


def patch_proj_schema(cfg: ModelConfig) -> Schema:
    """The vlm's patch projector (none without patches)."""
    if not (cfg.num_patches and cfg.patch_dim):
        return {}
    return {"patch_proj": {"w": ParamSpec((cfg.patch_dim, cfg.d_model)),
                           "b": ParamSpec((cfg.d_model,), init="zeros")}}


def encoder_schema(cfg: ModelConfig) -> Schema:
    """The audio encoder's layers and final norm (none without an encoder)."""
    s: Schema = {f"enc_{i}": _encoder_layer_schema(cfg) for i in range(cfg.encoder_layers)}
    if cfg.encoder_layers:
        s["enc_norm_f"] = norm_schema(cfg.norm, cfg.d_model)
    return s


def backbone_schema(cfg: ModelConfig) -> Schema:
    s: Schema = {"embed": embed_schema(cfg.vocab, cfg.d_model), **patch_proj_schema(cfg)}
    for i in range(cfg.num_layers):
        s[f"layer_{i}"] = _decoder_layer_schema(cfg, i)
    s["norm_f"] = norm_schema(cfg.norm, cfg.d_model)
    s.update(encoder_schema(cfg))
    return s


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None) -> ParamNode:
    """Random weights from ``seed``, made on ``device`` (default: the card)."""
    return materialize(backbone_schema(cfg), seed, dtype, resolve(device))


def pad_heads(cfg: ModelConfig, multiple: int) -> ModelConfig:
    """Head counts rounded up to ``multiple`` (the reference pads for
    tensor-parallel sharding); the KV heads grow until they divide the
    heads, and the head width stays the unpadded model's."""
    h = -(-cfg.num_heads // multiple) * multiple
    if h == cfg.num_heads:
        return cfg
    kv = cfg.num_kv_heads
    while h % kv:
        kv += 1
    return dataclasses.replace(cfg, num_heads=h, num_kv_heads=kv, head_dim=cfg.resolved_head_dim)


def pad_vocab(cfg: ModelConfig, multiple: int) -> ModelConfig:
    """The vocabulary rounded up to ``multiple`` (padded ids never drawn)."""
    v = -(-cfg.vocab // multiple) * multiple
    return cfg if v == cfg.vocab else dataclasses.replace(cfg, vocab=v)


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


def _cross_attention(p, x_norm: torch.Tensor, cross_kv: KVCache, cfg: ModelConfig) -> torch.Tensor:
    """Full attention of the decoder's rows over the encoder's K/V: no
    RoPE, no bias, K/V un-repeated (B4's GQA)."""
    b, s, _ = x_norm.shape
    q = (x_norm @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)
    o = blocked_attention(q, cross_kv.k, cross_kv.v, causal=False)
    return o.reshape(b, s, -1) @ p["wo"]


def _cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig) -> KVCache:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    b, t, _ = enc_out.shape
    return KVCache(k=(enc_out @ p["wk"]).reshape(b, t, kv, hd),
                   v=(enc_out @ p["wv"]).reshape(b, t, kv, hd))


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
                   positions: torch.Tensor, moe_groups: int, moe_stats: list | None,
                   cross_kv: KVCache | None = None) -> torch.Tensor:
    h = apply_norm(cfg.norm, pl["norm1"], x)
    if cfg.is_attn_layer(layer):
        x = x + _self_attention(pl["attn"], h, cfg, run, causal=True, positions=positions)
    else:
        x = x + mamba2.apply_mamba(pl["mamba"], h, cfg.ssm)
    if cross_kv is not None and cfg.cross_attention:
        hx = apply_norm(cfg.norm, pl["norm_x"], x)
        x = x + _cross_attention(pl["cross"], hx, cross_kv, cfg)
    return _ffn(pl, x, cfg, layer, moe_groups, moe_stats)


# --------------------------------------------------------------------------
# full forward passes
# --------------------------------------------------------------------------

def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return apply_embed(params["embed"], tokens, cfg.d_model)


def embed_vlm(params, tokens: torch.Tensor, patches: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The vlm's stub frontend: precomputed patch embeddings [B, P,
    patch_dim] through the linear projector, their rows before the token
    rows ([B, P + S, D]; P may be 0)."""
    tok = apply_embed(params["embed"], tokens, cfg.d_model)
    img = patches @ params["patch_proj"]["w"] + params["patch_proj"]["b"]
    return torch.cat([img.to(tok.dtype), tok], dim=1)


def embed_inputs(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """The decoder's input rows: ``embed_vlm`` for the vlm family
    (``batch["patches"]``), else the token embedding."""
    if cfg.family == "vlm":
        return embed_vlm(params, batch["tokens"], batch["patches"], cfg)
    return embed_tokens(params, batch["tokens"], cfg)


def encoder_forward(params, frames: torch.Tensor, cfg: ModelConfig, run: RunConfig) -> torch.Tensor:
    """The bidirectional encoder over stub frame embeddings [B, T, D]
    (B4 with ``causal=False`` in every layer), then its final norm."""
    x = frames
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.encoder_layers):
        pl = params[f"enc_{i}"]
        h = apply_norm(cfg.norm, pl["norm1"], x)
        x = x + _self_attention(pl["attn"], h, cfg, run, causal=False, positions=positions)
        h = apply_norm(cfg.norm, pl["norm2"], x)
        x = x + apply_mlp(pl["mlp"], h, cfg.mlp)
    return apply_norm(cfg.norm, params["enc_norm_f"], x)


def encode(params, batch: dict, cfg: ModelConfig, run: RunConfig) -> torch.Tensor | None:
    """The encoder's output over ``batch["frames"]`` (None without an encoder)."""
    return encoder_forward(params, batch["frames"], cfg, run) if cfg.encoder_layers else None


def grad_mode(mode: str):
    """The autograd context of a forward in ``mode``: ``prefill`` runs
    under ``torch.no_grad``; ``train`` records a graph wherever a
    parameter or input requires a gradient."""
    if mode == "prefill":
        return torch.no_grad()
    if mode == "train":
        return contextlib.nullcontext()
    raise ValueError(f"unknown mode {mode!r}")


def remat_layers(mode: str, run: RunConfig) -> bool:
    """Whether a ``train`` forward recomputes each layer in the backward
    (``run.remat``, as the reference's ``jax.checkpoint``)."""
    return mode == "train" and run.remat and torch.is_grad_enabled()


def forward_lm(params, batch: dict, cfg: ModelConfig, run: RunConfig, *,
               mode: str = "train", moe_groups: int = 1, last_only: bool = False,
               moe_stats: list | None = None) -> torch.Tensor:
    """Causal LM forward → logits [B, S, V] ([B, 1, V] with ``last_only``).
    ``batch["tokens"]`` int[B, S], with ``"patches"`` [B, P, patch_dim]
    (vlm: S grows by P) or ``"frames"`` [B, T, D] (audio).  ``prefill``
    runs under ``torch.no_grad``; ``train`` is differentiable (B4's
    backward on the card), and with ``run.remat`` each decoder layer runs
    under ``torch.utils.checkpoint`` and is recomputed in the backward.
    Each MoE layer appends its ``MoEStats`` to ``moe_stats`` when given
    (a recomputed layer appends again)."""
    with grad_mode(mode):
        x = embed_inputs(params, batch, cfg)
        cross_out = encode(params, batch, cfg, run)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        remat = remat_layers(mode, run)
        for i in range(cfg.num_layers):
            pl = params[f"layer_{i}"]

            def layer(x, cross_out, pl=pl, i=i):
                cross_kv = None if cross_out is None else _cross_kv(pl["cross"], cross_out, cfg)
                return _decoder_layer(pl, x, cfg, run, i, positions=positions, moe_groups=moe_groups,
                                      moe_stats=moe_stats, cross_kv=cross_kv)

            x = checkpoint(layer, x, cross_out, use_reentrant=False) if remat else layer(x, cross_out)
        x = apply_norm(cfg.norm, params["norm_f"], x)
        if last_only:
            x = x[:, -1:]              # only the next-token position matters
        return apply_unembed(params["embed"], x)


# --------------------------------------------------------------------------
# decode path (serve_step)
# --------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Per-layer caches, the number of tokens already in them (the same
    for every sequence of the batch) as a host int, and per layer the
    cross-attention's K/V over the encoder (None without cross-attention)."""

    layers: tuple          # per layer: KVCache (attention) or MambaCache (Mamba-2)
    pos: int
    cross: tuple           # per layer: KVCache [B, encoder_len, KV, hd] or None


def _zero_kv(shape, dtype, device) -> KVCache:
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device=None) -> DecodeCache:
    """Zeroed caches: K/V of ``max_len`` rows (attention layers) or a
    zero conv window and state (Mamba-2 layers), and zeroed cross K/V of
    ``cfg.encoder_len`` rows where the model cross-attends."""
    dev = resolve(device)
    kv, hd = cfg.num_kv_heads, (cfg.resolved_head_dim if cfg.num_heads else 0)
    layers = tuple(
        _zero_kv((batch, max_len, kv, hd), dtype, dev)
        if cfg.is_attn_layer(i) else mamba2.init_cache(batch, cfg.d_model, cfg.ssm, dtype, dev)
        for i in range(cfg.num_layers))
    cross = tuple(_zero_kv((batch, cfg.encoder_len, kv, hd), dtype, dev) if cfg.cross_attention else None
                  for _ in range(cfg.num_layers))
    return DecodeCache(layers=layers, pos=0, cross=cross)


@torch.no_grad()
def forward_decode(params, token: torch.Tensor, cache: DecodeCache, cfg: ModelConfig,
                   run: RunConfig, *, moe_groups: int = 1,
                   moe_stats: list | None = None) -> tuple[torch.Tensor, DecodeCache]:
    """One autoregressive step: token int[B, 1] → (logits [B, V], the cache
    one position longer).  The new K/V rows are written in place; a Mamba-2
    layer's cache is replaced.  A cross-attention layer attends over every
    row of its cross cache (B5 with ``cache_len`` = its length), which is
    returned unchanged.  An MoE layer routes the step's B tokens (capacity
    from B, not from the cache) and appends its ``MoEStats`` to
    ``moe_stats`` when given."""
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
        ckv = cache.cross[i]
        if cfg.cross_attention and ckv is not None:
            hx = apply_norm(cfg.norm, pl["norm_x"], x)
            q = (hx @ pl["cross"]["wq"]).reshape(b, 1, cfg.num_heads, cfg.resolved_head_dim)
            whole = torch.full((b,), ckv.k.shape[1], dtype=torch.int32, device=x.device)
            o = decode_attention(q, ckv.k, ckv.v, cache_len=whole)
            x = x + o.reshape(b, 1, -1) @ pl["cross"]["wo"]
        x = _ffn(pl, x, cfg, i, moe_groups, moe_stats)
    x = apply_norm(cfg.norm, params["norm_f"], x)
    logits = apply_unembed(params["embed"], x)[:, 0]
    return logits, DecodeCache(layers=tuple(layers), pos=pos + 1, cross=cache.cross)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32: logits [..., V], labels int[...]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)
