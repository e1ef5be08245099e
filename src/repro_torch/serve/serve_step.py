"""Serving steps: prefill and greedy decode of the LM, and the detector step of ExSample.

Counterpart of ``repro.serve.serve_step``, with the same returns: prefill
gives the next-token logits of the prompt's last position (and, as in the
reference, no decode cache), decode one greedy token against the cache,
and the detector step a frame batch's ``HeadOutput``.  With
``run.stacked`` the prefill runs the stacked forward on the stacked tree
(``models.stacked``), as the reference's does.  Each LM step takes a
``moe_stats`` list to which its MoE layers append their ``MoEStats``
(which changes no output).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.detection import HeadOutput, apply_head, pool_features
from repro_torch.models.layers import apply_norm
from repro_torch.models.stacked import forward_lm_stacked
from repro_torch.models.transformer import (
    DecodeCache,
    _decoder_layer,
    embed_inputs,
    forward_decode,
    forward_lm,
)


def build_prefill_step(cfg: ModelConfig, run: RunConfig, *, moe_groups: int = 1):
    fwd = forward_lm_stacked if run.stacked else forward_lm

    def prefill(params, batch: dict, *, moe_stats: list | None = None) -> torch.Tensor:
        logits = fwd(params, batch, cfg, run, mode="prefill", moe_groups=moe_groups,
                     last_only=True, moe_stats=moe_stats)
        return logits[:, -1]          # next-token logits [B, V]

    return prefill


def build_decode_step(cfg: ModelConfig, run: RunConfig, *, moe_groups: int = 1):
    def decode(params, token: torch.Tensor, cache: DecodeCache, *, moe_stats: list | None = None):
        logits, cache = forward_decode(params, token, cache, cfg, run, moe_groups=moe_groups,
                                       moe_stats=moe_stats)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, cache

    return decode


def build_detect_step(cfg: ModelConfig, run: RunConfig, *, max_dets: int, num_classes: int,
                      feat_dim: int, moe_groups: int = 1):
    """A frame batch → detections.  The frame enters as a short sequence
    (``batch["patches"]`` before ``batch["tokens"]`` for the vlm family,
    tokens otherwise); every decoder layer runs with no cross K/V (B4
    causal in each attention layer), then ``norm_f``; the features (not
    the logits) are mean-pooled and the detection head emits
    ``max_dets`` slots a frame."""

    @torch.no_grad()
    def detect(params, head_params, batch: dict) -> HeadOutput:
        x = embed_inputs(params, batch, cfg)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for i in range(cfg.num_layers):
            x = _decoder_layer(params[f"layer_{i}"], x, cfg, run, i, positions=positions,
                               moe_groups=moe_groups, moe_stats=None)
        hidden = apply_norm(cfg.norm, params["norm_f"], x)
        return apply_head(head_params, pool_features(hidden), max_dets=max_dets,
                          num_classes=num_classes, feat_dim=feat_dim)

    return detect
