"""Serving steps: prefill and greedy decode of the LM (dense and ssm families).

Counterpart of ``repro.serve.serve_step``'s ``build_prefill_step`` and
``build_decode_step``, with the same returns: prefill gives the
next-token logits of the prompt's last position (and, as in the
reference, no decode cache), decode one greedy token against the cache.
``build_detect_step`` comes with a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.transformer import DecodeCache, forward_decode, forward_lm


def build_prefill_step(cfg: ModelConfig, run: RunConfig):
    def prefill(params, batch: dict) -> torch.Tensor:
        logits = forward_lm(params, batch, cfg, run, mode="prefill", last_only=True)
        return logits[:, -1]          # next-token logits [B, V]

    return prefill


def build_decode_step(cfg: ModelConfig, run: RunConfig):
    def decode(params, token: torch.Tensor, cache: DecodeCache):
        logits, cache = forward_decode(params, token, cache, cfg, run)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, cache

    return decode
