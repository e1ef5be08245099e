"""Serving steps: prefill and greedy decode of the LM (dense, ssm, moe and hybrid families).

Counterpart of ``repro.serve.serve_step``'s ``build_prefill_step`` and
``build_decode_step``, with the same returns: prefill gives the
next-token logits of the prompt's last position (and, as in the
reference, no decode cache), decode one greedy token against the cache.
With ``run.stacked`` the prefill runs the stacked forward on the stacked
tree (``models.stacked``), as the reference's does.  Each step takes a
``moe_stats`` list to which its MoE layers append their ``MoEStats``
(which changes no output).  ``build_detect_step`` comes with a later
slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.stacked import forward_lm_stacked
from repro_torch.models.transformer import DecodeCache, forward_decode, forward_lm


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
