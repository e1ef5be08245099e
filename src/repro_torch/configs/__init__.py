"""Selectable configurations: the ten model architectures of the serving
stack (``ARCHS``, ``get_config``) and the paper's own
evaluation setups (``exsample_paper``).

Counterpart of ``repro.configs``, data only.  The port's model runs
every family: dense, ssm, moe, hybrid, vlm and audio.
"""
from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b,
    gemma_7b,
    granite_20b,
    granite_moe_1b_a400m,
    jamba_1_5_large_398b,
    mamba2_370m,
    phi3_medium_14b,
    phi3_vision_4_2b,
    qwen2_5_32b,
    whisper_base,
)
from repro_torch.configs.base import ModelConfig, MoEConfig, RunConfig, SSMConfig, scale_down

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        dbrx_132b,
        granite_moe_1b_a400m,
        jamba_1_5_large_398b,
        phi3_medium_14b,
        qwen2_5_32b,
        granite_20b,
        gemma_7b,
        mamba2_370m,
        phi3_vision_4_2b,
        whisper_base,
    )
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = [
    "ARCHS", "get_config",
    "ModelConfig", "MoEConfig", "SSMConfig", "RunConfig", "scale_down",
]
