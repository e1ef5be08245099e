"""Config dataclasses: model architecture and run settings.

Counterpart of ``repro.configs.base`` (plain data).  ``ModelConfig`` and
its parts are the reference's field for field and fully determine the
parameter schema and forward semantics; ``RunConfig`` carries the
execution knobs the port reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden width
    capacity_factor: float = 1.25
    every_k_layers: int = 1        # jamba applies MoE every 2nd layer
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_len: int = 1024          # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 ⇒ d_model // num_heads
    mlp: str = "swiglu"            # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every_k: int = 1          # hybrid: layer l is attention iff (l % k == k-1); 1 ⇒ all attn; 0 ⇒ attn-free
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False
    encoder_len: int = 1500        # cross-KV length (whisper 30 s @ 50 Hz)
    # multimodal stub frontends
    num_patches: int = 0           # vlm: image patches prepended to the sequence
    patch_dim: int = 0             # vlm: raw patch embedding width (CLIP stub)
    frontend: str = "none"         # none | vision | audio

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")

    def is_attn_layer(self, layer: int) -> bool:
        if self.attn_every_k == 0:
            return False
        if self.attn_every_k == 1:
            return True
        return layer % self.attn_every_k == (self.attn_every_k - 1)

    def is_moe_layer(self, layer: int) -> bool:
        return self.moe is not None and layer % self.moe.every_k_layers == (
            self.moe.every_k_layers - 1
        )


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs (orthogonal to architecture).

    The reference's ``RunConfig`` also carries tiling, sharding and MoE
    knobs; the port keeps the fields its serving and training paths read,
    with the reference's defaults, and adds the others with the slice that
    first reads them.  ``stacked`` picks the stacked forward
    (``models.stacked``), ``remat`` recomputes each layer (each stacked
    group) in the backward (``torch.utils.checkpoint``), and the training
    fields feed ``train.train_step``.  Not here: ``moe_token_exchange``,
    ``fsdp_params``, ``sequence_parallel`` and ``grad_compression``, which
    only the mesh and the sharding hints read (ROADMAP A13.6c).
    """

    param_dtype: str = "bfloat16"
    probs_bf16: bool = False           # bf16 attention probabilities: not on the port's path
    stacked: bool = False              # layers stacked by pattern period (models.stacked)
    # training
    remat: bool = True
    microbatches: int = 1              # gradient-accumulation chunks per step
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    adam_8bit: bool = False            # 8-bit optimizer state

    def dtype(self):
        import torch

        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.param_dtype]


def scale_down(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
               heads: int = 4, kv_heads: int = 0, d_ff: int = 128,
               vocab: int = 256) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kv = kv_heads or min(cfg.num_kv_heads, heads)
    kv = max(1, min(kv, heads))
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff=d_ff,
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=16, chunk_len=32)
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=(64 if cfg.head_dim else 0),
        d_ff=d_ff,
        vocab=vocab,
        moe=moe,
        ssm=ssm,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_len=min(cfg.encoder_len, 16),
        num_patches=min(cfg.num_patches, 8),
        patch_dim=min(cfg.patch_dim, 32) if cfg.patch_dim else 0,
    )
