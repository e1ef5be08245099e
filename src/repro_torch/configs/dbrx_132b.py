"""dbrx-132b — MoE 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    mlp="swiglu",
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff=10752),
)
