"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

attn_every_k=8 realizes the 1:7 attention:mamba ratio (layer 7, 15, ... are
attention).  MoE is applied every 2nd layer per the Jamba paper.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    mlp="swiglu",
    rope_theta=1_000_000.0,
    attn_every_k=8,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576, every_k_layers=2),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk_len=1024),
)
