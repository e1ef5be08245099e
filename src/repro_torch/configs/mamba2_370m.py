"""mamba2-370m — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]

d_inner = 2×1024 = 2048, head_dim 64 ⇒ 32 SSM heads; no FFN sublayer
(d_ff=0 per the assignment).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab=50280,
    mlp="gelu",
    attn_every_k=0,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk_len=1024),
)
