"""gemma-7b — GeGLU, head_dim=256 (16 heads × 256 = 4096 ≠ d_model 3072;
o_proj maps back).  [arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    mlp="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
