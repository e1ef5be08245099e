"""whisper-base — enc-dec audio backbone, conv frontend stubbed.
[arXiv:2212.04356; unverified]

The conv1d stem is a STUB: ``input_specs()`` supplies precomputed frame
embeddings [B, T, 512] fed straight to the 6-layer bidirectional encoder;
the 6-layer decoder cross-attends to the encoder output (cross-KV length
1500 = 30 s at 50 Hz).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    mlp="gelu",
    norm="layernorm",
    rope_theta=10_000.0,
    encoder_layers=6,
    cross_attention=True,
    encoder_len=1500,
    frontend="audio",
)
