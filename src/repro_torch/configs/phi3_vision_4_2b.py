"""phi-3-vision-4.2b — phi3-mini backbone + CLIP stub frontend.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The modality frontend is a STUB per the assignment: ``input_specs()``
supplies 576 precomputed CLIP patch embeddings (width 1024) which a linear
projector maps into the token sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    mlp="swiglu",
    rope_theta=10_000.0,
    num_patches=576,
    patch_dim=1024,
    frontend="vision",
)
