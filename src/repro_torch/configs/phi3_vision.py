"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend STUB.
32L d=3072 32H kv=32 ff=8192 V=32064.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
input_specs() provides precomputed patch embeddings (B, 256, d_model)
prepended to the token sequence; loss is computed on text positions only.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    n_patches=256, rope_theta=10_000.0,
)
