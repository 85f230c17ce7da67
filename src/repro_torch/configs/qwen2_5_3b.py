"""qwen2.5-3b [dense]: GQA + QKV bias. 36L d=2048 16H kv=2 ff=11008 V=151936.
[hf:Qwen/Qwen2.5-0.5B family; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab_size=151936, head_dim=128, qkv_bias=True,
    rope_theta=1_000_000.0, tie_embeddings=True,
)
