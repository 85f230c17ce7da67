"""qwen2.5-32b [dense]: GQA + QKV bias. 64L d=5120 40H kv=8 ff=27648 V=152064.
[hf:Qwen/Qwen2.5-0.5B family; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064, head_dim=128, qkv_bias=True,
    rope_theta=1_000_000.0,
)
