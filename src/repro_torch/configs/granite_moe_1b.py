"""granite-moe-1b-a400m [moe]: 24L d=1024 16H kv=8 expert_ff=512 V=49155,
MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=0, vocab_size=49155, head_dim=64,
    n_experts=32, top_k=8, moe_d_ff=512, rope_theta=10_000.0,
    tie_embeddings=True,
)
