"""granite-moe-3b-a800m [moe]: 32L d=1536 24H kv=8 expert_ff=512 V=49155,
MoE 40 experts top-8 (per assignment spec). [hf:ibm-granite; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=0, vocab_size=49155, head_dim=64,
    n_experts=40, top_k=8, moe_d_ff=512, rope_theta=10_000.0,
    tie_embeddings=True,
)
