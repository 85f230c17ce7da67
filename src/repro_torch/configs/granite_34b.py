"""granite-34b [dense]: llama-arch MQA (kv=1), code model.
88L d=6144 48H kv=1 ff=24576 V=49152. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128, rope_theta=10_000.0,
    mlp_style="gelu",  # GPT-BigCode-style 2-matrix MLP -> ~34B total
)
