"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.
[arXiv:2411.15242; unverified]. Shared attn+MLP block invoked after every 6
Mamba2 layers (Zamba-style weight sharing); per-invocation LoRA omitted
(DESIGN.md). Sliding-window (4096) shared attention keeps long_500k
sub-quadratic at decode.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    attn_every=6, sliding_window=4096, rope_theta=10_000.0,
)
