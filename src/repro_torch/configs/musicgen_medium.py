"""musicgen-medium [audio]: decoder-only over EnCodec tokens.
48L d=1536 24H kv=24 ff=6144 V=2048, 4 codebooks. [arXiv:2306.05284; hf]
Modality frontend (EnCodec) is a STUB: input_specs() provides token codes;
embeddings are the sum over codebooks, with one output head per codebook.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    n_codebooks=4, rope_theta=10_000.0,
)
