"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks. 48L d=2048 4H V=50304.
[arXiv:2405.04517; unverified]. Every 8th block sLSTM, rest mLSTM
(chunked matrix-memory linear attention); d_ff=0 per assignment (the
mLSTM up/down projection plays the FFN role).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=512,
    slstm_every=8, ssm_chunk=256,
)
