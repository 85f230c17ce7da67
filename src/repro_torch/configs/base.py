"""Model / run configuration system.

Every assigned architecture gets a `ModelConfig` in `configs/<id>.py`;
the registry in `repro_torch.configs` exposes them by ``--arch <id>``.
Input-shape sets (train_4k / prefill_32k / decode_32k / long_500k) are defined here as
`ShapeConfig`s and paired with archs by family rules.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    qkv_bias: bool = False
    mlp_style: str = "swiglu"       # swiglu (3 mats) | gelu (2 mats)
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden width
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM (Mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0             # hybrid: shared attn block after every k SSM layers
    sliding_window: int = 0         # 0 = full causal attention
    # --- xLSTM ---
    slstm_every: int = 0            # every k-th layer is sLSTM (rest mLSTM)
    # --- audio (EnCodec-token decoder) ---
    n_codebooks: int = 0
    # --- vlm (stubbed vision frontend) ---
    n_patches: int = 0
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    attn_chunk_q: int = 1024        # chunked-softmax block sizes (jnp path)
    attn_chunk_k: int = 1024
    loss_chunk: int = 512           # CE computed per seq-chunk (0 = off);
                                    # bounds fp32 logits memory at big vocabs

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """May run long_500k (SSM / hybrid / linear-attention families)."""
        return self.family in ("ssm", "hybrid")

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models.model import count_params  # lazy, avoids cycle
        return count_params(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode
    # Gradient accumulation microbatches (train only); tuned per arch via
    # launch.shapes.resolve_microbatches when left at 0.
    microbatches: int = 0


TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """The shape cells this arch runs. long_500k only for sub-quadratic
    archs (assignment rule; skips recorded in DESIGN.md)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.is_subquadratic:
        out.append(LONG_500K)
    return out


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return cfg.with_(
        n_layers=min(cfg.n_layers, 4 if cfg.attn_every == 0 else cfg.attn_every + 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_chunk=32,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        slstm_every=min(cfg.slstm_every, 4) if cfg.slstm_every else 0,
        n_patches=min(cfg.n_patches, 8) if cfg.n_patches else 0,
        attn_chunk_q=32,
        attn_chunk_k=32,
    )
