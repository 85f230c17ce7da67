"""Architecture registry: ``--arch <id>`` resolves here (a copy of the
reference package's config data, so the port needs nothing of it)."""
from repro_torch.configs.base import (LM_SHAPES, LONG_500K, DECODE_32K,
                                      PREFILL_32K, TRAIN_4K, ModelConfig,
                                      ShapeConfig, shapes_for, smoke_config)
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B
from repro_torch.configs.yi_6b import CONFIG as YI_6B
from repro_torch.configs.qwen2_5_32b import CONFIG as QWEN2_5_32B
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B
from repro_torch.configs.granite_34b import CONFIG as GRANITE_34B
from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM_1_3B
from repro_torch.configs.granite_moe_1b import CONFIG as GRANITE_MOE_1B
from repro_torch.configs.granite_moe_3b import CONFIG as GRANITE_MOE_3B
from repro_torch.configs.musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from repro_torch.configs.phi3_vision import CONFIG as PHI3_VISION

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        ZAMBA2_7B, YI_6B, QWEN2_5_32B, QWEN2_5_3B, GRANITE_34B, XLSTM_1_3B,
        GRANITE_MOE_1B, GRANITE_MOE_3B, MUSICGEN_MEDIUM, PHI3_VISION,
    )
}

SHAPES: dict[str, ShapeConfig] = {s.name: s for s in LM_SHAPES}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> list[tuple[ModelConfig, ShapeConfig]]:
    """Every (arch x applicable shape) dry-run cell."""
    return [(cfg, s) for cfg in ARCHS.values() for s in shapes_for(cfg)]
