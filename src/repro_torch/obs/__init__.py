"""Observability: run metadata stamps (tracing and telemetry are not
ported yet)."""
from repro_torch.obs.meta import kernel_mode, run_meta

__all__ = ["kernel_mode", "run_meta"]
