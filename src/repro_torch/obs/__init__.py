"""Observability: run metadata stamps and time-resolved telemetry (the
decision recorder and profiling spans are not ported yet, ROADMAP A4)."""
from repro_torch.obs.meta import kernel_mode, run_meta
from repro_torch.obs.telemetry import TelemetryAccumulator, telemetry_series

__all__ = ["kernel_mode", "run_meta", "TelemetryAccumulator",
           "telemetry_series"]
