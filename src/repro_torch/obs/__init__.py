"""Observability: the flight recorder, profiling spans, run metadata stamps
and time-resolved telemetry. All opt-in and near zero-cost when disabled:

  * `TraceRecorder` — a bounded ring buffer of structured decision events
    (routing, target re-solves with cache hit/miss/eviction, admission
    shed/defer, governor decisions, fault breakpoints), exportable to
    Chrome trace-event JSON (chrome://tracing, Perfetto). Attach one to a
    `SchedulerCore` / `AdmissionController` / `AutoscaleGovernor`; with
    none attached the hot paths skip a single `is not None` check.
  * Profiling spans (`repro_torch.obs.profile`) — wall-clock spans around
    the hot solver entry points that wait on the card's work
    (`torch.cuda.synchronize`) only while profiling is enabled.
  * Time-resolved telemetry (`repro_torch.obs.telemetry`) — fixed-bin
    series carried through the device engines, with a host twin in the
    oracle loops.
  * `run_meta()` stamps metrics rows with the torch / CUDA versions, the
    card and the kernel mode.
"""
from repro_torch.obs.meta import kernel_mode, run_meta
from repro_torch.obs.profile import (Profiler, enable_profiling,
                                     get_profiler, profile_block, span)
from repro_torch.obs.recorder import TraceEvent, TraceRecorder
from repro_torch.obs.telemetry import TelemetryAccumulator, telemetry_series

__all__ = ["TraceRecorder", "TraceEvent", "Profiler", "span",
           "enable_profiling", "get_profiler", "profile_block",
           "kernel_mode", "run_meta", "TelemetryAccumulator",
           "telemetry_series"]
