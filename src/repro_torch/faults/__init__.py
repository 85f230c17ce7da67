"""Fault injection and resilience.

A `FaultScenario` describes processor crash/recovery events, degraded-mu
stragglers, correlated multi-pool storms, transient task failures with
re-execution, a checkpoint-restart cost model, hedged duplicate dispatch
for protected classes, and automatic target refresh on topology events.
The scenario is REALIZED on the host into plain arrays (piecewise-constant
per-pool mu scales + per-arrival failure counts) that both the host event
loops (`run_closed_faults` / `run_open_faults`) and the open device engine
(`repro_torch.traffic.engine_torch.simulate_open_batch` with a
`FaultBatch`) consume, so a (scenario x policy x seed) grid sweeps in one
device call against an identical fault realization. With
`refresh_targets`, `segment_targets` re-solves the routing target of every
distinct availability segment in one batched solve.

Not ported yet (ROADMAP A4): the stochastic availability models
(`faults/hazard.py`) and fault inputs to the closed device engine.
"""
from repro_torch.faults.scenario import (FaultRealization, FaultScenario,
                                         PoolEvent, compose_event_streams,
                                         crash, degrade, make_storm)
from repro_torch.faults.targets import segment_targets
from repro_torch.faults.device import FaultBatch, build_fault_batch
from repro_torch.faults.host import run_closed_faults, run_open_faults

__all__ = [s for s in dir() if not s.startswith("_")]
