"""Fault injection and resilience.

A `FaultScenario` describes processor crash/recovery events, degraded-mu
stragglers, correlated multi-pool storms, transient task failures with
re-execution, a checkpoint-restart cost model, hedged duplicate dispatch
for protected classes, and automatic target refresh on topology events.
The scenario is REALIZED on the host into plain arrays (piecewise-constant
per-pool mu scales + per-arrival failure counts) that both the host event
loops (`run_closed_faults` / `run_open_faults`) and the device engines
(`repro_torch.sim.engine_torch.simulate_batch` and
`repro_torch.traffic.engine_torch.simulate_open_batch` with a
`FaultBatch`) consume, so a (scenario x policy x seed) grid sweeps in one
device call against an identical fault realization. With
`refresh_targets`, `segment_targets` re-solves the routing target of every
distinct availability segment in one batched solve.

`repro_torch.faults.hazard` layers stochastic availability on top:
renewal up/down processes with exponential or Weibull inter-failure and
repair times (`UpDownProcess` -> `realize_availability` /
`make_hazard_scenario` produce ordinary realized scenarios),
restart-vs-resume economics (`expected_completion_exp` /
`expected_completion_weibull` / `completion_forecast` with torch twins)
and checkpoint policy solvers (`optimal_ckpt_period`,
`age_checkpoint_policy` feeding `FaultScenario.ckpt_age`).
"""
from repro_torch.faults.scenario import (FaultRealization, FaultScenario,
                                         PoolEvent, compose_event_streams,
                                         crash, degrade, make_storm)
from repro_torch.faults.targets import segment_targets
from repro_torch.faults.device import FaultBatch, build_fault_batch
from repro_torch.faults.host import run_closed_faults, run_open_faults
from repro_torch.faults.hazard import (UpDownProcess, age_checkpoint_policy,
                                       completion_forecast,
                                       completion_forecast_torch,
                                       expected_completion_exp,
                                       expected_completion_exp_torch,
                                       expected_completion_weibull,
                                       make_hazard_scenario,
                                       optimal_ckpt_period,
                                       realize_availability, weibull_theta)

__all__ = [s for s in dir() if not s.startswith("_")]
