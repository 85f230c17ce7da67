"""Roofline-derived affinity matrices: the bridge between the dry-run
analysis and the paper's scheduler.

The paper measures mu_ij by timing kernels on each processor (Sec. 7.2). On a
fleet of accelerators we instead ESTIMATE mu_ij from the roofline terms of
one step on pool j's hardware (and refine online with the StragglerTracker
EWMA).
CAB/GrIn only need orderings, so roofline-grade estimates are sufficient —
exactly the robustness the paper claims for CAB (Sec. 3.3, advantage 2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sched.cluster import ChipSpec


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Per-task cost terms (global, one step/request of this class)."""

    name: str
    flops: float                 # model FLOPs for the step
    hbm_bytes: float             # bytes moved through HBM
    collective_bytes: float = 0.0


def step_time_roofline(cost: StepCost, chip: ChipSpec, n_chips: int,
                       mfu: float = 0.5, links: int = 4) -> float:
    """max(compute, memory, collective) roofline time on a pool."""
    t_compute = cost.flops / (n_chips * chip.peak_flops * mfu)
    t_memory = cost.hbm_bytes / (n_chips * chip.hbm_bw)
    t_coll = cost.collective_bytes / (n_chips * chip.link_bw * links)
    return max(t_compute, t_memory, t_coll)


def affinity_from_roofline(costs: list[StepCost], pools: list[tuple[ChipSpec, int]],
                           mfu: float = 0.5) -> np.ndarray:
    """mu[i, j] = 1 / roofline_time(class i on pool j)."""
    mu = np.zeros((len(costs), len(pools)))
    for i, c in enumerate(costs):
        for j, (chip, n) in enumerate(pools):
            mu[i, j] = 1.0 / step_time_roofline(c, chip, n, mfu)
    return mu


def serving_step_costs(n_params: float, seq_len: int, batch: int,
                       decode_tokens: int = 64) -> list[StepCost]:
    """Canonical two-class serving workload: prefill (compute-bound) and a
    decode run (bandwidth-bound) — the paper's CPU/GPU pair on a fleet of
    accelerators."""
    prefill = StepCost(
        name="prefill",
        flops=2.0 * n_params * seq_len * batch,
        hbm_bytes=2.0 * n_params + batch * seq_len * 1e3,
    )
    decode = StepCost(
        name="decode",
        flops=2.0 * n_params * batch * decode_tokens,
        # every decode step re-reads the weights + the KV cache
        hbm_bytes=decode_tokens * (2.0 * n_params + 0.1 * n_params * batch),
    )
    return [prefill, decode]


__all__ = ["StepCost", "step_time_roofline", "affinity_from_roofline",
           "serving_step_costs"]
