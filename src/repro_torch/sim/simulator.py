"""Configuration and result records of the closed batch network (paper
Figs. 2, 4-12). The host event loop, piecewise type re-draws, priority
classes, open traffic and faults are not ported yet; the batched engine is
`repro_torch.sim.engine_torch`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.affinity import PowerModel, PROPORTIONAL_POWER
from repro_torch.sim.distributions import TaskSizeDistribution


@dataclasses.dataclass
class SimConfig:
    mu: np.ndarray                      # (k, l) affinity matrix
    n_programs_per_type: np.ndarray     # (k,) programs whose tasks are type i
    distribution: TaskSizeDistribution
    order: str = "PS"                   # "PS" | "FCFS"
    power: PowerModel = dataclasses.field(default_factory=lambda: PROPORTIONAL_POWER)
    n_completions: int = 20_000
    warmup_completions: int = 2_000
    seed: int = 0


@dataclasses.dataclass
class SimMetrics:
    throughput: float                   # X_sim (tasks / sec)
    mean_response_time: float           # E[T_sim]
    mean_energy: float                  # E[E_sim]
    edp: float                          # E[E_sim] * E[T_sim]
    little_product: float               # X_sim * E[T_sim]  (should be ~N)
    completed: int
    elapsed: float
    state_occupancy: np.ndarray         # time-averaged N_ij
    # Occupancy-weighted power draw over the measurement window: the time
    # integral of sum_j W_j (PS: W_j = sum_i N_ij P_ij / c_j; FCFS/PRIO: the
    # running head's P) divided by elapsed. mean_power / throughput is the
    # model's E[E] (eq. 19) measured from the trajectory rather than per
    # completion.
    mean_power: float = 0.0
    # Per-priority-class metrics (C,) / (C, l); the C == 1 reductions for
    # single-class configs. class_throughput sums to `throughput`, and
    # sum_c w_c * class_throughput[c] is the class-weighted X the priority
    # solvers maximize.
    class_throughput: np.ndarray | None = None
    class_response_time: np.ndarray | None = None
    class_energy: np.ndarray | None = None
    class_occupancy: np.ndarray | None = None
    # meta: the run_meta() substrate block (torch version, device, kernel
    # mode, dtype) stamped by the engine wrappers so every metrics row says
    # WHERE it was measured.
    meta: dict | None = None
