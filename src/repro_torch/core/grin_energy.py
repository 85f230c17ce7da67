"""Energy-aware GrIn: host mirrors of the device objectives (paper Sec. 3.4,
arXiv:1607.07763 multi-objective framing).

Three greedy descents over the exact closed-form per-move deltas in
`repro_torch.core.throughput` (float64; the batched float32 production path
is `grin_solve_batch_torch(objective=...)`):

  * "max-x-e" — GrIn-E: run plain GrIn to a throughput local maximum, then
    slide along the X plateau (single moves with dX >= -tol) toward lower
    E[E]. Fixed points are throughput local maxima that additionally admit
    no energy-reducing zero-cost move.
  * "min-e"   — steepest E[E] descent (eq. 19) from the Algorithm-1 init.
  * "min-edp" — steepest EDP descent (eq. 21) from the Algorithm-1 init.

Single moves only (host reference is paper-scale); every accepted move
strictly improves the phase objective, so termination is guaranteed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.affinity import PowerModel, PROPORTIONAL_POWER
from repro_torch.core.energy import edp, expected_energy_per_task
from repro_torch.core.grin import grin_init, grin_solve
from repro_torch.core.throughput import (delta_edp_move_block,
                                   delta_energy_move_block, delta_x_add,
                                   delta_x_remove, system_throughput)

_TOL_REL = 1e-12


@dataclasses.dataclass
class GrInEnergyResult:
    N: np.ndarray
    x_sys: float
    energy: float
    edp: float
    moves: int
    converged: bool


def _best_energy_move(N, mu, P, score, x_guard: bool):
    """Most-improving single move under `score` (delta; negative = better),
    optionally restricted to moves that keep X_sys within float64 noise
    (the plateau guard). Returns (delta, p, src, dst)."""
    k, l = N.shape
    x = system_throughput(N, mu)
    best = (np.inf, -1, -1, -1)
    for p in range(k):
        if x_guard:
            dplus = delta_x_add(N, mu, p)
            dminus = delta_x_remove(N, mu, p)
        for s in range(l):
            if N[p, s] <= 0:
                continue
            for d in range(l):
                if d == s:
                    continue
                if x_guard and dminus[s] + dplus[d] < -_TOL_REL * (1.0 + x):
                    continue
                delta = score(N, p, s, d)
                if delta < best[0]:
                    best = (delta, p, s, d)
    return best


def grin_energy_solve(mu: np.ndarray, n_tasks: np.ndarray,
                      power: PowerModel = PROPORTIONAL_POWER,
                      objective: str = "max-x-e",
                      max_moves: int = 100_000) -> GrInEnergyResult:
    """Greedy energy-aware placement under `objective` (see module doc)."""
    mu = np.asarray(mu, dtype=np.float64)
    n_tasks = np.asarray(n_tasks, dtype=np.int64)
    P = power.power_matrix(mu)
    if objective == "max-x-e":
        N = grin_solve(mu, n_tasks).N.copy()
        guard = True
    elif objective in ("min-e", "min-edp"):
        N = grin_init(mu, n_tasks)
        guard = False
    else:
        raise ValueError(f"unknown objective {objective!r}: "
                         "max-x-e | min-e | min-edp")
    if objective == "min-edp":
        def score(N, p, s, d):
            return delta_edp_move_block(N, mu, P, p, s, d, 1)

        def value(N):
            return edp(N, mu, power)
    else:
        def score(N, p, s, d):
            return delta_energy_move_block(N, mu, P, p, s, d, 1)

        def value(N):
            return expected_energy_per_task(N, mu, power)
    moves = 0
    converged = False
    while moves < max_moves:
        v = value(N)
        delta, p, s, d = _best_energy_move(N, mu, P, score, guard)
        if not np.isfinite(delta) or delta >= -_TOL_REL * (1.0 + abs(v)):
            converged = True
            break
        N[p, s] -= 1
        N[p, d] += 1
        moves += 1
    return GrInEnergyResult(
        N=N, x_sys=system_throughput(N, mu),
        energy=expected_energy_per_task(N, mu, power),
        edp=edp(N, mu, power), moves=moves, converged=converged)
