"""SLSQP baseline (paper Sec. 6, Figs. 13-14).

Solves the RELAXED (continuous N_ij >= 0) problem with scipy's SLSQP, exactly
as the paper does: row-sum equality constraints, objective eq. 28. The paper
notes (and we observe) convergence failures near empty-column boundaries where
the objective is discontinuous; failures are reported, not hidden.

scipy is imported inside `slsqp_solve`, so the package imports where only
torch is installed; the largest-remainder rounding needs NumPy alone (the
batched device solvers repair float32 placements with it).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.throughput import system_throughput


@dataclasses.dataclass
class SLSQPResult:
    N: np.ndarray            # continuous placement
    x_sys: float
    success: bool
    runtime_s: float
    message: str


def _objective(flat: np.ndarray, mu: np.ndarray, k: int, l: int) -> float:
    N = flat.reshape(k, l)
    col = N.sum(axis=0)
    # Guard the discontinuity at empty columns the same way the relaxed
    # objective behaves in the limit (empty column contributes zero rate).
    num = (mu * N).sum(axis=0)
    x = np.where(col > 1e-12, num / np.maximum(col, 1e-12), 0.0).sum()
    return -x


def slsqp_solve(mu: np.ndarray, n_tasks, x0: np.ndarray | None = None,
                maxiter: int = 200) -> SLSQPResult:
    from scipy import optimize
    mu = np.asarray(mu, dtype=np.float64)
    n_tasks = np.asarray(n_tasks, dtype=np.float64)
    k, l = mu.shape
    if x0 is None:
        # Uniform spread (the generic initial guess a solver user would pick).
        x0 = np.repeat(n_tasks[:, None] / l, l, axis=1)
    cons = [{"type": "eq",
             "fun": (lambda flat, i=i: flat.reshape(k, l)[i].sum() - n_tasks[i])}
            for i in range(k)]
    bounds = [(0.0, None)] * (k * l)
    t0 = time.perf_counter()
    res = optimize.minimize(_objective, x0.ravel(), args=(mu, k, l),
                            method="SLSQP", bounds=bounds, constraints=cons,
                            options={"maxiter": maxiter, "ftol": 1e-10})
    dt = time.perf_counter() - t0
    N = res.x.reshape(k, l)
    return SLSQPResult(N=N, x_sys=float(-res.fun), success=bool(res.success),
                       runtime_s=dt, message=str(res.message))


def round_largest_remainder(N_cont: np.ndarray, n_tasks) -> np.ndarray:
    """Row-wise largest-remainder rounding of a continuous placement to a
    feasible integer one (row sums restored exactly).

    The paper deliberately does NOT round ("not a trivial task"); this naive
    rounding backs the SLSQP dispatch policy and extra comparisons only.
    """
    N_cont = np.asarray(N_cont, dtype=np.float64)
    n_tasks = np.asarray(n_tasks, dtype=np.int64)
    k, _ = N_cont.shape
    N = np.floor(N_cont).astype(np.int64)
    for i in range(k):
        deficit = int(n_tasks[i] - N[i].sum())
        frac = N_cont[i] - np.floor(N_cont[i])
        if deficit > 0:
            order = np.argsort(-frac)
            for j in order[:deficit]:
                N[i, j] += 1
        elif deficit < 0:  # numerical overshoot
            order = np.argsort(frac)
            for j in order[:-deficit]:
                N[i, j] -= 1
    return np.maximum(N, 0)


def slsqp_integer_rounded_x(result: SLSQPResult, mu: np.ndarray, n_tasks) -> float:
    """Throughput of the largest-remainder-rounded continuous solution."""
    return system_throughput(
        round_largest_remainder(result.N, n_tasks), np.asarray(mu, np.float64))
