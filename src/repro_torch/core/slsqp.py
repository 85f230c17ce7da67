"""Largest-remainder rounding of continuous placements (paper Sec. 6).

The SLSQP relaxation itself is not ported yet; the rounding is, because the
batched device solvers repair float32 placements with it.
"""
from __future__ import annotations

import numpy as np


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
