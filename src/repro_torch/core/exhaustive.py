"""Exhaustive optimal placement ("Opt" in the paper's figures).

Enumerates every nonneg-integer matrix N with row sums N_i and returns the
throughput maximizer. Exponential in (k, l, N) — used only at paper scale
(3x3, N ~ 20) to validate CAB/GrIn.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core.throughput import system_throughput


def compositions(n: int, parts: int):
    """All ways to write n as an ordered sum of `parts` nonneg integers."""
    if parts == 1:
        yield (n,)
        return
    for first in range(n + 1):
        for rest in compositions(n - first, parts - 1):
            yield (first,) + rest


def exhaustive_solve(mu: np.ndarray, n_tasks) -> tuple[np.ndarray, float]:
    """argmax_N X_sys(N) by enumeration. Returns (N*, X*)."""
    mu = np.asarray(mu, dtype=np.float64)
    n_tasks = np.asarray(n_tasks, dtype=np.int64)
    k, l = mu.shape
    best_x = -np.inf
    best_n = None
    row_choices = [list(compositions(int(n_tasks[i]), l)) for i in range(k)]
    for rows in itertools.product(*row_choices):
        N = np.asarray(rows, dtype=np.int64)
        x = system_throughput(N, mu)
        if x > best_x:
            best_x = x
            best_n = N
    return best_n, float(best_x)


def exhaustive_count(n_tasks, l: int) -> int:
    """Size of the search space (for reporting)."""
    from math import comb
    total = 1
    for n in np.asarray(n_tasks):
        total *= comb(int(n) + l - 1, l - 1)
    return total
