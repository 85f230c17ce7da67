"""Straggler mitigation: the per-pool EWMA of observed speed that the
scheduler folds into its affinity matrix (a slow pool's mu column drops,
GrIn re-solves, and load migrates away). Checkpoint/restart and elastic
re-meshing are not ported yet.
"""
from __future__ import annotations

import numpy as np


class StragglerTracker:
    """EWMA of per-pool speed RELATIVE to expectation (1.0 = nominal).

    Observations must be normalized per task class (expected/actual service
    time) — raw rates would conflate a pool's task mix with its health."""

    def __init__(self, n_pools: int, alpha: float = 0.3):
        self.alpha = alpha
        self.rates = np.ones(n_pools)     # relative speed, 1.0 = nominal
        self.seen = np.zeros(n_pools, dtype=bool)

    def observe(self, pool: int, rel_speed: float):
        """rel_speed = expected_service_s / actual_service_s."""
        if not self.seen[pool]:
            self.rates[pool] = rel_speed
            self.seen[pool] = True
        else:
            self.rates[pool] = (self.alpha * rel_speed
                                + (1 - self.alpha) * self.rates[pool])

    def slowdown_factors(self) -> np.ndarray:
        """Per-pool relative speed (<1 = straggler, >1 = faster than nominal).

        Normalized so the fleet-best healthy pool anchors at its own scale —
        the scheduler multiplies base mu columns by these factors."""
        return np.where(self.seen, self.rates, 1.0)
