"""Classic cluster schedulers (RD/BF/LB/JSQ) under their historical name.

The policies themselves live in the unified registry
(`repro_torch.sched.api`); this wrapper maps the historical
`BaselineClusterScheduler(mu, "LB")` constructor onto a SchedulerCore with
the lock a threaded pool needs.
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.sched.api import SchedulerCore


class BaselineClusterScheduler:
    """route/complete interface over a stateless classic policy."""

    def __init__(self, mu: np.ndarray, kind: str, seed: int = 0,
                 device=None):
        self.core = SchedulerCore(kind, mu, seed=seed, device=device)
        self.kind = kind
        self._lock = threading.Lock()

    def route(self, task_type: int) -> int:
        with self._lock:
            return self.core.route(task_type)

    def complete(self, task_type: int, pool: int,
                 service_s: float | None = None) -> None:
        with self._lock:
            self.core.complete(task_type, pool, service_s)

    @property
    def counts(self) -> np.ndarray:
        with self._lock:
            return self.core.counts
