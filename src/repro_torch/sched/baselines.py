"""Classic cluster schedulers (RD/BF/LB/JSQ) — kept as a compatibility name.

The policies themselves live in the unified registry
(`repro_torch.sched.api`); this wrapper just maps the historical
`BaselineClusterScheduler(mu, "LB")` constructor onto the shared
SchedulerCore via ClusterScheduler.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sched.scheduler import ClusterScheduler


class BaselineClusterScheduler(ClusterScheduler):
    """route/complete interface over a stateless classic policy."""

    def __init__(self, mu: np.ndarray, kind: str, seed: int = 0,
                 device=None):
        super().__init__(mu, policy=kind, seed=seed, device=device)
        self.kind = kind
