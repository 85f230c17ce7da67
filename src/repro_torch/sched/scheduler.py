"""ClusterScheduler: thread-safe wrapper around the unified SchedulerCore.

The deficit-routing + target-caching machinery lives in
`repro_torch.sched.api` (one implementation shared with the simulator, the
virtual-time harness and the serving path); this class only adds the lock
that real threaded pools need, and keeps the historical constructor `ClusterScheduler(mu, policy=...)`
working — `policy` is any registry name (`get_policy`) or Policy instance.
The core's batched solves run on `device` (default "cuda").
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.sched.api import Policy, SchedulerCore
from repro_torch.sched.cluster import TaskRecord


class ClusterScheduler:
    def __init__(self, mu: np.ndarray, policy: str | Policy = "grin",
                 rate_alpha: float = 0.3,
                 resolve_rate_rel_change: float = 0.25, seed: int = 0,
                 device=None):
        self.core = SchedulerCore(
            policy, mu, rate_alpha=rate_alpha,
            resolve_rate_rel_change=resolve_rate_rel_change, seed=seed,
            device=device)
        self._lock = threading.Lock()

    # ---------------- locked delegation ----------------
    def route(self, task_type: int) -> int:
        with self._lock:
            return self.core.route(task_type)

    def complete(self, task_type: int, pool: int,
                 service_s: float | None = None) -> None:
        with self._lock:
            self.core.complete(task_type, pool, service_s)

    def notify_type_counts(self, n_tasks: np.ndarray) -> None:
        with self._lock:
            self.core.notify_type_counts(n_tasks)

    def pool_lost(self, pool: int) -> None:
        with self._lock:
            self.core.pool_lost(pool)

    def pool_added(self, mu_column: np.ndarray) -> None:
        with self._lock:
            self.core.pool_added(mu_column)

    # ---------------- read-only views ----------------
    @property
    def name(self) -> str:
        return self.core.name

    @property
    def policy(self):
        return self.core.policy

    @property
    def mu(self) -> np.ndarray:
        return self.core.mu

    @property
    def base_mu(self) -> np.ndarray:
        return self.core.base_mu

    @property
    def counts(self) -> np.ndarray:
        # counts is a snapshot materialized from per-row state: take the
        # lock so concurrent topology changes can't tear the rows mid-build
        with self._lock:
            return self.core.counts

    @property
    def tracker(self):
        return self.core.tracker

    @property
    def resolves(self) -> int:
        return self.core.resolves

    @property
    def k(self) -> int:
        return self.core.k

    @property
    def l(self) -> int:
        return self.core.l


def run_closed_loop(cluster, scheduler: ClusterScheduler, task_types,
                    size_fn, duration_s: float, warmup_s: float = 0.5):
    """Drive a closed system: N programs (one in-flight task each); on each
    completion the program's next task enters immediately. Returns measured
    throughput (tasks/s) after warmup."""

    t_end = time.perf_counter() + duration_s
    t_measure = time.perf_counter() + warmup_s
    done = threading.Event()
    stats = {"measured": 0}

    def on_complete(pool_idx, rec):
        scheduler.complete(rec.task_type, pool_idx,
                           rec.finish_t - rec.start_t)
        now = time.perf_counter()
        if now >= t_measure:
            stats["measured"] += 1
        if now >= t_end:
            done.set()
            return
        nxt = TaskRecord(task_type=rec.task_type, size=size_fn(rec.task_type),
                         enqueue_t=now)
        j = scheduler.route(nxt.task_type)
        cluster.pools[j].submit(nxt)

    cluster.on_complete(on_complete)
    cluster.start()
    for tt in task_types:
        rec = TaskRecord(task_type=tt, size=size_fn(tt),
                         enqueue_t=time.perf_counter())
        j = scheduler.route(tt)
        cluster.pools[j].submit(rec)
    done.wait(timeout=duration_s + 10)
    cluster.stop()
    return stats["measured"] / max(duration_s - warmup_s, 1e-9)


__all__ = ["ClusterScheduler", "run_closed_loop"]
