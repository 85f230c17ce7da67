"""Virtual-time real-execution harness.

Pools that share one host (and here one card) cannot run as independent
processors: they would time-share it and the closed-network independence
assumption breaks. Instead a discrete-event loop uses SERVICE TIMES that are
real wall-clock measurements of real task executions, while CONCURRENCY is
virtual: each pool has its own virtual clock, tasks run FCFS, and a
completion immediately admits the program's next task (closed system).

This is trace-driven emulation of the paper's Sec. 7 experiment. A service
function that runs device work must synchronize before it returns, so that
its wall-clock time covers the work (`serve.engine.request_service_fns`
does).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.sched.api import Policy, SchedulerCore, as_core


@dataclasses.dataclass
class VirtualMetrics:
    throughput: float
    mean_response_time: float
    completed: int
    per_pool_tasks: np.ndarray
    little_product: float


class VirtualTimeCluster:
    """l pools with FCFS queues in virtual time; real service executions."""

    def __init__(self, service_fns: list[dict], measure_real: bool = True):
        """service_fns[j][task_type] -> callable(size) executed for real.
        measure_real=False turns execution off and uses callable's return
        value as the service time (pure simulation mode)."""
        self.service_fns = service_fns
        self.l = len(service_fns)
        self.measure_real = measure_real

    def _service(self, j: int, task_type: int, size) -> float:
        fn = self.service_fns[j][task_type]
        if self.measure_real:
            t0 = time.perf_counter()
            fn(size)
            return time.perf_counter() - t0
        return float(fn(size))

    def measure_rates(self, n_types: int, size=1.0, reps: int = 15) -> np.ndarray:
        mu = np.zeros((n_types, self.l))
        for j in range(self.l):
            for i in range(n_types):
                self._service(j, i, size)  # warmup
                dt = sum(self._service(j, i, size) for _ in range(reps)) / reps
                mu[i, j] = 1.0 / max(dt, 1e-12)
        return mu

    def run_closed(self, scheduler, task_types, *, n_completions: int = 400,
                   warmup: int = 80, size_fn: Callable = lambda t: 1.0,
                   feed_tracker: bool = False,
                   mu: np.ndarray | None = None,
                   device=None) -> VirtualMetrics:
        """Closed system with N = len(task_types) programs.

        `scheduler` is anything with route/complete (a SchedulerCore or the
        thread-safe ClusterScheduler wrapper), or a policy registry name /
        Policy instance — then `mu` (e.g. from measure_rates) is required to
        build the SchedulerCore here, on `device` (default "cuda"; pass
        "cpu" where there is no card).
        """
        if isinstance(scheduler, (str, Policy)):
            if mu is None:
                raise ValueError("pass mu= when giving a policy name; "
                                 "e.g. run_closed('cab', ..., mu=measured_mu)")
            scheduler = as_core(scheduler, mu, device=device)
        elif mu is not None:
            raise ValueError("mu= only applies when scheduler is a policy "
                             "name/Policy; the given scheduler already owns "
                             "its rates")
        clocks = np.zeros(self.l)                    # per-pool virtual time
        queues: list[list] = [[] for _ in range(self.l)]  # FCFS
        enter_t = {}
        completed = 0
        measured = 0
        sum_resp = 0.0
        t_start = None
        per_pool = np.zeros(self.l, dtype=np.int64)

        def admit(tt, now):
            j = scheduler.route(tt)
            queues[j].append((tt, size_fn(tt), now))
            # pool idle in virtual time? fast-forward its clock to arrival
            if clocks[j] < now and len(queues[j]) == 1:
                clocks[j] = now
            return j

        for tt in task_types:
            admit(tt, 0.0)

        while completed < n_completions:
            # next completion = busy pool with smallest clock
            busy = [j for j in range(self.l) if queues[j]]
            assert busy, "closed system cannot be empty"
            j = min(busy, key=lambda j_: clocks[j_])
            tt, size, t_in = queues[j][0]
            svc = self._service(j, tt, size)
            start = max(clocks[j], t_in)
            finish = start + svc
            clocks[j] = finish
            queues[j].pop(0)
            scheduler.complete(tt, j, svc if feed_tracker else None)
            completed += 1
            per_pool[j] += 1
            if completed == warmup:
                t_start = finish
            if completed > warmup:
                measured += 1
                sum_resp += finish - t_in
            admit(tt, finish)

        elapsed = max(clocks.max() - (t_start or 0.0), 1e-12)
        x = measured / elapsed
        et = sum_resp / max(measured, 1)
        return VirtualMetrics(throughput=x, mean_response_time=et,
                              completed=measured, per_pool_tasks=per_pool,
                              little_product=x * et)
