"""Open-loop trace replay on the virtual-time serving harness.

The serving counterpart of `repro_torch.traffic.host`: requests arrive on a
recorded (times, types) trace, an `AdmissionController` decides admit /
shed / defer on top of a `SchedulerCore`, and admitted requests execute
REAL service functions on `VirtualTimeCluster` pools (FCFS per pool,
virtual-time concurrency — see `repro_torch.sched.virtual` for why
threads cannot model pools that share one host). Completions feed the
controller, which adapts its best-effort limits against the per-class
SLOs and drains deferred requests as load recedes.

This is the loop behind `repro_torch.launch.serve --traffic`.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.traffic.admission import AdmissionController
from repro_torch.traffic.quantiles import exact_quantiles


@dataclasses.dataclass
class OpenReplayMetrics:
    throughput: float                   # completed / elapsed (goodput)
    elapsed: float
    class_completed: np.ndarray         # (C,)
    class_shed: np.ndarray              # (C,) rejected by admission
    class_deferred: np.ndarray          # (C,) queued in the controller
    class_mean_response: np.ndarray     # (C,)
    class_p50: np.ndarray               # (C,)
    class_p99: np.ndarray               # (C,)
    class_deadline_met: np.ndarray      # (C,) fraction under the SLO deadline
    limits: np.ndarray                  # (C,) final adaptive admit limits


def replay_open(cluster, admission: AdmissionController, times, types, *,
                size_fn=lambda t: 1.0, warmup: int = 0,
                feed_tracker: bool = False) -> OpenReplayMetrics:
    """Replay an arrival trace through admission control onto real pools.

    times/types: the request trace (sorted absolute seconds, flat task
    types); `warmup` requests lead in before measurement (by index, like
    the simulation engines). Service executes at dispatch: an admitted
    request's service function runs (and is timed) immediately, extending
    its pool's virtual clock — FCFS order on each pool is preserved.
    """
    times = np.asarray(times, dtype=np.float64)
    types = np.asarray(types, dtype=np.int64)
    if times.shape != types.shape or times.ndim != 1 or times.size < 2:
        raise ValueError("times and types must be matching 1-D arrays")
    T = times.size
    cls = admission.cls
    C = len(admission.slo)
    deadlines = np.asarray([s.deadline for s in admission.slo])
    clocks = np.zeros(cluster.l)            # per-pool virtual finish time
    heap: list = []                         # (finish, seq, tt, j, t_in)
    seq = 0
    samples: list[list[float]] = [[] for _ in range(C)]
    meas = np.zeros(C, dtype=np.int64)
    dm = np.zeros(C, dtype=np.int64)
    sum_resp = np.zeros(C)
    shed0 = admission.shed.copy()
    defer0 = admission.deferred_total.copy()

    def dispatch(tt: int, j: int, now: float) -> None:
        nonlocal seq
        svc = cluster._service(j, int(tt), size_fn(int(tt)))
        start = max(clocks[j], now)
        clocks[j] = start + svc
        heapq.heappush(heap, (clocks[j], seq, int(tt), j, now, svc))
        seq += 1

    def complete_one() -> None:
        finish, _, tt, j, t_in, svc = heapq.heappop(heap)
        resp = finish - t_in
        admission.complete(tt, j, resp, svc if feed_tracker else None)
        c = int(cls[tt])
        if t_in >= t_warm:
            meas[c] += 1
            sum_resp[c] += resp
            samples[c].append(resp)
            if resp <= deadlines[c]:
                dm[c] += 1
        for tt2, j2 in admission.drain(finish):
            dispatch(tt2, j2, finish)

    t_warm = 0.0 if warmup <= 0 else float(times[min(warmup, T - 1)])
    for i in range(T):
        now = float(times[i])
        while heap and heap[0][0] <= now:
            complete_one()
        verdict, j = admission.offer(int(types[i]), now)
        if verdict == "admit":
            dispatch(int(types[i]), j, now)
    while heap:
        complete_one()

    t_end = float(times[-1])
    elapsed = max(t_end - t_warm, 1e-12)
    total = int(meas.sum())
    return OpenReplayMetrics(
        throughput=total / elapsed, elapsed=elapsed,
        class_completed=meas,
        class_shed=admission.shed - shed0,
        class_deferred=admission.deferred_total - defer0,
        class_mean_response=np.where(meas > 0,
                                     sum_resp / np.maximum(meas, 1), np.inf),
        class_p50=np.asarray([exact_quantiles(s, (0.5,))[0]
                              for s in samples]),
        class_p99=np.asarray([exact_quantiles(s, (0.99,))[0]
                              for s in samples]),
        class_deadline_met=dm / np.maximum(meas, 1),
        limits=admission.limits.copy())


__all__ = ["OpenReplayMetrics", "replay_open"]
