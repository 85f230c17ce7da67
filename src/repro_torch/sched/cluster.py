"""Heterogeneous cluster: pools of execution resources with FCFS queues.

A Pool mirrors the paper's per-device OpenCL context + single queue (Sec. 7.1):
one worker thread, FCFS order, executing REAL callables (model steps on the
card, numpy kernels, serving engine calls). The cluster is the "closed
batch network" substrate the paper's scheduler drives.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Hardware constants per chip. The defaults are NVIDIA's data-sheet
    peaks of one H100 SXM (dense bf16, HBM3, one NVLink 4 link's bytes
    per direction, 18 links a card) at its full 700 W power limit."""

    name: str = "h100-sxm"
    peak_flops: float = 989e12          # bf16 FLOP/s
    hbm_bw: float = 3.35e12             # bytes/s
    link_bw: float = 25e9               # NVLink bytes/s/link/direction


@dataclasses.dataclass
class PoolSpec:
    name: str
    chips: int = 1
    chip: ChipSpec = dataclasses.field(default_factory=ChipSpec)
    # service_fns[task_type] -> callable(size) executing one task for real
    service_fns: dict | None = None


@dataclasses.dataclass
class TaskRecord:
    task_type: int
    size: float
    enqueue_t: float
    start_t: float = 0.0
    finish_t: float = 0.0
    pool: int = -1


class Pool:
    """One FCFS worker executing real task callables."""

    def __init__(self, index: int, spec: PoolSpec,
                 on_complete: Callable[[int, TaskRecord], None]):
        self.index = index
        self.spec = spec
        self._q: queue.Queue = queue.Queue()
        self._on_complete = on_complete
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.busy_time = 0.0

    def start(self):
        self._thread.start()

    def submit(self, rec: TaskRecord):
        rec.pool = self.index
        self._q.put(rec)

    def queue_len(self) -> int:
        return self._q.qsize()

    def _run(self):
        while not self._stop.is_set():
            try:
                rec = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            rec.start_t = time.perf_counter()
            self.spec.service_fns[rec.task_type](rec.size)
            rec.finish_t = time.perf_counter()
            self.busy_time += rec.finish_t - rec.start_t
            self._on_complete(self.index, rec)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


class HeterogeneousCluster:
    """l pools + completion plumbing; the scheduler routes into it."""

    def __init__(self, specs: list[PoolSpec]):
        self.specs = specs
        self.completions: list[TaskRecord] = []
        self._lock = threading.Lock()
        self._callbacks: list[Callable] = []
        self.pools = [Pool(i, s, self._complete) for i, s in enumerate(specs)]

    def _complete(self, pool_idx: int, rec: TaskRecord):
        with self._lock:
            self.completions.append(rec)
        for cb in self._callbacks:
            cb(pool_idx, rec)

    def on_complete(self, cb: Callable):
        self._callbacks.append(cb)

    def start(self):
        for p in self.pools:
            p.start()

    def stop(self):
        for p in self.pools:
            p.stop()

    def measure_rates(self, n_types: int, sizes=1.0, reps: int = 20) -> np.ndarray:
        """Measure the affinity matrix mu by timing each (type, pool) pair
        `reps` times (the paper's Sec. 7.2 procedure, 1000x there)."""
        mu = np.zeros((n_types, len(self.pools)))
        for j, p in enumerate(self.pools):
            for i in range(n_types):
                fn = p.spec.service_fns[i]
                fn(sizes)  # warmup / compile
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn(sizes)
                dt = (time.perf_counter() - t0) / reps
                mu[i, j] = 1.0 / max(dt, 1e-9)
        return mu


__all__ = ["ChipSpec", "PoolSpec", "TaskRecord", "Pool",
           "HeterogeneousCluster"]
