"""SLO specs and admission control.

Two layers share the same admission SEMANTICS (so the host oracle and the
device engine agree event-for-event):

  1. STATIC per-class admission limits — the rule both simulation engines
     implement: an arriving class-c task is shed when the total in-system
     population has reached `admit_limits[c]`, and dropped when the routed
     processor's finite queue (queue_capacity) is full. Protected (latency)
     classes get the full system capacity; best-effort classes get a lower
     cap, which is what keeps the latency class's queues short under
     overload. `default_admit_limits` derives the vector from an SLO spec.

  2. `AdmissionController` — the ADAPTIVE host-side controller for the
     serving path: it wraps a `SchedulerCore`, tracks each class's recent
     response-time quantile against its SLO deadline, and walks the
     best-effort limits down (multiplicative decrease) whenever a protected
     class's target percentile breaches its deadline — and back up
     (additive increase) when there is margin. Best-effort arrivals over
     the limit are shed (dropped) or deferred (queued in the controller and
     drained as load recedes).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.traffic.quantiles import exact_quantiles


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """Per-class service-level objective: `percentile` of response times
    must stay under `deadline`. Protected classes are never shed by
    admission control; unprotected (best-effort) classes absorb overload."""

    deadline: float
    percentile: float = 0.99
    protected: bool = False

    def __post_init__(self):
        if self.deadline <= 0 or not 0 < self.percentile < 1:
            raise ValueError(f"need deadline > 0 and percentile in (0, 1); "
                             f"got {self}")


def default_admit_limits(slo, n_slots: int,
                         best_effort_fraction: float = 0.5) -> np.ndarray:
    """(C,) static in-system admission caps from an SLO spec: protected
    classes admit up to the full capacity `n_slots` (= l * queue_capacity);
    best-effort classes cap at `best_effort_fraction` of it, reserving the
    rest as headroom for the latency class under overload."""
    if not 0 < best_effort_fraction <= 1:
        raise ValueError("best_effort_fraction must be in (0, 1]")
    return np.asarray([n_slots if s.protected
                       else max(1, int(n_slots * best_effort_fraction))
                       for s in slo], dtype=np.int64)


class AdmissionController:
    """Adaptive SLO admission on top of a `SchedulerCore` (serving path).

    offer(task_type, now) -> ("admit", pool) | ("shed", None)
                           | ("defer", None)
    complete(task_type, pool, response_s, ...)   records the response time,
        releases core state, and adapts the best-effort limits.
    drain(now) -> [(task_type, pool), ...]        admissions of deferred
        tasks that now fit (defer mode; call after completions).

    The control law is AIMD on the best-effort in-system limits: when any
    protected class's recent `percentile` response time exceeds its
    deadline, best-effort limits multiply by `decrease`; when every
    protected class is under `margin` * deadline, they increase by 1 (up to
    the physical capacity). Response times are tracked per class over a
    sliding `window` of completions.
    """

    def __init__(self, core, slo, class_of_type, queue_capacity: int, *,
                 mode: str = "shed", window: int = 256,
                 decrease: float = 0.7, margin: float = 0.8,
                 adapt_every: int = 32, recorder=None):
        if mode not in ("shed", "defer"):
            raise ValueError(f"unknown mode {mode!r}: shed | defer")
        self.core = core
        # Flight recorder: explicit, else shared with the wrapped core.
        self.recorder = (recorder if recorder is not None
                         else getattr(core, "recorder", None))
        self.slo = tuple(slo)
        self.cls = np.asarray(class_of_type, dtype=np.int64)
        C = int(self.cls.max()) + 1
        if len(self.slo) != C:
            raise ValueError(f"need {C} SLOClass entries; got {len(self.slo)}")
        self.queue_capacity = int(queue_capacity)
        self.n_slots = core.l * self.queue_capacity
        self.mode = mode
        self.window = int(window)
        self.decrease = float(decrease)
        self.margin = float(margin)
        self.adapt_every = int(adapt_every)
        self.limits = np.asarray(
            [float(self.n_slots) for _ in self.slo])
        self._resp = [deque(maxlen=self.window) for _ in range(C)]
        self._deferred: deque = deque()
        self._since_adapt = 0
        self.in_system = 0
        self.shed = np.zeros(C, dtype=np.int64)
        self.deferred_total = np.zeros(C, dtype=np.int64)

    # ---------------- admission ----------------
    def _try_place(self, task_type: int) -> int | None:
        """Route if the class limit and the routed pool's queue admit the
        task; None (with core state untouched) otherwise."""
        c = int(self.cls[task_type])
        if self.in_system >= self.limits[c]:
            return None
        j = self.core.route(task_type)
        if int(self.core.counts.sum(axis=0)[j]) > self.queue_capacity:
            # the routed pool was already full (route incremented counts)
            self.core.unroute(task_type, j)
            return None
        self.in_system += 1
        return j

    def offer(self, task_type: int, now: float) -> tuple[str, int | None]:
        j = self._try_place(task_type)
        c = int(self.cls[task_type])
        if j is not None:
            if self.recorder is not None:
                self.recorder.record("admission", "admit", t=now,
                                     type=task_type, cls=c, pool=j,
                                     in_system=self.in_system)
            return "admit", j
        if self.mode == "defer" and not self.slo[c].protected:
            self._deferred.append((task_type, now))
            self.deferred_total[c] += 1
            if self.recorder is not None:
                self.recorder.record("admission", "defer", t=now,
                                     type=task_type, cls=c,
                                     queued=len(self._deferred),
                                     limit=float(self.limits[c]))
            return "defer", None
        self.shed[c] += 1
        if self.recorder is not None:
            self.recorder.record("admission", "shed", t=now,
                                 type=task_type, cls=c,
                                 limit=float(self.limits[c]),
                                 in_system=self.in_system)
        return "shed", None

    def drain(self, now: float) -> list[tuple[int, int]]:
        """Admit deferred tasks that fit now (FIFO); call after completions."""
        out = []
        while self._deferred:
            task_type, _ = self._deferred[0]
            j = self._try_place(task_type)
            if j is None:
                break
            self._deferred.popleft()
            out.append((task_type, j))
        return out

    # ---------------- feedback ----------------
    def complete(self, task_type: int, pool: int, response_s: float,
                 service_s: float | None = None) -> None:
        self.core.complete(task_type, pool, service_s)
        self.in_system -= 1
        self._resp[int(self.cls[task_type])].append(float(response_s))
        self._since_adapt += 1
        if self._since_adapt >= self.adapt_every:
            self._since_adapt = 0
            self._adapt()

    def _protected_pressure(self) -> float:
        """max over protected classes of (observed quantile / deadline)."""
        worst = 0.0
        for c, s in enumerate(self.slo):
            if not s.protected or not self._resp[c]:
                continue
            q = float(exact_quantiles(list(self._resp[c]),
                                      (s.percentile,))[0])
            worst = max(worst, q / s.deadline)
        return worst

    def _adapt(self) -> None:
        pressure = self._protected_pressure()
        for c, s in enumerate(self.slo):
            if s.protected:
                continue
            if pressure > 1.0:                       # SLO breach: shed harder
                self.limits[c] = max(1.0, self.limits[c] * self.decrease)
            elif pressure < self.margin:             # headroom: re-open
                self.limits[c] = min(float(self.n_slots),
                                     self.limits[c] + 1.0)
        if self.recorder is not None:
            self.recorder.record("admission", "adapt",
                                 pressure=float(pressure),
                                 limits=[float(x) for x in self.limits])


__all__ = ["SLOClass", "AdmissionController", "default_admit_limits"]
