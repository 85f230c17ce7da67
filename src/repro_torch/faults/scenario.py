"""Fault scenario schema and deterministic realization.

A scenario is a declarative bundle of resilience knobs:

* ``events`` — timed per-pool mu-scale changes. ``scale == 0`` is a crash,
  ``0 < scale < 1`` a degraded straggler, ``1.0`` a recovery. Realization
  merges the events into a piecewise-constant schedule: breakpoint
  ``times (S,)`` plus per-segment multipliers ``scale (S+1, l)``.
* ``fail_prob`` / ``fail_cap`` — transient task failures: each completion
  attempt fails independently with ``fail_prob`` (at most ``fail_cap``
  times per task) and the task re-executes from its last checkpoint.
* ``ckpt_period`` / ``restart_overhead`` — checkpoint-restart cost model:
  on a crash or transient failure a
  task resumes from ``floor(done / period) * period`` seconds of preserved
  work plus a fixed restart overhead; ``period=None`` means full
  re-execution. The work between the last checkpoint and the fault is the
  *lost work* charged to ``SimMetrics.wasted_work``.
* ``hedge_classes`` — open/traffic mode only: arrivals of these classes
  are dispatched twice (primary + backup on a different pool);
  first-completion-wins, the partner is cancelled and its finished work
  is charged as wasted.
* ``refresh_targets`` — re-solve the routing target per fault segment on
  the ``solve_targets_grid_torch`` / ``elastic_what_if`` fabric instead of
  holding the fault-free target pinned.

The realization is computed ONCE on the host and shared verbatim by the
host event loops and the device event loop — that is what "identical
fault realization" means in the cross-engine conformance tests.

RNG streams (the reference package's contract, kept so both packages
realize identical schedules):

* transient-failure counts (open mode): ``np.random.default_rng([seed, 2])``
  — the host engines own ``default_rng(seed)`` / ``[seed, 0]`` / ``[seed, 1]``;
* storm generation: ``np.random.default_rng([seed, 3])``;
* stochastic availability realization (`repro_torch.faults.hazard`):
  ``np.random.default_rng([seed, 4, pool])`` per pool;
* the open device engine (`repro_torch.traffic.engine_torch`) draws its
  RD choices for primaries, class hedges and speculative backups from the
  point's own ``torch.Generator``, in bulk before the loop, beside its task
  sizes; the ``DEVICE_*_FOLD`` labels name the reference's JAX folds.

None of these touch the pre-existing streams, so a scenario whose events
never fire inside the horizon changes nothing on the host, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Substream labels (see module docstring). Kept as named constants so the
# tests can assert the contract instead of magic numbers.
HOST_FAIL_STREAM = 2
HOST_STORM_STREAM = 3
HOST_HAZARD_STREAM = 4
DEVICE_FAIL_FOLD = 3
DEVICE_HEDGE_FOLD = 4
DEVICE_SPEC_HEDGE_FOLD = 5


@dataclasses.dataclass(frozen=True)
class PoolEvent:
    """At ``time``, pool ``pool``'s service rates become ``scale * mu``."""

    time: float
    pool: int
    scale: float

    def __post_init__(self):
        if not (self.time > 0.0 and np.isfinite(self.time)):
            raise ValueError(f"event time must be finite and > 0, got {self.time}")
        if self.scale < 0.0:
            raise ValueError(f"event scale must be >= 0, got {self.scale}")


@dataclasses.dataclass(frozen=True)
class FaultRealization:
    """Piecewise-constant availability schedule shared by both engines.

    ``times (S,)`` are strictly increasing breakpoints; ``scale (S + 1, l)``
    holds the per-pool mu multipliers for each segment (segment ``s`` covers
    ``[times[s-1], times[s])`` with ``times[-1] = 0`` implied).
    """

    times: np.ndarray
    scale: np.ndarray

    def __post_init__(self):
        times = np.asarray(self.times, dtype=np.float64)
        scale = np.asarray(self.scale, dtype=np.float64)
        if times.ndim != 1 or scale.ndim != 2:
            raise ValueError("times must be (S,) and scale (S + 1, l)")
        if scale.shape[0] != times.shape[0] + 1:
            raise ValueError(
                f"scale must carry one more segment than times: got "
                f"times {times.shape} with scale {scale.shape}")
        if (scale < 0.0).any():
            raise ValueError("segment scales must be >= 0")
        # Strictly increasing breakpoints; +inf is legal only as trailing
        # padding (see `padded`), where every padded segment repeats the
        # last live one.
        finite = np.isfinite(times)
        n_fin = int(finite.sum())
        if finite[n_fin:].any():
            raise ValueError("non-finite breakpoint times must be a "
                             "trailing +inf pad, not interleaved")
        if np.isneginf(times).any() or np.isnan(times).any():
            raise ValueError("breakpoint times must be finite or +inf pad")
        if n_fin and not (np.diff(times[:n_fin]) > 0.0).all():
            raise ValueError(
                "breakpoint times must be strictly increasing — merge "
                "same-time events into one segment at realize time")

    @property
    def n_events(self) -> int:
        return int(self.times.shape[0])

    def padded(self, n: int) -> "FaultRealization":
        """Pad to ``n`` breakpoints (with +inf times) for batching."""
        s = self.n_events
        if s > n:
            raise ValueError(f"cannot pad {s} events down to {n}")
        if s == n:
            return self
        times = np.concatenate([self.times, np.full(n - s, np.inf)])
        scale = np.concatenate(
            [self.scale, np.repeat(self.scale[-1:], n - s, axis=0)], axis=0)
        return FaultRealization(times, scale)


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    events: tuple = ()
    fail_prob: float = 0.0
    fail_cap: int = 4
    ckpt_period: float | None = None
    ckpt_age: float = 0.0
    restart_overhead: float = 0.0
    hedge_classes: tuple = ()
    hedge_quantile: float = 0.0
    hedge_min_obs: int = 32
    refresh_targets: bool = False
    name: str = "faults"

    def __post_init__(self):
        if not (0.0 <= self.fail_prob < 1.0):
            raise ValueError(f"fail_prob must be in [0, 1), got {self.fail_prob}")
        if self.fail_cap < 0:
            raise ValueError("fail_cap must be >= 0")
        if self.ckpt_period is not None and not self.ckpt_period > 0:
            raise ValueError("ckpt_period must be > 0 (or None for full re-execution)")
        if not (self.ckpt_age >= 0.0 and np.isfinite(self.ckpt_age)):
            raise ValueError("ckpt_age must be finite and >= 0 (0 = the "
                             "uniform-period policy)")
        if self.restart_overhead < 0:
            raise ValueError("restart_overhead must be >= 0")
        if not (0.0 <= self.hedge_quantile < 1.0):
            raise ValueError(f"hedge_quantile must be in [0, 1) (0 disables "
                             f"speculative hedging), got {self.hedge_quantile}")
        if self.hedge_min_obs < 1:
            raise ValueError("hedge_min_obs must be >= 1")
        for e in self.events:
            if not isinstance(e, PoolEvent):
                raise TypeError(f"events must be PoolEvent instances, got {type(e)}")

    @property
    def is_null(self) -> bool:
        """True when the scenario cannot change any trajectory at all."""
        return (not self.events and self.fail_prob == 0.0
                and not self.hedge_classes and self.hedge_quantile == 0.0)

    # ---------------------------------------------------------------- realize
    def realize(self, l: int, *, require_alive: bool = False) -> FaultRealization:
        """Merge events into the (times, scale) schedule for ``l`` pools.

        ``require_alive`` forbids segments with the whole fleet crashed
        (mandatory for the closed network, which would deadlock).
        """
        for e in self.events:
            if not 0 <= e.pool < l:
                raise ValueError(f"event pool {e.pool} out of range for l={l}")
        if not self.events:
            return FaultRealization(np.zeros(0), np.ones((1, l)))
        evs = sorted(self.events, key=lambda e: (e.time, e.pool))
        times: list[float] = []
        cur = np.ones(l)
        segs = [cur.copy()]
        prev_key = None
        for e in evs:
            key = (float(e.time), int(e.pool))
            if key == prev_key:
                raise ValueError(
                    f"two events for pool {e.pool} at t={e.time} — event "
                    f"order would be ambiguous; merge them into one")
            prev_key = key
            if float(e.scale) == cur[e.pool]:
                if e.scale == 0.0:
                    raise ValueError(
                        f"overlapping crash windows for pool {e.pool}: "
                        f"crash at t={e.time} while the pool is already "
                        f"down — merge the windows into one crash/recovery "
                        f"pair")
                if e.scale == 1.0:
                    raise ValueError(
                        f"recovery event for pool {e.pool} at t={e.time} "
                        f"without a matching prior crash/degrade — the "
                        f"pool is already at full rate")
                raise ValueError(
                    f"redundant event for pool {e.pool} at t={e.time}: "
                    f"scale is already {e.scale}")
            if not times or e.time > times[-1]:
                times.append(float(e.time))
                cur = cur.copy()
                segs.append(cur)
            cur[e.pool] = float(e.scale)
        scale = np.stack(segs)
        if require_alive and bool((scale <= 0.0).all(axis=1).any()):
            raise ValueError(
                "fault schedule crashes the entire fleet in some segment — "
                "the closed network would deadlock")
        return FaultRealization(np.asarray(times), scale)

    def fail_counts(self, seed: int, n: int) -> np.ndarray:
        """Per-arrival transient-failure counts, ``(n,)`` int32.

        Drawn from the dedicated ``default_rng([seed, HOST_FAIL_STREAM])``
        substream: a capped geometric (count of leading successes of a
        Bernoulli(fail_prob) chain of length ``fail_cap``). Both engines
        consume these counts verbatim in open mode.
        """
        if self.fail_prob <= 0.0 or self.fail_cap == 0 or n == 0:
            return np.zeros(n, np.int32)
        rng = np.random.default_rng([int(seed), HOST_FAIL_STREAM])
        u = rng.random((n, self.fail_cap))
        return np.cumprod(u < self.fail_prob, axis=1).sum(axis=1).astype(np.int32)

    def preserved_work(self, done: float) -> float:
        """Checkpoint-restart model: work preserved after ``done`` seconds.

        With the age-threshold policy (``ckpt_age = a0 > 0``) a task takes
        no checkpoints before age ``a0`` — young tasks restart from scratch
        because re-execution is cheaper than the checkpoint write — then
        checkpoints every ``ckpt_period`` from ``a0`` on:
        ``preserved = a0 + floor((done - a0) / period) * period``.
        ``ckpt_age = 0`` is the uniform-period model.
        """
        if self.ckpt_period is None or done <= 0.0:
            return 0.0
        a0 = self.ckpt_age
        if done < a0:
            return 0.0
        return float(a0 + np.floor((done - a0) / self.ckpt_period)
                     * self.ckpt_period)


# ------------------------------------------------------------------ builders

def crash(pool: int, t_down: float, t_up: float | None = None) -> tuple:
    """Crash ``pool`` at ``t_down``; recover at ``t_up`` (never, if None)."""
    evs = [PoolEvent(t_down, pool, 0.0)]
    if t_up is not None:
        if not t_up > t_down:
            raise ValueError("recovery time must be after the crash time")
        evs.append(PoolEvent(t_up, pool, 1.0))
    return tuple(evs)


def degrade(pool: int, t0: float, factor: float,
            t1: float | None = None) -> tuple:
    """Straggle ``pool`` to ``factor * mu`` on ``[t0, t1)`` (forever if None)."""
    if not 0.0 < factor:
        raise ValueError("degrade factor must be > 0 (use crash for 0)")
    evs = [PoolEvent(t0, pool, factor)]
    if t1 is not None:
        if not t1 > t0:
            raise ValueError("degrade end must be after its start")
        evs.append(PoolEvent(t1, pool, 1.0))
    return tuple(evs)


def make_storm(l: int, *, n_bursts: int = 1, group_size: int = 2,
               window: tuple = (1.0, 2.0), downtime: float = 0.5,
               seed: int = 0, scale: float = 0.0) -> tuple:
    """Correlated multi-pool storm: ``n_bursts`` seeded bursts, each taking
    a random group of pools to ``scale`` for ``downtime`` seconds.

    Deterministic in ``seed`` via ``default_rng([seed, HOST_STORM_STREAM])``;
    the group size is clipped to ``l - 1`` so a single burst never takes the
    whole fleet (overlapping bursts are still validated at realize time).
    """
    if l < 2:
        raise ValueError("storms need at least 2 pools")
    rng = np.random.default_rng([int(seed), HOST_STORM_STREAM])
    t0, t1 = window
    starts = np.sort(rng.uniform(t0, t1, size=n_bursts))
    group_size = min(group_size, l - 1)
    raw: list[tuple[float, float, int]] = []
    for tb in starts:
        pools = rng.choice(l, size=group_size, replace=False)
        for p in np.sort(pools):
            raw.append((float(tb), float(tb) + float(downtime), int(p)))
    # Merge per-pool overlapping or touching down-windows: multi-burst
    # storms routinely re-hit a pool before it recovered, and realize()
    # rejects overlapping crash windows. Storms with disjoint windows
    # come out bit-identical to the pre-merge emission order.
    by_pool: dict[int, list[list[float]]] = {}
    merged_any = False
    for tb, te, p in sorted(raw, key=lambda r: (r[2], r[0])):
        ivs = by_pool.setdefault(p, [])
        if ivs and tb <= ivs[-1][1]:
            ivs[-1][1] = max(ivs[-1][1], te)
            merged_any = True
        else:
            ivs.append([tb, te])
    if merged_any:
        raw = sorted((iv[0], iv[1], p)
                     for p, ivs in by_pool.items() for iv in ivs)
    events: list[PoolEvent] = []
    for tb, te, p in raw:
        events.append(PoolEvent(tb, p, float(scale)))
        events.append(PoolEvent(te, p, 1.0))
    return tuple(events)


def compose_event_streams(primary: tuple, secondary: tuple, l: int) -> tuple:
    """Multiplicative composition of two per-pool scale schedules.

    Each stream is a ``PoolEvent`` tuple defining a piecewise-constant
    schedule starting at scale 1.0; the composed schedule is their
    per-pool PRODUCT, emitted as events only where the product changes
    (so the result always passes ``realize`` validation). This is how an
    autoscaler's decision trace (DVFS steps, parks) coexists with a
    hazard availability draw: a crash zeroes a downclocked pool, and
    recovery restores it at the governor's frequency — not nominal.
    """
    out: list[PoolEvent] = []
    for j in range(l):
        a = sorted((e.time, e.scale) for e in primary if e.pool == j)
        b = sorted((e.time, e.scale) for e in secondary if e.pool == j)
        sa = sb = cur = 1.0
        ia = ib = 0
        for t in sorted({t for t, _ in a} | {t for t, _ in b}):
            while ia < len(a) and a[ia][0] <= t:
                sa = a[ia][1]
                ia += 1
            while ib < len(b) and b[ib][0] <= t:
                sb = b[ib][1]
                ib += 1
            prod = sa * sb
            if prod != cur:
                out.append(PoolEvent(t, j, prod))
                cur = prod
    out.sort(key=lambda e: (e.time, e.pool))
    return tuple(out)
