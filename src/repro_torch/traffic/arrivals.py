"""Arrival streams for the open-network engine.

An `ArrivalProcess` produces sorted absolute arrival times starting at 0;
`TrafficSpec` owns one process per priority class plus a per-class type
distribution and merges everything into the single (times, types) stream
both engines consume. All processes are normalized so `rate` is the
long-run mean arrival rate — load sweeps scale a spec with `scaled()`.

The stream realization is sampled ON THE HOST with NumPy from the seeded
substream `default_rng([seed, 0])` — the device engine pre-samples the same
arrays and feeds them to its event loop, so host and device runs of one config
see the IDENTICAL arrival realization and differ only in task-size draws.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np


class ArrivalProcess:
    """Sorted absolute arrival times, starting from time 0."""

    name = "base"

    @property
    def rate(self) -> float:
        """Long-run mean arrival rate (arrivals / sec)."""
        raise NotImplementedError

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Draw the first n arrival times of one stream realization."""
        raise NotImplementedError

    def scaled(self, factor: float) -> "ArrivalProcess":
        """The same stream shape at `factor` times the rate (load sweeps)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process: iid exponential inter-arrivals."""

    lam: float
    name: str = "poisson"

    @property
    def rate(self) -> float:
        return self.lam

    def sample(self, rng, n):
        return np.cumsum(rng.exponential(1.0 / self.lam, size=n))

    def scaled(self, factor):
        return dataclasses.replace(self, lam=self.lam * factor)


@dataclasses.dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """Markov-modulated Poisson process (bursty load).

    The modulating chain cycles its states round-robin (the classic
    two-state case is the on/off burst model), dwelling an exponential
    time with the given mean in each; arrivals inside a dwell are Poisson
    at that state's rate. `rate` is the dwell-weighted mean.
    """

    rates: tuple = (8.0, 0.5)
    mean_dwell: tuple = (2.0, 6.0)
    name: str = "mmpp"

    def __post_init__(self):
        if len(self.rates) != len(self.mean_dwell) or len(self.rates) < 1:
            raise ValueError("need matching, nonempty rates / mean_dwell")

    @property
    def rate(self) -> float:
        r = np.asarray(self.rates, dtype=np.float64)
        d = np.asarray(self.mean_dwell, dtype=np.float64)
        return float((r * d).sum() / d.sum())

    def sample(self, rng, n):
        times = []
        t, state, S = 0.0, 0, len(self.rates)
        while len(times) < n:
            dwell = rng.exponential(self.mean_dwell[state])
            lam = self.rates[state]
            if lam > 0:
                # Poisson arrivals inside [t, t + dwell)
                m = rng.poisson(lam * dwell)
                if m:
                    times.extend(t + np.sort(rng.uniform(0.0, dwell, size=m)))
            t += dwell
            state = (state + 1) % S
        return np.asarray(times[:n])

    def scaled(self, factor):
        return dataclasses.replace(
            self, rates=tuple(r * factor for r in self.rates))


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Nonhomogeneous Poisson with a sinusoidal (diurnal) rate profile:
    lam(t) = base * (1 + amplitude * sin(2 pi t / period)), sampled by
    thinning a homogeneous process at the peak rate."""

    base: float
    amplitude: float = 0.5
    period: float = 100.0
    name: str = "diurnal"

    def __post_init__(self):
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1) so lam(t) > 0")

    @property
    def rate(self) -> float:
        return self.base      # the sinusoid integrates to zero over a period

    def sample(self, rng, n):
        lam_max = self.base * (1.0 + self.amplitude)
        times = []
        t = 0.0
        while len(times) < n:
            # thin candidates in blocks to keep the Python loop short
            cand = t + np.cumsum(rng.exponential(1.0 / lam_max, size=2 * n))
            lam_t = self.base * (1.0 + self.amplitude
                                 * np.sin(2.0 * np.pi * cand / self.period))
            keep = rng.uniform(size=cand.size) * lam_max < lam_t
            times.extend(cand[keep])
            t = cand[-1]
        return np.asarray(times[:n])

    def scaled(self, factor):
        return dataclasses.replace(self, base=self.base * factor)


@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay a recorded trace of arrival times; cycles with period
    `period` (default: last time + the mean inter-arrival gap) when more
    arrivals are requested than the trace holds. `time_scale` stretches
    the clock (scaled() divides it: faster replay = higher rate)."""

    times: tuple
    period: float | None = None
    time_scale: float = 1.0
    name: str = "trace"

    def __post_init__(self):
        t = np.asarray(self.times, dtype=np.float64)
        if t.ndim != 1 or t.size < 2 or (np.diff(t) < 0).any() or t[0] < 0:
            raise ValueError("trace times must be a sorted nonneg 1-D array")

    def _period(self) -> float:
        t = np.asarray(self.times, dtype=np.float64)
        return self.period if self.period is not None else float(
            t[-1] + (t[-1] - t[0]) / (t.size - 1))

    @property
    def rate(self) -> float:
        return len(self.times) / (self._period() * self.time_scale)

    def sample(self, rng, n):
        t = np.asarray(self.times, dtype=np.float64)
        reps = -(-n // t.size)          # ceil
        per = self._period()
        out = np.concatenate([t + r * per for r in range(reps)])[:n]
        return out * self.time_scale

    def scaled(self, factor):
        return dataclasses.replace(self, time_scale=self.time_scale / factor)


def load_trace(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load a bundled request trace: a JSON object with sorted "times" and
    integer "classes" arrays of equal length."""
    with open(path) as f:
        d = json.load(f)
    times = np.asarray(d["times"], dtype=np.float64)
    classes = np.asarray(d["classes"], dtype=np.int64)
    if times.shape != classes.shape or times.ndim != 1:
        raise ValueError(f"malformed trace {path!r}: need equal-length 1-D "
                         "'times' and 'classes'")
    return times, classes


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Per-class arrival streams merged into one (times, types) stream.

    processes:  one ArrivalProcess per priority class c in {0..C-1}.
    type_probs: (C, k) rows of P(flat task type | class) — class c's
                arrivals draw their type row from type_probs[c]. Rows must
                sum to 1; a class's probability mass must sit on rows the
                engine maps to that class (`class_of_type`).
    """

    processes: tuple
    type_probs: np.ndarray

    def __post_init__(self):
        tp = np.asarray(self.type_probs, dtype=np.float64)
        if tp.ndim != 2 or tp.shape[0] != len(self.processes):
            raise ValueError(f"type_probs must be (C={len(self.processes)}, "
                             f"k); got {tp.shape}")
        if (tp < 0).any() or not np.allclose(tp.sum(axis=1), 1.0):
            raise ValueError("type_probs rows must be probability vectors")
        object.__setattr__(self, "type_probs", tp)

    @property
    def n_classes(self) -> int:
        return len(self.processes)

    @property
    def total_rate(self) -> float:
        return float(sum(p.rate for p in self.processes))

    def type_rates(self) -> np.ndarray:
        """(k,) long-run per-type arrival rates (rate_c * P(type | c))."""
        rates = np.asarray([p.rate for p in self.processes])
        return rates @ self.type_probs

    def scaled(self, factor: float) -> "TrafficSpec":
        """Every class stream at `factor` times its rate (load sweeps)."""
        return dataclasses.replace(
            self, processes=tuple(p.scaled(factor) for p in self.processes))

    def sample(self, seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        """The first n merged arrivals: (times (n,) sorted, types (n,)).

        Deterministic in `seed` via the [seed, 0] substream — the same
        realization on host and device (sizes use separate streams)."""
        rng = np.random.default_rng([int(seed), 0])
        per_cls = [p.sample(rng, n) for p in self.processes]
        times = np.concatenate(per_cls)
        classes = np.repeat(np.arange(self.n_classes), [len(t) for t in per_cls])
        order = np.argsort(times, kind="stable")[:n]
        times, classes = times[order], classes[order]
        k = self.type_probs.shape[1]
        types = np.empty(n, dtype=np.int64)
        for c in range(self.n_classes):
            m = classes == c
            types[m] = rng.choice(k, size=int(m.sum()), p=self.type_probs[c])
        return times, types


__all__ = ["ArrivalProcess", "PoissonArrivals", "MMPPArrivals",
           "DiurnalArrivals", "TraceArrivals", "TrafficSpec", "load_trace"]
