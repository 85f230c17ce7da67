"""Task-size distributions (paper Sec. 5), all normalized to mean 1.

Sizes are in work units; a size-s i-type task needs s / mu[i, j] seconds of
dedicated service on processor j.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class TaskSizeDistribution:
    name = "base"

    def sample(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        raise NotImplementedError

    @property
    def mean(self) -> float:
        return 1.0


@dataclasses.dataclass
class Exponential(TaskSizeDistribution):
    """Markovian case classical queueing theory assumes."""

    name: str = "exponential"

    def sample(self, rng, n=1):
        return rng.exponential(1.0, size=n)


@dataclasses.dataclass
class Uniform(TaskSizeDistribution):
    """U[0, 2] (mean 1)."""

    name: str = "uniform"

    def sample(self, rng, n=1):
        return rng.uniform(0.0, 2.0, size=n)


@dataclasses.dataclass
class Constant(TaskSizeDistribution):
    name: str = "constant"

    def sample(self, rng, n=1):
        return np.ones(n)


@dataclasses.dataclass
class BoundedPareto(TaskSizeDistribution):
    """Heavy-tailed bounded Pareto on [low, high], normalized to mean 1.

    pdf(x) ~ alpha * low^alpha * x^(-alpha-1) / (1 - (low/high)^alpha).
    Sampled by inverse CDF, then divided by the analytic mean so E[size] = 1
    (the paper's distributions are mean-matched across Figs. 4-7).
    """

    alpha: float = 1.5
    low: float = 1.0
    high: float = 1000.0
    name: str = "bounded_pareto"

    def __post_init__(self):
        a, L, H = self.alpha, self.low, self.high
        if a == 1.0:
            raw_mean = L * np.log(H / L) / (1.0 - L / H)
        else:
            raw_mean = (a * L**a / (1.0 - (L / H)**a)
                        * (L**(1.0 - a) - H**(1.0 - a)) / (a - 1.0))
        object.__setattr__(self, "_raw_mean", float(raw_mean))

    def sample(self, rng, n=1):
        a, L, H = self.alpha, self.low, self.high
        u = rng.uniform(0.0, 1.0, size=n)
        # Inverse CDF of bounded Pareto.
        x = (-(u * H**a - u * L**a - H**a) / (H**a * L**a)) ** (-1.0 / a)
        return x / self._raw_mean


@dataclasses.dataclass
class HyperExponential(TaskSizeDistribution):
    """Hyperexponential mixture (heavy-tailed, high CV), normalized to
    mean 1: with probability probs[i] the size is Exp(rates[i]). The
    defaults (90% fast / 10% slow at 25x the mean) give CV^2 ~ 10 — the
    classic two-phase model for bursty request sizes, and the tail shape
    the log-histogram quantile accumulator is validated on.
    """

    probs: tuple = (0.9, 0.1)
    rates: tuple = (2.0, 0.08)
    name: str = "hyperexp"

    def __post_init__(self):
        p = np.asarray(self.probs, dtype=np.float64)
        r = np.asarray(self.rates, dtype=np.float64)
        if p.shape != r.shape or p.ndim != 1 or p.size < 1:
            raise ValueError("probs and rates must be matching 1-D tuples")
        if (p < 0).any() or not np.isclose(p.sum(), 1.0) or (r <= 0).any():
            raise ValueError("probs must be a probability vector and "
                             "rates positive")
        object.__setattr__(self, "_raw_mean", float((p / r).sum()))

    def sample(self, rng, n=1):
        comp = rng.choice(len(self.probs), size=n, p=self.probs)
        x = rng.exponential(1.0, size=n) / np.asarray(self.rates)[comp]
        return x / self._raw_mean


@dataclasses.dataclass
class Weibull(TaskSizeDistribution):
    """Weibull with shape ``k``, normalized to mean 1.

    ``k < 1`` is heavy-tailed with decreasing hazard (many tiny tasks,
    rare huge ones), ``k > 1`` concentrates around the mean with
    increasing hazard, and ``k = 1`` degenerates to Exponential. The
    same family parameterizes the reference package's up/down
    availability processes; here it is a task-size law. numpy's
    ``rng.weibull(k)`` draws scale-1 variates with mean Gamma(1 + 1/k),
    so we divide by that to mean-match.
    """

    k: float = 2.0
    name: str = "weibull"

    def __post_init__(self):
        if not self.k > 0:
            raise ValueError(f"weibull shape must be > 0, got {self.k}")
        from math import gamma
        object.__setattr__(self, "_raw_mean", float(gamma(1.0 + 1.0 / self.k)))

    def sample(self, rng, n=1):
        return rng.weibull(self.k, size=n) / self._raw_mean


DISTRIBUTIONS = {
    "exponential": Exponential,
    "bounded_pareto": BoundedPareto,
    "uniform": Uniform,
    "constant": Constant,
    "hyperexp": HyperExponential,
    "weibull": Weibull,
}


def make_distribution(name: str, **kw) -> TaskSizeDistribution:
    return DISTRIBUTIONS[name](**kw)
