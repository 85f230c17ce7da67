"""Stochastic availability processes and restart-vs-resume economics.

A `FaultScenario` scripts every outage by hand; this module draws them.
An `UpDownProcess` is a per-pool alternating renewal process: up
durations with mean MTBF and down durations with mean MTTR, each
exponential or Weibull (``shape != 1`` gives increasing/decreasing
hazard). `realize_availability` samples one trajectory per pool per seed
and emits the plain crash/recovery `PoolEvent`s the whole fault fabric
already consumes — host event loops, the device engines' fault stanzas,
`FaultBatch` padding, and `refresh_targets` see nothing new.

The second half prices failure: closed-form / quadrature expected
completion times under checkpoint-restart (host f64 + batched torch), the
Daly optimal checkpoint period, and the age-threshold checkpoint policy
(`ckpt_age`) derived from it — under increasing hazard a young task
should restart from scratch rather than pay checkpoint writes, so the
first checkpoint is deferred to age ``a*`` where the accrued cumulative
hazard matches the exponential optimum.

RNG contract: availability draws come only from the dedicated per-pool
substream ``np.random.default_rng([seed, HOST_HAZARD_STREAM, pool])``
(stream 4) — realizing a hazard process perturbs no arrival, size,
routing, transient-failure, or storm stream.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.faults.scenario import (FaultScenario, PoolEvent,
                                         HOST_HAZARD_STREAM)


# ----------------------------------------------------------- weibull algebra

def weibull_theta(mean: float, shape: float) -> float:
    """Scale ``theta`` of a Weibull with the given mean and shape."""
    if not shape > 0:
        raise ValueError(f"weibull shape must be > 0, got {shape}")
    if not mean > 0:
        raise ValueError(f"weibull mean must be > 0, got {mean}")
    return mean / math.gamma(1.0 + 1.0 / shape)


def weibull_hazard(t, mean: float, shape: float):
    """Hazard rate h(t) = (k/theta) (t/theta)^(k-1)."""
    theta = weibull_theta(mean, shape)
    t = np.asarray(t, dtype=np.float64)
    return shape / theta * np.maximum(t / theta, 0.0) ** (shape - 1.0)


def weibull_cum_hazard(t, mean: float, shape: float):
    """Cumulative hazard Lambda(t) = (t/theta)^k; survival = exp(-Lambda)."""
    theta = weibull_theta(mean, shape)
    t = np.asarray(t, dtype=np.float64)
    return np.maximum(t / theta, 0.0) ** shape


# --------------------------------------------------------- up/down processes

@dataclasses.dataclass(frozen=True)
class UpDownProcess:
    """Per-pool alternating renewal availability process.

    Pools start up. Up durations have mean ``mtbf`` and Weibull shape
    ``up_shape``; down durations mean ``mttr`` and shape ``down_shape``
    (shape 1 = exponential / memoryless; > 1 wear-out, < 1 infant
    mortality). While down a pool runs at ``scale * mu`` (0 = crash).
    ``pools=None`` means every pool; otherwise only the listed ones
    fail. ``mtbf=inf`` is the zero-rate process: it realizes to no
    events at all.
    """

    mtbf: float
    mttr: float
    up_shape: float = 1.0
    down_shape: float = 1.0
    scale: float = 0.0
    pools: tuple | None = None

    def __post_init__(self):
        if not (self.mtbf > 0.0):
            raise ValueError(f"mtbf must be > 0 (inf disables), got {self.mtbf}")
        if not (0.0 < self.mttr < np.inf):
            raise ValueError(f"mttr must be finite and > 0, got {self.mttr}")
        if not (self.up_shape > 0.0 and self.down_shape > 0.0):
            raise ValueError("weibull shapes must be > 0")
        if not (0.0 <= self.scale < 1.0):
            raise ValueError(f"down scale must be in [0, 1), got {self.scale}")
        if self.pools is not None and len(self.pools) == 0:
            raise ValueError("pools must be None (= all) or non-empty")

    @property
    def is_null(self) -> bool:
        return not np.isfinite(self.mtbf)


def _weibull_durations(rng: np.random.Generator, mean: float, shape: float,
                       n: int) -> np.ndarray:
    """n Weibull(mean, shape) durations; shape 1 matches rng.exponential."""
    theta = weibull_theta(mean, shape)
    return theta * rng.weibull(shape, size=n)


def realize_availability(proc: UpDownProcess, l: int, horizon: float,
                         seed: int) -> tuple:
    """Sample one up/down trajectory per pool on [0, horizon) -> events.

    Each pool draws from its own ``default_rng([seed, 4, pool])``
    substream, so adding pools (or restricting ``proc.pools``) never
    shifts another pool's trajectory. Down intervals that straddle the
    horizon keep the pool down through the end (no recovery event); a
    zero-rate process returns no events.
    """
    if not (l >= 1 and horizon > 0.0 and np.isfinite(horizon)):
        raise ValueError("need l >= 1 and a finite positive horizon")
    if proc.is_null:
        return ()
    pools = range(l) if proc.pools is None else proc.pools
    events: list[PoolEvent] = []
    chunk = max(4, int(2.0 * horizon / (proc.mtbf + proc.mttr)) + 4)
    for p in pools:
        if not 0 <= p < l:
            raise ValueError(f"process pool {p} out of range for l={l}")
        rng = np.random.default_rng([int(seed), HOST_HAZARD_STREAM, int(p)])
        t = 0.0
        while True:
            ups = _weibull_durations(rng, proc.mtbf, proc.up_shape, chunk)
            downs = _weibull_durations(rng, proc.mttr, proc.down_shape, chunk)
            done = False
            for up, down in zip(ups, downs):
                t_down = t + up
                if t_down >= horizon:
                    done = True
                    break
                if t_down <= 0.0:  # degenerate zero-length up draw
                    t_down = np.nextafter(t, np.inf) if t > 0 else 1e-12
                events.append(PoolEvent(float(t_down), int(p),
                                        float(proc.scale)))
                t_up = t_down + max(down, 1e-12)
                if t_up >= horizon:
                    done = True
                    break
                events.append(PoolEvent(float(t_up), int(p), 1.0))
                t = t_up
            if done:
                break
    return tuple(events)


def make_hazard_scenario(proc: UpDownProcess, l: int, horizon: float,
                         seed: int, *, name: str | None = None,
                         **scenario_kwargs) -> FaultScenario:
    """Realize ``proc`` for this seed into a `FaultScenario`.

    Extra keyword arguments (``fail_prob``, ``ckpt_period``, ``ckpt_age``,
    ``hedge_quantile``, ``refresh_targets``, ...) pass through to the
    scenario, so hazard-drawn availability composes with every scenario
    knob.
    A zero-rate process with no other knobs yields the null scenario
    (``is_null``), pinned bit-identical to no-faults in tests.
    """
    events = realize_availability(proc, l, horizon, seed)
    if name is None:
        kind = "exp" if proc.up_shape == 1.0 else f"wb{proc.up_shape:g}"
        name = f"hazard-{kind}-mtbf{proc.mtbf:g}-s{seed}"
    return FaultScenario(events=events, name=name, **scenario_kwargs)


# ------------------------------------------- restart-vs-resume economics

_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(32)


def _survival_integral(w: float, mean: float, shape: float) -> float:
    """I = int_0^w exp(-(t/theta)^k) dt by 32-point Gauss-Legendre."""
    theta = weibull_theta(mean, shape)
    t = 0.5 * w * (_GL_NODES + 1.0)
    return float(0.5 * w * (_GL_WEIGHTS
                            * np.exp(-(t / theta) ** shape)).sum())


def expected_completion_exp(w, lam, restart):
    """E[total time] to finish ``w`` work under exponential failures.

    Failures arrive at rate ``lam``; each one costs ``restart`` and
    re-executes the piece from scratch. Classical form
    ``(1/lam + R) (e^{lam w} - 1)`` (f64, vectorized over ``w``).
    """
    w = np.asarray(w, dtype=np.float64)
    lam = np.asarray(lam, dtype=np.float64)
    return (1.0 / lam + restart) * np.expm1(lam * w)


def expected_completion_weibull(w: float, mean: float, shape: float,
                                restart: float) -> float:
    """E[total time] to finish ``w`` work, Weibull(mean, shape) failures.

    Renewal argument with the hazard clock reset on every restart:
    ``E[T] = I / p + R (1 - p) / p`` with ``I = int_0^w S(t) dt`` and
    ``p = S(w)``. Shape 1 recovers `expected_completion_exp` exactly.
    """
    if w <= 0.0:
        return 0.0
    p = float(np.exp(-weibull_cum_hazard(w, mean, shape)))
    i = _survival_integral(w, mean, shape)
    return i / p + restart * (1.0 - p) / p


def completion_forecast(age, w: float, mean: float, shape: float,
                        restart: float):
    """Expected *remaining* time for a task of age ``age`` (f64 host form).

    The task has survived ``age`` units of execution and needs ``w``
    total; conditioning on survival, the remaining-failure law has
    survival ``S(age + t) / S(age)``. If it fails before finishing, it
    pays ``restart`` and re-runs as a *fresh* task (hazard clock reset),
    so the forecast is

        E[T | age] = I_a / 1 + (1 - p_a) (R + E[T fresh])   with
        I_a = int_0^{w-age} S(age+t)/S(age) dt,  p_a = S(w)/S(age).

    Under increasing hazard (shape > 1) an old task has a *worse*
    outlook than a fresh one — the quantity the age-threshold checkpoint
    policy and speculative hedging act on. Vectorized over ``age``.
    """
    age = np.atleast_1d(np.asarray(age, dtype=np.float64))
    theta = weibull_theta(mean, shape)
    fresh = expected_completion_weibull(w, mean, shape, restart)
    out = np.zeros_like(age)
    for ix, a in enumerate(age):
        rem = w - a
        if rem <= 0.0:
            continue
        s_a = math.exp(-(max(a, 0.0) / theta) ** shape)
        t = 0.5 * rem * (_GL_NODES + 1.0)
        s_cond = np.exp(-((a + t) / theta) ** shape) / s_a
        i_a = 0.5 * rem * float((_GL_WEIGHTS * s_cond).sum())
        p_a = math.exp(-(w / theta) ** shape) / s_a
        out[ix] = i_a + (1.0 - p_a) * (restart + fresh)
    return out if out.shape != (1,) else float(out[0])


def expected_completion_exp_torch(w, lam, restart, device=None):
    """Batched float32 twin of `expected_completion_exp` on `device`
    (default "cuda")."""
    dev = resolve_device(device)
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    return (1.0 / lam + restart) * torch.expm1(lam * w)


def completion_forecast_torch(age, w, mean, shape, restart, device=None):
    """Batched float32 twin of `completion_forecast` (the same quadrature)
    on `device` (default "cuda"); returns an (A,) tensor."""
    dev = resolve_device(device)
    f32 = torch.float32
    age = torch.atleast_1d(torch.as_tensor(age, dtype=f32, device=dev))
    theta = torch.tensor(weibull_theta(float(mean), float(shape)), dtype=f32,
                         device=dev)
    shape = torch.tensor(float(shape), dtype=f32, device=dev)
    w = torch.as_tensor(w, dtype=f32, device=dev)
    nodes = torch.as_tensor(_GL_NODES, dtype=f32, device=dev)
    wts = torch.as_tensor(_GL_WEIGHTS, dtype=f32, device=dev)
    p_full = torch.exp(-(w / theta) ** shape)
    i_full = 0.5 * w * torch.sum(
        wts * torch.exp(-((0.5 * w * (nodes + 1.0)) / theta) ** shape))
    fresh = i_full / p_full + restart * (1.0 - p_full) / p_full
    a = age[:, None]
    rem = torch.clamp(w - a, min=0.0)
    s_a = torch.exp(-(torch.clamp(a, min=0.0) / theta) ** shape)
    t = 0.5 * rem * (nodes + 1.0)
    s_cond = torch.exp(-((a + t) / theta) ** shape) / s_a
    i_a = 0.5 * rem[:, 0] * torch.sum(wts * s_cond, dim=1)
    p_a = torch.exp(-(w / theta) ** shape) / s_a[:, 0]
    return torch.where(rem[:, 0] > 0.0,
                       i_a + (1.0 - p_a) * (restart + fresh), 0.0)


def optimal_ckpt_period(lam: float, cost: float, *,
                        tol: float = 1e-12, max_iter: int = 64) -> float:
    """Daly's optimal checkpoint period for failure rate ``lam``.

    Solves ``e^{lam (tau + C)} (lam tau - 1) + 1 = 0`` by Newton from the
    first-order seed ``sqrt(2 C / lam)``; ``lam = 0`` (or ``inf`` MTBF
    upstream) means never checkpoint (+inf).
    """
    if not cost > 0.0:
        raise ValueError(f"checkpoint cost must be > 0, got {cost}")
    if lam <= 0.0:
        return float("inf")
    tau = math.sqrt(2.0 * cost / lam)
    for _ in range(max_iter):
        e = math.exp(lam * (tau + cost))
        f = e * (lam * tau - 1.0) + 1.0
        df = e * lam * (lam * tau - 1.0) + e * lam
        step = f / df
        tau -= step
        if abs(step) < tol * max(tau, 1.0):
            break
    return float(max(tau, 0.0))


def age_checkpoint_policy(mean: float, shape: float,
                          cost: float) -> tuple:
    """(ckpt_age, ckpt_period) for Weibull(mean, shape) failures.

    The period is Daly's optimum at the mean rate ``lam = 1/mean``. The
    first checkpoint is deferred to the age ``a*`` where the *accrued
    cumulative hazard* matches what the exponential process accrues by
    one optimal period: ``Lambda(a*) = lam tau*``, i.e.
    ``a* = theta (lam tau*)^{1/k}``. Under increasing hazard (k > 1) a
    young task is cheap to re-execute, so checkpoints start late and an
    aged task checkpoints on the uniform grid; ``k = 1`` recovers
    ``a* = tau*`` (the plain periodic policy, one period in). The pair
    feeds `FaultScenario(ckpt_age=..., ckpt_period=...)` directly.
    """
    lam = 1.0 / mean
    tau = optimal_ckpt_period(lam, cost)
    theta = weibull_theta(mean, shape)
    age = theta * (lam * tau) ** (1.0 / shape)
    return float(age), float(tau)
