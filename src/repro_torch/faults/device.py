"""Batched fault schedules for the device event loops.

`FaultBatch` is the device-side mirror of a list of host `FaultRealization`s:
every per-point schedule is padded to a common number of breakpoints
(`padded`), per-segment routing targets are attached, and open-mode
per-arrival failure counts / hedge masks are realized from the SAME host
substreams the host loops use — so one `simulate_open_batch` call sweeps a
(scenario x policy x seed) grid against bit-identical fault realizations.
Closed-mode batches feed the closed engine
(`repro_torch.sim.engine_torch.simulate_batch(..., faults=...)`).
`segment_rows` and `ckpt_preserved` are the per-step pieces both device
event loops share.

`extra_steps` sizes the event loop: every fault breakpoint and every
transient failure consumes one event step on top of the fault-free budget
(hedge cancellations ride along with the winner's completion step, so they
cost nothing). Closed-mode failures are drawn per attempt on device, so the
budget there is a high-probability bound, not an exact count; a storm that
exhausts it simply yields fewer measured completions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.faults.scenario import FaultScenario
from repro_torch.faults.targets import segment_targets


def segment_rows(x: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
    """x (B, S, ...) at each point's segment sp (B,) -> (B, ...)."""
    B = x.shape[0]
    idx = sp.view(B, 1, *([1] * (x.dim() - 2))).expand(B, 1, *x.shape[2:])
    return x.gather(1, idx)[:, 0]


def ckpt_preserved(done, period, age, period_finite):
    """Checkpoint-restart: the work preserved after `done` seconds of
    service. No checkpoint before the age threshold `age`, then one every
    `period` from it on (age 0: the uniform grid; period +inf: none);
    `period_finite` is `period` with +inf replaced by 0."""
    return torch.where(
        torch.isfinite(period) & (done >= age),
        age + torch.floor(torch.clamp(done - age, min=0.0)
                          / torch.clamp(period, min=1e-30)) * period_finite,
        0.0)


@dataclasses.dataclass(frozen=True)
class FaultBatch:
    """Per-point fault schedule arrays, leading dim = batch points B."""

    times: np.ndarray            # (B, S) breakpoints, +inf padded
    scale: np.ndarray            # (B, S + 1, l) per-segment mu multipliers
    seg_targets: np.ndarray      # (B, S + 1, k, l) per-segment routing targets
    ckpt_period: np.ndarray      # (B,) checkpoint period, +inf = none
    restart_overhead: np.ndarray  # (B,)
    extra_steps: int             # loop-budget headroom beyond the base run
    fail_counts: np.ndarray | None = None  # (B, T) open: per-arrival failures
    hedge: np.ndarray | None = None        # (B, C) open: hedged classes
    fail_prob: np.ndarray | None = None    # (B,) closed: per-attempt prob
    fail_cap: np.ndarray | None = None     # (B,) closed: per-task failure cap
    ckpt_age: np.ndarray | None = None     # (B,) age-threshold policy, 0 = off
    hedge_q: np.ndarray | None = None      # (B,) open: straggler quantile, 0 = off
    hedge_min: np.ndarray | None = None    # (B,) open: min obs before triggering

    @property
    def n_points(self) -> int:
        return int(self.times.shape[0])

    @property
    def n_events(self) -> int:
        return int(self.times.shape[1])


def _closed_fail_budget(n: int, p: float, cap: int) -> int:
    """High-probability bound on total transient failures over ``n`` successes."""
    if p <= 0.0 or cap == 0 or n == 0:
        return 0
    mean = n * p / (1.0 - p)
    slack = 6.0 * np.sqrt(mean + 1.0) + 16.0
    return int(min(n * cap, np.ceil(mean + slack)))


def build_fault_batch(scenarios, mu, targets, *, seeds, mode,
                      policies=None, mixes=None, n_arrivals=0,
                      n_classes=1, n_completions=0,
                      device=None) -> FaultBatch:
    """Realize ``scenarios`` into a `FaultBatch` for ``mode`` ("open"/"closed").

    ``mu (B, k, l)`` and ``targets (B, k, l)`` are the same arrays handed to
    the batched engine; ``targets`` seeds the static (non-refresh) segment
    targets. ``policies``/``mixes`` are only consulted for points whose
    scenario sets ``refresh_targets`` (the per-segment re-solve needs the
    policy's solver and the task mix); their batched re-solves run on
    `device` (default "cuda").
    """
    if mode not in ("open", "closed"):
        raise ValueError(f"mode must be 'open' or 'closed', got {mode!r}")
    scenarios = list(scenarios)
    b = len(scenarios)
    mu = np.asarray(mu, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.int64)
    if mu.ndim == 2:
        mu = np.broadcast_to(mu, (b,) + mu.shape)
    if targets.ndim == 2:
        targets = np.broadcast_to(targets, (b,) + targets.shape)
    seeds = np.broadcast_to(np.asarray(seeds, dtype=np.int64), (b,))
    if not (mu.shape[0] == targets.shape[0] == b):
        raise ValueError("scenarios, mu, targets and seeds must share the batch dim")
    k, l = mu.shape[1], mu.shape[2]
    for sc in scenarios:
        if not isinstance(sc, FaultScenario):
            raise TypeError(f"expected FaultScenario, got {type(sc)}")

    reals = [sc.realize(l, require_alive=(mode == "closed"))
             for sc in scenarios]
    s_max = max(r.n_events for r in reals)
    padded = [r.padded(s_max) for r in reals]
    times = np.stack([r.times for r in padded]).astype(np.float64)
    scale = np.stack([r.scale for r in padded]).astype(np.float64)

    seg = np.empty((b, s_max + 1, k, l), dtype=np.int64)
    for i, (sc, real) in enumerate(zip(scenarios, reals)):
        pol = None
        if policies is not None:
            pol = policies[i] if isinstance(policies, (list, tuple)) else policies
        if sc.refresh_targets and pol is not None and pol.needs_target:
            mix = (np.asarray(mixes[i] if np.ndim(mixes) > 1 else mixes,
                              dtype=np.int64)
                   if mixes is not None else np.ones(k, np.int64))
            st = segment_targets(pol, mu[i], mix, real, refresh=True,
                                 device=device)
            # pad segments to the common count by repeating the last row
            if st.shape[0] < s_max + 1:
                st = np.concatenate(
                    [st, np.repeat(st[-1:], s_max + 1 - st.shape[0], axis=0)])
            seg[i] = st
        else:
            seg[i] = np.broadcast_to(targets[i], (s_max + 1, k, l))

    period = np.array([np.inf if sc.ckpt_period is None else float(sc.ckpt_period)
                       for sc in scenarios])
    age = np.array([float(sc.ckpt_age) for sc in scenarios])
    overhead = np.array([float(sc.restart_overhead) for sc in scenarios])

    if mode == "open":
        t = int(n_arrivals)
        fail = np.stack([sc.fail_counts(int(sd), t)
                         for sc, sd in zip(scenarios, seeds)])
        hedge = np.zeros((b, int(n_classes)), np.int32)
        for i, sc in enumerate(scenarios):
            for c in sc.hedge_classes:
                if not 0 <= int(c) < n_classes:
                    raise ValueError(f"hedge class {c} out of range")
                hedge[i, int(c)] = 1
        hq = np.array([float(sc.hedge_quantile) for sc in scenarios])
        hmin = np.array([int(sc.hedge_min_obs) for sc in scenarios], np.int32)
        extra = s_max + int(fail.sum(axis=1).max(initial=0)) + 4
        if (hq > 0.0).any():
            # every speculative backup consumes an extra loop step; bound
            # the trigger count by the tail mass at the loosest quantile
            q_min = float(hq[hq > 0.0].min())
            extra += int(np.ceil(3.0 * (1.0 - q_min) * t)) + 64
        return FaultBatch(times, scale, seg, period, overhead, extra,
                          fail_counts=fail, hedge=hedge, ckpt_age=age,
                          hedge_q=hq, hedge_min=hmin)

    for sc in scenarios:
        if sc.hedge_classes:
            raise ValueError("hedge_classes require open/traffic mode")
        if sc.hedge_quantile > 0.0:
            raise ValueError("hedge_quantile (speculative straggler hedging) "
                             "requires open/traffic mode")
    fp = np.array([float(sc.fail_prob) for sc in scenarios])
    fc = np.array([int(sc.fail_cap) for sc in scenarios], np.int32)
    extra = s_max + max(_closed_fail_budget(int(n_completions), float(p), int(c))
                        for p, c in zip(fp, fc))
    return FaultBatch(times, scale, seg, period, overhead, extra,
                      fail_prob=fp, fail_cap=fc, ckpt_age=age)
