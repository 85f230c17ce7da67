"""Closed-loop elastic autoscaler + DVFS governor on the what-if fabric.

The what-if fabric (`SchedulerCore.elastic_what_if`, the energy
objectives) prices pool-loss/add and energy what-ifs; this module closes
the loop as a controller: a governor watches load / utilization /
straggler EWMA signals (the `AdmissionController` observation pattern),
prices every candidate (pool x frequency) action in ONE batched
`solve_targets_grid_torch` call per decision epoch — on the card one
launch of the fused GrIn solve (`grin_block_solve`) — and issues
`pool_lost` / `pool_added` / `set_frequencies` actions under an energy or
power-cap budget (alpha-power DVFS: mu ∝ f, P ∝ f^alpha —
`repro_torch.core.energy.DVFSModel`).

Parked pools in one batched solve — the big-M phantom guard
---------------------------------------------------------------------
Candidates that park pools have FEWER columns than candidates that
don't, yet one `grin_solve_batch_torch` solve needs a fixed (k, l).
Zeroing a parked column is wrong: under ratio-of-sums X_sys any
near-zero column is a beneficial dump site for below-average tasks (the
solver "improves" X by stranding them), so the priced capacity
overestimates. Instead each candidate matrix gets `l` phantom types
(count 1 each) and one dummy column:

  - phantom j rates 0.99*W on the dummy column, and W on column j iff
    the candidate parks pool j (W = 1e4 >> any real rate);
  - a parked candidate therefore pins phantom j to column j, and any
    real task placed there would dilute that column's average by
    ~W/2 — a catastrophic loss the ascent provably never takes;
  - phantoms contribute a KNOWN constant (W per parked pool + 0.99*W
    for the dummy slot), subtracted from the solved X_sys.

The restriction of the solved placement to real types x live columns is
then the exact submatrix optimum (held against the host float64 solve,
`price_config_host`), with mixed pool-count candidates still one
fixed-width batched device call.

Big-M in float32: the guarded rows carry rates up to GUARD_W, so X_sys of
a guarded candidate reaches ~GUARD_W * (n_parked + 0.99), where the fused
solve's relative stop threshold (2e-6) is ~0.1 absolute; real moves worth
less than that can stop the ascent early. The guard-corrected X is held
to the host price, and the gap reported.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core.affinity import PowerModel, PROPORTIONAL_POWER
from repro_torch.core.energy import DVFSModel, expected_energy_batch_torch
from repro_torch.core.grin import grin_block_solve
from repro_torch.core.slsqp import round_largest_remainder
from repro_torch.sched.api import SchedulerCore, solve_targets_grid_torch

GUARD_W = 1.0e4        # big-M phantom rate; >> any physical service rate
GUARD_DUMMY = 0.99     # dummy-slot discount: guards strictly prefer their pool


def _round_shares(share: np.ndarray, total: int) -> np.ndarray:
    """(k,) fractional shares -> integer counts summing to `total`."""
    return round_largest_remainder(
        np.asarray(share, np.float64)[None, :] * total,
        np.array([total]))[0]


# ---------------------------------------------------------------------------
# Candidate grid construction + one-call batched pricing
# ---------------------------------------------------------------------------

def guarded_candidate_mus(nominal_mu: np.ndarray, freq_grid: np.ndarray,
                          dvfs: DVFSModel) -> np.ndarray:
    """(C, k+l, l+1) guarded candidate matrices for per-pool frequency
    vectors `freq_grid` (C, l), where f_j == 0 parks pool j (see module
    docstring for the phantom-guard encoding)."""
    nominal_mu = np.asarray(nominal_mu, dtype=np.float64)
    freq_grid = np.asarray(freq_grid, dtype=np.float64)
    k, l = nominal_mu.shape
    C = freq_grid.shape[0]
    if freq_grid.shape != (C, l) or (freq_grid < 0).any():
        raise ValueError(f"freq_grid must be nonneg (C, {l}); "
                         f"got {freq_grid.shape}")
    mus = np.zeros((C, k + l, l + 1))
    mus[:, :k, :l] = dvfs.scale_mu(nominal_mu[None], freq_grid[:, None, :])
    for j in range(l):
        mus[:, k + j, l] = GUARD_DUMMY * GUARD_W
        mus[:, k + j, j] = np.where(freq_grid[:, j] == 0, GUARD_W, 0.0)
    return mus


def guarded_mixes(mixes: np.ndarray, l: int) -> np.ndarray:
    """Append the l phantom singleton counts to (M, k) real mixes."""
    mixes = np.asarray(mixes, dtype=np.int64)
    return np.concatenate(
        [mixes, np.ones((mixes.shape[0], l), dtype=np.int64)], axis=1)


def price_frequency_grid(nominal_mu: np.ndarray, P_nominal: np.ndarray,
                         freq_grid: np.ndarray, mixes: np.ndarray,
                         dvfs: DVFSModel, device=None):
    """Price every candidate frequency vector against every mix in ONE
    batched device solve (the decision-epoch hot path) on `device`
    (default "cuda").

    Returns dict with `targets` (C, M, k, l) real-slice placements,
    `x` (C, M) guard-corrected X_sys, `energy` (C, M) J/task at the solved
    placement under alpha-power-scaled physical power, and `conv` (C, M).
    """
    dev = resolve_device(device)
    nominal_mu = np.asarray(nominal_mu, dtype=np.float64)
    freq_grid = np.asarray(freq_grid, dtype=np.float64)
    mixes = np.asarray(mixes, dtype=np.int64)
    k, l = nominal_mu.shape
    C = freq_grid.shape[0]
    M = mixes.shape[0]
    mus = guarded_candidate_mus(nominal_mu, freq_grid, dvfs)
    targets, xs, conv = solve_targets_grid_torch(
        mus, guarded_mixes(mixes, l), device=dev)
    n_parked = (freq_grid == 0).sum(axis=1)
    x = xs - GUARD_W * (n_parked + GUARD_DUMMY)[:, None]
    real = targets[:, :, :k, :l]
    # Energy priced in one batched elementwise call: per-candidate scaled
    # (mu, P) against the (C*M, k, l) placements. Parked columns hold no
    # tasks, so their zeroed rates/powers contribute nothing.
    mu_s = dvfs.scale_mu(nominal_mu[None], freq_grid[:, None, :])
    P_s = dvfs.scale_power(np.asarray(P_nominal)[None],
                           freq_grid[:, None, :])
    energy = expected_energy_batch_torch(
        torch.as_tensor(real.reshape(C * M, k, l), device=dev),
        np.repeat(mu_s, M, axis=0),
        np.repeat(P_s, M, axis=0)).cpu().numpy().reshape(
            C, M).astype(np.float64)
    return {"targets": real, "x": np.maximum(x, 0.0), "energy": energy,
            "conv": conv}


def price_config_host(nominal_mu: np.ndarray, P_nominal: np.ndarray,
                      freqs: np.ndarray, mix: np.ndarray,
                      dvfs: DVFSModel) -> tuple[float, float]:
    """Host-f64 ground truth for ONE frequency vector: (X_sys, J/task) at
    the GrIn optimum of the live submatrix. The fluid runner prices every
    controller's realized configuration through this single oracle so the
    benchmark comparison is apples-to-apples; the governor additionally
    uses the batched device grid to *choose*."""
    freqs = np.asarray(freqs, dtype=np.float64)
    live = np.flatnonzero(freqs > 0)
    if live.size == 0:
        return 0.0, np.inf
    mu = dvfs.scale_mu(nominal_mu, freqs)[:, live]
    P = dvfs.scale_power(np.asarray(P_nominal, np.float64), freqs)[:, live]
    res = grin_block_solve(mu, np.asarray(mix, dtype=np.int64))
    # eq. 19 with the explicit DVFS-scaled power matrix
    N = np.asarray(res.N, dtype=np.float64)
    col = N.sum(axis=0)
    W_cols = np.where(col > 0, (N * P).sum(axis=0) / np.maximum(col, 1e-300),
                      0.0)
    e = float(W_cols.sum() / res.x_sys) if res.x_sys > 0 else np.inf
    return float(res.x_sys), e


# ---------------------------------------------------------------------------
# Budget / config / decision records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BudgetSpec:
    """Operating budget the governor enforces each epoch.

    power_cap: ceiling (W) on predicted draw (serve-rate * J/task plus
    static leakage of powered-on pools). energy_per_task_cap: ceiling
    (J/task) on the candidate's energy efficiency. Either/both optional.
    """
    power_cap: float | None = None
    energy_per_task_cap: float | None = None


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    epoch: float = 4.0        # decision period (s)
    headroom: float = 1.25    # required X_cap / predicted arrival rate
    ewma: float = 0.5         # per-epoch arrival-rate EWMA weight
    hysteresis: float = 0.03  # min fractional power saving to leave config
    min_active: int = 1       # never park below this many pools
    n_ref_tasks: int = 24     # closed-mix size the what-if grids solve at


@dataclasses.dataclass(frozen=True)
class Decision:
    time: float
    freqs: np.ndarray         # (l,) per-pool frequency, 0 = parked
    action: str               # hold | freq | park | unpark | emergency
    x_cap: float              # priced capacity of the chosen config
    energy_per_task: float
    power_pred: float
    n_candidates: int


# ---------------------------------------------------------------------------
# Controllers
# ---------------------------------------------------------------------------

class StaticScaler:
    """Fixed provisioning: every pool at f=1 forever (the baseline)."""

    def __init__(self, l: int):
        self.freqs = np.ones(l)

    def decide(self, signals: dict) -> np.ndarray:
        return self.freqs.copy()


class UtilizationScaler:
    """Naive utilization-threshold scaler (the industry-default strawman):
    no pricing, no what-ifs. Sustained util above `hi` steps every active
    pool one DVFS level up, unparking a pool once all are at max;
    sustained util below `lo` steps down, parking the highest-indexed
    active pool once all are at min. Round-robin, budget-blind."""

    def __init__(self, l: int, dvfs: DVFSModel, *, hi: float = 0.8,
                 lo: float = 0.35, min_active: int = 1):
        self.levels = list(dvfs.levels)
        self.freqs = np.full(l, self.levels[-1] if 1.0 not in self.levels
                             else 1.0)
        self.hi, self.lo, self.min_active = hi, lo, min_active

    def _step(self, direction: int) -> None:
        f = self.freqs
        active = np.flatnonzero(f > 0)
        if direction > 0:
            below = active[f[active] < self.levels[-1]]
            if below.size:
                j = below[0]
                f[j] = self.levels[
                    min(self.levels.index(f[j]) + 1, len(self.levels) - 1)]
            elif active.size < f.size:
                f[np.flatnonzero(f == 0)[0]] = self.levels[-1]
        else:
            above = active[f[active] > self.levels[0]]
            if above.size:
                j = above[-1]
                f[j] = self.levels[self.levels.index(f[j]) - 1]
            elif active.size > self.min_active:
                f[active[-1]] = 0.0

    def decide(self, signals: dict) -> np.ndarray:
        util = signals.get("util", 0.0)
        if util > self.hi:
            self._step(+1)
        elif util < self.lo:
            self._step(-1)
        return self.freqs.copy()


class AutoscaleGovernor:
    """What-if-driven scaling: observe -> price all candidates in one
    batched device call -> act under budget.

    Signals (AdmissionController observation pattern): a per-type
    arrival-rate EWMA folded each epoch via `observe`, plus straggler
    slowdown factors read from an attached live `SchedulerCore` tracker
    when present. Candidates: hold, plus for each pool a one-level DVFS
    step up/down, park (frequency -> 0), or unpark (at the ladder top).

    Budget semantics (see BudgetSpec): a candidate is feasible when its
    predicted draw — min(lambda_hat, X_cap) * J/task + static leakage of
    powered-on pools — respects `power_cap` and its J/task respects
    `energy_per_task_cap`. Among feasible candidates meeting
    X_cap >= headroom * lambda_hat, pick the cheapest predicted draw
    (hysteresis guards flapping); if none meets demand, maximize X_cap
    within budget; if none is feasible at all, take the cheapest draw
    (power emergency).

    The priced grids run on `device` (default: the attached core's, else
    "cuda"); a decision through an attached core's recorder is recorded
    as a ("governor", "decision") event.
    """

    def __init__(self, nominal_mu: np.ndarray, *,
                 dvfs: DVFSModel | None = None,
                 power: PowerModel = PROPORTIONAL_POWER,
                 budget: BudgetSpec | None = None,
                 config: GovernorConfig | None = None,
                 core: SchedulerCore | None = None, device=None):
        self.device = resolve_device(
            device if device is not None or core is None else core.device)
        self.nominal_mu = np.asarray(nominal_mu, dtype=np.float64)
        self.k, self.l = self.nominal_mu.shape
        self.dvfs = dvfs or DVFSModel()
        self.P_nominal = power.power_matrix(self.nominal_mu)
        self.budget = budget or BudgetSpec()
        self.config = config or GovernorConfig()
        self.core = core
        top = self.dvfs.levels[-1] if 1.0 not in self.dvfs.levels else 1.0
        self.freqs = np.full(self.l, top)
        self.lam_type = np.zeros(self.k)   # per-type arrival-rate EWMA
        self.decisions: list[Decision] = []
        self.solve_calls = 0               # batched solves (one per epoch)

    # ---------------- signals ----------------
    def observe(self, arrivals_by_type, dt: float) -> None:
        """Fold one epoch of arrival counts into the per-type rate EWMA."""
        rate = np.asarray(arrivals_by_type, dtype=np.float64) / max(dt, 1e-12)
        a = self.config.ewma
        self.lam_type = (1 - a) * self.lam_type + a * rate

    def straggler_factor(self) -> float:
        """Mean slowdown of powered-on pools from the live core's tracker
        (1.0 with no core attached or nothing observed yet)."""
        if self.core is None:
            return 1.0
        factors = self.core.tracker.slowdown_factors()
        on = self.freqs[:len(factors)] > 0
        return float(factors[on].mean()) if on.any() else 1.0

    # ---------------- candidates ----------------
    def candidate_freqs(self) -> np.ndarray:
        """(C, l) grid: hold + per-pool single-step actions, padded with
        the hold row to a FIXED width (3l + 1) so the batched solve keeps
        one shape across epochs."""
        levels = list(self.dvfs.levels)
        f = self.freqs
        cands = [f.copy()]
        active = int((f > 0).sum())
        for j in range(self.l):
            if f[j] > 0:
                i = levels.index(f[j]) if f[j] in levels else None
                if i is not None and i + 1 < len(levels):
                    up = f.copy(); up[j] = levels[i + 1]; cands.append(up)
                if i is not None and i > 0:
                    dn = f.copy(); dn[j] = levels[i - 1]; cands.append(dn)
                if active > self.config.min_active:
                    park = f.copy(); park[j] = 0.0; cands.append(park)
            else:
                un = f.copy(); un[j] = levels[-1]; cands.append(un)
        width = 3 * self.l + 1
        while len(cands) < width:
            cands.append(f.copy())
        return np.stack(cands[:width])

    def _ref_mix(self) -> np.ndarray:
        """Integer closed mix the what-ifs solve at: observed per-type load
        shares scaled to n_ref_tasks (uniform before any observation)."""
        total = self.lam_type.sum()
        share = (self.lam_type / total if total > 0
                 else np.full(self.k, 1.0 / self.k))
        return _round_shares(share, self.config.n_ref_tasks)

    # ---------------- decide / act ----------------
    def decide(self, now: float = 0.0) -> Decision:
        cfg, bud = self.config, self.budget
        freq_grid = self.candidate_freqs()
        priced = price_frequency_grid(self.nominal_mu, self.P_nominal,
                                      freq_grid, self._ref_mix()[None, :],
                                      self.dvfs, device=self.device)
        self.solve_calls += 1
        lam_hat = float(self.lam_type.sum())
        x_eff = priced["x"][:, 0] * self.straggler_factor()
        e_task = priced["energy"][:, 0]
        leak = np.array([self.dvfs.idle_power(self.P_nominal, f).sum()
                         for f in freq_grid])
        draw = e_task * np.minimum(lam_hat, x_eff) + leak
        feasible = priced["conv"][:, 0].copy()
        if bud.power_cap is not None:
            feasible &= draw <= bud.power_cap
        if bud.energy_per_task_cap is not None:
            feasible &= e_task <= bud.energy_per_task_cap
        adequate = feasible & (x_eff >= cfg.headroom * lam_hat)

        if adequate.any():
            pick = int(np.flatnonzero(adequate)[
                np.argmin(draw[adequate])])
            # hysteresis: stay unless the winner saves real power or the
            # current config (candidate 0 = hold) went inadequate
            if pick != 0 and adequate[0] and \
                    draw[0] - draw[pick] < cfg.hysteresis * max(draw[0], 1e-12):
                pick = 0
            action = "hold" if pick == 0 else None
        elif feasible.any():
            pick = int(np.flatnonzero(feasible)[
                np.argmax(x_eff[feasible])])
            action = None
        else:
            pick = int(np.argmin(draw))
            action = "emergency"
        chosen = freq_grid[pick]
        if action is None:
            was, now_on = self.freqs > 0, chosen > 0
            if (was & ~now_on).any():
                action = "park"
            elif (~was & now_on).any():
                action = "unpark"
            else:
                action = "freq" if not np.array_equal(chosen, self.freqs) \
                    else "hold"
        dec = Decision(time=float(now), freqs=chosen.copy(), action=action,
                       x_cap=float(x_eff[pick]),
                       energy_per_task=float(e_task[pick]),
                       power_pred=float(draw[pick]),
                       n_candidates=len(freq_grid))
        self.freqs = chosen.copy()
        self.decisions.append(dec)
        rec = getattr(self.core, "recorder", None) if self.core is not None \
            else None
        if rec is not None:
            rec.record("governor", "decision", t=float(now),
                       action=action, freqs=chosen.tolist(),
                       x_cap=dec.x_cap, energy_per_task=dec.energy_per_task,
                       power_pred=dec.power_pred,
                       power_cap=bud.power_cap,
                       energy_per_task_cap=bud.energy_per_task_cap,
                       lam_hat=lam_hat, n_candidates=dec.n_candidates)
        return dec

    def decide_signals(self, signals: dict) -> np.ndarray:
        """Scaler-protocol adapter for the fluid runner (StaticScaler /
        UtilizationScaler expose `.decide(signals)` directly)."""
        self.observe(signals["arrivals_by_type"], signals["dt"])
        return self.decide(now=signals.get("time", 0.0)).freqs

    def apply_to_core(self, core: SchedulerCore, decision: Decision,
                      live_pools: list[int]) -> list[int]:
        """Issue the decision as live SchedulerCore actions. `live_pools`
        maps the core's current columns to governor pool indices; returns
        the updated mapping. Parks become `pool_lost`, unparks
        `pool_added` (at the decision frequency), and surviving columns
        get one `set_frequencies` — all through `_set_mu`, so the target
        cache can never serve stale-frequency targets."""
        f = decision.freqs
        for pool in [p for p in live_pools if f[p] == 0]:
            core.pool_lost(live_pools.index(pool))
            live_pools = [p for p in live_pools if p != pool]
        for pool in [p for p in range(self.l)
                     if f[p] > 0 and p not in live_pools]:
            core.pool_added(self.nominal_mu[:, pool],
                            frequency=float(f[pool]))
            live_pools = live_pools + [pool]
        core.set_frequencies(np.array([f[p] for p in live_pools]))
        return live_pools


# ---------------------------------------------------------------------------
# Decision traces -> fault-fabric realizations (replay / composition)
# ---------------------------------------------------------------------------

def decisions_to_events(decisions, l: int) -> tuple:
    """Convert a governor decision trace into `PoolEvent`s on the fault
    fabric: scale = frequency (mu ∝ f), 0 parks the pool. Only
    CHANGES emit events (the realization validator rejects redundant
    ones) and t=0 decisions are the initial state, not events."""
    from repro_torch.faults.scenario import PoolEvent
    events = []
    prev = np.ones(l)
    for d in decisions:
        f = np.asarray(d.freqs, dtype=np.float64)
        for j in range(l):
            if f[j] != prev[j] and d.time > 0:
                events.append(PoolEvent(time=float(d.time), pool=j,
                                        scale=float(f[j])))
        prev = f.copy()
    return tuple(events)


# ---------------------------------------------------------------------------
# Fluid epoch simulation (the closed loop itself)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AutoscaleRun:
    times: np.ndarray         # (E,) epoch start times
    freq_trace: np.ndarray    # (E, l) applied frequency vectors
    served: float             # tasks completed inside the horizon
    dropped: float            # arrivals shed on queue overflow
    energy: float             # J spent (dynamic + leakage)
    goodput: float            # served / horizon (tasks/s)
    x_per_joule: float        # served / energy
    mean_backlog: float
    decisions: list


def run_autoscaled(nominal_mu: np.ndarray, times: np.ndarray,
                   types: np.ndarray, controller, *,
                   dvfs: DVFSModel | None = None,
                   power: PowerModel = PROPORTIONAL_POWER,
                   epoch: float = 4.0, queue_slots: int = 400,
                   horizon: float | None = None) -> AutoscaleRun:
    """Drive any controller over a realized arrival trace with a fluid
    epoch model: arrivals queue (finite `queue_slots`, overflow drops),
    the current configuration serves at its host-priced GrIn capacity,
    and energy accrues as served * J/task + static leakage. All
    controllers are priced through the SAME host oracle
    (`price_config_host`), so frontier comparisons only reflect their
    decisions. The controller sees {arrivals_by_type, dt, util, backlog,
    time} each epoch — the admission controller's observation pattern."""
    nominal_mu = np.asarray(nominal_mu, dtype=np.float64)
    dvfs = dvfs or DVFSModel()
    k, l = nominal_mu.shape
    P_nom = power.power_matrix(nominal_mu)
    times = np.asarray(times, dtype=np.float64)
    types = np.asarray(types, dtype=np.int64)
    t_end = float(horizon if horizon is not None
                  else (times[-1] if times.size else 0.0))
    n_epochs = max(int(np.ceil(t_end / epoch)), 1)

    counts = np.maximum(np.bincount(types, minlength=k), 1)
    ref_mix = _round_shares(counts / counts.sum(), 24)
    cache: dict[tuple, tuple[float, float]] = {}

    def price(freqs: np.ndarray) -> tuple[float, float]:
        key = tuple(np.round(freqs, 6))
        if key not in cache:
            cache[key] = price_config_host(nominal_mu, P_nom, freqs,
                                           ref_mix, dvfs)
        return cache[key]

    decide = (controller.decide_signals
              if hasattr(controller, "decide_signals")
              else controller.decide)
    freqs = (controller.freqs.copy() if hasattr(controller, "freqs")
             else np.ones(l))
    backlog = np.zeros(k)
    served = dropped = energy = 0.0
    backlog_sum = 0.0
    freq_trace = np.zeros((n_epochs, l))
    t_starts = np.arange(n_epochs) * epoch

    for e in range(n_epochs):
        t0, t1 = t_starts[e], min(t_starts[e] + epoch, t_end)
        dt = max(t1 - t0, 1e-12)
        freq_trace[e] = freqs
        in_epoch = (times >= t0) & (times < t1)
        arr = np.bincount(types[in_epoch], minlength=k).astype(np.float64)
        room = queue_slots - backlog.sum()
        admit_frac = min(1.0, room / arr.sum()) if arr.sum() > 0 else 1.0
        dropped += arr.sum() * (1.0 - admit_frac)
        backlog += arr * admit_frac
        x_cap, e_task = price(freqs)
        can_serve = x_cap * dt
        total = backlog.sum()
        take = min(total, can_serve)
        if total > 0:
            backlog -= backlog * (take / total)
        served += take
        energy += take * e_task \
            + dvfs.idle_power(P_nom, freqs).sum() * dt
        backlog_sum += backlog.sum()
        util = take / max(can_serve, 1e-12)
        freqs = np.asarray(decide({
            "arrivals_by_type": arr, "dt": dt, "util": util,
            "backlog": backlog.sum(), "time": float(t1)}),
            dtype=np.float64)

    return AutoscaleRun(
        times=t_starts, freq_trace=freq_trace, served=float(served),
        dropped=float(dropped), energy=float(energy),
        goodput=float(served / max(t_end, 1e-12)),
        x_per_joule=float(served / max(energy, 1e-12)),
        mean_backlog=float(backlog_sum / n_epochs),
        decisions=list(getattr(controller, "decisions", [])))


__all__ = ["GUARD_W", "GUARD_DUMMY", "guarded_candidate_mus", "guarded_mixes",
           "price_frequency_grid", "price_config_host", "BudgetSpec",
           "GovernorConfig", "Decision", "StaticScaler", "UtilizationScaler",
           "AutoscaleGovernor", "decisions_to_events", "AutoscaleRun",
           "run_autoscaled"]
