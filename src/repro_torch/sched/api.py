"""Unified scheduling API: one `Policy` protocol + one `SchedulerCore`.

The paper's central claim (Lemma 2) is that a single routing rule — keep the
live placement pinned at the solver's target state N* via largest-deficit
dispatch — is optimal regardless of the execution substrate. Every solver
(CAB, GrIn, GrIn+, SLSQP, the energy-aware GrIn variants, exhaustive Opt)
and every classic baseline (RD/BF/LB/JSQ) is a `Policy`, and the shared
machinery — target caching keyed on (type-mix, mu), largest-deficit routing
with rate tiebreak, EWMA straggler rate-folding, elastic topology events —
lives exactly once in `SchedulerCore`.

    >>> core = SchedulerCore(get_policy("grin"), mu)     # runs on "cuda"
    >>> j = core.route(task_type)            # largest-deficit dispatch
    >>> core.complete(task_type, j, service_s=dt)   # EWMA rate feedback

`solve_targets_torch` batches target re-solves over many type-mixes on the
device (block-move GrIn scoring its moves in the CUDA kernel;
`solver="single"` keeps the one-move-per-step variant) and
`solve_targets_grid_torch` solves whole (mu x mix) grids in one call — the
substrate for `SchedulerCore.elastic_what_if`. `SchedulerCore.route_many`
routes a burst of arrivals through the largest-deficit rule on the device.

Priority-class policies (`repro_torch.sched.priority`: grin-p/cab-p) run on
a class-major FLATTENED problem — row (c*k + i) of mu is class c's i-type —
so `SchedulerCore` keeps per-(class, type) deficits with no extra state; the
target-cache key includes the class-weight vector, and the engines'
strict-priority service order (`order="PRIO"`) supplies the preemption-free
class ordering at the processors.

`SchedulerCore.route_backup` places a hedged backup copy off its
primary's pool, and `deficit_route_masked_torch` is the device router
restricted to pools that are up (the fault layer, `repro_torch.faults`).
Not ported yet: the decision recorder (ROADMAP A4).
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.affinity import PROPORTIONAL_POWER, PowerModel
from repro_torch.core.cab import cab_target_state
from repro_torch.core.energy import expected_energy_batch_torch
from repro_torch.core.exhaustive import exhaustive_solve
from repro_torch.core.grin import (_grin_single_core, grin_solve,
                                   grin_solve_batch_torch)
from repro_torch.core.grin_energy import grin_energy_solve
from repro_torch.core.grin_plus import grin_multistart_solve
from repro_torch.core.slsqp import round_largest_remainder, slsqp_solve
from repro_torch.core.throughput import (state_from_pair, system_throughput,
                                         system_throughput_torch,
                                         throughput_map_2x2)
from repro_torch.train.fault_tolerance import StragglerTracker


@dataclasses.dataclass
class SystemView:
    """What a policy may observe when routing one task."""

    counts: np.ndarray         # (k, l) tasks currently resident per (type, proc)
    backlog_work: np.ndarray   # (l,) total remaining service demand per proc
    backlog_tasks: np.ndarray  # (l,) number of tasks queued/running per proc
    mu: np.ndarray             # (k, l) affinity matrix


# ---------------------------------------------------------------------------
# Policy protocol + registry
# ---------------------------------------------------------------------------

class Policy:
    """One scheduling policy: either a target solver or a stateless chooser.

    Capability flags:
      needs_target       — True: `solve_target` yields N* and SchedulerCore
                           routes by largest deficit; False: `choose` picks a
                           processor directly from a SystemView.
      pool_limit         — exact number of pools required (CAB: 2), or None.
      integer_target     — target entries are integers (SLSQP relaxes then
                           rounds; the flag records the relaxation).
      supports_torch_batch — `solve_targets_torch` can batch this policy's
                           re-solves on the device.
      torch_objective    — the objective the batched device solver ranks
                           moves under for this policy ("max-x" | "max-x-e" |
                           "min-e" | "min-edp").
      power              — PowerModel the energy objectives score against
                           (None: throughput-only policy; energy what-ifs
                           default to proportional power).
      class_weights      — priority-class weight vector (C,) for multi-class
                           policies (None: single-class). It is part of the
                           SchedulerCore target-cache key, so a weight
                           update can never be served a stale target.
    """

    name = "base"
    key = "base"
    needs_target = True
    pool_limit: int | None = None
    integer_target = True
    supports_torch_batch = False
    torch_objective = "max-x"
    power: PowerModel | None = None
    class_weights: np.ndarray | None = None

    def solve_target(self, mu: np.ndarray, n_tasks: np.ndarray) -> np.ndarray:
        """Return the (k, l) target placement N* for the given type mix."""
        raise NotImplementedError(f"{self.name} is not a target policy")

    def device_mu(self, mu: np.ndarray) -> np.ndarray:
        """The affinity matrix the batched device solver should rank moves
        under. Identity for single-class policies; priority policies return
        the class-weighted rows (weights fold into mu, physics does not)."""
        return mu

    def choose(self, task_type: int, view: SystemView,
               rng: np.random.Generator) -> int:
        """Stateless policies: pick the processor for one arriving task."""
        raise NotImplementedError(f"{self.name} is not a stateless policy")

    def repin_target(self, mu: np.ndarray, *, lost: int | None = None,
                     added: bool = False) -> None:
        """The topology changed under this policy (`mu` is the post-event
        matrix). Solver policies re-solve lazily on the next route, so the
        default is a no-op; policies that PIN a placement (FixedTargetPolicy)
        must remap it here or the next `solve_target` shape check raises."""


_REGISTRY: dict[str, type[Policy]] = {}


def register_policy(key: str, *aliases: str):
    """Class decorator: register a Policy under `key` (+ aliases)."""
    def deco(cls):
        cls.key = key
        for k in (key, *aliases):
            _REGISTRY[k] = cls
        return cls
    return deco


def get_policy(name: str | Policy, **kwargs) -> Policy:
    """Construct a policy by registry name (case-insensitive).

    A Policy instance passes through unchanged, so call sites can accept
    either form.
    """
    if isinstance(name, Policy):
        if kwargs:
            raise TypeError("constructor kwargs only apply to registry names; "
                            f"got a {name.name} instance plus {set(kwargs)}")
        return name
    cls = _REGISTRY.get(str(name).lower())
    if cls is None:
        raise KeyError(f"unknown policy {name!r}; available: "
                       f"{', '.join(available_policies())}")
    return cls(**kwargs)


def available_policies() -> tuple[str, ...]:
    """Canonical registry keys (aliases excluded), sorted."""
    return tuple(sorted({cls.key for cls in _REGISTRY.values()}))


# ------------------------------- target policies ---------------------------

@register_policy("cab")
class CABPolicy(Policy):
    """CAB Table-1 analytical optimum (two processor types only)."""

    name = "CAB"
    pool_limit = 2

    def solve_target(self, mu, n_tasks):
        if mu.shape[1] != 2:
            raise ValueError("CAB is the two-pool analytical solution; got "
                             f"{mu.shape[1]} pools (use 'grin')")
        return cab_target_state(mu, n_tasks)


@register_policy("grin")
class GrInPolicy(Policy):
    """GrIn greedy-increase near-optimal placement (any k x l)."""

    name = "GrIn"
    supports_torch_batch = True

    def solve_target(self, mu, n_tasks):
        return grin_solve(mu, n_tasks).N


@register_policy("grin+", "grin_plus", "grinplus")
class GrInPlusPolicy(Policy):
    """GrIn+ multistart (swap escapes + basin hops + AF seeds)."""

    name = "GrIn+"

    def solve_target(self, mu, n_tasks):
        return grin_multistart_solve(mu, n_tasks).N


@register_policy("grin-e", "grine", "grin_e")
class GrInEPolicy(Policy):
    """GrIn-E: maximize throughput, break move ties toward lower E[E], then
    polish along the X plateau (paper Sec. 3.4 objectives; the host solver
    is `grin_energy_solve`, the batched device path objective='max-x-e')."""

    name = "GrIn-E"
    supports_torch_batch = True
    torch_objective = "max-x-e"

    def __init__(self, power: PowerModel = PROPORTIONAL_POWER):
        self.power = power

    def solve_target(self, mu, n_tasks):
        return grin_energy_solve(mu, n_tasks, self.power, "max-x-e").N


@register_policy("grin-edp", "grinedp", "grin_edp")
class GrInEDPPolicy(Policy):
    """GrIn-EDP: greedy Energy-Delay-Product descent (eq. 21)."""

    name = "GrIn-EDP"
    supports_torch_batch = True
    torch_objective = "min-edp"

    def __init__(self, power: PowerModel = PROPORTIONAL_POWER):
        self.power = power

    def solve_target(self, mu, n_tasks):
        return grin_energy_solve(mu, n_tasks, self.power, "min-edp").N


@register_policy("cab-e", "cabe", "cab_e")
class CABEnergyPolicy(Policy):
    """CAB-E: the two-pool Table-1 optimum with an energy tie-break — the
    minimum-E[E] state among all (N11, N22) states whose throughput matches
    the CAB maximum (within float32 map resolution). Identical to CAB when
    the optimum is unique; on the non-affinity cases (whole families of
    optimal states) it picks the most energy-efficient member."""

    name = "CAB-E"
    pool_limit = 2

    def __init__(self, power: PowerModel = PROPORTIONAL_POWER):
        self.power = power

    def solve_target(self, mu, n_tasks):
        if mu.shape[1] != 2:
            raise ValueError("CAB-E is the two-pool analytical solution; got "
                             f"{mu.shape[1]} pools (use 'grin-e')")
        n1, n2 = int(n_tasks[0]), int(n_tasks[1])
        xmap = throughput_map_2x2(n1, n2, mu)            # (n1+1, n2+1)
        states = np.stack([state_from_pair(i, j, n1, n2)
                           for i in range(n1 + 1) for j in range(n2 + 1)])
        E = expected_energy_batch_torch(
            torch.as_tensor(states), torch.as_tensor(mu, dtype=torch.float32),
            torch.as_tensor(self.power.power_matrix(mu), dtype=torch.float32)
        ).numpy().astype(np.float64)
        near = xmap.ravel() >= xmap.max() * (1.0 - 1e-6)
        return states[np.flatnonzero(near)[np.argmin(E[near])]]


@register_policy("slsqp")
class SLSQPPolicy(Policy):
    """Continuous SLSQP relaxation, largest-remainder rounded to integers."""

    name = "SLSQP"
    integer_target = False

    def solve_target(self, mu, n_tasks):
        res = slsqp_solve(mu, n_tasks)
        return round_largest_remainder(res.N, n_tasks)


@register_policy("opt", "exhaustive")
class ExhaustivePolicy(Policy):
    """Exhaustive enumeration — exact optimum, exponential cost (paper scale
    only: 3x3, N ~ 20)."""

    name = "Opt"

    def solve_target(self, mu, n_tasks):
        N, _ = exhaustive_solve(mu, n_tasks)
        return N


@register_policy("fixed")
class FixedTargetPolicy(Policy):
    """Pin an externally computed placement (e.g. a precomputed exhaustive
    optimum reused across runs)."""

    name = "Opt"

    def __init__(self, target: np.ndarray, name: str = "Opt"):
        self._fixed = np.asarray(target, dtype=np.int64)
        self.name = name

    def solve_target(self, mu, n_tasks):
        return self._fixed

    def repin_target(self, mu, *, lost=None, added=False):
        tgt = np.asarray(self._fixed, dtype=np.int64)
        if lost is not None:
            moved = tgt[:, lost]
            tgt = np.delete(tgt, lost, axis=1)
            # re-home the lost column's allocation type-by-type onto the
            # fastest surviving pool (mu is already the post-event matrix)
            best = np.argmax(mu, axis=1)
            np.add.at(tgt, (np.arange(tgt.shape[0]), best), moved)
        if added:
            tgt = np.concatenate(
                [tgt, np.zeros((tgt.shape[0], 1), dtype=np.int64)], axis=1)
        self._fixed = tgt


# ------------------------------ stateless baselines ------------------------

@register_policy("rd", "random")
class RandomPolicy(Policy):
    """RD: uniform random processor."""

    name = "RD"
    needs_target = False

    def choose(self, task_type, view, rng):
        return int(rng.integers(view.mu.shape[1]))


@register_policy("bf", "bestfit")
class BestFitPolicy(Policy):
    """BF: processor with the highest rate for this task type."""

    name = "BF"
    needs_target = False

    def choose(self, task_type, view, rng):
        return int(np.argmax(view.mu[task_type]))


@register_policy("lb", "loadbalance")
class LoadBalancingPolicy(Policy):
    """LB: least remaining work. The simulator supplies true sizes (an upper
    bound on an estimating LB); the live cluster supplies expected seconds."""

    name = "LB"
    needs_target = False

    def choose(self, task_type, view, rng):
        return int(np.argmin(view.backlog_work))


@register_policy("jsq")
class JoinShortestQueuePolicy(Policy):
    """JSQ: least number of resident tasks."""

    name = "JSQ"
    needs_target = False

    def choose(self, task_type, view, rng):
        return int(np.argmin(view.backlog_tasks))


# ---------------------------------------------------------------------------
# Batched on-device target solving
# ---------------------------------------------------------------------------

def _solve_single_batch(mus: np.ndarray, mixes: np.ndarray, dev):
    """Single-move GrIn over a (B, k, l) / (B, k) batch: (targets, x_sys,
    converged) tensors, each instance capped at 4 * its population + 64."""
    mus_t = torch.as_tensor(np.array(mus, dtype=np.float32), device=dev)
    caps = torch.as_tensor(4 * np.asarray(mixes).sum(axis=1) + 64,
                           dtype=torch.int32, device=dev)
    targets, conv, _ = _grin_single_core(
        mus_t, torch.as_tensor(mixes, dtype=torch.float32, device=dev), caps)
    return targets, system_throughput_torch(targets, mus_t), conv


def _repair_targets(raw: np.ndarray, mixes: np.ndarray) -> np.ndarray:
    """Round float placements to integers with EXACT row sums.

    The device solvers accumulate placements in float32, so a plain
    `.round()` can drift a row off its task count on large mixes; rows that
    drift are re-rounded by largest remainder (the same repair SLSQP uses).
    """
    raw = np.asarray(raw, dtype=np.float64)
    mixes = np.asarray(mixes, dtype=np.int64)
    out = raw.round().astype(np.int64)
    for b in np.flatnonzero((out.sum(axis=-1) != mixes).any(axis=-1)):
        out[b] = round_largest_remainder(raw[b], mixes[b])
    return np.maximum(out, 0)


def physical_power_matrix(policy: Policy, mus: np.ndarray):
    """(G, k, l) (or (k, l)) PHYSICAL power matrices for a policy's energy
    objective, or None for throughput objectives (unused)."""
    if policy.torch_objective == "max-x":
        return None
    power = policy.power or PROPORTIONAL_POWER
    mus = np.asarray(mus, dtype=np.float64)
    if mus.ndim == 2:
        return power.power_matrix(mus)
    return np.stack([power.power_matrix(m) for m in mus])


def solve_targets_torch(mu, n_tasks_batch, solver: str = "block",
                        objective: str = "max-x",
                        power: PowerModel | None = None, P=None, device=None):
    """Batched GrIn re-solve over many type mixes on the device.

    Returns (targets (B, k, l) int64, x_sys (B,) float) as NumPy arrays,
    with row sums repaired to match the mixes exactly. `solver="block"`
    (default) is the block-move GrIn; `solver="single"` the one-move-per-
    step variant (throughput only). `objective`/`power` switch the block
    solver to the energy objectives; `P` overrides the priced power
    matrix."""
    dev = resolve_device(device)
    mu = np.asarray(mu, dtype=np.float64)
    mixes_np = np.asarray(n_tasks_batch)
    if mixes_np.ndim != 2 or mixes_np.shape[1] != mu.shape[0]:
        raise ValueError(f"n_tasks_batch must be (B, k={mu.shape[0]}); got "
                         f"{tuple(mixes_np.shape)}")
    if solver == "block":
        targets, xs, _, _ = grin_solve_batch_torch(
            mu, mixes_np, objective=objective, power=power, P=P, device=dev)
    elif solver == "single":
        if objective != "max-x":
            raise ValueError("energy objectives need solver='block'")
        targets, xs, _ = _solve_single_batch(
            np.broadcast_to(mu, (len(mixes_np),) + mu.shape), mixes_np, dev)
    else:
        raise ValueError(f"unknown solver {solver!r}: block | single")
    return (_repair_targets(targets.cpu().numpy(), mixes_np),
            xs.cpu().numpy())


def solve_targets_grid_torch(mus, mixes, solver: str = "block",
                             objective: str = "max-x",
                             power: PowerModel | None = None, P=None,
                             device=None):
    """Whole (mu x mix) target grid in one batched device solve.

    mus: (G, k, l) affinity matrices; mixes: (M, k) type mixes. Returns
    (targets (G, M, k, l) int64, x_sys (G, M), converged (G, M) bool) as
    NumPy arrays. The grid is flattened to a (G*M,) batch, so the whole grid
    costs one solver loop whose depth is the slowest instance's move count.
    `P` ((G, k, l) or (k, l)) overrides the priced power matrix."""
    dev = resolve_device(device)
    mus = np.asarray(mus, dtype=np.float64)
    mixes = np.asarray(mixes, dtype=np.int64)
    if mus.ndim != 3 or mixes.ndim != 2 or mus.shape[1] != mixes.shape[1]:
        raise ValueError("need mus (G, k, l) and mixes (M, k) with matching "
                         f"k; got {mus.shape} and {mixes.shape}")
    G, k, l = mus.shape
    M = mixes.shape[0]
    mu_b = np.repeat(mus, M, axis=0)                    # (G*M, k, l)
    mix_b = np.tile(mixes, (G, 1))                      # (G*M, k)
    if P is not None and np.ndim(P) == 3:
        P = np.repeat(np.asarray(P), M, axis=0)         # align with mu_b
    if solver == "block":
        raw, xs, conv, _ = grin_solve_batch_torch(
            mu_b, mix_b, objective=objective, power=power, P=P, device=dev)
    elif solver == "single":
        if objective != "max-x":
            raise ValueError("energy objectives need solver='block'")
        raw, xs, conv = _solve_single_batch(mu_b, mix_b, dev)
    else:
        raise ValueError(f"unknown solver {solver!r}: block | single")
    targets = _repair_targets(raw.cpu().numpy(), mix_b).reshape(G, M, k, l)
    return (targets, xs.cpu().numpy().reshape(G, M),
            conv.cpu().numpy().reshape(G, M))


# ---------------------------------------------------------------------------
# Largest-deficit routing on the device
# ---------------------------------------------------------------------------

def _mu_tiebreak_ranks(mu: np.ndarray) -> np.ndarray:
    """Per-row preference rank of each pool: 0 = largest mu, ties broken by
    the lower pool index. Computed in float64 on the host so the device
    router's tie-breaks match `route` exactly (no float32 collisions)."""
    order = np.argsort(-np.asarray(mu, dtype=np.float64), axis=1, kind="stable")
    rank = np.empty_like(order)
    rank[np.arange(mu.shape[0])[:, None], order] = np.arange(mu.shape[1])
    return rank.astype(np.int32)


def deficit_route_torch(target, rank, counts, t):
    """One largest-deficit routing decision on the device: the pool index
    for an arriving t-type task (integer tensors (k, l), or batched
    (B, k, l) with t (B,)). combined = deficit * l - rank is a strict
    lexicographic key over (deficit desc, mu desc, pool index asc) because
    rank < l, so the first-index argmax reproduces the host rule decision
    for decision. Every device router (route_many, the engine) goes through
    this helper so their decisions stay identical."""
    l = target.shape[-1]
    if target.dim() == 2:
        return torch.argmax((target[t] - counts[t]) * l - rank[t])
    rows = t[:, None, None].expand(-1, 1, l)
    key = ((target.gather(1, rows) - counts.gather(1, rows)) * l
           - rank.gather(1, rows))[:, 0]
    return torch.argmax(key, dim=1)


def deficit_route_masked_torch(target, rank, counts, t, avail):
    """`deficit_route_torch` restricted to available pools (`avail`, bool
    (l,) or (B, l)): pools that are down drop out of the argmax through the
    integer sentinel -(2**30), so with every pool up the key — and the
    decision — is the unmasked rule's."""
    l = target.shape[-1]
    if target.dim() == 2:
        key = (target[t] - counts[t]) * l - rank[t]
    else:
        rows = t[:, None, None].expand(-1, 1, l)
        key = ((target.gather(1, rows) - counts.gather(1, rows)) * l
               - rank.gather(1, rows))[:, 0]
    return torch.argmax(torch.where(avail, key, -(2**30)), dim=-1)


def _route_many_torch(target, rank, counts0, types: np.ndarray):
    """Sequential largest-deficit dispatch of a burst on the device: one
    decision per arrival, in order, with no host round trip in between.
    Returns (final counts, decisions) as device tensors."""
    counts = counts0.clone()
    js = torch.empty(len(types), dtype=torch.int64, device=counts.device)
    for i, t in enumerate(types.tolist()):
        j = deficit_route_torch(target, rank, counts, t)
        js[i] = j
        counts[t].index_add_(0, j.reshape(1), counts.new_ones(1))
    return counts, js


# ---------------------------------------------------------------------------
# SchedulerCore — the shared machinery, implemented exactly once
# ---------------------------------------------------------------------------

_CACHE_CAP = 1024


class SchedulerCore:
    """Largest-deficit routing toward a policy's target state N* (Lemma 2),
    with target caching, EWMA straggler rate-folding and elastic topology.

    Single-threaded. Callers interact through:

      route(task_type[, view][, rng]) -> pool   (updates live counts)
      complete(task_type, pool[, service_s])    (EWMA feedback if timed)
      notify_type_counts(n_tasks)               (piecewise-closed mix change)
      pool_lost(j) / pool_added(mu_column)      (elastic topology)
      set_frequencies(f)                        (per-pool DVFS rescale)
      set_class_weights(w)                      (priority-class weights)
      warm_targets(mixes)                       (batched pre-solve on device)

    When the in-flight type mix is pinned via reset/notify_type_counts, the
    target is solved for that mix (the simulator's closed-population case);
    otherwise the mix is inferred from live counts plus the arriving task
    (the live cluster case). Both reduce to the same deficit rule.
    """

    def __init__(self, policy: str | Policy, mu: np.ndarray, *,
                 rate_alpha: float = 0.3,
                 resolve_rate_rel_change: float = 0.25, seed: int = 0,
                 refresh_on_topology: bool = False,
                 cache_capacity: int | None = None, device=None):
        self.policy = get_policy(policy)
        # batched solves (warm_targets, elastic_what_if) and route_many run
        # here; the scalar route() hot path stays on the host
        self.device = resolve_device(device)
        self._rate_alpha = rate_alpha
        self._resolve_threshold = resolve_rate_rel_change
        self._seed = seed
        # Opt-in: pool_lost/pool_added repin the policy's pinned target to
        # the new pool set instead of leaving it to raise on the next route.
        self.refresh_on_topology = refresh_on_topology
        if cache_capacity is None:
            cache_capacity = _CACHE_CAP     # read at call time (patchable)
        if cache_capacity < 1:
            raise ValueError(f"cache_capacity must be >= 1; "
                             f"got {cache_capacity}")
        self._cache_cap = int(cache_capacity)
        self.reset(mu)

    # ---------------- lifecycle ----------------
    def _set_mu(self, mu: np.ndarray) -> None:
        """Install a new affinity matrix: scalar mirrors for the hot route
        path, a monotone version token for target-cache keys, and pinned-
        target invalidation. All mu changes MUST go through here."""
        self.mu = mu
        self.k, self.l = mu.shape
        self._mu_rows = mu.tolist()
        self._inv_mu_rows = [[1.0 / v for v in row] for row in self._mu_rows]
        self._mu_token = getattr(self, "_mu_token", 0) + 1
        self._pinned_rows = None            # target rows for (mix, mu), lazy
        self._ranks = None                  # route_many tie-break ranks, lazy

    def reset(self, mu: np.ndarray | None = None,
              n_tasks: np.ndarray | None = None) -> "SchedulerCore":
        """Zero live state (counts, backlog, EWMA, cache); optionally install
        a new affinity matrix and pin the initial type mix."""
        if mu is not None:
            mu = np.asarray(mu, dtype=np.float64)
            if self.policy.pool_limit not in (None, mu.shape[1]):
                raise ValueError(
                    f"{self.policy.name} requires exactly "
                    f"{self.policy.pool_limit} pools; got {mu.shape[1]}")
            self._set_mu(mu)
            self.nominal_mu = self.mu.copy()   # the f=1 DVFS baseline
            self._freq = np.ones(self.l)
        else:
            self._set_mu(self.base_mu.copy())  # drop EWMA folding: to nominal
        self.base_mu = self.mu.copy()
        self._counts_rows = [[0] * self.l for _ in range(self.k)]
        self._backlog = [0.0] * self.l
        self.tracker = StragglerTracker(self.l, alpha=self._rate_alpha)
        self._rng = np.random.default_rng(self._seed)
        self._targets: dict[tuple, np.ndarray] = {}
        self._mix: np.ndarray | None = None
        self._mix_key: tuple | None = None
        self.resolves = 0
        # target-cache statistics (`stats` snapshot)
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_evictions = 0
        self._solve_time_s = 0.0
        self._churn_warned = False
        if n_tasks is not None:
            self.notify_type_counts(n_tasks)
        return self

    @property
    def name(self) -> str:
        return self.policy.name

    @property
    def counts(self) -> np.ndarray:
        """(k, l) live placement. A snapshot: the hot route/complete path
        maintains scalar rows internally and materializes the array on
        access."""
        return np.asarray(self._counts_rows, dtype=np.int64)

    @property
    def backlog_work(self) -> np.ndarray:
        """(l,) expected remaining seconds routed to each pool (snapshot)."""
        return np.asarray(self._backlog, dtype=np.float64)

    # ---------------- target maintenance ----------------
    @property
    def stats(self) -> dict:
        """Target-cache + solve statistics snapshot: hits/misses count
        `_target_for` lookups, evictions count FIFO displacement (the churn
        signal: a working set larger than `cache_capacity`), solve_time_s
        is the cumulative host wall-clock spent inside
        `policy.solve_target`."""
        return {"cache_hits": self._cache_hits,
                "cache_misses": self._cache_misses,
                "cache_evictions": self._cache_evictions,
                "cache_size": len(self._targets),
                "cache_capacity": self._cache_cap,
                "resolves": self.resolves,
                "solve_time_s": self._solve_time_s}

    def _cache_put(self, key: tuple, target: np.ndarray) -> None:
        if len(self._targets) >= self._cache_cap:
            # FIFO: evict the single oldest entry (dicts preserve insertion
            # order) rather than wiping the whole cache.
            evicted = next(iter(self._targets))
            self._targets.pop(evicted)
            self._cache_evictions += 1
            if (not self._churn_warned
                    and self._cache_evictions >= self._cache_cap):
                # a full capacity of evictions means the working set cycled
                # through the whole cache at least once: every later lookup
                # is likely a miss and targets re-solve continuously
                self._churn_warned = True
                warnings.warn(
                    f"{self.policy.name} target cache is churning: "
                    f"{self._cache_evictions} FIFO evictions at capacity "
                    f"{self._cache_cap} — the mix/mu working set exceeds "
                    "the cache; raise SchedulerCore(cache_capacity=...) or "
                    "narrow the sweep", RuntimeWarning, stacklevel=3)
        self._targets[key] = target

    def _weights_key(self) -> tuple | None:
        """Priority-class weight vector as a hashable cache-key component.
        Weight updates via `set_class_weights` change this key, so a warm
        cache can never serve a target solved under stale weights."""
        w = self.policy.class_weights
        return None if w is None else tuple(float(x) for x in w)

    def set_class_weights(self, weights) -> None:
        """Update the policy's priority-class weight vector. Targets re-solve
        lazily because the weights are part of every cache key; the pinned
        fast-path rows are dropped eagerly."""
        cur = self.policy.class_weights
        if cur is None:
            raise ValueError(f"{self.policy.name} is not a priority-class "
                             "policy (no class_weights)")
        w = np.asarray(weights, dtype=np.float64)
        if w.shape != (len(cur),) or (w < 0).any():
            raise ValueError(f"weights must be a nonneg ({len(cur)},) "
                             f"vector; got {weights!r}")
        self.policy.class_weights = w
        self._pinned_rows = None

    def _target_for(self, n_tasks: np.ndarray,
                    key_hint: tuple | None = None) -> np.ndarray:
        key = ((tuple(int(x) for x in n_tasks) if key_hint is None
                else key_hint), self._mu_token, self._weights_key())
        hit = self._targets.get(key)
        if hit is None:
            self._cache_misses += 1
            t0 = time.perf_counter()
            hit = np.asarray(self.policy.solve_target(self.mu, np.asarray(n_tasks)))
            self._solve_time_s += time.perf_counter() - t0
            if hit.shape != (self.k, self.l):
                raise ValueError(
                    f"{self.policy.name} target shape {hit.shape} does not "
                    f"match the current ({self.k}, {self.l}) topology (fixed "
                    "targets must be re-pinned after pool_lost/pool_added)")
            self._cache_put(key, hit)
            self.resolves += 1
        else:
            self._cache_hits += 1
        return hit

    def notify_type_counts(self, n_tasks: np.ndarray) -> None:
        """Piecewise-closed operation: the in-flight type mix changed (or is
        externally known, e.g. a closed population). Pins the mix used for
        target solving until the next notify/reset. The mix is snapshotted
        here (keyed once), so later caller-side mutation of the array has no
        effect until the next notify."""
        key = tuple(int(x) for x in n_tasks)
        if key == self._mix_key:
            return                          # unchanged: keep pinned target
        self._mix = np.asarray(key, dtype=np.int64)
        self._mix_key = key
        self._pinned_rows = None

    def _pinned_target_rows(self) -> list:
        """Scalar rows of the target for the pinned mix under the current mu
        (the hot path of the simulator's closed populations)."""
        rows = self._pinned_rows
        if rows is None:
            rows = self._target_for(self._mix, key_hint=self._mix_key).tolist()
            self._pinned_rows = rows
        return rows

    def warm_targets(self, mixes) -> int:
        """Pre-solve targets for many type mixes. Policies that support it
        batch on the device via `solve_targets_torch`; others loop the host
        solver.
        Returns the number of targets inserted during this call. The cache
        holds at most _CACHE_CAP entries with FIFO eviction, so warming more
        than the cap keeps the most recently warmed mixes cached and earlier
        ones re-solve lazily on the host.

        The batched path uses the block-move device solver, so a warmed
        mix can pin a different (same-quality-class) local maximum than the
        host solver would — routing on warmed entries is a deliberate
        speed-for-bit-parity trade; skip warming where exact reproducibility
        vs a cold core matters."""
        mixes = np.asarray(mixes, dtype=np.int64)
        if self.policy.supports_torch_batch and self.policy.needs_target:
            targets, _ = solve_targets_torch(
                self.policy.device_mu(self.mu), mixes,
                objective=self.policy.torch_objective,
                power=self.policy.power,
                P=physical_power_matrix(self.policy, self.mu),
                device=self.device)
            added = 0
            for mix, N in zip(mixes, targets):
                key = (tuple(int(x) for x in mix), self._mu_token,
                       self._weights_key())
                if key in self._targets:
                    continue
                self._cache_put(key, N)
                added += 1
            return added
        before = self.resolves
        for mix in mixes:
            self._target_for(mix)
        return self.resolves - before

    def elastic_what_if(self, mixes=None, *, added_columns=None,
                        warm: bool = True,
                        power: PowerModel | None = None) -> dict:
        """Elastic planning grids: X_sys AND energy/EDP for the current
        topology, for every single-pool loss, and for each candidate added
        pool — each topology group solved as one `solve_targets_grid_torch`
        device call and priced under `power` (default: the policy's power
        model, else proportional).

        mixes: (M, k) type mixes (default: the pinned mix); added_columns:
        (A, k) candidate mu columns for `pool_added`. Returns
        {"base": (M,), "pool_lost": (l, M), "pool_added": (A, M)} of the
        policy's OBJECTIVE throughput (X_sys; the class-weighted
        sum_c w_c X_c for priority policies) plus matching "*_energy"
        (E[E] per task, eq. 19) and "*_edp" (eq. 21) grids — both always
        physical, weights never scale watts or the EDP delay term —
        answering "what does losing pool j / adding this pool do to
        achievable throughput and energy across these mixes" without
        touching live state. With `warm=True` the base-topology
        targets are inserted into the target cache, so routing on any of
        the mixes after a `notify_type_counts` is already warm.
        """
        if not self.policy.needs_target:
            raise ValueError(f"{self.policy.name} routes statelessly; "
                             "what-ifs apply to target policies")
        if mixes is None:
            if self._mix is None:
                raise ValueError("no mixes given and no pinned type mix")
            mixes = self._mix[None]
        mixes = np.asarray(mixes, dtype=np.int64)
        power = power or self.policy.power or PROPORTIONAL_POWER
        ntot = mixes.sum(axis=1).astype(np.float64)     # (M,)

        def grid(mus: np.ndarray):
            if self.policy.supports_torch_batch:
                # solve AND score under the policy's device matrix (class-
                # weighted for priority policies): xs is the policy's
                # objective value, identical semantics on both branches
                targets, xs, _ = solve_targets_grid_torch(
                    np.stack([self.policy.device_mu(m) for m in mus]), mixes,
                    objective=self.policy.torch_objective,
                    power=self.policy.power,
                    P=physical_power_matrix(self.policy, mus),
                    device=self.device)
            else:
                targets = np.stack([
                    np.stack([np.asarray(self.policy.solve_target(m, mix))
                              for mix in mixes]) for m in mus])
                xs = np.array([[system_throughput(N, self.policy.device_mu(m))
                                for N in row] for m, row in zip(mus, targets)])
            G, M = xs.shape
            energy = expected_energy_batch_torch(
                torch.as_tensor(targets.reshape((G * M,) + targets.shape[2:]),
                                dtype=torch.float32, device=self.device),
                torch.as_tensor(np.repeat(mus, M, axis=0),
                                dtype=torch.float32, device=self.device),
                torch.as_tensor(
                    np.repeat(np.stack([power.power_matrix(m) for m in mus]),
                              M, axis=0),
                    dtype=torch.float32, device=self.device)
            ).cpu().numpy().astype(np.float64).reshape(G, M)
            # energy and EDP stay PHYSICAL (eq. 19/21: watts and X_sys are
            # class-blind) — for priority policies xs above is the weighted
            # objective, so EDP's delay term uses its own physical X_sys;
            # single-class policies (device_mu identity) reuse xs as-is
            x_phys = xs if self.policy.class_weights is None else np.array(
                [[system_throughput(N, m)
                  for N in row] for m, row in zip(mus, targets)])
            with np.errstate(divide="ignore"):
                edp = energy * np.where(x_phys > 0, ntot[None, :] / x_phys,
                                        np.inf)
            return targets, xs, energy, edp

        base_targets, base_xs, base_e, base_edp = grid(self.mu[None])
        if warm:
            for mix, N in zip(mixes, base_targets[0]):
                key = (tuple(int(x) for x in mix), self._mu_token,
                       self._weights_key())
                if key not in self._targets:
                    self._cache_put(key, N)
        if self.l > 1:
            _, lost_xs, lost_e, lost_edp = grid(
                np.stack([np.delete(self.mu, j, axis=1)
                          for j in range(self.l)]))
        else:
            # losing the only pool leaves nowhere to run: X_sys = 0
            lost_xs = np.zeros((1, len(mixes)))
            lost_e = np.full((1, len(mixes)), np.inf)
            lost_edp = np.full((1, len(mixes)), np.inf)
        if added_columns is not None and len(added_columns):
            cols = np.asarray(added_columns, dtype=np.float64)
            _, added_xs, added_e, added_edp = grid(np.stack([
                np.concatenate([self.mu, c[:, None]], axis=1) for c in cols]))
        else:
            added_xs = np.zeros((0, len(mixes)))
            added_e = np.zeros((0, len(mixes)))
            added_edp = np.zeros((0, len(mixes)))
        return {"base": base_xs[0], "pool_lost": lost_xs,
                "pool_added": added_xs,
                "base_energy": base_e[0], "pool_lost_energy": lost_e,
                "pool_added_energy": added_e,
                "base_edp": base_edp[0], "pool_lost_edp": lost_edp,
                "pool_added_edp": added_edp}

    # ---------------- routing ----------------
    def _internal_view(self) -> SystemView:
        counts = self.counts
        return SystemView(counts=counts, backlog_work=self.backlog_work,
                          backlog_tasks=counts.sum(axis=0), mu=self.mu)

    def route(self, task_type: int, view: SystemView | None = None,
              rng: np.random.Generator | None = None) -> int:
        """Choose the pool for an arriving task; updates live counts.

        `view` lets a caller expose richer observations (the simulator's true
        remaining work for LB); target policies route on counts either way.
        `rng` lets a caller own the random stream (reproducible sweeps).
        """
        if self.policy.needs_target:
            if view is None and self._mix_key is not None:
                # Hot path (pinned mix, own counts): scalar largest-deficit
                # with rate tiebreak — decision-identical to the array path.
                rows = self._pinned_rows
                if rows is None:
                    rows = self._pinned_target_rows()
                trow = rows[task_type]
                crow = self._counts_rows[task_type]
                mrow = self._mu_rows[task_type]
                best_d = trow[0] - crow[0]
                best_m = mrow[0]
                j = 0
                for jj in range(1, self.l):
                    d = trow[jj] - crow[jj]
                    if d > best_d or (d == best_d and mrow[jj] > best_m):
                        best_d, best_m, j = d, mrow[jj], jj
            else:
                counts = view.counts if view is not None else self.counts
                if self._mix is not None:
                    target = self._target_for(self._mix, key_hint=self._mix_key)
                else:
                    mix = counts.sum(axis=1) if view is None \
                        else self.counts.sum(axis=1)
                    mix[task_type] += 1        # include the arriving task
                    target = self._target_for(mix)
                deficit = target[task_type] - counts[task_type]
                best = np.flatnonzero(deficit == deficit.max())
                j = int(best[np.argmax(self.mu[task_type][best])])
        else:
            j = int(self.policy.choose(
                task_type, view if view is not None else self._internal_view(),
                rng if rng is not None else self._rng))
        self._counts_rows[task_type][j] += 1
        self._backlog[j] += self._inv_mu_rows[task_type][j]
        return j

    def route_backup(self, task_type: int, exclude: int,
                     avail: np.ndarray | None = None,
                     view: SystemView | None = None,
                     rng: np.random.Generator | None = None) -> int:
        """Choose the pool for a speculative backup copy of a resident task.

        The hedge-aware twin of `route`: the backup may never land on the
        primary's pool `exclude` (a straggler duplicated onto its own pool
        buys nothing), and an optional `avail` mask further restricts the
        menu to pools currently up. Returns -1 when no pool is eligible —
        the caller skips the hedge and the core's books are untouched.
        On success the live count/backlog update is identical to `route`,
        so a later `complete`/`unroute` balances it the same way.
        """
        ok = (np.ones(self.l, dtype=bool) if avail is None
              else np.asarray(avail, dtype=bool).copy())
        if 0 <= exclude < self.l:
            ok[exclude] = False
        if not ok.any():
            return -1
        if self.policy.needs_target:
            counts = view.counts if view is not None else self.counts
            if self._mix is not None:
                target = self._target_for(self._mix, key_hint=self._mix_key)
            else:
                mix = counts.sum(axis=1)
                mix[task_type] += 1        # include the backup copy
                target = self._target_for(mix)
            deficit = (target[task_type] - counts[task_type]
                       ).astype(np.float64)
            deficit[~ok] = -np.inf
            best = np.flatnonzero(deficit == deficit.max())
            j = int(best[np.argmax(self.mu[task_type][best])])
        else:
            v = view if view is not None else self._internal_view()
            if not ok.all():
                # Same masking convention as the fault engines: ineligible
                # pools look infinitely loaded and infinitely slow, so every
                # stateless rule (LB/JSQ/BF/RD via choose) avoids them.
                vmu = np.array(v.mu, dtype=np.float64)
                vmu[:, ~ok] = -np.inf
                bw = np.array(v.backlog_work, dtype=np.float64)
                bt = np.array(v.backlog_tasks, dtype=np.float64)
                bw[~ok] = np.inf
                bt[~ok] = np.inf
                v = SystemView(counts=v.counts, backlog_work=bw,
                               backlog_tasks=bt, mu=vmu)
            j = int(self.policy.choose(
                task_type, v, rng if rng is not None else self._rng))
            if not ok[j]:       # random policies ignore the mu mask
                opts = np.flatnonzero(ok)
                r = rng if rng is not None else self._rng
                j = int(opts[r.integers(len(opts))])
        self._counts_rows[task_type][j] += 1
        self._backlog[j] += self._inv_mu_rows[task_type][j]
        return j

    def route_many(self, task_types) -> np.ndarray:
        """Route a burst of arrivals through the largest-deficit rule on the
        device (`deficit_route_torch`, one decision per arrival in order).
        Requires a pinned type mix — the target is then a single placement —
        and is decision-identical to looping `route` (tie-breaks included:
        the ranks come from mu in float64 on the host). Unpinned or
        stateless policies fall back to the Python loop."""
        types = np.asarray(task_types, dtype=np.int64)
        if types.ndim != 1:
            raise ValueError(f"task_types must be 1-D; got {types.shape}")
        if (not self.policy.needs_target or self._mix_key is None
                or types.size == 0):
            return np.array([self.route(int(t)) for t in types],
                            dtype=np.int64)
        target = self._target_for(self._mix, key_hint=self._mix_key)
        if self._ranks is None:
            self._ranks = _mu_tiebreak_ranks(self.mu)
        counts, js = _route_many_torch(
            torch.as_tensor(target, dtype=torch.int64, device=self.device),
            torch.as_tensor(self._ranks, dtype=torch.int64,
                            device=self.device),
            torch.as_tensor(self.counts, dtype=torch.int64,
                            device=self.device), types)
        js = js.cpu().numpy()
        self._counts_rows = counts.cpu().numpy().tolist()
        backlog = self.backlog_work
        # np.add.at applies in arrival order: bit-equal to sequential route().
        np.add.at(backlog, js, (1.0 / self.mu)[types, js])
        self._backlog = backlog.tolist()
        return js

    def unroute(self, task_type: int, pool: int) -> None:
        """Undo the most recent `route` of a task that was never admitted
        (admission shed or a full finite queue): the exact inverse of the
        count/backlog update, with no EWMA or rate-refresh side effects —
        the task never ran, so there is nothing to observe.

        Guards: a pool index from before a pool_lost/pool_added is stale
        (columns shifted), and undoing a route that is not on the books
        would drive counts negative — both corrupt deficit routing silently,
        so they raise instead."""
        if not 0 <= pool < self.l:
            raise IndexError(
                f"unroute pool {pool} out of range for l={self.l} pools "
                "(stale index from before a pool_lost/pool_added? remap it "
                "to the post-event column)")
        if self._counts_rows[task_type][pool] <= 0:
            raise ValueError(
                f"unroute(type={task_type}, pool={pool}) has no matching "
                "route on the books (counts would go negative). Topology "
                "events do not migrate in-flight counts; unroute on the "
                "pre-event pool before applying pool_lost/pool_added.")
        self._counts_rows[task_type][pool] -= 1
        b = self._backlog[pool] - self._inv_mu_rows[task_type][pool]
        self._backlog[pool] = b if b > 0.0 else 0.0

    def complete(self, task_type: int, pool: int,
                 service_s: float | None = None) -> None:
        """A task finished on `pool`; with a measured service time, fold the
        observation into the EWMA and re-solve on material rate change."""
        self._counts_rows[task_type][pool] -= 1
        b = self._backlog[pool] - self._inv_mu_rows[task_type][pool]
        self._backlog[pool] = b if b > 0.0 else 0.0
        if service_s is not None:
            expected = 1.0 / self.base_mu[task_type, pool]
            self.tracker.observe(pool, expected / max(service_s, 1e-12))
            # Rate-folding serves the target refresh; the classic stateless
            # baselines stay static, as the paper defines them.
            if self.policy.needs_target:
                self._maybe_refresh_rates()

    # ---------------- stragglers / elastic / DVFS ----------------
    @property
    def frequencies(self) -> np.ndarray:
        """(l,) current per-pool DVFS scale (1.0 = nominal)."""
        return self._freq.copy()

    def set_frequencies(self, f) -> None:
        """Per-pool DVFS rescale: effective rates become f_j * nominal mu
        (alpha-power model, mu ∝ f). Routed through `_set_mu`, so the mu
        version token bumps and a warm cache can never serve a target
        solved at stale frequencies. Accumulated EWMA straggler folding is
        dropped to the new operating point (it re-converges from live
        completions). Frequencies must be positive: parking a pool is a
        `pool_lost` topology event, not a frequency."""
        f = np.asarray(f, dtype=np.float64)
        if f.shape != (self.l,) or not np.isfinite(f).all() or (f <= 0).any():
            raise ValueError(f"need ({self.l},) positive finite "
                             f"frequencies; got {f!r}")
        self._freq = f.copy()
        self.base_mu = self.nominal_mu * f[None, :]
        self._set_mu(self.base_mu.copy())

    def _maybe_refresh_rates(self) -> None:
        """Fold observed slowdowns into mu; targets re-solve lazily because
        the cache key includes the mu version token."""
        factors = self.tracker.slowdown_factors()
        new_mu = self.base_mu * factors[None, :]
        rel = np.abs(new_mu - self.mu) / np.maximum(self.mu, 1e-12)
        if rel.max() > self._resolve_threshold:
            self._set_mu(new_mu)

    def pool_lost(self, pool: int) -> None:
        """Elastic: a pool died; drop its column and re-solve on next route.
        In-flight tasks on the pool are the caller's to re-enqueue."""
        self._set_mu(np.delete(self.mu, pool, axis=1))
        self.base_mu = np.delete(self.base_mu, pool, axis=1)
        self.nominal_mu = np.delete(self.nominal_mu, pool, axis=1)
        self._freq = np.delete(self._freq, pool)
        # rebuild-and-swap keeps the row lists rectangular at every instant
        # (unlocked snapshot readers must never observe ragged rows)
        self._counts_rows = [row[:pool] + row[pool + 1:]
                             for row in self._counts_rows]
        self._backlog = self._backlog[:pool] + self._backlog[pool + 1:]
        self._targets.clear()
        t = self.tracker
        t.rates = np.delete(t.rates, pool)
        t.seen = np.delete(t.seen, pool)
        if self.refresh_on_topology:
            self.policy.repin_target(self.mu, lost=pool)

    def pool_added(self, mu_column: np.ndarray,
                   frequency: float = 1.0) -> None:
        """Elastic: a pool joined with NOMINAL rates `mu_column`, optionally
        entering at a non-unit DVFS `frequency` (effective rates scale)."""
        if not (np.isfinite(frequency) and frequency > 0):
            raise ValueError(f"frequency must be positive; got {frequency!r}")
        mu_column = np.asarray(mu_column, dtype=np.float64)
        eff = mu_column * frequency
        self._set_mu(np.concatenate([self.mu, eff[:, None]], axis=1))
        self.base_mu = np.concatenate([self.base_mu, eff[:, None]], axis=1)
        self.nominal_mu = np.concatenate(
            [self.nominal_mu, mu_column[:, None]], axis=1)
        self._freq = np.append(self._freq, float(frequency))
        self._counts_rows = [row + [0] for row in self._counts_rows]
        self._backlog = self._backlog + [0.0]
        self._targets.clear()
        t = self.tracker
        t.rates = np.append(t.rates, 0.0)
        t.seen = np.append(t.seen, False)
        if self.refresh_on_topology:
            self.policy.repin_target(self.mu, added=True)


def as_core(policy: str | Policy | SchedulerCore, mu: np.ndarray,
            **kwargs) -> SchedulerCore:
    """Coerce any accepted policy spec into a SchedulerCore over `mu`."""
    if isinstance(policy, SchedulerCore):
        return policy
    return SchedulerCore(policy, mu, **kwargs)
