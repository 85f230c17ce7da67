"""Batched closed-network simulation on the device.

One call simulates a whole fleet of closed networks: every batch point
(seed, type mix, target, affinity matrix, routing policy) advances one
event per loop iteration on the batch's tensors — next completion, PS,
FCFS or PRIO depletion, routing of the program's next task, task-size draw
— the counterpart of the reference package's vmapped `lax.scan` event core.

Scope and semantics:

  * Per-point route modes: deficit (target policies) plus the four classic
    baselines — JSQ, LB, RD and BF. Deficit routing goes through
    `deficit_route_torch`, the same strict lexicographic key as
    `SchedulerCore.route_many`, so given identical event sequences the route
    decisions match the host rule exactly. JSQ picks the fewest-resident
    column, LB the least remaining true work (host-compat semantics: a
    task's true remaining size depletes in proportion to the service it
    received), BF the fastest column for the type, RD a uniform column.
  * Service orders: PS, FCFS, and PRIO — strict-priority preemption-free
    (arXiv:1712.03246): the running head always finishes; the next to run
    is the oldest waiting task of the highest-priority class present
    (class 0 first; `class_of_type` maps types to classes). Waiting tasks
    are ranked by the int64 key class * stamp_cap + admission stamp.
  * Per-class metrics: throughput, response time, energy and occupancy per
    priority class in every result dict / SimMetrics (the C == 1
    reductions for single-class configs); `class_distributions` gives each
    class its own task-size distribution.
  * Piecewise type re-draw (`type_mix`): each completed program's next task
    re-draws its type from the mix probabilities. The deficit target is
    pinned at the EXPECTED mix (largest-remainder rounding of N * p) — the
    quasi-static approximation of the host core's per-mix re-solve — so
    results are statistically, not bit-, comparable to the host core.
  * Sizes, RD choices and re-drawn types come from one `torch.Generator`
    per batch point, seeded from the point's seed and drawn in bulk before
    the loop. They cannot replay the host core's NumPy streams, so results
    agree with the host oracle statistically, not bit for bit.
  * float32 state, like the reference's device engine. Open-traffic
    configs run on the open engine (`repro_torch.traffic.engine_torch`,
    through `simulate_policy`); closed-network fault inputs are not ported
    yet (ROADMAP A4, item 1) and raise.

`compare_policies` runs a Fig. 9-style policy comparison — every target
policy plus the baselines — as one batched simulation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.affinity import PowerModel, PROPORTIONAL_POWER
from repro_torch.core.slsqp import round_largest_remainder
from repro_torch.obs.meta import run_meta
from repro_torch.sched.api import (_mu_tiebreak_ranks, deficit_route_torch,
                                   get_policy, physical_power_matrix,
                                   solve_targets_grid_torch)
from repro_torch.sim.simulator import SimMetrics

_BIG_STAMP = 2**62

# Route modes carried per batch point (data, so one loop serves
# mixed-policy batches).
MODE_DEFICIT, MODE_JSQ, MODE_LB, MODE_RD, MODE_BF = 0, 1, 2, 3, 4
_BASELINE_MODES = {"jsq": MODE_JSQ, "lb": MODE_LB, "rd": MODE_RD,
                   "bf": MODE_BF}
_SAMPLED = ("exponential", "uniform", "constant", "weibull", "hyperexp",
            "bounded_pareto")


def _sizes_from_uniforms(distribution, u, u_comp) -> torch.Tensor:
    """Mean-1 task sizes (matching `repro_torch.sim.distributions`) from
    uniforms u, u_comp in [0, 1) of any shape."""
    name = distribution.name
    expo = -torch.log1p(-u)                              # Exp(1)
    if name == "exponential":
        return expo
    if name == "uniform":
        return 2.0 * u
    if name == "constant":
        return torch.ones_like(u)
    if name == "weibull":
        return expo ** (1.0 / distribution.k) / distribution._raw_mean
    if name == "hyperexp":
        cum = torch.as_tensor(np.cumsum(distribution.probs)[:-1],
                              dtype=torch.float32, device=u.device)
        comp = torch.searchsorted(cum, u_comp.contiguous(), right=True)
        inv_r = torch.as_tensor([1.0 / r for r in distribution.rates],
                                dtype=torch.float32, device=u.device)
        return expo * inv_r[comp] / distribution._raw_mean
    if name == "bounded_pareto":
        a, L, H = distribution.alpha, distribution.low, distribution.high
        x = (-(u * H**a - u * L**a - H**a) / (H**a * L**a)) ** (-1.0 / a)
        return x / distribution._raw_mean
    raise ValueError(f"no device sampler for distribution {name!r}; "
                     f"supported: {', '.join(_SAMPLED)}")


def _draws(seeds, n_draws: int, distributions, l: int, dev,
           with_types: bool = False):
    """Per-point streams, drawn in bulk, T = n_draws: sizes (D, T, B)
    float32, one slice per distribution in `distributions` (all from the
    same uniforms), RD columns (T, B) int64 and, with `with_types`, (T, B)
    uniforms for type re-draws from the same generator (else None). Point
    b's draws depend only on its own seed."""
    us, uts = [], []
    for s in seeds:
        g = torch.Generator(device=dev).manual_seed(int(s))
        us.append(torch.rand((n_draws, 3), device=dev, generator=g))
        if with_types:
            uts.append(torch.rand(n_draws, device=dev, generator=g))
    u = torch.stack(us, dim=1)                           # (T, B, 3)
    sizes = torch.stack([
        _sizes_from_uniforms(d, u[..., 0], u[..., 1]).to(torch.float32)
        for d in distributions]).contiguous()
    rd = torch.clamp((u[..., 2] * l).to(torch.int64), max=l - 1).contiguous()
    return sizes, rd, torch.stack(uts, dim=1) if with_types else None


def _simulate_fleet(mu, P, target, rank, types0, sizes_c, rd, u_type,
                    mix_cum, cls, modes_np, *, order, n_steps, warmup):
    """The event loop. mu/P (B, k, l) float32, target/rank (B, k, l) int64,
    types0 (B, n) int64, sizes_c (D, n + n_steps, B) float32 with D = 1
    (one distribution) or C (one per class), rd (n + n_steps, B), u_type
    (n_steps, B) uniforms and mix_cum (B, k - 1) cumulative type
    probabilities for re-draws (both None: no re-draw), cls (k,) int64
    type -> class, modes_np (B,) host ints. Returns the per-point
    accumulators as device tensors."""
    B, k, l = mu.shape
    n = types0.shape[1]
    C = int(cls.max()) + 1
    dev = mu.device
    cols = torch.arange(l, device=dev)
    idx_n = torch.arange(n, device=dev)[None, :]
    rows_b = torch.arange(B, device=dev)
    mu_flat, P_flat = mu.reshape(B, k * l), P.reshape(B, k * l)
    modes = torch.as_tensor(modes_np, device=dev)
    present = sorted(set(int(m) for m in modes_np))
    inf = torch.tensor(torch.inf, device=dev)
    stamp_cap = n + n_steps + 2         # PRIO key stride > any stamp

    def route_one(counts, backlog, t, rd_j):
        cand = {}
        if MODE_DEFICIT in present:
            cand[MODE_DEFICIT] = deficit_route_torch(target, rank, counts, t)
        if MODE_JSQ in present:
            cand[MODE_JSQ] = torch.argmin(counts.sum(dim=1), dim=1)
        if MODE_LB in present:
            cand[MODE_LB] = torch.argmin(backlog, dim=1)
        if MODE_RD in present:
            cand[MODE_RD] = rd_j
        if MODE_BF in present:
            cand[MODE_BF] = torch.argmax(
                mu.gather(1, t[:, None, None].expand(B, 1, l))[:, 0], dim=1)
        j = cand[present[0]]
        for m in present[1:]:
            j = torch.where(modes == m, cand[m], j)
        return j

    def bump(counts, t, j, delta):
        counts.view(B, k * l).scatter_add_(
            1, (t * l + j)[:, None],
            torch.full((B, 1), delta, dtype=counts.dtype, device=dev))

    def sizes_for(t, row):
        """The size draw `row` of each point, from its task's class's
        distribution: t (B,) types -> (B,)."""
        if sizes_c.shape[0] == 1:
            return sizes_c[0, row]
        return sizes_c[:, row].gather(0, cls[t][None])[0]

    # ---- initial admissions: sequential routing of the n programs ----
    counts = torch.zeros((B, k, l), dtype=torch.int64, device=dev)
    backlog = torch.zeros((B, l), dtype=torch.float32, device=dev)
    proc = torch.empty((B, n), dtype=torch.int64, device=dev)
    run_pid = torch.full((B, l), -1, dtype=torch.int64, device=dev)
    if sizes_c.shape[0] == 1:
        sizes0 = sizes_c[0, :n].T.contiguous()           # (B, n)
    else:
        sizes0 = sizes_c[:, :n].gather(
            0, cls[types0].T[None])[0].T.contiguous()
    for i in range(n):
        t = types0[:, i]
        j = route_one(counts, backlog, t, rd[i])
        if order == "PRIO":             # an idle column starts it at once
            idle = counts.sum(dim=1).gather(1, j[:, None])[:, 0] == 0
            run_pid[rows_b[idle], j[idle]] = i
        bump(counts, t, j, 1)
        backlog[rows_b, j] += sizes0[:, i]
        proc[:, i] = j
    types = types0.clone()
    need = sizes0 / mu_flat.gather(1, types * l + proc)
    remaining = need.clone()
    size_left = sizes0.clone()
    entry = torch.zeros((B, n), dtype=torch.float32, device=dev)
    stamp = idx_n.expand(B, n).clone()
    now = torch.zeros(B, dtype=torch.float32, device=dev)
    t_start = torch.zeros(B, dtype=torch.float32, device=dev)
    resp_c = torch.zeros((B, C), dtype=torch.float32, device=dev)
    energy_c = torch.zeros((B, C), dtype=torch.float32, device=dev)
    meas_c = torch.zeros((B, C), dtype=torch.float32, device=dev)
    sum_power = torch.zeros(B, dtype=torch.float32, device=dev)
    occ = torch.zeros((B, k, l), dtype=torch.float32, device=dev)

    for i in range(n_steps):
        mask = proc[:, :, None] == cols                  # (B, n, l)
        cnt = mask.sum(dim=1)                            # (B, l)
        cntf = cnt.to(torch.float32)
        if order == "PS":
            cnt_p = cntf.gather(1, proc)                 # (B, n)
            rem_col = torch.where(mask, remaining[:, :, None], inf)
            dtj = torch.where(cnt > 0, rem_col.amin(dim=1) * cntf, inf)
            # occupancy-weighted draw: each resident burns P / c_j
            pw = (P_flat.gather(1, types * l + proc) / cnt_p).sum(dim=1)
        else:
            if order == "PRIO":         # the sticky running task
                head = run_pid.clamp(min=0)
            else:                       # FCFS: the oldest resident
                stamp_col = torch.where(mask, stamp[:, :, None], _BIG_STAMP)
                head = torch.argmin(stamp_col, dim=1)    # (B, l)
            dtj = torch.where(cnt > 0, remaining.gather(1, head), inf)
            # heads run alone at full rate; idle columns draw nothing
            pw = torch.where(cnt > 0, P_flat.gather(
                1, types.gather(1, head) * l + cols), 0.0).sum(dim=1)
        j_star = torch.argmin(dtj, dim=1)
        dt = dtj.gather(1, j_star[:, None])[:, 0]
        now = now + dt
        if order == "PS":
            dep = dt[:, None] / cnt_p
            remaining = remaining - dep
            pid = torch.argmin(torch.where(proc == j_star[:, None],
                                           remaining, inf), dim=1)
        else:
            is_head = idx_n == head.gather(1, proc)
            dep = torch.where(is_head, dt[:, None], 0.0)
            remaining = remaining - dep
            pid = head.gather(1, j_star[:, None])[:, 0]
        # true remaining work depletes with service received (host compat
        # loop semantics: size_left -= (dep/need) * size_left)
        frac = torch.where(need > 0, dep / need, 1.0)
        size_left = torch.clamp(size_left - frac * size_left, min=0.0)

        pidc = pid[:, None]
        t = types.gather(1, pidc)[:, 0]
        if i >= warmup:
            occ += dt[:, None, None] * counts.to(torch.float32)
            c = cls[t][:, None]
            resp_c.scatter_add_(1, c, (now - entry.gather(1, pidc)[:, 0])
                                [:, None])
            energy_c.scatter_add_(1, c, (
                P_flat.gather(1, (t * l + j_star)[:, None])[:, 0]
                * need.gather(1, pidc)[:, 0])[:, None])
            meas_c.scatter_add_(1, c, torch.ones_like(dt)[:, None])
            sum_power += dt * pw
        if i == warmup - 1:
            t_start = now.clone()
        bump(counts, t, j_star, -1)
        if order == "PRIO":
            # next head: the oldest waiting task (smallest stamp) of the
            # best class present on j_star, the completed task excluded
            waiting = (proc == j_star[:, None]) & (idx_n != pidc)
            pkey = cls[types] * stamp_cap + stamp
            nxt = torch.argmin(torch.where(waiting, pkey, _BIG_STAMP), dim=1)
            run_pid.scatter_(1, j_star[:, None], torch.where(
                waiting.any(dim=1), nxt, -1)[:, None])

        # closed system: the program's next task routes immediately (its
        # type re-drawn under type_mix); the completed task is gone from
        # the LB backlog
        if u_type is not None:
            t = torch.clamp(torch.searchsorted(
                mix_cum, u_type[i][:, None], right=True)[:, 0], max=k - 1)
            types.scatter_(1, pidc, t[:, None])
        size_left.scatter_(1, pidc, 0.0)
        backlog = torch.where(mask, size_left[:, :, None], 0.0).sum(dim=1)
        j_new = route_one(counts, backlog, t, rd[n + i])
        bump(counts, t, j_new, 1)
        s_new = sizes_for(t, n + i)
        sn = s_new / mu_flat.gather(1, (t * l + j_new)[:, None])[:, 0]
        remaining.scatter_(1, pidc, sn[:, None])
        need.scatter_(1, pidc, sn[:, None])
        size_left.scatter_(1, pidc, s_new[:, None])
        entry.scatter_(1, pidc, now[:, None])
        proc.scatter_(1, pidc, j_new[:, None])
        stamp.scatter_(1, pidc, n + i)
        if order == "PRIO":             # an idle column starts it at once
            cur = run_pid.gather(1, j_new[:, None])
            run_pid.scatter_(1, j_new[:, None],
                             torch.where(cur < 0, pidc, cur))
    return now, t_start, resp_c, energy_c, meas_c, sum_power, occ


def simulate_batch(mu, targets, types0, seeds, *, distribution, order="PS",
                   n_completions, warmup_completions,
                   power: PowerModel = PROPORTIONAL_POWER, modes=None,
                   class_of_type=None, class_distributions=None,
                   type_mix=None, device=None):
    """Simulate B closed networks in one batched run on the device.

    mu: (k, l) shared or (B, k, l) per-point; targets: (B, k, l) pinned
    placements; types0: (B, n) initial program types; seeds: (B,) ints;
    modes: (B,) route modes (MODE_DEFICIT default, MODE_JSQ, MODE_LB,
    MODE_RD, MODE_BF — baseline points ignore their target rows).
    `class_of_type` ((k,) type -> priority class, class 0 highest) selects
    the per-class metric split and the PRIO service order's class ranking;
    `class_distributions` (len C) gives per-class task sizes; `type_mix`
    ((k,) or (B, k) probabilities) re-draws each completed program's next
    type (piecewise-closed operation).
    Returns a dict of NumPy arrays: throughput/mean_response_time/
    mean_energy/edp/little_product/mean_power (B,), elapsed (B,),
    state_occupancy (B, k, l), and the per-class split class_throughput/
    class_response_time/class_energy (B, C) and class_occupancy (B, C, l);
    mean_power / throughput is the trajectory-measured E[E] (eq. 19)."""
    dev = resolve_device(device)
    targets = np.asarray(targets)
    B, k, l = targets.shape
    mu = np.asarray(mu, dtype=np.float64)
    mus = np.broadcast_to(mu, (B, k, l)) if mu.ndim == 2 else mu
    if mus.shape != (B, k, l):
        raise ValueError(f"mu must be (k, l) or (B, k, l); got {mu.shape}")
    types0 = np.asarray(types0, dtype=np.int64)
    if types0.ndim != 2 or types0.shape[0] != B:
        raise ValueError(f"types0 must be (B, n); got {types0.shape}")
    if len(seeds) != B:
        raise ValueError(f"need {B} seeds; got {len(seeds)}")
    if not 0 <= warmup_completions < n_completions:
        raise ValueError("need 0 <= warmup_completions < n_completions")
    if order not in ("PS", "FCFS", "PRIO"):
        raise ValueError(f"unknown order {order!r}: PS | FCFS | PRIO")
    modes = (np.zeros(B, dtype=np.int64) if modes is None
             else np.asarray(modes, dtype=np.int64))
    if modes.shape != (B,) or modes.min() < 0 or modes.max() > MODE_BF:
        raise ValueError(f"modes must be (B,) ints in [0, {MODE_BF}]")
    cls = (np.zeros(k, dtype=np.int64) if class_of_type is None
           else np.asarray(class_of_type, dtype=np.int64))
    if cls.shape != (k,) or cls.min() < 0:
        raise ValueError(f"class_of_type must be (k,) nonneg ints; got "
                         f"{class_of_type!r}")
    C = int(cls.max()) + 1
    if class_distributions is not None:
        if len(class_distributions) != C:
            raise ValueError(f"need {C} class_distributions; got "
                             f"{len(class_distributions)}")
        dists = tuple(class_distributions)
    else:
        dists = (distribution,)
    if mu.ndim == 2:                # shared mu: derive P/ranks once, tile
        P = np.broadcast_to(power.power_matrix(mu), (B, k, l))
        ranks = np.broadcast_to(_mu_tiebreak_ranks(mu), (B, k, l))
    else:
        P = np.stack([power.power_matrix(m) for m in mus])
        ranks = np.stack([_mu_tiebreak_ranks(m) for m in mus])
    n, n_steps = types0.shape[1], int(n_completions)
    warmup = int(warmup_completions)
    sizes_c, rd, u_type = _draws(seeds, n + n_steps, dists, l, dev,
                                 with_types=type_mix is not None)
    mix_cum = None
    if type_mix is not None:
        probs = np.broadcast_to(np.asarray(type_mix, dtype=np.float64),
                                (B, k))
        mix_cum = torch.as_tensor(np.cumsum(probs, axis=1)[:, :-1],
                                  dtype=torch.float32, device=dev)
        u_type = u_type[n:].contiguous()

    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)

    def i64(a):
        return torch.as_tensor(np.array(a, dtype=np.int64), device=dev)

    now, t_start, resp_c, energy_c, meas_c, sum_power, occ = \
        _simulate_fleet(f32(mus), f32(P), i64(targets), i64(ranks),
                        i64(types0), sizes_c, rd, u_type, mix_cum, i64(cls),
                        modes, order=order,
                        n_steps=n_steps, warmup=warmup)
    measured = float(n_steps - warmup)
    elapsed_t = now - t_start

    def host(x):
        return x.cpu().numpy().astype(np.float64)
    x = host(measured / elapsed_t)
    et = host(resp_c.sum(dim=1) / measured)
    ee = host(energy_c.sum(dim=1) / measured)
    occ = host(occ / elapsed_t[:, None, None])
    pw = host(sum_power / elapsed_t)
    elapsed = host(elapsed_t)
    meas_c, resp_c, energy_c = host(meas_c), host(resp_c), host(energy_c)
    if warmup == 0:
        occ = np.zeros_like(occ)    # host convention: warmup==0 tracks none
        pw = np.zeros_like(pw)      # mean_power follows the occ window
    with np.errstate(divide="ignore", invalid="ignore"):
        cls_rt = np.where(meas_c > 0, resp_c / np.maximum(meas_c, 1.0),
                          np.inf)
        cls_ee = np.where(meas_c > 0, energy_c / np.maximum(meas_c, 1.0),
                          np.inf)
    cls_occ = np.zeros((B, C, l))
    np.add.at(cls_occ, (slice(None), cls), occ)
    return {"throughput": x, "mean_response_time": et, "mean_energy": ee,
            "edp": ee * et, "little_product": x * et,
            "completed": np.full(B, n_steps - warmup), "elapsed": elapsed,
            "state_occupancy": occ, "mean_power": pw,
            "class_throughput": meas_c / elapsed[:, None],
            "class_response_time": cls_rt, "class_energy": cls_ee,
            "class_occupancy": cls_occ, "device": str(dev)}


def _check_closed(cfg, entry: str) -> None:
    """Refuse what the closed device engine does not run: fault scenarios
    (not ported) and open traffic (its own engine)."""
    if getattr(cfg, "faults", None) is not None:
        raise NotImplementedError(
            "the closed device engine takes no fault inputs yet (ROADMAP "
            "A4, item 1); run faults on the host core "
            "(ClosedNetworkSimulator) or in open mode (simulate_open_batch)")
    if getattr(cfg, "traffic", None) is not None:
        raise ValueError(f"open-traffic configs {entry} via "
                         "repro_torch.traffic.simulate_open_batch")


def _types0_for(mix: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(len(mix)), mix).astype(np.int64)


def _expected_mix(probs: np.ndarray, n: int) -> np.ndarray:
    """Largest-remainder rounding of n * probs to an integer mix summing to
    n — the pinned mix the engine solves the deficit target at."""
    raw = np.asarray(probs, dtype=np.float64) * n
    return round_largest_remainder(raw[None, :], np.array([n]))[0]


def _cfg_mix_and_types0(cfg, seed: int | None = None):
    """(pinned mix, initial types) for a config: fixed populations repeat
    the per-type counts; `type_mix` configs draw the initial types exactly
    like the host core (same NumPy generator, same first draw) and pin the
    EXPECTED mix for target solving."""
    base = np.asarray(cfg.n_programs_per_type, dtype=np.int64)
    if cfg.type_mix is None:
        return base, _types0_for(base)
    n = int(base.sum())
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    t0 = rng.choice(len(base), size=n, p=cfg.type_mix).astype(np.int64)
    return _expected_mix(cfg.type_mix, n), t0


def _device_route_mode(pol) -> int:
    """Route mode for a policy, or raise for host-only SystemView policies."""
    if pol.needs_target:
        return MODE_DEFICIT
    mode = _BASELINE_MODES.get(pol.key)
    if mode is None:
        raise ValueError(
            f"{pol.name} routes on a SystemView with no device variant "
            "(only LB/JSQ/RD/BF have one)")
    return mode


def _policy_of(spec):
    """A Policy from a registry name, a Policy, or a SchedulerCore."""
    return get_policy(getattr(spec, "policy", spec))


def _metrics_row(out: dict, i: int) -> SimMetrics:
    return SimMetrics(
        meta=run_meta(out["device"]),
        throughput=float(out["throughput"][i]),
        mean_response_time=float(out["mean_response_time"][i]),
        mean_energy=float(out["mean_energy"][i]),
        edp=float(out["edp"][i]),
        little_product=float(out["little_product"][i]),
        completed=int(out["completed"][i]),
        elapsed=float(out["elapsed"][i]),
        state_occupancy=out["state_occupancy"][i],
        mean_power=float(out["mean_power"][i]),
        class_throughput=out["class_throughput"][i],
        class_response_time=out["class_response_time"][i],
        class_energy=out["class_energy"][i],
        class_occupancy=out["class_occupancy"][i])


def _run_cfg(cfg, mus, tgts, types_b, seed_b, modes, dev):
    return simulate_batch(
        mus, np.stack(tgts), np.stack(types_b), seed_b,
        distribution=cfg.distribution, order=cfg.order,
        n_completions=cfg.n_completions,
        warmup_completions=cfg.warmup_completions, power=cfg.power,
        modes=np.asarray(modes), class_of_type=cfg.class_of_type,
        class_distributions=cfg.class_distributions, type_mix=cfg.type_mix,
        device=dev)


def simulate_policy(cfg, policy, device=None) -> SimMetrics:
    """One closed-network run of `cfg` under `policy` (a registry name,
    Policy or SchedulerCore) on the device: the target is solved on the
    host by the policy itself, as the reference's single-config path does.
    `type_mix` configs pin the deficit target at the expected mix and
    re-draw types in the loop. Open-traffic configs (`cfg.traffic`, with or
    without `cfg.faults`) run on the open engine (`simulate_open_policy`).
    """
    dev = resolve_device(device)
    pol = _policy_of(policy)
    if getattr(cfg, "traffic", None) is not None:
        from repro_torch.traffic.engine_torch import simulate_open_policy
        return simulate_open_policy(cfg, pol, device=dev)
    _check_closed(cfg, "run")
    mu = np.asarray(cfg.mu, dtype=np.float64)
    mix, t0 = _cfg_mix_and_types0(cfg)
    mode = _device_route_mode(pol)
    target = (np.asarray(pol.solve_target(mu, mix)) if mode == MODE_DEFICIT
              else np.zeros(mu.shape, np.int64))
    out = _run_cfg(cfg, mu, [target], [t0], [int(cfg.seed)], [mode], dev)
    return _metrics_row(out, 0)


def sweep(cfg, policy, *, mixes=None, seeds=None, mus=None, device=None):
    """Batched what-if sweep: one simulation over the (mu, mix, seed) grid.

    `mixes` (M, k) must all sum to the same N (the closed population);
    `mus` (G, k, l) batches affinity matrices; `seeds` (S,) replicates.
    Targets re-solve per (mu, mix) — the whole grid in one
    `solve_targets_grid_torch` call when the policy batches on the device.
    LB/JSQ/RD/BF run as baseline modes (their target rows are zeros).
    `type_mix` configs run natively (expected-mix targets, re-draws in the
    loop) but cannot combine with a `mixes` grid. Returns (grid, results):
    `grid` lists (mu_index, mix, seed) per point and `results` is the
    `simulate_batch` dict over the B = G*M*S points."""
    dev = resolve_device(device)
    _check_closed(cfg, "sweep")
    pol = _policy_of(policy)
    mode = _device_route_mode(pol)
    if cfg.type_mix is not None and mixes is not None:
        raise ValueError("a mixes grid needs fixed populations; this config "
                         "re-draws types from type_mix")
    base_mix, _ = _cfg_mix_and_types0(cfg)
    mixes = base_mix[None] if mixes is None else np.asarray(mixes, np.int64)
    if (mixes.sum(axis=1) != base_mix.sum()).any():
        raise ValueError("all mixes must keep the closed population "
                         f"N={base_mix.sum()}")
    seeds = np.asarray([cfg.seed] if seeds is None else seeds, dtype=np.int64)
    mus = (np.asarray(cfg.mu, np.float64)[None] if mus is None
           else np.asarray(mus, np.float64))
    if mode != MODE_DEFICIT:
        per_mu_targets = np.zeros(
            (len(mus), len(mixes)) + mus.shape[1:], dtype=np.int64)
    elif pol.supports_torch_batch:
        per_mu_targets, _, _ = solve_targets_grid_torch(
            np.stack([pol.device_mu(m) for m in mus]), mixes,
            objective=pol.torch_objective, power=pol.power,
            P=physical_power_matrix(pol, mus), device=dev)
    else:
        per_mu_targets = np.stack([
            np.stack([np.asarray(pol.solve_target(m, mix)) for mix in mixes])
            for m in mus])
    grid, mu_b, tgt_b, types_b, seed_b = [], [], [], [], []
    for gi, (m, targets) in enumerate(zip(mus, per_mu_targets)):
        for mix, target in zip(mixes, targets):
            for s in seeds:
                grid.append((gi, mix.copy(), int(s)))
                mu_b.append(m)
                tgt_b.append(target)
                types_b.append(_cfg_mix_and_types0(cfg, seed=int(s))[1]
                               if cfg.type_mix is not None
                               else _types0_for(mix))
                seed_b.append(int(s))
    results = _run_cfg(cfg, mus[0] if len(mus) == 1 else np.stack(mu_b),
                       tgt_b, types_b, seed_b, [mode] * len(grid), dev)
    return grid, results


def compare_policies(cfg, policies, seeds=None, device=None) -> dict:
    """Fig. 9-style policy comparison as ONE batched simulation.

    Every target policy (deficit routing toward its host-solved N*) and the
    LB/JSQ/RD/BF baselines simulate side by side; SystemView choosers
    without a device variant raise. Returns {display name: SimMetrics} — or
    {name: [SimMetrics per seed]} when `seeds` is given. Duplicate display
    names disambiguate as "Opt", "Opt#2", ..."""
    dev = resolve_device(device)
    _check_closed(cfg, "compare")
    mu = np.asarray(cfg.mu, dtype=np.float64)
    mix, _ = _cfg_mix_and_types0(cfg)
    single = seeds is None
    seed_list = [int(cfg.seed)] if single else [int(s) for s in seeds]
    names, tgts, modes = [], [], []
    for pol in (_policy_of(p) for p in policies):
        key, n = pol.name, 2
        while key in names:
            key = f"{pol.name}#{n}"
            n += 1
        names.append(key)
        mode = _device_route_mode(pol)
        modes.append(mode)
        tgts.append(np.asarray(pol.solve_target(mu, mix))
                    if mode == MODE_DEFICIT else np.zeros(mu.shape, np.int64))
    S = len(seed_list)
    types_b = [_cfg_mix_and_types0(cfg, seed=s)[1] for s in seed_list]
    out = _run_cfg(cfg, mu, [t for t in tgts for _ in range(S)],
                   types_b * len(names), seed_list * len(names),
                   np.repeat(modes, S), dev)
    rows = {name: [_metrics_row(out, i * S + s) for s in range(S)]
            for i, name in enumerate(names)}
    return {k: v[0] for k, v in rows.items()} if single else rows
