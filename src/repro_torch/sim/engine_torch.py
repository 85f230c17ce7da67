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
    through `simulate_policy`).

Fault scenarios (`faults=`, a closed-mode `repro_torch.faults.FaultBatch`)
add per-segment rate multipliers and routing targets (every route mode
masked to the pools that are up), per-attempt transient failures, the
checkpoint-restart model and crash re-execution; the run freezes after
`n_completions` successes within `n_completions + extra_steps` steps.
Their draws — transient failures, RD among the pools that are up, and
the task sizes of the extra steps — come from a second generator per
point, so a scenario that never fires leaves the run bit for bit as it
was. `telemetry_bins > 0` adds the binned integrals of
`repro_torch.obs.telemetry` over a caller-given horizon. Without faults or
telemetry those stanzas are skipped entirely.

`compare_policies` runs a Fig. 9-style policy comparison — every target
policy plus the baselines — as one batched simulation.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.affinity import PowerModel, PROPORTIONAL_POWER
from repro_torch.core.slsqp import round_largest_remainder
from repro_torch.obs.meta import run_meta
from repro_torch.sched.api import (_mu_tiebreak_ranks,
                                   deficit_route_masked_torch,
                                   deficit_route_torch,
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


def _fault_draws(seeds, n_extra: int, n_steps: int, distributions, l: int,
                 dev):
    """The fault stanza's own per-point streams, from a second generator
    seeded from (seed, 3): sizes (D, n_extra, B) and RD columns
    (n_extra, B) for the steps past the fault-free budget, and (n_steps,
    B, 2) uniforms per step — transient failure, RD among the pools that
    are up. The fault-free streams (`_draws`) are left as they were."""
    us = []
    for s in seeds:
        g = torch.Generator(device=dev).manual_seed(int(
            np.random.SeedSequence([int(s), 3]).generate_state(1)[0]))
        us.append(torch.rand((n_extra + n_steps, 3), device=dev,
                             generator=g))
    u = torch.stack(us, dim=1)                           # (E + T, B, 3)
    ue = u[:n_extra]
    sizes = torch.stack([
        _sizes_from_uniforms(d, ue[..., 0], ue[..., 1]).to(torch.float32)
        for d in distributions])
    rd = torch.clamp((ue[..., 2] * l).to(torch.int64), max=l - 1)
    return sizes, rd, u[n_extra:, :, :2].contiguous()


def route_modes(present, modes, mu, target, rank, counts, backlog, t, *,
                rd=None, u=None, avail=None, tgt=None):
    """One route decision per point under its mode (`modes` (B,), the
    modes in the batch sorted in `present`): deficit toward `target`, JSQ,
    LB on `backlog`, RD, BF. With `avail` (B, l) every mode is masked to
    the pools that are up, deficit routing toward `tgt` (the segment's
    targets). RD takes the columns `rd` (B,), or floor(u * l) from
    uniforms `u` (B,); masked, the floor(u * n_up)-th pool that is up,
    which is the unmasked column while every pool is up."""
    B, k, l = counts.shape
    cand = {}
    if MODE_DEFICIT in present:
        cand[MODE_DEFICIT] = (
            deficit_route_torch(target, rank, counts, t) if avail is None
            else deficit_route_masked_torch(tgt, rank, counts, t, avail))
    if MODE_JSQ in present:
        q = counts.sum(dim=1)
        cand[MODE_JSQ] = torch.argmin(
            q if avail is None else torch.where(avail, q, 2**30), dim=1)
    if MODE_LB in present:
        cand[MODE_LB] = torch.argmin(
            backlog if avail is None
            else torch.where(avail, backlog, torch.inf), dim=1)
    if MODE_BF in present:
        m = mu.gather(1, t[:, None, None].expand(B, 1, l))[:, 0]
        cand[MODE_BF] = torch.argmax(
            m if avail is None else torch.where(avail, m, -torch.inf), dim=1)
    if MODE_RD in present:
        j = (rd if rd is not None
             else torch.clamp((u * l).to(torch.int64), max=l - 1))
        if avail is not None:
            na = avail.sum(dim=1)
            r = torch.minimum((u * torch.clamp(na, min=1)).to(torch.int64),
                              torch.clamp(na - 1, min=0))
            # the r-th pool that is up (pool l - 1 when none is: the
            # caller then admits nothing)
            up = torch.clamp((torch.cumsum(avail.to(torch.int64), dim=1)
                              < (r + 1)[:, None]).sum(dim=1), max=l - 1)
            j = torch.where(avail.all(dim=1), j, up)
        cand[MODE_RD] = j
    j = cand[present[0]]
    for m in present[1:]:
        j = torch.where(modes == m, cand[m], j)
    return j


def _simulate_fleet(mu, P, target, rank, types0, sizes_c, rd, u_type,
                    mix_cum, cls, modes_np, fault=None, tel=None, *, order,
                    n_steps, warmup, n_target):
    """The event loop. mu/P (B, k, l) float32, target/rank (B, k, l) int64,
    types0 (B, n) int64, sizes_c (D, n + n_steps, B) float32 with D = 1
    (one distribution) or C (one per class), rd (n + n_steps, B), u_type
    (n_steps, B) uniforms and mix_cum (B, k - 1) cumulative type
    probabilities for re-draws (both None: no re-draw), cls (k,) int64
    type -> class, modes_np (B,) host ints. `fault`: None or a dict of the
    FaultBatch tensors and the per-step uniforms "u" (n_steps, B, 2); the
    run then freezes after n_target successes. `tel`: None or {"bins",
    "horizon" (B,)}. Returns a dict of the per-point accumulators as
    device tensors."""
    B, k, l = mu.shape
    n = types0.shape[1]
    C = int(cls.max()) + 1
    dev = mu.device
    has_faults = fault is not None
    nbt = 0 if tel is None else int(tel["bins"])
    cols = torch.arange(l, device=dev)
    idx_n = torch.arange(n, device=dev)[None, :]
    rows_b = torch.arange(B, device=dev)
    mu_flat, P_flat = mu.reshape(B, k * l), P.reshape(B, k * l)
    modes = torch.as_tensor(modes_np, device=dev)
    present = sorted(set(int(m) for m in modes_np))
    inf = torch.tensor(torch.inf, device=dev)
    stamp_cap = n + n_steps + 2         # PRIO key stride > any stamp

    def route_one(counts, backlog, t, rd_j, u=None, avail=None, tgt=None):
        return route_modes(present, modes, mu, target, rank, counts,
                           backlog, t, rd=rd_j, u=u, avail=avail, tgt=tgt)

    def bump(counts, t, j, delta):
        counts.view(B, k * l).scatter_add_(
            1, (t * l + j)[:, None],
            delta[:, None] if torch.is_tensor(delta) else
            torch.full((B, 1), delta, dtype=counts.dtype, device=dev))

    def put(x, pidc, cond, val):
        """x[b, pid[b]] = val[b] where cond[b], in place."""
        x.scatter_(1, pidc, torch.where(cond, val, x.gather(1, pidc)[:, 0])
                   [:, None])

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
    if has_faults:
        from repro_torch.faults.device import ckpt_preserved, segment_rows
        f32z = torch.zeros(B, dtype=torch.float32, device=dev)
        sp = torch.zeros(B, dtype=torch.int64, device=dev)
        ncomp = torch.zeros(B, dtype=torch.int64, device=dev)
        fails_used = torch.zeros((B, n), dtype=torch.int64, device=dev)
        size0 = sizes0.clone()
        wasted, failcnt = f32z.clone(), f32z.clone()
        rrp_s, rrp_n, rr_s, rr_n = (f32z.clone() for _ in range(4))
        topo = torch.zeros(B, dtype=torch.int64, device=dev)
        period, c_age, overhead = (fault["period"], fault["age"],
                                   fault["overhead"])
        p_fin = torch.where(torch.isfinite(period), period, 0.0)
        n_faults = fault["times"].shape[1]
    if nbt:
        from repro_torch.obs.telemetry import telemetry_bin_weights
        tel_h = tel["horizon"]
        binw = torch.clamp(tel_h, min=1e-30) / nbt
        bins = torch.arange(nbt, device=dev)[None, :]
        occ_t = torch.zeros((B, nbt, l), dtype=torch.float32, device=dev)
        bl_t = torch.zeros((B, nbt, l), dtype=torch.float32, device=dev)
        pw_t = torch.zeros((B, nbt), dtype=torch.float32, device=dev)

    for i in range(n_steps):
        if has_faults:
            # past the fault-free budget, stop once every point is done
            if i >= n_target and (i - n_target) % 256 == 0 \
                    and not bool((ncomp < n_target).any()):
                break
            sc = segment_rows(fault["scale"], sp)        # (B, l)
            avail = sc > 0.0
            sc_safe = torch.where(avail, sc, 1.0)
            tgt_cur = segment_rows(fault["seg"], sp)     # (B, k, l)
            alive = ncomp < n_target                     # frozen when done
            sc_p = sc.gather(1, proc)                    # (B, n)
        mask = proc[:, :, None] == cols                  # (B, n, l)
        cnt = mask.sum(dim=1)                            # (B, l)
        cntf = cnt.to(torch.float32)
        if order == "PS":
            cnt_p = cntf.gather(1, proc)                 # (B, n)
            rem_col = torch.where(mask, remaining[:, :, None], inf)
            if has_faults:
                dtj = torch.where((cnt > 0) & avail,
                                  rem_col.amin(dim=1) * cntf / sc_safe, inf)
                pw = (P_flat.gather(1, types * l + proc) * sc_p
                      / cnt_p).sum(dim=1)
            else:
                dtj = torch.where(cnt > 0, rem_col.amin(dim=1) * cntf, inf)
                # occupancy-weighted draw: each resident burns P / c_j
                pw = (P_flat.gather(1, types * l + proc) / cnt_p).sum(dim=1)
        else:
            if order == "PRIO":         # the sticky running task
                head = run_pid.clamp(min=0)
            else:                       # FCFS: the oldest resident
                stamp_col = torch.where(mask, stamp[:, :, None], _BIG_STAMP)
                head = torch.argmin(stamp_col, dim=1)    # (B, l)
            p_h = P_flat.gather(1, types.gather(1, head) * l + cols)
            if has_faults:
                dtj = torch.where((cnt > 0) & avail,
                                  remaining.gather(1, head) / sc_safe, inf)
                pw = torch.where(cnt > 0, p_h * sc, 0.0).sum(dim=1)
            else:
                dtj = torch.where(cnt > 0, remaining.gather(1, head), inf)
                # heads run alone at full rate; idle columns draw nothing
                pw = torch.where(cnt > 0, p_h, 0.0).sum(dim=1)
        j_star = torch.argmin(dtj, dim=1)
        dt = dtj.gather(1, j_star[:, None])[:, 0]
        if has_faults:
            if n_faults > 0:
                tf = torch.where(sp < n_faults, fault["times"].gather(
                    1, torch.clamp(sp, max=n_faults - 1)[:, None])[:, 0],
                    inf)
            else:
                tf = torch.full_like(now, torch.inf)
            do_fault = alive & torch.isfinite(tf) & (tf - now <= dt)
            do_comp = alive & ~do_fault & torch.isfinite(dt)
            dt = torch.where(do_fault, tf - now,
                             torch.where(do_comp, dt, 0.0))
        if nbt:
            # the pre-event state over [now, now + dt) clipped at the
            # horizon, charged to the bin holding the interval start
            wb = telemetry_bin_weights(now, torch.clamp(
                torch.minimum(now + dt, tel_h) - now, min=0.0), binw, bins)
            bl_pre = torch.where(mask, size_left[:, :, None],
                                 0.0).sum(dim=1)
            occ_t += wb[:, :, None] * cntf[:, None]
            bl_t += wb[:, :, None] * bl_pre[:, None]
            pw_t += wb * pw[:, None]
        now = now + dt
        if order == "PS":
            dep = (dt[:, None] * sc_p if has_faults else dt[:, None]) / cnt_p
            remaining = remaining - dep
            pid = torch.argmin(torch.where(proc == j_star[:, None],
                                           remaining, inf), dim=1)
        else:
            is_head = idx_n == head.gather(1, proc)
            dep = torch.where(is_head, dt[:, None] * sc_p if has_faults
                              else dt[:, None], 0.0)
            remaining = remaining - dep
            pid = head.gather(1, j_star[:, None])[:, 0]
        # true remaining work depletes with service received (host compat
        # loop semantics: size_left -= (dep/need) * size_left)
        frac = torch.where(need > 0, dep / need, 1.0)
        size_left = torch.clamp(size_left - frac * size_left, min=0.0)

        pidc = pid[:, None]
        t = types.gather(1, pidc)[:, 0]
        if has_faults:
            u_f = fault["u"][i]                          # (B, 2)
            fail_now = (do_comp & (u_f[:, 0] < fault["fail_p"])
                        & (fails_used.gather(1, pidc)[:, 0]
                           < fault["fail_cap"]))
            succ = do_comp & ~fail_now
            in_win = ncomp >= warmup
            win = succ & in_win
            dt_w = torch.where(in_win, dt, 0.0)
            occ += dt_w[:, None, None] * counts.to(torch.float32)
            c = cls[t][:, None]
            resp_c.scatter_add_(1, c, torch.where(
                win, now - entry.gather(1, pidc)[:, 0], 0.0)[:, None])
            energy_c.scatter_add_(1, c, torch.where(
                win, P_flat.gather(1, (t * l + j_star)[:, None])[:, 0]
                * need.gather(1, pidc)[:, 0], 0.0)[:, None])
            meas_c.scatter_add_(1, c, win.to(torch.float32)[:, None])
            sum_power += dt_w * pw
            t_start = torch.where(succ & (ncomp == warmup - 1), now, t_start)
        elif i >= warmup:
            occ += dt[:, None, None] * counts.to(torch.float32)
            c = cls[t][:, None]
            resp_c.scatter_add_(1, c, (now - entry.gather(1, pidc)[:, 0])
                                [:, None])
            energy_c.scatter_add_(1, c, (
                P_flat.gather(1, (t * l + j_star)[:, None])[:, 0]
                * need.gather(1, pidc)[:, 0])[:, None])
            meas_c.scatter_add_(1, c, torch.ones_like(dt)[:, None])
            sum_power += dt * pw
        if not has_faults and i == warmup - 1:
            t_start = now.clone()
        bump(counts, t, j_star, -succ.to(torch.int64) if has_faults else -1)
        if order == "PRIO":
            # next head: the oldest waiting task (smallest stamp) of the
            # best class present on j_star, the completed task excluded
            waiting = (proc == j_star[:, None]) & (idx_n != pidc)
            pkey = cls[types] * stamp_cap + stamp
            nxt = torch.argmin(torch.where(waiting, pkey, _BIG_STAMP), dim=1)
            new_head = torch.where(waiting.any(dim=1), nxt, -1)
            if has_faults:
                put(run_pid, j_star[:, None], succ, new_head)
            else:
                run_pid.scatter_(1, j_star[:, None], new_head[:, None])
        if has_faults:
            # transient failure: the attempt ran its full service and is
            # rewound to its last checkpoint, plus the restart overhead
            done_f = need.gather(1, pidc)[:, 0]
            pres_f = ckpt_preserved(done_f, period, c_age, p_fin)
            newrem_f = done_f - pres_f + overhead
            fw = fail_now & in_win
            wasted += torch.where(fw, done_f - pres_f, 0.0)
            failcnt += fw.to(torch.float32)
            oh_pid = idx_n == pidc                       # (B, n)
            oh_f = oh_pid & fail_now[:, None]
            fails_used = fails_used + oh_f.to(torch.int64)
            left_f = size0.gather(1, pidc)[:, 0] * torch.clamp(
                newrem_f / torch.clamp(done_f, min=1e-30), 0.0, 1.0)
            remaining = torch.where(oh_f, newrem_f[:, None], remaining)
            size_left = torch.where(oh_f, left_f[:, None], size_left)
            # re-route latency: crash -> next successful completion
            flush = succ & (rrp_n > 0)
            rr_s += torch.where(flush, now * rrp_n - rrp_s, 0.0)
            rr_n += torch.where(flush, rrp_n, 0.0)
            rrp_s = torch.where(flush, 0.0, rrp_s)
            rrp_n = torch.where(flush, 0.0, rrp_n)
            # fault breakpoint: the next segment; tasks on a pool that
            # crashes rewind to their last checkpoint
            sp_new = sp + do_fault.to(torch.int64)
            crash_col = (do_fault[:, None] & (sc > 0.0)
                         & (segment_rows(fault["scale"], sp_new) <= 0.0))
            hit = crash_col.gather(1, proc)
            done_t = torch.clamp(need - remaining, min=0.0)
            pres_t = ckpt_preserved(done_t, period[:, None], c_age[:, None],
                                    p_fin[:, None])
            newrem_t = need - pres_t + overhead[:, None]
            wasted += torch.where(in_win, torch.where(
                hit, done_t - pres_t, 0.0).sum(dim=1), 0.0)
            remaining = torch.where(hit, newrem_t, remaining)
            size_left = torch.where(hit, size0 * torch.clamp(
                newrem_t / torch.clamp(need, min=1e-30), 0.0, 1.0),
                size_left)
            any_crash = do_fault & crash_col.any(dim=1)
            topo += any_crash.to(torch.int64)
            rrp_s = rrp_s + torch.where(any_crash, now, 0.0)
            rrp_n = rrp_n + any_crash.to(torch.float32)
            sp = sp_new

            # the program's next task routes at once among the pools that
            # are up, and only after a success
            oh_s = oh_pid & succ[:, None]
            size_left = torch.where(oh_s, 0.0, size_left)
            backlog = torch.where(mask, size_left[:, :, None],
                                  0.0).sum(dim=1)
            j_new = route_one(counts, backlog, t, rd[n + i], u=u_f[:, 1],
                              avail=avail, tgt=tgt_cur)
            bump(counts, t, j_new, succ.to(torch.int64))
            s_new = sizes_for(t, n + i)[:, None]
            sn = s_new / mu_flat.gather(1, (t * l + j_new)[:, None])
            remaining = torch.where(oh_s, sn, remaining)
            need = torch.where(oh_s, sn, need)
            size_left = torch.where(oh_s, s_new, size_left)
            size0 = torch.where(oh_s, s_new, size0)
            entry = torch.where(oh_s, now[:, None], entry)
            proc = torch.where(oh_s, j_new[:, None], proc)
            stamp = torch.where(oh_s, n + i, stamp)
            fails_used = torch.where(oh_s, 0, fails_used)
            if order == "PRIO":         # an idle column starts it at once
                cur = run_pid.gather(1, j_new[:, None])[:, 0]
                put(run_pid, j_new[:, None], succ & (cur < 0), pid)
            ncomp += succ.to(torch.int64)
            continue

        # (fault-free) closed system: the program's next task routes
        # immediately (its type re-drawn under type_mix); the completed
        # task is gone from the LB backlog
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
    out = dict(now=now, t_start=t_start, resp_c=resp_c, energy_c=energy_c,
               meas_c=meas_c, sum_power=sum_power, occ=occ)
    if has_faults:
        out.update(ncomp=ncomp, wasted=wasted, failcnt=failcnt, rr_s=rr_s,
                   rr_n=rr_n, topo=topo)
    if nbt:
        out.update(occ_t=occ_t, bl_t=bl_t, pw_t=pw_t)
    return out


def simulate_batch(mu, targets, types0, seeds, *, distribution, order="PS",
                   n_completions, warmup_completions,
                   power: PowerModel = PROPORTIONAL_POWER, modes=None,
                   class_of_type=None, class_distributions=None,
                   type_mix=None, faults=None, telemetry_bins=0,
                   telemetry_horizon=None, device=None):
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
    mean_power / throughput is the trajectory-measured E[E] (eq. 19).

    `faults` (a `repro_torch.faults.FaultBatch`, `build_fault_batch(...,
    mode="closed", n_completions=...)`) turns on the fault stanza:
    per-point crash/degrade schedules, per-attempt transient failures and
    the checkpoint-restart model; the result dict then gains goodput /
    wasted_work / failures / topology_events / reroute_latency rows
    (recovery_time is NaN in closed mode: the population is constant, so
    there is no pre-crash level to recover to). Incompatible with
    `type_mix`.

    `telemetry_bins` > 0 (with `telemetry_horizon`, a scalar or (B,)
    simulated-time horizon) adds res["telemetry"]: raw dt-weighted
    integrals of per-pool occupancy / backlog (B, nb, l), total power and
    hedges (B, nb; hedges are 0 in closed mode) over nb equal bins of
    [0, horizon], plus bin_width / horizon (B,)
    (`repro_torch.obs.telemetry_series` gives per-bin time averages)."""
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
    fault = None
    if faults is not None:
        if type_mix is not None:
            raise ValueError("faults + type_mix is not supported in closed "
                             "mode (the host oracle raises the same)")
        if faults.fail_prob is None or faults.fail_cap is None:
            raise ValueError("closed-mode FaultBatch required "
                             "(build_fault_batch(..., mode='closed'))")
        if faults.times.shape[0] != B or faults.scale.shape[2] != l:
            raise ValueError("FaultBatch batch/pool dims do not match")
    if telemetry_bins < 0:
        raise ValueError("telemetry_bins must be >= 0")
    tel = None
    if telemetry_bins:
        if telemetry_horizon is None:
            raise ValueError("telemetry_bins > 0 needs telemetry_horizon "
                             "(the closed engine has no arrival horizon)")
        tel_h = np.broadcast_to(
            np.asarray(telemetry_horizon, np.float64), (B,))
        if (tel_h <= 0).any():
            raise ValueError("telemetry_horizon must be > 0")
        tel = {"bins": int(telemetry_bins),
               "horizon": torch.as_tensor(np.array(tel_h, np.float32),
                                          device=dev)}
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

    n_target = n_steps
    if faults is not None:
        extra = int(faults.extra_steps)
        n_steps += extra
        sizes_x, rd_x, u_f = _fault_draws(seeds, extra, n_steps, dists, l,
                                          dev)
        sizes_c = torch.cat([sizes_c, sizes_x], dim=1)
        rd = torch.cat([rd, rd_x])
        fault = {"times": f32(faults.times), "scale": f32(faults.scale),
                 "seg": i64(faults.seg_targets), "u": u_f,
                 "period": f32(faults.ckpt_period),
                 "age": f32(faults.ckpt_age if faults.ckpt_age is not None
                            else np.zeros(B)),
                 "overhead": f32(faults.restart_overhead),
                 "fail_p": f32(faults.fail_prob),
                 "fail_cap": i64(faults.fail_cap)}
    res = _simulate_fleet(f32(mus), f32(P), i64(targets), i64(ranks),
                          i64(types0), sizes_c, rd, u_type, mix_cum,
                          i64(cls), modes, fault, tel, order=order,
                          n_steps=n_steps, warmup=warmup, n_target=n_target)
    now, t_start, resp_c, energy_c, meas_c, sum_power, occ = (
        res[key] for key in ("now", "t_start", "resp_c", "energy_c",
                             "meas_c", "sum_power", "occ"))
    # every point measures n_completions - warmup, unless a fault run used
    # up its step budget first: then each point counts its own. (One count
    # for all keeps the fault-free arithmetic: the card divides a tensor by
    # a Python float as a product with its reciprocal.)
    measured = float(n_target - warmup)
    if fault is not None and not bool((res["ncomp"] >= n_target).all()):
        measured = torch.clamp(res["ncomp"] - warmup,
                               min=0).to(torch.float32)
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
    out = {"throughput": x, "mean_response_time": et, "mean_energy": ee,
           "edp": ee * et, "little_product": x * et,
           "completed": (meas_c.sum(axis=1).astype(np.int64)
                         if fault is not None
                         else np.full(B, n_target - warmup)),
           "elapsed": elapsed, "state_occupancy": occ, "mean_power": pw,
           "class_throughput": meas_c / elapsed[:, None],
           "class_response_time": cls_rt, "class_energy": cls_ee,
           "class_occupancy": cls_occ, "device": str(dev)}
    if fault is not None:
        wasted, failcnt, rr_s, rr_n, topo = (
            host(res[key]) for key in ("wasted", "failcnt", "rr_s", "rr_n",
                                       "topo"))
        out["goodput"] = x
        out["wasted_work"] = wasted / np.maximum(elapsed, 1e-12)
        out["failures"] = failcnt.astype(np.int64)
        out["topology_events"] = topo.astype(np.int64)
        out["reroute_latency"] = np.where(
            rr_n > 0, rr_s / np.maximum(rr_n, 1.0), np.nan)
        out["recovery_time"] = np.full(B, np.nan)
    if tel is not None:
        out["telemetry"] = {
            "occupancy": host(res["occ_t"]), "backlog": host(res["bl_t"]),
            "power": host(res["pw_t"]), "hedges": np.zeros((B, tel["bins"])),
            "horizon": tel_h.astype(np.float64),
            "bin_width": tel_h / tel["bins"]}
    return out


def _check_closed(cfg, entry: str) -> None:
    """Refuse open traffic: it runs on its own engine."""
    if getattr(cfg, "traffic", None) is not None:
        raise ValueError(f"open-traffic configs {entry} via "
                         "repro_torch.traffic.simulate_open_batch")


def _closed_faults(cfg, policies, mus, targets, mixes, repeat: int, dev):
    """The closed-mode FaultBatch of `cfg.faults` for points with these
    policies, affinities (G, k, l), targets (G, k, l) and mixes (G, k),
    each row repeated `repeat` times (one per seed; the schedule and the
    segment targets do not depend on the seed). None without faults or for
    a scenario that is null. Refreshed segment targets are one
    `segment_targets` grid solve per row, on `dev`."""
    sc = getattr(cfg, "faults", None)
    if sc is None or sc.is_null:
        return None
    from repro_torch.faults.device import build_fault_batch
    fb = build_fault_batch(
        [sc] * len(targets), mus, np.asarray(targets), seeds=cfg.seed,
        mode="closed", policies=list(policies), mixes=np.asarray(mixes),
        n_completions=cfg.n_completions, device=dev)
    if repeat == 1:
        return fb
    return dataclasses.replace(fb, **{
        f.name: np.repeat(getattr(fb, f.name), repeat, axis=0)
        for f in dataclasses.fields(fb)
        if isinstance(getattr(fb, f.name), np.ndarray)})


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


def fault_fields(out: dict, i: int) -> dict:
    """The fault rows of an engine result at point i, as SimMetrics
    keyword arguments (none when the run had no faults)."""
    if "goodput" not in out:
        return {}
    return {"goodput": float(out["goodput"][i]),
            "wasted_work": float(out["wasted_work"][i]),
            "failures": int(out["failures"][i]),
            "topology_events": int(out["topology_events"][i]),
            "reroute_latency": float(out["reroute_latency"][i]),
            "recovery_time": float(out["recovery_time"][i])}


def row_telemetry(out: dict, i: int) -> dict | None:
    """Point i of an engine result's telemetry block (None when off)."""
    tel = out.get("telemetry")
    return None if tel is None else {n: v[i] for n, v in tel.items()}


def _metrics_row(out: dict, i: int) -> SimMetrics:
    return SimMetrics(
        meta=run_meta(out["device"]), telemetry=row_telemetry(out, i),
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
        class_occupancy=out["class_occupancy"][i], **fault_fields(out, i))


def _run_cfg(cfg, mus, tgts, types_b, seed_b, modes, dev, faults=None):
    return simulate_batch(
        mus, np.stack(tgts), np.stack(types_b), seed_b,
        distribution=cfg.distribution, order=cfg.order,
        n_completions=cfg.n_completions,
        warmup_completions=cfg.warmup_completions, power=cfg.power,
        modes=np.asarray(modes), class_of_type=cfg.class_of_type,
        class_distributions=cfg.class_distributions, type_mix=cfg.type_mix,
        faults=faults, device=dev)


def simulate_policy(cfg, policy, device=None) -> SimMetrics:
    """One closed-network run of `cfg` under `policy` (a registry name,
    Policy or SchedulerCore) on the device: the target is solved on the
    host by the policy itself, as the reference's single-config path does.
    `type_mix` configs pin the deficit target at the expected mix and
    re-draw types in the loop. `cfg.faults` runs the scenario in the loop
    (refreshed segment targets solved on the device). Open-traffic configs
    (`cfg.traffic`, with or without `cfg.faults`) run on the open engine
    (`simulate_open_policy`)."""
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
    faults = _closed_faults(cfg, [pol], mu[None], target[None], mix[None],
                            1, dev)
    out = _run_cfg(cfg, mu, [target], [t0], [int(cfg.seed)], [mode], dev,
                   faults)
    return _metrics_row(out, 0)


def sweep(cfg, policy, *, mixes=None, seeds=None, mus=None, device=None):
    """Batched what-if sweep: one simulation over the (mu, mix, seed) grid.

    `mixes` (M, k) must all sum to the same N (the closed population);
    `mus` (G, k, l) batches affinity matrices; `seeds` (S,) replicates.
    Targets re-solve per (mu, mix) — the whole grid in one
    `solve_targets_grid_torch` call when the policy batches on the device.
    LB/JSQ/RD/BF run as baseline modes (their target rows are zeros).
    `type_mix` configs run natively (expected-mix targets, re-draws in the
    loop) but cannot combine with a `mixes` grid. `cfg.faults` runs the
    scenario at every point. Returns (grid, results):
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
    S = len(seeds)
    faults = _closed_faults(cfg, [pol] * (len(grid) // S), mu_b[::S],
                            tgt_b[::S], [g[1] for g in grid[::S]], S, dev)
    results = _run_cfg(cfg, mus[0] if len(mus) == 1 else np.stack(mu_b),
                       tgt_b, types_b, seed_b, [mode] * len(grid), dev,
                       faults)
    return grid, results


def compare_policies(cfg, policies, seeds=None, device=None) -> dict:
    """Fig. 9-style policy comparison as ONE batched simulation.

    Every target policy (deficit routing toward its host-solved N*) and the
    LB/JSQ/RD/BF baselines simulate side by side; SystemView choosers
    without a device variant raise. `cfg.faults` runs the scenario at
    every point (each policy's refreshed segment targets one grid solve).
    Returns {display name: SimMetrics} — or {name: [SimMetrics per seed]}
    when `seeds` is given. Duplicate display names disambiguate as "Opt",
    "Opt#2", ..."""
    dev = resolve_device(device)
    _check_closed(cfg, "compare")
    mu = np.asarray(cfg.mu, dtype=np.float64)
    mix, _ = _cfg_mix_and_types0(cfg)
    single = seeds is None
    seed_list = [int(cfg.seed)] if single else [int(s) for s in seeds]
    names, tgts, modes, pols = [], [], [], []
    for pol in (_policy_of(p) for p in policies):
        pols.append(pol)
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
    faults = _closed_faults(cfg, pols, np.broadcast_to(mu, (len(pols),)
                                                        + mu.shape),
                            tgts, np.broadcast_to(mix, (len(pols), len(mix))),
                            S, dev)
    out = _run_cfg(cfg, mu, [t for t in tgts for _ in range(S)],
                   types_b * len(names), seed_list * len(names),
                   np.repeat(modes, S), dev, faults)
    rows = {name: [_metrics_row(out, i * S + s) for s in range(S)]
            for i, name in enumerate(names)}
    return {k: v[0] for k, v in rows.items()} if single else rows
