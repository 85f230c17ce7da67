"""Host fault-injection event loops (the oracle path of `repro_torch.faults`).

Both loops mirror their fault-free templates op-for-op — `run_open_faults`
is `repro_torch.traffic.host.run_open` and `run_closed_faults` is the
simulator's `_run_compat` — with three additions threaded through the
identical arithmetic:

* a piecewise-constant per-pool mu scale `sc` (the realized fault schedule):
  completion candidates and depletion are scaled by `sc[j]`, crashed pools
  (`sc[j] == 0`) freeze in place, and routing is masked to available pools;
* transient failures: a completion attempt with failures left re-executes
  from its last checkpoint instead of departing;
* hedged dispatch (open mode): protected-class arrivals get a backup copy
  on a second pool, first-completion-wins, the partner is cancelled and its
  finished work charged as wasted.

Because every scale multiplication is by exactly 1.0 while no event is in
effect, a scenario whose events never fire inside the horizon produces
bit-identical trajectories to the fault-free loops (tested). Routing for
target policies inlines the same largest-deficit / mu-tie-break rule as
`SchedulerCore.route` (and `deficit_route_masked_torch` on device) against
the per-segment targets from `repro_torch.faults.targets`.

Accounting (all window-gated like their fault-free cousins):

* ``wasted_work``  — lost alone-seconds per second of window: work beyond
  the last checkpoint at a crash or transient failure, plus the finished
  work of cancelled hedge partners;
* ``failures``     — in-window transient failures;
* ``reroute_latency`` — mean gap from a crash event to the next successful
  completion anywhere (how long dispatch takes to produce output again);
* ``recovery_time``   — open mode: mean time for the system population to
  return to its pre-crash level (NaN if never, censored at the window end);
  closed mode: NaN (the population is constant by construction);
* ``goodput``      — successful in-window completions per second (drops,
  failures, and cancelled partners all excluded by construction).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sched.api import SystemView
from repro_torch.traffic.quantiles import QUANTILES, exact_quantiles

_INF = float("inf")


def _preserved(done: float, period: float, age: float = 0.0) -> float:
    """Checkpoint-restart: work surviving a fault after `done` alone-secs.

    ``age`` is the age-threshold policy (`FaultScenario.ckpt_age`): no
    checkpoint exists before `age`, then one every `period` from there —
    ``age = 0`` is the uniform-period grid."""
    if period == _INF or done <= 0.0 or done < age:
        return 0.0
    return age + float(np.floor((done - age) / period)) * period


# ---------------------------------------------------------------------------
# Open / traffic mode
# ---------------------------------------------------------------------------

def run_open_faults(sim, core, return_samples: bool = False):
    """`repro_torch.traffic.host.run_open` with the fault layer threaded in."""
    from repro_torch.faults.targets import segment_targets
    from repro_torch.traffic.host import _open_metrics

    cfg = sim.cfg
    tr = cfg.traffic
    fs = cfg.faults
    k, l = sim.k, sim.l
    mu, P = sim.mu, sim.P
    cls_l = sim.cls.tolist()
    C = sim.n_classes
    order_ps = cfg.order == "PS"
    order_prio = cfg.order == "PRIO"
    cdists = cfg.class_distributions
    T = tr.n_arrivals
    W = tr.warmup_arrivals
    Q = tr.queue_capacity
    limits = tr.resolved_admit_limits(l).tolist()
    deadlines = tr.resolved_deadlines().tolist()

    arr_times, arr_types = tr.spec.sample(cfg.seed, T)
    t_warm = 0.0 if W == 0 else float(arr_times[W - 1])
    t_end = float(arr_times[T - 1])
    rng = np.random.default_rng([int(cfg.seed), 1])   # sizes (+ RD draws)

    mix = np.asarray(cfg.n_programs_per_type, dtype=np.int64)
    core.reset(mu, mix)
    needs_target = core.policy.needs_target
    pol_key = getattr(core.policy, "key", None)
    recorder = getattr(core, "recorder", None)
    mu_rows = mu.tolist()

    # ---- fault realization (shared verbatim with the device engine) ----
    real = fs.realize(l)
    f_times = real.times.tolist()
    S = len(f_times)
    scale_rows = real.scale                       # (S + 1, l)
    fail_counts = fs.fail_counts(cfg.seed, T)
    period = _INF if fs.ckpt_period is None else float(fs.ckpt_period)
    ckpt_age = float(fs.ckpt_age)
    overhead = float(fs.restart_overhead)
    hedge_cls = [c in set(fs.hedge_classes) for c in range(C)]
    # straggler-triggered speculative hedging: a running per-type response
    # histogram (the device engine's accumulator, same geometry) feeds a
    # quantile threshold; unpaired in-flight tasks older than it get a
    # late-binding backup
    hq = float(fs.hedge_quantile)
    hmin = int(fs.hedge_min_obs)
    hist = tr.hist
    shist = np.zeros((k, hist.n_bins)) if hq > 0.0 else None
    th = np.full(k, _INF)
    n_spec = 0
    seg_tgts = (segment_targets(core.policy, mu, mix, real,
                                refresh=fs.refresh_targets,
                                device=core.device)
                if needs_target else None)

    # Per-task state; hedged backups of arrival `a` use id `a + T`.
    n_ids = 2 * T
    task_type = arr_types.tolist() + arr_types.tolist()
    remaining = np.zeros(n_ids)
    size_left = np.zeros(n_ids)
    size0 = np.zeros(n_ids)
    service_need = np.zeros(n_ids)
    entry_time = np.zeros(n_ids)
    task_proc = [-1] * n_ids
    partner = [-1] * n_ids
    fail_left = [0] * n_ids
    proc_tasks: list[list[int]] = [[] for _ in range(l)]   # admission order
    running = [-1] * l                                     # PRIO sticky heads
    counts = np.zeros((k, l), dtype=np.int64)              # sim-side mirror
    n_sys = 0

    sp = 0
    sc = scale_rows[0]
    avail = sc > 0.0

    def view(mask) -> SystemView:
        backlog_work = np.zeros(l)
        backlog_tasks = np.zeros(l)
        for j in range(l):
            ids = proc_tasks[j]
            backlog_tasks[j] = len(ids)
            if ids:
                backlog_work[j] = size_left[np.asarray(ids)].sum()
        if mask is None:
            vmu = mu
        else:
            backlog_work[~mask] = _INF
            backlog_tasks[~mask] = _INF
            vmu = mu.copy()
            vmu[:, ~mask] = -_INF
        return SystemView(counts=counts, backlog_work=backlog_work,
                          backlog_tasks=backlog_tasks, mu=vmu)

    def route_to(t: int, excl: int = -1) -> int:
        """Pool for an arriving type-t task under the current availability
        (excluding `excl` for hedged backups); -1 when nowhere can take it.
        Identical decisions to SchedulerCore.route / the device router."""
        ok = avail if excl < 0 else (avail & (np.arange(l) != excl))
        if not ok.any():
            return -1
        if needs_target:
            trow = seg_tgts[sp][t]
            crow = counts[t]
            mrow = mu_rows[t]
            j = -1
            best_d = best_m = 0.0
            for jj in range(l):
                if not ok[jj]:
                    continue
                d = int(trow[jj]) - int(crow[jj])
                if j < 0 or d > best_d or (d == best_d and mrow[jj] > best_m):
                    best_d, best_m, j = d, mrow[jj], jj
            return j
        if pol_key == "rd":
            opts = np.flatnonzero(ok)
            return int(opts[rng.integers(len(opts))])
        return int(core.policy.choose(t, view(None if ok.all() else ok), rng))

    # Accumulators (in-window).
    cls_meas = [0] * C
    cls_resp = [0.0] * C
    cls_energy = [0.0] * C
    cls_drop = [0] * C
    cls_dm = [0] * C
    samples: list[list[float]] = [[] for _ in range(C)]
    occupancy = np.zeros((k, l))
    power_int = 0.0
    wasted = 0.0
    failures = 0
    n_topo = 0
    rr_pend_sum = 0.0
    rr_pend_n = 0
    rr_sum = 0.0
    rr_n = 0
    rec_on = False
    rec_pre = 0
    rec_t0 = 0.0
    rec_sum = 0.0
    rec_n = 0

    def pool_draw() -> float:
        draw = 0.0
        for jj in range(l):
            ids = proc_tasks[jj]
            if not ids:
                continue
            if order_ps:
                draw += sc[jj] * (sum(P[task_type[i], jj] for i in ids)
                                  / len(ids))
            elif order_prio:
                draw += sc[jj] * P[task_type[running[jj]], jj]
            else:
                draw += sc[jj] * P[task_type[ids[0]], jj]
        return draw

    now = 0.0
    aptr = 0

    def advance(dt: float) -> None:
        nonlocal now, power_int, occupancy
        if dt > 0.0:
            ow = min(now + dt, t_end) - max(now, t_warm)
            if ow > 0.0:
                occupancy += counts * ow
                power_int += ow * pool_draw()
            for jj in range(l):
                ids = proc_tasks[jj]
                if not ids or sc[jj] <= 0.0:
                    continue
                eff = dt * sc[jj]
                idx = np.asarray(ids)
                if order_ps:
                    dep = eff / len(ids)
                    remaining[idx] -= dep
                    frac = np.zeros(len(idx))
                    nz = service_need[idx] > 0
                    frac[nz] = dep / service_need[idx][nz]
                    size_left[idx] = np.maximum(
                        size_left[idx] - frac * size_left[idx], 0.0)
                else:
                    head = running[jj] if order_prio else ids[0]
                    remaining[head] -= eff
                    if service_need[head] > 0:
                        size_left[head] = max(
                            size_left[head]
                            - eff / service_need[head] * size_left[head], 0.0)
        now += dt

    def restart(pid: int, done: float) -> float:
        """Reset a task to its last checkpoint; returns the work lost."""
        preserved = _preserved(done, period, ckpt_age)
        newrem = service_need[pid] - preserved + overhead
        remaining[pid] = newrem
        if service_need[pid] > 0:
            size_left[pid] = size0[pid] * min(newrem / service_need[pid], 1.0)
        return done - preserved

    def admit(pid: int, t: int, j: int, s: float) -> None:
        nonlocal n_sys
        counts[t, j] += 1
        service_need[pid] = s / mu[t, j]
        remaining[pid] = service_need[pid]
        size_left[pid] = s
        size0[pid] = s
        entry_time[pid] = now
        task_proc[pid] = j
        proc_tasks[j].append(pid)
        if order_prio and running[j] < 0:
            running[j] = pid
        fail_left[pid] = int(fail_counts[pid % T])
        n_sys += 1

    def spec_hedge() -> None:
        """At most one straggler backup per event (the device stanza's
        semantics): the most-overdue unpaired in-flight task whose age
        strictly exceeds its type's observed hq-quantile gets a
        late-binding backup on a different pool. The backup inherits the
        primary's arrival time (the winner's response is end-to-end) and
        is exempt from transient failures."""
        nonlocal n_spec
        if shist is None:
            return
        best, best_score = -1, 0.0
        for jj in range(l):
            for pp in proc_tasks[jj]:
                if pp >= T or partner[pp] >= 0:
                    continue
                score = (now - entry_time[pp]) - th[task_type[pp]]
                if score > best_score:
                    best, best_score = pp, score
        if best < 0:
            return
        pp = best
        tt = int(task_type[pp])
        cc = cls_l[tt]
        if n_sys >= limits[cc]:
            return
        j3 = route_to(tt, excl=task_proc[pp])
        if j3 < 0 or len(proc_tasks[j3]) >= Q:
            return
        admit(pp + T, tt, j3, size0[pp])
        entry_time[pp + T] = entry_time[pp]
        fail_left[pp + T] = 0
        partner[pp] = pp + T
        partner[pp + T] = pp
        n_spec += 1

    while aptr < T:
        # ---- next completion (relative dt) over AVAILABLE pools ----
        best_dt, best_j = _INF, -1
        for j in range(l):
            ids = proc_tasks[j]
            if not ids or sc[j] <= 0.0:
                continue
            if order_ps:
                arr = remaining[np.asarray(ids)]
                dt = arr.min() * len(ids) / sc[j]
            elif order_prio:
                dt = remaining[running[j]] / sc[j]
            else:
                dt = remaining[ids[0]] / sc[j]
            if dt < best_dt:
                best_dt, best_j = dt, j

        ta = float(arr_times[aptr])
        tf = f_times[sp] if sp < S else _INF

        if tf <= ta and tf - now <= best_dt:
            # ---- fault event (first on exact ties) ----
            advance(tf - now)
            old = sc
            sp += 1
            sc = scale_rows[sp]
            avail = sc > 0.0
            in_w = t_warm < now <= t_end
            crashed = [j for j in range(l) if old[j] > 0.0 and sc[j] <= 0.0]
            for j in crashed:
                for pid in proc_tasks[j]:
                    done = max(service_need[pid] - remaining[pid], 0.0)
                    lost = restart(pid, done)
                    if in_w:
                        wasted += lost
            if crashed:
                n_topo += 1
                rr_pend_sum += now
                rr_pend_n += 1
                if not rec_on:
                    rec_on = True
                    rec_pre = n_sys
                    rec_t0 = now
                if recorder is not None:
                    recorder.record(
                        "faults", "breakpoint", t=now, segment=sp,
                        crashed=crashed, in_system=n_sys,
                        scales=[float(s) for s in sc])
            spec_hedge()
            continue

        if ta - now <= best_dt:
            # ---- arrival event (before completions on exact ties) ----
            advance(ta - now)
            pid = aptr
            t = int(task_type[pid])
            c = cls_l[t]
            in_w = aptr >= W
            admitted = False
            if n_sys < limits[c]:
                j = route_to(t)
                if j >= 0 and len(proc_tasks[j]) < Q:
                    admitted = True
                    d = cfg.distribution if cdists is None else cdists[c]
                    s = float(d.sample(rng, 1)[0])
                    admit(pid, t, j, s)
                    if hedge_cls[c]:
                        j2 = route_to(t, excl=j)
                        if (j2 >= 0 and n_sys < limits[c]
                                and len(proc_tasks[j2]) < Q):
                            admit(pid + T, t, j2, s)   # same size: a replica
                            partner[pid] = pid + T
                            partner[pid + T] = pid
            if not admitted and in_w:
                cls_drop[c] += 1
            aptr += 1
            spec_hedge()
            continue

        # ---- completion attempt ----
        assert best_j >= 0, "no events pending and no tasks in flight"
        advance(best_dt)
        j = best_j
        if order_ps:
            ids = np.asarray(proc_tasks[j])
            pid = int(ids[np.argmin(remaining[ids])])
        elif order_prio:
            pid = running[j]
        else:
            pid = proc_tasks[j][0]
        t = int(task_type[pid])
        in_w = t_warm < now <= t_end
        if fail_left[pid] > 0:
            # ---- transient failure: re-execute from the last checkpoint ----
            fail_left[pid] -= 1
            lost = restart(pid, service_need[pid])
            if in_w:
                wasted += lost
                failures += 1
            spec_hedge()
            continue
        # ---- successful completion (first-completion-wins) ----
        proc_tasks[j].remove(pid)
        if order_prio:
            ids = proc_tasks[j]
            running[j] = (min(ids, key=lambda q: cls_l[task_type[q]])
                          if ids else -1)
        counts[t, j] -= 1
        n_sys -= 1
        b = partner[pid]
        if b >= 0:                  # cancel the hedge partner mid-flight
            jb = task_proc[b]
            proc_tasks[jb].remove(b)
            if order_prio and running[jb] == b:
                idsb = proc_tasks[jb]
                running[jb] = (min(idsb, key=lambda q: cls_l[task_type[q]])
                               if idsb else -1)
            counts[task_type[b], jb] -= 1
            n_sys -= 1
            if in_w:
                wasted += max(service_need[b] - remaining[b], 0.0)
            partner[pid] = -1
            partner[b] = -1
        if rr_pend_n:
            rr_sum += now * rr_pend_n - rr_pend_sum
            rr_n += rr_pend_n
            rr_pend_sum = 0.0
            rr_pend_n = 0
        if rec_on and n_sys <= rec_pre:
            rec_sum += now - rec_t0
            rec_n += 1
            rec_on = False
        if shist is not None:
            # estimator learns every successful completion, windowed or not
            # (the device accumulator does the same)
            shist[t, hist.bin_index(now - entry_time[pid])] += 1
            if shist[t].sum() >= hmin:
                th[t] = hist.quantile(shist[t], hq)
        if in_w:
            resp = now - entry_time[pid]
            c = cls_l[t]
            cls_meas[c] += 1
            cls_resp[c] += resp
            cls_energy[c] += P[t, j] * service_need[pid]
            if resp <= deadlines[c]:
                cls_dm[c] += 1
            samples[c].append(resp)
        spec_hedge()

    if rec_on:                      # censored at the window end
        rec_sum += max(t_end - rec_t0, 0.0)
        rec_n += 1

    elapsed = t_end - t_warm
    measured = int(np.sum(cls_meas))
    extras = dict(
        goodput=measured / elapsed if elapsed > 0 else 0.0,
        wasted_work=wasted / elapsed if elapsed > 0 else 0.0,
        failures=int(failures),
        topology_events=int(n_topo),
        spec_hedges=int(n_spec),
        reroute_latency=rr_sum / rr_n if rr_n else float("nan"),
        recovery_time=rec_sum / rec_n if rec_n else float("nan"))
    metrics = _open_metrics(sim, elapsed=elapsed, offered=T - W,
                  cls_meas=cls_meas, cls_resp=cls_resp,
                  cls_energy=cls_energy, cls_drop=cls_drop,
                  cls_dm=cls_dm, occupancy=occupancy, power_int=power_int,
                  class_quantiles=np.stack(
                      [exact_quantiles(s, QUANTILES) for s in samples]),
                  track_deadlines=tr.deadlines is not None,
                  fault_extras=extras)
    if return_samples:
        return metrics, samples
    return metrics


# ---------------------------------------------------------------------------
# Closed mode
# ---------------------------------------------------------------------------

def run_closed_faults(sim, core):
    """The simulator's `_run_compat` loop with the fault layer threaded in.

    Serves target AND stateless policies (the fast virtual-clock path
    assumes constant service rates, which faults break). Transient failures
    in closed mode are drawn per completion attempt from the isolated
    `default_rng([seed, 2])` stream (capped at `fail_cap` per task);
    `recovery_time` is NaN (the closed population is constant).
    """
    from repro_torch.faults.targets import segment_targets

    cfg = sim.cfg
    fs = cfg.faults
    k, l = sim.k, sim.l
    mu, P = sim.mu, sim.P
    if cfg.type_mix is not None:
        raise ValueError("faults + type_mix is not supported in closed mode")
    rng = np.random.default_rng(cfg.seed)
    frng = (np.random.default_rng([int(cfg.seed), 2])
            if fs.fail_prob > 0 else None)
    n_per_type = np.asarray(cfg.n_programs_per_type, dtype=np.int64)
    n_prog = int(n_per_type.sum())
    order_ps = cfg.order == "PS"
    order_prio = cfg.order == "PRIO"
    cls_l = sim.cls.tolist()
    C = sim.n_classes
    cdists = cfg.class_distributions
    mu_rows = mu.tolist()

    real = fs.realize(l, require_alive=True)
    f_times = real.times.tolist()
    S = len(f_times)
    scale_rows = real.scale
    period = _INF if fs.ckpt_period is None else float(fs.ckpt_period)
    ckpt_age = float(fs.ckpt_age)
    overhead = float(fs.restart_overhead)

    core.reset(mu, n_per_type)
    needs_target = core.policy.needs_target
    pol_key = getattr(core.policy, "key", None)
    recorder = getattr(core, "recorder", None)
    seg_tgts = (segment_targets(core.policy, mu, n_per_type, real,
                                refresh=fs.refresh_targets,
                                device=core.device)
                if needs_target else None)

    task_type = np.repeat(np.arange(k), n_per_type)
    task_proc = np.full(n_prog, -1, dtype=np.int64)
    remaining = np.zeros(n_prog)
    size_left = np.zeros(n_prog)
    size0 = np.zeros(n_prog)
    entry_time = np.zeros(n_prog)
    service_need = np.zeros(n_prog)
    fails_used = [0] * n_prog

    proc_tasks: list[list[int]] = [[] for _ in range(l)]
    running = [-1] * l
    cls_meas = [0] * C
    cls_resp = [0.0] * C
    cls_energy = [0.0] * C
    counts = np.zeros((k, l), dtype=np.int64)

    sp = 0
    sc = scale_rows[0]
    avail = sc > 0.0

    def view(mask) -> SystemView:
        backlog_work = np.zeros(l)
        backlog_tasks = np.zeros(l)
        for j in range(l):
            ids = proc_tasks[j]
            backlog_tasks[j] = len(ids)
            if ids:
                backlog_work[j] = size_left[np.asarray(ids)].sum()
        if mask is None:
            vmu = mu
        else:
            backlog_work[~mask] = _INF
            backlog_tasks[~mask] = _INF
            vmu = mu.copy()
            vmu[:, ~mask] = -_INF
        return SystemView(counts=counts, backlog_work=backlog_work,
                          backlog_tasks=backlog_tasks, mu=vmu)

    def route_to(t: int) -> int:
        if needs_target:
            trow = seg_tgts[sp][t]
            crow = counts[t]
            mrow = mu_rows[t]
            j = -1
            best_d = best_m = 0.0
            for jj in range(l):
                if not avail[jj]:
                    continue
                d = int(trow[jj]) - int(crow[jj])
                if j < 0 or d > best_d or (d == best_d and mrow[jj] > best_m):
                    best_d, best_m, j = d, mrow[jj], jj
            return j
        if pol_key == "rd":
            opts = np.flatnonzero(avail)
            return int(opts[rng.integers(len(opts))])
        return int(core.policy.choose(
            t, view(None if avail.all() else avail), rng))

    def admit(pid: int, now: float) -> None:
        t = int(task_type[pid])
        j = route_to(t)
        counts[t, j] += 1
        d = cfg.distribution if cdists is None else cdists[cls_l[t]]
        s = float(d.sample(rng, 1)[0])
        task_proc[pid] = j
        service_need[pid] = s / mu[t, j]
        remaining[pid] = service_need[pid]
        size_left[pid] = s
        size0[pid] = s
        fails_used[pid] = 0
        entry_time[pid] = now
        proc_tasks[j].append(pid)
        if order_prio and running[j] < 0:
            running[j] = pid

    for pid in range(n_prog):
        admit(pid, 0.0)

    now = 0.0
    completed = 0
    measured = 0
    t_measure_start = 0.0
    sum_resp = 0.0
    sum_energy = 0.0
    occupancy = np.zeros((k, l))
    occ_t0 = None
    power_int = 0.0
    wasted = 0.0
    failures = 0
    n_topo = 0
    rr_pend_sum = 0.0
    rr_pend_n = 0
    rr_sum = 0.0
    rr_n = 0
    warmup = cfg.warmup_completions

    def restart(pid: int, done: float) -> float:
        preserved = _preserved(done, period, ckpt_age)
        newrem = service_need[pid] - preserved + overhead
        remaining[pid] = newrem
        if service_need[pid] > 0:
            size_left[pid] = size0[pid] * min(newrem / service_need[pid], 1.0)
        return done - preserved

    while completed < cfg.n_completions:
        # ---- next completion over AVAILABLE pools ----
        best_dt, best_j = _INF, -1
        for j in range(l):
            ids = proc_tasks[j]
            if not ids or sc[j] <= 0.0:
                continue
            if order_ps:
                arr = remaining[np.asarray(ids)]
                dt = arr.min() * len(ids) / sc[j]
            elif order_prio:
                dt = remaining[running[j]] / sc[j]
            else:
                dt = remaining[ids[0]] / sc[j]
            if dt < best_dt:
                best_dt, best_j = dt, j
        tf = f_times[sp] if sp < S else _INF
        do_fault = tf - now <= best_dt          # fault first on exact ties
        if not do_fault and best_j < 0:
            raise RuntimeError(
                "closed network deadlocked: every runnable task sits on a "
                "crashed pool and no recovery event remains")
        dt = (tf - now) if do_fault else best_dt

        # ---- advance time & deplete (scaled by the segment's mu scale) ----
        if occ_t0 is not None and dt > 0.0:
            occupancy += counts * dt
            draw = 0.0
            for jj in range(l):
                ids = proc_tasks[jj]
                if not ids:
                    continue
                if order_ps:
                    draw += sc[jj] * (sum(P[task_type[i], jj] for i in ids)
                                      / len(ids))
                elif order_prio:
                    draw += sc[jj] * P[task_type[running[jj]], jj]
                else:
                    draw += sc[jj] * P[task_type[ids[0]], jj]
            power_int += dt * draw
        now += dt
        for jj in range(l):
            ids = proc_tasks[jj]
            if not ids or sc[jj] <= 0.0:
                continue
            eff = dt * sc[jj]
            idx = np.asarray(ids)
            if order_ps:
                dep = eff / len(ids)
                remaining[idx] -= dep
                frac = np.zeros(len(idx))
                nz = service_need[idx] > 0
                frac[nz] = dep / service_need[idx][nz]
                size_left[idx] = np.maximum(
                    size_left[idx] - frac * size_left[idx], 0.0)
            else:
                head = running[jj] if order_prio else ids[0]
                remaining[head] -= eff
                if service_need[head] > 0:
                    size_left[head] = max(
                        size_left[head]
                        - eff / service_need[head] * size_left[head], 0.0)

        if do_fault:
            old = sc
            sp += 1
            sc = scale_rows[sp]
            avail = sc > 0.0
            in_w = completed >= warmup
            crashed = [j for j in range(l) if old[j] > 0.0 and sc[j] <= 0.0]
            for j in crashed:
                for pid in proc_tasks[j]:
                    done = max(service_need[pid] - remaining[pid], 0.0)
                    lost = restart(pid, done)
                    if in_w:
                        wasted += lost
            if crashed:
                n_topo += 1
                rr_pend_sum += now
                rr_pend_n += 1
                if recorder is not None:
                    recorder.record(
                        "faults", "breakpoint", t=now, segment=sp,
                        crashed=crashed,
                        scales=[float(s) for s in sc])
            continue

        # ---- completion attempt on processor j ----
        j = best_j
        if order_ps:
            ids = np.asarray(proc_tasks[j])
            pid = int(ids[np.argmin(remaining[ids])])
        elif order_prio:
            pid = running[j]
        else:
            pid = proc_tasks[j][0]
        t = int(task_type[pid])
        if (frng is not None and fails_used[pid] < fs.fail_cap
                and frng.random() < fs.fail_prob):
            # ---- transient failure: re-execute from the last checkpoint ----
            fails_used[pid] += 1
            lost = restart(pid, service_need[pid])
            if completed >= warmup:
                wasted += lost
                failures += 1
            continue
        proc_tasks[j].remove(pid)
        if order_prio:
            ids = proc_tasks[j]
            running[j] = (min(ids, key=lambda q: cls_l[task_type[q]])
                          if ids else -1)
        counts[t, j] -= 1
        completed += 1
        if rr_pend_n:
            rr_sum += now * rr_pend_n - rr_pend_sum
            rr_n += rr_pend_n
            rr_pend_sum = 0.0
            rr_pend_n = 0

        in_window = completed > warmup
        if completed == warmup:
            t_measure_start = now
            occ_t0 = now
            occupancy[:] = 0.0
            power_int = 0.0
        if in_window:
            measured += 1
            resp = now - entry_time[pid]
            energy = P[t, j] * service_need[pid]
            sum_resp += resp
            sum_energy += energy
            c = cls_l[t]
            cls_meas[c] += 1
            cls_resp[c] += resp
            cls_energy[c] += energy

        # ---- the program's next task enters immediately (closed) ----
        admit(pid, now)

    elapsed = now - t_measure_start
    base = sim._metrics(measured, elapsed, sum_resp, sum_energy,
                        occupancy, power_int, cls_meas, cls_resp, cls_energy)
    return dataclasses.replace(
        base,
        goodput=measured / elapsed if elapsed > 0 else 0.0,
        wasted_work=wasted / elapsed if elapsed > 0 else 0.0,
        failures=int(failures),
        topology_events=int(n_topo),
        reroute_latency=rr_sum / rr_n if rr_n else float("nan"),
        recovery_time=float("nan"))


__all__ = ["run_open_faults", "run_closed_faults"]
