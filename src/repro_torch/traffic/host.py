"""Host open-network event loop (the oracle path).

Open mode: arrivals from `SimConfig.traffic` inject tasks, completions
depart instead of recirculating, and each processor holds at most
`queue_capacity` tasks — an arriving class-c task is SHED when the total
population has reached `admit_limits[c]` (checked before routing) and
DROPPED when the processor it routes to is full (the route is undone with
`SchedulerCore.unroute`). The device engine
(`repro_torch.traffic.engine_torch`) implements the identical event
semantics over the identical pre-sampled arrival realization; only the
task-size streams differ.

Measurement window: arrivals are counted by INDEX (warmup_arrivals onward),
completions and time integrals by the interval [t_warm, t_end] where t_warm
is the warmup-th arrival's time (0 when warmup is 0) and t_end the last
arrival's. The loop ends at the last arrival: every completion still in
flight is after t_end and outside the window by construction.

Response-time quantiles here are EXACT order statistics of the in-window
per-class samples — the reference the device log-histogram path is
validated against (`return_samples=True` exposes the raw samples).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sched.api import SystemView
from repro_torch.traffic.quantiles import QUANTILES, exact_quantiles

_INF = float("inf")


def run_open(sim, core, return_samples: bool = False,
             telemetry: int | None = None):
    """Run `sim`'s open-mode config under a prebuilt SchedulerCore.

    Returns SimMetrics, or (SimMetrics, per-class sample lists) with
    `return_samples` (in-window response times, for quantile validation).
    `telemetry` (an int n_bins) attaches a `TelemetryAccumulator`
    (`repro_torch.obs.telemetry`) time series over [0, t_end] to the
    returned SimMetrics — the host twin of the device engine's
    telemetry_bins carry, charged bin for bin by the same start-bin
    convention. telemetry=None changes nothing.
    """
    cfg = sim.cfg
    tr = cfg.traffic
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

    core.reset(mu, np.asarray(cfg.n_programs_per_type, dtype=np.int64))
    needs_target = core.policy.needs_target

    # Per-arrival-id task state (ids are arrival indices).
    task_type = arr_types.tolist()
    remaining = np.zeros(T)
    size_left = np.zeros(T)
    service_need = np.zeros(T)
    entry_time = np.zeros(T)
    proc_tasks: list[list[int]] = [[] for _ in range(l)]   # admission order
    running = [-1] * l                                     # PRIO sticky heads
    counts = np.zeros((k, l), dtype=np.int64)              # sim-side mirror
    n_sys = 0

    def view() -> SystemView:
        backlog_work = np.zeros(l)
        backlog_tasks = np.zeros(l)
        for j in range(l):
            ids = proc_tasks[j]
            backlog_tasks[j] = len(ids)
            if ids:
                backlog_work[j] = size_left[np.asarray(ids)].sum()
        return SystemView(counts=counts, backlog_work=backlog_work,
                          backlog_tasks=backlog_tasks, mu=mu)

    # Accumulators (in-window).
    cls_meas = [0] * C
    cls_resp = [0.0] * C
    cls_energy = [0.0] * C
    cls_drop = [0] * C
    cls_dm = [0] * C
    samples: list[list[float]] = [[] for _ in range(C)]
    occupancy = np.zeros((k, l))
    power_int = 0.0

    def pool_draw() -> float:
        """Instantaneous occupancy-weighted power draw (pure reads)."""
        draw = 0.0
        for jj in range(l):
            ids = proc_tasks[jj]
            if not ids:
                continue
            if order_ps:
                draw += sum(P[task_type[i], jj] for i in ids) / len(ids)
            elif order_prio:
                draw += P[task_type[running[jj]], jj]
            else:
                draw += P[task_type[ids[0]], jj]
        return draw

    tel = None
    if telemetry is not None:
        from repro_torch.obs.telemetry import TelemetryAccumulator
        tel = TelemetryAccumulator(int(telemetry), t_end, l)

    now = 0.0
    aptr = 0

    def advance(dt: float) -> None:
        """Integrate the window overlap, advance time, deplete service."""
        nonlocal now, power_int, occupancy
        if dt > 0.0:
            if tel is not None:
                tel.add(now, dt,
                        [len(proc_tasks[jj]) for jj in range(l)],
                        [size_left[np.asarray(proc_tasks[jj])].sum()
                         if proc_tasks[jj] else 0.0 for jj in range(l)],
                        pool_draw())
            ow = min(now + dt, t_end) - max(now, t_warm)
            if ow > 0.0:
                occupancy += counts * ow
                power_int += ow * pool_draw()
            for jj in range(l):
                ids = proc_tasks[jj]
                if not ids:
                    continue
                idx = np.asarray(ids)
                if order_ps:
                    dep = dt / len(ids)
                    remaining[idx] -= dep
                    frac = np.zeros(len(idx))
                    nz = service_need[idx] > 0
                    frac[nz] = dep / service_need[idx][nz]
                    size_left[idx] = np.maximum(
                        size_left[idx] - frac * size_left[idx], 0.0)
                else:
                    head = running[jj] if order_prio else ids[0]
                    remaining[head] -= dt
                    if service_need[head] > 0:
                        size_left[head] = max(
                            size_left[head]
                            - dt / service_need[head] * size_left[head], 0.0)
        now += dt

    while aptr < T:
        # ---- next completion (relative dt) ----
        best_dt, best_j = _INF, -1
        for j in range(l):
            ids = proc_tasks[j]
            if not ids:
                continue
            if order_ps:
                arr = remaining[np.asarray(ids)]
                dt = arr.min() * len(ids)
            elif order_prio:
                dt = remaining[running[j]]
            else:
                dt = remaining[ids[0]]
            if dt < best_dt:
                best_dt, best_j = dt, j

        ta = float(arr_times[aptr])
        if ta - now <= best_dt:
            # ---- arrival event (arrival first on exact ties) ----
            advance(ta - now)
            pid = aptr
            t = int(task_type[pid])
            c = cls_l[t]
            in_w = aptr >= W
            admitted = False
            if n_sys < limits[c]:
                j = (core.route(t) if needs_target
                     else core.route(t, view=view(), rng=rng))
                if len(proc_tasks[j]) >= Q:
                    core.unroute(t, j)          # finite queue full: drop
                else:
                    admitted = True
                    counts[t, j] += 1
                    d = cfg.distribution if cdists is None else cdists[c]
                    s = float(d.sample(rng, 1)[0])
                    service_need[pid] = s / mu[t, j]
                    remaining[pid] = service_need[pid]
                    size_left[pid] = s
                    entry_time[pid] = now
                    proc_tasks[j].append(pid)
                    if order_prio and running[j] < 0:
                        running[j] = pid
                    n_sys += 1
            if not admitted and in_w:
                cls_drop[c] += 1
            aptr += 1
            continue

        # ---- completion event ----
        assert best_j >= 0, "no arrivals pending and no tasks in flight"
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
        proc_tasks[j].remove(pid)
        if order_prio:
            ids = proc_tasks[j]
            running[j] = (min(ids, key=lambda q: cls_l[task_type[q]])
                          if ids else -1)
        core.complete(t, j)
        counts[t, j] -= 1
        n_sys -= 1
        if t_warm < now <= t_end:
            resp = now - entry_time[pid]
            c = cls_l[t]
            cls_meas[c] += 1
            cls_resp[c] += resp
            cls_energy[c] += P[t, j] * service_need[pid]
            if resp <= deadlines[c]:
                cls_dm[c] += 1
            samples[c].append(resp)

    metrics = _open_metrics(sim, elapsed=t_end - t_warm, offered=T - W,
                            cls_meas=cls_meas, cls_resp=cls_resp,
                            cls_energy=cls_energy, cls_drop=cls_drop,
                            cls_dm=cls_dm, occupancy=occupancy,
                            power_int=power_int,
                            class_quantiles=np.stack(
                                [exact_quantiles(s, QUANTILES)
                                 for s in samples]),
                            track_deadlines=tr.deadlines is not None)
    if tel is not None:
        metrics.telemetry = tel.series()
    if return_samples:
        return metrics, samples
    return metrics


def _open_metrics(sim, *, elapsed, offered, cls_meas, cls_resp, cls_energy,
                  cls_drop, cls_dm, occupancy, power_int, class_quantiles,
                  track_deadlines, fault_extras=None):
    """Assemble open-mode SimMetrics (shared by host-side consumers).
    `fault_extras` merges the `repro_torch.faults` goodput/wasted-work
    fields."""
    from repro_torch.sim.simulator import SimMetrics
    C = sim.n_classes
    cm = np.asarray(cls_meas, dtype=np.float64)
    cr = np.asarray(cls_resp, dtype=np.float64)
    ce = np.asarray(cls_energy, dtype=np.float64)
    measured = int(cm.sum())
    x = measured / elapsed if elapsed > 0 else 0.0
    et = float(cr.sum() / measured) if measured else _INF
    ee = float(ce.sum() / measured) if measured else _INF
    occ = occupancy / max(elapsed, 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        cls_x = cm / elapsed if elapsed > 0 else np.zeros(C)
        cls_rt = np.where(cm > 0, cr / np.maximum(cm, 1.0), _INF)
        cls_ee = np.where(cm > 0, ce / np.maximum(cm, 1.0), _INF)
    cls_occ = np.zeros((C, occ.shape[1]))
    np.add.at(cls_occ, sim.cls, occ)
    dm = np.asarray(cls_dm, dtype=np.float64)
    return SimMetrics(
        throughput=x, mean_response_time=et, mean_energy=ee, edp=ee * et,
        little_product=x * et, completed=measured, elapsed=elapsed,
        state_occupancy=occ,
        mean_power=power_int / elapsed if elapsed > 0 else 0.0,
        class_throughput=cls_x, class_response_time=cls_rt,
        class_energy=cls_ee, class_occupancy=cls_occ,
        offered=int(offered), dropped=int(np.sum(cls_drop)),
        class_dropped=np.asarray(cls_drop, dtype=np.int64),
        class_quantiles=np.asarray(class_quantiles),
        class_deadline_met=(dm / np.maximum(cm, 1.0)
                            if track_deadlines else None),
        **(fault_extras or {}))


__all__ = ["run_open"]
