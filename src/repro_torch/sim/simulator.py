"""Discrete-event simulator of the closed batch network (paper Figs. 2, 4-12):
the host event core, the oracle the batched engine
(`repro_torch.sim.engine_torch`) is held against.

Model: N programs; each program is an endless sequence of tasks. The system
always holds exactly N in-flight tasks; when a task completes, the program's
next task enters immediately and the dispatcher routes it (closed system).

Processing orders (all work-conserving, per Lemma 3):
  * PS   — processor j serves its n_j resident tasks simultaneously; each
           task's remaining "alone time" r = s / mu[i, j] depletes at rate
           1 / n_j wall-seconds per second.
  * FCFS — head-of-line task runs at full rate; the rest wait.
  * PRIO — strict-priority, preemption-free (arXiv:1712.03246): the running
           task always finishes; the next to run is the oldest waiting task
           of the highest-priority class present (class 0 first). With a
           single class this is exactly FCFS.

Priority classes: `SimConfig.class_of_type` maps each task-type row of mu
to a class c in {0..C-1}; both engines then report per-class throughput,
response time, energy and occupancy in `SimMetrics` (single-class configs
get the C == 1 reductions). `class_distributions` gives each class its own
task-size distribution. The priority subsystem (`repro_torch.sched.priority`)
builds these flattened configs from (C, k) per-class mixes.

Energy: a size-s i-type task on processor j occupies the processor for
s / mu[i, j] dedicated seconds in either order, so task energy is
P[i, j] * s / mu[i, j] (paper Sec. 5: execution time, NOT response time).

Two inner loops share the model, both the reference package's op for op
(same NumPy streams, same summation order), so a run reproduces the
reference host core's metrics bit for bit:

  * Fast path (target policies, `policy.needs_target`): O(l) per event.
    PS runs on per-processor virtual-time clocks (V_j = cumulative
    per-resident service; a task admitted at V_j with need r completes when
    V_j reaches V_j + r), so no per-task depletion pass exists; completion
    queues are per-processor lists sorted descending by (finish, seq) with
    O(1) pop and binary-search insertion. FCFS depletes heads only.
    Occupancy is integrated per cell on change (O(1) per event). Task sizes
    are prefetched in blocks (stream-identical to per-event draws) whenever
    the policy path consumes no other randomness. Target policies never
    read a SystemView, so none is built.
  * Compat path (stateless policies, i.e. anything routing on a SystemView):
    the O(l*N)-per-event loop; LB's backlog_work is the pairwise NumPy sum
    over residents in admission order, which its routing decisions depend
    on.

Open traffic (`SimConfig.traffic`) dispatches to the host open loop
(`repro_torch.traffic.host.run_open`) and fault scenarios
(`SimConfig.faults`) to the host fault loops (`repro_torch.faults.host`),
each bit-equal to the reference package's.

The loop runs on the host; the `SchedulerCore` it routes through is built
on `device` (its batched solves — a refreshed fault scenario's segment
targets among them — run there; routing and the policy's own target solves
stay the host float64 solvers).
"""
from __future__ import annotations

import dataclasses
from bisect import insort
from collections import deque

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.affinity import PowerModel, PROPORTIONAL_POWER
from repro_torch.sched.api import Policy, SchedulerCore, SystemView, as_core
from repro_torch.sim.distributions import TaskSizeDistribution

_INF = float("inf")
_SIZE_BLOCK = 4096      # prefetch granularity for task-size draws


@dataclasses.dataclass
class SimConfig:
    mu: np.ndarray                      # (k, l) affinity matrix
    n_programs_per_type: np.ndarray     # (k,) programs whose tasks are type i
    distribution: TaskSizeDistribution
    order: str = "PS"                   # "PS" | "FCFS" | "PRIO"
    power: PowerModel = dataclasses.field(default_factory=lambda: PROPORTIONAL_POWER)
    n_completions: int = 20_000
    warmup_completions: int = 2_000
    seed: int = 0
    # If set, each new task's type is re-drawn iid with these probabilities
    # (piecewise-closed operation; dispatchers are notified of mix changes).
    type_mix: np.ndarray | None = None
    # Priority classes: class id (0 = highest priority) of each task-type
    # row; None = every type is class 0. Drives the per-class SimMetrics
    # and the PRIO service order.
    class_of_type: np.ndarray | None = None
    # Per-class task-size distributions (len C); None = `distribution` for
    # every class.
    class_distributions: tuple | None = None
    # Open-network mode (repro_torch.traffic.OpenTraffic): when set,
    # arrivals inject tasks and completions depart instead of recirculating;
    # n_programs_per_type becomes the reference mix target policies solve
    # at, and finite per-processor queues (traffic.queue_capacity) bound the
    # population. None = the closed network above.
    traffic: "object | None" = None
    # Fault scenario (repro_torch.faults.FaultScenario): crash/recovery and
    # degraded-mu events, transient task failures, checkpoint-restart costs,
    # hedged dispatch (open mode only) and target refresh on topology
    # events. None — or a scenario whose events never fire — leaves every
    # fault-free trajectory bit-identical (dedicated RNG substreams).
    faults: "object | None" = None


@dataclasses.dataclass
class SimMetrics:
    throughput: float                   # X_sim (tasks / sec)
    mean_response_time: float           # E[T_sim]
    mean_energy: float                  # E[E_sim]
    edp: float                          # E[E_sim] * E[T_sim]
    little_product: float               # X_sim * E[T_sim]  (should be ~N)
    completed: int
    elapsed: float
    state_occupancy: np.ndarray         # time-averaged N_ij
    # Occupancy-weighted power draw over the measurement window: the time
    # integral of sum_j W_j (PS: W_j = sum_i N_ij P_ij / c_j; FCFS/PRIO: the
    # running head's P) divided by elapsed. mean_power / throughput is the
    # model's E[E] (eq. 19) measured from the trajectory rather than per
    # completion.
    mean_power: float = 0.0
    # Per-priority-class metrics (C,) / (C, l); the C == 1 reductions for
    # single-class configs. class_throughput sums to `throughput`, and
    # sum_c w_c * class_throughput[c] is the class-weighted X the priority
    # solvers maximize.
    class_throughput: np.ndarray | None = None
    class_response_time: np.ndarray | None = None
    class_energy: np.ndarray | None = None
    class_occupancy: np.ndarray | None = None
    # Open-network (SimConfig.traffic) extras; None on closed runs.
    # offered counts post-warmup arrivals; dropped = shed by admission +
    # rejected by a full finite queue. class_quantiles is (C, 3) response
    # p50/p99/p999 (repro_torch.traffic.quantiles.QUANTILES);
    # class_deadline_met is the in-window fraction meeting each class's SLO
    # deadline.
    offered: int | None = None
    dropped: int | None = None
    class_dropped: np.ndarray | None = None
    class_quantiles: np.ndarray | None = None
    class_deadline_met: np.ndarray | None = None
    # Resilience extras (SimConfig.faults); None on fault-free runs.
    # goodput = successful in-window completions / elapsed; wasted_work =
    # lost alone-seconds of work (crash rewinds past the last checkpoint,
    # failed attempts, cancelled hedge duplicates) / elapsed; failures
    # counts in-window transient failures; topology_events counts crash
    # breakpoints; reroute_latency averages crash -> next successful
    # completion; recovery_time averages crash -> population back at its
    # pre-crash level (open mode; NaN in closed mode).
    goodput: float | None = None
    wasted_work: float | None = None
    failures: int | None = None
    topology_events: int | None = None
    reroute_latency: float | None = None
    recovery_time: float | None = None
    # Straggler-triggered speculative backups launched (open mode with
    # faults.hedge_quantile > 0; None elsewhere).
    spec_hedges: int | None = None
    # meta: the run_meta() substrate block (torch version, device, kernel
    # mode, dtype) stamped by the engine wrappers so every metrics row says
    # WHERE it was measured. telemetry: time-resolved per-pool series for
    # this row ({occupancy, backlog, power, hedges, bin_width, horizon})
    # when the run asked for them.
    meta: dict | None = None
    telemetry: dict | None = None


class ClosedNetworkSimulator:
    """Event-driven closed network; O(l) per completion for target policies,
    O(l*N) for SystemView policies. `device` is where the SchedulerCore it
    builds for a policy runs its batched solves (default "cuda")."""

    def __init__(self, cfg: SimConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mu = np.asarray(cfg.mu, dtype=np.float64)
        self.k, self.l = self.mu.shape
        self.P = cfg.power.power_matrix(self.mu)
        if cfg.order not in ("PS", "FCFS", "PRIO"):
            raise ValueError(f"unknown order {cfg.order!r}: PS | FCFS | PRIO")
        self.cls = (np.zeros(self.k, dtype=np.int64)
                    if cfg.class_of_type is None
                    else np.asarray(cfg.class_of_type, dtype=np.int64))
        if self.cls.shape != (self.k,) or self.cls.min() < 0:
            raise ValueError(f"class_of_type must be (k={self.k},) nonneg "
                             f"ints; got {cfg.class_of_type!r}")
        self.n_classes = int(self.cls.max()) + 1
        if (cfg.class_distributions is not None
                and len(cfg.class_distributions) != self.n_classes):
            raise ValueError(f"need {self.n_classes} class_distributions; "
                             f"got {len(cfg.class_distributions)}")
        if cfg.traffic is not None:
            if cfg.traffic.spec.n_classes != self.n_classes:
                raise ValueError(
                    f"traffic spec has {cfg.traffic.spec.n_classes} classes; "
                    f"class_of_type implies {self.n_classes}")
            if cfg.type_mix is not None:
                raise ValueError("type_mix is a closed-network knob; open "
                                 "mode draws types from traffic.spec")
        if cfg.faults is not None:
            if cfg.faults.hedge_classes and cfg.traffic is None:
                raise ValueError("hedge_classes require open/traffic mode "
                                 "(a closed network has no duplicate "
                                 "admission slot)")
            if cfg.faults.hedge_quantile > 0.0 and cfg.traffic is None:
                raise ValueError("hedge_quantile (speculative straggler "
                                 "hedging) requires open/traffic mode")
            if cfg.type_mix is not None and not cfg.faults.is_null:
                raise ValueError("faults + type_mix is not supported in "
                                 "closed mode")

    def run(self, policy: str | Policy | SchedulerCore) -> SimMetrics:
        """Simulate under a policy: a registry name ("cab", "grin", "lb",
        ...), a Policy instance, or a prebuilt SchedulerCore (reset here)."""
        core = as_core(policy, self.mu, device=self.device)
        # Null fault scenarios dispatch to the fault-free loops: trivially
        # bit-identical, and the fault loops run only when a scenario can
        # actually fire.
        if self.cfg.faults is not None and not self.cfg.faults.is_null:
            if self.cfg.traffic is not None:
                from repro_torch.faults.host import run_open_faults
                return run_open_faults(self, core)
            from repro_torch.faults.host import run_closed_faults
            return run_closed_faults(self, core)
        if self.cfg.traffic is not None:
            from repro_torch.traffic.host import run_open
            return run_open(self, core)
        if core.policy.needs_target:
            return self._run_fast(core)
        return self._run_compat(core)

    # ------------------------------------------------------------------
    # Fast path: target policies — no SystemView, O(l) per event.
    # ------------------------------------------------------------------
    def _run_fast(self, core: SchedulerCore) -> SimMetrics:
        cfg = self.cfg
        k, l = self.k, self.l
        mu_rows = self.mu.tolist()
        P_rows = self.P.tolist()
        rng = np.random.default_rng(cfg.seed)
        n_per_type = np.asarray(cfg.n_programs_per_type, dtype=np.int64)
        n_prog = int(n_per_type.sum())
        order_ps = cfg.order == "PS"
        order_prio = cfg.order == "PRIO"
        cls_l = self.cls.tolist()
        C = self.n_classes
        cdists = cfg.class_distributions

        task_type = np.repeat(np.arange(self.k), n_per_type)
        if cfg.type_mix is not None:
            task_type = rng.choice(self.k, size=n_prog, p=cfg.type_mix)
            mix_counts = np.bincount(task_type, minlength=self.k)
            core.reset(self.mu, mix_counts)
            mix_counts = mix_counts.tolist()    # maintained incrementally
        else:
            core.reset(self.mu, n_per_type)
            mix_counts = None
        task_type = task_type.tolist()

        # Sizes: with the mix fixed, a single distribution and a target
        # policy, the distribution is the only consumer of `rng`, so block
        # draws are stream-identical to per-admission draws (verified for
        # every registry distribution). Per-class distributions interleave
        # draws by class, so they draw per admission like the mix case.
        dist = cfg.distribution
        if mix_counts is None and cdists is None:
            size_buf = dist.sample(rng, _SIZE_BLOCK).tolist()
            size_ptr = 0
        else:
            size_buf = None                     # interleaved draws
            size_ptr = 0

        service_need = [0.0] * n_prog
        entry_time = [0.0] * n_prog
        remaining = [0.0] * n_prog              # FCFS only (heads deplete)
        V = [0.0] * l                           # PS virtual clocks
        n_res = [0] * l
        # PS: per-proc completions sorted ASC by (-finish, -seq): the tail is
        # the earliest finisher with ties broken toward the earliest
        # admission, exactly the original list-order argmin. FCFS: FIFO.
        # PRIO: one FIFO per class per proc + the sticky running head
        # (preemption-free: an arriving high-priority task waits for the
        # running task to finish, then jumps every lower class).
        ps_q: list[list] = [[] for _ in range(l)]
        fifo: list[deque] = [deque() for _ in range(l)]
        prio_q: list[list] = [[deque() for _ in range(C)] for _ in range(l)]
        running = [-1] * l
        seq = 0

        # Per-priority-class accumulators (the totals keep their own scalar
        # accumulators so single-class sums stay bit-identical to pre-PR).
        cls_meas = [0] * C
        cls_resp = [0.0] * C
        cls_energy = [0.0] * C

        # O(1)-per-event occupancy: integrate each (type, proc) cell on
        # change; cnt_rows mirrors core's counts cheaply on the sim side.
        occ_rows = [[0.0] * l for _ in range(k)]
        last_t = [[0.0] * l for _ in range(k)]
        cnt_rows = [[0] * l for _ in range(k)]

        # O(1)-per-event power integration: pw_sum is the instantaneous
        # occupancy-weighted draw sum_j W_j. PS shares each processor, so
        # W_j = sum_{residents} P[type, j] / n_j; FCFS runs the head alone
        # at its full P. Both fold incrementally on admit/complete.
        pw_num = [0.0] * l          # PS: sum of P[type, j] over residents
        head_pw = [0.0] * l         # FCFS: P of the running head (0: idle)
        pw_sum = 0.0
        power_int = 0.0

        route = core.route
        now = 0.0

        def admit(pid: int) -> None:
            nonlocal seq, size_ptr, size_buf, pw_sum
            t = task_type[pid]
            j = route(t)
            if size_buf is None:
                d = dist if cdists is None else cdists[cls_l[t]]
                s = float(d.sample(rng, 1)[0])
            else:
                if size_ptr == _SIZE_BLOCK:
                    size_buf = dist.sample(rng, _SIZE_BLOCK).tolist()
                    size_ptr = 0
                s = size_buf[size_ptr]
                size_ptr += 1
            sn = s / mu_rows[t][j]
            service_need[pid] = sn
            entry_time[pid] = now
            if order_ps:
                old = pw_num[j] / n_res[j] if n_res[j] else 0.0
                pw_num[j] += P_rows[t][j]
                pw_sum += pw_num[j] / (n_res[j] + 1) - old
                insort(ps_q[j], (-(V[j] + sn), -seq, pid))
            elif order_prio:
                if running[j] < 0:          # idle: start immediately
                    running[j] = pid
                    head_pw[j] = P_rows[t][j]
                    pw_sum += head_pw[j]
                else:                       # no preemption: queue by class
                    prio_q[j][cls_l[t]].append(pid)
                remaining[pid] = sn
            else:
                if not fifo[j]:
                    head_pw[j] = P_rows[t][j]
                    pw_sum += head_pw[j]
                remaining[pid] = sn
                fifo[j].append(pid)
            seq += 1
            n_res[j] += 1
            row = cnt_rows[t]
            occ_rows[t][j] += row[j] * (now - last_t[t][j])
            last_t[t][j] = now
            row[j] += 1

        for pid in range(n_prog):
            admit(pid)

        completed = 0
        measured = 0
        t_measure_start = 0.0
        sum_resp = 0.0
        sum_energy = 0.0
        n_completions = cfg.n_completions
        warmup = cfg.warmup_completions
        in_window = warmup <= 0     # == the pre-refactor `completed > warmup`
        occ_started = False         # warmup <= 0 never starts the occ window

        while completed < n_completions:
            # ---- find next completion (O(l)) ----
            best_dt = _INF
            best_j = -1
            if order_ps:
                for j in range(l):
                    q = ps_q[j]
                    if q:
                        dt = (-q[-1][0] - V[j]) * n_res[j]
                        if dt < best_dt:
                            best_dt, best_j = dt, j
            elif order_prio:
                for j in range(l):
                    r = running[j]
                    if r >= 0:
                        dt = remaining[r]
                        if dt < best_dt:
                            best_dt, best_j = dt, j
            else:
                for j in range(l):
                    q = fifo[j]
                    if q:
                        dt = remaining[q[0]]
                        if dt < best_dt:
                            best_dt, best_j = dt, j
            assert best_j >= 0, "no runnable tasks — system cannot be empty"
            power_int += best_dt * pw_sum   # draw over the elapsed interval

            # ---- advance time & deplete (O(l)) ----
            now += best_dt
            j = best_j
            if order_ps:
                for jj in range(l):
                    r = n_res[jj]
                    if r:
                        V[jj] += best_dt / r
                pid = ps_q[j].pop()[2]
            elif order_prio:
                for jj in range(l):
                    r = running[jj]
                    if r >= 0:
                        remaining[r] -= best_dt
                pid = running[j]
            else:
                for jj in range(l):
                    q = fifo[jj]
                    if q:
                        remaining[q[0]] -= best_dt
                pid = fifo[j].popleft()
            n_res[j] -= 1

            # ---- complete ----
            t = task_type[pid]
            if order_ps:
                old = pw_num[j] / (n_res[j] + 1)
                pw_num[j] -= P_rows[t][j]
                pw_sum += (pw_num[j] / n_res[j] if n_res[j] else 0.0) - old
            elif order_prio:
                # next to run: oldest waiting task of the best class present
                pw_sum -= head_pw[j]
                nxt = -1
                for qc in prio_q[j]:
                    if qc:
                        nxt = qc.popleft()
                        break
                running[j] = nxt
                head_pw[j] = P_rows[task_type[nxt]][j] if nxt >= 0 else 0.0
                pw_sum += head_pw[j]
            else:
                pw_sum -= head_pw[j]
                q = fifo[j]
                head_pw[j] = P_rows[task_type[q[0]]][j] if q else 0.0
                pw_sum += head_pw[j]
            core.complete(t, j)
            row = cnt_rows[t]
            occ_rows[t][j] += row[j] * (now - last_t[t][j])
            last_t[t][j] = now
            row[j] -= 1
            completed += 1

            if completed == warmup:     # unreachable when warmup <= 0
                t_measure_start = now
                in_window = True
                occ_started = True
                power_int = 0.0
                for i in range(k):
                    oi, li = occ_rows[i], last_t[i]
                    for jj in range(l):
                        oi[jj] = 0.0
                        li[jj] = now
            elif in_window:
                measured += 1
                resp = now - entry_time[pid]
                energy = P_rows[t][j] * service_need[pid]
                sum_resp += resp
                sum_energy += energy
                c = cls_l[t]
                cls_meas[c] += 1
                cls_resp[c] += resp
                cls_energy[c] += energy

            # ---- the program's next task enters immediately (closed) ----
            if mix_counts is not None:
                tt = int(rng.choice(self.k, p=cfg.type_mix))
                if tt != t:
                    mix_counts[t] -= 1
                    mix_counts[tt] += 1
                    core.notify_type_counts(mix_counts)
                    task_type[pid] = tt
            admit(pid)

        occupancy = np.asarray(occ_rows)
        if occ_started:
            for i in range(k):
                for jj in range(l):
                    occupancy[i, jj] += cnt_rows[i][jj] * (now - last_t[i][jj])
        else:
            occupancy[:] = 0.0      # pre-refactor quirk: warmup==0 tracks none
            power_int = 0.0         # power window follows the occ convention
        return self._metrics(measured, now - t_measure_start, sum_resp,
                             sum_energy, occupancy, power_int,
                             cls_meas, cls_resp, cls_energy)

    # ------------------------------------------------------------------
    # Compat path: SystemView policies (LB/JSQ/RD/BF and custom choosers).
    # Kept op-for-op equal to the pre-refactor loop: LB routes on pairwise
    # NumPy sums of true remaining sizes in admission order, so any change
    # to summation order or tie-breaks would shift its decisions.
    # ------------------------------------------------------------------
    def _run_compat(self, core: SchedulerCore) -> SimMetrics:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        n_per_type = np.asarray(cfg.n_programs_per_type, dtype=np.int64)
        n_prog = int(n_per_type.sum())

        # Per in-flight task state (one task per program).
        task_type = np.repeat(np.arange(self.k), n_per_type)
        if cfg.type_mix is not None:
            task_type = rng.choice(self.k, size=n_prog, p=cfg.type_mix)
        task_proc = np.full(n_prog, -1, dtype=np.int64)
        remaining = np.zeros(n_prog)        # alone-seconds of service left
        size_left = np.zeros(n_prog)        # work units left (for LB view)
        entry_time = np.zeros(n_prog)
        service_need = np.zeros(n_prog)     # total alone-seconds (for energy)

        proc_tasks: list[list[int]] = [[] for _ in range(self.l)]  # FCFS order
        order_prio = cfg.order == "PRIO"
        running = [-1] * self.l             # PRIO: sticky head per processor
        cls_l = self.cls.tolist()
        cdists = cfg.class_distributions
        cls_meas = [0] * self.n_classes
        cls_resp = [0.0] * self.n_classes
        cls_energy = [0.0] * self.n_classes

        mix0 = (n_per_type if cfg.type_mix is None
                else np.bincount(task_type, minlength=self.k))
        core.reset(self.mu, mix0)
        mix_counts = mix0.tolist()          # maintained incrementally
        counts = np.zeros((self.k, self.l), dtype=np.int64)  # sim-side mirror

        def view() -> SystemView:
            backlog_work = np.zeros(self.l)
            backlog_tasks = np.zeros(self.l)
            for j in range(self.l):
                ids = proc_tasks[j]
                backlog_tasks[j] = len(ids)
                if ids:
                    backlog_work[j] = size_left[np.asarray(ids)].sum()
            return SystemView(counts=counts, backlog_work=backlog_work,
                              backlog_tasks=backlog_tasks, mu=self.mu)

        def admit(pid: int, now: float) -> None:
            t = int(task_type[pid])
            j = core.route(t, view=view(), rng=rng)
            counts[t, j] += 1
            d = cfg.distribution if cdists is None else cdists[cls_l[t]]
            s = float(d.sample(rng, 1)[0])
            task_proc[pid] = j
            service_need[pid] = s / self.mu[t, j]
            remaining[pid] = service_need[pid]
            size_left[pid] = s
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
        occupancy = np.zeros((self.k, self.l))
        occ_t0 = None
        power_int = 0.0

        while completed < cfg.n_completions:
            # ---- find next completion ----
            best_dt, best_j = _INF, -1
            for j in range(self.l):
                ids = proc_tasks[j]
                if not ids:
                    continue
                if cfg.order == "PS":
                    arr = remaining[np.asarray(ids)]
                    dt = arr.min() * len(ids)
                elif order_prio:    # sticky head runs alone, no preemption
                    dt = remaining[running[j]]
                else:  # FCFS: head of line runs alone
                    dt = remaining[ids[0]]
                if dt < best_dt:
                    best_dt, best_j = dt, j
            assert best_j >= 0, "no runnable tasks — system cannot be empty"

            # ---- advance time & deplete ----
            if occ_t0 is not None:
                occupancy += counts * best_dt
                # occupancy-weighted draw (pure reads: routing/rng untouched)
                draw = 0.0
                for jj in range(self.l):
                    ids = proc_tasks[jj]
                    if not ids:
                        continue
                    if cfg.order == "PS":
                        draw += sum(self.P[task_type[i], jj]
                                    for i in ids) / len(ids)
                    elif order_prio:
                        draw += self.P[task_type[running[jj]], jj]
                    else:
                        draw += self.P[task_type[ids[0]], jj]
                power_int += best_dt * draw
            now += best_dt
            j = best_j
            for jj in range(self.l):
                ids = proc_tasks[jj]
                if not ids:
                    continue
                idx = np.asarray(ids)
                if cfg.order == "PS":
                    dep = best_dt / len(ids)
                    remaining[idx] -= dep
                    # size depletes proportionally to service received
                    frac = np.zeros(len(idx))
                    nz = service_need[idx] > 0
                    frac[nz] = dep / service_need[idx][nz]
                    size_left[idx] = np.maximum(
                        size_left[idx] - frac * size_left[idx], 0.0)
                else:
                    head = running[jj] if order_prio else ids[0]
                    remaining[head] -= best_dt
                    # head's size depletes linearly
                    if service_need[head] > 0:
                        size_left[head] = max(
                            size_left[head]
                            - best_dt / service_need[head] * size_left[head],
                            0.0)

            # ---- complete the finished task on processor j ----
            if cfg.order == "PS":
                ids = np.asarray(proc_tasks[j])
                pid = int(ids[np.argmin(remaining[ids])])
            elif order_prio:
                pid = running[j]
            else:
                pid = proc_tasks[j][0]
            t = int(task_type[pid])
            proc_tasks[j].remove(pid)
            if order_prio:
                # next head: oldest (admission order) of the best class
                # present — min() returns the first minimum
                ids = proc_tasks[j]
                running[j] = (min(ids, key=lambda q: cls_l[task_type[q]])
                              if ids else -1)
            core.complete(t, j)
            counts[t, j] -= 1
            completed += 1

            in_window = completed > cfg.warmup_completions
            if completed == cfg.warmup_completions:
                t_measure_start = now
                occ_t0 = now
                occupancy[:] = 0.0
                power_int = 0.0
            if in_window:
                measured += 1
                resp = now - entry_time[pid]
                energy = self.P[t, j] * service_need[pid]
                sum_resp += resp
                sum_energy += energy
                c = cls_l[t]
                cls_meas[c] += 1
                cls_resp[c] += resp
                cls_energy[c] += energy

            # ---- the program's next task enters immediately (closed) ----
            if cfg.type_mix is not None:
                tt = int(rng.choice(self.k, p=cfg.type_mix))
                if tt != t:
                    mix_counts[t] -= 1
                    mix_counts[tt] += 1
                    core.notify_type_counts(mix_counts)
                    task_type[pid] = tt
            admit(pid, now)

        return self._metrics(measured, now - t_measure_start, sum_resp,
                             sum_energy, occupancy, power_int,
                             cls_meas, cls_resp, cls_energy)

    def _metrics(self, measured: int, elapsed: float, sum_resp: float,
                 sum_energy: float, occupancy: np.ndarray,
                 power_int: float = 0.0, cls_meas=None, cls_resp=None,
                 cls_energy=None) -> SimMetrics:
        x = measured / elapsed if elapsed > 0 else 0.0
        et = sum_resp / measured if measured else _INF
        ee = sum_energy / measured if measured else _INF
        occ = occupancy / max(elapsed, 1e-12)
        C = self.n_classes
        cm = np.asarray(cls_meas if cls_meas is not None else [measured],
                        dtype=np.float64)
        cr = np.asarray(cls_resp if cls_resp is not None else [sum_resp])
        ce = np.asarray(cls_energy if cls_energy is not None else [sum_energy])
        with np.errstate(divide="ignore", invalid="ignore"):
            cls_x = cm / elapsed if elapsed > 0 else np.zeros(C)
            cls_rt = np.where(cm > 0, cr / np.maximum(cm, 1.0), _INF)
            cls_ee = np.where(cm > 0, ce / np.maximum(cm, 1.0), _INF)
        cls_occ = np.zeros((C, occupancy.shape[1]))
        np.add.at(cls_occ, self.cls, occ)
        return SimMetrics(throughput=x, mean_response_time=et, mean_energy=ee,
                          edp=ee * et, little_product=x * et,
                          completed=measured, elapsed=elapsed,
                          state_occupancy=occ,
                          mean_power=power_int / elapsed if elapsed > 0
                          else 0.0,
                          class_throughput=cls_x, class_response_time=cls_rt,
                          class_energy=cls_ee, class_occupancy=cls_occ)


def run_policy_sweep(cfg: SimConfig, policies, engine: str = "host",
                     device=None) -> dict[str, SimMetrics]:
    """Run the same workload under each policy; results keyed by display name.

    `policies` is an iterable of registry names, Policy instances, or
    SchedulerCores. `engine` selects the simulator:

      * "host" (default) — the event-driven host core; one NumPy stream per
        run (same seed => same task sizes), bit-reproducible across versions
        and equal to the reference package's host core.
      * "torch" — target policies run on the batched engine
        (`engine_torch.simulate_policy`, its own torch random stream:
        statistically equivalent, not bit-identical to host runs),
        including piecewise type-mix workloads (target pinned at the
        expected mix); SystemView policies run on the host core.
      * "auto" — alias for "torch" with its fallbacks.

    `device` is where the engine and the cores' batched solves run.
    """
    if engine not in ("host", "torch", "auto"):
        raise ValueError(f"unknown engine {engine!r}: host | torch | auto")
    sim = ClosedNetworkSimulator(cfg, device=device)
    # the batched engine needs a real measurement window; degenerate warmups
    # (legal on the host: zero measured completions) run on the host too
    dev_ok = (engine in ("torch", "auto")
              and 0 <= cfg.warmup_completions < cfg.n_completions)
    out: dict[str, SimMetrics] = {}
    for c in (as_core(p, cfg.mu, device=sim.device) for p in policies):
        key, n = c.name, 2
        while key in out:                       # e.g. two 'Opt' variants
            key = f"{c.name}#{n}"
            n += 1
        if dev_ok and c.policy.needs_target:
            from repro_torch.sim.engine_torch import simulate_policy
            out[key] = simulate_policy(cfg, c, device=sim.device)
        else:
            out[key] = sim.run(c)
    return out
