"""Batched OPEN-network simulation on the device.

The open counterpart of `repro_torch.sim.engine_torch`: arrivals inject
tasks, completions depart instead of recirculating, finite per-processor
queues (queue_capacity) bound the population, and per-class response
times accumulate into the fixed-bin log-histogram
(`repro_torch.traffic.quantiles`) so p50/p99/p999 come off the device with
a documented error bound. One call advances every batch point (arrival
realization, seed, target, route mode, admission caps, fault schedule)
one event per loop iteration on (B, ...) tensors.

Event semantics match the host oracle (`repro_torch.traffic.host`, and
`repro_torch.faults.host` with faults) event for event over the IDENTICAL
pre-sampled arrival realization (times and types are inputs, sampled on
the host from the spec's [seed, 0] substream):

  * each iteration consumes the earliest pending event — a fault
    breakpoint, the next arrival or the earliest completion (fault first,
    then arrival, on exact ties); 2 * T iterations (plus the fault batch's
    `extra_steps`) cover every event, and the loop stops early once every
    point is past its last arrival;
  * an arriving class-c task is SHED when the total population has reached
    admit_limits[c], and DROPPED when the processor it routes to already
    holds queue_capacity tasks (the route has no side effects on the
    device, so the host's `unroute` has no counterpart here);
  * the measurement window counts arrivals (and drops) by INDEX from
    warmup_arrivals on, and completions / time integrals over the interval
    (t_warm, t_end] bounded by the warmup-th and last arrival times.

The population bound l * queue_capacity makes the slot arrays fixed-size:
proc == -1 marks a free slot, admissions fill the lowest free slot, and the
PS / FCFS / PRIO depletion rules are the closed engine's with an `active`
guard. Routing supports the same five per-point modes (deficit, JSQ, LB,
RD, BF); with faults every mode is masked to the pools that are up.

With a `FaultBatch` (`repro_torch.faults.build_fault_batch(...,
mode="open")`) the loop also runs the crash / degrade schedule with
per-segment routing targets, per-arrival transient failures with
checkpoint restart (`ckpt_period`, `ckpt_age`, `restart_overhead`), hedged
dispatch of protected classes and the straggler-quantile speculative hedge
(first completion wins; the partner is cancelled in the same iteration
and its finished work charged as wasted), and reports goodput, wasted
work, failures, topology events, re-route latency and recovery time.
`telemetry_bins > 0` adds the four binned integrals of
`repro_torch.obs.telemetry`. Without faults or telemetry those stanzas are
skipped entirely.

Task sizes and RD choices (for primaries, class hedges and speculative
backups) come from one `torch.Generator` per point, seeded from the
point's seed and drawn in bulk before the loop — per arrival, so a longer
loop draws nothing different. They cannot replay the host's NumPy
streams: results agree with the host oracle statistically, not bit for
bit. float32 state, like the reference's device engine.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.affinity import PROPORTIONAL_POWER, PowerModel
from repro_torch.faults.device import ckpt_preserved, segment_rows
from repro_torch.obs.meta import run_meta
from repro_torch.obs.telemetry import telemetry_bin_weights
from repro_torch.sched.api import _mu_tiebreak_ranks
from repro_torch.sim.engine_torch import (MODE_BF, MODE_DEFICIT,
                                          _device_route_mode, _policy_of,
                                          _sizes_from_uniforms,
                                          fault_fields, route_modes,
                                          row_telemetry)
from repro_torch.sim.simulator import SimMetrics
from repro_torch.traffic.quantiles import (QUANTILES, LogHistogram,
                                           hist_quantile_rows_torch)

_BIG_STAMP = 2**62
_INF = float("inf")
_CHUNK = 256            # iterations a captured graph holds and between
                        # host checks for the early stop


def _open_draws(seeds, T: int, n_steps: int, distributions, dev,
                spec_hedge: bool):
    """Per-point streams drawn in bulk: sizes (D, T, B) float32 (one slice
    per distribution, all from the same uniforms), RD uniforms (T, B, 2)
    for primaries and class hedges, and — for the speculative hedge — RD
    uniforms (n_steps, B) drawn after them (else None). Point b's draws
    depend only on its own seed, and the per-arrival draws not on the
    loop's length."""
    us, uss = [], []
    for s in seeds:
        g = torch.Generator(device=dev).manual_seed(int(s))
        us.append(torch.rand((T, 4), device=dev, generator=g))
        if spec_hedge:
            uss.append(torch.rand(n_steps, device=dev, generator=g))
    u = torch.stack(us, dim=1)                           # (T, B, 4)
    sizes = torch.stack([
        _sizes_from_uniforms(d, u[..., 0], u[..., 1]).to(torch.float32)
        for d in distributions]).contiguous()
    rd = u[..., 2:].contiguous()
    return sizes, rd, (torch.stack(uss, dim=1).contiguous() if spec_hedge
                       else None)


def _simulate_open_fleet(mu, P, target, rank, arr_t, arr_ty, sizes_c, u_rd,
                         u_spec, modes_np, admit, deadlines, cls, fault,
                         *, order, warmup, qcap, hist, n_steps,
                         telemetry_bins, cuda_graph=False):
    """The open event loop. mu/P (B, k, l) float32, target/rank (B, k, l)
    int64, arr_t (B, T) float32, arr_ty (B, T) int64, sizes_c (D, T, B),
    u_rd (T, B, 2), u_spec (n_steps, B) or None, modes_np (B,) host ints,
    admit (B, C) int64, deadlines (B, C) float32, cls (k,) int64, `fault`
    None or a dict of the FaultBatch tensors. Runs whole chunks of _CHUNK
    iterations — eagerly, or with `cuda_graph` as replays of one captured
    chunk (the same ops, so the same results) — up to n_steps, stopping
    after the first chunk that leaves every point done. Returns a dict of
    the accumulators as device tensors."""
    B, k, l = mu.shape
    T = arr_t.shape[1]
    C = int(cls.max()) + 1
    ns = l * qcap
    nb = hist.n_bins
    lo = float(hist.lo)
    log_g = float(np.log(hist.hi / hist.lo) / hist.n_bins)
    dev = mu.device
    f32, i64 = torch.float32, torch.int64
    has_faults = fault is not None
    spec = u_spec is not None
    cols = torch.arange(l, device=dev)
    cls_c = torch.arange(C, device=dev)[None, :]
    idx_s = torch.arange(ns, device=dev)[None, :]
    mu_flat, P_flat = mu.reshape(B, k * l), P.reshape(B, k * l)
    modes = torch.as_tensor(modes_np, device=dev)
    present = sorted(set(int(m) for m in modes_np))
    stamp_cap = n_steps + _CHUNK + 2    # PRIO key stride > any stamp
    t_warm = (arr_t[:, warmup - 1] if warmup > 0
              else torch.zeros(B, dtype=f32, device=dev))
    t_end = arr_t[:, T - 1]

    def take(x, idx):
        """x (B, n) at idx (B,) -> (B,)."""
        return x.gather(1, idx[:, None])[:, 0]

    def put(x, idx, cond, val):
        """x with x[b, idx[b]] = val[b] where cond[b] (out of place)."""
        cur = take(x, idx)
        return x.scatter(1, idx[:, None],
                         torch.where(cond, val, cur)[:, None])

    def bump(counts, t, j, delta):
        """counts + delta (B,) int at [b, t[b], j[b]]."""
        return counts.view(B, k * l).scatter_add(
            1, (t * l + j)[:, None], delta[:, None]).view(B, k, l)

    def route_one(counts, backlog, t, u, avail=None, tgt=None):
        """Per-point route modes; with `avail` masked to pools that are up
        (deficit routing toward `tgt`, the segment's targets)."""
        return route_modes(present, modes, mu, target, rank, counts,
                           backlog, t, u=u, avail=avail, tgt=tgt)

    def size_for(t, a_idx):
        """The size draw of arrival a_idx (B,) from its class's
        distribution (t (B,) its type)."""
        if sizes_c.shape[0] == 1:
            return sizes_c[0].gather(0, a_idx[None])[0]
        sz = sizes_c.gather(1, a_idx[None, None].expand(
            sizes_c.shape[0], 1, B))[:, 0]               # (D, B)
        return sz.gather(0, cls[t][None])[0]

    if has_faults:
        period, c_age, overhead = (fault["period"], fault["age"],
                                   fault["overhead"])
        p_fin = torch.where(torch.isfinite(period), period, 0.0)

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, val, dtype):
        return torch.full(shape, val, dtype=dtype, device=dev)

    S = dict(now=zeros(B), a_ptr=zeros(B, dtype=i64),
             proc=full((B, ns), -1, i64), types=zeros(B, ns, dtype=i64),
             remaining=full((B, ns), _INF, f32), need=zeros(B, ns),
             size_left=zeros(B, ns), entry=zeros(B, ns),
             stamp=full((B, ns), _BIG_STAMP, i64),
             run_pid=full((B, l), -1, i64), counts=zeros(B, k, l, dtype=i64),
             hist=zeros(B, C, nb), resp_c=zeros(B, C), meas_c=zeros(B, C),
             energy_c=zeros(B, C), dm_c=zeros(B, C), drop_c=zeros(B, C),
             occ=zeros(B, k, l), power=zeros(B), events=zeros(B, dtype=i64),
             pop_warm=zeros(B, dtype=i64), pop_end=zeros(B, dtype=i64))
    if has_faults:
        S.update(sp=zeros(B, dtype=i64), fail_left=zeros(B, ns, dtype=i64),
                 partner=full((B, ns), -1, i64), size0=zeros(B, ns),
                 wasted=zeros(B), failcnt=zeros(B), rrp_s=zeros(B),
                 rrp_n=zeros(B), rr_s=zeros(B), rr_n=zeros(B),
                 rec_on=zeros(B, dtype=torch.bool),
                 rec_pre=zeros(B, dtype=i64), rec_t0=zeros(B),
                 rec_s=zeros(B), rec_n=zeros(B), topo=zeros(B, dtype=i64))
        if spec:
            S["shist"] = zeros(B, k, nb)
        n_faults = fault["times"].shape[1]
    if telemetry_bins:
        nbt = telemetry_bins
        S.update(occ_t=zeros(B, nbt, l), bl_t=zeros(B, nbt, l),
                 pw_t=zeros(B, nbt), hg_t=zeros(B, nbt))
        binw = torch.clamp(t_end, min=1e-30) / nbt
        bins_t = torch.arange(nbt, device=dev)[None, :]

    def onehot(idx, cond):
        """(B, ns) mask of slot idx[b] where cond[b]."""
        return (idx_s == idx[:, None]) & cond[:, None]

    def step(S, i):
        now, a_ptr, proc, types = S["now"], S["a_ptr"], S["proc"], S["types"]
        remaining, need, size_left = S["remaining"], S["need"], S["size_left"]
        entry, stamp, run_pid = S["entry"], S["stamp"], S["run_pid"]
        counts = S["counts"]
        if has_faults:
            sp = S["sp"]
            sc = segment_rows(fault["scale"], sp)        # (B, l)
            avail = sc > 0.0
            sc_safe = torch.where(avail, sc, 1.0)
            tgt_cur = segment_rows(fault["seg"], sp)     # (B, k, l)
        active = proc >= 0
        proc_safe = torch.clamp(proc, min=0)
        mask = proc[:, :, None] == cols                  # (B, ns, l)
        cnt = mask.sum(dim=1)                            # (B, l)
        cntf = cnt.to(f32)
        cnt_safe = torch.clamp(cntf, min=1.0)
        busy = (cnt > 0) & avail if has_faults else cnt > 0
        if has_faults:
            sc_res = sc.gather(1, proc_safe)             # (B, ns)
        if order == "PS":
            rem_min = torch.where(mask, remaining[:, :, None],
                                  _INF).amin(dim=1)
            p_res = P_flat.gather(1, types * l + proc_safe)
            cnt_res = cnt_safe.gather(1, proc_safe)
            if has_faults:
                dtj = torch.where(busy, rem_min * cntf / sc_safe, _INF)
                pw = torch.where(active, p_res * sc_res / cnt_res,
                                 0.0).sum(dim=1)
            else:
                dtj = torch.where(busy, rem_min * cntf, _INF)
                pw = torch.where(active, p_res / cnt_res, 0.0).sum(dim=1)
        else:
            if order == "PRIO":         # the sticky running task
                head = torch.clamp(run_pid, min=0)
            else:                       # FCFS: the oldest resident
                head = torch.argmin(torch.where(mask, stamp[:, :, None],
                                                _BIG_STAMP), dim=1)
            rem_h = remaining.gather(1, head)
            p_h = P_flat.gather(1, types.gather(1, head) * l + cols)
            if has_faults:
                dtj = torch.where(busy, rem_h / sc_safe, _INF)
                pw = torch.where(cnt > 0, p_h * sc, 0.0).sum(dim=1)
            else:
                dtj = torch.where(busy, rem_h, _INF)
                pw = torch.where(cnt > 0, p_h, 0.0).sum(dim=1)
        j_star = torch.argmin(dtj, dim=1)
        dt_c = take(dtj, j_star)
        a_idx = torch.clamp(a_ptr, max=T - 1)
        has_arr = a_ptr < T
        ta = torch.where(has_arr, take(arr_t, a_idx), _INF)
        if has_faults:
            if n_faults > 0:
                tf = torch.where(sp < n_faults, take(
                    fault["times"], torch.clamp(sp, max=n_faults - 1)), _INF)
            else:
                tf = torch.full_like(now, _INF)
            # fault first on exact ties; only faults inside the horizon
            # fire (the host loop exits after the last arrival)
            do_fault = (torch.isfinite(tf) & (tf <= ta)
                        & (tf - now <= dt_c) & (tf <= t_end))
            do_arr = ~do_fault & has_arr & (ta - now <= dt_c)
            do_comp = ~do_fault & ~do_arr & torch.isfinite(dt_c)
            dt = torch.where(do_fault, tf - now, torch.where(
                do_arr, ta - now, torch.where(do_comp, dt_c, 0.0)))
        else:
            do_arr = has_arr & (ta - now <= dt_c)   # arrival first on tie
            do_comp = ~do_arr & torch.isfinite(dt_c)
            dt = torch.where(do_arr, ta - now,
                             torch.where(do_comp, dt_c, 0.0))
        new_now = now + dt
        # time integrals over the overlap with the window [t_warm, t_end]
        ow = torch.clamp(torch.minimum(new_now, t_end)
                         - torch.maximum(now, t_warm), min=0.0)
        N = dict(occ=S["occ"] + ow[:, None, None] * counts.to(f32),
                 power=S["power"] + ow * pw)
        if telemetry_bins:
            # pre-event state over [now, new_now) clipped at t_end, charged
            # to the bin holding the interval start (the host convention)
            wb = telemetry_bin_weights(now, torch.clamp(
                torch.minimum(new_now, t_end) - now, min=0.0), binw, bins_t)
            bl_pre = torch.where(mask, size_left[:, :, None],
                                 0.0).sum(dim=1)
            hg = ((active & (S["partner"] >= 0)).to(f32).sum(dim=1)
                  if has_faults else torch.zeros_like(now))
            N["occ_t"] = S["occ_t"] + wb[:, :, None] * cntf[:, None]
            N["bl_t"] = S["bl_t"] + wb[:, :, None] * bl_pre[:, None]
            N["pw_t"] = S["pw_t"] + wb * pw[:, None]
            N["hg_t"] = S["hg_t"] + wb * hg[:, None]
        now = new_now

        # ---- deplete in-service tasks over dt ----
        if order == "PS":
            dep = torch.where(active, (dt[:, None] * sc_res if has_faults
                                       else dt[:, None]) / cnt_res, 0.0)
        else:
            is_run = active & (head.gather(1, proc_safe) == idx_s)
            dep = torch.where(is_run, dt[:, None] * sc_res if has_faults
                              else dt[:, None], 0.0)
        remaining = remaining - dep
        frac = torch.where(need > 0, dep / need, 0.0)
        size_left = torch.clamp(size_left - frac * size_left, min=0.0)

        # ---- completion branch (identity unless do_comp) ----
        if order == "PS":
            pid = torch.argmin(torch.where(proc == j_star[:, None],
                                           remaining, _INF), dim=1)
        else:
            pid = take(head, j_star)
        t_done = take(types, pid)
        c_done = cls[t_done]
        if has_faults:
            # transient failure: the attempt completes but fails, and the
            # task re-executes from its last checkpoint on the same pool
            fail_left = S["fail_left"]
            fail_now = do_comp & (take(fail_left, pid) > 0)
            succ = do_comp & ~fail_now
        else:
            succ = do_comp
        wf = (succ & (now > t_warm) & (now <= t_end)).to(f32)
        resp = now - take(entry, pid)
        b = torch.clamp(torch.floor(torch.log(torch.clamp(resp, min=1e-30)
                                              / lo) / log_g),
                        0, nb - 1).to(i64)
        N["hist"] = S["hist"].view(B, C * nb).scatter_add(
            1, (c_done * nb + b)[:, None], wf[:, None]).view(B, C, nb)
        need_pid = take(need, pid)
        oh_c = cls_c == c_done[:, None]                  # (B, C)
        N["resp_c"] = S["resp_c"] + torch.where(oh_c, (wf * resp)[:, None],
                                                0.0)
        N["meas_c"] = S["meas_c"] + torch.where(oh_c, wf[:, None], 0.0)
        N["energy_c"] = S["energy_c"] + torch.where(oh_c, (
            wf * take(P_flat, t_done * l + j_star) * need_pid)[:, None], 0.0)
        N["dm_c"] = S["dm_c"] + torch.where(oh_c, (wf * (
            resp <= take(deadlines, c_done)).to(f32))[:, None], 0.0)
        counts = bump(counts, t_done, j_star, -succ.to(i64))
        if order == "PRIO":
            # next head BEFORE freeing the slot: the oldest waiting task of
            # the best class present on j_star, the finisher excluded
            waiting = (proc == j_star[:, None]) & (idx_s != pid[:, None])
            nxt = torch.argmin(torch.where(waiting, cls[types] * stamp_cap
                                           + stamp, _BIG_STAMP), dim=1)
            run_pid = put(run_pid, j_star, succ,
                          torch.where(waiting.any(dim=1), nxt, -1))
        oh_pid = idx_s == pid[:, None]
        oh_s = oh_pid & succ[:, None]
        if has_faults:
            inw_t = (now > t_warm) & (now <= t_end)
            partner, size0 = S["partner"], S["size0"]
            if spec:
                # the running per-type service estimator learns every
                # successful completion, windowed or not (as the host)
                N["shist"] = S["shist"].view(B, k * nb).scatter_add(
                    1, (t_done * nb + b)[:, None],
                    succ.to(f32)[:, None]).view(B, k, nb)
            # failed attempt: the full service was done, then lost back to
            # the last checkpoint (the host's restart(pid, need))
            pres_f = ckpt_preserved(need_pid, period, c_age, p_fin)
            newrem_f = need_pid - pres_f + overhead
            fw = fail_now & inw_t
            wasted = S["wasted"] + torch.where(fw, need_pid - pres_f, 0.0)
            N["failcnt"] = S["failcnt"] + fw.to(f32)
            oh_f = oh_pid & fail_now[:, None]
            fail_left = fail_left - oh_f.to(i64)
            remaining = torch.where(oh_f, newrem_f[:, None], remaining)
            size_left = torch.where(oh_f, (take(size0, pid) * torch.clamp(
                newrem_f / torch.clamp(need_pid, min=1e-30), 0.0, 1.0)
            )[:, None], size_left)
            # hedge partner: first completion wins; cancel the loser and
            # charge its finished work as wasted
            pt = take(partner, pid)
            pt_s = torch.clamp(pt, min=0)
            has_pt = succ & (pt >= 0)
            jb = torch.clamp(take(proc, pt_s), min=0)
            done_b = torch.clamp(take(need, pt_s) - take(remaining, pt_s),
                                 min=0.0)
            wasted = wasted + torch.where(has_pt & inw_t, done_b, 0.0)
            counts = bump(counts, take(types, pt_s), jb, -has_pt.to(i64))
            oh_pt = onehot(pt_s, has_pt)
            if order == "PRIO":
                was_head = has_pt & (take(run_pid, jb) == pt)
                waiting_b = (proc == jb[:, None]) & ~oh_pt & ~oh_s
                nxt_b = torch.argmin(torch.where(
                    waiting_b, cls[types] * stamp_cap + stamp, _BIG_STAMP),
                    dim=1)
                run_pid = put(run_pid, jb, was_head,
                              torch.where(waiting_b.any(dim=1), nxt_b, -1))
            gone = oh_s | oh_pt             # finisher and cancelled partner
            partner = torch.where(gone, -1, partner)
            # re-route latency flush + recovery-time hit on success
            succ_w = succ & (now <= t_end)
            rrp_s, rrp_n = S["rrp_s"], S["rrp_n"]
            flush = succ_w & (rrp_n > 0)
            N["rr_s"] = S["rr_s"] + torch.where(flush, now * rrp_n - rrp_s,
                                                0.0)
            N["rr_n"] = S["rr_n"] + torch.where(flush, rrp_n, 0.0)
            rrp_s = torch.where(flush, 0.0, rrp_s)
            rrp_n = torch.where(flush, 0.0, rrp_n)
            rec_on, rec_pre, rec_t0 = S["rec_on"], S["rec_pre"], S["rec_t0"]
            rec_hit = succ_w & rec_on & (counts.sum(dim=(1, 2)) <= rec_pre)
            N["rec_s"] = S["rec_s"] + torch.where(rec_hit, now - rec_t0, 0.0)
            N["rec_n"] = S["rec_n"] + rec_hit.to(f32)
            rec_on = rec_on & ~rec_hit
        else:
            gone = oh_s
        proc = torch.where(gone, -1, proc)
        remaining = torch.where(gone, _INF, remaining)
        need = torch.where(gone, 0.0, need)
        size_left = torch.where(gone, 0.0, size_left)
        stamp = torch.where(gone, _BIG_STAMP, stamp)

        if has_faults:
            # ---- fault-event branch (identity unless do_fault) ----
            sp_new = sp + do_fault.to(i64)
            sc_next = segment_rows(fault["scale"], sp_new)
            crash_col = do_fault[:, None] & (sc > 0.0) & (sc_next <= 0.0)
            hit = (proc >= 0) & crash_col.gather(1, torch.clamp(proc, min=0))
            done_t = torch.clamp(need - remaining, min=0.0)
            pres_t = ckpt_preserved(done_t, period[:, None],
                                    c_age[:, None], p_fin[:, None])
            newrem_t = need - pres_t + overhead[:, None]
            wasted = wasted + torch.where(
                inw_t, torch.where(hit, done_t - pres_t, 0.0).sum(dim=1),
                0.0)
            remaining = torch.where(hit, newrem_t, remaining)
            size_left = torch.where(hit, size0 * torch.clamp(
                newrem_t / torch.clamp(need, min=1e-30), 0.0, 1.0),
                size_left)
            any_crash = do_fault & crash_col.any(dim=1)
            N["topo"] = S["topo"] + any_crash.to(i64)
            rrp_s = rrp_s + torch.where(any_crash, now, 0.0)
            rrp_n = rrp_n + any_crash.to(f32)
            start_rec = any_crash & ~rec_on
            N["rec_pre"] = torch.where(start_rec, counts.sum(dim=(1, 2)),
                                       rec_pre)
            N["rec_t0"] = torch.where(start_rec, now, rec_t0)
            N["rec_on"] = rec_on | start_rec
            N["rrp_s"], N["rrp_n"] = rrp_s, rrp_n
            N["sp"] = sp_new

        # ---- arrival branch (identity unless do_arr; the branches are
        # exclusive, so the post-completion state is the pre-state here) ----
        t_new = take(arr_ty, a_idx)
        c_new = cls[t_new]
        backlog = torch.where(proc[:, :, None] == cols, size_left[:, :, None],
                              0.0).sum(dim=1)
        u_arr = u_rd.gather(0, a_idx[None, :, None].expand(1, B, 2))[0]
        if has_faults:
            j_new = route_one(counts, backlog, t_new, u_arr[:, 0], avail,
                              tgt_cur)
            ok_route = avail.any(dim=1)
        else:
            j_new = route_one(counts, backlog, t_new, u_arr[:, 0])
            ok_route = torch.ones_like(has_arr)
        limit_c = take(admit, c_new)
        ok = ((counts.sum(dim=(1, 2)) < limit_c)
              & (take(counts.sum(dim=1), j_new) < qcap) & ok_route)
        admit_ok = do_arr & ok
        N["drop_c"] = S["drop_c"] + torch.where(
            cls_c == c_new[:, None],
            (do_arr & ~ok & (a_ptr >= warmup)).to(f32)[:, None], 0.0)
        slot = torch.argmin(proc, dim=1)        # the lowest free (-1) slot
        s_new = size_for(t_new, a_idx)
        sn = s_new / take(mu_flat, t_new * l + j_new)
        counts = bump(counts, t_new, j_new, admit_ok.to(i64))
        oh_a = onehot(slot, admit_ok)
        proc = torch.where(oh_a, j_new[:, None], proc)
        types = torch.where(oh_a, t_new[:, None], types)
        remaining = torch.where(oh_a, sn[:, None], remaining)
        need = torch.where(oh_a, sn[:, None], need)
        size_left = torch.where(oh_a, s_new[:, None], size_left)
        entry = torch.where(oh_a, now[:, None], entry)
        stamp = torch.where(oh_a, i[:, None], stamp)
        if order == "PRIO":
            run_pid = put(run_pid, j_new,
                          admit_ok & (take(run_pid, j_new) < 0), slot)
        if has_faults:
            size0 = torch.where(oh_a, s_new[:, None], size0)
            f_new = take(fault["fail"], a_idx)
            fail_left = torch.where(oh_a, f_new[:, None], fail_left)
            # hedged backup: same size, another pool, admitted only if the
            # shed cap and a queue slot still allow it
            want = admit_ok & (take(fault["hedge"], c_new) > 0)
            avail2 = avail & (cols != j_new[:, None])
            j2 = route_one(counts, backlog, t_new, u_arr[:, 1], avail2,
                           tgt_cur)
            slot2 = torch.argmin(proc, dim=1)   # next free slot
            hedge_ok = (want & avail2.any(dim=1)
                        & (counts.sum(dim=(1, 2)) < limit_c)
                        & (take(counts.sum(dim=1), j2) < qcap)
                        & (take(proc, slot2) < 0))
            sn2 = s_new / take(mu_flat, t_new * l + j2)
            counts = bump(counts, t_new, j2, hedge_ok.to(i64))
            oh_h = onehot(slot2, hedge_ok)
            proc = torch.where(oh_h, j2[:, None], proc)
            types = torch.where(oh_h, t_new[:, None], types)
            remaining = torch.where(oh_h, sn2[:, None], remaining)
            need = torch.where(oh_h, sn2[:, None], need)
            size_left = torch.where(oh_h, s_new[:, None], size_left)
            size0 = torch.where(oh_h, s_new[:, None], size0)
            entry = torch.where(oh_h, now[:, None], entry)
            stamp = torch.where(oh_h, i[:, None], stamp)
            fail_left = torch.where(oh_h, f_new[:, None], fail_left)
            partner = torch.where(oh_a, torch.where(hedge_ok, slot2, -1)
                                  [:, None], partner)
            partner = torch.where(oh_h, slot[:, None], partner)
            if order == "PRIO":
                run_pid = put(run_pid, j2,
                              hedge_ok & (take(run_pid, j2) < 0), slot2)
            if spec:
                # ---- straggler-triggered speculative backup (at most one
                # per iteration): an unpaired in-flight task whose age
                # crossed the observed hq-quantile of its type's response
                # times gets a late-binding backup on another pool ----
                shist = N["shist"]
                th_k = hist_quantile_rows_torch(shist, fault["hq"][:, None],
                                                lo, log_g)
                th_k = torch.where((fault["hq"] > 0.0)[:, None]
                                   & (shist.sum(dim=2)
                                      >= fault["hmin"][:, None]),
                                   th_k, _INF)
                # post-event availability (sp already advanced on fault
                # iterations: no backup lands on a pool that just crashed)
                avail3 = segment_rows(fault["scale"], sp_new) > 0.0
                tgt3 = segment_rows(fault["seg"], sp_new)
                score = torch.where((proc >= 0) & (partner < 0),
                                    (now[:, None] - entry)
                                    - th_k.gather(1, types), -_INF)
                pid3 = torch.argmax(score, dim=1)
                t3 = take(types, pid3)
                avail3 = avail3 & (cols != torch.clamp(
                    take(proc, pid3), min=0)[:, None])
                backlog3 = torch.where(proc[:, :, None] == cols,
                                       size_left[:, :, None], 0.0).sum(dim=1)
                j3 = route_one(counts, backlog3, t3, u_spec.index_select(
                    0, torch.clamp(i, max=u_spec.shape[0] - 1))[0],
                    avail3, tgt3)
                slot3 = torch.argmin(proc, dim=1)
                launch = ((take(score, pid3) > 0.0) & avail3.any(dim=1)
                          & (take(proc, slot3) < 0)
                          & (counts.sum(dim=(1, 2)) < take(admit, cls[t3]))
                          & (take(counts.sum(dim=1), j3) < qcap))
                s3 = take(size0, pid3)
                sn3 = s3 / take(mu_flat, t3 * l + j3)
                counts = bump(counts, t3, j3, launch.to(i64))
                oh_3 = onehot(slot3, launch)
                proc = torch.where(oh_3, j3[:, None], proc)
                types = torch.where(oh_3, t3[:, None], types)
                remaining = torch.where(oh_3, sn3[:, None], remaining)
                need = torch.where(oh_3, sn3[:, None], need)
                size_left = torch.where(oh_3, s3[:, None], size_left)
                size0 = torch.where(oh_3, s3[:, None], size0)
                # the backup inherits the primary's arrival, so the
                # winner's response is the end-to-end one; speculative
                # attempts are exempt from transient failures
                entry = torch.where(oh_3, take(entry, pid3)[:, None], entry)
                stamp = torch.where(oh_3, i[:, None], stamp)
                fail_left = torch.where(oh_3, 0, fail_left)
                partner = torch.where(oh_3, pid3[:, None], partner)
                partner = torch.where(onehot(pid3, launch), slot3[:, None],
                                      partner)
                if order == "PRIO":
                    run_pid = put(run_pid, j3,
                                  launch & (take(run_pid, j3) < 0), slot3)
            N.update(fail_left=fail_left, partner=partner, size0=size0,
                     wasted=wasted)
        # events handled, and the population after the last event at or
        # before t_warm / t_end (the window's conservation books)
        pop = counts.sum(dim=(1, 2))
        event = do_arr | do_comp | do_fault if has_faults else do_arr | do_comp
        N.update(now=now, a_ptr=a_ptr + do_arr.to(i64), proc=proc,
                 types=types, remaining=remaining, need=need,
                 size_left=size_left, entry=entry, stamp=stamp,
                 run_pid=run_pid, counts=counts,
                 events=S["events"] + event.to(i64),
                 pop_warm=torch.where(now <= t_warm, pop, S["pop_warm"]),
                 pop_end=torch.where(now <= t_end, pop, S["pop_end"]))
        return N

    def live(S):
        """Whether any point is still before its last arrival or its clock
        at or before t_end: later events change nothing in the window."""
        return bool(((S["a_ptr"] < T) | (S["now"] <= t_end)).any())

    i_t = torch.zeros((1,), dtype=i64, device=dev)
    steps = 0
    if cuda_graph:
        # replay one captured chunk of _CHUNK iterations: the same step,
        # its outputs copied back into the static state tensors (warmed up
        # on a copy of the state, which is then dropped)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step({n: v.clone() for n, v in S.items()}, i_t.clone())
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(_CHUNK):
                for n, v in step(S, i_t).items():
                    S[n].copy_(v)
                i_t.add_(1)
        while steps < n_steps:
            graph.replay()
            steps += _CHUNK
            if not live(S):
                break
    else:
        while steps < n_steps:
            for _ in range(_CHUNK):
                S = step(S, i_t)
                i_t = i_t + 1
            steps += _CHUNK
            if not live(S):
                break
    S["t_warm"], S["t_end"], S["steps"] = t_warm, t_end, steps
    return S


def simulate_open_batch(mu, targets, arr_times, arr_types, seeds, *,
                        distribution, queue_capacity, order="PS",
                        warmup_arrivals=0,
                        power: PowerModel = PROPORTIONAL_POWER, modes=None,
                        class_of_type=None, class_distributions=None,
                        admit_limits=None, hist: LogHistogram | None = None,
                        deadlines=None, faults=None, telemetry_bins=0,
                        device=None, cuda_graph=None):
    """Simulate B open networks in one batched run on the device.

    mu: (k, l) shared or (B, k, l); targets: (B, k, l) reference placements
    (deficit points; baseline points ignore their rows); arr_times (B, T)
    sorted absolute arrival times with arr_types (B, T) type rows (both
    pre-sampled on the host, e.g. `TrafficSpec.sample`); seeds (B,) feed
    the size streams; modes (B,) route modes as in
    `repro_torch.sim.engine_torch.simulate_batch`. `admit_limits` ((C,) or
    (B, C)) are the in-system shed caps (default: no shedding),
    `deadlines` ((C,) or (B, C)) the SLO deadline per class (default
    +inf).

    Returns a dict of NumPy arrays: the closed engine's metrics plus the
    open extras offered / dropped (B,), class_dropped (B, C), class_hist
    (B, C, n_bins), class_quantiles (B, C, 3) — p50/p99/p999 recovered
    from the histogram within `hist.rel_error_bound` — and
    class_deadline_met (B, C); "steps" is the number of loop iterations
    run, "events" (B,) the events each point handled, and in_system_warm /
    in_system_end (B,) the population just after the last event at or
    before t_warm / t_end, so that offered - dropped - completed ==
    in_system_end - in_system_warm for runs without hedged copies.

    `faults` (a `repro_torch.faults.FaultBatch` built with mode="open",
    n_arrivals=T and n_classes=C) turns on the fault stanzas and adds the
    goodput / wasted_work / failures / topology_events / reroute_latency /
    recovery_time rows. `telemetry_bins` > 0 adds res["telemetry"]: raw
    dt-weighted integrals of per-pool occupancy / backlog (B, nb, l), total
    power and in-flight hedges (B, nb) over nb equal bins of [0, t_end],
    plus bin_width / horizon (B,) (`repro_torch.obs.telemetry_series`
    turns them into time averages).

    `cuda_graph` (default: True on the card) replays the loop body from a
    captured CUDA graph in chunks instead of launching its ops one by one;
    the ops, and so the results, are the eager loop's. It needs a CUDA
    device.
    """
    dev = resolve_device(device)
    if cuda_graph is None:
        cuda_graph = dev.type == "cuda"
    if cuda_graph and dev.type != "cuda":
        raise ValueError("cuda_graph needs a CUDA device")
    if telemetry_bins < 0:
        raise ValueError("telemetry_bins must be >= 0")
    targets = np.asarray(targets)
    B, k, l = targets.shape
    mu = np.asarray(mu, dtype=np.float64)
    mus = np.broadcast_to(mu, (B, k, l)) if mu.ndim == 2 else mu
    if mus.shape != (B, k, l):
        raise ValueError(f"mu must be (k, l) or (B, k, l); got {mu.shape}")
    arr_times = np.asarray(arr_times, dtype=np.float64)
    arr_types = np.asarray(arr_types, dtype=np.int64)
    if arr_times.ndim != 2 or arr_times.shape[0] != B:
        raise ValueError(f"arr_times must be (B, T); got {arr_times.shape}")
    if arr_types.shape != arr_times.shape:
        raise ValueError("arr_types must match arr_times")
    if len(seeds) != B:
        raise ValueError(f"need {B} seeds; got {len(seeds)}")
    T = arr_times.shape[1]
    if not 0 <= warmup_arrivals < T:
        raise ValueError("need 0 <= warmup_arrivals < T")
    if order not in ("PS", "FCFS", "PRIO"):
        raise ValueError(f"unknown order {order!r}: PS | FCFS | PRIO")
    if queue_capacity < 1:
        raise ValueError("queue_capacity must be >= 1")
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
    ns = int(l * queue_capacity)
    admit = (np.full((B, C), ns, dtype=np.int64) if admit_limits is None
             else np.broadcast_to(np.asarray(admit_limits, dtype=np.int64),
                                  (B, C)))
    admit = np.clip(admit, 0, ns)
    dl = (np.full((B, C), np.inf) if deadlines is None
          else np.broadcast_to(np.asarray(deadlines, dtype=np.float64),
                               (B, C)))
    hist = hist if hist is not None else LogHistogram()
    if mu.ndim == 2:
        P = np.broadcast_to(power.power_matrix(mu), (B, k, l))
        ranks = np.broadcast_to(_mu_tiebreak_ranks(mu), (B, k, l))
    else:
        P = np.stack([power.power_matrix(m) for m in mus])
        ranks = np.stack([_mu_tiebreak_ranks(m) for m in mus])

    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)

    def i64(a):
        return torch.as_tensor(np.array(a, dtype=np.int64), device=dev)

    fault, n_steps, spec = None, 2 * T, False
    if faults is not None:
        if faults.fail_counts is None or faults.hedge is None:
            raise ValueError("open-mode FaultBatch required "
                             "(build_fault_batch(..., mode='open'))")
        if faults.times.shape[0] != B or faults.scale.shape[2] != l:
            raise ValueError("FaultBatch batch/pool dims do not match")
        if faults.fail_counts.shape != (B, T):
            raise ValueError(f"fail_counts must be (B, T); got "
                             f"{faults.fail_counts.shape}")
        if faults.hedge.shape[1] != C:
            raise ValueError(f"hedge must be (B, {C})")
        n_steps = 2 * T + int(faults.extra_steps)
        hq = (np.asarray(faults.hedge_q, np.float64)
              if faults.hedge_q is not None else np.zeros(B))
        spec = bool((hq > 0.0).any())
        fault = {
            "times": f32(faults.times), "scale": f32(faults.scale),
            "seg": i64(faults.seg_targets), "fail": i64(faults.fail_counts),
            "hedge": i64(faults.hedge), "period": f32(faults.ckpt_period),
            "age": f32(faults.ckpt_age if faults.ckpt_age is not None
                       else np.zeros(B)),
            "overhead": f32(faults.restart_overhead), "hq": f32(hq),
            "hmin": f32(faults.hedge_min if faults.hedge_min is not None
                        else np.ones(B))}
    sizes_c, u_rd, u_spec = _open_draws(seeds, T, n_steps, dists, dev, spec)
    S = _simulate_open_fleet(
        f32(mus), f32(P), i64(targets), i64(ranks), f32(arr_times),
        i64(arr_types), sizes_c, u_rd, u_spec, modes, i64(admit), f32(dl),
        i64(cls), fault, order=order, warmup=int(warmup_arrivals),
        qcap=int(queue_capacity), hist=hist, n_steps=n_steps,
        telemetry_bins=int(telemetry_bins), cuda_graph=cuda_graph)

    def host(x):
        return x.cpu().numpy().astype(np.float64)
    h, meas_c, resp_c, energy_c, dm_c, drop_c = (
        host(S[n]) for n in ("hist", "meas_c", "resp_c", "energy_c", "dm_c",
                             "drop_c"))
    elapsed = host(S["t_end"] - S["t_warm"])
    occ, power_int = host(S["occ"]), host(S["power"])
    measured = meas_c.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        x = np.where(elapsed > 0, measured / elapsed, 0.0)
        et = np.where(measured > 0, resp_c.sum(1) / np.maximum(measured, 1.0),
                      np.inf)
        ee = np.where(measured > 0,
                      energy_c.sum(1) / np.maximum(measured, 1.0), np.inf)
        cls_x = meas_c / elapsed[:, None]
        cls_rt = np.where(meas_c > 0, resp_c / np.maximum(meas_c, 1.0),
                          np.inf)
        cls_ee = np.where(meas_c > 0, energy_c / np.maximum(meas_c, 1.0),
                          np.inf)
        cls_dm = np.where(meas_c > 0, dm_c / np.maximum(meas_c, 1.0), 0.0)
    occ = occ / np.maximum(elapsed, 1e-12)[:, None, None]
    cls_occ = np.zeros((B, C, l))
    np.add.at(cls_occ, (slice(None), cls), occ)
    quants = np.stack([hist.quantiles(h[b], QUANTILES) for b in range(B)])
    res = {"throughput": x, "mean_response_time": et, "mean_energy": ee,
           "edp": ee * et, "little_product": x * et,
           "completed": measured.astype(np.int64), "elapsed": elapsed,
           "state_occupancy": occ,
           "mean_power": power_int / np.maximum(elapsed, 1e-12),
           "class_throughput": cls_x, "class_response_time": cls_rt,
           "class_energy": cls_ee, "class_occupancy": cls_occ,
           "offered": np.full(B, T - warmup_arrivals, dtype=np.int64),
           "dropped": drop_c.sum(1).astype(np.int64),
           "class_dropped": drop_c.astype(np.int64),
           "class_hist": h, "class_quantiles": quants,
           "class_deadline_met": cls_dm, "steps": int(S["steps"]),
           "events": S["events"].cpu().numpy(),
           "in_system_warm": S["pop_warm"].cpu().numpy(),
           "in_system_end": S["pop_end"].cpu().numpy(), "device": str(dev)}
    if fault is not None:
        wasted, failcnt, rr_s, rr_n, rec_s, rec_n, topo = (
            host(S[n]) for n in ("wasted", "failcnt", "rr_s", "rr_n",
                                 "rec_s", "rec_n", "topo"))
        # a recovery still open at the horizon is censored at t_end
        rec_on = S["rec_on"].cpu().numpy()
        rec_s = rec_s + np.where(rec_on, np.maximum(
            host(S["t_end"] - S["rec_t0"]), 0.0), 0.0)
        rec_n = rec_n + rec_on
        el = np.maximum(elapsed, 1e-12)
        with np.errstate(divide="ignore", invalid="ignore"):
            res["goodput"] = x
            res["wasted_work"] = wasted / el
            res["failures"] = failcnt.astype(np.int64)
            res["topology_events"] = topo.astype(np.int64)
            res["reroute_latency"] = np.where(
                rr_n > 0, rr_s / np.maximum(rr_n, 1.0), np.nan)
            res["recovery_time"] = np.where(
                rec_n > 0, rec_s / np.maximum(rec_n, 1.0), np.nan)
    if telemetry_bins:
        horizon = arr_times[:, -1].astype(np.float64)
        res["telemetry"] = {
            "occupancy": host(S["occ_t"]), "backlog": host(S["bl_t"]),
            "power": host(S["pw_t"]), "hedges": host(S["hg_t"]),
            "horizon": horizon, "bin_width": horizon / telemetry_bins}
    return res


def simulate_open_policy(cfg, policy, device=None,
                         telemetry_bins: int = 0) -> SimMetrics:
    """One open-network run of `cfg` (`cfg.traffic` set, `cfg.faults`
    optional) under `policy` (a registry name, Policy or SchedulerCore) on
    the device: the open counterpart of
    `repro_torch.sim.engine_torch.simulate_policy`, returning the host
    core's SimMetrics fields with quantiles from the device histogram.
    Refreshed fault targets are solved on `device` too."""
    dev = resolve_device(device)
    tr = cfg.traffic
    if tr is None:
        raise ValueError("simulate_open_policy needs cfg.traffic")
    pol = _policy_of(policy)
    mu = np.asarray(cfg.mu, dtype=np.float64)
    mix = np.asarray(cfg.n_programs_per_type, dtype=np.int64)
    mode = _device_route_mode(pol)
    target = (np.asarray(pol.solve_target(mu, mix))
              if mode == MODE_DEFICIT else np.zeros(mu.shape, np.int64))
    times, tys = tr.spec.sample(cfg.seed, tr.n_arrivals)
    cls = (np.zeros(mu.shape[0], np.int64) if cfg.class_of_type is None
           else np.asarray(cfg.class_of_type, np.int64))
    faults = None
    if cfg.faults is not None and not cfg.faults.is_null:
        from repro_torch.faults.device import build_fault_batch
        faults = build_fault_batch(
            [cfg.faults], mu, target[None], seeds=[cfg.seed], mode="open",
            policies=[pol], mixes=mix[None], n_arrivals=tr.n_arrivals,
            n_classes=int(cls.max()) + 1, device=dev)
    out = simulate_open_batch(
        mu, target[None], times[None], tys[None], [cfg.seed],
        distribution=cfg.distribution, queue_capacity=tr.queue_capacity,
        order=cfg.order, warmup_arrivals=tr.warmup_arrivals,
        power=cfg.power, modes=[mode], class_of_type=cfg.class_of_type,
        class_distributions=cfg.class_distributions,
        admit_limits=tr.resolved_admit_limits(mu.shape[1])[None],
        hist=tr.hist,
        deadlines=(tr.resolved_deadlines()[None]
                   if tr.deadlines is not None else None),
        faults=faults, telemetry_bins=telemetry_bins, device=dev)
    return open_metrics_row(out, 0, track_deadlines=tr.deadlines is not None)


def open_metrics_row(out: dict, i: int,
                     track_deadlines: bool = True) -> SimMetrics:
    """One batch row of a `simulate_open_batch` result as SimMetrics."""
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
        class_occupancy=out["class_occupancy"][i],
        offered=int(out["offered"][i]), dropped=int(out["dropped"][i]),
        class_dropped=out["class_dropped"][i],
        class_quantiles=out["class_quantiles"][i],
        class_deadline_met=(out["class_deadline_met"][i]
                            if track_deadlines else None),
        **fault_fields(out, i))


__all__ = ["simulate_open_batch", "simulate_open_policy", "open_metrics_row"]
