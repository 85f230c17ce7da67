#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `src/repro_torch/kernels/csrc` (one
nvcc per source, all started together), holds each against its plain
PyTorch version on the card at the shapes its path gives it, then drives
the port's paths through the entry points a user calls, each with the
launch counts set to 0 just before it and read just after:

  * scheduling — the batched GrIn target solver on (mu x mix) grids, a
    `SchedulerCore` routing bursts and pricing elastic what-ifs, and the
    batched closed-network engine comparing policies on the paper's Fig. 9
    workload (block-move scorer kernel);
  * serving — zamba2-7b at full width and depth (81 Mamba2 layers, a shared
    attention block applied 13 times, d_model 3584; random weights from a
    seed) in a `ServeEngine`: 4 prompts of 8192 tokens and 64 greedy decode
    steps (flash-attention and SSD-scan kernels), a decode-vs-forward check,
    then CAB against LB over two pools of that engine in virtual time;
  * `ops.rmsnorm`, the RMSNorm kernel's only entry point;

and checks each result by the repository's own means. It prints the card's
name and power limit, one JSON line describing every kernel (launches on
its path, error against the plain version, times and bounds), and last a
JSON status line.
Details go to `chiprun_out/chip_smoke_detail.json`. Exits non-zero, with no
result lines, when there is no CUDA device, when the repository is not
beside the script, or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12              # H100 SXM float32, non-tensor (data sheet)
BF16_OPS_PER_S = 989e12             # H100 SXM bf16 tensor cores, dense
GAIN_TOL = 1e-5                     # gains: |kernel - plain| <= tol*(1+|g|)
K, L, N_TASKS = 4, 6, 6000          # the solver benchmark's 4x6, N = 6000


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _ladder_len(total: int) -> int:
    import math
    return max(1, min(24, math.ceil(math.log2(max(total, 2))) + 1))


# ---------------------------------------------------------------- helpers

def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_busy(fn) -> dict:
    """Run fn() once under torch.profiler: wall seconds, summed device
    kernel seconds, the busy share, and the top kernels by device time.
    The profiler's own host overhead inflates the wall time, so the share
    is a lower bound. Device fields are None if the trace shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    from torch.autograd import DeviceType
    events = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(us for _, us, _ in events) / 1e6
    top = sorted(events, key=lambda e: -e[1])[:6]
    return {"wall_s": wall, "device_s": total or None,
            "busy_share": (total / wall) if total else None,
            "top": [{"kernel": k[:80], "device_s": us / 1e6, "calls": n}
                    for k, us, n in top if us > 0]}


def skewed_grid(seed: int, G: int, M: int, k: int, l: int, n: int):
    """(G, k, l) affinities and (M, k) Dirichlet(0.3)-skewed mixes of n
    tasks — the reference solver benchmark's workload."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mus = rng.uniform(1.0, 30.0, size=(G, k, l))
    mixes = np.array([rng.multinomial(n, p)
                      for p in rng.dirichlet([0.3] * k, size=M)])
    return mus, mixes


def scorer_states(seed: int, B: int, k: int, l: int, n: int, dev):
    """B placements as the solver meets them: skewed mixes of n tasks, each
    row spread over the columns; float32 N, mu, P (alpha = 0.5) on dev."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    mus = rng.uniform(1.0, 30.0, size=(B, k, l))
    mixes = [rng.multinomial(n, p) for p in rng.dirichlet([0.3] * k, size=B)]
    N = np.stack([np.stack([rng.multinomial(int(c), rng.dirichlet([0.5] * l))
                            for c in mix]) for mix in mixes])
    f32 = dict(dtype=torch.float32, device=dev)
    mu_t = torch.as_tensor(mus, **f32).contiguous()
    return (torch.as_tensor(N, **f32).contiguous(), mu_t,
            (mu_t ** 0.5).contiguous())


def scorer_bound(B, k, l, M, objective, return_gains):
    """(bound ms, "bytes" | "operations", bytes, ops) for one scorer call:
    each input read once, each output written once; operations counted per
    scored move (11 float32 operations for dX, 30 with the energy drop)
    over the moves the function must score — every m=1 direction plus the
    ladder along the chosen one, or all M*k*l*l moves when the gains are
    returned — plus the column statistics."""
    n_in = 2 if objective == 0 else 3
    dirs = k * l * l
    scored = M * dirs if return_gains else dirs + M
    nbytes = 4 * (B * k * l * n_in + M) + 12 * B \
        + (4 * B * M * dirs if return_gains else 0)
    ops = B * (scored * (11 if objective == 0 else 30) + 3 * k * l * n_in)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def direction_margins(gains, tie, base, objective):
    """Per-instance margin of the m=1 direction choice (plain version's
    numbers): gap between the chosen score and the next, and the scale it
    is compared against. Selections inside 1e-5*(1+|.|) are near-ties."""
    import torch
    from repro_torch.kernels.grin_moves import _XE_TIE
    B = gains.shape[0]
    g1 = gains[:, -1].reshape(B, -1)
    if objective == 1:
        band = base - _XE_TIE * (1.0 + base.abs())
        score = torch.where(g1 >= band[:, None], tie[:, -1].reshape(B, -1),
                            -torch.inf)
        # a direction sitting on the band's edge may flip in or out of it
        edge = ((g1 - band[:, None]).abs()
                <= 1e-6 * (1 + base.abs()[:, None])).any(dim=1)
    else:
        score, edge = g1, torch.zeros(B, dtype=torch.bool,
                                      device=gains.device)
    top2 = torch.topk(score, 2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).nan_to_num(nan=0.0, posinf=torch.inf)
    gap = torch.where(torch.isfinite(top2[:, 0]) & ~torch.isfinite(top2[:, 1]),
                      torch.inf, gap)
    scale = GAIN_TOL * (1 + top2[:, 0].abs().nan_to_num(0.0, 0.0, 0.0))
    return (gap > scale) & ~edge


def ladder_clear(gains, d1):
    """Per-instance: True when no doubling slope along the chosen direction
    d1 sits within 1e-5*(1+|threshold|) of the run-length threshold, so the
    block size cannot flip between the kernel and the plain version."""
    import torch
    B, M = gains.shape[:2]
    g1 = gains[:, -1].reshape(B, -1)
    runner = torch.where(torch.arange(g1.shape[1], device=g1.device)[None]
                         == d1[:, None], -torch.inf, g1).max(dim=1).values
    thresh = torch.clamp(runner, min=0.0)
    gasc = gains.reshape(B, M, -1).gather(
        2, d1[:, None, None].expand(B, M, 1))[..., 0].flip(1)
    sizes = 2.0 ** torch.arange(M, dtype=torch.float32, device=gains.device)
    prev_g = torch.cat([torch.zeros_like(gasc[:, :1]), gasc[:, :-1]], dim=1)
    prev_s = torch.cat([torch.zeros_like(sizes[:1]), sizes[:-1]])
    slope = (gasc - prev_g) / (sizes - prev_s)
    near = (slope - thresh[:, None]).abs() <= GAIN_TOL * (
        1 + thresh.abs()[:, None])
    return ~near.any(dim=1)


# ----------------------------------------------------------------- phases

def phase_kernel(dev, shapes, detail):
    """Kernel vs plain version on the card, every objective, both output
    modes, at the solver's shapes. Returns the kernel's summary entry."""
    import torch
    from repro_torch.kernels import grin_moves as G
    rows, max_err = [], 0.0
    for (B, k, l, n) in shapes:
        M = _ladder_len(n)
        N, mu, P = scorer_states(B, B, k, l, n, dev)
        sizes = 2.0 ** torch.arange(M - 1, -1, -1, dtype=torch.float32,
                                    device=dev)
        for obj in range(5):
            Pk = None if obj == 0 else P
            if obj == 0:
                pg, tie = G._gains_body(N, mu, sizes), None
            else:
                pg, tie = G._energy_gains_body(N, mu, P, sizes, obj)
            pbi, pbg, pbase = G._select_body(pg, tie)
            d1 = pbi.long() % (k * l * l)
            clear = (direction_margins(pg, tie, pbase, obj)
                     & ladder_clear(pg, d1))
            pg = pg.reshape(B, -1)
            for rg in (True, False):
                kg, kbi, kbg, kbase = G.block_move_gains_cuda(
                    N, mu, sizes, return_gains=rg, P=Pk, objective=obj)
                torch.cuda.synchronize()
                err = 0.0
                if rg:
                    fin = torch.isfinite(pg)
                    if not torch.equal(torch.isfinite(kg), fin):
                        raise AssertionError(f"gain -inf pattern differs "
                                             f"(B={B}, obj={obj})")
                    diff = (kg[fin] - pg[fin]).abs()
                    err = float(diff.max()) if diff.numel() else 0.0
                    if (diff > GAIN_TOL * (1 + pg[fin].abs())).any():
                        raise AssertionError(f"gains off by {err:.3g} "
                                             f"(B={B}, obj={obj})")
                same = kbi == pbi
                # best_gain is compared where both chose the same move
                for name, a, b in (("best_gain", kbg[same], pbg[same]),
                                   ("base_gain", kbase, pbase)):
                    fa, fb = torch.isfinite(a), torch.isfinite(b)
                    if not torch.equal(fa, fb):
                        raise AssertionError(f"{name} finiteness differs")
                    d = (a[fb] - b[fb]).abs()
                    if d.numel():
                        err = max(err, float(d.max()))
                        if (d > GAIN_TOL * (1 + b[fb].abs())).any():
                            raise AssertionError(f"{name} off (B={B}, "
                                                 f"obj={obj})")
                if not bool(same[clear].all()):
                    raise AssertionError(
                        f"best_idx differs outside near-ties (B={B}, "
                        f"obj={obj}, {int((~same & clear).sum())} cases)")
                max_err = max(max_err, err)
                ms = cuda_ms(lambda: G.block_move_gains_cuda(
                    N, mu, sizes, return_gains=rg, P=Pk, objective=obj))
                plain_ms = cuda_ms(lambda: G.block_move_scores_reference(
                    N, mu, sizes, return_gains=rg, P=Pk, objective=obj),
                    iters=5, warmup=1)
                bound, by, nbytes, ops = scorer_bound(B, k, l, M, obj, rg)
                rows.append({"B": B, "k": k, "l": l, "M": M, "objective": obj,
                             "return_gains": rg, "max_abs_err": err,
                             "best_idx_equal": float(same.float().mean()),
                             "near_ties": int((~clear).sum()),
                             "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": by,
                             "bytes": nbytes, "ops": ops})
                print(f"  kernel B={B:5d} {k}x{l} M={M:2d} obj={obj} "
                      f"gains={int(rg)} err={err:.2e} "
                      f"idx_eq={rows[-1]['best_idx_equal']:.4f} "
                      f"near_ties={rows[-1]['near_ties']} ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} bound_ms={bound:.6f}")
    detail["kernel_rows"] = rows
    # the summary entry: the solver's own call, selection only, max-x, at
    # the largest grid of the main path
    main = next(r for r in rows if r["B"] == max(s[0] for s in shapes)
                and r["objective"] == 0 and not r["return_gains"])
    return {"name": "block_move_gains", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grin_moves.cu",
            "replaces": "src/repro/kernels/grin_moves.py:307",
            "launches": 0, "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": f"B={main['B']},k={main['k']},l={main['l']},"
                     f"M={main['M']},select-only,max-x"}


def phase_solver(dev, grids, host_check, detail):
    """Batched GrIn grids under max-x and max-x-e: every point converged,
    exact row sums, and every target a single-move local maximum of X_sys
    at the solver's float32 threshold (the best single move, scored in
    float64, gains at most 2e-6 * (1 + X_sys)). X_sys against the host
    float64 block solver is reported, not asserted: the batched solver's
    vectorised init can start it in another basin (see PERF.md)."""
    import numpy as np
    import torch
    from repro_torch.core import grin_block_solve, system_throughput
    from repro_torch.kernels.grin_moves import _gains_body
    from repro_torch.sched import solve_targets_grid_torch
    out = []
    for (G_, M_, seed) in grids:
        mus, mixes = skewed_grid(seed, G_, M_, K, L, N_TASKS)
        mu_b = np.repeat(mus, M_, axis=0)
        for objective in ("max-x", "max-x-e"):
            t0 = time.perf_counter()
            targets, xs, conv = solve_targets_grid_torch(
                mus, mixes, objective=objective, device=dev)
            dt = time.perf_counter() - t0
            if not conv.all():
                raise AssertionError(f"{int((~conv).sum())} grid points did "
                                     f"not converge ({objective})")
            if not (targets.sum(axis=3) == mixes[None]).all():
                raise AssertionError("row sums not exact")
            flat = targets.reshape(-1, K, L)
            x64 = np.array([system_throughput(n, m)
                            for n, m in zip(flat, mu_b)])
            g1 = _gains_body(torch.as_tensor(flat, dtype=torch.float64),
                             torch.as_tensor(mu_b, dtype=torch.float64),
                             torch.ones(1, dtype=torch.float64))
            best = g1.reshape(len(flat), -1).max(dim=1).values.numpy()
            lm = best / (1 + x64)
            step = max(1, len(flat) // host_check)
            gaps = np.array([
                (x64[i] - grin_block_solve(mu_b[i], mixes[i % M_]).x_sys)
                / (1 + x64[i]) for i in range(0, len(flat), step)])
            row = {"grid": f"{G_}x{M_}", "objective": objective,
                   "points": G_ * M_, "seconds": dt,
                   "solves_per_s": G_ * M_ / dt,
                   "max_rel_single_move_gain": float(lm.max()),
                   "host_checked": len(gaps),
                   "min_rel_gap_vs_host": float(gaps.min()),
                   "mean_rel_gap_vs_host": float(gaps.mean()),
                   "below_host_by_more_than_4e-6": int((gaps < -4e-6).sum())}
            out.append(row)
            print(f"  solver {row['grid']} {objective}: {dt:.3f} s, "
                  f"{row['solves_per_s']:.1f} solves/s; local-max margin "
                  f"{lm.max():.2e}; vs host ({len(gaps)} points) min "
                  f"{gaps.min():.2e} mean {gaps.mean():.2e}")
            if lm.max() > 2e-6:
                raise AssertionError(f"a target is not a single-move local "
                                     f"maximum ({lm.max():.2e}, {objective})")
    mus, mixes = skewed_grid(grids[-1][2], grids[-1][0], grids[-1][1], K, L,
                             N_TASKS)
    prof = device_busy(lambda: solve_targets_grid_torch(mus, mixes,
                                                        device=dev))
    print(f"  solver profile ({grids[-1][0]}x{grids[-1][1]} max-x): wall "
          f"{prof['wall_s']:.3f} s, device busy share {prof['busy_share']}")
    detail["solver"] = out
    detail["solver_profile"] = prof


def phase_scheduler(dev, n_mixes, burst, detail):
    """SchedulerCore on the card: warm targets, route_many == route loop,
    elastic what-ifs, pool loss and return."""
    import numpy as np
    from repro_torch.sched import SchedulerCore, get_policy
    mus, mixes = skewed_grid(7, 1, n_mixes, K, L, N_TASKS)
    mu = mus[0]
    core = SchedulerCore(get_policy("grin"), mu, device=dev)
    t0 = time.perf_counter()
    added = core.warm_targets(mixes)
    t_warm = time.perf_counter() - t0
    if added != len({tuple(m) for m in mixes.tolist()}):
        raise AssertionError(f"warm_targets inserted {added}")
    loop = SchedulerCore(get_policy("grin"), mu, device=dev)
    loop.warm_targets(mixes[:1])
    core.notify_type_counts(mixes[0])
    loop.notify_type_counts(mixes[0])
    types = np.random.default_rng(3).choice(K, size=burst,
                                            p=mixes[0] / mixes[0].sum())
    t0 = time.perf_counter()
    js = core.route_many(types)
    t_many = time.perf_counter() - t0
    t0 = time.perf_counter()
    js_loop = np.array([loop.route(int(t)) for t in types])
    t_loop = time.perf_counter() - t0
    if not np.array_equal(js, js_loop):
        raise AssertionError("route_many decisions differ from route()")
    if not (np.array_equal(core.counts, loop.counts)
            and np.array_equal(core.backlog_work, loop.backlog_work)):
        raise AssertionError("route_many books differ from route()")
    cols = np.random.default_rng(4).uniform(1.0, 30.0, size=(2, K))
    t0 = time.perf_counter()
    wi = core.elastic_what_if(mixes[:8], added_columns=cols)
    t_wi = time.perf_counter() - t0
    shapes = {"base": (8,), "pool_lost": (L, 8), "pool_added": (2, 8)}
    for key, shape in shapes.items():
        for suffix in ("", "_energy", "_edp"):
            a = wi[key + suffix]
            if a.shape != shape or not np.isfinite(a).all():
                raise AssertionError(f"what-if {key + suffix}: {a.shape}")
    core.pool_lost(2)
    if core.mu.shape != (K, L - 1) or core.counts.shape != (K, L - 1):
        raise AssertionError("pool_lost did not drop the column")
    js2 = core.route_many(types[:256])
    core.pool_added(mu[:, 2])
    if core.mu.shape != (K, L) or not (js2 < L - 1).all():
        raise AssertionError("pool_lost / pool_added round trip")
    core.route_many(types[:256])
    detail["scheduler"] = {"warm_targets_s": t_warm, "burst": burst,
                           "route_many_s": t_many,
                           "route_many_per_s": burst / t_many,
                           "route_loop_per_s": burst / t_loop,
                           "what_if_s": t_wi, "stats": core.stats}
    print(f"  scheduler: warm {added} targets {t_warm:.3f} s; route_many "
          f"{burst / t_many:.0f} routes/s (host loop {burst / t_loop:.0f}); "
          f"what-if {t_wi:.3f} s")


def phase_engine(dev, n_mus, seeds, n_completions, warmup, detail):
    """Fig. 9 workload (3x3, N = 30 programs) on the batched engine: GrIn
    beats LB on the mean, and simulated X and E/task agree with the closed
    form of the solved target at the conformance gates."""
    import numpy as np
    from repro_torch.core import (PowerModel, expected_energy_per_task,
                                  random_affinity_matrix, system_throughput)
    from repro_torch.sched import get_policy
    from repro_torch.sim import (SimConfig, compare_policies,
                                 make_distribution, sweep)
    power = PowerModel(alpha=0.5)
    rng = np.random.default_rng(3)
    mus = [random_affinity_matrix(rng, 3, 3) for _ in range(n_mus)]
    mix = np.array([10, 10, 10])
    out, gaps_x, gaps_e = [], [], []
    t_all = time.perf_counter()
    for order in ("PS", "FCFS"):
        xg, xl = [], []
        for mu in mus:
            cfg = SimConfig(mu=mu, n_programs_per_type=mix,
                            distribution=make_distribution("exponential"),
                            order=order, power=power,
                            n_completions=n_completions,
                            warmup_completions=warmup, seed=0)
            t0 = time.perf_counter()
            rows = compare_policies(cfg, ["grin", "grin-e", "lb", "jsq"],
                                    seeds=seeds, device=dev)
            dt = time.perf_counter() - t0
            xg += [m.throughput for m in rows["GrIn"]]
            xl += [m.throughput for m in rows["LB"]]
            for name, key in (("GrIn", "grin"), ("GrIn-E", "grin-e")):
                target = get_policy(key).solve_target(mu, mix)
                x_cf = system_throughput(target, mu)
                e_cf = expected_energy_per_task(target, mu, power)
                for m in rows[name]:
                    gaps_x.append(abs(m.throughput - x_cf) / x_cf)
                    gaps_e.append(abs(m.mean_energy - e_cf) / e_cf)
            events = n_completions * 4 * len(seeds)
            out.append({"order": order, "seconds": dt,
                        "events_per_s": events / dt})
        if np.mean(xg) < np.mean(xl):
            raise AssertionError(f"GrIn X {np.mean(xg):.3f} < LB X "
                                 f"{np.mean(xl):.3f} ({order})")
        print(f"  engine {order}: GrIn X {np.mean(xg):.3f} vs LB "
              f"{np.mean(xl):.3f} ({len(xg)} runs)")
    # the device solver inside the engine path: one grid sweep
    cfg = SimConfig(mu=mus[0], n_programs_per_type=mix,
                    distribution=make_distribution("exponential"),
                    order="PS", power=power, n_completions=n_completions,
                    warmup_completions=warmup, seed=0)
    _, res = sweep(cfg, "grin-e", mus=np.stack(mus), seeds=seeds, device=dev)
    if not np.isfinite(res["throughput"]).all():
        raise AssertionError("sweep throughput not finite")
    cfg.n_completions, cfg.warmup_completions = 500, 100
    detail["engine_profile"] = prof = device_busy(lambda: compare_policies(
        cfg, ["grin", "grin-e", "lb", "jsq"], seeds=seeds, device=dev))
    print(f"  engine profile (500 completions): wall {prof['wall_s']:.3f} s, "
          f"device busy share {prof['busy_share']}")
    t_all = time.perf_counter() - t_all
    gx, ge = np.asarray(gaps_x), np.asarray(gaps_e)
    detail["engine"] = {"runs": out, "seconds": t_all,
                        "x_gap_max": float(gx.max()),
                        "x_gap_mean": float(gx.mean()),
                        "e_gap_max": float(ge.max()),
                        "e_gap_mean": float(ge.mean())}
    print(f"  engine: sim vs closed form X gap max {gx.max():.3f} mean "
          f"{gx.mean():.3f}; E gap max {ge.max():.3f} mean {ge.mean():.3f}; "
          f"{t_all:.1f} s")
    if gx.max() >= 0.15 or ge.max() >= 0.15 or gx.mean() >= 0.05 \
            or ge.mean() >= 0.05:
        raise AssertionError("simulation outside the conformance gates")


# ------------------------------------------------------------ model kernels

# bf16 attention, kernel vs plain: |d| <= ATTN_TOL * (rms of the output row
# + |out|). The reference sweep's 2e-2, taken relative to each row's rms:
# at S = 8192 a row averages ~4096 unit-variance values, so |out| ~ 0.03
# and an absolute 2e-2 would pass a kernel that drops a 64-key tile.
ATTN_TOL = 2e-2
ATTN_FAULT_KEYS = 64    # the negative control's fault: one 64-key tile
SSD_Y_TOL = 5e-2        # bf16 SSD y (the reference sweep's)
SSD_STATE_TOL = 1e-4    # float32 SSD final state (the reference's)
RMS_TOL = 2e-2          # bf16 RMSNorm (the reference sweep's)
SERVE_ARCH = "zamba2-7b"
SERVE_B, SERVE_S, SERVE_STEPS = 4, 8192, 64
CHECK_S = 4600          # decode-vs-forward prompt, longer than the 4096 window
# decode-vs-forward: the largest gap between the logits prefill + decode_step
# give for the last token and forward's last position, bf16 through 81
# Mamba2 layers and 13 attention applications (the two paths round
# differently: chunked SSD kernel vs the step recurrence, flash kernel vs the
# plain decode attention over the bf16 ring). On an H100 the sound gaps over
# the 4 prompts were 0.156-0.191 and the gaps against a forward without the
# window 0.328-0.398 (PERF.md); the limit lies between the two.
LOGIT_TOL = 0.25


def _bound(nbytes, ops, ops_per_s):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ops_per_s * 1e3
    return (max(t_b, t_o), "bytes" if t_b >= t_o else "operations", nbytes,
            ops)


def attention_pairs(s: int, window: int) -> int:
    """(query, key) pairs causal attention over s positions attends."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_bound(b, s, h, kv, dh, window):
    """q, k, v read once and out written once (bf16); 4*dh FLOP per
    attended pair (q.k and p*v), at the bf16 tensor-core rate."""
    nbytes = 2 * (2 * b * s * h * dh + 2 * b * s * kv * dh)
    return _bound(nbytes, 4 * dh * b * h * attention_pairs(s, window),
                  BF16_OPS_PER_S)


def ssd_bound(b, s, h, dk, dv, chunk, shared_qk):
    """q, k (stored once for all heads when shared), v, y bf16; log_a, beta
    float32; the final state float32. Operations of the chunked form the
    function is defined by (chunk c): per chunk and row the causal half of
    q k^T and of the intra-chunk product, plus q S and the state update,
    at the bf16 tensor-core rate."""
    c = min(chunk, s)
    n = -(-s // c)
    pairs = c * (c + 1) // 2
    ops = b * h * n * (2 * pairs * dk + 2 * pairs * dv + 4 * c * dk * dv)
    qk = 2 * 2 * b * s * dk * (1 if shared_qk else h)
    nbytes = qk + 2 * 2 * b * s * h * dv + 2 * 4 * b * s * h \
        + 4 * b * h * dk * dv
    return _bound(nbytes, ops, BF16_OPS_PER_S)


def _close(a, b, tol):
    """max |a - b| and whether |a - b| <= tol + tol * |b| everywhere."""
    d = (a.float() - b.float()).abs()
    return float(d.max()), bool((d <= tol + tol * b.float().abs()).all())


def _close_rows(a, b, tol):
    """Attention outputs (..., dh): max |a - b|, max |a - b| over the rms of
    b's row, and whether |a - b| <= tol * (rms(b row) + |b|) everywhere."""
    b = b.float()
    d = (a.float() - b).abs()
    rms = b.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return (float(d.max()), float((d / rms).max()),
            bool((d <= tol * (rms + b.abs())).all()))


def _attn_inputs(dev, seed, b, s, h, kv, dh):
    """q contiguous (as rope leaves it), k contiguous, v a strided view of a
    wider projection (as the model splits it), bf16."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dict(dtype=torch.bfloat16, device=dev, generator=g)
    q = torch.randn((b, s, h, dh), **bf)
    k = torch.randn((b, s, kv, dh), **bf)
    v = torch.randn((b, s, 2 * kv * dh), **bf)[..., kv * dh:].reshape(
        b, s, kv, dh)
    return q, k, v


def ssd_inputs(dev, seed, b, s, h, d):
    """SSD inputs as a Mamba2 layer forms them: q = C and k = B shared by
    all heads (expanded views, head stride 0), v the head-split x, dt =
    softplus(. - 2), log_a = dt * A with A = -linspace(1, 16)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dict(dtype=torch.bfloat16, device=dev, generator=g)
    Bc = F.silu(torch.randn((b, s, d), **bf))
    Cc = F.silu(torch.randn((b, s, d), **bf))
    x = torch.randn((b, s, h * d), **bf).reshape(b, s, h, d)
    dtv = F.softplus(torch.randn((b, s, h), device=dev, generator=g) - 2.0)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    return (Cc[:, :, None].expand(b, s, h, d), Bc[:, :, None].expand(
        b, s, h, d), x, dtv * A, dtv)


def phase_model_kernels(dev, detail):
    """The flash-attention, SSD-scan and RMSNorm kernels against their plain
    versions on the card, bf16, at the shapes the serving path gives them
    (and B = 1 causal, windowed and GQA cases); kernel, plain and library
    times and bounds. Returns the three summary entries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SSD
    rows = {"flash_attention": [], "ssd_scan": [], "rmsnorm": []}

    # (B, S, H, KV, dh, window): the serving prefill's call first
    for i, (b, s, h, kv, dh, win) in enumerate([
            (SERVE_B, SERVE_S, 32, 32, 112, 4096), (1, SERVE_S, 32, 32, 112,
                                                    4096),
            (1, SERVE_S, 32, 32, 112, 0), (1, SERVE_S, 32, 4, 128, 0)]):
        q, k, v = _attn_inputs(dev, 100 + i, b, s, h, kv, dh)
        out = FA.flash_attention_cuda(q, k, v, window=win)
        plain = FA.flash_attention_plain(q, k, v, window=win)
        torch.cuda.synchronize()
        err, rel, ok = _close_rows(out, plain, ATTN_TOL)
        # negative control: the plain version with a one-tile fault (the
        # window edge 64 keys early; without a window, the 64 newest keys
        # dropped, rows past the first 128) must fail the same check
        if win:
            bad = FA.flash_attention_plain(q, k, v,
                                           window=win - ATTN_FAULT_KEYS)
        else:
            bad = FA.flash_attention_plain(q, k, v, q_offset=-ATTN_FAULT_KEYS)
        cut = 2 * ATTN_FAULT_KEYS
        _, bad_rel, bad_ok = _close_rows(bad[:, cut:], plain[:, cut:],
                                         ATTN_TOL)
        del bad
        if not ok:
            raise AssertionError(f"flash attention off by {err:.3g} "
                                 f"({rel:.3g} of a row's rms; B={b}, H={h}, "
                                 f"KV={kv}, dh={dh}, window={win})")
        if bad_ok:
            raise AssertionError(f"the attention check passes a one-tile "
                                 f"fault ({bad_rel:.3g} of a row's rms; "
                                 f"window={win})")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if win:
            ones = torch.ones((s, s), dtype=torch.bool, device=dev)
            mask = torch.tril(ones) & ~torch.tril(ones, diagonal=-win)
            del ones

            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=h != kv)
        else:
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=h != kv)
        lib_err = float((lib().transpose(1, 2).float() - plain.float())
                        .abs().max())
        ms = cuda_ms(lambda: FA.flash_attention_cuda(q, k, v, window=win),
                     iters=10, warmup=2)
        plain_ms = cuda_ms(lambda: FA.flash_attention_plain(
            q, k, v, window=win), iters=2, warmup=1)
        lib_ms = cuda_ms(lib, iters=10, warmup=2)
        bound, by, nbytes, ops = attention_bound(b, s, h, kv, dh, win)
        rows["flash_attention"].append({
            "B": b, "S": s, "H": h, "KV": kv, "dh": dh, "window": win,
            "max_abs_err": err, "max_err_over_row_rms": rel,
            "fault_err_over_row_rms": bad_rel, "library_err": lib_err,
            "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": by, "bytes": nbytes, "ops": ops,
            "tflops": ops / ms / 1e9})
        print(f"  flash B={b} S={s} H={h} KV={kv} dh={dh} window={win}: "
              f"err {err:.2e} = {rel:.2e} x row rms (one-tile fault "
              f"{bad_rel:.2e}, rejected) ms {ms:.3f} plain {plain_ms:.1f} sdpa "
              f"{lib_ms:.3f} bound {bound:.3f} ({by}) "
              f"{ops / ms / 1e9:.1f} TFLOP/s")
        del q, k, v, out, plain, qt, kt, vt
        mask = None

    b, s, h, d, chunk = SERVE_B, SERVE_S, 112, 64, 256
    q, k, v, la, beta = ssd_inputs(dev, 200, b, s, h, d)
    y, st = SSD.ssd_scan_cuda(q, k, v, la, beta, chunk=chunk)
    yp, sp = SSD.ssd_scan_plain(q, k, v, la, beta, chunk=chunk)
    torch.cuda.synchronize()
    err_y, ok_y = _close(y, yp, SSD_Y_TOL)
    err_s, ok_s = _close(st, sp, SSD_STATE_TOL)
    if not (ok_y and ok_s):
        raise AssertionError(f"SSD scan off: y {err_y:.3g}, state "
                             f"{err_s:.3g}")
    ms = cuda_ms(lambda: SSD.ssd_scan_cuda(q, k, v, la, beta, chunk=chunk),
                 iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: SSD.ssd_scan_plain(q, k, v, la, beta,
                                                  chunk=chunk),
                       iters=2, warmup=1)
    bound, by, nbytes, ops = ssd_bound(b, s, h, d, d, chunk, True)
    rows["ssd_scan"].append({
        "B": b, "S": s, "H": h, "dk": d, "dv": d, "chunk": chunk,
        "max_abs_err": max(err_y, err_s), "y_err": err_y,
        "state_err": err_s, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": bound, "bound_by": by,
        "bytes": nbytes, "ops": ops})
    print(f"  ssd B={b} S={s} H={h} dk=dv={d} chunk={chunk}: y err "
          f"{err_y:.2e} state err {err_s:.2e} ms {ms:.3f} plain "
          f"{plain_ms:.1f} bound {bound:.3f} ({by})")
    del q, k, v, la, beta, y, st, yp, sp

    g = torch.Generator(device=dev).manual_seed(300)
    for d in (3584, 7168):
        x = torch.randn((SERVE_B * SERVE_S, d), dtype=torch.bfloat16,
                        device=dev, generator=g)
        w = (0.1 * torch.randn((d,), device=dev, generator=g)).to(
            torch.bfloat16)
        w1 = (1.0 + w.float()).to(torch.bfloat16)
        out = RN.rmsnorm_cuda(x, w)
        plain = RN.rmsnorm_plain(x, w)
        torch.cuda.synchronize()
        err, ok = _close(out, plain, RMS_TOL)
        if not ok:
            raise AssertionError(f"rmsnorm off by {err:.3g} (D={d})")
        ms = cuda_ms(lambda: RN.rmsnorm_cuda(x, w))
        plain_ms = cuda_ms(lambda: RN.rmsnorm_plain(x, w), iters=5)
        lib_ms = cuda_ms(lambda: F.rms_norm(x, (d,), weight=w1, eps=1e-5))
        bound, by, nbytes, ops = _bound(2 * 2 * x.numel() + 2 * d,
                                        4 * x.numel(), FP32_OPS_PER_S)
        rows["rmsnorm"].append({
            "T": x.shape[0], "D": d, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": by, "bytes": nbytes, "ops": ops})
        print(f"  rmsnorm ({x.shape[0]}, {d}) bf16: err {err:.2e} ms "
              f"{ms:.4f} plain {plain_ms:.3f} F.rms_norm {lib_ms:.4f} bound "
              f"{bound:.4f} ({by})")
        del x, out, plain
    torch.cuda.empty_cache()
    detail["model_kernel_rows"] = rows

    def entry(name, source, replaces, main):
        r = rows[name][0]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": 0,
                "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": main}
    return {
        "flash_attention": dict(entry(
            "flash_attention", "flash_attention.cu",
            "src/repro/kernels/flash_attention.py:105",
            f"B={SERVE_B},S={SERVE_S},H=KV=32,dh=112,window=4096,bf16"),
            max_err_over_row_rms=max(
                x["max_err_over_row_rms"] for x in rows["flash_attention"])),
        "ssd_scan": entry(
            "ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:85",
            f"B={SERVE_B},S={SERVE_S},H=112,dk=dv=64,chunk=256,bf16,"
            f"q/k head-broadcast"),
        "rmsnorm": entry(
            "rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:33",
            f"T={SERVE_B * SERVE_S},D=3584,bf16"),
    }


def reset_all_launches():
    from repro_torch.kernels import flash_attention, grin_moves, rmsnorm
    from repro_torch.kernels import ssd_scan
    for mod in (grin_moves, flash_attention, ssd_scan, rmsnorm):
        mod.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels import flash_attention, grin_moves, rmsnorm
    from repro_torch.kernels import ssd_scan
    out = {}
    for mod in (grin_moves, flash_attention, ssd_scan, rmsnorm):
        out.update(mod.launches)
    return out


def phase_serve(dev, state, detail, cfg=None):
    """zamba2-7b at full width and depth in a ServeEngine: 4 requests of
    8192-token prompts and 64 greedy decode steps through `generate` (the
    counted path), then timed prefill and decode runs, profiles, and the
    decode-vs-forward check on 4 requests of 4600 tokens, with a forward
    that leaves the window out as its negative control. `cfg` replaces the
    model (a reduced one for a rehearsal on a CPU)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or get_arch(SERVE_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServeEngine(model, max_len=SERVE_S + SERVE_STEPS + 8)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(f"  {cfg.name}: {n_params / 1e9:.3f} B params, "
          f"{len(model.mamba)} Mamba2 blocks + shared attention x "
          f"{cfg.n_layers // cfg.attn_every}, d_model {cfg.d_model}; "
          f"init + bf16 cast {t_init:.1f} s, weights "
          f"{weight_bytes / 1e9:.2f} GB")
    state["engine"] = engine
    tg = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S), device=dev,
                         generator=tg)
    batch = {"tokens": toks}
    # warm-up at a short prompt: cuBLAS handles, allocator (not counted)
    engine.generate({"tokens": toks[:1, :256]}, steps=2)
    engine.synchronize()

    reset_all_launches()                 # the serving path's count starts
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = engine.generate(batch, steps=SERVE_STEPS)
    engine.synchronize()
    t_gen = time.perf_counter() - t0
    launches = all_launches()            # ... and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    if out.shape != (SERVE_B, SERVE_STEPS) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(out.shape)} / ids "
                             f"out of range")

    t0 = time.perf_counter()
    logits, cache = engine.prefill(batch)
    engine.synchronize()
    t_prefill = time.perf_counter() - t0
    if logits.shape != (SERVE_B, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("prefill logits not finite / wrong shape")
    first, feed = engine._greedy_next(logits)
    t0 = time.perf_counter()
    dec, cache = engine.decode_run(feed, cache, SERVE_S, SERVE_STEPS)
    engine.synchronize()
    t_dec = time.perf_counter() - t0
    same = bool(torch.equal(out[:, 0], first)) and bool(
        torch.equal(out[:, 1:], dec[:, :SERVE_STEPS - 1]))
    del cache

    hold = {}

    def prefill_once():
        hold["lc"] = engine.prefill(batch)
    prof_prefill = device_busy(prefill_once)
    lg, cache = hold.pop("lc")
    _, feed = engine._greedy_next(lg)
    prof_decode = device_busy(lambda: engine.decode_run(feed, cache, SERVE_S,
                                                        8))
    del cache
    torch.cuda.empty_cache()

    # decode-vs-forward on SERVE_B requests longer than the window, and the
    # same decode against a forward that leaves the window out (the gap a
    # window or ring-cache fault would show; it must exceed the limit)
    ct = toks[:, :CHECK_S]
    with torch.no_grad():
        full = model.forward({"tokens": ct})[:, -1]
        model.cfg = dataclasses.replace(cfg, sliding_window=0)
        try:
            no_window = model.forward({"tokens": ct})[:, -1]
        finally:
            model.cfg = cfg
    _, c = engine.prefill({"tokens": ct[:, :-1]})
    dl, _ = model.decode_step(ct[:, -1:], c, CHECK_S - 1)
    dl = dl[:, -1]
    gaps = [float(x) for x in (dl - full).abs().amax(-1)]
    fault_gaps = [float(x) for x in (dl - no_window).abs().amax(-1)]
    gap, fault_gap = max(gaps), min(fault_gaps)
    argmax_eq = [bool(x) for x in dl.argmax(-1) == full.argmax(-1)]
    top2 = torch.topk(full, 2, dim=-1).values
    margins = [float(x) for x in top2[:, 0] - top2[:, 1]]
    del c, full, no_window, dl
    torch.cuda.empty_cache()

    res = {"arch": cfg.name, "params": n_params, "weight_bytes": weight_bytes,
           "init_s": t_init, "batch": SERVE_B, "prompt": SERVE_S,
           "steps": SERVE_STEPS, "generate_s": t_gen,
           "prefill_s": t_prefill,
           "prefill_tok_per_s": SERVE_B * SERVE_S / t_prefill,
           "decode_s": t_dec,
           "decode_tok_per_s": SERVE_B * SERVE_STEPS / t_dec,
           "decode_ms_per_step": t_dec / SERVE_STEPS * 1e3,
           "peak_bytes": peak, "launches": launches,
           "generate_equals_prefill_plus_decode": same,
           "profile_prefill": prof_prefill, "profile_decode_8": prof_decode,
           "check_prompt": CHECK_S, "check_requests": len(gaps),
           "decode_vs_forward_gaps": gaps, "decode_vs_forward_max_gap": gap,
           "decode_vs_forward_tol": LOGIT_TOL,
           "decode_vs_no_window_forward_gaps": fault_gaps,
           "decode_vs_forward_argmax_equal": argmax_eq,
           "forward_top2_margins": margins}
    detail["serve"] = res
    print(f"  generate 4 x {SERVE_S} + {SERVE_STEPS} steps: {t_gen:.2f} s; "
          f"launches {launches}; peak {peak / 1e9:.2f} GB")
    print(f"  prefill (time to first token) {t_prefill:.3f} s = "
          f"{res['prefill_tok_per_s']:.0f} tok/s; decode "
          f"{res['decode_tok_per_s']:.1f} tok/s, "
          f"{res['decode_ms_per_step']:.2f} ms/step; generate == prefill + "
          f"decode_run: {same}")
    print(f"  profiled prefill: wall {prof_prefill['wall_s']:.3f} s, device "
          f"{prof_prefill['device_s']} s, busy {prof_prefill['busy_share']}")
    print(f"  profiled 8 decode steps: wall {prof_decode['wall_s']:.3f} s, "
          f"device {prof_decode['device_s']} s, busy "
          f"{prof_decode['busy_share']}")
    print(f"  decode vs forward ({len(gaps)} x {CHECK_S}): gaps "
          f"{[round(x, 4) for x in gaps]} (tol {LOGIT_TOL}); against a "
          f"forward without the window {[round(x, 4) for x in fault_gaps]}; "
          f"argmax equal {argmax_eq}, forward top-2 margins "
          f"{[round(x, 4) for x in margins]}")
    if launches["flash_attention"] <= 0 or launches["ssd_scan"] <= 0:
        raise AssertionError(f"serving path launched no model kernel: "
                             f"{launches}")
    if gap > LOGIT_TOL:
        raise AssertionError(f"decode vs forward gap {gap:.4f} > "
                             f"{LOGIT_TOL}")
    if fault_gap <= LOGIT_TOL:
        raise AssertionError(f"decode vs a forward without the window: gap "
                             f"{fault_gap:.4f} <= {LOGIT_TOL}; the check "
                             f"cannot see a window fault")
    return launches


def phase_serve_sched(dev, state, detail):
    """CAB against LB over two pools of the full-width engine in virtual
    time (the reference launcher's --heterogeneous experiment): 1 x 1024
    prompts, measured 2 x 2 rates, 60 completions after 10 warmup."""
    import numpy as np
    import torch
    from repro_torch.core import classify_2x2
    from repro_torch.sched import SchedulerCore, get_policy
    from repro_torch.sched.virtual import VirtualTimeCluster
    from repro_torch.serve.engine import request_service_fns
    engine = state["engine"]
    tg = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, engine.cfg.vocab_size, (1, 1024), device=dev,
                         generator=tg)
    before = all_launches()
    fns = request_service_fns(engine, {"tokens": toks}, toks)
    t0 = time.perf_counter()
    mu = VirtualTimeCluster(fns).measure_rates(2, reps=3)
    t_mu = time.perf_counter() - t0
    case = classify_2x2(mu).value
    types = [0] * 4 + [1] * 4
    xs = {}
    for name in ("cab", "lb"):
        sched = SchedulerCore(get_policy(name), mu, device=dev)
        t0 = time.perf_counter()
        m = VirtualTimeCluster(fns).run_closed(sched, types,
                                               n_completions=60, warmup=10)
        xs[sched.name] = {"X": m.throughput, "mean_response_s":
                          m.mean_response_time,
                          "per_pool_tasks": m.per_pool_tasks.tolist(),
                          "wall_s": time.perf_counter() - t0}
    after = all_launches()
    detail["serve_sched"] = {"mu": mu.tolist(), "case": case,
                             "measure_s": t_mu, "policies": xs,
                             "launches": {k: after[k] - before[k]
                                          for k in after}}
    print(f"  measured mu (req/s) {np.round(mu, 3).tolist()} ({case}) in "
          f"{t_mu:.1f} s")
    for name, r in xs.items():
        print(f"  {name}: X={r['X']:.3f} req/s, mean response "
              f"{r['mean_response_s']:.3f} s, per pool {r['per_pool_tasks']}")
    if not all(np.isfinite(r["X"]) and r["X"] > 0 for r in xs.values()):
        raise AssertionError("serve-sched throughput not positive")


def phase_ops_rmsnorm(dev, detail):
    """The RMSNorm kernel's one entry point, `ops.rmsnorm`, on a serving-
    sized hidden state (4 x 8192 x 3584, bf16); checked against the plain
    version."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as RN
    g = torch.Generator(device=dev).manual_seed(400)
    x = torch.randn((SERVE_B, SERVE_S, 3584), dtype=torch.bfloat16,
                    device=dev, generator=g)
    w = (0.1 * torch.randn((3584,), device=dev, generator=g)).to(
        torch.bfloat16)
    reset_all_launches()
    out = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    n = all_launches()["rmsnorm"]
    err, ok = _close(out, RN.rmsnorm_plain(x, w), RMS_TOL)
    detail["ops_rmsnorm"] = {"launches": n, "max_abs_err": err}
    print(f"  ops.rmsnorm {tuple(x.shape)}: launches {n}, err {err:.2e}")
    if n <= 0 or not ok or out.shape != x.shape:
        raise AssertionError("ops.rmsnorm did not run the kernel correctly")
    return n


# ------------------------------------------------------------------- main

def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        _fail("src/repro_torch not found beside chip_smoke.py: run it from "
              "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith(("jax.", "repro.")) \
                or mod == "repro":
            _fail(f"{mod} was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from repro_torch.kernels import (build, flash_attention, grin_moves,
                                     rmsnorm, ssd_scan)
    t0 = time.perf_counter()
    mods = {"grin_moves": (grin_moves, build.NVCC_FLAGS),
            "flash_attention": (flash_attention, build.MODEL_NVCC_FLAGS),
            "ssd_scan": (ssd_scan, build.MODEL_NVCC_FLAGS),
            "rmsnorm": (rmsnorm, build.MODEL_NVCC_FLAGS)}
    handles = {name: build.start_build(name, mod.SOURCES, flags)
               for name, (mod, flags) in mods.items()}
    for name, h in handles.items():     # one nvcc per source, in parallel
        build.finish_build(name, h)
    for mod, _ in mods.values():
        mod._kernel_lib()
    t_build = time.perf_counter() - t0
    print(f"build: {t_build:.1f} s "
          f"{ {n: round(b['seconds'], 1) for n, b in build.build_log.items()} }")
    for name in mods:
        used = [ln.split("info    : ")[-1] for ln in
                build.build_log[name]["ptxas"].splitlines() if "Used" in ln]
        print(f"  {name}: {'; '.join(sorted(set(used)))[:400]}")

    detail = {"card": smi, "build_s": t_build,
              "build": {n: {"seconds": b["seconds"], "ptxas": b["ptxas"]}
                        for n, b in build.build_log.items()}}
    failed = []

    def run(name, fn, *args):
        print(f"[{name}]")
        t = time.perf_counter()
        try:
            res = fn(*args)
        except Exception:                # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
            res = None
        print(f"[{name}] {'FAIL' if name in failed else 'ok'} "
              f"({time.perf_counter() - t:.1f} s)")
        return res

    entry = run("kernel", phase_kernel, dev,
                [(256, K, L, N_TASKS), (4096, K, L, N_TASKS),
                 (1001, 3, 3, 30)], detail)
    model_entries = run("model-kernels", phase_model_kernels, dev, detail)
    reset_all_launches()                # the scheduling path's count starts
    per_phase = {}
    for name, fn, args in (
            ("solver", phase_solver, (dev, [(16, 16, 1), (64, 64, 2)], 64,
                                      detail)),
            ("scheduler", phase_scheduler, (dev, 16, 4096, detail)),
            ("engine", phase_engine, (dev, 4, [0, 1, 2], 4000, 800,
                                      detail))):
        before = grin_moves.launches["block_move_gains"]
        run(name, fn, *args)
        per_phase[name] = grin_moves.launches["block_move_gains"] - before
    launches = grin_moves.launches["block_move_gains"]
    print(f"scorer launches on the scheduling path: {launches} {per_phase}")
    if per_phase.get("solver", 0) <= 0:
        failed.append("launches")
    detail["launches"] = {"total": launches, **per_phase}

    state = {}                          # the serving engine, shared
    serve_launches = run("serve", phase_serve, dev, state, detail)
    run("serve-sched", phase_serve_sched, dev, state, detail)
    state.clear()
    torch.cuda.empty_cache()
    rms_launches = run("ops-rmsnorm", phase_ops_rmsnorm, dev, detail)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_detail.json").write_text(
        json.dumps(detail, indent=1, default=str))
    if failed or entry is None or model_entries is None \
            or serve_launches is None or rms_launches is None:
        _fail(f"phases failed: {failed}")
    entry["launches"] = launches
    model_entries["flash_attention"]["launches"] = \
        serve_launches["flash_attention"]
    model_entries["ssd_scan"]["launches"] = serve_launches["ssd_scan"]
    model_entries["rmsnorm"]["launches"] = rms_launches
    print(json.dumps({"kernels": [entry, *model_entries.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
