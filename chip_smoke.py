#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernel from `src/repro_torch/kernels/csrc`, holds
it against its plain PyTorch version on the card, then drives the port's
scheduling path through the entry points a user calls — the batched GrIn
target solver on (mu x mix) grids, a `SchedulerCore` routing bursts and
pricing elastic what-ifs, and the batched closed-network engine comparing
policies on the paper's Fig. 9 workload — and checks each result by the
repository's own means. It prints the card's name and power limit, one
JSON line describing every kernel (launches on the main path, error
against the plain version, times and bound), and last a JSON status line.
Details go to `chiprun_out/chip_smoke_detail.json`. Exits non-zero, with no
result lines, when there is no CUDA device, when the repository is not
beside the script, or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12              # H100 SXM float32, non-tensor (data sheet)
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

    from repro_torch.kernels import build, grin_moves
    t0 = time.perf_counter()
    handles = {"grin_moves": build.start_build("grin_moves",
                                               grin_moves.SOURCES)}
    for name, h in handles.items():     # one nvcc per source, in parallel
        build.finish_build(name, h)
    grin_moves._kernel_lib()
    t_build = time.perf_counter() - t0
    print(f"build: {t_build:.1f} s")
    print(build.build_log["grin_moves"]["ptxas"].strip()[-600:])

    detail = {"card": smi, "build_s": t_build}
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
    grin_moves.reset_launches()         # the main path's count starts here
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
    print(f"kernel launches on the main path: {launches} {per_phase}")
    if per_phase.get("solver", 0) <= 0:
        failed.append("launches")
    detail["launches"] = {"total": launches, **per_phase}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_detail.json").write_text(
        json.dumps(detail, indent=1, default=str))
    if failed or entry is None:
        _fail(f"phases failed: {failed}")
    entry["launches"] = launches
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
