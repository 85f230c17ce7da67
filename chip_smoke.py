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
    `SchedulerCore` routing bursts and pricing elastic what-ifs, the
    batched closed-network engine comparing policies on the paper's Fig. 9
    workload, and the priority classes: GrIn-P target grids on
    class-weighted rows and the priority benchmark's two-class workload
    under PS, PRIO and FCFS (the fused GrIn solve kernel: one launch per
    grid solve; the per-step block-move scorer kernel is off this path and
    held against its plain version in the kernel phase only). The engine
    runs are held to the port's own host event core, run in a pool of
    host processes;
  * open traffic and faults — `benchmarks/fig_traffic.py`'s and
    `benchmarks/fig_faults.py`'s workloads at their defaults and a 4x6,
    1,536-slot `fleet` point under a storm, each one `simulate_open_batch`
    call, held to the port's host open and fault loops (same arrivals and
    fault realizations, in the same pool), to conservation, Little's law
    and the benchmarks' claims; every refreshed segment grid is one fused
    GrIn launch whose targets are held to the plain per-step loop;
  * the rest of the fault and capacity paths — the closed engine's fault
    inputs on the Fig. 9 workload under a storm (every run against the
    host fault loop; a never-firing scenario bit-equal to none),
    `benchmarks/fig_hazard.py`'s drawn-availability workload (one
    `simulate_open_batch` call, every point against the host fault
    loop), and `benchmarks/fig_autoscale.py`'s governor (one fused GrIn
    launch per decision epoch, its priced X against the host float64
    price);
  * serving — zamba2-7b at full width and depth (81 Mamba2 layers, a shared
    attention block applied 13 times, d_model 3584; random weights from a
    seed) in a `ServeEngine`: 4 prompts of 8192 tokens and 32 greedy decode
    steps (flash-attention and SSD-scan kernels), a decode-vs-forward check,
    then CAB against LB over two pools of that engine in virtual time and
    `serve --traffic` on it (the bundled trace through GrIn-P with SLO
    admission, its decisions recorded and its solves profiled); and
    xlstm-1.3b at full width and depth (42 mLSTM blocks with 512 x 512
    memories, 6 sLSTM blocks, d_model 2048) on the same prompts and steps
    (the wide SSD-scan kernel's pair: memory and normaliser in one call
    per mLSTM block) with its own
    decode-vs-forward check; and the moe, audio and vlm families at full
    width and depth, granite-moe-3b-a800m (40 experts, top 8) on the same
    prompts and steps, musicgen-medium on 4 prompts of 1500 frames x 4
    codebooks, phi-3-vision-4.2b on 4 x (256 patches + 8192 tokens) (the
    flash kernel once per attention layer per prefill), each with a
    decode-vs-forward check against a negative control;
  * `ops.rmsnorm`, the RMSNorm kernel's only entry point;
  * training — through `launch.train.train`, 4 AdamW steps of 4 x 4096
    tokens in 4 microbatches each, every block recomputed in the
    backward, from a random initialisation (a seed): qwen2.5-3b at full
    width and depth (36 blocks, d_model 2048, 3.09 B parameters; flash
    attention with the rows' log-sum-exp and its backward kernel in every
    layer); zamba2-7b at full width cut to 27 Mamba2 blocks (2.54 B; the
    SSD scan's forward and backward kernels in every block, flash
    attention in the 4 applications of the shared block); xlstm-1.3b at
    full width and depth (1.19 B; mLSTM's pair and its backward kernel in
    the 42 mLSTM blocks); granite-moe-3b-a800m at full width cut to 16
    of its 32 blocks (1.69 B; flash attention and its backward kernel in
    every layer, the experts' fixed-order backward, one microbatch's
    gradients bit-equal across two runs). Each with a gradient check
    against the plain routes
    (`grad_check_routes`) and a dropped-gradient control, and recovery from
    an injected failure at `smoke_config` (bit-equal). The model-kernels
    phase holds the flash backward kernel against its plain version at
    four shapes, and the two scan backward kernels at their training
    shapes. Then training sharded (the train-sharded phase): 4 ranks, each
    a process of its own on the one card, as a (data 2, model 2) mesh
    over gloo (CUDA tensors staged through pinned host buffers), train
    qwen2.5-3b and granite-moe-3b-a800m at full width cut to 4 blocks for
    one step of 4 x 4096 tokens (fsdp x tp masters, the ZeRO-2 compute
    copy, tensor-parallel attention and MLP, each data shard's experts
    routed alone), held to the same step on one rank (loss, gradients per
    leaf group, a control with one row-parallel sum left out), each
    rank's flash launches on its own heads. The dry-run
    (`launch.dryrun.lower_cell` on the one-card mesh, on the meta device)
    prints what each trained cell's state should take beside its
    measured peak;
  * the examples' counterparts (`examples/*_torch.py`), each run on the
    card with its defaults (serve_heterogeneous in the reference example's
    smoke mode);

and checks each result by the repository's own means. It prints the card's
name and power limit, one JSON line describing every kernel (launches on
its path, error against the plain version, times and bounds), and last a
JSON status line.
Details go to `chiprun_out/chip_smoke_detail.json`. Exits non-zero, with no
result lines, when there is no CUDA device, when the repository is not
beside the script, or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing
import os
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


def fused_kernel_ms(mus, mixes, dev, iters: int = 5) -> float:
    """Device ms of the fused GrIn kernel alone (max-x) on (B, k, l) rows
    and (B, k) mixes: its inputs prepared once, then `iters` launches
    between CUDA events. The launch counts are restored."""
    from repro_torch.core import grin as GR
    from repro_torch.kernels import grin_moves as GM
    N0, mu_t, Ps, sizes, cap, obj = GR._batch_inputs(
        mus, mixes, None, None, "max-x", None, None, dev)
    counted = dict(GM.launches)
    ms = cuda_ms(lambda: GM.grin_block_solve_cuda(N0, mu_t, sizes, cap,
                                                  P=Ps, objective=obj),
                 iters=iters, warmup=1)
    GM.launches.update(counted)
    return ms


def device_busy(fn, cpu: bool = True, top: int = 6) -> dict:
    """Run fn() once under torch.profiler: wall seconds, summed device
    kernel seconds, the busy share, and the top kernels by device time,
    read from the profiler's raw device events (building its Python event
    tree takes seconds for the ~20,000 launches of a training step). The
    profiler's own host overhead inflates the wall time, so the share is a
    lower bound. Device fields are None if the trace shows none.
    `cpu=False` traces device activity only (fewer events to record);
    `top` kernels are listed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if cpu else [])) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            us, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    total = sum(us for us, _ in by_name.values()) / 1e6
    most = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": wall, "device_s": total or None,
            "busy_share": (total / wall) if total else None,
            "top": [{"kernel": k[:80], "device_s": us / 1e6, "calls": n}
                    for k, (us, n) in most if us > 0]}


def profile_sees_device(dev) -> bool:
    """Whether `device_busy` records the device time of one small kernel
    on the card."""
    import torch
    x = torch.ones(1 << 20, device=dev)
    return device_busy(lambda: x.mul_(2.0), cpu=False)["device_s"] is not None


def host_run(job):
    """One run of the port's host event core: job = (SimConfig, policy).
    The loop, its routing and its target solves are host float64 code;
    the core never touches the card (device "cpu"), so this runs in a pool
    of host processes beside the card's work."""
    from repro_torch.sim import ClosedNetworkSimulator
    cfg, policy = job
    return ClosedNetworkSimulator(cfg, device="cpu").run(policy)


def host_grin_p(job):
    """Weighted X of the host float64 GrIn-P: job = (mu, class mixes,
    weights)."""
    from repro_torch.core.priority import grin_priority_solve
    return grin_priority_solve(*job).weighted_x


def host_map(pool, fn, jobs):
    """fn over jobs in the host pool (in order), or here without one."""
    jobs = list(jobs)
    if pool is None:
        return [fn(j) for j in jobs]
    return pool.map(fn, jobs, chunksize=1)


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


def solve_bound(B, k, l, M, objective, steps):
    """(bound ms, "bytes" | "operations", bytes, ops) for one fused solve:
    N0, mu (and P) and the ladder read once, N, moves and converged written
    once; operations counted over the steps these inputs took (each
    instance's moves plus one converging step a phase): every m=1 direction
    and the ladder along the chosen one scored per step, at 11 float32
    operations per move (30 under the energy objectives), plus the column
    statistics. What it leaves out is the slowest instance's chain of
    dependent steps."""
    n_in = 2 if objective == 0 else 3
    nbytes = 4 * (B * k * l * n_in + M) + 4 * B * k * l + 8 * B
    per_step = (k * l * l + M) * (11 if objective == 0 else 30) \
        + 3 * k * l * n_in
    ops = int(steps) * per_step
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def _ulps_from(base, thr):
    """|base - thr| in float32 ulps of thr, per instance (float64)."""
    import torch
    ulp = (torch.nextafter(thr, torch.full_like(thr, torch.inf)) - thr)
    return (base.double() - thr.double()).abs() / ulp.double()


def threshold_margin_ulps(mu_b, mix_b, objective, dev, P=None):
    """Replay the per-step loop (scorer kernel, the device functions the
    fused solve runs) for a batch of instances on the card and return, per
    instance, the smallest distance in float32 ulps of the threshold between
    a step's steepest m=1 gain and 1e-6 * (1 + scale): a fused-vs-per-step
    difference is a near-threshold move when this is a few ulps. `P` as in
    `first_divergence`."""
    import torch
    from repro_torch.core import grin as GR
    from repro_torch.kernels.grin_moves import (OBJ_E_GUARD, OBJ_XE,
                                                block_move_gains_cuda)
    N, mus, Ps, sizes, cap, obj = GR._batch_inputs(
        mu_b, mix_b, None, None, objective, None, P, dev)
    B, k, l = N.shape
    best = torch.full((B,), torch.inf, dtype=torch.float64, device=dev)
    for pobj in [obj] + ([OBJ_E_GUARD] if obj == OBJ_XE else []):
        active = torch.ones(B, dtype=torch.bool, device=dev)
        for _ in range(cap):
            _, bi, _, base = block_move_gains_cuda(
                N, mus, sizes, return_gains=False, P=Ps, objective=pobj)
            thr = GR._TOL32_BLOCK * (1.0 + GR.phase_scale(N, mus, Ps, pobj))
            best = torch.where(active,
                               torch.minimum(best, _ulps_from(base, thr)),
                               best)
            active = active & (base > thr)
            if not bool(active.any()):
                break
            N = _apply_moves(N, bi, sizes, active)
    return best.cpu().numpy()


def _apply_moves(N, bi, sizes, do):
    """N after each instance in `do` takes its selected move."""
    B, k, l = N.shape
    r = bi.long()
    mi, r = r // (k * l * l), r % (k * l * l)
    p, s, d = r // (l * l), (r // l) % l, r % l
    import torch
    N = N.clone()
    rows = torch.arange(B, device=N.device)[do]
    m = sizes[mi[do]]
    N[rows, p[do], s[do]] -= m
    N[rows, p[do], d[do]] += m
    return N


def first_divergence(mu_b, mix_b, objective, dev, P=None):
    """Replay the per-step loop for a batch of instances on the card, scoring
    each step's state with both the plain PyTorch body and the scorer kernel
    (the device functions the fused solve runs), up to the first step where
    they disagree on whether to move or on the move. Returns, per instance,
    the kind of that step: "threshold" (a steepest m=1 gain within 8
    float32 ulps of 1e-6 * (1 + scale)), "tie" (a near-tie of direction or
    block size by the kernel phase's margins), "other", or "" when they
    never disagree. `P` is the priced power matrix when mu_b is not the
    physical one (the priority solves' weighted rows)."""
    import numpy as np
    import torch
    from repro_torch.core import grin as GR
    from repro_torch.kernels import grin_moves as GM
    N, mus, Ps, sizes, cap, obj = GR._batch_inputs(
        mu_b, mix_b, None, None, objective, None, P, dev)
    B, k, l = N.shape
    kind = np.array([""] * B, dtype=object)
    live = torch.ones(B, dtype=torch.bool, device=dev)   # not yet diverged
    for pobj in [obj] + ([GM.OBJ_E_GUARD] if obj == GM.OBJ_XE else []):
        active = live.clone()
        for _ in range(cap):
            _, kbi, _, kbase = GM.block_move_gains_cuda(
                N, mus, sizes, return_gains=False, P=Ps, objective=pobj)
            if pobj == GM.OBJ_X:
                gains, tie = GM._gains_body(N, mus, sizes), None
            else:
                gains, tie = GM._energy_gains_body(N, mus, Ps, sizes, pobj)
            pbi, _, pbase = GM._select_body(gains, tie)
            thr = GR._TOL32_BLOCK * (1.0 + GR.phase_scale(N, mus, Ps, pobj))
            kdo, pdo = kbase > thr, pbase > thr
            split = active & ((kdo != pdo) | (pdo & (kbi != pbi)))
            if bool(split.any()):
                near = torch.minimum(_ulps_from(kbase, thr),
                                     _ulps_from(pbase, thr)) <= 8
                d1 = pbi.long() % (k * l * l)
                clear = (direction_margins(gains, tie, pbase, pobj)
                         & ladder_clear(gains, d1))
                for i in torch.nonzero(split).flatten().tolist():
                    kind[i] = ("threshold" if bool(near[i]) else
                               "tie" if not bool(clear[i]) else "other")
                live = live & ~split
            active = active & ~split & pdo
            if not bool(active.any()):
                break
            N = _apply_moves(N, pbi, sizes, active)
    return kind


def energy_phase_fixed_points(mu_b, mix_b, N, P, dev):
    """Hold max-x-e targets N (B, k, l) to the plain version's own stopping
    rule: one plain float32 step of the energy phase (OBJ_E_GUARD) from N
    must find no move whose energy drop clears the phase's threshold, 1e-6
    * (1 + |E|). The plain bodies sum in the kernel's order, so a target the
    fused solve reports converged passes exactly, with no tolerance.
    Returns (points that fail, the largest (drop - threshold) / threshold)."""
    from repro_torch.core import grin as GR
    from repro_torch.kernels import grin_moves as GM
    _, mus, Ps, sizes, _, _ = GR._batch_inputs(
        mu_b, mix_b, None, None, "max-x-e", None, P, dev)
    gains, tie = GM._energy_gains_body(N, mus, Ps, sizes, GM.OBJ_E_GUARD)
    _, _, base = GM._select_body(gains, tie)
    thr = GR._TOL32_BLOCK * (1.0 + GR.phase_scale(N, mus, Ps,
                                                  GM.OBJ_E_GUARD))
    return int((base > thr).sum()), float(((base - thr) / thr).max())


def per_step_comparison(mu_b, mix_b, objective, dev, fused, P=None):
    """Solve the points again through the per-step loop with the plain
    scorer (the fused solve's plain version) and with the scorer kernel,
    and hold the fused solve's (N, converged, moves) `fused` for the same
    points to both: against the kernel loop, differences only at
    near-threshold steps (only the threshold's scale is computed apart, in
    the kernel and by phase_scale); against the plain loop, differences
    only where the first divergence is a near-threshold step or a near-tie
    (or the kernel loop explains it). `P` is the priced power matrix when
    mu_b is not the physical one. Returns the counts and times, with
    "failure" the first broken condition or None."""
    import numpy as np
    import torch
    from repro_torch.core.grin import grin_solve_batch_steps_torch
    from repro_torch.kernels import grin_moves as GM
    Nf, cf, mvf = fused

    def per_step(scorer):
        t0 = time.perf_counter()
        res = grin_solve_batch_steps_torch(mu_b, mix_b, objective=objective,
                                           P=P, device=dev, scorer=scorer)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def differing(res):
        Ns, _, cs_, mvs = res
        return np.flatnonzero((Nf != Ns).flatten(1).any(dim=1).cpu().numpy()
                              | (mvf != mvs).cpu().numpy()
                              | (cf != cs_).cpu().numpy())

    def sub(a, idx):
        return None if a is None else a[idx]

    plain, plain_ms = per_step(GM.block_move_scores_reference)
    steps_k, steps_ms = per_step(None)
    d_plain, d_steps = differing(plain), differing(steps_k)
    m_steps = (threshold_margin_ulps(mu_b[d_steps], mix_b[d_steps],
                                     objective, dev, P=sub(P, d_steps))
               if len(d_steps) else np.zeros(0))
    near_steps = int((m_steps <= 8).sum())
    kinds = (first_divergence(mu_b[d_plain], mix_b[d_plain], objective, dev,
                              P=sub(P, d_plain))
             if len(d_plain) else np.zeros(0, dtype=object))
    ok_steps = set(d_steps[m_steps <= 8].tolist())
    explained = np.array([kd in ("threshold", "tie") or i in ok_steps
                          for i, kd in zip(d_plain, kinds)], bool)
    n_thr = int(sum(kd == "threshold" for kd in kinds))
    n_tie = int(sum(kd == "tie" for kd in kinds))
    failure = None
    if near_steps != len(d_steps):
        failure = (f"{len(d_steps) - near_steps} points differ from the "
                   f"scorer-kernel loop away from the threshold ({objective})")
    elif not explained.all():
        failure = (f"{int((~explained).sum())} points differ from the plain "
                   f"loop away from the threshold and near-ties "
                   f"({objective})")
    elif not (bool(plain[2].all()) and bool(steps_k[2].all())
              and bool(cf.all())):
        failure = "the fused or a per-step solve did not converge"
    return {"plain": plain, "plain_ms": plain_ms, "steps_ms": steps_ms,
            "d_plain": len(d_plain), "d_steps": len(d_steps),
            "near_steps": near_steps, "n_thr": n_thr, "n_tie": n_tie,
            "failure": failure}


def phase_solver(dev, grids, host_check, detail):
    """Batched GrIn grids under max-x and max-x-e through the user's entry
    point (`solve_targets_grid_torch`: one launch of the fused solve, both
    phases of max-x-e included): every point converged, exact row sums,
    and every target a single-move local maximum of X_sys at the solver's
    float32 threshold (the best single move, scored in float64, gains at
    most 2e-6 * (1 + X_sys)). In the same run, uncounted, each grid is also
    solved by the fused solve's plain version (the per-step loop
    `grin_solve_batch_steps_torch` with the plain PyTorch scorer, its time
    the kernel's plain_ms) and by the per-step loop with the scorer kernel
    (one launch a step, printed beside). Targets must equal the fused
    solve's apart from points whose per-step trajectories meet a
    near-threshold step (a steepest gain within 8 float32 ulps of the
    threshold) or, against the plain scorer, a near-tie selection; both are
    counted. X_sys against the host float64 block solver is reported, not
    asserted: the batched solver's vectorised init can start it in another
    basin (see PERF.md). Returns the fused solver's summary entry."""
    import numpy as np
    import torch
    from repro_torch.core import grin_block_solve, system_throughput
    from repro_torch.core.grin import grin_solve_batch_torch
    from repro_torch.kernels import grin_moves as GM
    from repro_torch.kernels.grin_moves import _gains_body
    from repro_torch.sched import solve_targets_grid_torch
    out, entry = [], None
    for (G_, M_, seed) in grids:
        mus, mixes = skewed_grid(seed, G_, M_, K, L, N_TASKS)
        mu_b = np.repeat(mus, M_, axis=0)
        mix_b = np.tile(mixes, (G_, 1))
        for objective in ("max-x", "max-x-e"):
            before = GM.launches["grin_solve"]
            t0 = time.perf_counter()
            targets, xs, conv = solve_targets_grid_torch(
                mus, mixes, objective=objective, device=dev)
            dt = time.perf_counter() - t0
            n_launch = GM.launches["grin_solve"] - before
            if n_launch != 1:              # max-x-e's two phases included
                raise AssertionError(f"the grid took {n_launch} fused "
                                     f"launches ({objective})")
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

            # the comparisons: none of their launches count
            counted = dict(GM.launches)

            def fused():
                return grin_solve_batch_torch(mu_b, mix_b,
                                              objective=objective,
                                              device=dev)
            Nf, xf, cf, mvf = fused()
            torch.cuda.synchronize()
            ms = cuda_ms(fused, iters=3, warmup=1)

            cmp = per_step_comparison(mu_b, mix_b, objective, dev,
                                      (Nf, cf, mvf))
            GM.launches.update(counted)
            plain, plain_ms, steps_ms = (cmp["plain"], cmp["plain_ms"],
                                         cmp["steps_ms"])
            n_thr, n_tie, near_steps = (cmp["n_thr"], cmp["n_tie"],
                                        cmp["near_steps"])
            d_plain, d_steps = cmp["d_plain"], cmp["d_steps"]
            phases = 2 if objective == "max-x-e" else 1
            steps = int(mvf.sum()) + phases * len(mvf)
            M = _ladder_len(N_TASKS)
            bound, by, nbytes, ops = solve_bound(
                len(mvf), K, L, M, 0 if objective == "max-x" else 1, steps)
            err = float((xf - plain[1]).abs().max())
            row = {"grid": f"{G_}x{M_}", "objective": objective,
                   "points": G_ * M_, "seconds": dt,
                   "solves_per_s": G_ * M_ / dt,
                   "fused_launches": n_launch,
                   "fused_ms": ms, "fused_solves_per_s": G_ * M_ / ms * 1e3,
                   "plain_ms": plain_ms,
                   "plain_solves_per_s": G_ * M_ / plain_ms * 1e3,
                   "per_step_kernel_ms": steps_ms,
                   "per_step_kernel_solves_per_s": G_ * M_ / steps_ms * 1e3,
                   "max_moves": int(mvf.max()), "steps": steps,
                   "points_differing_from_plain": d_plain,
                   "plain_first_divergence": {
                       "threshold": n_thr, "tie": n_tie,
                       "other": int(d_plain - n_thr - n_tie)},
                   "points_differing_from_per_step_kernel": d_steps,
                   "near_threshold_vs_per_step_kernel": near_steps,
                   "max_abs_x_diff_vs_plain": err,
                   "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                   "ops": ops,
                   "max_rel_single_move_gain": float(lm.max()),
                   "host_checked": len(gaps),
                   "min_rel_gap_vs_host": float(gaps.min()),
                   "mean_rel_gap_vs_host": float(gaps.mean()),
                   "below_host_by_more_than_4e-6": int((gaps < -4e-6).sum())}
            out.append(row)
            print(f"  solver {row['grid']} {objective}: {dt:.3f} s, "
                  f"{row['solves_per_s']:.1f} solves/s through "
                  f"solve_targets_grid_torch ({n_launch} fused launch); "
                  f"fused solve {ms:.3f} ms ({row['fused_solves_per_s']:.0f} "
                  f"solves/s); plain per-step loop {plain_ms:.1f} ms "
                  f"({row['plain_solves_per_s']:.1f} solves/s); per-step "
                  f"loop with the scorer kernel {steps_ms:.1f} ms "
                  f"({row['per_step_kernel_solves_per_s']:.1f} solves/s); "
                  f"max moves {row['max_moves']}; bound {bound:.4f} ms "
                  f"({by})")
            print(f"    points differing from the plain loop {d_plain} "
                  f"(first divergence near-threshold {n_thr}, near-tie "
                  f"{n_tie}); from the scorer-kernel loop {d_steps} "
                  f"(near-threshold {near_steps}); local-max margin "
                  f"{lm.max():.2e}; vs host ({len(gaps)} points) min "
                  f"{gaps.min():.2e} mean {gaps.mean():.2e}")
            if lm.max() > 2e-6:
                raise AssertionError(f"a target is not a single-move local "
                                     f"maximum ({lm.max():.2e}, {objective})")
            if cmp["failure"]:
                raise AssertionError(cmp["failure"])
            if (G_, M_) == tuple(grids[-1][:2]) and objective == "max-x":
                entry = {"name": "grin_solve", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "grin_moves.cu",
                         "replaces": "src/repro/kernels/grin_moves.py:307, "
                                     "src/repro/core/grin.py:341",
                         "launches": 0, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "library_ms": None,
                         "points_differing_from_plain": d_plain,
                         "shape": f"B={len(mvf)},k={K},l={L},M={M},max-x,"
                                  f"whole solve"}
    mus, mixes = skewed_grid(grids[-1][2], grids[-1][0], grids[-1][1], K, L,
                             N_TASKS)
    prof = device_busy(lambda: solve_targets_grid_torch(mus, mixes,
                                                        device=dev))
    print(f"  solver profile ({grids[-1][0]}x{grids[-1][1]} max-x): wall "
          f"{prof['wall_s']:.3f} s, device busy share {prof['busy_share']}")
    detail["solver"] = out
    detail["solver_profile"] = prof
    return entry


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


def phase_engine(dev, n_mus, seeds, n_completions, warmup, detail,
                 pool=None):
    """Fig. 9 workload (3x3, N = 30 programs) on the batched engine: GrIn
    beats LB on the mean, and simulated X and E/task agree with the closed
    form of the solved target and, run for run, with the port's own host
    event core (same config and seed), at the conformance gates (15% per
    run, 5% mean)."""
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
    out, gaps_x, gaps_e, pairs = [], [], [], []
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
            for name, key in (("GrIn", "grin"), ("GrIn-E", "grin-e"),
                              ("LB", "lb"), ("JSQ", "jsq")):
                for s, m in zip(seeds, rows[name]):
                    pairs.append((dataclasses.replace(cfg, seed=int(s)),
                                  key, m))
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
    t0 = time.perf_counter()
    hosts = host_map(pool, host_run, [(c, key) for c, key, _ in pairs])
    t_host = time.perf_counter() - t0
    hx = np.array([abs(m.throughput - h.throughput) / h.throughput
                   for (_, _, m), h in zip(pairs, hosts)])
    he = np.array([abs(m.mean_energy - h.mean_energy) / h.mean_energy
                   for (_, _, m), h in zip(pairs, hosts)])
    t_all = time.perf_counter() - t_all
    gx, ge = np.asarray(gaps_x), np.asarray(gaps_e)
    detail["engine"] = {"runs": out, "seconds": t_all,
                        "x_gap_max": float(gx.max()),
                        "x_gap_mean": float(gx.mean()),
                        "e_gap_max": float(ge.max()),
                        "e_gap_mean": float(ge.mean()),
                        "host_runs": len(hosts), "host_seconds": t_host,
                        "x_gap_vs_host_max": float(hx.max()),
                        "x_gap_vs_host_mean": float(hx.mean()),
                        "e_gap_vs_host_max": float(he.max()),
                        "e_gap_vs_host_mean": float(he.mean())}
    print(f"  engine: sim vs closed form X gap max {gx.max():.3f} mean "
          f"{gx.mean():.3f}; E gap max {ge.max():.3f} mean {ge.mean():.3f}; "
          f"{t_all:.1f} s")
    print(f"  engine vs the host core ({len(hosts)} runs, {t_host:.1f} s): "
          f"X gap max {hx.max():.3f} mean {hx.mean():.3f}; E gap max "
          f"{he.max():.3f} mean {he.mean():.3f}")
    if gx.max() >= 0.15 or ge.max() >= 0.15 or gx.mean() >= 0.05 \
            or ge.mean() >= 0.05:
        raise AssertionError("simulation outside the conformance gates")
    if hx.max() >= 0.15 or he.max() >= 0.15 or hx.mean() >= 0.05 \
            or he.mean() >= 0.05:
        raise AssertionError("engine vs host core outside the conformance "
                             "gates")


# --------------------------------------------------------------- priority

PRIO_CLASS_N = (600, 5400)          # latency class, batch class (N = 6000)
PRIO_W = (4.0, 1.0)
PRIO_COMPARE, PRIO_HOST = 256, 64   # points held to the plain loop / host
# benchmarks/fig_priority.py::run() at its defaults
FIGP_WEIGHTS = (1.0, 2.0, 4.0, 8.0)
FIGP_POLICIES = ("grin-p", "grin", "lb", "jsq")
FIGP_CLASS_MIXES = ((2, 2, 2), (8, 8, 8))
FIGP_SAMPLES, FIGP_SEEDS, FIGP_SEED = 4, (0, 1, 2), 5
FIGP_COMPLETIONS, FIGP_WARMUP = 6000, 1200
# PRIO alone runs longer: strict priority leaves the batch class about an
# eighth of the completions, in long starved stretches, and single runs of
# it at the benchmark's 6,000 scatter past P_PT_TOL between two correct
# engines (PERF.md, section 6; the largest single run 0.117 at 32,000 on
# the CPU streams, 0.050 on the card at 48,000)
FIGP_PRIO_COMPLETIONS, FIGP_PRIO_WARMUP = 32000, 6400
P_PT_TOL, P_MEAN_TOL = 0.2, 0.08    # tests/test_conformance.py multi-class


def priority_grid(seed: int, G: int, M: int, k: int, l: int):
    """(G, k, l) affinities (`random_affinity_matrix`) and (M, C, k) class
    mixes: each class's tasks (PRIO_CLASS_N) split Dirichlet(0.3) over the
    types, as `skewed_grid` splits one class."""
    import numpy as np
    from repro_torch.core import random_affinity_matrix
    rng = np.random.default_rng(seed)
    mus = np.stack([random_affinity_matrix(rng, k, l) for _ in range(G)])
    mixes = np.array([[rng.multinomial(n, rng.dirichlet([0.3] * k))
                       for n in PRIO_CLASS_N] for _ in range(M)])
    return mus, mixes


def phase_priority(dev, G, M, detail, pool=None, fig=None):
    """The priority subsystem at full size. (1) GrIn-P target grids: G x M
    points of 4x6 affinities x two-class mixes (N = 6000, weights 4 : 1),
    solved through `get_policy("grin-p")` and `solve_targets_grid_torch`
    under max-x and max-x-e — one fused launch a grid on (C*k, l) = (8, 6)
    class-weighted rows. Every point converged with exact per-(class,
    type) row sums; every max-x target a single-move local maximum of the
    weighted X at the solver's float32 threshold, and every max-x-e target
    a fixed point of the plain float32 energy phase (its X margin is
    reported: the X-plateau phase may end below an X maximum). The same
    grid through `core.priority.grin_solve_priority_batch_torch` gives the
    same targets; PRIO_COMPARE of its points held, as in the solver phase,
    against the per-step loop with the plain scorer (differences only where
    the first divergence is a near-threshold step or a near-tie, counted)
    and with the scorer kernel (differences only at near-threshold steps);
    the weighted-X gap to the host float64 GrIn-P on PRIO_HOST points
    reported. (2) `priority_engine`: the priority benchmark's workload on
    the batched engine, held run for run to the port's host core. Returns
    the max-x solve's summary row."""
    import numpy as np
    import torch
    from repro_torch.core import PROPORTIONAL_POWER, system_throughput
    from repro_torch.core.priority import (flat_mu, flatten_mixes,
                                           grin_solve_priority_batch_torch,
                                           weighted_system_throughput)
    from repro_torch.kernels import grin_moves as GM
    from repro_torch.sched import get_policy, solve_targets_grid_torch
    C = len(PRIO_CLASS_N)
    pol = get_policy("grin-p", weights=PRIO_W)
    mus, cmixes = priority_grid(11, G, M, K, L)
    mus_f = np.stack([flat_mu(m, C) for m in mus])          # (G, C*K, L)
    mus_w = np.stack([pol.device_mu(m) for m in mus_f])     # w_c * mu rows
    mix_f = flatten_mixes(cmixes)                           # (M, C*K)
    mu_b = np.repeat(mus_w, M, axis=0)
    mix_b = np.tile(mix_f, (G, 1))
    mus_g, cmix_g = np.repeat(mus, M, axis=0), np.tile(cmixes, (G, 1, 1))
    pts = G * M
    step = max(1, pts // PRIO_COMPARE)
    sub = np.arange(0, pts, step)[:PRIO_COMPARE]
    hstep = max(1, pts // PRIO_HOST)
    hsub = np.arange(0, pts, hstep)[:PRIO_HOST]
    t0 = time.perf_counter()
    host_x = host_map(pool, host_grin_p, [
        (mus[i // M], cmixes[i % M], PRIO_W) for i in hsub])
    t_host = time.perf_counter() - t0
    rows = []
    for objective in ("max-x", "max-x-e"):
        P = (None if objective == "max-x" else
             np.stack([PROPORTIONAL_POWER.power_matrix(m) for m in mus_f]))
        P_b = None if P is None else np.repeat(P, M, axis=0)
        before = GM.launches["grin_solve"]
        t0 = time.perf_counter()
        targets, xs, conv = solve_targets_grid_torch(
            mus_w, mix_f, objective=objective, P=P, device=dev)
        dt = time.perf_counter() - t0
        n_launch = GM.launches["grin_solve"] - before
        if n_launch != 1:
            raise AssertionError(f"the grid took {n_launch} fused launches "
                                 f"({objective})")
        if not conv.all():
            raise AssertionError(f"{int((~conv).sum())} points did not "
                                 f"converge ({objective})")
        if not (targets.sum(axis=3) == mix_f[None]).all():
            raise AssertionError("per-(class, type) row sums not exact")
        flat = targets.reshape(pts, C * K, L)
        xw = np.array([system_throughput(n, m) for n, m in zip(flat, mu_b)])
        g1 = GM._gains_body(torch.as_tensor(flat, dtype=torch.float64),
                            torch.as_tensor(mu_b, dtype=torch.float64),
                            torch.ones(1, dtype=torch.float64))
        lm = (g1.reshape(pts, -1).max(dim=1).values.numpy() / (1 + xw))
        # the weighted X is the class-weighted objective of the (C, k, l)
        # placement under the physical affinities
        i0 = int(sub[-1])
        if abs(weighted_system_throughput(flat[i0].reshape(C, K, L),
                                          mus[i0 // M], PRIO_W)
               - xw[i0]) > 1e-9 * xw[i0]:
            raise AssertionError("weighted X != X of the weighted rows")
        gaps = (xw[hsub] - np.asarray(host_x)) / (1 + xw[hsub])

        # the comparisons: none of their launches count
        counted = dict(GM.launches)

        def fused():        # the same grid through the module's batch solve
            return grin_solve_priority_batch_torch(
                mus_g, cmix_g, PRIO_W, objective=objective, device=dev)
        Nc, _, cf, mvf = fused()
        torch.cuda.synchronize()
        Nf = Nc.reshape(pts, C * K, L)
        if not np.array_equal(Nf.cpu().numpy(), flat):
            raise AssertionError("grin_solve_priority_batch_torch and the "
                                 "policy's grid solve disagree")
        ms = cuda_ms(fused, iters=3, warmup=1)
        subt = torch.as_tensor(sub, device=Nf.device)
        cmp = per_step_comparison(
            mu_b[sub], mix_b[sub], objective, dev,
            (Nf[subt], cf[subt], mvf[subt]),
            P=None if P_b is None else P_b[sub])
        GM.launches.update(counted)
        n_thr, n_tie, near_steps = (cmp["n_thr"], cmp["n_tie"],
                                    cmp["near_steps"])
        d_plain, d_steps = cmp["d_plain"], cmp["d_steps"]
        plain_ms, steps_ms = cmp["plain_ms"], cmp["steps_ms"]
        not_fixed, fixed_margin = (
            energy_phase_fixed_points(mu_b, mix_b, Nf, P_b, dev)
            if objective == "max-x-e" else (0, None))
        phases = 2 if objective == "max-x-e" else 1
        steps = int(mvf.sum()) + phases * pts
        bound, by, nbytes, ops = solve_bound(
            pts, C * K, L, _ladder_len(sum(PRIO_CLASS_N)),
            0 if objective == "max-x" else 1, steps)
        row = {"grid": f"{G}x{M}", "objective": objective, "points": pts,
               "rows": C * K, "weights": list(PRIO_W), "seconds": dt,
               "solves_per_s": pts / dt, "fused_launches": n_launch,
               "fused_ms": ms, "fused_solves_per_s": pts / ms * 1e3,
               "max_moves": int(mvf.max()), "steps": steps,
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "ops": ops, "compared": len(sub),
               "plain_ms_compared": plain_ms,
               "per_step_kernel_ms_compared": steps_ms,
               "points_differing_from_plain": d_plain,
               "plain_first_divergence": {
                   "threshold": n_thr, "tie": n_tie,
                   "other": int(d_plain - n_thr - n_tie)},
               "points_differing_from_per_step_kernel": d_steps,
               "near_threshold_vs_per_step_kernel": near_steps,
               "max_rel_single_move_gain": float(lm.max()),
               "energy_phase_not_fixed": not_fixed,
               "energy_phase_max_rel_excess": fixed_margin,
               "host_checked": len(hsub),
               "host_seconds": t_host,
               "min_rel_gap_vs_host": float(gaps.min()),
               "mean_rel_gap_vs_host": float(gaps.mean()),
               "below_host_by_more_than_4e-6": int((gaps < -4e-6).sum())}
        rows.append(row)
        print(f"  grin-p {row['grid']} {objective} ((C*k, l) = ({C * K}, "
              f"{L}), w = {PRIO_W}): {dt:.3f} s, {row['solves_per_s']:.1f} "
              f"solves/s through solve_targets_grid_torch ({n_launch} fused "
              f"launch); fused solve {ms:.3f} ms "
              f"({row['fused_solves_per_s']:.0f} solves/s); max moves "
              f"{row['max_moves']}; bound {bound:.4f} ms ({by})")
        print(f"    {len(sub)} points vs the plain per-step loop "
              f"({plain_ms:.1f} ms): differing {d_plain} (first "
              f"divergence near-threshold {n_thr}, near-tie {n_tie}); vs "
              f"the scorer-kernel loop ({steps_ms:.1f} ms) {d_steps} "
              f"(near-threshold {near_steps}); local-max margin "
              f"{lm.max():.2e}; weighted X vs host GrIn-P "
              f"({len(hsub)} points) min {gaps.min():.2e} mean "
              f"{gaps.mean():.2e}")
        if objective == "max-x-e":
            print(f"    energy phase: {not_fixed} of {pts} targets not a "
                  f"fixed point of the plain float32 step; largest drop "
                  f"over the threshold {fixed_margin:.3e} (relative)")
        # max-x-e's second phase slides along the X plateau, each move
        # losing up to _XE_TIE * (1 + X): its targets end a float32 band
        # per plateau move below an X local maximum (reported, PERF.md)
        if objective == "max-x" and lm.max() > 2e-6:
            raise AssertionError(f"a target is not a single-move local "
                                 f"maximum of the weighted X ({lm.max():.2e}"
                                 f", {objective})")
        if not_fixed:
            raise AssertionError(f"{not_fixed} max-x-e targets are not fixed "
                                 f"points of the energy phase")
        if cmp["failure"]:
            raise AssertionError(cmp["failure"])

    detail["priority"] = {"solver": rows,
                          "engine": priority_engine(dev, fig, pool)}
    return rows[0]


def figp_runs(dev, fig, pool):
    """`benchmarks/fig_priority.py::run()`'s workload (its defaults, PRIO
    at FIGP_PRIO_COMPLETIONS, any of them replaced by the `fig` dict's) on
    the batched engine under PS, PRIO and FCFS, one batch an order, and
    each distinct (order, system, policy, seed) run
    again on the port's host core (same config and seed). Returns the
    engine's points (system, w0, policy, seed), its results and timings an
    order, one record per (order, point, class) against the host run, and
    the host core's seconds."""
    import numpy as np
    import torch
    from repro_torch.core import random_affinity_matrix
    from repro_torch.core.priority import class_of_flat, flat_mu, flatten_mixes
    from repro_torch.sched import get_policy
    from repro_torch.sched.priority import priority_sim_config
    from repro_torch.sim import make_distribution, simulate_batch
    from repro_torch.sim.engine_torch import (MODE_DEFICIT, _BASELINE_MODES,
                                              _types0_for)
    fig = {"samples": FIGP_SAMPLES, "seeds": FIGP_SEEDS,
           "n_completions": FIGP_COMPLETIONS, "warmup": FIGP_WARMUP,
           "prio_completions": FIGP_PRIO_COMPLETIONS,
           "prio_warmup": FIGP_PRIO_WARMUP, **(fig or {})}
    runs = {o: (fig["n_completions"], fig["warmup"]) for o in ("PS", "FCFS")}
    runs["PRIO"] = (fig["prio_completions"], fig["prio_warmup"])
    rng = np.random.default_rng(FIGP_SEED)
    systems = [random_affinity_matrix(rng, 3, 3)
               for _ in range(fig["samples"])]
    cm = np.array(FIGP_CLASS_MIXES)
    Cf, kf = cm.shape
    mixf = flatten_mixes(cm)
    cls = class_of_flat(Cf, kf)
    dist = make_distribution("exponential")
    seeds = list(fig["seeds"])
    keys, mu_e, tgt_e, modes, pols = [], [], [], [], {}
    for si, mu in enumerate(systems):
        mu_f = flat_mu(mu, Cf)
        for w0 in FIGP_WEIGHTS:
            for pname in FIGP_POLICIES:
                if pname == "grin-p":
                    p = get_policy("grin-p", weights=[w0, 1.0])
                    disp = f"GrIn-P(w={w0:g})"
                else:
                    p = get_policy(pname)
                    disp = p.name
                mode = (MODE_DEFICIT if p.needs_target
                        else _BASELINE_MODES[p.key])
                target = (np.asarray(p.solve_target(mu_f, mixf))
                          if p.needs_target else np.zeros(mu_f.shape,
                                                          np.int64))
                for s in seeds:
                    keys.append((si, w0, disp, s))
                    pols.setdefault((si, disp, s), p)
                    mu_e.append(mu_f)
                    tgt_e.append(target)
                    modes.append(mode)
    B = len(keys)
    res, eng = {}, {}
    for order in ("PS", "PRIO", "FCFS"):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[order] = simulate_batch(
            np.stack(mu_e), np.stack(tgt_e), np.tile(_types0_for(mixf),
                                                     (B, 1)),
            [k[3] for k in keys], distribution=dist, order=order,
            n_completions=runs[order][0], warmup_completions=runs[order][1],
            modes=np.asarray(modes), class_of_type=cls, device=dev)
        dt = time.perf_counter() - t0
        eng[order] = {"seconds": dt, "n_completions": runs[order][0],
                      "events_per_s": B * runs[order][0] / dt}
        print(f"  fig_priority engine {order}: {B} points x "
              f"{runs[order][0]} completions in {dt:.2f} s "
              f"({eng[order]['events_per_s']:.0f} events/s)")
    # each distinct (system, policy, seed) once: the class-blind policies
    # repeat over the weights with identical rows
    uniq = {}
    for i, (si, w0, disp, s) in enumerate(keys):
        uniq.setdefault((si, disp, s), i)
    jobs = []
    for order in ("PS", "PRIO", "FCFS"):
        for (si, disp, s) in uniq:
            cfg = priority_sim_config(
                systems[si], cm, distribution=dist, order=order,
                n_completions=runs[order][0],
                warmup_completions=runs[order][1], seed=s)
            jobs.append(((order, si, disp, s), (cfg, pols[(si, disp, s)])))
    t0 = time.perf_counter()
    hosts = host_map(pool, host_run, [j for _, j in jobs])
    t_host = time.perf_counter() - t0
    recs = []
    for ((order, si, disp, s), _), h in zip(jobs, hosts):
        i = uniq[(si, disp, s)]
        d = res[order]
        for c in range(Cf):
            hx, dx = float(h.class_throughput[c]), \
                float(d["class_throughput"][i][c])
            he, de = float(h.class_energy[c]), float(d["class_energy"][i][c])
            rec = {"order": order, "system": si, "policy": disp, "seed": s,
                   "class": c, "host_x": hx, "engine_x": dx,
                   "host_e": he, "engine_e": de,
                   "host_total_x": float(h.throughput),
                   "engine_total_x": float(d["throughput"][i])}
            if hx == 0 or dx == 0:      # strict priority starved the class
                rec["starved"] = True
            else:
                rec.update(starved=False, x_rel=abs(dx - hx) / hx,
                           e_rel=abs(de - he) / he)
            recs.append(rec)
    return {"fig": fig, "keys": keys, "res": res, "eng": eng,
            "recs": recs, "host_seconds": t_host, "host_runs": len(hosts)}


def priority_engine(dev, fig, pool):
    """The priority benchmark's workload on the engine, held run for run
    to the port's host core at the multi-class conformance gates of
    tests/test_conformance.py (per (run, class) X and E/task within
    P_PT_TOL, their means within P_MEAN_TOL; a class that strict priority
    starves must be starved on both engines), and PRIO cutting the latency
    class's mean response time against FCFS with the same placements.
    Returns the summary for the detail file."""
    import numpy as np
    out = figp_runs(dev, fig, pool)
    fig, keys, res, eng, recs = (out["fig"], out["keys"], out["res"],
                                 out["eng"], out["recs"])
    live = [r for r in recs if not r["starved"]]
    starved = [r for r in recs if r["starved"]]
    for r in starved:
        if not (r["host_x"] < 0.02 * r["host_total_x"]
                and r["engine_x"] < 0.02 * r["engine_total_x"]):
            raise AssertionError(f"class {r['class']} starved on one engine "
                                 f"only: {r}")
    x_rel = np.array([r["x_rel"] for r in live])
    e_rel = np.array([r["e_rel"] for r in live])
    worst = sorted(live, key=lambda r: -max(r["x_rel"], r["e_rel"]))[:8]
    lat = {o: np.array([res[o]["class_response_time"][i][0]
                        for i, k in enumerate(keys)
                        if k[2].startswith("GrIn-P")]) for o in ("PRIO",
                                                                 "FCFS")}
    gain = float(lat["FCFS"].mean() / lat["PRIO"].mean())
    xw = {}
    for i, (si, w0, disp, s) in enumerate(keys):
        xw.setdefault((si, w0, disp), []).append(
            float(np.dot([w0, 1.0], res["PS"]["class_throughput"][i])))
    n_sys = 1 + max(k[0] for k in keys)
    over_lb = [np.mean(xw[(si, w0, f"GrIn-P(w={w0:g})")])
               / np.mean(xw[(si, w0, "LB")])
               for si in range(n_sys) for w0 in FIGP_WEIGHTS]
    summary = {"points": len(keys), "class_mixes": [list(m) for m in
                                                    FIGP_CLASS_MIXES],
               "weights": list(FIGP_WEIGHTS), "seeds": list(fig["seeds"]),
               "orders": eng,
               "host_runs": out["host_runs"],
               "host_seconds": out["host_seconds"],
               "checked": len(live), "starved": len(starved),
               "x_rel_max": float(x_rel.max()),
               "x_rel_mean": float(x_rel.mean()),
               "e_rel_max": float(e_rel.max()),
               "e_rel_mean": float(e_rel.mean()),
               "x_rel_at_or_over_tol": int((x_rel >= P_PT_TOL).sum()),
               "e_rel_at_or_over_tol": int((e_rel >= P_PT_TOL).sum()),
               "by_order": {o: {"x_rel_max": max(r["x_rel"] for r in live
                                                 if r["order"] == o),
                                "e_rel_max": max(r["e_rel"] for r in live
                                                 if r["order"] == o)}
                            for o in eng},
               "worst": worst,
               "class0_response_fcfs_over_prio": gain,
               "grin_p_over_lb_weighted_x": [float(min(over_lb)),
                                             float(max(over_lb))]}
    print(f"  fig_priority vs the host core ({out['host_runs']} runs, "
          f"{out['host_seconds']:.1f} s), {len(live)} (run, class) points, "
          f"{len(starved)} starved on both: per-class X max "
          f"{x_rel.max():.3f} mean {x_rel.mean():.3f}; E/task max "
          f"{e_rel.max():.3f} mean {e_rel.mean():.3f}; at or over "
          f"{P_PT_TOL}: X {summary['x_rel_at_or_over_tol']}, E "
          f"{summary['e_rel_at_or_over_tol']}; worst {worst[0]}")
    print("    X / E max by order: " + "; ".join(
        f"{o} {v['x_rel_max']:.3f} / {v['e_rel_max']:.3f} "
        f"({eng[o]['n_completions']} completions)"
        for o, v in summary["by_order"].items()))
    print(f"  GrIn-P class-0 mean response FCFS / PRIO {gain:.2f}x; "
          f"GrIn-P / LB weighted X {min(over_lb):.2f}x-{max(over_lb):.2f}x")
    if x_rel.max() >= P_PT_TOL or e_rel.max() >= P_PT_TOL \
            or x_rel.mean() >= P_MEAN_TOL or e_rel.mean() >= P_MEAN_TOL:
        raise AssertionError("priority engine outside the multi-class gates")
    if not lat["PRIO"].mean() < lat["FCFS"].mean():
        raise AssertionError("PRIO did not cut class 0's response time")
    return summary


# ------------------------------------------------ open traffic and faults

# benchmarks/fig_traffic.py at its defaults: two classes (a light latency
# stream, the dominant batch stream) on a diagonal 2x2, swept from half
# load to 1.2x the knee, six variants x six loads x three seeds
OPEN_SHARES = (0.25, 0.75)          # latency class, batch class
OPEN_WEIGHTS = (2.0, 1.0)           # GrIn-P / CAB-P class weights
TRAFFIC_MU = ((8.0, 2.0), (2.0, 6.0))
TRAFFIC_QCAP = 8
TRAFFIC_DEADLINES = (1.25, 10.0)
TRAFFIC_UTILS = (0.5, 0.7, 0.85, 0.95, 1.05, 1.2)
TRAFFIC_VARIANTS = ("grin-p", "cab-p", "lb", "jsq", "jsq+adm", "grin-p+adm")
# benchmarks/fig_faults.py at its defaults: a 2x4 system at u = 1.1 under a
# two-burst storm and 2% transient failures, six variants x three seeds
FAULTS_MU = ((12.0, 2.0, 2.0, 1.5), (1.5, 9.0, 2.0, 8.0))
FAULTS_U, FAIL_PROB, CKPT_PERIOD = 1.1, 0.02, 0.05
# the scale point: the solver benchmark's 4x6 affinities, two classes over
# four types, 256-deep queues (1,536 slots a point), a three-burst storm
FLEET_CLS = (0, 0, 1, 1)
FLEET_QCAP, FLEET_U = 256, 0.95
OPEN_FIG = {"n_arrivals": 20000, "warmup": 2000, "seeds": (0, 1, 2),
            "fleet_oracle_s": 60.0, "busy_arrivals": 100}
X_REL, P99_REL = 0.05, 0.30         # fig_traffic.py's host-vs-device gates
LITTLE_REL = 0.05                   # occupancy vs X * E[T] on the window


def knee(mu, shares):
    """fig_traffic.py's / fig_faults.py's saturation knee: each task type
    (there, one per class) alone on its fastest pool; `shares` are the
    types' arrival shares."""
    return 1.0 / max(s / max(row) for s, row in zip(shares, mu))


def open_policy(pname):
    """A variant's policy: the class-weighted priority policies, or a
    baseline by name."""
    from repro_torch.sched import get_policy
    if pname in ("grin-p", "cab-p"):
        return get_policy(pname, weights=OPEN_WEIGHTS)
    return get_policy(pname)


def host_open(job):
    """One run of the port's host open loop (with faults, the host fault
    loop): job = (SimConfig, policy name). Host float64 code with the
    SchedulerCore on "cpu", so it runs in the pool of host processes."""
    from repro_torch.sim import ClosedNetworkSimulator
    cfg, pname = job
    t0 = time.perf_counter()
    m = ClosedNetworkSimulator(cfg, device="cpu").run(open_policy(pname))
    return m, time.perf_counter() - t0


def torch_sync(dev):
    """A barrier for `dev` (a no-op on the CPU)."""
    import torch
    if dev.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def open_record(out, i, host):
    """Engine point i of `out` against its host oracle run: total X, and
    per class X, E/task and p99 (a class with no completions on either
    side is recorded as starved)."""
    import numpy as np
    rec = {"x_host": host.throughput, "x_engine": float(out["throughput"][i]),
           "x_rel": abs(float(out["throughput"][i]) - host.throughput)
           / host.throughput, "classes": []}
    for c in range(len(host.class_throughput)):
        hx, dx = host.class_throughput[c], out["class_throughput"][i][c]
        row = {"x_host": float(hx), "x_engine": float(dx)}
        if hx == 0 or dx == 0:
            row["starved"] = True
            row["starved_disagree"] = bool(
                max(hx / host.throughput,
                    dx / max(out["throughput"][i], 1e-30)) > 0.02)
        else:
            he, de = host.class_energy[c], out["class_energy"][i][c]
            hp = host.class_quantiles[c][1]
            dp = out["class_quantiles"][i][c][1]
            row.update(x_rel=float(abs(dx - hx) / hx),
                       e_rel=float(abs(de - he) / he), p99_host=float(hp),
                       p99_engine=float(dp),
                       p99_rel=float(abs(dp - hp) / hp))
        rec["classes"].append(row)
    return rec


def open_gates(recs):
    """The engine against the host oracle over every point with an oracle
    run (each record has its "cell": the point without its seed):
    fig_traffic.py's gates, total X within X_REL at every point and each
    class's p99 within P99_REL on the benchmarks' own p99 statistic, the
    mean over a cell's seeds (fig_traffic.py's curves and fig_faults.py's
    latency_p99 are seed means; a single run's p99 under a storm moves by
    +-20% with the size stream alone, PERF.md section 6); and the
    multi-class conformance gates of tests/test_conformance.py over every
    (point, class), X and E/task within P_PT_TOL and their means within
    P_MEAN_TOL, a class starved on one side starved on both. Returns
    (summary, failures)."""
    import numpy as np
    rows = [c for r in recs for c in r["classes"] if not c.get("starved")]
    x_rel = np.array([c["x_rel"] for c in rows])
    e_rel = np.array([c["e_rel"] for c in rows])
    tot = np.array([r["x_rel"] for r in recs])
    cells = {}
    for r in recs:
        for c, row in enumerate(r["classes"]):
            if not row.get("starved"):
                h, d = cells.setdefault((tuple(r["cell"]), c), ([], []))
                h.append(row["p99_host"])
                d.append(row["p99_engine"])
    p99 = np.array([abs(np.mean(d) - np.mean(h)) / np.mean(h)
                    for h, d in cells.values()])
    summary = {"points": len(recs), "classes": len(rows),
               "cells": len(cells), "max_x_rel": float(tot.max()),
               "max_class_x_rel": float(x_rel.max()),
               "mean_class_x_rel": float(x_rel.mean()),
               "max_class_e_rel": float(e_rel.max()),
               "mean_class_e_rel": float(e_rel.mean()),
               "max_cell_p99_rel": float(p99.max()),
               "mean_cell_p99_rel": float(p99.mean()),
               "max_point_p99_rel": float(max(c["p99_rel"] for c in rows))}
    fails = []
    if tot.max() >= X_REL:
        fails.append(f"total X rel {tot.max():.3f} >= {X_REL}")
    if p99.max() >= P99_REL:
        fails.append(f"class p99 rel {p99.max():.3f} >= {P99_REL}")
    for name, v in (("X", x_rel), ("E/task", e_rel)):
        if v.max() >= P_PT_TOL or v.mean() >= P_MEAN_TOL:
            fails.append(f"class {name} rel max {v.max():.3f} / mean "
                         f"{v.mean():.3f} vs {P_PT_TOL} / {P_MEAN_TOL}")
    if any(c.get("starved_disagree") for r in recs for c in r["classes"]):
        fails.append("a class is starved on one engine only")
    return summary, fails


def conservation_gaps(out, T, W, rows):
    """offered - dropped - completed - (in system at t_end - in system at
    t_warm) for batch rows `rows`: 0 exactly when every in-window arrival
    is accounted for (runs without hedged copies)."""
    import numpy as np
    rows = np.asarray(list(rows))
    return ((T - W) - out["dropped"][rows] - out["completed"][rows]
            - (out["in_system_end"][rows] - out["in_system_warm"][rows]))


def little_rel(out, rows):
    """|time-averaged population - X * E[T]| / population over the
    window, for batch rows `rows` (Little's law)."""
    import numpy as np
    rows = np.asarray(list(rows))
    occ = out["state_occupancy"][rows].sum(axis=(1, 2))
    return np.abs(occ - out["little_product"][rows]) / occ


def run_open_batch(dev, batch, key, detail, busy_batch=None):
    """One `simulate_open_batch` call on `batch` (its keyword arguments),
    timed; with `busy_batch` (the same points at fewer arrivals: one
    captured chunk) a second call, profiled, gives the loop's device time a
    step, and so the device busy share of the timed call (the profiler's
    event sort takes minutes over a whole run). Returns the result and its
    row for the detail file."""
    import numpy as np
    from repro_torch.traffic import simulate_open_batch
    sync = torch_sync(dev)
    sync()
    t0 = time.perf_counter()
    out = simulate_open_batch(device=dev, **batch)
    sync()
    wall = time.perf_counter() - t0
    ev = int(np.sum(out["events"]))
    row = {"points": len(batch["seeds"]),
           "arrivals": int(batch["arr_times"].shape[1]),
           "steps": out["steps"], "events": ev, "seconds": wall,
           "events_per_s": ev / wall,
           "ms_per_step": wall / out["steps"] * 1e3}
    busy = None
    if busy_batch is not None and dev.type == "cuda":
        prof = []
        row["busy"] = device_busy(lambda: prof.append(simulate_open_batch(
            device=dev, **busy_batch)), cpu=False)
        row["busy"].update(arrivals=int(busy_batch["arr_times"].shape[1]),
                           steps=prof[0]["steps"])
        if row["busy"]["device_s"]:
            row["device_ms_per_step"] = (row["busy"]["device_s"]
                                         / prof[0]["steps"] * 1e3)
            busy = row["busy_share"] = (row["device_ms_per_step"]
                                        / row["ms_per_step"])
    detail.setdefault("open", {})[key] = row
    print(f"  {key}: {row['points']} points x {row['arrivals']} arrivals, "
          f"{row['steps']} steps, {ev} events in {wall:.1f} s "
          f"({row['events_per_s']:.0f} events/s, "
          f"{row['ms_per_step']:.3f} ms a step); device busy share {busy}")
    return out, row


def phase_traffic(dev, detail, pool=None, fig=None):
    """`benchmarks/fig_traffic.py::run()`'s workload at its defaults: six
    variants x six loads x three seeds (108 points) in ONE
    `simulate_open_batch` call, held to the port's host open loop
    (`run_open`, same arrival realizations) at every point (`open_gates`),
    to conservation, and to the benchmark's own claims (the knee,
    isolation, admission). The targets are the policies' host solves, so
    no kernel is on this path."""
    import numpy as np
    from repro_torch.sim import make_distribution
    from repro_torch.sim.engine_torch import MODE_DEFICIT, _BASELINE_MODES
    from repro_torch.traffic import (LogHistogram, PoissonArrivals,
                                     TrafficSpec, derive_target_mix,
                                     open_sim_config)
    fig = {**OPEN_FIG, **(fig or {})}
    T, W, seeds = fig["n_arrivals"], fig["warmup"], fig["seeds"]
    utils = fig.get("utils", TRAFFIC_UTILS)
    mu = np.asarray(TRAFFIC_MU)
    l = mu.shape[1]
    n_slots = l * TRAFFIC_QCAP
    xk = knee(mu, OPEN_SHARES)
    dist = make_distribution("exponential")
    specs = {u: TrafficSpec(tuple(PoissonArrivals(u * xk * s)
                                  for s in OPEN_SHARES), np.eye(2))
             for u in utils}
    arr = {(u, s): specs[u].sample(s, T) for u in utils for s in seeds}
    mix = derive_target_mix(specs[max(utils)], l, TRAFFIC_QCAP)
    admit = {v: [n_slots, TRAFFIC_QCAP // 2] if v.endswith("+adm")
             else [n_slots, n_slots] for v in TRAFFIC_VARIANTS}
    points = [(v, u, s) for v in TRAFFIC_VARIANTS for u in utils
              for s in seeds]
    route = {}
    for v in TRAFFIC_VARIANTS:
        pol = open_policy(v.split("+")[0])
        route[v] = ((MODE_DEFICIT, np.asarray(pol.solve_target(mu, mix)))
                    if pol.needs_target else
                    (_BASELINE_MODES[pol.key], np.zeros(mu.shape, np.int64)))

    # the oracle runs (every point) start first and overlap the card's run
    matched = list(range(len(points)))
    jobs = [(open_sim_config(
        mu, specs[u], n_arrivals=T, warmup_arrivals=W,
        queue_capacity=TRAFFIC_QCAP, admit_limits=admit[v],
        deadlines=np.asarray(TRAFFIC_DEADLINES), class_of_type=[0, 1],
        target_mix=mix, distribution=dist, order="PS", seed=s),
        v.split("+")[0]) for v, u, s in (points[i] for i in matched)]
    pending = (pool.map_async(host_open, jobs, chunksize=1)
               if pool is not None else None)

    batch = dict(
        mu=mu, targets=np.stack([route[v][1] for v, _, _ in points]),
        arr_times=np.stack([arr[(u, s)][0] for _, u, s in points]),
        arr_types=np.stack([arr[(u, s)][1] for _, u, s in points]),
        seeds=[s for _, _, s in points], distribution=dist,
        queue_capacity=TRAFFIC_QCAP, order="PS", warmup_arrivals=W,
        modes=np.array([route[v][0] for v, _, _ in points]),
        class_of_type=[0, 1],
        admit_limits=np.array([admit[v] for v, _, _ in points]),
        hist=LogHistogram(), deadlines=np.asarray(TRAFFIC_DEADLINES))
    out, row = run_open_batch(dev, batch, "traffic", detail,
                              busy_batch=shorter(batch,
                                                 fig["busy_arrivals"]))

    t0 = time.perf_counter()
    hosts = (pending.get() if pending is not None
             else [host_open(j) for j in jobs])
    wait = time.perf_counter() - t0
    recs = []
    for i, (h, secs) in zip(matched, hosts):
        rec = open_record(out, i, h)
        rec.update(point=list(points[i]), cell=list(points[i][:2]),
                   host_s=secs)
        recs.append(rec)
    summary, fails = open_gates(recs)
    gaps = conservation_gaps(out, T, W, range(len(points)))
    if np.abs(gaps).max() > 0:
        fails.append(f"conservation off by {int(np.abs(gaps).max())}")

    # the benchmark's claims, on the seed means (fig_traffic.py:145-173)
    offered = {(u, s): np.bincount(arr[(u, s)][1][W:], minlength=2)
               for u in utils for s in seeds}

    host_m = {i: h for i, (h, _) in zip(matched, hosts)}

    def stat(v, u, key, c=None, host=False):
        """A seed mean of the engine's (or, with `host`, the host
        oracle's) results at variant v and load u."""
        idx = [i for i, p in enumerate(points) if p[:2] == (v, u)]
        if host:
            hm = [host_m[i] for i in idx]
            return float(np.mean([
                m.class_quantiles[c][1] if key == "p99" else
                m.class_dropped[c] / max(offered[points[i][1:]][c], 1)
                for i, m in zip(idx, hm)]))
        if key == "goodput":
            return float(np.mean(out["throughput"][idx]))
        if key == "drop_frac":
            vals = np.array([out["class_dropped"][i]
                             / np.maximum(offered[points[i][1:]], 1)
                             for i in idx])
        elif key == "deadline_met":
            vals = out["class_deadline_met"][idx]
        else:
            vals = out["class_quantiles"][idx][:, :, 1]      # p99
        return float(vals.mean(axis=0)[c])
    u_hi, u_lo = max(utils), min(utils)
    # The knee claim's p99 factor of 1.5 sits within the histogram's
    # resolution for cab-p (exact ratio ~1.53; engine quantiles move in
    # bins of g = 7.5%, PERF.md section 6). So the claim is held on the
    # host oracle's exact quantiles at the same points, and the engine's
    # ratio to it within one bin; the drop fractions are exact on both.
    g = LogHistogram().growth
    claims = {}
    for v in ("grin-p", "cab-p", "lb", "jsq"):
        c = {}
        for side, host in (("engine", False), ("host", True)):
            c[side] = {"batch_p99_ratio": stat(v, u_hi, "p99", 1, host)
                       / stat(v, u_lo, "p99", 1, host),
                       "batch_drop_hi": stat(v, u_hi, "drop_frac", 1, host),
                       "batch_drop_lo": stat(v, u_lo, "drop_frac", 1, host)}
        claims[v] = c
        e, h = c["engine"], c["host"]
        if not (h["batch_p99_ratio"] > 1.5 and e["batch_p99_ratio"] * g > 1.5
                and all(x["batch_drop_hi"] > 0.05 > x["batch_drop_lo"]
                        for x in (e, h))):
            fails.append(f"no saturation knee for {v}: {c}")
    iso = stat("jsq", u_hi, "p99", 0) / stat("grin-p", u_hi, "p99", 0)
    gp = stat("grin-p", u_hi, "goodput") / stat("jsq", u_hi, "goodput")
    claims.update(isolation_p99_ratio=iso, goodput_ratio=gp)
    if not (iso > 2.0 and gp > 1.05):
        fails.append(f"isolation claim broken (p99 ratio {iso:.2f}, "
                     f"goodput ratio {gp:.3f})")
    adm = {"protected_drop_frac": stat("jsq+adm", u_hi, "drop_frac", 0),
           "best_effort_shed_frac": stat("jsq+adm", u_hi, "drop_frac", 1),
           "protected_p99_without": stat("jsq", u_hi, "p99", 0),
           "protected_p99_with": stat("jsq+adm", u_hi, "p99", 0),
           "deadline_met_without": stat("jsq", u_hi, "deadline_met", 0),
           "deadline_met_with": stat("jsq+adm", u_hi, "deadline_met", 0)}
    claims["admission"] = adm
    if not (adm["protected_drop_frac"] < 0.01
            and adm["best_effort_shed_frac"] > 0.10
            and adm["protected_p99_with"] < adm["protected_p99_without"]
            and adm["deadline_met_with"] > adm["deadline_met_without"]):
        fails.append(f"admission claim broken {adm}")
    row.update(gates=summary, claims=claims, oracle_wait_s=wait,
               host_seconds=[r["host_s"] for r in recs], records=recs)
    print(f"  traffic vs host ({len(recs)} points): {summary}")
    knees = {v: (round(claims[v]["engine"]["batch_p99_ratio"], 3),
                 round(claims[v]["host"]["batch_p99_ratio"], 3))
             for v in ("grin-p", "cab-p", "lb", "jsq")}
    print(f"  claims: batch p99 past the knee (engine, host) {knees}, "
          f"isolation {iso:.2f}x, goodput {gp:.3f}x, "
          f"admission p99 {adm['protected_p99_without']:.2f} -> "
          f"{adm['protected_p99_with']:.2f}")
    if fails:
        raise AssertionError("; ".join(fails))
    return row


class SegmentGrids:
    """Records every grid `segment_targets` (or the module `mod` that
    calls `solve_targets_grid_torch`) hands to the batched solver — its
    rows, mix, targets and the wall time of the call — while a phase drives
    its path."""

    def __init__(self, dev, mod=None):
        self.dev, self.grids, self._mod = dev, [], mod

    def __enter__(self):
        if self._mod is None:
            from repro_torch.faults import targets as FT
            self._mod = FT
        FT = self._mod
        self._orig = FT.solve_targets_grid_torch
        sync = torch_sync(self.dev)

        def solve(mus, mixes, **kw):
            sync()
            t0 = time.perf_counter()
            res = self._orig(mus, mixes, **kw)
            sync()
            self.grids.append({"mus": mus, "mixes": mixes, "kw": kw,
                               "targets": res[0],
                               "wall_ms": (time.perf_counter() - t0) * 1e3})
            return res
        FT.solve_targets_grid_torch = solve
        return self

    def __exit__(self, *exc):
        self._mod.solve_targets_grid_torch = self._orig


def check_segment_grids(dev, grids):
    """Every recorded segment grid: targets with exact row sums, each a
    single-move local maximum of X_sys on the grid's (class-weighted)
    rows at the solver's 2e-6 threshold, and equal to the plain per-step
    loop's (`grin_solve_batch_steps_torch` with the plain scorer) on the
    same rows. Times the fused solve of each grid (device ms). Launches
    made here are not the path's: the caller restores the counts."""
    import numpy as np
    import torch
    from repro_torch.core.grin import (grin_solve_batch_steps_torch,
                                       grin_solve_batch_torch)
    from repro_torch.core.throughput import system_throughput
    from repro_torch.kernels import grin_moves as GM
    from repro_torch.sched.api import _repair_targets
    rows = []
    for g in grids:
        mus, mix = np.asarray(g["mus"]), np.asarray(g["mixes"])
        mix_b = np.repeat(mix, len(mus), axis=0)
        tg = np.asarray(g["targets"])[:, 0]
        if not (tg.sum(axis=2) == mix_b).all():
            raise AssertionError("segment targets: row sums not exact")
        x64 = np.array([system_throughput(n, m) for n, m in zip(tg, mus)])
        g1 = GM._gains_body(torch.as_tensor(tg, dtype=torch.float64),
                            torch.as_tensor(mus, dtype=torch.float64),
                            torch.ones(1, dtype=torch.float64))
        lm = g1.reshape(len(tg), -1).max(dim=1).values.numpy() / (1 + x64)
        obj = g["kw"].get("objective", "max-x")
        plain = grin_solve_batch_steps_torch(
            mus, mix_b, objective=obj, device=dev,
            scorer=GM.block_move_scores_reference)
        tp = _repair_targets(plain[0].cpu().numpy(), mix_b)
        n_diff = int((tp != tg).reshape(len(tg), -1).any(axis=1).sum())
        row = {"segments": len(tg), "rows": int(mus.shape[1]),
               "pools": int(mus.shape[2]), "wall_ms": g["wall_ms"],
               "max_rel_single_move_gain": float(lm.max()),
               "points_differing_from_plain": n_diff}
        if dev.type == "cuda":
            row["fused_ms"] = cuda_ms(lambda: grin_solve_batch_torch(
                mus, mix_b, objective=obj, device=dev), iters=5, warmup=1)
        rows.append(row)
        if lm.max() > 2e-6:
            raise AssertionError(f"a segment target is not a single-move "
                                 f"local maximum ({lm.max():.2e})")
        if n_diff:
            raise AssertionError(f"{n_diff} segment targets differ from the "
                                 f"plain per-step loop")
    return rows


def faults_workload(T, W, seeds):
    """fig_faults.py's workload: (mu, class-of-type, spec, arrivals by
    seed, storm, tight target mix, variants as (name, policy name,
    FaultScenario))."""
    import numpy as np
    from repro_torch.faults import FaultScenario, make_storm
    from repro_torch.traffic import PoissonArrivals, TrafficSpec
    mu = np.asarray(FAULTS_MU)
    l = mu.shape[1]
    xk = knee(mu, OPEN_SHARES)
    spec = TrafficSpec(tuple(PoissonArrivals(FAULTS_U * xk * s)
                             for s in OPEN_SHARES), np.eye(2))
    arr = {s: spec.sample(s, T) for s in seeds}
    storm = storm_for(arr, W, l, n_bursts=2)
    # fig_faults.py's TIGHT target mix, ~2 tasks a pool by traffic share
    mix = np.maximum(1, np.round(np.asarray(OPEN_SHARES) * 2 * l)
                     ).astype(np.int64)

    def sc(**kw):
        return FaultScenario(events=storm, fail_prob=FAIL_PROB, **kw)
    variants = [("grin-p", "grin-p", sc()),
                ("grin-p+refresh", "grin-p", sc(refresh_targets=True)),
                ("grin-p+refresh+hedge", "grin-p",
                 sc(refresh_targets=True, hedge_classes=(0,))),
                ("grin-p+refresh+ckpt", "grin-p",
                 sc(refresh_targets=True, ckpt_period=CKPT_PERIOD)),
                ("lb", "lb", sc()), ("jsq", "jsq", sc())]
    return mu, [0, 1], spec, arr, storm, mix, variants


def storm_for(arr, W, l, n_bursts):
    """fig_faults.py's storm: bursts of two pools inside the measurement
    window of the shortest realization, each down 6% of the window."""
    from repro_torch.faults import make_storm
    t_end = min(float(t[-1]) for t, _ in arr.values())
    t_w = max(float(t[W - 1]) for t, _ in arr.values()) if W else 0.0
    return make_storm(l, n_bursts=n_bursts, group_size=2,
                      window=(t_w + 0.15 * (t_end - t_w),
                              t_w + 0.65 * (t_end - t_w)),
                      downtime=0.06 * (t_end - t_w), seed=11)


def fleet_workload(T, W, seeds):
    """The scale point: (mu, class-of-type, spec, arrivals by seed, storm,
    tight target mix, [("grin-p+refresh", "grin-p", FaultScenario)],
    knee)."""
    import numpy as np
    from repro_torch.faults import FaultScenario
    from repro_torch.traffic import PoissonArrivals, TrafficSpec
    mus, _ = skewed_grid(0, 1, 1, K, L, N_TASKS)
    mu = mus[0]
    probs = np.array([[0.5, 0.5, 0.0, 0.0], [0.0, 0.0, 0.5, 0.5]])
    p_type = np.asarray(OPEN_SHARES) @ probs
    xk = knee(mu, p_type)
    spec = TrafficSpec(tuple(PoissonArrivals(FLEET_U * xk * s)
                             for s in OPEN_SHARES), probs)
    arr = {s: spec.sample(s, T) for s in seeds}
    storm = storm_for(arr, W, L, n_bursts=3)
    mix = np.maximum(1, np.round(p_type * 2 * L)).astype(np.int64)
    sc = FaultScenario(events=storm, fail_prob=FAIL_PROB,
                       refresh_targets=True)
    return mu, list(FLEET_CLS), spec, arr, storm, mix, [
        ("grin-p+refresh", "grin-p", sc)], xk


def open_fault_batch(dev, work, T, W, seeds, qcap):
    """The keyword arguments of one `simulate_open_batch` call over every
    (variant, seed) point of a fault workload (its FaultBatch built here,
    with the refreshed segment targets solved on `dev`), the points, and
    the oracle configs. The workload's variants are (name, policy name,
    FaultScenario), run at every seed, or already points (name, policy
    name, FaultScenario, seed)."""
    import numpy as np
    from repro_torch.faults import build_fault_batch
    from repro_torch.sim import make_distribution
    from repro_torch.sim.engine_torch import MODE_DEFICIT, _BASELINE_MODES
    from repro_torch.traffic import open_sim_config
    mu, cls, spec, arr, storm, mix, variants = work[:7]
    dist = make_distribution("exponential")
    points = ([(v, p, sc, s) for v, p, sc in variants for s in seeds]
              if len(variants[0]) == 3 else list(variants))
    pols = [open_policy(p) for _, p, _, _ in points]
    tg = np.stack([np.asarray(pol.solve_target(mu, mix)) if pol.needs_target
                   else np.zeros(mu.shape, np.int64) for pol in pols])
    modes = np.array([MODE_DEFICIT if pol.needs_target
                      else _BASELINE_MODES[pol.key] for pol in pols])

    fb = build_fault_batch(
        [sc for _, _, sc, _ in points], mu, tg,
        seeds=[s for *_, s in points], mode="open",
        policies=[pol if pol.needs_target else None for pol in pols],
        mixes=mix, n_arrivals=T, n_classes=2, device=dev)
    batch = dict(mu=mu, targets=tg,
                 arr_times=np.stack([arr[s][0] for *_, s in points]),
                 arr_types=np.stack([arr[s][1] for *_, s in points]),
                 seeds=[s for *_, s in points], distribution=dist,
                 queue_capacity=qcap, order="PS", warmup_arrivals=W,
                 modes=modes, class_of_type=cls, faults=fb)
    cfgs = [open_sim_config(mu, spec, n_arrivals=T, warmup_arrivals=W,
                            queue_capacity=qcap, class_of_type=cls,
                            target_mix=mix, distribution=dist, order="PS",
                            seed=s, faults=sc) for _, _, sc, s in points]
    return batch, points, cfgs


def shorter(batch, n):
    """The same open batch cut to its first n arrivals (warmup n // 10;
    fault breakpoints past the new horizon never fire)."""
    import dataclasses
    fb = batch.get("faults")
    return dict(batch, arr_times=batch["arr_times"][:, :n],
                arr_types=batch["arr_types"][:, :n],
                warmup_arrivals=min(batch["warmup_arrivals"], n // 10),
                **({} if fb is None else {"faults": dataclasses.replace(
                    fb, fail_counts=fb.fail_counts[:, :n])}))


def phase_faults(dev, detail, pool=None, fig=None):
    """`benchmarks/fig_faults.py::run()`'s workload at its defaults (six
    variants x three seeds, 18 points, one `simulate_open_batch` call with
    one FaultBatch) and the `fleet` scale point (three seeds, one call).
    Every refresh point's `segment_targets` solves its distinct segments
    in one `solve_targets_grid_torch` grid — one fused GrIn launch — and
    every such grid is held to the single-move local-maximum property and
    to the plain per-step loop. The engine is held to the host fault loop
    (`run_open_faults`, same arrivals and fault realization) at every
    `faults` point and at the fleet's seed-0 point when the host finishes
    within fig["fleet_oracle_s"]; the fleet is also held by conservation
    and Little's law. fig_faults.py's claims are asserted on the seed
    means."""
    import numpy as np
    from repro_torch.kernels import grin_moves as GM
    fig = {**OPEN_FIG, **(fig or {})}
    T, W, seeds = fig["n_arrivals"], fig["warmup"], fig["seeds"]
    fails, rows = [], {}
    segs = {}
    for key, work, qcap in (
            ("faults", faults_workload(T, W, seeds), TRAFFIC_QCAP),
            ("fleet", fleet_workload(T, W, seeds), FLEET_QCAP)):
        with SegmentGrids(dev) as rec:
            full, points, cfgs = open_fault_batch(dev, work, T, W, seeds,
                                                  qcap)
        segs[key] = rec.grids
        if key == "faults":
            jobs = list(zip(cfgs, [p for _, p, _, _ in points]))
            matched = list(range(len(points)))
        else:
            jobs = [(cfgs[0], points[0][1])]
            matched = [0]
        t_sub = time.perf_counter()
        pending = (pool.map_async(host_open, jobs, chunksize=1)
                   if pool is not None else None)
        out, row = run_open_batch(dev, full, key, detail, busy_batch=shorter(
            full, fig["busy_arrivals"]))
        row["storm"] = [(e.time, e.pool, e.scale) for e in work[4]]
        row["segment_grids"] = len(segs[key])
        if key == "fleet":
            row["knee"] = work[7]
        hosts = None
        if pending is None:
            hosts = [host_open(j) for j in jobs]
        else:
            budget = (fig["fleet_oracle_s"] if key == "fleet" else None)
            try:
                left = (None if budget is None else
                        max(1.0, budget - (time.perf_counter() - t_sub)))
                hosts = pending.get(timeout=left)
            except multiprocessing.TimeoutError:
                row["oracle"] = (f"host run not done within "
                                 f"{budget:.0f} s; held by conservation "
                                 f"and Little's law alone")
        recs = []
        if hosts is not None:
            for i, (h, secs) in zip(matched, hosts):
                r = open_record(out, i, h)
                r.update(point=[points[i][0], points[i][3]],
                         cell=[points[i][0]], host_s=secs,
                         host_topology_events=h.topology_events,
                         engine_topology_events=int(
                             out["topology_events"][i]),
                         host_goodput=h.goodput,
                         engine_goodput=float(out["goodput"][i]))
                if h.topology_events != int(out["topology_events"][i]):
                    fails.append(f"{key}: topology events differ at "
                                 f"{r['point']}")
                recs.append(r)
            summary, f = open_gates(recs)
            fails += [f"{key}: {x}" for x in f]
            row.update(gates=summary, records=recs,
                       host_seconds=[r["host_s"] for r in recs])
            print(f"  {key} vs host ({len(recs)} points): {summary}")
        # hedged copies are two residents for one task: the books and
        # Little's law hold for the points without them
        unhedged = [i for i, p in enumerate(points)
                    if not p[2].hedge_classes]
        gaps = conservation_gaps(out, T, W, unhedged)
        lr = little_rel(out, unhedged)
        row.update(conservation_max_gap=int(np.abs(gaps).max()),
                   little_max_rel=float(lr.max()))
        if np.abs(gaps).max() > 0:
            fails.append(f"{key}: conservation off by "
                         f"{int(np.abs(gaps).max())}")
        if lr.max() >= LITTLE_REL:
            fails.append(f"{key}: Little's law off by {lr.max():.3f}")
        per = {}
        for v in dict.fromkeys(p[0] for p in points):
            idx = [i for i, p in enumerate(points) if p[0] == v]
            per[v] = {n: float(np.nanmean(out[n][idx])) for n in (
                "goodput", "wasted_work", "failures", "dropped",
                "topology_events", "reroute_latency", "recovery_time")}
            per[v]["latency_p99"] = float(np.mean(
                out["class_quantiles"][idx][:, 0, 1]))
        row["variants"] = per
        print(f"  {key}: {per}")
        n_crash = len({e.time for e in work[4] if e.scale == 0.0})
        for v, r in per.items():
            if r["topology_events"] != n_crash:
                fails.append(f"{key}: {v} saw {r['topology_events']} "
                             f"topology events")
            if not np.isfinite(r["recovery_time"]):
                fails.append(f"{key}: {v} never recovered")
        if key == "faults":          # fig_faults.py:149-164
            g = {v: r["goodput"] for v, r in per.items()}
            for ref in ("grin-p+refresh", "grin-p+refresh+hedge"):
                for base in ("lb", "jsq"):
                    if not g[ref] > 1.02 * g[base]:
                        fails.append(f"goodput {ref} {g[ref]:.3f} not > "
                                     f"1.02 x {base} {g[base]:.3f}")
            if not (per["grin-p+refresh+ckpt"]["wasted_work"]
                    < per["grin-p+refresh"]["wasted_work"]):
                fails.append("checkpointing did not cut wasted work")
        rows[key] = row
    # every segment grid on the path: one fused launch each on the card
    counted = dict(GM.launches)
    for key in ("faults", "fleet"):
        rows[key]["segment_checks"] = check_segment_grids(dev, segs[key])
    GM.launches.update(counted)
    n_grids = sum(len(v) for v in segs.values())
    print(f"  segment grids: {n_grids} "
          f"({ {k: len(v) for k, v in segs.items()} }); "
          f"{[r for k in rows for r in rows[k]['segment_checks']][:2]}")
    if fails:
        raise AssertionError("; ".join(fails))
    return {"grids": n_grids, **rows}


# ------------------------------------------------- closed-network faults

# the Fig. 9 workload (phase_engine's first 3x3 affinity, N = 30) under a
# two-burst storm (one pool a burst, 6 s down, inside the first ~45 s of
# runs that last 90-135 s), 2% transient failures, refreshed targets, with
# and without checkpoints
CF_POLICIES = (("GrIn", "grin"), ("GrIn-E", "grin-e"), ("LB", "lb"),
               ("JSQ", "jsq"))
CF_STORM = dict(n_bursts=2, group_size=1, window=(15.0, 45.0), downtime=6.0,
                seed=5)
CF_FIG = {"n_completions": 4000, "warmup": 800, "seeds": (0, 1, 2),
          "check_completions": 1000}
CF_PT_TOL, CF_MEAN_TOL = 0.15, 0.05     # the engine's conformance gates


def closed_fault_configs(fig):
    """(label, SimConfig) per (order, checkpoint period) of the workload,
    and the fault-free and never-firing configs of the bit-equality
    check."""
    import numpy as np
    from repro_torch.core import PowerModel, random_affinity_matrix
    from repro_torch.faults import FaultScenario, crash, make_storm
    from repro_torch.sim import SimConfig, make_distribution
    mu = random_affinity_matrix(np.random.default_rng(3), 3, 3)
    storm = make_storm(3, **CF_STORM)

    def cfg(order, faults, n, warm):
        return SimConfig(mu=mu, n_programs_per_type=np.array([10, 10, 10]),
                         distribution=make_distribution("exponential"),
                         order=order, power=PowerModel(alpha=0.5),
                         n_completions=n, warmup_completions=warm, seed=0,
                         faults=faults)
    runs = [((order, ck), cfg(order, FaultScenario(
        events=storm, fail_prob=FAIL_PROB, ckpt_period=ck,
        refresh_targets=True), fig["n_completions"], fig["warmup"]))
        for order in ("PS", "FCFS") for ck in (None, CKPT_PERIOD)]
    n = fig["check_completions"]
    never = FaultScenario(events=crash(1, 1e9, 2e9))
    return runs, cfg("PS", None, n, n // 5), cfg("PS", never, n, n // 5)


def phase_closed_faults(dev, detail, pool=None, fig=None):
    """The closed engine's fault inputs: the Fig. 9 workload under a storm
    with transient failures, refreshed segment targets and, in half the
    calls, checkpoints — one `compare_policies` call (4 policies x 3
    seeds) per (order, checkpoint period). Every run is held to the port's
    host fault loop (`run_closed_faults`, same config and seed, in the
    host pool) at the engine gates, with equal topology events;
    checkpoints cut the wasted work of every (order, policy); a scenario
    that never fires is bit-equal to the fault-free run; every refreshed
    segment grid is one fused launch, held to the plain per-step loop."""
    import numpy as np
    from repro_torch.kernels import grin_moves as GM
    from repro_torch.sim import compare_policies
    fig = {**CF_FIG, **(fig or {})}
    seeds = list(fig["seeds"])
    runs, plain_cfg, never_cfg = closed_fault_configs(fig)
    jobs = [(dataclasses.replace(c, seed=s), key) for _, c in runs
            for _, key in CF_POLICIES for s in seeds]
    pending = (pool.map_async(host_run, jobs, chunksize=1)
               if pool is not None else None)
    sync = torch_sync(dev)
    devs, calls = [], []
    with SegmentGrids(dev) as rec:
        for label, c in runs:
            sync()
            t0 = time.perf_counter()
            rows = compare_policies(c, [k for _, k in CF_POLICIES],
                                    seeds=seeds, device=dev)
            sync()
            calls.append({"order": label[0], "ckpt_period": label[1],
                          "seconds": time.perf_counter() - t0})
            devs += [(label, name, s, m) for name, _ in CF_POLICIES
                     for s, m in zip(seeds, rows[name])]
    t0 = time.perf_counter()
    hosts = (pending.get() if pending is not None
             else [host_run(j) for j in jobs])
    t_host = time.perf_counter() - t0
    fails, recs = [], []
    for (label, name, s, m), h in zip(devs, hosts):
        r = {"order": label[0], "ckpt_period": label[1], "policy": name,
             "seed": s, "x_rel": abs(m.throughput - h.throughput)
             / h.throughput,
             "e_rel": abs(m.mean_energy - h.mean_energy) / h.mean_energy,
             "wasted": m.wasted_work, "wasted_host": h.wasted_work,
             "failures": m.failures, "failures_host": h.failures,
             "topology": m.topology_events,
             "topology_host": h.topology_events, "completed": m.completed}
        recs.append(r)
        if m.topology_events != h.topology_events:
            fails.append(f"topology events differ at {label} {name} {s}")
        if m.completed != fig["n_completions"] - fig["warmup"]:
            fails.append(f"{label} {name} {s}: {m.completed} completions")
    xr = np.array([r["x_rel"] for r in recs])
    er = np.array([r["e_rel"] for r in recs])
    if xr.max() >= CF_PT_TOL or er.max() >= CF_PT_TOL \
            or xr.mean() >= CF_MEAN_TOL or er.mean() >= CF_MEAN_TOL:
        fails.append(f"engine vs host: X rel max {xr.max():.3f} mean "
                     f"{xr.mean():.3f}, E rel max {er.max():.3f} mean "
                     f"{er.mean():.3f}")
    wasted = {}
    for r in recs:
        wasted.setdefault((r["order"], r["policy"], r["ckpt_period"]),
                          []).append(r["wasted"])
    cut = {f"{o} {p}": float(np.mean(wasted[(o, p, CKPT_PERIOD)])
                             / np.mean(wasted[(o, p, None)]))
           for o, p, ck in wasted if ck is None}
    if max(cut.values()) >= 1.0:
        fails.append(f"checkpoints did not cut wasted work: {cut}")
    # the fault stanza with nothing to do: bit for bit the fault-free run
    names = [k for _, k in CF_POLICIES]
    a = compare_policies(plain_cfg, names, seeds=seeds, device=dev)
    b = compare_policies(never_cfg, names, seeds=seeds, device=dev)
    fields = ("throughput", "mean_response_time", "mean_energy", "elapsed",
              "mean_power", "state_occupancy", "class_throughput",
              "completed")
    n_diff = sum(not np.array_equal(np.asarray(getattr(x, f)),
                                    np.asarray(getattr(y, f)))
                 for name in a for x, y in zip(a[name], b[name])
                 for f in fields)
    if n_diff or any(y.failures or y.topology_events
                     for name in b for y in b[name]):
        fails.append(f"the never-firing scenario differs from the "
                     f"fault-free run in {n_diff} fields")
    counted = dict(GM.launches)
    seg = check_segment_grids(dev, rec.grids)
    GM.launches.update(counted)
    res = {"grids": len(rec.grids), "calls": calls, "runs": recs,
           "host_seconds": t_host, "host_runs": len(hosts),
           "x_rel_max": float(xr.max()), "x_rel_mean": float(xr.mean()),
           "e_rel_max": float(er.max()), "e_rel_mean": float(er.mean()),
           "wasted_ratio_ckpt_over_none": cut,
           "never_firing_fields_differing": n_diff, "segment_checks": seg}
    detail["closed_faults"] = res
    print(f"  closed faults: {len(devs)} runs in "
          f"{sum(c['seconds'] for c in calls):.1f} s "
          f"({[round(c['seconds'], 1) for c in calls]}); vs the host fault "
          f"loop ({t_host:.1f} s after): X rel max {xr.max():.3f} mean "
          f"{xr.mean():.3f}, E rel max {er.max():.3f} mean {er.mean():.3f}")
    print(f"  wasted work with / without checkpoints: {cut}; never-firing "
          f"fields differing: {n_diff}; segment grids {len(rec.grids)}: "
          f"{seg[:1]}")
    if fails:
        raise AssertionError("; ".join(fails))
    return res


# ------------------------------------------------------------------ hazard

# benchmarks/fig_hazard.py at its defaults: fig_faults' 2x4 system at
# u = 1.1 with availability drawn from per-pool Weibull up/down processes
HZ_SHAPES = (1.0, 2.2)
HZ_MTBF_FRACS = (0.18, 0.45)
HZ_MTTR_FRAC = 0.04
HZ_HQ, HZ_HMIN = 0.95, 64
HZ_OVERHEAD = 0.005


def hazard_workload(T, seeds):
    """fig_hazard.py's grid and variants: (points as (variant, policy name,
    FaultScenario, seed), arrivals by seed, target mix)."""
    import numpy as np
    from repro_torch.faults import UpDownProcess, make_hazard_scenario
    from repro_torch.traffic import PoissonArrivals, TrafficSpec
    mu = np.asarray(FAULTS_MU)
    l = mu.shape[1]
    xk = knee(mu, OPEN_SHARES)
    spec = TrafficSpec(tuple(PoissonArrivals(FAULTS_U * xk * s)
                             for s in OPEN_SHARES), np.eye(2))
    arr = {s: spec.sample(s, T) for s in seeds}
    t_end = min(float(t[-1]) for t, _ in arr.values())
    grid = [(shape, mf, s) for shape in HZ_SHAPES for mf in HZ_MTBF_FRACS
            for s in seeds]
    procs = {(shape, mf): UpDownProcess(mtbf=mf * t_end,
                                        mttr=HZ_MTTR_FRAC * t_end,
                                        up_shape=shape)
             for shape in HZ_SHAPES for mf in HZ_MTBF_FRACS}
    ref = dict(refresh_targets=True, restart_overhead=HZ_OVERHEAD)
    variants = [
        ("grin-p+refresh", "grin-p", ref),
        ("grin-p+refresh+hedge-always", "grin-p",
         dict(ref, hedge_classes=(0,))),
        ("grin-p+refresh+hedge-q95", "grin-p",
         dict(ref, hedge_quantile=HZ_HQ, hedge_min_obs=HZ_HMIN)),
        ("grin-p+refresh+ckpt", "grin-p", dict(ref, ckpt_period=CKPT_PERIOD)),
        ("grin-p+refresh+ckpt-age", "grin-p",
         dict(ref, ckpt_period=CKPT_PERIOD, ckpt_age=3 * CKPT_PERIOD)),
        ("lb", "lb", {}), ("jsq", "jsq", {})]
    points = [(v, p, make_hazard_scenario(procs[(shape, mf)], l, t_end, s,
                                          fail_prob=FAIL_PROB, **kw), s)
              for v, p, kw in variants for shape, mf, s in grid]
    mix = np.maximum(1, np.round(np.asarray(OPEN_SHARES) * 2 * l)
                     ).astype(np.int64)
    return mu, [0, 1], spec, arr, None, mix, points


def phase_hazard(dev, detail, pool=None, fig=None):
    """`benchmarks/fig_hazard.py::run()`'s workload at its defaults: 2
    shapes x 2 MTBFs x 3 seeds of drawn availability under seven variants
    (84 points) in ONE `simulate_open_batch` call from the captured graph
    (per-point route modes and fault schedules; the reference takes one
    call a variant). Every point is held to the host fault loop
    (`run_open_faults`, same arrivals and realization, in the host pool)
    at `open_gates`, with equal topology events (a p99 cell is a variant
    over the availability grid); the benchmark's claims are asserted on
    its own statistics; every refreshed segment grid is one fused launch,
    and each distinct grid is held to the plain per-step loop."""
    import numpy as np
    from repro_torch.faults import (age_checkpoint_policy,
                                    expected_completion_exp,
                                    expected_completion_weibull)
    from repro_torch.kernels import grin_moves as GM
    fig = {**OPEN_FIG, **(fig or {})}
    T, W, seeds = fig["n_arrivals"], fig["warmup"], fig["seeds"]
    work = hazard_workload(T, seeds)
    n_grid = len(HZ_SHAPES) * len(HZ_MTBF_FRACS) * len(seeds)
    with SegmentGrids(dev) as rec:
        batch, points, cfgs = open_fault_batch(dev, work, T, W, seeds,
                                               TRAFFIC_QCAP)
    jobs = list(zip(cfgs, [p for _, p, _, _ in points]))
    pending = (pool.map_async(host_open, jobs, chunksize=1)
               if pool is not None else None)
    out, row = run_open_batch(dev, batch, "hazard", detail,
                              busy_batch=shorter(batch,
                                                 fig["busy_arrivals"]))
    hosts = (pending.get() if pending is not None
             else [host_open(j) for j in jobs])
    fails, recs = [], []
    for i, (h, secs) in enumerate(hosts):
        r = open_record(out, i, h)
        # a cell: one variant over the availability grid, whose points
        # (shape, MTBF, seed) are each a realization of the outage process
        # (the level fig_hazard.py's claims take their means at)
        r.update(point=[points[i][0], points[i][3]], host_s=secs,
                 cell=[points[i][0]])
        if h.topology_events != int(out["topology_events"][i]):
            fails.append(f"topology events differ at {r['point']}")
        recs.append(r)
    summary, f = open_gates(recs)
    fails += f
    # reported, not gated: the p99 seed means per (variant, shape, MTBF)
    fine = open_gates([dict(r, cell=[points[i][0],
                                     (i % n_grid) // len(seeds)])
                       for i, r in enumerate(recs)])[0]
    per = {}
    for v in dict.fromkeys(p[0] for p in points):
        idx = [i for i, p in enumerate(points) if p[0] == v]
        per[v] = {n: np.asarray(out[n][idx], np.float64) for n in (
            "goodput", "wasted_work", "topology_events")}

    def mean(v, n):
        return float(per[v][n].mean())
    # fig_hazard.py's claims 0-3, on its statistics
    if min(per[v]["topology_events"].min() for v in per) < 1:
        fails.append("a point saw no crash")
    for base in ("lb", "jsq"):
        if not mean("grin-p+refresh", "goodput") > 1.02 * mean(base,
                                                               "goodput"):
            fails.append(f"refresh goodput not > 1.02 x {base}")
    ga, gq = (per[v]["goodput"] for v in ("grin-p+refresh+hedge-always",
                                          "grin-p+refresh+hedge-q95"))
    wa, wq = (per[v]["wasted_work"] for v in ("grin-p+refresh+hedge-always",
                                              "grin-p+refresh+hedge-q95"))
    dom = (wq < wa) & (gq >= ga)
    if not dom.any() or not wq.mean() < wa.mean():
        fails.append("quantile hedging does not dominate always-hedge")
    w_none, w_ckpt, w_age = (mean(v, "wasted_work") for v in (
        "grin-p+refresh", "grin-p+refresh+ckpt", "grin-p+refresh+ckpt-age"))
    if not (w_ckpt < w_none and w_ckpt <= w_age * (1 + 1e-9)
            <= w_none * 1.05):
        fails.append(f"restart economics: wasted {w_ckpt}, {w_age}, "
                     f"{w_none}")
    task_mean = 1.0 / FAIL_PROB
    a_star, tau = age_checkpoint_policy(task_mean, max(HZ_SHAPES),
                                        HZ_OVERHEAD)
    ws, wl = 0.1 * task_mean, 1.6 * task_mean
    e_s = expected_completion_exp(ws, 1.0 / task_mean, HZ_OVERHEAD)
    e_l = expected_completion_exp(wl, 1.0 / task_mean, HZ_OVERHEAD)
    if not (abs(expected_completion_weibull(ws, task_mean, 1.0, HZ_OVERHEAD)
                - e_s) / e_s < 1e-6
            and expected_completion_weibull(ws, task_mean, max(HZ_SHAPES),
                                            HZ_OVERHEAD) < e_s
            and expected_completion_weibull(wl, task_mean, max(HZ_SHAPES),
                                            HZ_OVERHEAD) > e_l):
        fails.append("restart-vs-resume forecasts")
    # the refresh variants of one availability point solve the same grid
    distinct = list({(g["mus"].tobytes(), g["mixes"].tobytes()): g
                     for g in rec.grids}.values())
    counted = dict(GM.launches)
    seg = check_segment_grids(dev, distinct)
    GM.launches.update(counted)
    row.update(gates=summary, records=recs, p99_by_availability=fine,
               host_seconds=[r["host_s"] for r in recs],
               segment_grids=len(rec.grids), segment_checks=seg,
               hedge_dominance_points=int(dom.sum()),
               hedge_waste_ratio=float(wq.mean() / wa.mean()),
               ckpt_wasted_reduction=1.0 - w_ckpt / max(w_none, 1e-12),
               age_policy_a_star=a_star, daly_tau=tau,
               variants={v: {n: float(a.mean()) for n, a in r.items()}
                         for v, r in per.items()})
    print(f"  hazard vs host ({len(recs)} points, host "
          f"{sum(r['host_s'] for r in recs):.0f} s of runs): {summary}; "
          f"class p99 on the (variant, shape, MTBF) seed means (not "
          f"gated): max {fine['max_cell_p99_rel']:.3f}, mean "
          f"{fine['mean_cell_p99_rel']:.3f}")
    print(f"  hazard: {row['variants']}; segment grids {len(rec.grids)}")
    if fails:
        raise AssertionError("; ".join(fails))
    return {"grids": len(rec.grids), **row}


# --------------------------------------------------------------- autoscale

# benchmarks/fig_autoscale.py at its defaults: 3 types x 4 pools, the
# diurnal peak at 70% of the full-fleet f = 1 capacity
AS_MU = ((14.0, 3.0, 3.0, 2.0), (2.0, 11.0, 3.0, 9.0), (4.0, 4.0, 8.0, 4.0))
AS_TYPE_PROBS = (0.4, 0.35, 0.25)
AS_LEVELS = (0.5, 0.75, 1.0, 1.25)
AS_PEAK_UTIL, AS_AMPLITUDE, AS_EPOCH, AS_SLOTS = 0.70, 0.85, 4.0, 400
AS_FIG = {"horizon": 240.0, "seeds": (0, 1, 2)}
AS_X_REL = 5e-3         # guarded X at most this far above the host float64
                        # price (the reference test's tolerance)


def phase_autoscale(dev, detail, fig=None):
    """`benchmarks/fig_autoscale.py::run()`'s workload at its defaults:
    the diurnal, MMPP and flash traces (horizon 240, seeds 0-2) under the
    static, threshold and governor controllers, through `run_autoscaled`.
    Every governor epoch prices its 13 guarded (7, 5) candidates in one
    `price_frequency_grid` call — one fused `grin_block_solve` launch —
    asserted as solve_calls == epochs == launches; the benchmark's
    frontier claims are asserted; every distinct priced grid is held to
    the plain per-step loop and the single-move local-maximum property;
    every priced candidate's guard-corrected X is compared with the host
    float64 price of its live submatrix (`price_config_host`): never above
    it by more than AS_X_REL, the largest gap either way reported."""
    import numpy as np
    from repro_torch.core import (DVFSModel, PROPORTIONAL_POWER,
                                  grin_block_solve)
    from repro_torch.core.grin import (grin_solve_batch_steps_torch,
                                       grin_solve_batch_torch)
    from repro_torch.kernels import grin_moves as GM
    from repro_torch.sched import autoscale as A
    from repro_torch.traffic import make_load_traces
    fig = {**AS_FIG, **(fig or {})}
    h, seeds = fig["horizon"], fig["seeds"]
    mu = np.asarray(AS_MU)
    l = mu.shape[1]
    dvfs = DVFSModel(alpha=3.0, levels=AS_LEVELS)
    P = PROPORTIONAL_POWER.power_matrix(mu)
    x_full = grin_block_solve(
        mu, np.round(np.asarray(AS_TYPE_PROBS) * 40).astype(np.int64)).x_sys
    base = AS_PEAK_UTIL * x_full / (1.0 + AS_AMPLITUDE)
    traces = make_load_traces(AS_TYPE_PROBS, base=base, horizon=h,
                              period=h / 2.0, amplitude=AS_AMPLITUDE)
    n_sample = int(1.6 * base * h) + 64
    sync = torch_sync(dev)
    priced, orig = [], A.price_frequency_grid

    def recorded(nominal_mu, P_nominal, freq_grid, mixes, dvfs_, device=None):
        sync()
        t0 = time.perf_counter()
        res = orig(nominal_mu, P_nominal, freq_grid, mixes, dvfs_,
                   device=device)
        sync()
        priced.append((np.array(freq_grid), np.array(mixes), res["x"],
                       res["conv"], (time.perf_counter() - t0) * 1e3))
        return res
    controllers = {
        "static": lambda: A.StaticScaler(l),
        "naive": lambda: A.UtilizationScaler(l, dvfs),
        "governor": lambda: A.AutoscaleGovernor(
            mu, dvfs=dvfs, config=A.GovernorConfig(epoch=AS_EPOCH,
                                                   headroom=1.15),
            device=dev)}
    rows, epochs, solve_calls = {}, 0, 0
    before = GM.launches["grin_solve"]
    t_all = time.perf_counter()
    A.price_frequency_grid = recorded
    grids = SegmentGrids(dev, A)
    try:
        grids.__enter__()
        for tname, spec in traces.items():
            rows[tname] = {}
            for cname, make in controllers.items():
                acc = {k: [] for k in ("goodput", "x_per_joule", "energy",
                                       "dropped", "mean_backlog")}
                for s in seeds:
                    times, types = spec.sample(s, n_sample)
                    ctrl = make()
                    r = A.run_autoscaled(mu, times, types, ctrl, dvfs=dvfs,
                                         power=PROPORTIONAL_POWER,
                                         epoch=AS_EPOCH,
                                         queue_slots=AS_SLOTS, horizon=h)
                    for key in acc:
                        acc[key].append(float(getattr(r, key)))
                    if cname == "governor":
                        epochs += len(r.times)
                        solve_calls += ctrl.solve_calls
                rows[tname][cname] = {k: float(np.mean(v))
                                      for k, v in acc.items()}
    finally:
        A.price_frequency_grid = orig
        grids.__exit__()
    t_all = time.perf_counter() - t_all
    launched = GM.launches["grin_solve"] - before
    fails = []
    if not solve_calls == epochs == len(priced) == launched > 0:
        fails.append(f"solve calls {solve_calls}, epochs {epochs}, priced "
                     f"grids {len(priced)}, fused launches {launched}")
    wins, frontier = 0, {}
    for tname in traces:
        g, n, st = (rows[tname][c] for c in ("governor", "naive", "static"))
        wins += g["x_per_joule"] > n["x_per_joule"]
        frontier[tname] = {
            "gov_over_naive_xpj": g["x_per_joule"] / n["x_per_joule"],
            "gov_over_static_xpj": g["x_per_joule"] / st["x_per_joule"],
            "gov_goodput_vs_static": g["goodput"] / st["goodput"]}
        if not (frontier[tname]["gov_goodput_vs_static"] > 0.95
                and frontier[tname]["gov_over_static_xpj"] > 1.0):
            fails.append(f"{tname}: {frontier[tname]}")
    if wins < 2:
        fails.append(f"the governor wins goodput per joule on {wins} of 3 "
                     f"traces")
    # the guard-corrected X of every priced candidate vs the host price
    # of its live submatrix: never above it by more than AS_X_REL; below
    # it where the batched block ascent stops in another basin than the
    # host solve (the reference's solve does the same; ROADMAP queue C)
    cache, gaps = {}, []
    for fg, mixes, x, conv, _ in priced:
        for c in range(len(fg)):
            key = (tuple(fg[c]), tuple(mixes[0]))
            if key not in cache:
                cache[key] = A.price_config_host(mu, P, fg[c], mixes[0],
                                                 dvfs)[0]
            gaps.append((x[c, 0] - cache[key]) / cache[key])
    gaps = np.asarray(gaps)
    if not all(p[3].all() for p in priced):
        fails.append("a priced candidate did not converge")
    if gaps.max() > AS_X_REL:
        fails.append(f"guarded X above the host price by {gaps.max():.2e}")
    # every distinct priced grid: exact row sums, a single-move local
    # maximum on its guarded rows, the plain per-step loop's targets
    distinct = list({(g["mus"].tobytes(), g["mixes"].tobytes()): g
                     for g in grids.grids}.values())
    counted = dict(GM.launches)
    checks = check_segment_grids(dev, distinct)
    GM.launches.update(counted)
    res = {"grids": launched, "epochs": epochs, "solve_calls": solve_calls,
           "seconds": t_all, "traces": rows, "frontier": frontier,
           "gov_beats_naive_on": wins, "candidates_priced": int(gaps.size),
           "distinct_configs": len(cache), "distinct_grids": len(distinct),
           "x_gap_max_abs": float(np.abs(gaps).max()),
           "x_gap_max_over": float(gaps.max()),
           "x_gap_mean_abs": float(np.abs(gaps).mean()),
           "x_gaps_under_5e-3": int((gaps < -AS_X_REL).sum()),
           "x_gaps_over_1e-4": int((np.abs(gaps) > 1e-4).sum()),
           "grid_max_rel_single_move_gain": float(max(
               c["max_rel_single_move_gain"] for c in checks)),
           "grid_fused_ms": [c.get("fused_ms") for c in checks[:8]],
           "price_ms_per_epoch": float(np.mean([p[4] for p in priced])),
           "base_rate": base, "x_full": x_full}
    # the distinct grid whose solve takes the most steps: the fused
    # kernel's device ms, its bound over the steps it took, and the plain
    # per-step loop's ms
    counted = dict(GM.launches)
    _, _, _, moves_all = grin_solve_batch_torch(
        np.concatenate([g["mus"] for g in distinct]),
        np.concatenate([np.repeat(g["mixes"], len(g["mus"]), axis=0)
                        for g in distinct]), device=dev)
    sizes = np.cumsum([0] + [len(g["mus"]) for g in distinct])
    mv = moves_all.cpu().numpy()
    hard = distinct[int(np.argmax([mv[a:b].sum() for a, b in
                                   zip(sizes[:-1], sizes[1:])]))]
    g_mus = hard["mus"]
    g_mix = np.repeat(hard["mixes"], len(g_mus), axis=0)
    _, _, _, moves = grin_solve_batch_torch(g_mus, g_mix, device=dev)
    sync()
    t0 = time.perf_counter()
    grin_solve_batch_steps_torch(g_mus, g_mix, device=dev,
                                 scorer=GM.block_move_scores_reference)
    sync()
    res["plain_ms_per_epoch"] = (time.perf_counter() - t0) * 1e3
    GM.launches.update(counted)
    steps = int(moves.sum()) + len(moves)
    res["bound_ms_per_epoch"], res["bound_by"] = solve_bound(
        len(moves), g_mus.shape[1], g_mus.shape[2],
        _ladder_len(int(g_mix.sum(axis=1).max())), 0, steps)[:2]
    res["steps_per_epoch"] = steps
    if dev.type == "cuda":
        res["fused_ms_per_epoch"] = fused_kernel_ms(g_mus, g_mix, dev,
                                                    iters=20)
    detail["autoscale"] = res
    print(f"  autoscale: {epochs} governor epochs, {launched} fused "
          f"launches, {t_all:.1f} s; gov > naive x/J on {wins}/3: "
          f"{ {t: round(f['gov_over_naive_xpj'], 3) for t, f in frontier.items()} }")
    print(f"  priced X vs host float64 over {gaps.size} candidates: "
          f"largest |gap| {res['x_gap_max_abs']:.3e}, above the host at "
          f"most {gaps.max():.2e}, mean |gap| {res['x_gap_mean_abs']:.2e}, "
          f"{res['x_gaps_under_5e-3']} below by more than {AS_X_REL}; "
          f"{len(distinct)} distinct grids held to the plain loop; price "
          f"{res['price_ms_per_epoch']:.2f} ms an epoch, fused "
          f"{res.get('fused_ms_per_epoch')} ms (bound "
          f"{res['bound_ms_per_epoch']:.2e} ms, {res['bound_by']}; "
          f"{steps} steps), plain loop {res['plain_ms_per_epoch']:.1f} ms")
    if fails:
        raise AssertionError("; ".join(fails))
    return res


# ------------------------------------------------------------ model kernels

# bf16 attention, kernel vs plain: |d| <= ATTN_TOL * (rms of the output row
# + |out|). The reference sweep's 2e-2, taken relative to each row's rms:
# at S = 8192 a row averages ~4096 unit-variance values, so |out| ~ 0.03
# and an absolute 2e-2 would pass a kernel that drops a 64-key tile.
ATTN_TOL = 2e-2
ATTN_FAULT_KEYS = 64    # the negative control's fault: one 64-key tile
SSD_Y_TOL = 5e-2        # bf16 SSD y (the reference sweep's)
SSD_STATE_TOL = 1e-4    # float32 SSD final state (the reference's)
# mLSTM's forget gates, log_a = log_sigmoid(randn + bias): at bias 0 (about
# -0.8 a token) a chunk of 256 tokens passes on about e^-200 of the state
# entering it, 0 in float32, so neither y nor the final state sees that
# share of the carry over chunks (the exp(lt) * S_in term); at bias 6
# (about -0.004 a token, forget gates near 1 as trained ones are) it passes
# on about a third, so the check sees it dropped or misplaced. The wide
# kernel is held at both.
SLOW_FORGET_BIAS = 6.0
FORGET_BIASES = (0.0, SLOW_FORGET_BIAS)
# a ragged wide-kernel case, (B, S, H) and the chunk: S a multiple of
# neither the chunk nor the 64-token tiles, 33 chunks of 16 tokens
WIDE_RAGGED, WIDE_RAGGED_CHUNK = (2, 523, 3), 16
# The SSD kernel's previous design (one 256-thread block per (batch, head),
# float32 CUDA-core products) at the serving shape on an NVIDIA H100 80GB
# HBM3 at 700 W: quoted from PERF.md's kernel table, printed beside this
# run's time as such and not a reading of this run.
SSD_PREVIOUS_MS_QUOTED = 6.09
# The flash kernel's earlier design (mma.sync, 64 x 64 tiles, synchronous
# loads) at the four attention cases below, on an NVIDIA H100 80GB HBM3 at
# 700 W: quoted from PERF.md's kernel table, printed beside this run's
# times as such and not a reading of this run.
FLASH_PREVIOUS_MS_QUOTED = (12.28, 3.33, 4.76, 5.07)
# The backward kernel's earlier design (mma.sync, cp.async, one dK / dV
# block per 128-key tile of a kv head) at BWD_SHAPES below, on an NVIDIA
# H100 80GB HBM3 at 700 W: quoted from PERF.md's kernel table, printed
# beside this run's times as such and not a reading of this run.
BWD_PREVIOUS_MS_QUOTED = (3.136, 6.238, 0.885, 0.905)
RMS_TOL = 2e-2          # bf16 RMSNorm (the reference sweep's)
# the scans' backward kernels against their plain versions (float32 math
# on the same bf16 inputs): for each of dq, dk, dv (bf16) and dlog_a, dbeta
# (float32), grad_err <= SSD_BWD_TOL. Both compute in float32 and differ in
# summation order, then round dq, dk, dv to bf16, where two float32 values
# an ulp apart can land one bf16 spacing (2^-8 relative) apart; the plain
# version's own distance to its float64 run (printed as the rounding
# floor) is that size, 2-4e-3, and so are the kernels' readings. The limit
# is four spacings, 2^-6; the kernels with the reverse carry cut between
# chunks read 0.1-10 at slow decay (FORGET_BIASES).
SSD_BWD_TOL = 2.0 ** -6
SSD_BWD_CHUNK = 256     # the models' chunk; the backward walks 64 tokens
SSD_BWD_GRADS = ("dq", "dk", "dv", "dlog_a", "dbeta")
# the kernels of `csrc/ssd_bwd.cuh` (`bwd_<name>`); a call launches those
# `ssd_scan_bwd.kernel_launches` names, and a named launch that matches no
# profiled kernel fails the row
SSD_BWD_LAUNCHES = ("chunk", "carry", "fused", "scores", "grads", "finish",
                    "cast")
# The backward kernels' first design (float32 CUDA-core products,
# the chunk states walked in sequence) at the rows' shapes below, on an
# NVIDIA H100 80GB HBM3 at 700 W: quoted from PERF.md's kernel table,
# printed beside this run's times as such and not a reading of this run.
SSD_BWD_PREVIOUS_MS_QUOTED = {False: 4.691, True: 5.794}
# flash attention's backward kernel against its plain version (float32 on
# the same bf16 inputs): for each of dq, dk and dv, max |d| / (rms of the
# plain tensor + |plain|) <= BWD_TOL. The kernel rounds P and dS to bf16
# as the operands of its products (as FA2 does), and at the first few
# positions, where a query attends a few keys and P is large, that
# rounding leaves entries a few per cent off: on an NVIDIA H100 80GB HBM3
# at 700 W the sound readings at BWD_SHAPES were 0.032-0.080, and the
# plain version with P and dS rounded to bf16 reads the same against the
# float32 one (tools/flash_bwd_rounding.py; PERF.md section 6). The
# planted control (the middle 128-key tile's causal-diagonal block
# dropped from the gradients, as a dK / dV launch that skipped it would
# give) read 0.44-1.72. The limit lies between the two.
BWD_TOL = 0.15
LSE_TOL = 1e-3          # the forward's log-sum-exp against the plain one's
# (B, S, H, KV, dh, window): qwen2.5-3b's training microbatch, zamba2's
# windowed shape, a ragged S = 1500 (musicgen's frames) and GQA with three
# query heads a kv head
BWD_SHAPES = ((1, 4096, 16, 2, 128, 0), (1, 8192, 32, 32, 112, 4096),
              (4, 1500, 24, 24, 64, 0), (2, 2048, 24, 8, 64, 0))
# the train phases (qwen2.5-3b at full width and depth; the hybrid's and
# ssm's below): global batch TRAIN_B x TRAIN_S in TRAIN_MICRO microbatches,
# TRAIN_STEPS steps of AdamW at TRAIN_LR (warmup TRAIN_WARMUP steps, cosine
# decay over the run): 4 since the train-sharded phase was added (6 before;
# step 1 warms up, 2-3 are timed, 4 runs under the profiler)
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_B, TRAIN_S, TRAIN_MICRO, TRAIN_STEPS = 4, 4096, 4, 4
TRAIN_LR, TRAIN_WARMUP = 2e-6, 1
# the first loss's cross-entropy: ln V plus half the variance of the
# initial logits (rms-normed hidden state against N(0, 0.02^2) tied
# embeddings or head: d * 0.02^2), within TRAIN_LOSS0_TOL. The moe family's
# loss also holds the load-balancing loss summed over its blocks (about
# 0.18 a block at initialisation: granite-moe-3b-a800m's first loss is
# 16.82 = 11.08 + 5.74, on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md
# section 6), which this expectation leaves out
TRAIN_LOSS0_TOL = 0.3
# one microbatch's gradients through the kernels against the plain
# attention's, per leaf group (a layer's attention, MLP or norms; the
# embedding; the final norm): ||kernel - plain|| / ||plain|| <= GRAD_REL_TOL;
# the control drops one layer's attention gradient (dq, dk, dv = 0)
GRAD_REL_TOL = 2e-2
# the train-hybrid phase: zamba2-7b at full width, cut to 27 Mamba2 blocks
# (the shared attention block after every 6, 4 times, then the trailing 3,
# as at 81 = 13 x 6 + 3): 2.54 B parameters, whose float32 masters, Adam
# moments and gradients fit on the 80 GB card, where the full 6.75 B (~108
# GB) do not
TRAIN_HYBRID_LAYERS = 27
# the train-ssm phase's learning rate: the reference launcher's default
# (`OptimizerConfig.lr`). At 2e-6 xlstm-1.3b's loss does not move in 6
# steps (11.229 to 11.232, within its step-to-step noise); at 3e-4 it falls
# to 11.123 (tools/train_lr_probe.py --arch xlstm-1.3b)
TRAIN_SSM_LR = 3e-4
# train-ssm's check against the plain scans' autograd runs on the first
# TRAIN_SSM_CUT_GROUPS groups of xlstm-1.3b's blocks (7 mLSTM and 1 sLSTM
# each), with the trained parameters: the plain route's own float32 spread
# (chunk 64 against 256) reads 1.4e-3 on 8 blocks and 0.19 on all 48, on
# an NVIDIA H100 80GB HBM3 at 700 W (tools/train_grad_noise.py; PERF.md
# section 6)
TRAIN_SSM_CUT_GROUPS = 1
# recovery at smoke_config on the card: RECOVERY_STEPS steps of 4 x 256 in
# 2 microbatches, a checkpoint every 3, a failure injected at call 5
RECOVERY_STEPS, RECOVERY_FAIL_AT = 8, 5
SERVE_ARCH = "zamba2-7b"
# the serve phases' greedy decode steps: 32 since the train-sharded phase
# was added (64 before; the decodes are host-bound, ~60-120 ms a step)
SERVE_B, SERVE_S, SERVE_STEPS = 4, 8192, 32
# the serve-traffic phase replays the bundled trace's first 120 of its 240
# requests (cut to make room for the moe, audio and vlm phases within the
# smoke's 1,200 s: its replay took 98-148 s at 240)
SERVE_TRAFFIC_REQUESTS = 120
CHECK_S = 4600          # decode-vs-forward prompt, longer than the 4096 window
# decode-vs-forward: the largest gap between the logits prefill + decode_step
# give for the last token and forward's last position, bf16 through 81
# Mamba2 layers and 13 attention applications (the two paths round
# differently: chunked SSD kernel vs the step recurrence, flash kernel vs the
# plain decode attention over the bf16 ring). On an H100 the sound gaps over
# the 4 prompts were 0.156-0.191 and the gaps against a forward without the
# window 0.328-0.398 (PERF.md); the limit lies between the two.
LOGIT_TOL = 0.25
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_H, XLSTM_D = 4, 512   # its mLSTM heads: 512 x 512 memories
XLSTM_CHECK_S = 2048        # (4, 2048, 50304) float32 logits: 1.6 GB
# xlstm-1.3b's decode-vs-forward gap (the wide SSD kernel against the step
# recurrence in 42 mLSTM blocks, the doubling scan against the step in 6
# sLSTM blocks) is gated on a float32 copy of the same weights. In bf16,
# 48 blocks of random weights amplify rounding until any two summation
# orders differ: on an H100 the bf16 gaps were 0.61-2.67 and a bf16
# forward with the plain SSD version in place of the kernel differed from
# the kernel's by 2.08-3.28 (tools/xlstm_decode_gap.py; PERF.md). The
# float32 readings this limit is set between, from this script's
# serve-xlstm phase on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section
# 6): the sound gaps 0.00037-0.00518 over the 4 prompts, and 5.01-5.94 for
# the negative control, the decode step against a prefill cache whose
# mLSTM memories are zeroed (the carried state dropped). The limit lies
# ten times above the largest sound gap, for summation-order noise, and a
# hundred times below the control; the bf16 gaps are reported.
XLSTM_LOGIT_TOL = 0.05
MOE_ARCH, AUDIO_ARCH, VLM_ARCH = ("granite-moe-3b-a800m", "musicgen-medium",
                                  "phi-3-vision-4.2b")
AUDIO_S = 1500          # 30 s of EnCodec frames at 50 Hz, what musicgen makes
# decode-vs-forward of the moe, audio and vlm phases: 8 requests of 1024
# positions (vlm: after its 256 patches), gated at LOGIT_TOL like zamba2's,
# each against a negative control that must exceed it
FAMILY_CHECK_B, FAMILY_CHECK_S = 8, 1024
# routing faults smaller than top_k - 1, reported beside serve-moe's gate
# (not gated): each token's k-th expert swapped for its (k+1)-th in the
# last n MoE layers (None: every layer)
MOE_SWAP_CONTROLS = (("every layer", None), ("the last 8 layers", 8),
                     ("the last layer", 1))
# granite-moe's decode-vs-forward. Decode (8 rows a GEMM, the plain decode
# attention) and forward (8,192 rows, the flash kernel) round their bf16
# products differently, so at the checked position a token's MoE inputs
# differ by ~0.4-1.0% of their rms, and where its k-th and (k+1)-th router
# scores lie a few bf16 steps apart the router picks another expert. That
# flip moves the layer's output row by 25-52% of its rms and the later
# layers' inputs by 5-8%, so more flips follow. On an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md, section 6): 7 of 8 requests flipped, each
# first at a probability margin of 0-0.0117 (after 0.7-1.0% of input
# drift), 35 flips in all at margins up to 0.10; logit gaps 0.035-0.205
# against 0.340-0.447 for the negative control (a forward with top_k - 1).
# So every request is gated at LOGIT_TOL against that control, and the
# same decode step routed to the forward's own experts in every layer
# (0.031-0.039) is gated at LOGIT_TOL against the same control. The
# router's own rounding is held per layer: each MoE layer applied to the
# forward's own input at the checked position as a decode-sized call must
# choose the forward's experts except at near-ties, where the k-th and
# (k+1)-th router scores lie within MOE_TIE_SPACINGS bf16 spacings (at the
# larger of the two) of each other (each path rounds a score to the
# nearest bf16), and must give the forward's output rows on the other
# tokens (ATTN_TOL of the row's rms).
MOE_TIE_SPACINGS = 2


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


def attention_padded_bound(b, s, h, kv, dh, window, dh_pad):
    """attention_bound with the tensor work the kernel does at its padded
    head dim: Q K^T over dh, P V over dh_pad columns."""
    nbytes = 2 * (2 * b * s * h * dh + 2 * b * s * kv * dh)
    return _bound(nbytes, 2 * (dh + dh_pad) * b * h * attention_pairs(
        s, window), BF16_OPS_PER_S)


def ptxas_kernel_stats(log: str) -> dict:
    """{kernel name: {"registers", "spill_stores", "spill_loads"}} from a
    `-Xptxas=-v` log."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def flash_kernel_stats(dh: int) -> dict:
    """ptxas's registers and spills for the flash kernel instantiated at
    head dim dh (empty when no ptxas report was kept)."""
    from repro_torch.kernels import build
    log = build.build_log.get("flash_attention", {}).get("ptxas", "")
    for name, st in ptxas_kernel_stats(log).items():
        if "flash_fwd" in name and f"ILi{dh}E" in name:
            return st
    return {}


def attention_bwd_bound(b, s, h, kv, dh, window):
    """The backward: 2.5x the forward's operations (five products of its
    size against two) at the bf16 tensor-core rate; bytes q, k, v, o, do
    read and dq, dk, dv written once (bf16), the LSE read (float32)."""
    nbytes = 2 * 4 * b * s * (h + kv) * dh + 4 * b * h * s
    return _bound(nbytes, 2.5 * 4 * dh * b * h * attention_pairs(s, window),
                  BF16_OPS_PER_S)


BWD_LAUNCHES = ("delta", "dkdv", "sum", "dq")   # the backward's kernels


def flash_bwd_kernel_stats(dh: int) -> dict:
    """ptxas's registers and spills for the backward's kernels: dK / dV
    and dQ instantiated at head dim dh, the D and partial-sum launches."""
    from repro_torch.kernels import build
    log = build.build_log.get("flash_attention_bwd", {}).get("ptxas", "")
    return {kind: st for name, st in ptxas_kernel_stats(log).items()
            for kind in BWD_LAUNCHES
            if (f"bwd_{kind}I" in name and f"ILi{dh}E" in name)
            or f"bwd_{kind}E" in name}


def ptxas_serialized(lib: str) -> list[str]:
    """The kernels of a built library whose wgmma ptxas serialized
    ("C7512 ... insufficient register resources"): each warning line's
    function name from what follows the anonymous namespace's
    `_cu_<hash>` on, 40 characters."""
    import re
    from repro_torch.kernels import build
    log = build.build_log.get(lib, {}).get("ptxas", "")
    return [re.sub(r"^.*?_cu_[0-9a-f]{8}\d+", "", m.group(1))[:40]
            for m in re.finditer(r"C7512.*function '([^']+)'", log)]


def grad_err(a, b) -> float:
    """max |a - b| / (rms(b) + |b|) over the entries, in float32."""
    b = b.float()
    return float(((a.float() - b).abs() / (b.square().mean().sqrt()
                                            + b.abs())).max())


def sdpa_bwd_call(q, k, v, do, win):
    """A call that runs SDPA's backward for the backward kernel's inputs:
    `scaled_dot_product_attention` on (B, H, S, dh) views of q, k, v
    (causal, or a boolean band mask for a window; GQA enabled), its
    forward run once here, then `torch.autograd.grad` at do each call."""
    import torch
    import torch.nn.functional as F
    s, h, kv = q.shape[1], q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    mask = None
    if win:
        ones = torch.ones((s, s), dtype=torch.bool, device=q.device)
        mask = torch.tril(ones) & ~torch.tril(ones, diagonal=-win)
        del ones
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=mask is None,
        enable_gqa=h != kv)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def measure_flash_bwd(dev, seed, b, s, h, kv, dh, win):
    """The backward kernel at one shape: the forward with its LSE against
    the serving forward (bit-equal o) and the plain LSE; dq, dk, dv against
    `flash_attention_bwd_plain` (float32, same inputs) and against a
    planted fault (the middle 128-key tile's causal-diagonal block dropped
    from the plain gradients); two runs bit-equal; kernel, per-launch,
    plain and SDPA-backward ms, the bound, ptxas. Returns the row."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _attn_inputs(dev, seed, b, s, h, kv, dh)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn((b, s, h, dh), dtype=torch.bfloat16, device=dev,
                     generator=g)
    o_serve = FA.flash_attention_cuda(q, k, v, window=win)
    o, lse = FA.flash_attention_cuda(q, k, v, window=win, return_lse=True)
    _, lse_plain = FA.flash_attention_plain(q, k, v, window=win,
                                            return_lse=True)
    lse_err = float((lse - lse_plain).abs().max())
    o_equal = bool(torch.equal(o, o_serve))
    del o_serve, lse_plain
    got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, window=win)
    again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, window=win)
    deterministic = all(bool(torch.equal(x, y)) for x, y in zip(got, again))
    del again
    f32 = [t.float() for t in (q, k, v, o)] + [lse, do.float()]
    plain = FA.flash_attention_bwd_plain(*f32, window=win)
    errs = {n: grad_err(x, z) for n, x, z in zip(("dq", "dk", "dv"), got,
                                                 plain)}
    abs_err = max(float((x.float() - z).abs().max())
                  for x, z in zip(got, plain))
    bk = FA.bwd_kernel_tiles()["dkdv_block_k"]
    k0 = (-(-s // bk) // 2) * bk
    sl = slice(k0, min(k0 + bk, s))
    part = FA.flash_attention_bwd_plain(*(t[:, sl] for t in f32[:4]),
                                        lse[..., sl], f32[5][:, sl],
                                        window=win)
    fault = {}
    for n, z, c in zip(("dq", "dk", "dv"), plain, part):
        bad = z.clone()
        bad[:, sl] -= c
        fault[n] = grad_err(bad, z)     # what the check reads for it
        del bad
    del part, f32
    args = (q, k, v, o, lse, do)
    ms = cuda_ms(lambda: FA.flash_attention_bwd_cuda(*args, window=win),
                 iters=10, warmup=2)
    top = device_busy(lambda: FA.flash_attention_bwd_cuda(*args, window=win),
                      cpu=False)["top"]
    launch_ms = {name: sum(t["device_s"] * 1e3 for t in top
                           if f"bwd_{name}" in t["kernel"])
                 for name in BWD_LAUNCHES}
    plan = dict(FA.last_bwd_plan)       # the plan those calls launched
    plain_ms = cuda_ms(lambda: FA.flash_attention_bwd_plain(
        *args, window=win), iters=2, warmup=1)
    fwd_ms = cuda_ms(lambda: FA.flash_attention_cuda(q, k, v, window=win),
                     iters=10, warmup=2)
    fwd_lse_ms = cuda_ms(lambda: FA.flash_attention_cuda(
        q, k, v, window=win, return_lse=True), iters=10, warmup=2)
    lib_ms = cuda_ms(sdpa_bwd_call(q, k, v, do, win), iters=5, warmup=1)
    del got, plain, args
    torch.cuda.empty_cache()
    bound, by, nbytes, ops = attention_bwd_bound(b, s, h, kv, dh, win)
    return {"B": b, "S": s, "H": h, "KV": kv, "dh": dh, "window": win,
            "max_abs_err": abs_err, "errs": errs,
            "fault_errs": fault, "fault_tile": [sl.start, sl.stop],
            "deterministic": deterministic, "o_bit_equal": o_equal,
            "lse_err": lse_err, "ms": ms, "launch_ms": launch_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "fwd_ms": fwd_ms, "fwd_lse_ms": fwd_lse_ms,
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops,
            "tflops": ops / ms / 1e9, "bound_share": bound / ms,
            **{k: plan[k] for k in ("splits", "dkdv_blocks", "dq_blocks",
                                    "scratch_bytes")},
            **{f"ptxas_{k}": st for k, st in
               flash_bwd_kernel_stats(dh).items()}}


def print_flash_bwd(row, previous_ms=None) -> None:
    """One backward row; `previous_ms`, the earlier design's time quoted
    from PERF.md, is printed as such."""
    e, f = row["errs"], row["fault_errs"]
    quoted = (f" (earlier design {previous_ms:.3f}, quoted from PERF.md, "
              f"not measured here)" if previous_ms is not None else "")
    print(f"  flash bwd B={row['B']} S={row['S']} H={row['H']} "
          f"KV={row['KV']} dh={row['dh']} window={row['window']}: err "
          f"(limit {BWD_TOL}) dq {e['dq']:.2e} dk {e['dk']:.2e} dv "
          f"{e['dv']:.2e}; diagonal tile {row['fault_tile']} dropped: dq "
          f"{f['dq']:.2e} dk {f['dk']:.2e} dv {f['dv']:.2e}; two runs "
          f"{'bit-equal' if row['deterministic'] else 'DIFFER'}; forward "
          f"with LSE: o {'bit-equal' if row['o_bit_equal'] else 'CHANGED'},"
          f" lse err {row['lse_err']:.1e}, ms {row['fwd_lse_ms']:.3f} "
          f"(without {row['fwd_ms']:.3f}); bwd ms {row['ms']:.3f}{quoted} "
          f"{ {k: round(v, 3) for k, v in row['launch_ms'].items()} }, "
          f"{row['splits']} split(s), {row['dkdv_blocks']} dK / dV and "
          f"{row['dq_blocks']} dQ blocks, scratch "
          f"{row['scratch_bytes'] / 1e6:.1f} MB; plain "
          f"{row['plain_ms']:.1f} sdpa bwd {row['library_ms']:.3f} bound "
          f"{row['bound_ms']:.3f} ({row['bound_by']}) = "
          f"{row['bound_share']:.2f} of it; ptxas "
          f"{ {k: v for k, v in row.items() if k.startswith('ptxas')} }")


def flash_bwd_faults(row) -> list[str]:
    """What a backward row fails: its errors over BWD_TOL, a control
    within it, run-to-run differences, the forward's o or LSE off."""
    out = [f"{n} off by {e:.3g} > {BWD_TOL}" for n, e in row["errs"].items()
           if not e <= BWD_TOL]
    out += [f"the check passes the planted fault in {n} ({e:.3g})"
            for n, e in row["fault_errs"].items() if e <= BWD_TOL]
    if not row["deterministic"]:
        out.append("two runs differ")
    if not row["o_bit_equal"]:
        out.append("the forward with its LSE changes o")
    if not row["lse_err"] <= LSE_TOL:
        out.append(f"LSE off by {row['lse_err']:.3g} > {LSE_TOL}")
    return out


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


def mlstm_bound(b, s, h, dk, dv, chunk):
    """The pair (`mlstm_scan_cuda`): the memory's `ssd_bound` plus the
    normaliser's own work, which shares the causal scores: per chunk and row
    the row sums of G, q . n and the state update at dv = 1; bytes also nm
    (bf16) written and n (float32)."""
    _, _, nbytes, ops = ssd_bound(b, s, h, dk, dv, chunk, False)
    c = min(chunk, s)
    n = -(-s // c)
    ops += b * h * n * (2 * (c * (c + 1) // 2) + 4 * c * dk)
    nbytes += 2 * b * s * h + 4 * b * h * dk
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


def mlstm_scan_inputs(dev, seed, b, s, h, dk, dv, forget_bias=0.0):
    """SSD inputs as an mLSTM layer forms them, bf16: q scaled by
    1/sqrt(dk), log_a = log_sigmoid(. + forget_bias), beta = sigmoid(.);
    v = ones for the normaliser (dv = 1)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(device=dev, generator=g)
    q = (torch.randn((b, s, h, dk), **kw) / dk ** 0.5).to(torch.bfloat16)
    k = torch.randn((b, s, h, dk), **kw).to(torch.bfloat16)
    v = (torch.ones((b, s, h, 1), dtype=torch.bfloat16, device=dev)
         if dv == 1 else torch.randn((b, s, h, dv), **kw).to(torch.bfloat16))
    return (q, k, v,
            F.logsigmoid(torch.randn((b, s, h), **kw) + forget_bias),
            torch.sigmoid(torch.randn((b, s, h), **kw)))


def scan_cut_carry(q, k, v, log_a, beta, *, chunk):
    """The plain SSD version with the carry between chunks cut to one
    chunk: the state entering chunk c is chunk c - 1's own contribution
    alone, without the decayed share of the chunks before it (S a multiple
    of the chunk). This is what a carry over chunks that drops its
    exp(lt) * S_in term computes: the negative control of the wide
    kernel's check."""
    import torch
    from repro_torch.models.linear_scan import linear_scan_chunked
    b, s, h, _ = q.shape
    n = s // chunk

    def fold(t):
        return t.reshape(b * n, chunk, *t.shape[2:])
    folded = [fold(t) for t in (q, k, v, log_a, beta)]
    _, own = linear_scan_chunked(*folded, chunk=chunk)   # from zero states
    own = own.reshape(b, n, *own.shape[1:])
    s0 = torch.cat([torch.zeros_like(own[:, :1]), own[:, :-1]], 1)
    del own
    y, st = linear_scan_chunked(*folded, s0=s0.flatten(0, 1), chunk=chunk)
    return y.reshape(b, s, h, -1), st.reshape(b, n, *st.shape[1:])[:, -1]


def check_wide_ssd(dev, seed, b, s, h, dk, dv, chunk, scan, pair=False):
    """`scan` (the wide kernel's wrapper, `ssd_scan_wide_cuda`, or with
    `pair` `mlstm_scan_cuda`, which also returns the normaliser's nm and n)
    against the plain version on mLSTM's inputs at each forget bias of
    FORGET_BIASES: y (and nm) within SSD_Y_TOL, the final states within
    SSD_STATE_TOL. Where S is a multiple of the chunk, the plain version
    with its carry cut to one chunk (`scan_cut_carry`) goes through the
    same check of y and the state beside it. Returns {bias: {"y_err",
    "state_err" (the largest over both scans for the pair), "ok", with
    `pair` "nm_err", "n_err", and "cut_carry_y_err", "cut_carry_state_err",
    "cut_carry_ok" where run}}."""
    from repro_torch.kernels.ssd_scan_wide import mlstm_scan_plain
    from repro_torch.models.linear_scan import linear_scan_chunked
    out = {}
    for bias in FORGET_BIASES:
        args = mlstm_scan_inputs(dev, seed, b, s, h, dk, dv, bias)
        got = scan(*args, chunk=chunk)
        ref = (mlstm_scan_plain if pair else linear_scan_chunked)(
            *args, chunk=chunk)
        errs = [_close(x, xp, SSD_STATE_TOL if i % 2 else SSD_Y_TOL)
                for i, (x, xp) in enumerate(zip(got, ref))]
        r = {"y_err": max(e[0] for e in errs[0::2]),
             "state_err": max(e[0] for e in errs[1::2]),
             "ok": all(e[1] for e in errs)}
        if pair:
            r.update(nm_err=errs[2][0], n_err=errs[3][0])
        yp, sp = ref[:2]
        del got, ref
        if s % min(chunk, s) == 0:
            y, st = scan_cut_carry(*args, chunk=min(chunk, s))
            err_y, ok_y = _close(y, yp, SSD_Y_TOL)
            err_s, ok_s = _close(st, sp, SSD_STATE_TOL)
            r.update(cut_carry_y_err=err_y, cut_carry_state_err=err_s,
                     cut_carry_ok=ok_y and ok_s)
            del y, st
        out[bias] = r
        del args, yp, sp
    return out


def wide_ssd_faults(checks) -> list[str]:
    """What `check_wide_ssd`'s results show wrong: the kernel off the
    plain version at any bias, or the slow-decay check passing the plain
    version with its carry cut to one chunk (then it could not see a fault
    in the carry over chunks)."""
    bad = [f"off the plain version at forget bias {bias}: y "
           f"{r['y_err']:.3g}, state {r['state_err']:.3g}"
           for bias, r in checks.items() if not r["ok"]]
    r = checks[SLOW_FORGET_BIAS]
    if r.get("cut_carry_ok"):
        bad.append(f"the slow-decay check passes the plain version with its "
                   f"carry cut to one chunk (y {r['cut_carry_y_err']:.3g}, "
                   f"state {r['cut_carry_state_err']:.3g})")
    return bad


# the bf16 route's launches of the wide kernel, by kernel name
WIDE_PHASES = ("decay", "states", "scores", "outputs")


def measure_wide_ssd(dev, dv, pair=False):
    """The wide kernel at xlstm-1.3b's prefill shape, B = 4, S = 8192, H =
    4, dk = 512, chunk 256, bf16: the scan alone at its memory (dv = 512)
    or its normaliser (v = ones, dv = 1), or with `pair` the memory and the
    normaliser in one call (`mlstm_scan_cuda`, the serving path).
    `check_wide_ssd` at the serving shape and at a ragged one, then the
    kernel's and the plain version's ms, the bound, and each launch's
    device ms (WIDE_PHASES). Returns the kernel table's row;
    `wide_ssd_faults` of its "checks" and "ragged_checks" says whether it
    holds."""
    import torch
    from repro_torch.kernels import ssd_scan_wide as SSDW
    scan = SSDW.mlstm_scan_cuda if pair else SSDW.ssd_scan_wide_cuda
    plain = SSDW.mlstm_scan_plain if pair else SSDW.ssd_scan_plain
    b, s, h, d, chunk = SERVE_B, SERVE_S, XLSTM_H, XLSTM_D, 256
    seed = 210 + dv + 100 * pair
    checks = check_wide_ssd(dev, seed, b, s, h, d, dv, chunk, scan, pair)
    ragged = check_wide_ssd(dev, seed + 10, *WIDE_RAGGED, d, dv,
                            WIDE_RAGGED_CHUNK, scan, pair)
    args = mlstm_scan_inputs(dev, seed, b, s, h, d, dv, SLOW_FORGET_BIAS)
    ms = cuda_ms(lambda: scan(*args, chunk=chunk), iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: plain(*args, chunk=chunk), iters=2, warmup=1)
    bound, by, nbytes, ops = (mlstm_bound(b, s, h, d, dv, chunk) if pair
                              else ssd_bound(b, s, h, d, dv, chunk, False))
    top = device_busy(lambda: scan(*args, chunk=chunk), cpu=False)["top"]
    phases = {name: sum(t["device_s"] * 1e3 for t in top
                        if f"wide_{name}" in t["kernel"])
              for name in WIDE_PHASES}
    del args
    torch.cuda.empty_cache()
    errs = [x for c in (checks, ragged) for r in c.values()
            for x in (r["y_err"], r["state_err"])]
    return {"pair": pair, "B": b, "S": s, "H": h, "dk": d, "dv": dv,
            "chunk": chunk,
            "max_abs_err": max(errs),
            "y_err": max(r["y_err"] for r in checks.values()),
            "state_err": max(r["state_err"] for r in checks.values()),
            "checks": checks,
            "ragged_shape": [*WIDE_RAGGED, d, dv, WIDE_RAGGED_CHUNK],
            "ragged_checks": ragged,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops,
            "bound_share": bound / ms, "phase_ms": phases}


def print_wide_ssd(row) -> None:
    what = "mlstm pair" if row["pair"] else "ssd wide"
    for name, checks in (("", row["checks"]),
                         (" ragged " + str(row["ragged_shape"]),
                          row["ragged_checks"])):
        for bias, r in checks.items():
            ctl = (f"; carry cut to one chunk: y "
                   f"{r['cut_carry_y_err']:.2e} state "
                   f"{r['cut_carry_state_err']:.2e} "
                   f"({'passes' if r['cut_carry_ok'] else 'rejected'})"
                   if "cut_carry_ok" in r else "")
            nm = (f" (nm {r['nm_err']:.2e}, n {r['n_err']:.2e})"
                  if "nm_err" in r else "")
            print(f"  {what} dv={row['dv']}{name} forget bias {bias}: y "
                  f"err {r['y_err']:.2e} state err {r['state_err']:.2e}{nm} "
                  f"({'ok' if r['ok'] else 'OFF'}){ctl}")
    print(f"  {what} B={row['B']} S={row['S']} H={row['H']} "
          f"dk={row['dk']} dv={row['dv']} chunk={row['chunk']}: ms "
          f"{row['ms']:.3f} plain {row['plain_ms']:.1f} bound "
          f"{row['bound_ms']:.3f} ({row['bound_by']}; "
          f"{row['bound_share']:.3f} of the bound); launches (ms) "
          f"{ {k: round(v, 3) for k, v in row['phase_ms'].items()} }")


def measure_fwd_train(dev, pair, heads=None):
    """A forward scan kernel at the shape its training path launches it:
    `ssd_scan_cuda` at one zamba2-7b microbatch (1, TRAIN_S, 112, 64, 64,
    chunk 256, Mamba2's inputs), or the pair `mlstm_scan_cuda` at one
    xlstm-1.3b microbatch (1, TRAIN_S, 4, 512, 512 + the normaliser, slow
    decay), or at `heads` in place of 112 or 4 (a rank's on a mesh): y and
    the state against the plain version (SSD_Y_TOL, SSD_STATE_TOL), the
    kernel's and the plain version's ms, the bound."""
    import torch
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssd_scan_wide as SSDW
    chunk = 256
    if pair:
        b, s, h, dk, dv = 1, TRAIN_S, heads or XLSTM_H, XLSTM_D, XLSTM_D
        args = mlstm_scan_inputs(dev, 230, b, s, h, dk, dv, SLOW_FORGET_BIAS)
        kern, plain = SSDW.mlstm_scan_cuda, SSDW.mlstm_scan_plain
        bound, by, nbytes, ops = mlstm_bound(b, s, h, dk, dv, chunk)
    else:
        b, s, h, dk, dv = 1, TRAIN_S, heads or 112, 64, 64
        args = ssd_inputs(dev, 220, b, s, h, dk)
        kern, plain = SSD.ssd_scan_cuda, SSD.ssd_scan_plain
        bound, by, nbytes, ops = ssd_bound(b, s, h, dk, dv, chunk, True)
    got = kern(*args, chunk=chunk)
    want = plain(*args, chunk=chunk)
    errs = [_close(x, w, SSD_STATE_TOL if i % 2 else SSD_Y_TOL)
            for i, (x, w) in enumerate(zip(got, want))]
    del got, want
    ms = cuda_ms(lambda: kern(*args, chunk=chunk), iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: plain(*args, chunk=chunk), iters=2, warmup=1)
    del args
    torch.cuda.empty_cache()
    return {"B": b, "S": s, "H": h, "dk": dk, "dv": dv, "chunk": chunk,
            "pair": pair, "train_shape": True,
            "y_err": max(e[0] for e in errs[0::2]),
            "state_err": max(e[0] for e in errs[1::2]),
            "max_abs_err": max(e[0] for e in errs),
            "ok": all(e[1] for e in errs), "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "ops": ops, "bound_share": bound / ms}


# ------------------------------------------------- the scans' backward

def ssd_bwd_bound(b, s, h, dk, dv, chunk, shared_qk, normaliser=False):
    """The backward of the chunked form at chunks of c = min(chunk, 64, s)
    tokens (dv + 1 columns with mLSTM's normaliser): per chunk and row the
    causal half of dy v^T, q k~^T, A k~, A^T q and G^T dy (2 x pairs x (3 dk
    + 2 dv) FLOP) and five state products (the forward's chunk states, the
    reverse carry, S_in dy, dS v, dS^T k~: 5 x 2 c dk dv FLOP), at the bf16
    tensor-core rate; bytes q, k (once for all heads when shared), v, dy
    read and dq, dk, dv written (bf16; two tensors of dk columns, three of
    dv), log_a, beta read and dlog_a, dbeta written (float32), dnm read
    with the normaliser."""
    c = min(chunk, 64, s)
    n = -(-s // c)
    dvx = dv + int(normaliser)
    pairs = c * (c + 1) // 2
    ops = b * h * n * (2 * pairs * (3 * dk + 2 * dvx) + 10 * c * dk * dvx)
    qk = 2 * 2 * 2 * b * s * dk * (1 if shared_qk else h)
    nbytes = qk + 2 * 3 * b * s * h * dv + 4 * 4 * b * s * h \
        + 2 * b * s * h * int(normaliser)
    return _bound(nbytes, ops, BF16_OPS_PER_S)


def ssd_bwd_inputs(dev, seed, b, s, h, dk, dv, bias, shared, dtype=None):
    """The backward's inputs, bf16 (or `dtype`): q (scaled by 1/sqrt(dk))
    and k, shared by the heads (expanded views, head stride 0) when
    `shared` as Mamba2 passes its C and B; v; log_a = log_sigmoid(. +
    bias), beta = sigmoid(.) float32; the cotangents dy, dnm (like v) and
    the final states' d_state, dn (float32)."""
    import torch
    import torch.nn.functional as F
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(device=dev, generator=g)
    hq = 1 if shared else h
    q = (torch.randn((b, s, hq, dk), **kw) / dk ** 0.5).to(dtype)
    k = torch.randn((b, s, hq, dk), **kw).to(dtype)
    return {"q": q.expand(b, s, h, dk), "k": k.expand(b, s, h, dk),
            "v": torch.randn((b, s, h, dv), **kw).to(dtype),
            "log_a": F.logsigmoid(torch.randn((b, s, h), **kw) + bias),
            "beta": torch.sigmoid(torch.randn((b, s, h), **kw)),
            "dy": torch.randn((b, s, h, dv), **kw).to(dtype),
            "dnm": torch.randn((b, s, h, 1), **kw).to(dtype),
            "d_state": torch.randn((b, h, dk, dv), **kw),
            "dn": torch.randn((b, h, dk, 1), **kw)}


def ssd_bwd_call(fn, x, pair, final, **kw):
    """fn (a backward wrapper or plain version, `pair` for mLSTM's) on the
    inputs `x`, with the final states' cotangents when `final`."""
    args = [x[n] for n in ("q", "k", "v", "log_a", "beta", "dy")]
    if pair:
        return fn(*args, x["dnm"], x["d_state"] if final else None,
                  x["dn"] if final else None, chunk=SSD_BWD_CHUNK, **kw)
    return fn(*args, x["d_state"] if final else None, chunk=SSD_BWD_CHUNK,
              **kw)


def grad_errs(got, want) -> dict:
    return {n: grad_err(g, w) for n, g, w in zip(SSD_BWD_GRADS, got, want)}


def measure_ssd_bwd(dev, pair, heads=None, biases=FORGET_BIASES):
    """A scan backward kernel at its training path's shape: Mamba2's
    (`ssd_scan_bwd_cuda`, zamba2's (1, 4096, 112, 64, 64) with q and k
    shared by the heads) or mLSTM's pair (`mlstm_scan_bwd_cuda`, xlstm's
    (1, 4096, 4, 512, 512) and the normaliser), at each forget bias of
    FORGET_BIASES, without and with the final states' cotangents: the five
    gradients against the plain version on the same inputs (grad_err, under
    SSD_BWD_TOL), two runs bit-equal, the plain version's own distance to
    its float64 run (the rounding floor); at slow decay the kernel with its
    reverse carry cut between chunks, which must read above the tolerance.
    Then the kernel's, each launch's (`ssd_scan_bwd.kernel_launches`; a
    name no profiled kernel matches is listed as missing) and the plain
    version's ms and the bound. `heads` in place of 112 or 4 (a rank's on
    a mesh), `biases` in place of FORGET_BIASES. Returns the row;
    `ssd_bwd_faults` says whether it holds."""
    import torch
    from repro_torch.kernels import ssd_scan_bwd as SB
    b, s, h, dk, dv = ((1, TRAIN_S, heads or XLSTM_H, XLSTM_D, XLSTM_D)
                       if pair else (1, TRAIN_S, heads or 112, 64, 64))
    kern = SB.mlstm_scan_bwd_cuda if pair else SB.ssd_scan_bwd_cuda
    plain = SB.mlstm_scan_bwd_plain if pair else SB.ssd_scan_bwd_plain
    checks = []
    for bias in biases:
        x = ssd_bwd_inputs(dev, 700 + 10 * pair, b, s, h, dk, dv, bias,
                           not pair)
        for final in (False, True):
            got = ssd_bwd_call(kern, x, pair, final)
            again = ssd_bwd_call(kern, x, pair, final)
            same = all(bool(torch.equal(u, w)) for u, w in zip(got, again))
            del again
            want = ssd_bwd_call(plain, x, pair, final)
            r = {"forget_bias": bias, "final_state": final,
                 "errs": grad_errs(got, want), "bit_equal": same,
                 "max_abs_err": max(float((u.float() - w.float()).abs().max())
                                    for u, w in zip(got, want))}
            del got
            if final:       # the rounding floor: float32 against float64
                x64 = {n: (t[:, :, :1].double().expand(t.shape)
                           if SB.shared_heads(t) else t.double())
                       for n, t in x.items()}
                w64 = ssd_bwd_call(plain, x64, pair, final)
                r["plain_errs_vs_f64"] = grad_errs(want, w64)
                del x64, w64
            if bias == SLOW_FORGET_BIAS:
                cut = ssd_bwd_call(kern, x, pair, final, cut_carry=True)
                r["cut_carry_errs"] = grad_errs(cut, want)
                del cut
            checks.append(r)
            del want
            torch.cuda.empty_cache()
    x = ssd_bwd_inputs(dev, 790 + pair, b, s, h, dk, dv, SLOW_FORGET_BIAS,
                       not pair)
    ms = cuda_ms(lambda: ssd_bwd_call(kern, x, pair, False), iters=10,
                 warmup=2)
    top = device_busy(lambda: ssd_bwd_call(kern, x, pair, False),
                      cpu=False, top=20)["top"]
    hits = {name: [t["device_s"] * 1e3 for t in top
                   if f"ssd_bwd::bwd_{name}" in t["kernel"]]
            for name in SB.kernel_launches(dk, dv, pair)}
    launch_ms = {name: sum(v) for name, v in hits.items() if v}
    missing = [name for name, v in hits.items() if not v]
    plain_ms = cuda_ms(lambda: ssd_bwd_call(plain, x, pair, False), iters=2,
                       warmup=1)
    del x
    torch.cuda.empty_cache()
    bound, by, nbytes, ops = ssd_bwd_bound(b, s, h, dk, dv, SSD_BWD_CHUNK,
                                           not pair, pair)
    return {"pair": pair, "B": b, "S": s, "H": h, "dk": dk, "dv": dv,
            "chunk": SSD_BWD_CHUNK, "shared_qk": not pair, "checks": checks,
            "max_abs_err": max(r["max_abs_err"] for r in checks),
            "max_err": max(max(r["errs"].values()) for r in checks),
            "ms": ms, "launch_ms": launch_ms, "missing_launches": missing,
            "previous_ms_quoted": SSD_BWD_PREVIOUS_MS_QUOTED[pair],
            "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "ops": ops, "bound_share": bound / ms,
            "scratch_bytes": 4 * sum(SB.scratch_numel(
                b, s, h, dk, dv, SSD_BWD_CHUNK, pair).values())}


def print_ssd_bwd(row) -> None:
    what = "mlstm pair bwd" if row["pair"] else "ssd bwd"
    for r in row["checks"]:
        cut = (f"; reverse carry cut: " + " ".join(
            f"{n} {e:.2e}" for n, e in r["cut_carry_errs"].items())
            if "cut_carry_errs" in r else "")
        floor = (f"; plain float32 vs float64: " + " ".join(
            f"{n} {e:.1e}" for n, e in r["plain_errs_vs_f64"].items())
            if "plain_errs_vs_f64" in r else "")
        print(f"  {what} forget bias {r['forget_bias']} final-state "
              f"cotangent {r['final_state']}: err (limit {SSD_BWD_TOL}) "
              + " ".join(f"{n} {e:.2e}" for n, e in r["errs"].items())
              + f"; two runs {'bit-equal' if r['bit_equal'] else 'DIFFER'}"
              f"{floor}{cut}")
    print(f"  {what} B={row['B']} S={row['S']} H={row['H']} dk={row['dk']} "
          f"dv={row['dv']}{' +1 (normaliser)' if row['pair'] else ''} "
          f"chunk {row['chunk']}: ms {row['ms']:.3f} "
          f"{ {k: round(v, 3) for k, v in row['launch_ms'].items()} } "
          f"(first design {row['previous_ms_quoted']} ms, quoted from "
          f"PERF.md, not measured here); "
          f"plain {row['plain_ms']:.1f} bound {row['bound_ms']:.3f} "
          f"({row['bound_by']}; {row['bound_share']:.3f} of the bound); "
          f"scratch {row['scratch_bytes'] / 1e6:.0f} MB")


def ssd_bwd_faults(row) -> list[str]:
    """What a backward row fails: a gradient over SSD_BWD_TOL, two runs
    that differ, a cut reverse carry that the check passes (at slow
    decay, in the gradients the carry reaches: dk, dv, dlog_a, dbeta), or
    a launch the call names that the profile does not show."""
    out = [f"launch bwd_{n} not in the profile" for n in
           row["missing_launches"]]
    for r in row["checks"]:
        tag = f"bias {r['forget_bias']}, final {r['final_state']}"
        out += [f"{n} off by {e:.3g} ({tag})" for n, e in r["errs"].items()
                if not e <= SSD_BWD_TOL]
        if not r["bit_equal"]:
            out.append(f"two runs differ ({tag})")
        if "cut_carry_errs" in r and not all(
                e > SSD_BWD_TOL for n, e in r["cut_carry_errs"].items()
                if n != "dq"):
            out.append(f"the check passes a cut reverse carry ({tag}): "
                       f"{r['cut_carry_errs']}")
    return out


def phase_model_kernels(dev, detail):
    """The flash-attention, SSD-scan (both kernels; the wide one alone and
    as mLSTM's pair) and RMSNorm kernels against their plain versions on
    the card, bf16, at the shapes the serving paths give them (and B = 1
    causal, windowed and GQA cases); kernel, plain and library times and
    bounds. Returns the five summary entries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SSD
    rows = {"flash_attention": [], "flash_attention_bwd": [], "ssd_scan": [],
            "ssd_scan_wide": [], "mlstm_scan": [], "ssd_scan_bwd": [],
            "mlstm_scan_bwd": [], "rmsnorm": []}

    # (B, S, H, KV, dh, window): the zamba2 prefill's call first; the last
    # three are granite-moe-3b's prefill call (GQA 24 / 8, dh 64),
    # phi-3-vision's (256 patches + 8192 tokens, dh 96) and musicgen's
    # (1500 frames, a ragged last tile of 92 rows), causal
    for i, (b, s, h, kv, dh, win) in enumerate([
            (SERVE_B, SERVE_S, 32, 32, 112, 4096), (1, SERVE_S, 32, 32, 112,
                                                    4096),
            (1, SERVE_S, 32, 32, 112, 0), (1, SERVE_S, 32, 4, 128, 0),
            (SERVE_B, SERVE_S, 24, 8, 64, 0),
            (SERVE_B, 256 + SERVE_S, 32, 32, 96, 0),
            (SERVE_B, AUDIO_S, 24, 24, 64, 0)]):
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
        padded, _, _, padded_ops = attention_padded_bound(
            b, s, h, kv, dh, win, FA.padded_head_dim(dh))
        st = flash_kernel_stats(dh)
        tiles = FA.kernel_tiles()       # as the built kernel reports them
        rows["flash_attention"].append({
            "B": b, "S": s, "H": h, "KV": kv, "dh": dh, "window": win,
            "max_abs_err": err, "max_err_over_row_rms": rel,
            "fault_err_over_row_rms": bad_rel, "library_err": lib_err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": by, "bytes": nbytes, "ops": ops,
            "tflops": ops / ms / 1e9, "bound_share": bound / ms,
            "dh_padded": FA.padded_head_dim(dh), "padded_ops": padded_ops,
            "padded_bound_ms": padded, **tiles, **st})
        quoted = (f" (earlier design {FLASH_PREVIOUS_MS_QUOTED[i]} ms, "
                  f"quoted from PERF.md, not measured here)"
                  if i < len(FLASH_PREVIOUS_MS_QUOTED) else "")
        print(f"  flash B={b} S={s} H={h} KV={kv} dh={dh} window={win}: "
              f"err {err:.2e} = {rel:.2e} x row rms (one-tile fault "
              f"{bad_rel:.2e}, rejected) ms {ms:.3f}{quoted} "
              f"plain {plain_ms:.1f} sdpa {lib_ms:.3f} bound "
              f"{bound:.3f} ({by}; {padded:.3f} at dh padded to "
              f"{FA.padded_head_dim(dh)}) {ops / ms / 1e9:.1f} TFLOP/s = "
              f"{bound / ms:.2f} of the bound; tiles {tiles['block_q']} x "
              f"{tiles['block_k']}, {tiles['stages']} stages; ptxas {st}")
        del q, k, v, out, plain, qt, kt, vt
        mask = None

    # the backward kernel at the train phase's shape and three others
    for name in ptxas_serialized("flash_attention_bwd"):
        print(f"  ptxas C7512: the wgmma of {name} serialized "
              f"(insufficient register resources)")
    for i, shape in enumerate(BWD_SHAPES):
        row = measure_flash_bwd(dev, 500 + i, *shape)
        print_flash_bwd(row, BWD_PREVIOUS_MS_QUOTED[i])
        faults = flash_bwd_faults(row)
        if faults:
            raise AssertionError(f"flash backward {shape}: "
                                 + "; ".join(faults))
        rows["flash_attention_bwd"].append(row)

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
                 iters=10, warmup=2)
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
          f"{err_y:.2e} state err {err_s:.2e} ms {ms:.3f} (previous design "
          f"{SSD_PREVIOUS_MS_QUOTED} ms, quoted from PERF.md, not measured "
          f"here) plain {plain_ms:.1f} bound {bound:.3f} ({by})")
    del q, k, v, la, beta, y, st, yp, sp
    torch.cuda.empty_cache()

    # the wide kernel at xlstm-1.3b's prefill shape: the scan alone at its
    # memory (dv = 512) and its normaliser (v = ones, dv = 1), then both in
    # one call, the pair the serving path launches
    for dv, pair in ((XLSTM_D, False), (1, False), (XLSTM_D, True)):
        row = measure_wide_ssd(dev, dv, pair)
        print_wide_ssd(row)
        faults = wide_ssd_faults(row["checks"]) + wide_ssd_faults(
            row["ragged_checks"])
        if faults:
            raise AssertionError(f"wide SSD scan (dv={dv}, pair={pair}): "
                                 + "; ".join(faults))
        rows["mlstm_scan" if pair else "ssd_scan_wide"].append(row)

    # the forward kernels at the training paths' shapes (216 ssd_scan
    # launches a zamba2 train step, 336 of the pair an xlstm one)
    for pair in (False, True):
        row = measure_fwd_train(dev, pair)
        print(f"  {'mlstm pair' if pair else 'ssd'} at its training shape "
              f"B=1 S={row['S']} H={row['H']} dk={row['dk']} "
              f"dv={row['dv']}{' +1' if pair else ''} chunk {row['chunk']}: "
              f"y err {row['y_err']:.2e} state err {row['state_err']:.2e} "
              f"ms {row['ms']:.3f} plain {row['plain_ms']:.1f} bound "
              f"{row['bound_ms']:.3f} ({row['bound_by']}; "
              f"{row['bound_share']:.3f} of the bound)")
        if not row["ok"]:
            raise AssertionError(f"{'pair' if pair else 'ssd'} forward at "
                                 f"the training shape off: y "
                                 f"{row['y_err']:.3g}, state "
                                 f"{row['state_err']:.3g}")
        rows["mlstm_scan" if pair else "ssd_scan"].append(row)

    # the scans' backward kernels at the training paths' shapes
    for pair in (False, True):
        row = measure_ssd_bwd(dev, pair)
        print_ssd_bwd(row)
        faults = ssd_bwd_faults(row)
        if faults:
            raise AssertionError(f"{'mlstm' if pair else 'ssd'} backward: "
                                 + "; ".join(faults))
        rows["mlstm_scan_bwd" if pair else "ssd_scan_bwd"].append(row)

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

    def train_shape(name, shape):
        r = next(x for x in rows[name] if x.get("train_shape"))
        return {"train_shape": shape, "train_ms": r["ms"],
                "train_plain_ms": r["plain_ms"],
                "train_bound_ms": r["bound_ms"],
                "train_bound_by": r["bound_by"]}

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
                x["max_err_over_row_rms"] for x in rows["flash_attention"]),
            causal_shape=f"B=1,S={SERVE_S},H=KV=32,dh=112,causal,bf16",
            causal_ms=rows["flash_attention"][2]["ms"],
            causal_library_ms=rows["flash_attention"][2]["library_ms"],
            **{f"{tag}_{key}": rows["flash_attention"][i][key]
               for i, tag in ((4, "gqa24_8_dh64"), (5, "dh96"),
                              (6, "audio_dh64"))
               for key in ("ms", "bound_ms", "library_ms", "plain_ms")},
            bound_share=rows["flash_attention"][0]["bound_share"]),
        "flash_attention_bwd": dict(entry(
            "flash_attention_bwd", "flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:105",
            "B={},S={},H={},KV={},dh={},causal,bf16 (one microbatch of the "
            "train phase)".format(*BWD_SHAPES[0][:5])),
            replaces_note="the gradient of that kernel; the reference has "
                          "no backward kernel (jax.grad of its jnp route)",
            launch_ms=rows["flash_attention_bwd"][0]["launch_ms"],
            shapes=[{k: r[k] for k in ("B", "S", "H", "KV", "dh", "window",
                                       "errs", "fault_errs", "ms",
                                       "launch_ms", "plain_ms",
                                       "library_ms", "bound_ms", "splits",
                                       "dkdv_blocks", "dq_blocks",
                                       "scratch_bytes")}
                    for r in rows["flash_attention_bwd"]]),
        "ssd_scan": dict(entry(
            "ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:85",
            f"B={SERVE_B},S={SERVE_S},H=112,dk=dv=64,chunk=256,bf16,"
            f"q/k head-broadcast"),
            **train_shape("ssd_scan", f"B=1,S={TRAIN_S},H=112,dk=dv=64,"
                          f"chunk=256,bf16 (one zamba2-7b microbatch)")),
        "ssd_scan_wide": dict(entry(
            "ssd_scan_wide", "ssd_scan_wide.cu",
            "src/repro/kernels/ssd_scan.py:85",
            f"B={SERVE_B},S={SERVE_S},H={XLSTM_H},dk=dv={XLSTM_D},chunk=256,"
            f"bf16 (mLSTM memory)"),
            normaliser_shape=f"B={SERVE_B},S={SERVE_S},H={XLSTM_H},"
                             f"dk={XLSTM_D},dv=1,chunk=256,bf16",
            normaliser_ms=rows["ssd_scan_wide"][1]["ms"],
            normaliser_plain_ms=rows["ssd_scan_wide"][1]["plain_ms"],
            normaliser_bound_ms=rows["ssd_scan_wide"][1]["bound_ms"],
            phase_ms=rows["ssd_scan_wide"][0]["phase_ms"]),
        "mlstm_scan": dict(entry(
            "mlstm_scan", "ssd_scan_wide.cu",
            "src/repro/kernels/ssd_scan.py:85",
            f"B={SERVE_B},S={SERVE_S},H={XLSTM_H},dk=dv={XLSTM_D},chunk=256,"
            f"bf16, memory + normaliser (v = ones) in one call"),
            phase_ms=rows["mlstm_scan"][0]["phase_ms"],
            **train_shape("mlstm_scan", f"B=1,S={TRAIN_S},H={XLSTM_H},"
                          f"dk=dv={XLSTM_D},chunk=256,bf16 (one xlstm-1.3b "
                          f"microbatch)")),
        **{name: dict(entry(
            name, source, "src/repro/kernels/ssd_scan.py:85", shape),
            replaces_note="the gradient of that kernel; the reference has "
                          "no backward kernel (jax.vjp of its jnp route)",
            launch_ms=rows[name][0]["launch_ms"],
            max_grad_err=rows[name][0]["max_err"])
           for name, source, shape in (
               ("ssd_scan_bwd", "ssd_scan_bwd.cu",
                f"B=1,S={TRAIN_S},H=112,dk=dv=64,chunk={SSD_BWD_CHUNK},"
                f"bf16,q/k head-broadcast (one zamba2-7b training "
                f"microbatch)"),
               ("mlstm_scan_bwd", "ssd_scan_wide_bwd.cu",
                f"B=1,S={TRAIN_S},H={XLSTM_H},dk=dv={XLSTM_D},"
                f"chunk={SSD_BWD_CHUNK},bf16, memory + normaliser (one "
                f"xlstm-1.3b training microbatch)"))},
        "rmsnorm": entry(
            "rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:33",
            f"T={SERVE_B * SERVE_S},D=3584,bf16"),
    }


def _kernel_modules():
    from repro_torch.kernels import flash_attention, grin_moves, rmsnorm
    from repro_torch.kernels import ssd_scan, ssd_scan_bwd, ssd_scan_wide
    return (grin_moves, flash_attention, ssd_scan, ssd_scan_wide,
            ssd_scan_bwd, rmsnorm)


def reset_all_launches():
    for mod in _kernel_modules():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in _kernel_modules():
        out.update(mod.launches)
    return out


def serve_engine(dev, cfg, prompt=None):
    """A ServeEngine over `cfg` at full width with random weights from seed
    0 (the bf16 serving copy), its caches `prompt` positions (vlm: plus the
    patches) + SERVE_STEPS + 8 long; returns (engine, record of its
    size)."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    patches = cfg.n_patches if cfg.family == "vlm" else 0
    engine = ServeEngine(model, max_len=patches + (prompt or SERVE_S)
                         + SERVE_STEPS + 8)
    torch.cuda.synchronize()
    return engine, {"arch": cfg.name, "params": n_params, "weight_bytes": sum(
        p.numel() * p.element_size() for p in model.parameters()),
        "init_s": time.perf_counter() - t0}


def serve_batch(dev, cfg, b, s, seed=1):
    """b random prompts of s positions from a seed: (b, s) token ids, audio
    (b, K, s) (one row per codebook), vlm also (b, n_patches, d) bf16
    patch embeddings (put before the tokens)."""
    import torch
    tg = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, cfg.n_codebooks, s) if cfg.family == "audio" else (b, s)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, device=dev,
                                     generator=tg)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (b, cfg.n_patches, cfg.d_model), device=dev, generator=tg).to(
            torch.bfloat16)
    return batch


def head_of(batch, n):
    """The batch with its prompts cut to their first n positions (along
    the last axis of the tokens; patches kept)."""
    return dict(batch, tokens=batch["tokens"][..., :n])


def serve_runs(dev, engine, prompt=None):
    """The runs every serving phase makes: a warm-up at a short prompt (not
    counted), `generate` on SERVE_B random prompts of `prompt` positions
    (`serve_batch`) and SERVE_STEPS greedy steps (the counted path: the
    launch counts and the plain versions' calls set to 0 just before it
    and read just after), then timed prefill and decode runs and their
    device profiles. Returns (batch, record); record["plain_ssd_calls"]
    and record["plain_attention_calls"] must be 0. Tokens per second
    count positions: an audio position is one frame of K codebook tokens,
    and a vlm prefill's positions include its patches."""
    import torch
    cfg = engine.cfg
    prompt = prompt or SERVE_S
    batch = serve_batch(dev, cfg, SERVE_B, prompt)
    n_pre = engine.prompt_len(batch)
    # warm-up at a short prompt: cuBLAS handles, allocator (not counted)
    engine.generate({k: v[:1] for k, v in head_of(batch, 256).items()},
                    steps=2)
    engine.synchronize()

    plain = {"ssd": 0, "attention": 0}
    with counting_plain_routes(plain):
        reset_all_launches()             # the serving path's count starts
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = engine.generate(batch, steps=SERVE_STEPS)
        engine.synchronize()
        t_gen = time.perf_counter() - t0
        launches = all_launches()        # ... and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    audio = cfg.family == "audio"
    want = (SERVE_B, SERVE_STEPS) + ((cfg.n_codebooks,) if audio else ())
    if out.shape != want or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(out.shape)} / ids "
                             f"out of range")

    t0 = time.perf_counter()
    logits, cache = engine.prefill(batch)
    engine.synchronize()
    t_prefill = time.perf_counter() - t0
    want = (SERVE_B, 1) + ((cfg.n_codebooks,) if audio else ()) + (
        cfg.vocab_size,)
    if logits.shape != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits not finite / wrong shape")
    first, feed = engine._greedy_next(logits)
    t0 = time.perf_counter()
    dec, cache = engine.decode_run(feed, cache, n_pre, SERVE_STEPS)
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
    prof_decode = device_busy(lambda: engine.decode_run(feed, cache, n_pre,
                                                        8))
    del cache, lg
    torch.cuda.empty_cache()

    res = {"batch": SERVE_B, "prompt": prompt, "positions": n_pre,
           "steps": SERVE_STEPS, "generate_s": t_gen, "prefill_s": t_prefill,
           "prefill_tok_per_s": SERVE_B * n_pre / t_prefill,
           "decode_s": t_dec,
           "decode_tok_per_s": SERVE_B * SERVE_STEPS / t_dec,
           "decode_ms_per_step": t_dec / SERVE_STEPS * 1e3,
           "peak_bytes": peak, "launches": launches,
           "plain_ssd_calls": plain["ssd"],
           "plain_attention_calls": plain["attention"],
           "generate_equals_prefill_plus_decode": same,
           "profile_prefill": prof_prefill, "profile_decode_8": prof_decode}
    top = [(t["kernel"][:40], round(t["device_s"], 4))
           for t in prof_prefill["top"][:4]]
    print(f"  generate {SERVE_B} x {n_pre} + {SERVE_STEPS} steps: "
          f"{t_gen:.2f} s; launches {launches}; plain SSD calls "
          f"{plain['ssd']}, plain attention calls {plain['attention']}; "
          f"peak {peak / 1e9:.2f} GB")
    print(f"  prefill (time to first token) {t_prefill:.3f} s = "
          f"{res['prefill_tok_per_s']:.0f} tok/s; decode "
          f"{res['decode_tok_per_s']:.1f} tok/s, "
          f"{res['decode_ms_per_step']:.2f} ms/step; generate == prefill + "
          f"decode_run: {same}")
    print(f"  profiled prefill: wall {prof_prefill['wall_s']:.3f} s, device "
          f"{prof_prefill['device_s']} s, busy {prof_prefill['busy_share']}; "
          f"top {top}")
    print(f"  profiled 8 decode steps: wall {prof_decode['wall_s']:.3f} s, "
          f"device {prof_decode['device_s']} s, busy "
          f"{prof_decode['busy_share']}")
    if not same:
        raise AssertionError("generate != prefill + decode_run")
    return batch, res


def phase_serve(dev, state, detail, cfg=None):
    """zamba2-7b at full width and depth in a ServeEngine: 4 requests of
    8192-token prompts and 32 greedy decode steps through `generate` (the
    counted path), then timed prefill and decode runs, profiles, and the
    decode-vs-forward check on 4 requests of 4600 tokens, with a forward
    that leaves the window out as its negative control. `cfg` replaces the
    model (a reduced one for a rehearsal on a CPU)."""
    import torch
    from repro_torch.configs import get_arch
    cfg = cfg or get_arch(SERVE_ARCH)
    engine, size = serve_engine(dev, cfg)
    model = engine.model
    print(f"  {cfg.name}: {size['params'] / 1e9:.3f} B params, "
          f"{len(model.mamba)} Mamba2 blocks + shared attention x "
          f"{cfg.n_layers // cfg.attn_every}, d_model {cfg.d_model}; "
          f"init + bf16 cast {size['init_s']:.1f} s, weights "
          f"{size['weight_bytes'] / 1e9:.2f} GB")
    state["engine"] = engine
    batch, res = serve_runs(dev, engine)
    toks = batch["tokens"]
    launches = res["launches"]

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

    res.update(size)
    res.update({"check_prompt": CHECK_S, "check_requests": len(gaps),
                "decode_vs_forward_gaps": gaps,
                "decode_vs_forward_max_gap": gap,
                "decode_vs_forward_tol": LOGIT_TOL,
                "decode_vs_no_window_forward_gaps": fault_gaps,
                "decode_vs_forward_argmax_equal": argmax_eq,
                "forward_top2_margins": margins})
    detail["serve"] = res
    print(f"  decode vs forward ({len(gaps)} x {CHECK_S}): gaps "
          f"{[round(x, 4) for x in gaps]} (tol {LOGIT_TOL}); against a "
          f"forward without the window {[round(x, 4) for x in fault_gaps]}; "
          f"argmax equal {argmax_eq}, forward top-2 margins "
          f"{[round(x, 4) for x in margins]}")
    # generate runs one prefill; decode never calls the flash kernel
    print(f"  flash-attention launches per prefill: "
          f"{launches['flash_attention']} (shared attention applied "
          f"{cfg.n_layers // max(cfg.attn_every, 1)} times)")
    res["flash_launches_per_prefill"] = launches["flash_attention"]
    if launches["flash_attention"] <= 0 or launches["ssd_scan"] <= 0:
        raise AssertionError(f"serving path launched no model kernel: "
                             f"{launches}")
    # one SSD launch per Mamba2 block, all on the 64 x 64 kernel
    if launches["ssd_scan"] != cfg.n_layers or launches["ssd_scan_wide"] \
            or launches["mlstm_scan"] or res["plain_ssd_calls"] \
            or res["plain_attention_calls"]:
        raise AssertionError(f"expected {cfg.n_layers} ssd_scan launches, "
                             f"no wide ones and no plain SSD or attention "
                             f"call per prefill: {launches}, plain calls "
                             f"{res['plain_ssd_calls']} SSD, "
                             f"{res['plain_attention_calls']} attention")
    if gap > LOGIT_TOL:
        raise AssertionError(f"decode vs forward gap {gap:.4f} > "
                             f"{LOGIT_TOL}")
    if fault_gap <= LOGIT_TOL:
        raise AssertionError(f"decode vs a forward without the window: gap "
                             f"{fault_gap:.4f} <= {LOGIT_TOL}; the check "
                             f"cannot see a window fault")
    return launches


def decode_vs_forward(model, toks):
    """The logits prefill(toks[:, :-1]) + decode_step give for the last
    token against forward's last position, and against the same decode from
    a cache whose mLSTM memories are zeroed (the negative control): the
    largest gap over the vocabulary per request."""
    import torch
    with torch.no_grad():
        full = model.forward({"tokens": toks})[:, -1]
    _, c = model.prefill({"tokens": toks[:, :-1]})
    dropped = {"mlstm": [{"C": torch.zeros_like(m["C"]), "n": m["n"]}
                         for m in c["mlstm"]],
               "slstm": [dict(x) for x in c["slstm"]]}
    pos = toks.shape[1] - 1
    dl = model.decode_step(toks[:, -1:], c, pos)[0][:, -1]
    bad = model.decode_step(toks[:, -1:], dropped, pos)[0][:, -1]
    return {"gaps": [float(x) for x in (dl - full).abs().amax(-1)],
            "dropped_memory_gaps": [float(x) for x in
                                    (bad - full).abs().amax(-1)],
            "argmax_equal": [bool(x) for x in
                             dl.argmax(-1) == full.argmax(-1)]}


@contextlib.contextmanager
def counting_plain_routes(counter: dict):
    """Count calls of the plain SSD version through `ops.ssd_scan` and
    `ops.mlstm_scan` in counter["ssd"], and of the plain attention through
    `ops.flash_attention` in counter["attention"] (the routes a CPU tensor
    takes)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan_wide as SSDW
    real_ssd, real_attn = ops.linear_scan_chunked, ops.chunked_attention

    def counted_ssd(*args, **kw):
        counter["ssd"] += 1
        return real_ssd(*args, **kw)

    def counted_attn(*args, **kw):
        counter["attention"] += 1
        return real_attn(*args, **kw)
    ops.linear_scan_chunked = SSDW.linear_scan_chunked = counted_ssd
    ops.chunked_attention = counted_attn
    try:
        yield
    finally:
        ops.linear_scan_chunked = SSDW.linear_scan_chunked = real_ssd
        ops.chunked_attention = real_attn


def phase_serve_xlstm(dev, detail, cfg=None):
    """xlstm-1.3b at full width and depth (48 blocks: 6 groups of 7 mLSTM
    blocks and one sLSTM block; d_model 2048, 4 heads of 512) in a
    ServeEngine: 4 requests of 8192-token prompts and 32 greedy decode steps
    through `generate` (the counted path: 42 launches of the wide kernel's
    pair per prefill, memory and normaliser in one call per mLSTM block,
    no other SSD launch and no plain SSD call), then timed prefill and
    decode runs, profiles, and decode-vs-forward on 4 x 2048 with the
    carried mLSTM memories dropped as its negative control: gated on a
    float32 copy of the weights, reported for the bf16 serving copy. `cfg`
    replaces the model (a reduced one for a rehearsal on a CPU)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    cfg = cfg or get_arch(XLSTM_ARCH)
    engine, size = serve_engine(dev, cfg)
    model = engine.model
    n_pair = len(model.mlstm)            # memory + normaliser, one call
    print(f"  {cfg.name}: {size['params']:,} params, {len(model.mlstm)} "
          f"mLSTM + {len(model.slstm)} sLSTM blocks, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.resolved_head_dim}; init + bf16 "
          f"cast {size['init_s']:.1f} s, weights "
          f"{size['weight_bytes'] / 1e9:.2f} GB")
    batch, res = serve_runs(dev, engine)
    toks = batch["tokens"]
    launches, plain_calls = res["launches"], res["plain_ssd_calls"]

    ct = toks[:, :XLSTM_CHECK_S]
    state_bytes = sum(m.numel() * 4 for m in model.init_cache(
        SERVE_B, 1)["mlstm"][0].values()) * len(model.mlstm)
    bf16 = decode_vs_forward(model, ct)              # the serving copy
    del engine, model
    torch.cuda.empty_cache()
    model = Model(cfg.with_(dtype="float32"), device=dev).init(
        torch.Generator(device=dev).manual_seed(0))  # the same weights
    f32 = decode_vs_forward(model, ct)
    del model
    torch.cuda.empty_cache()
    gap, fault_gap = max(f32["gaps"]), min(f32["dropped_memory_gaps"])

    res.update(size)
    res.update({"mlstm_state_bytes": state_bytes,
                "check_prompt": XLSTM_CHECK_S,
                "decode_vs_forward_float32": f32,
                "decode_vs_forward_bf16": bf16,
                "decode_vs_forward_max_gap": gap,
                "decode_vs_forward_tol": XLSTM_LOGIT_TOL})
    detail["serve_xlstm"] = res
    print(f"  plain SSD calls {plain_calls}; mLSTM states "
          f"{state_bytes / 1e9:.3f} GB")
    for name, r in (("float32", f32), ("bf16 (reported)", bf16)):
        print(f"  decode vs forward, {name} ({len(r['gaps'])} x "
              f"{XLSTM_CHECK_S}): gaps {[round(x, 5) for x in r['gaps']]}; "
              f"with the mLSTM memories dropped "
              f"{[round(x, 4) for x in r['dropped_memory_gaps']]}; argmax "
              f"equal {r['argmax_equal']}")
    print(f"  float32 gate: max gap {gap:.5f} <= {XLSTM_LOGIT_TOL} < the "
          f"control's least {fault_gap:.4f}")
    if launches["mlstm_scan"] != n_pair or launches["ssd_scan_wide"] != 0 \
            or launches["ssd_scan"] != 0 or launches["flash_attention"] != 0 \
            or plain_calls != 0:
        raise AssertionError(f"the xlstm prefill should launch the wide "
                             f"kernel's pair {n_pair} times and no other SSD "
                             f"kernel: {launches}, plain calls "
                             f"{plain_calls}")
    if gap > XLSTM_LOGIT_TOL:
        raise AssertionError(f"decode vs forward gap {gap:.4f} > "
                             f"{XLSTM_LOGIT_TOL}")
    if fault_gap <= XLSTM_LOGIT_TOL:
        raise AssertionError(f"decode with the mLSTM memories dropped: gap "
                             f"{fault_gap:.4f} <= {XLSTM_LOGIT_TOL}; the "
                             f"check cannot see a lost carried state")
    return launches


def serve_family(dev, cfg, prompt=None):
    """The serving runs of the moe, audio and vlm phases: a full-width
    engine (`serve_engine`) and `serve_runs` on it. Returns (engine,
    batch, record)."""
    engine, size = serve_engine(dev, cfg, prompt)
    blocks = (f"MoE blocks of {cfg.n_experts} experts, top {cfg.top_k}"
              if cfg.family == "moe" else "attention + MLP blocks")
    print(f"  {cfg.name}: {size['params']:,} params, {cfg.n_layers} "
          f"{blocks}, d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}; init + bf16 "
          f"cast {size['init_s']:.1f} s, weights "
          f"{size['weight_bytes'] / 1e9:.2f} GB")
    batch, res = serve_runs(dev, engine, prompt)
    res.update(size)
    return engine, batch, res


def clone_cache(cache):
    """A copy of an attention cache (decode writes into its cache)."""
    return {"attn": [{k: (v.clone() if hasattr(v, "clone") else v)
                      for k, v in c.items()} for c in cache["attn"]]}


def per_request_gap(a, b):
    """The largest |a - b| of each request over its logits."""
    return [float(x) for x in (a - b).abs().reshape(a.shape[0], -1)
            .amax(-1)]


def family_verdict(name, cfg, res, gaps, gated, control_gaps, control):
    """Print and check a family phase: the flash kernel once per attention
    layer in the prefill and no other model kernel or plain route;
    decode-vs-forward gaps of the `gated` requests <= LOGIT_TOL (at least
    one gated); every negative-control gap > LOGIT_TOL. Raises on a
    fault."""
    launches = res["launches"]
    gate = [g for g, ok in zip(gaps, gated) if ok]
    res.update({"check_requests": len(gaps), "check_prompt": FAMILY_CHECK_S,
                "decode_vs_forward_gaps": gaps, "gated": gated,
                "decode_vs_forward_max_gap": max(gate) if gate else None,
                "decode_vs_forward_tol": LOGIT_TOL,
                "negative_control": control,
                "negative_control_gaps": control_gaps,
                "flash_launches_per_prefill": launches["flash_attention"]})
    print(f"  decode vs forward ({len(gaps)} x {FAMILY_CHECK_S}): gaps "
          f"{[round(x, 4) for x in gaps]} (gated {gated}, tol {LOGIT_TOL}); "
          f"{control}: {[round(x, 4) for x in control_gaps]}")
    print(f"  flash-attention launches per prefill: "
          f"{launches['flash_attention']} ({cfg.n_layers} attention layers)")
    fails = []
    if launches["flash_attention"] != cfg.n_layers or any(
            launches[k] for k in ("ssd_scan", "ssd_scan_wide", "mlstm_scan",
                                  "grin_solve", "block_move_gains")) \
            or res["plain_ssd_calls"] or res["plain_attention_calls"]:
        fails.append(f"expected {cfg.n_layers} flash launches per prefill "
                     f"and no other kernel or plain route: {launches}, "
                     f"plain calls {res['plain_ssd_calls']} SSD, "
                     f"{res['plain_attention_calls']} attention")
    if not gate:
        fails.append("no request is gated")
    elif max(gate) > LOGIT_TOL:
        fails.append(f"decode vs forward gap {max(gate):.4f} > {LOGIT_TOL}")
    if min(control_gaps) <= LOGIT_TOL:
        fails.append(f"{control}: gap {min(control_gaps):.4f} <= "
                     f"{LOGIT_TOL}; the check cannot see that fault")
    if fails:
        raise AssertionError(f"{name}: " + "; ".join(fails))
    return launches


@contextlib.contextmanager
def recording_moe_routes(routes: list):
    """Record every `apply_moe` call (in layer order) in `routes`: its
    route (the call runs `moe_route` once and hands it to `moe_experts`,
    as `apply_moe` does), and its input and output rows at the last
    position ("x_last", "y_last")."""
    from repro_torch.models import layers as L
    real = L.apply_moe

    def recorded(p, x, cfg):
        route = L.moe_route(p, x, cfg)
        y = L.moe_experts(p, x, cfg, route)
        routes.append(dict(route, x_last=x[:, -1].clone(),
                           y_last=y[:, -1].clone()))
        return y, route["aux"]
    L.apply_moe = recorded
    try:
        yield
    finally:
        L.apply_moe = real


@contextlib.contextmanager
def choosing_experts(cfg, choose):
    """The MoE router's choice of experts overridden: in the i-th MoE call
    (layer order), `choose(i, probs)` gives each token's k experts (T, k),
    or None to keep the router's; the gates are the token's own
    probabilities there, renormalised as before."""
    from repro_torch.models import layers as L
    real, calls = L.top_k, [0]

    def chosen(x, k):
        if k != cfg.top_k or x.shape[-1] != cfg.n_experts:
            return real(x, k)          # not the router's choice of experts
        idx = choose(calls[0], x)
        calls[0] += 1
        return real(x, k) if idx is None else (x.gather(-1, idx), idx)
    L.top_k = chosen
    try:
        yield
    finally:
        L.top_k = real


def kth_expert_swapped(cfg, last=None):
    """A routing fault for a negative control (a `choose` for
    `choosing_experts`): in the `last` MoE layers (None: every layer), each
    token's k-th expert replaced by its (k+1)-th. It is the change one
    routing flip makes, at every token of those layers."""
    from repro_torch.models.layers import top_k
    k = cfg.top_k
    pick = [*range(k - 1), k]

    def choose(i, probs):
        if last is not None and i < cfg.n_layers - last:
            return None
        return top_k(probs, k + 1)[1][..., pick]
    return choose


@contextlib.contextmanager
def plain_attention():
    """`ops.flash_attention` replaced by its plain version (the route a CPU
    tensor takes), for a diagnostic forward on the card."""
    from repro_torch.kernels import ops
    real = ops.flash_attention

    def plain(q, k, v, *, causal=True, window=0, block_q=128, block_k=128):
        return ops.chunked_attention(q, k, v, causal=causal, window=window,
                                     chunk_q=block_q, chunk_k=block_k)
    ops.flash_attention = plain
    try:
        yield
    finally:
        ops.flash_attention = real


def rel_drift(a, b):
    """Per row of (B, d): rms(b - a) / rms(a), in float32."""
    a, b = a.float(), b.float()
    return [float(x) for x in (b - a).pow(2).mean(-1).sqrt()
            / a.pow(2).mean(-1).sqrt()]


def bf16_spacing(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


def moe_layer_checks(model, fw, cfg, s):
    """Each MoE layer applied to the forward's own input rows at the
    checked position as a decode-sized call (one row per request) against
    the forward's route and output there (`fw`, recorded at dropless
    capacity). Per layer: the tokens whose experts differ, whether each is
    a near-tie (k-th and (k+1)-th router scores within MOE_TIE_SPACINGS
    bf16 spacings), and the output rows' largest error over their rms on
    the other tokens."""
    import torch
    from repro_torch.models import layers as L
    k, out = cfg.top_k, []
    for blk, rf in zip(model.layers, fw):
        h = rf["x_last"]                                   # (B, d)
        r1 = L.moe_route(blk.moe, h[:, None], cfg)
        y1 = L.moe_experts(blk.moe, h[:, None], cfg, r1)[:, 0]
        gf = rf["gate_idx"].reshape(h.shape[0], s, k)[:, -1]
        flip = (gf.sort(-1).values != r1["gate_idx"].sort(-1).values).any(-1)
        sc = (h @ blk.moe.router.to(h.dtype)).float().sort(
            -1, descending=True).values
        tie = (sc[:, k - 1] - sc[:, k]) <= MOE_TIE_SPACINGS * bf16_spacing(
            torch.maximum(sc[:, k - 1].abs(), sc[:, k].abs()))
        keep = ~flip
        _, rel, ok = (_close_rows(y1[keep], rf["y_last"][keep], ATTN_TOL)
                      if bool(keep.any()) else (0.0, 0.0, True))
        out.append({"flips": int(flip.sum()),
                    "flips_not_near_ties": int((flip & ~tie).sum()),
                    "y_err_over_row_rms": rel, "y_ok": ok})
    return out


def phase_serve_moe(dev, detail, cfg=None):
    """granite-moe-3b-a800m at full width and depth (32 blocks of GQA
    attention (24 / 8 heads of 64) and 40 experts, top 8; d_model 1536) in
    a ServeEngine: 4 requests of 8192 tokens and 32 greedy steps through
    `generate` (the counted path: 32 flash launches per prefill, no other
    model kernel), timed prefill and decode runs and profiles, the tokens
    the prefill's capacity drops in each layer, then decode-vs-forward on
    8 x 1024 at dropless capacity (the reference's test's setting) against
    a forward with top_k - 1 as its negative control, natural and routed
    to the forward's experts; the routing flips at the checked position
    per layer and each request's first, the MoE inputs' and outputs' drift
    per layer, smaller routing faults and a forward on plain attention
    reported; and each layer's router and experts held on the forward's
    own inputs there (`moe_layer_checks`).
    `cfg` replaces the model (a reduced one for a rehearsal on a CPU)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import moe_capacity
    cfg = cfg or get_arch(MOE_ARCH)
    engine, batch, res = serve_family(dev, cfg)
    model = engine.model
    routes = []
    with recording_moe_routes(routes), torch.no_grad():
        engine.prefill(batch)
    dropped = [int(r["dropped"]) for r in routes]
    choices = batch["tokens"].numel() * cfg.top_k
    cap = moe_capacity(cfg, batch["tokens"].numel(), batch["tokens"].shape[-1])
    del routes
    print(f"  prefill capacity {cap} tokens an expert: "
          f"dropped choices per layer {dropped} of {choices} "
          f"({sum(dropped) / (choices * cfg.n_layers):.4f} overall)")

    chk = serve_batch(dev, cfg, FAMILY_CHECK_B, FAMILY_CHECK_S, seed=3)
    s, k = FAMILY_CHECK_S, cfg.top_k
    dropless = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
    fw, dc = [], []
    try:
        with torch.no_grad():
            model.cfg = dropless
            with recording_moe_routes(fw):
                full = model.forward(chk)[:, -1]
            model.cfg = dropless.with_(top_k=k - 1)
            fewer = model.forward(chk)[:, -1]
            model.cfg = dropless
            swapped = {}
            for tag, which in MOE_SWAP_CONTROLS:
                with choosing_experts(dropless,
                                      kth_expert_swapped(dropless, which)):
                    swapped[tag] = model.forward(chk)[:, -1]
            fp = []             # diagnostic: the forward on plain attention
            with recording_moe_routes(fp), plain_attention():
                plain_fw = model.forward(chk)[:, -1]
            _, c = engine.prefill(head_of(chk, s - 1))
            # the decode step again, routed to the forward's experts at the
            # checked position: the gap without routing flips
            forward_choice = [r["gate_idx"].reshape(FAMILY_CHECK_B, s, k)[:, -1]
                              for r in fw]
            with choosing_experts(dropless,
                                  lambda i, _: forward_choice[i]):
                forced = model.decode_step(chk["tokens"][..., -1:],
                                           clone_cache(c), s - 1)[0][:, -1]
            with recording_moe_routes(dc):
                dl = model.decode_step(chk["tokens"][..., -1:], c,
                                       s - 1)[0][:, -1]
            layers = moe_layer_checks(model, fw, dropless, s)
    finally:
        model.cfg = cfg
    del c, forward_choice
    flips, margins, x_drift, y_drift, xp_drift = [], [], [], [], []
    for rf, rd, rp in zip(fw, dc, fp):   # the checked position, per layer
        x_drift.append(rel_drift(rf["x_last"], rd["x_last"]))
        y_drift.append(rel_drift(rf["y_last"], rd["y_last"]))
        xp_drift.append(rel_drift(rp["x_last"], rd["x_last"]))
        gi = rf["gate_idx"].reshape(FAMILY_CHECK_B, s, k)[:, -1]
        flips.append([bool(x) for x in (gi.sort(-1).values
                                        != rd["gate_idx"].sort(-1).values)
                      .any(-1)])
        p = rf["probs"].reshape(FAMILY_CHECK_B, s, -1)[:, -1].sort(
            -1, descending=True).values
        margins.append([float(x) for x in (p[:, k - 1] - p[:, k])
                        / p[:, k - 1]])
    del fw, dc, fp
    flipped = [any(f[b] for f in flips) for b in range(FAMILY_CHECK_B)]
    # per request: the layer of its first flip, that flip's margin, and its
    # MoE inputs' largest drift up to that layer (all layers if none)
    first_flips = []
    for b in range(FAMILY_CHECK_B):
        at = next((i for i, f in enumerate(flips) if f[b]), None)
        upto = len(flips) if at is None else at + 1
        first_flips.append({
            "layer": at, "margin": None if at is None else margins[at][b],
            "input_drift_up_to_it": max(x[b] for x in x_drift[:upto])})
    flip_margins = [m[b] for f, m in zip(flips, margins)
                    for b in range(FAMILY_CHECK_B) if f[b]]
    gaps = per_request_gap(dl, full)
    control = per_request_gap(dl, fewer)
    swap_gaps = {tag: per_request_gap(dl, v) for tag, v in swapped.items()}
    plain_gaps = per_request_gap(dl, plain_fw)
    forced_gaps = per_request_gap(forced, full)
    forced_control = per_request_gap(forced, fewer)
    del full, fewer, dl, swapped, plain_fw, forced
    torch.cuda.empty_cache()
    res.update({"prefill_capacity": cap,
                "prefill_dropped_per_layer": dropped,
                "prefill_choices_per_layer": choices,
                "flips_per_layer": [sum(f) for f in flips],
                "flipped_requests": flipped, "flip_margins": flip_margins,
                "first_flip_per_request": first_flips,
                "forward_routed_decode_gaps": forced_gaps,
                "forward_routed_decode_control_gaps": forced_control,
                "moe_input_drift_per_layer": x_drift,
                "moe_output_drift_per_layer": y_drift,
                "plain_attention_forward": {
                    "moe_input_drift_per_layer": xp_drift,
                    "decode_vs_forward_gaps": plain_gaps},
                "kth_expert_swapped_gaps": swap_gaps,
                "layer_checks": layers,
                "near_tie_spacings": MOE_TIE_SPACINGS})
    detail["serve_moe"] = res
    print(f"  routing flips at the checked position (decode vs forward): "
          f"per layer {[sum(f) for f in flips]}, requests {flipped}; their "
          f"probability margins {[round(x, 5) for x in flip_margins]}")
    print(f"  decode vs forward at the checked position, rms(diff) / rms "
          f"per layer, largest over the requests: MoE inputs "
          f"{[round(max(x), 5) for x in x_drift]}; MoE outputs "
          f"{[round(max(x), 5) for x in y_drift]}")
    firsts = [(x["layer"], x["margin"] and round(x["margin"], 5),
               round(x["input_drift_up_to_it"], 5)) for x in first_flips]
    print(f"  per request, its first flip (layer, probability margin, "
          f"largest MoE-input drift up to it): {firsts}")
    print(f"  decode routed to the forward's experts, against the forward: "
          f"gaps {[round(x, 4) for x in forced_gaps]} (tol {LOGIT_TOL}); "
          f"against the forward with top_k - 1: "
          f"{[round(x, 4) for x in forced_control]}")
    print(f"  diagnostic, a forward on plain attention instead of the flash "
          f"kernel: MoE inputs {[round(max(x), 5) for x in xp_drift]} off "
          f"the decode's; logit gaps {[round(x, 4) for x in plain_gaps]}")
    for tag, g in swap_gaps.items():
        print(f"  reported control, forward with each token's k-th expert "
              f"swapped for its (k+1)-th in {tag}: "
              f"{[round(x, 4) for x in g]} "
              f"({sum(x > LOGIT_TOL for x in g)} of {len(g)} over "
              f"{LOGIT_TOL})")
    print(f"  each layer on the forward's own inputs, decode-sized: flips "
          f"{[x['flips'] for x in layers]}, not near-ties "
          f"{sum(x['flips_not_near_ties'] for x in layers)}; output rows "
          f"off by at most "
          f"{max(x['y_err_over_row_rms'] for x in layers):.3g} of their "
          f"rms (tol {ATTN_TOL})")
    launches = family_verdict("serve-moe", cfg, res, gaps,
                              [True] * len(gaps), control,
                              "forward with top_k - 1")
    bad = [i for i, x in enumerate(layers)
           if x["flips_not_near_ties"] or not x["y_ok"]]
    if bad:
        raise AssertionError(f"serve-moe: layers {bad} on the forward's own "
                             f"inputs: {[layers[i] for i in bad]}")
    if max(forced_gaps) > LOGIT_TOL or min(forced_control) <= LOGIT_TOL:
        raise AssertionError(f"serve-moe: the decode routed to the "
                             f"forward's experts is off by "
                             f"{max(forced_gaps):.4f} (tol {LOGIT_TOL}), and "
                             f"by {min(forced_control):.4f} from the forward "
                             f"with top_k - 1 (must exceed the tol)")
    return launches


def phase_serve_audio(dev, detail, cfg=None):
    """musicgen-medium at full width and depth (48 blocks, 24 heads of 64,
    d_model 1536, 4 codebooks) in a ServeEngine: 4 prompts of 1500 frames x
    4 codebooks (30 s of EnCodec at 50 Hz) and 32 greedy steps of one token
    per codebook through `generate` (48 flash launches per prefill), timed
    runs and profiles, then decode-vs-forward on 8 x 1024 frames against a
    decode whose codebooks are shifted by one (the negative control).
    `cfg` replaces the model (a reduced one for a rehearsal on a CPU)."""
    import torch
    from repro_torch.configs import get_arch
    cfg = cfg or get_arch(AUDIO_ARCH)
    engine, batch, res = serve_family(dev, cfg, AUDIO_S)
    model = engine.model
    chk = serve_batch(dev, cfg, FAMILY_CHECK_B, FAMILY_CHECK_S, seed=3)
    s = FAMILY_CHECK_S
    last = chk["tokens"][..., -1:]                    # (B, K, 1)
    with torch.no_grad():
        full = model.forward(chk)[:, -1]              # (B, K, V)
    _, c = engine.prefill(head_of(chk, s - 1))
    shifted = model.decode_step(torch.roll(last, 1, dims=1),
                                clone_cache(c), s - 1)[0][:, -1]
    dl = model.decode_step(last, c, s - 1)[0][:, -1]
    gaps, control = per_request_gap(dl, full), per_request_gap(shifted, full)
    del c, full, shifted, dl
    torch.cuda.empty_cache()
    detail["serve_audio"] = res
    return family_verdict("serve-audio", cfg, res, gaps, [True] * len(gaps),
                          control, "decode with codebooks shifted by one")


def phase_serve_vlm(dev, detail, cfg=None):
    """phi-3-vision-4.2b at full width and depth (32 blocks, 32 heads of
    96, d_model 3072) in a ServeEngine: 4 requests of 256 image patches
    (random embeddings through `patch_proj`) + 8192 tokens and 32 greedy
    steps through `generate` (32 flash launches per prefill, 8448
    positions each), timed runs and profiles, then decode-vs-forward on 8
    x (256 + 1024) against a forward without the patches (the negative
    control). `cfg` replaces the model (a reduced one for a rehearsal on a
    CPU)."""
    import torch
    from repro_torch.configs import get_arch
    cfg = cfg or get_arch(VLM_ARCH)
    engine, batch, res = serve_family(dev, cfg)
    model = engine.model
    chk = serve_batch(dev, cfg, FAMILY_CHECK_B, FAMILY_CHECK_S, seed=3)
    n = engine.prompt_len(chk)
    with torch.no_grad():
        full = model.forward(chk)[:, -1]
        no_patches = model.forward({"tokens": chk["tokens"]})[:, -1]
    _, c = engine.prefill(head_of(chk, FAMILY_CHECK_S - 1))
    dl = model.decode_step(chk["tokens"][:, -1:], c, n - 1)[0][:, -1]
    gaps = per_request_gap(dl, full)
    control = per_request_gap(dl, no_patches)
    del c, full, no_patches, dl
    torch.cuda.empty_cache()
    detail["serve_vlm"] = res
    return family_verdict("serve-vlm", cfg, res, gaps, [True] * len(gaps),
                          control, "forward without the patches")


# the serve-sched phase's completions a policy after its warmup: 15 after
# 5 since the train-sharded phase took all six families (30 after 5 since
# it was added, 37.4 s of phase; 60 after 10 before: 83-94 s on a slow
# host; its X is reported, not gated)
SERVE_SCHED_COMPLETIONS, SERVE_SCHED_WARMUP = 15, 5


def phase_serve_sched(dev, state, detail):
    """CAB against LB over two pools of the full-width engine in virtual
    time (the reference launcher's --heterogeneous experiment): 1 x 1024
    prompts, measured 2 x 2 rates, SERVE_SCHED_COMPLETIONS completions
    after SERVE_SCHED_WARMUP warmup."""
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
        m = VirtualTimeCluster(fns).run_closed(
            sched, types, n_completions=SERVE_SCHED_COMPLETIONS,
            warmup=SERVE_SCHED_WARMUP)
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


def phase_serve_traffic(dev, state, detail):
    """`serve --traffic` on the full-width engine (the reference launcher's
    open-trace replay): the 2 x 2 mu of 1 x 1024 prefill / decode requests
    measured in virtual time, the bundled trace's first
    SERVE_TRAFFIC_REQUESTS requests scaled to 1.2 x the knee and replayed
    through GrIn-P with SLO admission, per-class goodput,
    shed and p99; the decisions recorded to a Chrome trace (more than 0
    events), and the run under the profiler, with a 64 x 64 grid solve
    whose spans must cover its fused kernel's device time (`span.ready`
    waits on the card)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch.serve import serve_traffic
    from repro_torch.obs import get_profiler, profile_block
    from repro_torch.sched.api import solve_targets_grid_torch
    engine = state["engine"]
    tg = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, engine.cfg.vocab_size, (1, 1024), device=dev,
                         generator=tg)
    mus, mixes = skewed_grid(0, 64, 64, K, L, N_TASKS)
    before = all_launches()
    get_profiler().clear()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td, \
            profile_block("serve-traffic") as prof:
        path = os.path.join(td, "decisions.json")
        trace = os.path.join(td, "trace.json")
        with open(ROOT / "examples" / "data" / "serve_trace.json") as f:
            bundled = json.load(f)
        with open(trace, "w") as f:
            json.dump({k: v[:SERVE_TRAFFIC_REQUESTS]
                       for k, v in bundled.items()}, f)
        m, mu, n_events = serve_traffic(engine, {"tokens": toks}, toks,
                                        trace=trace, trace_out=path,
                                        device=dev)
        t_replay = time.perf_counter() - t0
        solve_targets_grid_torch(mus, mixes, device=dev)
        with open(path) as f:
            doc = json.load(f)
    after = all_launches()
    spans = prof.summary()
    fused = (fused_kernel_ms(np.repeat(mus, len(mixes), axis=0),
                             np.tile(mixes, (len(mus), 1)), dev, iters=3)
             if dev.type == "cuda" else 0.0)
    cats = sorted({e["cat"] for e in doc["traceEvents"]})
    res = {"mu": mu.tolist(), "requests": SERVE_TRAFFIC_REQUESTS,
           "replay_s": t_replay,
           "goodput": m.throughput, "trace_events": n_events,
           "categories": cats,
           "classes": {name: {"done": int(m.class_completed[c]),
                              "shed": int(m.class_shed[c]),
                              "deferred": int(m.class_deferred[c]),
                              "p50_s": float(m.class_p50[c]),
                              "p99_s": float(m.class_p99[c]),
                              "slo_met": float(m.class_deadline_met[c])}
                       for c, name in enumerate(("prefill", "decode"))},
           "spans": spans, "fused_ms": fused,
           "launches": {k: after[k] - before[k] for k in after}}
    detail["serve_traffic"] = res
    print(f"  replay {t_replay:.1f} s; {n_events} trace events {cats}; "
          f"spans { {k: (v['count'], round(v['total_s'] * 1e3, 2)) for k, v in spans.items()} }; "
          f"64 x 64 fused solve {fused:.2f} ms; launches {res['launches']}")
    fails = []
    if not n_events > 0 or len(doc["traceEvents"]) != n_events \
            or not {"sched", "admission"} <= set(cats):
        fails.append(f"trace: {n_events} events, categories {cats}")
    for name, r in res["classes"].items():
        if not (r["done"] > 0 and np.isfinite(r["p99_s"])):
            fails.append(f"class {name}: {r}")
    for name in ("solve_targets_grid_torch", "grin_solve_batch_torch"):
        if name not in spans:
            fails.append(f"no {name} span")
    # a span that closed before its kernel ran would time the launch only
    if "grin_solve_batch_torch" in spans and \
            spans["grin_solve_batch_torch"]["max_s"] * 1e3 < 0.9 * fused:
        fails.append(f"the solve's span ({spans['grin_solve_batch_torch']}) "
                     f"is shorter than its kernel ({fused:.2f} ms)")
    if dev.type == "cuda" and not (res["launches"]["flash_attention"] > 0
                                   and res["launches"]["ssd_scan"] > 0):
        fails.append(f"the replay ran no model kernel: {res['launches']}")
    if fails:
        raise AssertionError("; ".join(fails))
    return res


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


@contextlib.contextmanager
def dropped_grad(fn, call: int, record: dict):
    """The negative control of a train phase's gradient check: the
    `call`-th backward of the kernels' autograd Function `fn` (the flash
    kernel's, the SSD scan's or mLSTM's pair's; the backward runs the
    layers last to first) returns zero gradients for its inputs."""
    real = fn.backward
    seen = {"n": 0}

    def backward(ctx, *grads):
        out = real(ctx, *grads)
        seen["n"] += 1
        if seen["n"] == call:
            record["dropped"] = True
            return tuple(g if g is None else g.zero_() for g in out)
        return out
    fn.backward = staticmethod(backward)
    try:
        yield
    finally:
        fn.backward = staticmethod(real)


@contextlib.contextmanager
def plain_scans():
    """`ops.ssd_scan` and `ops.mlstm_scan` replaced by their plain versions
    (the routes a CPU tensor takes, which autograd differentiates), for the
    train phases' gradient checks on the card."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan_wide as SSDW
    from repro_torch.models.linear_scan import linear_scan_chunked
    real = ops.ssd_scan, ops.mlstm_scan

    def ssd(q, k, v, log_a, beta, *, chunk=256):
        return linear_scan_chunked(q, k, v, log_a, beta, chunk=chunk)

    def pair(q, k, v, log_a, beta, *, chunk=256):
        return SSDW.mlstm_scan_plain(q, k, v, log_a, beta, chunk=chunk)
    ops.ssd_scan, ops.mlstm_scan = ssd, pair
    try:
        yield
    finally:
        ops.ssd_scan, ops.mlstm_scan = real


@contextlib.contextmanager
def plain_scan_backward():
    """The scans' backward kernels replaced by their plain versions
    (`ssd_scan_bwd_plain`, `mlstm_scan_bwd_plain`: the same float32 math)
    inside the autograd Functions, whose forwards stay the kernels: the
    reference of the train phases' gradient checks for the scans, with the
    forward on both sides the same."""
    from repro_torch.kernels import ssd_scan_bwd as SB
    real = (SB.ssd_scan_bwd_cuda, SB.mlstm_scan_bwd_cuda,
            SB.ssd_scan_wide_bwd_cuda)
    SB.ssd_scan_bwd_cuda = SB.ssd_scan_wide_bwd_cuda = SB.ssd_scan_bwd_plain
    SB.mlstm_scan_bwd_cuda = SB.mlstm_scan_bwd_plain
    try:
        yield
    finally:
        (SB.ssd_scan_bwd_cuda, SB.mlstm_scan_bwd_cuda,
         SB.ssd_scan_wide_bwd_cuda) = real


def leaf_groups(names) -> dict:
    """Leaf groups of a model's parameters: each block's mixer (attention,
    Mamba2, mLSTM, sLSTM), MLP and norms, zamba2's shared block's, the
    embedding, the head, the final norm."""
    groups = {}
    for n in names:
        parts = n.split(".")
        if parts[0] in ("layers", "mamba", "mlstm", "slstm"):
            kind = "ln" if parts[2].startswith("ln") else parts[2]
            key = f"{parts[0]}.{parts[1]}.{kind}"
        elif parts[0] == "shared":
            kind = "ln" if parts[1].startswith("ln") else parts[1]
            key = f"shared.{kind}"
        else:
            key = parts[0]
        groups.setdefault(key, []).append(n)
    return groups


def group_rel_errs(got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| per leaf group, float32."""
    out = {}
    for key, names in leaf_groups(want).items():
        num = sum(float((got[n].float() - want[n].float()).square().sum())
                  for n in names)
        den = sum(float(want[n].float().square().sum()) for n in names)
        out[key] = (num / den) ** 0.5 if den > 0 else float(num > 0)
    return out


def train_launches(cfg, micro: int = TRAIN_MICRO) -> dict:
    """The model kernels' launches in one train step of `micro`
    microbatches: a block's forward kernel twice a microbatch (the forward
    and its recompute in the backward), its backward kernel once."""
    m = micro
    if cfg.family == "hybrid":
        att = cfg.n_layers // cfg.attn_every
        return {"ssd_scan": 2 * cfg.n_layers * m,
                "ssd_scan_bwd": cfg.n_layers * m,
                "flash_attention": 2 * att * m, "flash_attention_bwd": att * m}
    if cfg.family == "ssm":
        n = (cfg.n_layers // cfg.slstm_every) * (cfg.slstm_every - 1)
        return {"mlstm_scan": 2 * n * m, "mlstm_scan_bwd": n * m}
    return {"flash_attention": 2 * cfg.n_layers * m,
            "flash_attention_bwd": cfg.n_layers * m}


def train_control(cfg):
    """(the autograd Function whose backward the gradient check's control
    drops once, its backward calls a microbatch, the leaf group that
    owns the layer `dropped_grad` hits at call n // 2)."""
    from repro_torch.kernels import ops
    if cfg.family == "hybrid":
        fn, n, block = ops._SSDScan, cfg.n_layers, "mamba.{}.mamba"
    elif cfg.family == "ssm":
        fn, block = ops._MLSTMScan, "mlstm.{}.mlstm"
        n = (cfg.n_layers // cfg.slstm_every) * (cfg.slstm_every - 1)
    else:
        fn, n, block = ops._FlashAttention, cfg.n_layers, "layers.{}.attn"
    return fn, n, block.format(n - n // 2)


@contextlib.contextmanager
def index_backward():
    """The MoE experts' gather and combine as plain indexing (`x2[idx]`,
    `rows[row[:, j]]` summed in float32), which autograd differentiates
    with `index_put_(accumulate=True)`: the route before the fixed-order
    Functions (`layers.dispatch_rows`, `combine_rows`), the same forward
    values."""
    import torch
    from repro_torch.models import layers as L
    real = L.dispatch_rows, L.combine_rows

    def dispatch(x2, idx, row):
        return x2[idx]

    def combine(rows, row, src):
        ext = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        y = torch.zeros((row.shape[0], rows.shape[1]), device=rows.device,
                        dtype=torch.promote_types(rows.dtype,
                                                  torch.float32))
        for j in range(row.shape[1]):
            y += ext[row[:, j]].to(y.dtype)
        return y
    L.dispatch_rows, L.combine_rows = dispatch, combine
    try:
        yield
    finally:
        L.dispatch_rows, L.combine_rows = real


def grad_check_routes(cfg, moe=None):
    """(compute dtype, {reference name: (its contexts, blocks, gated)}, the
    kernels' route's contexts) of a train phase's gradient check; contexts
    as a function returning fresh context managers, blocks None for the
    phase's whole model or a depth to cut it to (its first blocks, with the
    trained parameters), gated False for a figure only reported. Each
    reference comes with its own dropped-gradient control. The dense
    family: bf16, the kernels against the plain attention. The moe family:
    bf16, the kernels' route recording in `moe` (a dict) its routes
    (`recording_moe_routes`; the forward's calls, one a block, come first)
    and its router's choices, one a routing call, the recompute's included
    ("choices"), against the plain attention routed to those choices
    call by call (`choosing_experts`: a router near-tie that falls the
    other way under the other attention's rounding would read as a
    gradient error), against autograd's index backward for the experts'
    gather and combine under the same kernel forwards (`index_backward`),
    and, reported only, against the plain attention routing by itself. The
    hybrid and ssm families: float32, where rounding moves a check little
    (at bf16 the plain route against itself at another chunk reads 0.09
    for zamba2-7b at 27 blocks and 1.4 for xlstm-1.3b,
    `tools/train_grad_noise.py`), attention plain on every side (the flash
    kernels take bf16 only): the kernels against their plain backward under
    the same kernel forwards (`plain_scan_backward`), and against the plain
    scans' autograd (`plain_scans`), for xlstm-1.3b at its first
    TRAIN_SSM_CUT_GROUPS groups of blocks (at full depth that route reads
    0.19 against itself at float32, beyond any limit a check could hold;
    PERF.md section 7)."""
    if cfg.family == "dense":
        return (cfg.dtype, {"the plain attention": (lambda: (
            plain_attention(),), None, True)}, lambda: ())
    if cfg.family == "moe":
        from repro_torch.models.layers import top_k
        moe = {} if moe is None else moe
        routes, choices = moe.setdefault("routes", []), moe.setdefault(
            "choices", [])

        def record(i, probs):           # the router's own choice, kept
            choices.append(top_k(probs, cfg.top_k)[1])

        def pinned():
            return choosing_experts(cfg, lambda i, probs: choices[i])
        return (cfg.dtype, {
            "the plain attention, routed as the kernels": (
                lambda: (plain_attention(), pinned()), None, True),
            "autograd's index backward for the experts": (
                lambda: (index_backward(),), None, True),
            "the plain attention, routed by itself": (
                lambda: (plain_attention(),), None, False)},
            lambda: (recording_moe_routes(routes),
                     choosing_experts(cfg, record)))
    cut = (TRAIN_SSM_CUT_GROUPS * cfg.slstm_every if cfg.family == "ssm"
           else None)
    refs = {"the plain backward": (lambda: (plain_attention(),
                                            plain_scan_backward()), None,
                                   True),
            "the plain scans" + (f", first {cut} blocks" if cut else ""): (
                lambda: (plain_attention(), plain_scans()), cut, True)}
    return "float32", refs, lambda: (plain_attention(),)


def phase_train(dev, detail, smoke=False, arch=TRAIN_ARCH, layers=None,
                key="train", lr=None):
    """`arch` trained at full width (and depth, or `layers` blocks) from a
    random initialisation (a seeded generator) through `launch.train.train`:
    TRAIN_STEPS steps of TRAIN_B x TRAIN_S tokens in TRAIN_MICRO
    microbatches, every block and loss chunk recomputed in the backward.
    qwen2.5-3b by default (36 blocks, d_model 2048, 3.09 B parameters, tied
    embeddings; flash attention and its backward kernel in every layer);
    `phase_train_hybrid` and `phase_train_ssm` run zamba2-7b and
    xlstm-1.3b. Per step: seconds and tokens/s (the last step under the
    profiler, for the device time and busy share; the others without it),
    peak GB, each model kernel's launches (`train_launches`; nothing else)
    and no plain attention or scan call. Then one microbatch's gradients
    through the kernels against the reference routes of
    `grad_check_routes` (the plain attention for the dense family; at
    float32 the scans' plain backward and the plain scans, the latter for
    xlstm-1.3b on its first blocks), per leaf group, each with one layer's
    kernel gradient dropped as its control (`train_control`); and recovery at `smoke_config` (an injected failure,
    restore and replay, bit-equal to an uninterrupted run, through the
    backward kernels). `smoke` trains the reduced config instead (a
    rehearsal on a CPU). Results go to detail[key]."""
    import math
    import statistics
    import tempfile

    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch import train as T
    from repro_torch.models.model import Model
    from repro_torch.train.data import DataConfig, batch_for_step
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import compute_copy, loss_and_grads
    cfg = get_arch(arch)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    if smoke:
        cfg = smoke_config(cfg)
    want = train_launches(cfg)
    opt = OptimizerConfig(lr=lr or TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          decay_steps=TRAIN_STEPS)
    records = []

    def measure(step_fn):
        def run(state, batch):
            reset_all_launches()
            torch.cuda.reset_peak_memory_stats()
            # the last step runs under the profiler, the others without it
            profiled = state.step + 1 == TRAIN_STEPS
            busy = {}
            torch.cuda.synchronize()
            t = time.perf_counter()
            if profiled:
                out = {}
                busy = device_busy(lambda: out.update(r=step_fn(state,
                                                                batch)),
                                   cpu=False)
                r, s = out["r"], busy["wall_s"]
            else:
                r = step_fn(state, batch)     # its float metrics synchronise
                torch.cuda.synchronize()
                s = time.perf_counter() - t
            n = all_launches()
            m = r[1]
            rec = {"step": r[0].step,
                   "since_start_s": time.perf_counter() - t0,
                   "loss": m["loss"], "ce": m["ce"], "aux": m["aux"],
                   "grad_norm": m["grad_norm"], "lr": m["lr"],
                   "profiled": profiled, "s": s,
                   "tokens_per_s": TRAIN_B * TRAIN_S / s,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "device_s": busy.get("device_s"),
                   "busy_share": busy.get("busy_share"),
                   "launches": {k: n[k] for k in want},
                   "other_launches": {k: c for k, c in n.items()
                                      if c and k not in want},
                   "top": busy.get("top")}
            records.append(rec)
            print(f"  step {rec['step']}: loss {rec['loss']:.5f}"
                  + (f" (ce {rec['ce']:.5f}, aux {rec['aux']:.5f})"
                     if rec["aux"] else "") + " grad norm "
                  f"{rec['grad_norm']:.3f} lr {rec['lr']:.2e}; "
                  f"{rec['s']:.3f} s ({rec['tokens_per_s']:.0f} tok/s"
                  + (f"; under the profiler, device "
                     f"{rec['device_s'] or 0:.3f} s, busy "
                     f"{rec['busy_share'] or 0:.3f}" if profiled else "")
                  + f"), peak {rec['peak_gb']:.2f} GB; launches "
                  f"{rec['launches']}", flush=True)
            return r
        return run

    plain = {"ssd": 0, "attention": 0}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d, counting_plain_routes(plain):
        res = T.train(arch, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                      microbatches=TRAIN_MICRO, smoke=smoke, layers=layers,
                      ckpt_dir=d, ckpt_every=TRAIN_STEPS + 1, device=dev,
                      opt=opt, step_wrapper=measure)
    train_s = time.perf_counter() - t0
    model, state = res["model"], res["state"]
    print(f"  set-up before the first step (model, init, optimizer state, "
          f"data): {records[0]['since_start_s'] - records[0]['s']:.1f} s"
          if records else "  no step ran")
    n_params = sum(p.numel() for p in state.params.values())
    losses = [r["loss"] for r in records]
    ces = [r["ce"] for r in records]
    loss0 = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    # the steps after the first (which warms the allocator and the
    # libraries) and before the profiled last one
    timed = [r["s"] for r in records[1:] if not r["profiled"]]
    step_s = statistics.median(timed) if timed else None
    prof_rec = next((r for r in records if r["profiled"]), None)
    busy_est = (prof_rec["device_s"] / step_s
                if prof_rec and prof_rec["device_s"] and step_s else None)
    print(f"  {cfg.name} ({cfg.n_layers} blocks): {n_params:,} parameters; "
          f"{len(records)} steps of {TRAIN_B} x {TRAIN_S} in {TRAIN_MICRO} "
          f"microbatches in {train_s:.1f} s (init included); losses "
          f"{[round(x, 4) for x in losses]}, cross-entropy "
          f"{[round(x, 4) for x in ces]} (first expected {loss0:.3f} +- "
          f"{TRAIN_LOSS0_TOL}); plain calls {plain}")
    if step_s:
        print(f"  steps 2-{TRAIN_STEPS - 1} without the profiler: median "
              f"{step_s:.4f} s ({TRAIN_B * TRAIN_S / step_s:.0f} tok/s); "
              f"the profiled step's device time over it "
              f"{busy_est or 0:.3f}")

    # one microbatch's gradients: kernels, the reference routes, the control
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                    global_batch=TRAIN_B)
    mb = {k: torch.from_numpy(v[:TRAIN_B // TRAIN_MICRO]).to(dev)
          for k, v in batch_for_step(dc, 0).items()}
    state.opt = {}                      # the moments: not needed from here
    torch.cuda.empty_cache()
    moe = {}                            # the moe family's routes, choices
    check_dtype, refs, kernel_ctx = grad_check_routes(cfg, moe)
    routes = moe.get("routes", [])
    pc = compute_copy(state.params, getattr(torch, check_dtype))
    t1 = time.perf_counter()

    def grads(m, p, *ctx):
        with contextlib.ExitStack() as st:
            for c in ctx:
                st.enter_context(c)
            loss, _, g = loss_and_grads(m, p, mb)
        return float(loss), g
    # the moe family: one microbatch's gradients taken again by the kernels'
    # route and by the index backward's, the leaves that differ between
    # the two runs of each
    repeats = {}

    def repeat(route, g, m, p, *ctx):
        again = grads(m, p, *ctx)[1]
        repeats[route] = [n for n in g if not torch.equal(g[n], again[n])]
        del again
        print(f"  {route}: one microbatch's gradients twice, "
              + ("bit-equal in every leaf" if not repeats[route] else
                 f"{len(repeats[route])} leaves differ, e.g. "
                 f"{repeats[route][:4]}"), flush=True)
    checks, runs = {}, {}
    for name, (ctx, blocks, gated) in refs.items():
        ccfg = cfg.with_(dtype=check_dtype,
                         **({"n_layers": blocks} if blocks else {}))
        if blocks:      # the first blocks, with the trained parameters
            m = Model(ccfg, device="meta")
            p = {n: pc[n] for n, _ in m.named_parameters()}
        else:
            m, p = model, pc
            m.cfg = ccfg
        fn, n_bwd, drop_group = train_control(ccfg)
        if blocks not in runs:  # the kernels, and with the control
            runs.clear()
            dropped = {}
            runs[blocks] = (grads(m, p, *kernel_ctx()),
                            grads(m, p, *kernel_ctx(), dropped_grad(
                                fn, n_bwd // 2, dropped))[1],
                            bool(dropped))
            if cfg.family == "moe":
                repeat("fixed-order Functions", runs[blocks][0][1], m, p)
            torch.cuda.empty_cache()
        (loss_k, g_k), g_f, was_dropped = runs[blocks]
        loss_r, g_r = grads(m, p, *ctx())
        if name == "autograd's index backward for the experts":
            repeat("autograd's index backward", g_r, m, p, *ctx())
        rel, rel_f = group_rel_errs(g_k, g_r), group_rel_errs(g_f, g_r)
        del g_k, g_f, g_r
        torch.cuda.empty_cache()
        worst, worst_f = max(rel, key=rel.get), max(rel_f, key=rel_f.get)
        checks[name] = {
            "gated": gated,
            "blocks": ccfg.n_layers, "loss_kernel": loss_k, "loss": loss_r,
            "rel": rel, "worst": worst, "control": fn.__name__,
            "dropped_group": drop_group, "dropped": was_dropped,
            "rel_dropped": rel_f, "worst_dropped": worst_f}
        print(f"  gradients of one {TRAIN_B // TRAIN_MICRO} x {TRAIN_S} "
              f"microbatch at {check_dtype} compute, {ccfg.n_layers} "
              f"blocks, through the kernels (loss {loss_k:.6f}) against "
              f"{name} (loss {loss_r:.6f}): worst group ||d|| / ||ref|| "
              f"{rel[worst]:.2e} ({worst}); "
              f"{f'limit {GRAD_REL_TOL}' if gated else 'reported only'}; "
              f"{fn.__name__}'s gradient dropped once ({drop_group}): "
              f"{rel_f[worst_f]:.2e} ({worst_f})", flush=True)
    model.cfg = cfg
    del runs, pc
    torch.cuda.empty_cache()
    grad_s = time.perf_counter() - t1
    print(f"  gradient checks: {grad_s:.1f} s")
    # the kernels' first forward's MoE calls, one a block in order
    moe_dropped = [int(r["dropped"]) for r in routes[:cfg.n_layers]]
    if moe_dropped:
        t_mb = TRAIN_B // TRAIN_MICRO * TRAIN_S
        print(f"  dropped choices per layer at capacity "
              f"{tuple(routes[0]['top_i'].shape)[1]} an expert (of "
              f"{t_mb * cfg.top_k}): {moe_dropped}")
    moe.clear()

    # recovery at smoke_config: an uninterrupted run and one with a failure
    kw = dict(steps=RECOVERY_STEPS, batch=4, seq=256, microbatches=2,
              smoke=True, ckpt_every=3, device=dev,
              opt=OptimizerConfig(warmup_steps=2,
                                  decay_steps=RECOVERY_STEPS))
    calls = {"n": 0}

    def flaky(step_fn):
        def run(state_, batch):
            calls["n"] += 1
            if calls["n"] == RECOVERY_FAIL_AT:
                raise RuntimeError("injected node failure")
            return step_fn(state_, batch)
        return run
    del model, state, res
    torch.cuda.empty_cache()
    reset_all_launches()
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        clean = T.train(arch, ckpt_dir=d1, log=lambda *a: None, **kw)
        healed = T.train(arch, ckpt_dir=d2, step_wrapper=flaky,
                         log=lambda *a: None, **kw)
    rec_launches = all_launches()
    same = all(bool(torch.equal(p, clean["state"].params[n]))
               for n, p in healed["state"].params.items())
    rec_s = time.perf_counter() - t2
    print(f"  recovery at smoke_config ({RECOVERY_STEPS} steps, failure at "
          f"call {RECOVERY_FAIL_AT}, checkpoints every 3): restarts "
          f"{healed['restarts']}, steps {healed['steps']}, parameters "
          f"{'bit-equal to' if same else 'DIFFERENT from'} the "
          f"uninterrupted run's; launches "
          f"{ {k: c for k, c in rec_launches.items() if c} }; "
          f"{rec_s:.1f} s")

    per_step = [{k: v for k, v in r.items() if k != "top"} for r in records]
    detail[key] = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
        "B": TRAIN_B, "S": TRAIN_S, "microbatches": TRAIN_MICRO,
        "steps": per_step, "median_step_s": step_s,
        "busy_share_est": busy_est,
        "top_profiled_step": prof_rec["top"] if prof_rec else None,
        "train_s": train_s, "loss0_expected": loss0,
        "plain_calls": plain, "launches_per_step_expected": want,
        "grad_check": {"dtype": check_dtype, "against": checks,
                       "seconds": grad_s},
        **({"moe_dropped_per_layer": moe_dropped,
            "repeat_leaves_differing": repeats} if moe_dropped else {}),
        "recovery": {"restarts": healed["restarts"],
                     "steps": healed["steps"], "bit_equal": same,
                     "launches": rec_launches, "seconds": rec_s}}
    faults = []
    if len(records) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        faults.append(f"losses {losses}")
    elif not abs(ces[0] - loss0) <= TRAIN_LOSS0_TOL:
        faults.append(f"first cross-entropy {ces[0]:.4f}, expected "
                      f"{loss0:.4f}")
    elif not losses[-1] < losses[0]:
        faults.append(f"last loss {losses[-1]:.4f} not below the first")
    for r in records:
        if r["launches"] != want or r["other_launches"]:
            faults.append(f"step {r['step']}: launches {r['launches']} other "
                          f"{r['other_launches']}, expected {want}")
    if plain["attention"] or plain["ssd"]:
        faults.append(f"plain calls on the main path: {plain}")
    if repeats.get("fixed-order Functions"):
        faults.append("one microbatch's gradients differ between two runs "
                      f"in {repeats['fixed-order Functions'][:4]}")
    for name, c in checks.items():
        if not c["gated"]:
            continue
        if not c["rel"][c["worst"]] <= GRAD_REL_TOL:
            faults.append(f"gradients off {name}'s in {c['worst']}: "
                          f"{c['rel'][c['worst']]:.3g}")
        if not c["dropped"] \
                or c["rel_dropped"][c["worst_dropped"]] <= GRAD_REL_TOL:
            faults.append(f"the gradient check against {name} passes a "
                          f"dropped {c['control']} gradient")
    bwd = [k for k in want if k.endswith("_bwd")]
    if healed["restarts"] != 1 or healed["steps"] != RECOVERY_STEPS \
            or not same or not all(rec_launches[k] > 0 for k in bwd):
        faults.append("recovery not bit-equal or not through the kernels")
    if faults:
        raise AssertionError("; ".join(faults))
    measured = {k: sorted({r["launches"][k] for r in records}) for k in want}
    return {**{k: sum(r["launches"][k] for r in records) for k in want},
            "per_step": {k: n[0] if len(n) == 1 else n
                         for k, n in measured.items()}}


# the train-moe phase: granite-moe-3b-a800m at full width cut to this many
# of its 32 blocks since the train-sharded phase was added (full depth
# before: 43.7 s of phase on a slow host, PERF.md section 5)
TRAIN_MOE_LAYERS = 16


def phase_train_moe(dev, detail, smoke=False):
    """granite-moe-3b-a800m at full width cut to TRAIN_MOE_LAYERS blocks
    (of 32; GQA attention, 24 / 8 heads of 64, and 40 experts, top 8, of
    width 512; d_model 1536): `phase_train`'s run, checks and recovery,
    through the flash kernels and the experts' fixed-order backward
    (`layers.dispatch_rows`, `combine_rows`), at capacity 1,024 an expert
    a microbatch; also one microbatch's gradients twice, by the Functions
    and by autograd's index backward, compared bit for bit."""
    return phase_train(dev, detail, smoke, arch=MOE_ARCH, key="train_moe",
                       layers=None if smoke else TRAIN_MOE_LAYERS)


TRAINED_CELLS = (("train", TRAIN_ARCH, None),
                 ("train_hybrid", SERVE_ARCH, TRAIN_HYBRID_LAYERS),
                 ("train_ssm", XLSTM_ARCH, None),
                 ("train_moe", MOE_ARCH, TRAIN_MOE_LAYERS))


def phase_dryrun(dev, detail):
    """`launch.dryrun.lower_cell` on the one-card mesh (`make_debug_mesh`)
    for each train phase's cell (its arch, depth and TRAIN_B x TRAIN_S in
    TRAIN_MICRO microbatches), on the meta device: the per-device bytes of
    the state it should take (masters, float32 gradients, moments, the
    compute copy and one microbatch's gradients) and the reference's stash
    estimate, beside the train phase's measured peak
    (`max_memory_allocated`). Reported, not gated."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(devices=[dev])
    shape = ShapeConfig("train_smoke", TRAIN_S, TRAIN_B, "train",
                        microbatches=TRAIN_MICRO)
    out = {}
    for key, arch, layers in TRAINED_CELLS:
        cfg = get_arch(arch)
        cfg = cfg.with_(n_layers=layers) if layers else cfg
        _, info = lower_cell(arch, shape.name, mesh, cfg=cfg, shape=shape,
                             trace=False)
        mem = info["per_device_bytes"]
        steps = (detail.get(key) or {}).get("steps") or []
        peak = max((r["peak_gb"] for r in steps), default=None)
        out[key] = {"arch": cfg.name, "layers": cfg.n_layers,
                    "per_device_bytes": mem,
                    "stash_estimate": info["stash_estimate"],
                    "measured_peak_gb": peak}
        print(f"  {key} ({cfg.name}, {cfg.n_layers} blocks): state "
              f"{mem['total'] / 1e9:.2f} GB predicted ("
              + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in mem.items()
                          if k != "total")
              + f"), stash estimate {info['stash_estimate'] / 1e9:.2f} GB; "
              f"measured peak "
              + (f"{peak:.2f} GB" if peak is not None else "not run"))
    detail["dryrun"] = out
    return out


# the examples' counterparts and their arguments: their defaults, and the
# reference example's own smoke mode for serve_heterogeneous (80 requests of
# the trace, 2 measurement repetitions: at its defaults it took 66 s on an
# NVIDIA H100 80GB HBM3 at 700 W beside the other three)
EXAMPLES = {"quickstart_torch.py": (), "schedule_cluster_torch.py": (),
            "serve_heterogeneous_torch.py": ("--smoke",),
            "train_lm_torch.py": ()}
EXAMPLES_TIMEOUT_S = 240


def phase_examples(dev, detail):
    """The examples' counterparts (`examples/*_torch.py`), each run with
    the arguments of EXAMPLES (on the card; `--device cpu` for a CPU
    rehearsal) in a process of its own, all four at once, with a fresh
    temporary directory (train_lm's checkpoints): each must exit 0. Prints
    each one's seconds from the start (EXAMPLES_TIMEOUT_S at most) and the
    last lines of its output."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    extra = [] if dev.type == "cuda" else ["--device", "cpu"]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        env["TMPDIR"] = tmp
        t0 = time.perf_counter()
        procs = {}
        for name, args in EXAMPLES.items():
            log = open(Path(tmp) / f"{name}.log", "w+")
            procs[name] = (log, subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / name), *args,
                 *extra], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT, text=True))
        while len(res) < len(procs):
            for name, (log, proc) in procs.items():
                late = time.perf_counter() - t0 > EXAMPLES_TIMEOUT_S
                if name in res or (proc.poll() is None and not late):
                    continue
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.seek(0)
                res[name] = {"rc": proc.returncode,
                             "s": time.perf_counter() - t0,
                             "tail": log.read().strip().splitlines()[-4:]}
                log.close()
            time.sleep(0.05)
        wall = time.perf_counter() - t0
    for name, r in res.items():
        print(f"  {name}: rc {r['rc']}, {r['s']:.1f} s; "
              + " | ".join(r["tail"]))
    print(f"  all four at once: {wall:.1f} s")
    detail["examples"] = {"runs": res, "wall_s": wall}
    bad = [n for n, r in res.items() if r["rc"] != 0]
    if bad:
        raise AssertionError(f"examples failed: {bad}")
    return res


def phase_train_hybrid(dev, detail, smoke=False):
    """zamba2-7b at full width, depth cut to TRAIN_HYBRID_LAYERS Mamba2
    blocks (the shared attention block after every 6, then the trailing
    3, as at 81 = 13 x 6 + 3): `phase_train`'s run, checks and recovery,
    through the SSD scan's forward and backward kernels and flash
    attention's."""
    return phase_train(dev, detail, smoke, arch=SERVE_ARCH,
                       layers=None if smoke else TRAIN_HYBRID_LAYERS,
                       key="train_hybrid")


def phase_train_ssm(dev, detail, smoke=False):
    """xlstm-1.3b at full width and depth (42 mLSTM and 6 sLSTM blocks):
    `phase_train`'s run, checks and recovery, through the wide SSD
    kernel's pair (`mlstm_scan_cuda`) and its backward kernel."""
    return phase_train(dev, detail, smoke, arch=XLSTM_ARCH, key="train_ssm",
                       lr=TRAIN_SSM_LR)


# the train-sharded phase: SHARDED_RANKS processes on the one card as a
# (data 2, model 2) mesh over gloo (NCCL refuses two ranks on one device),
# CUDA tensors staged through pinned host buffers; the six families at
# full width cut to SHARDED_LAYERS blocks (qwen2.5-3b 4 of 36,
# granite-moe-3b-a800m 4 of 32, musicgen-medium 4 of 48, phi-3-vision-4.2b
# 4 of 32, zamba2-7b 7 of 81: one group of 6 Mamba2 blocks, the shared
# block once, one trailing block; xlstm-1.3b 8 of 48: one group of 7 mLSTM
# and 1 sLSTM); one step of SHARDED_B x SHARDED_S tokens in SHARDED_MICRO
# microbatches, held to the same step on one rank
SHARDED_RANKS = 4
SHARDED_ARCHS = (TRAIN_ARCH, MOE_ARCH, AUDIO_ARCH, VLM_ARCH, SERVE_ARCH,
                 XLSTM_ARCH)
SHARDED_LAYERS = {TRAIN_ARCH: 4, MOE_ARCH: 4, AUDIO_ARCH: 4, VLM_ARCH: 4,
                  SERVE_ARCH: 7, XLSTM_ARCH: 8}
SHARDED_B, SHARDED_S, SHARDED_MICRO = 4, 4096, 2
# the first loss against the one-rank run's: bf16 partial sums meet in
# another order across ranks
SHARDED_LOSS_REL = 5e-3
SHARDED_TIMEOUT_S = 480
# each rank's heads at model 2, by kernel: flash (q heads, kv heads), the
# SSD scan's and mLSTM's pair's heads
SHARDED_HEADS = {TRAIN_ARCH: {"flash": (8, 1)},
                 MOE_ARCH: {"flash": (12, 4)},
                 AUDIO_ARCH: {"flash": (12, 12)},
                 VLM_ARCH: {"flash": (16, 16)},
                 SERVE_ARCH: {"flash": (16, 16), "ssd": (56,)},
                 XLSTM_ARCH: {"pair": (2,)}}
# the families whose gradient check runs at float32 (the sharded step
# and its control again, and the one-rank step, at float32; attention
# plain on both sides, the flash kernels taking bf16 only): their bf16
# rounding alone reaches GRAD_REL_TOL. One rank's bf16 gradients lie 4.8e-2
# (zamba2-7b at 7 blocks, mamba.0.ln) and 1.25 (xlstm-1.3b at 8, embed)
# from its float32 ones with the plain scans, and the bf16 kernels 2.55e-2
# and 0.85 from the bf16 plain scans (tools/sharded_grad_floor.py
# --against-float32; on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md section
# 6); the sharded bf16 step read 3.36e-2 and 1.15 from one rank's. The
# float32 checks read 1.34e-3 and 4.71e-3 because the scan kernels round
# their operands to bf16 at float32 inputs too (2.40e-3 and 5.74e-3
# against the plain float32 scans on one rank). The main path, whose
# launches are counted, runs in bf16 for every family, its first loss held
# to one rank's bf16 run's
SHARDED_CHECK_F32 = (SERVE_ARCH, XLSTM_ARCH)
# of those, the families whose bf16 main path's gradients are held too: per
# leaf group no farther from one rank's float32 gradients than one rank's
# bf16 ones are, plus GRAD_REL_TOL (zamba2-7b's four bf16 routes, the
# kernels, at twice the microbatches, the plain scans and the sharded step,
# lie within 2.0e-3 of each other in that distance). Not xlstm-1.3b: its
# routes' distances spread by up to 2.2 (up to 1.26 through the kernels,
# 3.31 through the plain scans), so no margin there tells a fault from
# rounding; its bf16 gradients are printed
SHARDED_BF16_GRADS = (SERVE_ARCH,)
# granite-moe's router scores on each shard's rows against the one-rank
# run's on the same rows (||d|| / ||ref|| a routing call), as the
# gradients are held: a shard routing other rows reads ~1.4
SHARDED_SCORE_REL = GRAD_REL_TOL


@contextlib.contextmanager
def dropped_row_sum(block: str, layer: int, sum_name="row_parallel_sum"):
    """The negative control of the sharded check: in the `layer`-th
    `block` ("apply_mlp", "apply_attention", "apply_mlstm" or "apply_mamba"
    of `models.layers`, in the order the model first calls them) the
    model-axis sum `sum_name` of `models.layers` left as this rank's part
    (the row-parallel output's, `row_parallel_sum`, or Mamba2's gated
    norm's sum of squares, `norm_sum_over_model`), in the forward and the
    recompute alike."""
    from repro_torch.models import layers as L
    real_block, real_sum = getattr(L, block), getattr(L, sum_name)
    seen, skip = [], {"on": False}

    def wrapped(p, *args, **kw):
        if p not in seen:
            seen.append(p)
        skip["on"] = seen.index(p) == layer
        try:
            return real_block(p, *args, **kw)
        finally:
            skip["on"] = False

    def row_sum(y):
        return y if skip["on"] else real_sum(y)
    setattr(L, block, wrapped)
    setattr(L, sum_name, row_sum)
    try:
        yield
    finally:
        setattr(L, block, real_block)
        setattr(L, sum_name, real_sum)


def sharded_control(cfg):
    """The sharded check's control for `cfg`'s family, in its middle
    block: a row-parallel layer's model-axis sum left out (the MLP's; the
    moe family's attention output, its experts being whole; mLSTM's
    output for the ssm family), or for the hybrid family the gated norm's
    sum of squares over "model" (`dropped_row_sum`)."""
    if cfg.family == "hybrid":
        return dropped_row_sum("apply_mamba", cfg.n_layers // 2,
                               "norm_sum_over_model")
    if cfg.family == "ssm":
        return dropped_row_sum("apply_mlstm", (cfg.slstm_every - 1) // 2)
    return dropped_row_sum("apply_attention" if cfg.family == "moe"
                           else "apply_mlp", cfg.n_layers // 2)


@contextlib.contextmanager
def kernel_heads(seen: set):
    """Record each model kernel launch's heads in `seen`: flash forward and
    backward as ("fwd" / "bwd", q heads, kv heads), the SSD scan and
    mLSTM's pair as ("ssd" / "ssd_bwd" / "pair" / "pair_bwd", heads) (the
    kernels' wrappers still count their launches)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssd_scan_bwd as SB
    from repro_torch.kernels import ssd_scan_wide as SSDW
    swaps = [(FA, "flash_attention_cuda", lambda q, k, v: ("fwd", q.shape[2],
                                                          k.shape[2])),
             (FA, "flash_attention_bwd_cuda",
              lambda q, k, v: ("bwd", q.shape[2], k.shape[2])),
             (SSD, "ssd_scan_cuda", lambda q, k, v: ("ssd", v.shape[2])),
             (SB, "ssd_scan_bwd_cuda", lambda q, k, v: ("ssd_bwd",
                                                        v.shape[2])),
             (SSDW, "mlstm_scan_cuda", lambda q, k, v: ("pair", v.shape[2])),
             (SB, "mlstm_scan_bwd_cuda", lambda q, k, v: ("pair_bwd",
                                                          v.shape[2]))]
    real = [getattr(mod, name) for mod, name, _ in swaps]

    def recording(fn, key):
        def run(q, k, v, *a, **kw):
            seen.add(key(q, k, v))
            return fn(q, k, v, *a, **kw)
        return run
    for (mod, name, key), fn in zip(swaps, real):
        setattr(mod, name, recording(fn, key))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, real):
            setattr(mod, name, fn)


def sharded_expected(cfg, arch: str) -> tuple[dict, list]:
    """({kernel: launches a rank}, sorted heads records) of the main path's
    step for `arch` at `cfg`'s depth: `train_launches` at SHARDED_MICRO
    microbatches, each launch on the rank's SHARDED_HEADS."""
    want, heads = train_launches(cfg, SHARDED_MICRO), []
    h = SHARDED_HEADS[arch]
    if "flash" in h:
        heads += [["bwd", *h["flash"]], ["fwd", *h["flash"]]]
    if "ssd" in h:
        heads += [["ssd", *h["ssd"]], ["ssd_bwd", *h["ssd"]]]
    if "pair" in h:
        heads += [["pair", *h["pair"]], ["pair_bwd", *h["pair"]]]
    return want, sorted(heads)


@contextlib.contextmanager
def pinned_routing(record=None, replay=None, checks=None):
    """The MoE router's two decisions in each `moe_route` call (its `top_k`
    calls: each token's k experts, then each expert's capacity of tokens),
    in call order, recorded in `record` (a dict of lists: "idx", their
    indices; "scores" and "dropped", each call's router scores and dropped
    choices) or replayed: the i-th decision
    takes the indices and scores `replay(i)` gives, its values gathered
    from its own inputs. The train-sharded check's one-rank reference
    routes as the shards routed, so a decision that the ranks' other sums
    tip the other way (a near-tie of experts, or of tokens at an expert's
    capacity) reads as no gradient error. With `replay`, `checks` (a list)
    gets each replayed decision held to this run's own top_k on its own
    inputs (`routing_gap`), so the shards' decisions are checked and not
    only copied."""
    import torch
    from repro_torch.models import layers as L
    real, real_route, calls, scores = L.top_k, L.moe_route, [0], [None]

    def route(p, x, cfg):               # the router's scores, as moe_route
        with torch.no_grad():
            scores[0] = (x.reshape(-1, x.shape[-1])
                         @ p.router.to(x.dtype)).float()
        r = real_route(p, x, cfg)
        if record is not None:
            record["scores"].append(scores[0].cpu())
            record["dropped"].append(int(r["dropped"]))
        return r

    def pinned(x, k):
        i = calls[0]
        calls[0] += 1
        if replay is not None:
            idx, z_other = (t.to(x.device) for t in replay(i))
            if checks is not None:
                with torch.no_grad():
                    checks.append(routing_gap(x.detach(), real(x, k)[1],
                                              idx, scores[0], z_other,
                                              experts=i % 2 == 0))
            return x.gather(-1, idx), idx
        vals, idx = real(x, k)
        if record is not None:
            record["idx"].append(idx.cpu())
        return vals, idx
    L.top_k = pinned
    if checks is not None or record is not None:
        L.moe_route = route
    try:
        yield
    finally:
        L.top_k, L.moe_route = real, real_route


def routing_gap(v, own, idx, z, z_other, experts: bool) -> dict:
    """One routing decision over the rows of v, taken as `idx` (another
    run's, on its router scores `z_other`) against `own`, this run's top_k
    of v (on its scores z, (tokens, experts)). `experts`: v holds each
    token's expert probabilities (rows tokens, entries experts); else
    each expert's tokens' gates (rows experts, entries tokens). Returns
    the scores' difference ||z_other - z|| / ||z||; the rows whose chosen
    set differs; and of those the ones that the two runs' scores do not
    explain: where the largest entry left out exceeds the smallest taken,
    in log(v) (the scores' units), by more than the two runs' score
    difference can reorder (2 m_t for a token t's experts, 2 (m_t + m_u)
    for tokens t, u at an expert's capacity, m_t = max over t's experts of
    |z_other - z|: a gate is renormalised over its token's experts) plus
    MOE_TIE_SPACINGS bf16 spacings of the scores (this run's rounding). A
    decision of another shape (another capacity) differs in every row."""
    import torch
    rows = v.shape[0]
    drift = z_other - z
    out = {"rows": rows, "differ": rows, "beyond": rows,
           "gap_spacings": float("inf"),
           "score_rel": float(drift.norm() / z.norm())}
    if own.shape != idx.shape:
        return out
    differ = (own.sort(-1).values != idx.sort(-1).values).any(-1)
    out["differ"] = int(differ.sum())
    if idx.shape[-1] >= v.shape[-1]:
        out.update(beyond=0, gap_spacings=0.0)
        return out
    i_in = idx.gather(-1, v.gather(-1, idx).argmin(-1, keepdim=True))
    i_out = v.scatter(-1, idx, -1.0).argmax(-1, keepdim=True)
    v_in, v_out = v.gather(-1, i_in), v.gather(-1, i_out)
    m = drift.abs().amax(-1)                               # (tokens,)
    zr = z if experts else z.t()
    if experts:
        slack = 2 * m[:, None]
    else:
        slack = 2 * (m[i_in] + m[i_out])
    spacing = bf16_spacing(torch.maximum(zr.gather(-1, i_in).abs(),
                                         zr.gather(-1, i_out).abs()))
    gap = torch.where(v_out > v_in,
                      (v_out.log() - v_in.log() - slack) / spacing,
                      torch.zeros_like(v_in)).squeeze(-1)
    beyond = differ & (gap > MOE_TIE_SPACINGS)
    out.update(beyond=int(beyond.sum()), gap_spacings=float(gap.max()))
    return out


@contextlib.contextmanager
def step_parts(parts: dict):
    """Host seconds of the train step's parts, each ended by a device
    synchronise, added up in `parts`: the sharded compute copy, each
    microbatch's loss and gradients, the gradients' reduction to the
    masters, the update."""
    import torch
    from repro_torch.train import train_step as TS
    names = ("sharded_compute_copy", "loss_and_grads", "sharded_grads",
             "apply_updates")
    real = {n: getattr(TS, n) for n in names}

    def timed(name):
        def run(*args, **kw):
            t = time.perf_counter()
            out = real[name](*args, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
            return out
        return run
    for n in names:
        setattr(TS, n, timed(n))
    try:
        yield
    finally:
        for n in names:
            setattr(TS, n, real[n])


# the kernels at a rank's shapes in the train-sharded phase (model 2), one
# microbatch row: flash (B, S, q heads, kv heads, dh, window) for
# musicgen-medium, phi-3-vision-4.2b (256 patches + 4096 tokens) and
# zamba2-7b's shared block; the SSD scan's heads (56 of zamba2-7b's 112)
# and the pair's (2 of xlstm-1.3b's 4)
SHARDED_FLASH_SHAPES = {AUDIO_ARCH: (1, SHARDED_S, 12, 12, 64, 0),
                        VLM_ARCH: (1, 256 + SHARDED_S, 16, 16, 96, 0),
                        SERVE_ARCH: (1, SHARDED_S, 16, 16, 112, 4096)}
SHARDED_SCAN_HEADS = {"ssd": 56, "pair": 2}


def sharded_kernel_rows(dev) -> tuple[dict, list]:
    """({kernel: [rows]}, faults): each model kernel the train-sharded
    phase launches for the four families it added, at a rank's shapes
    (SHARDED_FLASH_SHAPES, SHARDED_SCAN_HEADS), against its plain version
    on the same inputs: flash forward (`_close_rows` at ATTN_TOL) with
    SDPA's time, its backward (`measure_flash_bwd`), the SSD scan and the
    pair forward (`measure_fwd_train`) and backward (`measure_ssd_bwd` at
    slow decay, each launch's name and ms from its profile); each with its
    ms, the plain version's and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    rows = {n: [] for n in ("flash_attention", "flash_attention_bwd",
                            "ssd_scan", "ssd_scan_bwd", "mlstm_scan",
                            "mlstm_scan_bwd")}
    faults = []
    for i, (arch, (b, s, h, kv, dh, win)) in enumerate(
            SHARDED_FLASH_SHAPES.items()):
        q, k, v = _attn_inputs(dev, 900 + i, b, s, h, kv, dh)
        got = FA.flash_attention_cuda(q, k, v, window=win)
        err, rel, ok = _close_rows(got, FA.flash_attention_plain(
            q, k, v, window=win), ATTN_TOL)
        del got
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if win:
            ones = torch.ones((s, s), dtype=torch.bool, device=dev)
            mask = torch.tril(ones) & ~torch.tril(ones, diagonal=-win)
            del ones
        ms = cuda_ms(lambda: FA.flash_attention_cuda(q, k, v, window=win),
                     iters=10, warmup=2)
        plain_ms = cuda_ms(lambda: FA.flash_attention_plain(
            q, k, v, window=win), iters=2, warmup=1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None),
            iters=10, warmup=2)
        bound, by, _, ops = attention_bound(b, s, h, kv, dh, win)
        rows["flash_attention"].append({
            "arch": arch, "B": b, "S": s, "H": h, "KV": kv, "dh": dh,
            "window": win, "max_abs_err": err, "max_err_over_row_rms": rel,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": by, "bound_share": bound / ms})
        if not ok:
            faults.append(f"flash at {arch}'s rank shape off by {rel:.3g} "
                          f"of a row's rms")
        del q, k, v, qt, kt, vt, mask
        bw = measure_flash_bwd(dev, 910 + i, b, s, h, kv, dh, win)
        rows["flash_attention_bwd"].append({"arch": arch, **{
            n: bw[n] for n in ("B", "S", "H", "KV", "dh", "window",
                               "max_abs_err", "errs", "ms", "launch_ms",
                               "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "bound_share")}})
        faults += [f"flash bwd at {arch}'s rank shape: {f}"
                   for f in flash_bwd_faults(bw)]
        torch.cuda.empty_cache()
    for pair, (fwd, bwd) in ((False, ("ssd_scan", "ssd_scan_bwd")),
                             (True, ("mlstm_scan", "mlstm_scan_bwd"))):
        heads = SHARDED_SCAN_HEADS["pair" if pair else "ssd"]
        f = measure_fwd_train(dev, pair, heads=heads)
        rows[fwd].append(f)
        if not f["ok"]:
            faults.append(f"{fwd} at a rank's {heads} heads off: y "
                          f"{f['y_err']:.3g}, state {f['state_err']:.3g}")
        bw = measure_ssd_bwd(dev, pair, heads=heads,
                             biases=(SLOW_FORGET_BIAS,))
        rows[bwd].append({n: bw[n] for n in (
            "H", "dk", "dv", "max_abs_err", "max_err", "ms", "launch_ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_share")})
        faults += [f"{bwd} at a rank's {heads} heads: {x}"
                   for x in ssd_bwd_faults(bw)]
        torch.cuda.empty_cache()
    return rows, faults


def print_sharded_kernel_rows(rows: dict) -> None:
    for name, rs in rows.items():
        for r in rs:
            shape = (f"({r['B']}, {r['S']}, {r['H']} / {r['KV']}, "
                     f"{r['dh']}) window {r['window']}" if "KV" in r else
                     f"{r['H']} heads of {r['dk']} x {r['dv']}")
            print(f"  {name} at a rank's {shape}"
                  + (f" ({r['arch']})" if "arch" in r else "")
                  + f": max abs err {r['max_abs_err']:.3g}, ms "
                  f"{r['ms']:.3f}, plain {r['plain_ms']:.2f}, bound "
                  f"{r['bound_ms']:.3f} ({r['bound_by']}; "
                  f"{r['bound_share']:.2f} of it)"
                  + (f", SDPA {r['library_ms']:.3f}"
                     if r.get("library_ms") is not None else "")
                  + (f", each launch's ms from the profile "
                     f"{ {k: round(v, 3) for k, v in r['launch_ms'].items()} }"
                     if "launch_ms" in r else ""))


def phase_sharded_kernels(dev, detail):
    """The train-sharded phase's kernels at a rank's shapes
    (`sharded_kernel_rows`), printed; raises on a fault. The smoke runs it
    right after model-kernels: later in a full smoke a profile in this
    process records no device events (PERF.md section 6), and these rows
    name each backward launch from one."""
    rows, faults = sharded_kernel_rows(dev)
    print_sharded_kernel_rows(rows)
    detail["kernels_at_rank_shapes"] = rows
    if faults:
        raise AssertionError("; ".join(faults))
    return rows


def sharded_cell(arch: str, smoke: bool):
    """(cfg, B, S, microbatches) of the train-sharded phase for `arch`."""
    from repro_torch.configs import get_arch, smoke_config
    cfg = get_arch(arch).with_(n_layers=SHARDED_LAYERS[arch])
    if smoke:       # a CPU rehearsal at float32, where the sums' order shows
        return (smoke_config(cfg).with_(dtype="float32"), 4, 64,
                SHARDED_MICRO)
    return cfg, SHARDED_B, SHARDED_S, SHARDED_MICRO


def sharded_arch(arch: str, smoke: bool, world: dict, mesh) -> dict:
    """One rank's part of the train-sharded phase for `arch` (every rank
    runs it): the sharded step through `launch.train.train` (launches,
    each kernel's heads, peak memory, collective bytes, seconds), the same
    step with the control's sum left out (`sharded_control`), rank 0's
    one-rank step from the same seed and batch (for the moe family the
    per-shard dispatch, routed as the shards routed with each choice held
    to its own top_k, and beside it the per-shard dispatch on its own
    routing and the global dispatch), and the gradients gathered leaf by
    leaf to rank 0 and compared per leaf group. For SHARDED_CHECK_F32's
    families the check's steps (the sharded one again, its control, the
    one-rank one) run at float32 with the plain attention, and rank 0
    takes the main path's bf16 step on one rank too: the main path's
    gradients are compared with it ("rel_bf16") and with the float32
    one-rank run's ("rel_bf16_vs_f32"), beside the one-rank bf16 run's own
    distance from the float32 one ("floor_bf16"). Returns rank 0's verdict
    (the others' figures in it)."""
    import tempfile

    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import train as T
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as S
    from repro_torch.train.data import DataConfig, batch_for_step
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg, B, Sq, M = sharded_cell(arch, smoke)
    dev = world["device"]
    on_card = dev.type == "cuda"
    rank0 = world["rank"] == 0
    opt = OptimizerConfig(lr=TRAIN_LR, warmup_steps=1, decay_steps=1)
    moe = cfg.family == "moe"
    # the gradient check's config and the contexts of its every step
    ccfg, cctx = cfg, (lambda: ())
    f32 = arch in SHARDED_CHECK_F32 and cfg.dtype != "float32"
    if f32:
        ccfg, cctx = cfg.with_(dtype="float32"), (lambda: (
            plain_attention(),))
    kw = dict(steps=1, batch=B, seq=Sq, microbatches=M, smoke=False,
              device=dev, opt=opt, ckpt_every=2, log=lambda *a: None)

    def run(config, *ctx):
        grads, choices = {}, {"idx": [], "scores": [], "dropped": []}
        with tempfile.TemporaryDirectory() as d, \
                contextlib.ExitStack() as st:
            for c in ctx:
                st.enter_context(c)
            if moe:
                st.enter_context(pinned_routing(record=choices))
            res = T.train(arch, ckpt_dir=d, grad_hook=grads.update,
                          config=config, **kw)
        h = res["history"][0]
        del res
        if on_card:
            torch.cuda.empty_cache()
        return h, grads, choices, choices.pop("dropped")

    # the main path: counts from 0 just before, read just after
    heads, plain, parts = set(), {"ssd": 0, "attention": 0}, {}
    reset_all_launches()
    C.reset_traffic()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting_plain_routes(plain), kernel_heads(heads), \
            step_parts(parts):
        hist, grads, choices, dropped = run(cfg)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = all_launches()
    mine = {"rank": world["rank"], "coords": mesh.coords,
            "loss": hist["loss"], "step_s": hist["s"], "train_s": wall,
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None),
            "launches": {k: c for k, c in n.items() if c},
            "heads": sorted(map(list, heads)), "plain": plain,
            "traffic": {k: dict(v) for k, v in C.traffic.items()},
            "parts_s": parts,
            "dropped": dropped[:cfg.n_layers]}
    # each comparison: (its name, the reference's key), and this rank's
    # gradients for it by name
    mine_grads = {"main": grads}
    comps = [("main", "grads"), ("control", "grads")]
    if moe:
        comps.append(("free", "free_grads"))
        mine_grads["free"] = grads
    t1 = time.perf_counter()
    if f32:     # the check's own sharded step; the main path's held apart
        mine_grads["bf16"] = mine_grads["bf16_vs_f32"] = grads
        comps += [("bf16", "grads_bf16"), ("bf16_vs_f32", "grads")]
        hist_k, mine_grads["main"], _, _ = run(ccfg, *cctx())
        mine["check_loss"] = hist_k["loss"]
    del grads
    hist_c, mine_grads["control"], _, _ = run(ccfg, sharded_control(ccfg),
                                              *cctx())
    mine["control_loss"] = hist_c["loss"]
    mine["control_s"] = time.perf_counter() - t1
    by_shard = C.all_gather_object(choices if mesh.coords["model"] == 0
                                   else None, mesh)
    del choices
    ranks = C.all_gather_object(mine, mesh)

    ref, t2 = {}, time.perf_counter()
    if rank0:                            # the one-rank step
        dc = DataConfig(vocab_size=ccfg.vocab_size, seq_len=Sq,
                        global_batch=B, n_codebooks=ccfg.n_codebooks,
                        n_patches=ccfg.n_patches, d_model=ccfg.d_model)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in batch_for_step(dc, 0).items()}
        shards = [c for c in by_shard if c is not None]

        def one_rank(config, micro, *ctx):
            g = {}
            with contextlib.ExitStack() as st:
                for c in ctx:
                    st.enter_context(c)
                model = Model(config, device=dev)
                state = init_train_state(
                    model, torch.Generator(device=dev).manual_seed(0), opt)
                _, met = make_train_step(model, opt, microbatches=micro,
                                         grad_hook=g.update)(state, batch)
            del model, state
            return met["loss"], g
        # each data shard's rows of each microbatch a microbatch of its own:
        # the same step, its per-row bf16 gradients summed in float32 as
        # the mesh sums them (with a microbatch's rows together, ln_f alone
        # moves 2.86e-2 by rounding: tools/sharded_grad_floor.py), and for
        # the moe family each shard routed alone, the auxes averaged
        n_sh = mesh.shape["data"]
        ctx, checks = (), []
        if moe:     # routed as the shards routed, decision by decision,
            per = len(shards[0]["idx"]) // M  # each held to its own top_k

            def replay(i):
                j, within = divmod(i, per)
                mb, d = divmod(j, n_sh)
                c = mb * per + within
                return shards[d]["idx"][c], shards[d]["scores"][c // 2]
            ctx = (pinned_routing(replay=replay, checks=checks),)
        ref["loss"], ref["grads"] = one_rank(ccfg, M * n_sh, *ctx, *cctx())
        if f32:     # the main path's own route on one rank, and its rounding
            ref["loss_bf16"], ref["grads_bf16"] = one_rank(cfg, M * n_sh)
            ref["floor_bf16"] = group_rel_errs(ref["grads_bf16"],
                                               ref["grads"])
        if moe:
            ref["routing"] = {k: sum(c[k] for c in checks)
                              for k in ("rows", "differ", "beyond")}
            ref["routing"].update(
                calls=len(checks),
                gap_spacings=max(c["gap_spacings"] for c in checks),
                score_rel=max(c["score_rel"] for c in checks))
            # per shard on its own routing; the global dispatch: a
            # microbatch's rows routed together
            ref["free_loss"], ref["free_grads"] = one_rank(ccfg, M * n_sh)
            ref["global_loss"], g_glob = one_rank(ccfg, M)
            ref["global_rel"] = group_rel_errs(g_glob, ref["grads"])
            del g_glob
        if on_card:
            torch.cuda.empty_cache()

    ref_s, t3 = time.perf_counter() - t2, time.perf_counter()
    # the references' pieces scattered from rank 0 leaf by leaf; each rank
    # sums its pieces' squared differences per leaf group (a piece that
    # several ranks hold counted on one of them), then over the mesh: row i
    # for comps[i], then each reference's own sum of squares
    with S.use_mesh(mesh):
        specs = S.param_pspec_tree(Model(cfg, device="meta"))
    groups = sorted(leaf_groups(specs))
    group_of = {n: g for g, names in leaf_groups(specs).items()
                for n in names}
    keys = list(dict.fromkeys(key for _, key in comps))
    sums = torch.zeros((len(comps) + len(keys), len(groups)),
                       dtype=torch.float64, device=dev)
    for name in specs:
        got = {c: mine_grads[c][name] for c, _ in comps}
        owner = all(mesh.coords[a] == 0 for a in mesh.axis_names
                    if a not in S.spec_axes(specs[name]))
        g = groups.index(group_of[name])
        for k, key in enumerate(keys):
            parts = ([S.local_slice(ref[key][name], specs[name],
                                    dataclasses.replace(mesh, rank=r))
                      for r in mesh.ranks] if rank0 else None)
            like = next(got[c] for c, kk in comps if kk == key)
            piece = C.scatter(parts, like, mesh, mesh.ranks[0]).double()
            del parts
            if owner:
                sums[len(comps) + k, g] += piece.square().sum()
                for i, (c, kk) in enumerate(comps):
                    if kk == key:
                        sums[i, g] += (got[c].double() - piece).square().sum()
            del piece
        del got
        for d in {id(v): v for v in mine_grads.values()}.values():
            del d[name]
    sums = C.all_reduce(sums, mesh, None).cpu()
    compare_s = time.perf_counter() - t3
    if not rank0:
        return {}
    rel = {c: {g: (float(sums[i, j]) / float(sums[n, j])) ** 0.5
               if float(sums[n, j]) > 0 else float(float(sums[i, j]) > 0)
               for j, g in enumerate(groups)}
           for i, (c, key) in enumerate(comps)
           for n in (len(comps) + keys.index(key),)}
    shape = ShapeConfig("train_sharded", Sq, B, "train", microbatches=M)
    _, info = lower_cell(cfg.name, shape.name, S.Mesh(mesh.axis_names,
                                                      mesh.axis_sizes),
                         cfg=cfg, shape=shape, sharding_mode="2d",
                         zero_stage=2, trace=False)
    return {"arch": cfg.name, "layers": cfg.n_layers, "B": B, "S": Sq,
            "microbatches": M, "transport": world["transport"],
            "mesh": mesh.shape, "ranks": ranks, "check_dtype": ccfg.dtype,
            "loss_ref": ref["loss"], "rel": rel["main"],
            "rel_control": rel["control"],
            "global_loss": ref.get("global_loss"),
            "global_rel": ref.get("global_rel"),
            "free_loss": ref.get("free_loss"), "rel_free": rel.get("free"),
            "routing": ref.get("routing"),
            "loss_ref_bf16": ref.get("loss_bf16"),
            "rel_bf16": rel.get("bf16"),
            "rel_bf16_vs_f32": rel.get("bf16_vs_f32"),
            "floor_bf16": ref.get("floor_bf16"),
            "predicted_bytes": info["per_device_bytes"],
            "seconds": {"main": wall, "control": mine["control_s"],
                        "one_rank": ref_s, "compare": compare_s}}


def sharded_rank(out: str, smoke: bool) -> int:
    """A rank of the train-sharded phase (`chip_smoke.py --rank-of
    train-sharded DIR full|smoke`, started by `phase_train_sharded` with
    RANK, WORLD_SIZE, LOCAL_RANK set): joins the world over a file://
    store in DIR, runs `sharded_arch` for each of SHARDED_ARCHS, and rank
    0 writes DIR/result.json. The kernels are built by the parent; a rank
    only loads them."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import collectives as C
    marks = {"import torch": time.perf_counter() - t0}
    import torch._dynamo  # noqa: F401  (the recompute's first call needs it)
    marks["import torch._dynamo"] = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if smoke:
        torch.set_num_threads(1)
    world = C.init_world("cpu" if smoke else "cuda",
                         init_method=f"file://{out}/store")
    try:
        mesh = make_debug_mesh()
        marks["world joined, mesh bound"] = time.perf_counter() - t0
        res = {arch: sharded_arch(arch, smoke, world, mesh)
               for arch in SHARDED_ARCHS}
        marks["done"] = time.perf_counter() - t0
        if world["rank"] == 0:
            res["marks"] = marks
            (Path(out) / "result.json").write_text(json.dumps(res,
                                                              default=str))
    finally:
        C.leave_world()
    return 0


def phase_train_sharded(dev, detail, smoke=False, kernel_rows=None):
    """Training sharded over a (data 2, model 2) mesh of SHARDED_RANKS
    ranks on the one card (gloo; NCCL refuses two ranks on one device, so
    CUDA tensors are staged through pinned host buffers), each a process
    of its own started here after the kernels are built: the six families
    at full width cut to SHARDED_LAYERS blocks (qwen2.5-3b, GQA 16 / 2;
    granite-moe-3b-a800m, GQA 24 / 8, 40 experts top 8; musicgen-medium,
    24 heads, 4 codebooks; phi-3-vision-4.2b, 32 heads of 96 over 256
    patches and the tokens; zamba2-7b, 112 SSD heads and the shared
    block's 32 heads of 112 windowed; xlstm-1.3b, 4 mLSTM heads of 512 and
    sLSTM's 2048 channels), one step of SHARDED_B x SHARDED_S tokens in
    SHARDED_MICRO microbatches at cfg.dtype through `launch.train.train`
    (fsdp x tp masters, the ZeRO-2 compute copy, each family's layers on
    the rank's heads or channels, vocabulary-parallel embeddings and
    cross-entropy, the per-shard MoE dispatch), held to the same step on
    one rank: the first loss within SHARDED_LOSS_REL, the gradients within
    GRAD_REL_TOL per leaf group, and beyond it with the control's
    model-axis sum left out (`sharded_control`). For SHARDED_CHECK_F32's
    families the gradients are held at float32, and the bf16 main path
    too: its first loss against the one-rank bf16 run's within
    SHARDED_LOSS_REL, and for SHARDED_BF16_GRADS' per leaf group its
    gradients no farther from the one-rank float32 run's than the one-rank
    bf16 run's are, plus GRAD_REL_TOL, the control beyond that
    (`sharded_arch`). For granite-moe the one-rank reference
    is the per-shard dispatch routed as the shards routed: the shards'
    router scores must be the reference's on the same rows within
    SHARDED_SCORE_REL, and each replayed choice the reference's own top_k
    on its own inputs but where the two runs' scores reorder it
    (`routing_gap`); the gaps of the per-shard dispatch on its own routing
    and of the global dispatch are printed beside it. Each rank's flash,
    SSD and pair launches must number `sharded_expected`'s and run on its
    own heads (SHARDED_HEADS), with no plain attention or scan call.
    `kernel_rows` are each of those kernels at the rank shapes against its
    plain version (`phase_sharded_kernels`, which runs first where they
    are not given), with its ms, the plain version's, the bound and
    SDPA's. Printed: whether a profile here records device events before
    and after the ranks ran, each rank's peak beside `lower_cell`'s
    per-device prediction, the bytes each collective moved, the
    transport, the seconds. `smoke` rehearses it on the CPU at
    `smoke_config` (gloo, no kernels)."""
    import tempfile
    t0 = time.perf_counter()
    faults, seen = [], {}
    if not smoke:
        if kernel_rows is None:
            kernel_rows = phase_sharded_kernels(dev, detail)
        seen["before the ranks"] = profile_sees_device(dev)
    t1 = time.perf_counter()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   WORLD_SIZE=str(SHARDED_RANKS),
                   LOCAL_WORLD_SIZE=str(SHARDED_RANKS))
        logs = [open(Path(tmp) / f"rank{r}.log", "w+")
                for r in range(SHARDED_RANKS)]
        try:
            for r in range(SHARDED_RANKS):
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--rank-of", "train-sharded", tmp,
                     "smoke" if smoke else "full"], cwd=ROOT,
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=logs[r], stderr=subprocess.STDOUT, text=True))
            while any(p.poll() is None for p in procs):
                failed = any(p.poll() not in (None, 0) for p in procs)
                if failed or time.perf_counter() - t1 > SHARDED_TIMEOUT_S:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        tails = []
        for r, log in enumerate(logs):
            log.seek(0)
            tails.append(log.read().strip().splitlines())
            log.close()
        rcs = [p.returncode for p in procs]
        result = Path(tmp) / "result.json"
        res = json.loads(result.read_text()) if result.exists() else None
    print("\n".join(f"  {ln}" for ln in tails[0][-40:]))
    if rcs != [0] * SHARDED_RANKS or res is None:
        for r, t in enumerate(tails):
            print(f"  rank {r} (rc {rcs[r]}): " + " | ".join(t[-12:]))
        raise AssertionError(f"the ranks failed: {rcs}")
    if not smoke:
        seen["after the ranks"] = profile_sees_device(dev)
        print("  a profile here records device events: " + ", ".join(
            f"{k} {v}" for k, v in seen.items()))
    counts = dict.fromkeys(("flash_attention", "flash_attention_bwd",
                            "ssd_scan", "ssd_scan_bwd", "mlstm_scan",
                            "mlstm_scan_bwd"), 0)
    marks = res.pop("marks")
    print("  rank 0 from its start: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in marks.items()))
    for arch, r in res.items():
        worst = max(r["rel"], key=r["rel"].get)
        worst_c = max(r["rel_control"], key=r["rel_control"].get)
        loss = r["ranks"][0].get("check_loss", r["ranks"][0]["loss"])
        rel_loss = abs(loss - r["loss_ref"]) / abs(r["loss_ref"])
        mem = r["predicted_bytes"]
        print(f"  {r['arch']}: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in r["seconds"].items()))
        print(f"  {r['arch']} ({r['layers']} blocks) on {r['mesh']} over "
              f"{r['transport']}: loss {r['ranks'][0]['loss']:.6f}"
              + (f" (the check's, at {r['check_dtype']}: "
                 f"{r['ranks'][0]['check_loss']:.6f})"
                 if "check_loss" in r["ranks"][0] else "")
              + f", one rank {r['loss_ref']:.6f} (rel {rel_loss:.2e}, "
              f"limit {SHARDED_LOSS_REL}); gradients at "
              f"{r['check_dtype']}: worst group "
              f"{r['rel'][worst]:.2e} ({worst}; limit {GRAD_REL_TOL}); "
              f"control (a model-axis sum left out): loss "
              f"{r['ranks'][0]['control_loss']:.6f}, worst group "
              f"{r['rel_control'][worst_c]:.2e} ({worst_c})")
        if r["loss_ref_bf16"] is not None:      # the bf16 main path, held
            loss16 = r["ranks"][0]["loss"]
            rel16 = abs(loss16 - r["loss_ref_bf16"]) / abs(r["loss_ref_bf16"])
            floor = r["floor_bf16"]
            # how much farther from the float32 gradients than one rank's
            # bf16 run: the main path's, and the control's
            gap = {g: r["rel_bf16_vs_f32"][g] - floor[g] for g in floor}
            gap_c = {g: r["rel_control"][g] - floor[g] for g in floor}
            wg, wc = max(gap, key=gap.get), max(gap_c, key=gap_c.get)
            w16 = max(r["rel_bf16"], key=r["rel_bf16"].get)
            print(f"    the bf16 main path: loss {loss16:.6f}, one rank's "
                  f"bf16 {r['loss_ref_bf16']:.6f} (rel {rel16:.2e}, limit "
                  f"{SHARDED_LOSS_REL}); gradients against one rank's "
                  f"float32, beyond one rank's bf16: worst "
                  f"{gap[wg]:.2e} ({wg}: {r['rel_bf16_vs_f32'][wg]:.2e} "
                  f"against {floor[wg]:.2e}; "
                  + (f"limit {GRAD_REL_TOL}" if arch in SHARDED_BF16_GRADS
                     else "printed, not held")
                  + "), the "
                  + f"control's {gap_c[wc]:.2e} ({wc}); against one rank's "
                  f"bf16: worst {r['rel_bf16'][w16]:.2e} ({w16})")
            print("    per leaf group, main bf16 against one rank's bf16 / "
                  "against one rank's float32 / one rank's bf16 against "
                  "its float32 / the float32 check: " + "; ".join(
                      f"{g} {r['rel_bf16'][g]:.2e} "
                      f"{r['rel_bf16_vs_f32'][g]:.2e} {floor[g]:.2e} "
                      f"{r['rel'][g]:.2e}" for g in sorted(floor)))
            if not rel16 <= SHARDED_LOSS_REL:
                faults.append(f"{arch}: the bf16 loss off one rank's by "
                              f"{rel16:.3g}")
            if arch in SHARDED_BF16_GRADS and not gap[wg] <= GRAD_REL_TOL:
                faults.append(f"{arch}: bf16 gradients farther from float32 "
                              f"than one rank's in {wg} by {gap[wg]:.3g}")
            if arch in SHARDED_BF16_GRADS and gap_c[wc] <= GRAD_REL_TOL:
                faults.append(f"{arch}: the bf16 check passes the control")
        if r["global_loss"] is not None:
            wg = max(r["global_rel"], key=r["global_rel"].get)
            wf = max(r["rel_free"], key=r["rel_free"].get)
            rt = r["routing"]
            print(f"    the shards' routing against the one-rank "
                  f"reference's own on its own inputs: router scores "
                  f"within {rt['score_rel']:.2e} (worst call; limit "
                  f"{SHARDED_SCORE_REL}); {rt['differ']} of {rt['rows']} "
                  f"rows of {rt['calls']} decisions choose otherwise, "
                  f"{rt['beyond']} of them beyond what the two runs' scores "
                  f"reorder (largest excess {rt['gap_spacings']:.2f} bf16 "
                  f"spacings; limit {MOE_TIE_SPACINGS}); per shard on its "
                  f"own routing (not pinned): loss {r['free_loss']:.6f}, "
                  f"worst group {r['rel_free'][wf]:.2e} ({wf})")
            print(f"    the global dispatch on one rank, against the "
                  f"per-shard one: loss {r['global_loss']:.6f}, worst "
                  f"group {r['global_rel'][wg]:.2e} ({wg}); dropped "
                  f"choices per shard, layer by layer: "
                  + "; ".join(f"shard {k['coords']['data']}: {k['dropped']}"
                              for k in r["ranks"]
                              if k["coords"]["model"] == 0))
            if rt["beyond"] or not rt["score_rel"] <= SHARDED_SCORE_REL:
                faults.append(f"{arch}: the shards' routing: scores off by "
                              f"{rt['score_rel']:.3g}, {rt['beyond']} "
                              f"choices beyond what the scores reorder")
        print(f"    predicted per device (lower_cell, 2d, ZeRO-2): "
              f"{mem['total'] / 1e9:.2f} GB ("
              + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in mem.items()
                          if k != "total") + ")")
        for k in r["ranks"]:
            print(f"    rank {k['rank']} {k['coords']}: step "
                  f"{k['step_s']:.2f} s ({k['train_s']:.2f} s with set-up)"
                  f", peak "
                  + (f"{k['peak_gb']:.2f} GB" if k["peak_gb"] is not None
                     else "n/a")
                  + f"; launches {k['launches']}; heads {k['heads']}"
                  f"; bytes received "
                  + ", ".join(f"{op} {t['bytes'] / 1e6:.1f} MB in "
                              f"{t['calls']} ({t['s']:.2f} s)" for op, t in
                              sorted(k["traffic"].items()))
                  + "; step parts " + ", ".join(
                      f"{n} {v:.2f} s" for n, v in k["parts_s"].items()))
        if not rel_loss <= SHARDED_LOSS_REL:
            faults.append(f"{arch}: loss off the one-rank run's by "
                          f"{rel_loss:.3g}")
        if not r["rel"][worst] <= GRAD_REL_TOL:
            faults.append(f"{arch}: gradients off in {worst}: "
                          f"{r['rel'][worst]:.3g}")
        if r["rel_control"][worst_c] <= GRAD_REL_TOL:
            faults.append(f"{arch}: the check passes the control")
        want, want_heads = sharded_expected(sharded_cell(arch, smoke)[0],
                                            arch)
        for k in r["ranks"]:
            if not smoke and (
                    k["plain"]["attention"] or k["plain"]["ssd"]
                    or k["launches"] != want or k["heads"] != want_heads):
                faults.append(f"{arch} rank {k['rank']}: launches "
                              f"{k['launches']} (want {want}), heads "
                              f"{k['heads']} (want {want_heads}), plain "
                              f"{k['plain']}")
            for name in counts:
                counts[name] += k["launches"].get(name, 0)
    wall = time.perf_counter() - t0
    print(f"  the phase: {wall:.1f} s")
    detail["train_sharded"] = {"archs": res, "seconds": wall,
                               "rank0_marks": marks, "launches": counts,
                               "kernels_at_rank_shapes": kernel_rows,
                               "profile_sees_device": seen}
    if faults:
        raise AssertionError("; ".join(faults))
    return counts


# ------------------------------------------------------------------- main

def build_kernels() -> float:
    """Build the eight CUDA libraries (one nvcc per source, all started
    together), load them, and print the build's seconds and ptxas's
    register counts; returns the seconds."""
    from repro_torch.kernels import (build, flash_attention, grin_moves,
                                     rmsnorm, ssd_scan, ssd_scan_bwd,
                                     ssd_scan_wide)
    t0 = time.perf_counter()
    model_flags = build.MODEL_NVCC_FLAGS
    mods = {"grin_moves": (grin_moves.SOURCES, build.NVCC_FLAGS,
                           grin_moves._kernel_lib),
            "flash_attention": (flash_attention.SOURCES, model_flags,
                                flash_attention._kernel_lib),
            "flash_attention_bwd": (flash_attention.BWD_SOURCES, model_flags,
                                    flash_attention._bwd_kernel_lib),
            "ssd_scan": (ssd_scan.SOURCES, model_flags, ssd_scan._kernel_lib),
            "ssd_scan_wide": (ssd_scan_wide.SOURCES, model_flags,
                              ssd_scan_wide._kernel_lib),
            "ssd_scan_bwd": (ssd_scan_bwd.SOURCES, model_flags,
                             ssd_scan_bwd._kernel_lib),
            "ssd_scan_wide_bwd": (ssd_scan_bwd.WIDE_SOURCES, model_flags,
                                  ssd_scan_bwd._wide_kernel_lib),
            "rmsnorm": (rmsnorm.SOURCES, model_flags, rmsnorm._kernel_lib)}
    handles = {name: build.start_build(name, sources, flags)
               for name, (sources, flags, _) in mods.items()}
    for name, h in handles.items():     # one nvcc per source, in parallel
        build.finish_build(name, h)
    for _, _, load in mods.values():
        load()
    t_build = time.perf_counter() - t0
    print(f"build: {t_build:.1f} s "
          f"{ {n: round(b['seconds'], 1) for n, b in build.build_log.items()} }")
    for name in mods:
        used = [ln.split("info    : ")[-1] for ln in
                build.build_log[name]["ptxas"].splitlines() if "Used" in ln]
        print(f"  {name}: {'; '.join(sorted(set(used)))[:400]}")
    return t_build


def main() -> int:
    if sys.argv[1:3] == ["--rank-of", "train-sharded"]:
        return sharded_rank(sys.argv[3], sys.argv[4] == "smoke")
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
    t_build = build_kernels()

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
    sharded_rows = run("sharded-kernels", phase_sharded_kernels, dev, detail)
    # host event-core oracles run in a pool of host processes (spawned:
    # they import torch afresh and never touch the card), closed below
    pool = multiprocessing.get_context("spawn").Pool(
        min(8, os.cpu_count() or 1))
    reset_all_launches()                # the scheduling path's count starts
    per_phase, solve_entry, grids = {}, None, {}
    try:
        for name, fn, args in (
                ("solver", phase_solver, (dev, [(16, 16, 1), (64, 64, 2)],
                                          64, detail)),
                ("scheduler", phase_scheduler, (dev, 16, 4096, detail)),
                ("engine", phase_engine, (dev, 2, [0, 1, 2], 4000, 800,
                                          detail, pool)),
                ("priority", phase_priority, (dev, 64, 64, detail, pool)),
                ("traffic", phase_traffic, (dev, detail, pool)),
                ("faults", phase_faults, (dev, detail, pool)),
                ("closed-faults", phase_closed_faults, (dev, detail, pool)),
                ("hazard", phase_hazard, (dev, detail, pool)),
                ("autoscale", phase_autoscale, (dev, detail))):
            before = dict(grin_moves.launches)
            res = run(name, fn, *args)
            if name == "solver":
                solve_entry = res
            if isinstance(res, dict) and "grids" in res:
                grids[name] = res["grids"]
            per_phase[name] = {k: grin_moves.launches[k] - before[k]
                               for k in before}
    finally:
        pool.terminate()
        pool.join()
    launches = dict(grin_moves.launches)
    print(f"launches on the scheduling path: {launches} {per_phase}")
    # every grid solve is one fused launch: the per-step scorer kernel is
    # off the path (held against its plain version in the kernel phase);
    # the traffic phase's targets are host solves (no kernel on its path);
    # the fault and hazard phases make one launch per segment grid, the
    # autoscale phase one per governor epoch
    if any(per_phase[p]["grin_solve"] <= 0 for p in per_phase
           if p != "traffic") \
            or launches["block_move_gains"] != 0 \
            or per_phase["traffic"]["grin_solve"] != 0 \
            or any(per_phase[p]["grin_solve"] != n
                   for p, n in grids.items()):
        failed.append("launches")
    detail["launches"] = {"total": launches, **per_phase}

    state = {}                          # the serving engine, shared
    serve_launches = run("serve", phase_serve, dev, state, detail)
    run("serve-sched", phase_serve_sched, dev, state, detail)
    run("serve-traffic", phase_serve_traffic, dev, state, detail)
    state.clear()
    torch.cuda.empty_cache()
    xlstm_launches = run("serve-xlstm", phase_serve_xlstm, dev, detail)
    torch.cuda.empty_cache()
    family_launches = {}
    for name, fn in (("serve-moe", phase_serve_moe),
                     ("serve-audio", phase_serve_audio),
                     ("serve-vlm", phase_serve_vlm)):
        family_launches[name] = run(name, fn, dev, detail)
        torch.cuda.empty_cache()        # each engine is freed before the next
    rms_launches = run("ops-rmsnorm", phase_ops_rmsnorm, dev, detail)
    torch.cuda.empty_cache()
    train_counts = run("train", phase_train, dev, detail)
    torch.cuda.empty_cache()
    hybrid_counts = run("train-hybrid", phase_train_hybrid, dev, detail)
    torch.cuda.empty_cache()
    ssm_counts = run("train-ssm", phase_train_ssm, dev, detail)
    torch.cuda.empty_cache()
    moe_counts = run("train-moe", phase_train_moe, dev, detail)
    torch.cuda.empty_cache()
    # the ranks are processes of their own on the card: nothing of the
    # earlier phases' is kept here but the built kernels
    sharded_counts = run("train-sharded", phase_train_sharded, dev, detail,
                         False, sharded_rows)
    dry = run("dryrun", phase_dryrun, dev, detail)
    examples = run("examples", phase_examples, dev, detail)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_detail.json").write_text(
        json.dumps(detail, indent=1, default=str))
    if failed or entry is None or model_entries is None \
            or solve_entry is None or serve_launches is None \
            or xlstm_launches is None or rms_launches is None \
            or train_counts is None or hybrid_counts is None \
            or ssm_counts is None or moe_counts is None or dry is None \
            or sharded_counts is None \
            or examples is None or None in family_launches.values():
        _fail(f"phases failed: {failed}")
    entry["launches"] = launches["block_move_gains"]
    solve_entry["launches"] = launches["grin_solve"]
    flash_by_phase = {"serve": serve_launches["flash_attention"], **{
        name: n["flash_attention"] for name, n in family_launches.items()},
        "train": train_counts["flash_attention"],
        "train-hybrid": hybrid_counts["flash_attention"],
        "train-moe": moe_counts["flash_attention"],
        "train-sharded": sharded_counts["flash_attention"]}
    by_phase = {
        "flash_attention": flash_by_phase,
        "flash_attention_bwd": {
            "train": train_counts["flash_attention_bwd"],
            "train-hybrid": hybrid_counts["flash_attention_bwd"],
            "train-moe": moe_counts["flash_attention_bwd"],
            "train-sharded": sharded_counts["flash_attention_bwd"]},
        "ssd_scan": {"serve": serve_launches["ssd_scan"],
                     "train-hybrid": hybrid_counts["ssd_scan"],
                     "train-sharded": sharded_counts["ssd_scan"]},
        "ssd_scan_wide": {"serve-xlstm": xlstm_launches["ssd_scan_wide"]},
        "mlstm_scan": {"serve-xlstm": xlstm_launches["mlstm_scan"],
                       "train-ssm": ssm_counts["mlstm_scan"],
                       "train-sharded": sharded_counts["mlstm_scan"]},
        "ssd_scan_bwd": {"train-hybrid": hybrid_counts["ssd_scan_bwd"],
                         "train-sharded": sharded_counts["ssd_scan_bwd"]},
        "mlstm_scan_bwd": {"train-ssm": ssm_counts["mlstm_scan_bwd"],
                           "train-sharded": sharded_counts[
                               "mlstm_scan_bwd"]}}
    for name, counts in by_phase.items():
        model_entries[name]["launches"] = sum(counts.values())
        model_entries[name]["launches_by_phase"] = counts
    for name, counts in (("flash_attention_bwd", train_counts),
                         ("ssd_scan_bwd", hybrid_counts),
                         ("mlstm_scan_bwd", ssm_counts)):
        model_entries[name]["launches_per_train_step"] = \
            counts["per_step"][name]
    model_entries["rmsnorm"]["launches"] = rms_launches
    print(json.dumps({"kernels": [entry, solve_entry,
                                  *model_entries.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
