#!/usr/bin/env python3
"""Time the port's flash-attention kernels (forward and backward) and
SSD-scan kernel, its GrIn grid solve and zamba2-7b prefill from any
checkout of the repository, on chip_smoke.py's inputs and with its timer,
so that two versions can be compared in one run on one NVIDIA GPU:

    python3 tools/port_kernel_times.py --root OLD_CHECKOUT
    python3 tools/port_kernel_times.py --root . [--parts bwd flash]
    python3 tools/port_kernel_times.py --parts bwd_sdpa --reps 10

It imports `repro_torch` from ROOT/src (building that tree's kernels) and
this tree's `chip_smoke.py` for the shapes, seeds, input makers and
`cuda_ms`, and calls only entry points every version of the port has:
`kernels.flash_attention.flash_attention_cuda` on the smoke's serving
call (B = 4, S = 8192, H = KV = 32, dh = 112, window 4096) and its causal
B = 1 case (the time between CUDA events, and the kernel's own device
time under `torch.profiler` as `*_device_ms`), `flash_attention_bwd_cuda` at each of the smoke's BWD_SHAPES
(inputs as `chip_smoke.measure_flash_bwd` makes them; checkouts since the
backward kernel), with `bwd_sdpa` that backward and SDPA's backward
(`chip_smoke.sdpa_bwd_call`) alternately on the same inputs, `--reps`
readings each in the order kernel, SDPA, SDPA, kernel, ...,
`kernels.ssd_scan.ssd_scan_cuda` on the smoke's serving-shape SSD inputs,
with `scan_bwd` the scans' backward kernels (`ssd_scan_bwd_cuda`,
`mlstm_scan_bwd_cuda`; checkouts since those kernels) at the smoke's
training shapes and inputs (`chip_smoke.ssd_bwd_inputs`), with each
launch's device ms from `torch.profiler`,
`sched.solve_targets_grid_torch` on the smoke's 64 x 64 max-x grid, and
`ServeEngine.prefill` of the smoke's model and prompts. Prints the card's
name and power limit, then one JSON line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
GRID = (64, 64, 2)          # chip_smoke.py's larger solver grid


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wall(fn, reps):
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


PARTS = ("flash", "bwd", "bwd_sdpa", "ssd", "scan_bwd", "grid", "prefill")


def _bwd_inputs(sm, dev, i):
    """The smoke's backward inputs at BWD_SHAPES[i]: q, k, v, o, lse, do
    and the window."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    b, s, h, kv, dh, win = sm.BWD_SHAPES[i]
    q, k, v = sm._attn_inputs(dev, 500 + i, b, s, h, kv, dh)
    g = torch.Generator(device=dev).manual_seed(501 + i)
    do = torch.randn((b, s, h, dh), dtype=torch.bfloat16, device=dev,
                     generator=g)
    o, lse = FA.flash_attention_cuda(q, k, v, window=win, return_lse=True)
    return (q, k, v, o, lse, do), win


def _shape_key(b, s, h, kv, dh, win):
    return f"{b}x{s}x{h}/{kv}x{dh}w{win}"


def measure_bwd(sm, dev, reps):
    """{shape: ms} of the backward at each of the smoke's BWD_SHAPES."""
    from repro_torch.kernels import flash_attention as FA
    out = {}
    for i, shape in enumerate(sm.BWD_SHAPES):
        args, win = _bwd_inputs(sm, dev, i)
        out[_shape_key(*shape)] = sm.cuda_ms(
            lambda: FA.flash_attention_bwd_cuda(*args, window=win),
            iters=10 * reps, warmup=2)
        del args
    return out


def measure_bwd_sdpa(sm, dev, reps):
    """{shape: {"kernel": [ms, ...], "sdpa": [ms, ...]}}: the backward
    kernel and SDPA's backward at each of the smoke's BWD_SHAPES on the
    same inputs, `reps` readings of 10 calls each, alternately (kernel,
    SDPA, SDPA, kernel, ...)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    out = {}
    for i, shape in enumerate(sm.BWD_SHAPES):
        args, win = _bwd_inputs(sm, dev, i)
        calls = {"kernel": lambda: FA.flash_attention_bwd_cuda(
                     *args, window=win),
                 "sdpa": sm.sdpa_bwd_call(*args[:3], args[5], win)}
        got = {name: [] for name in calls}
        for r in range(reps):
            for name in (("kernel", "sdpa") if r % 2 == 0
                         else ("sdpa", "kernel")):
                got[name].append(sm.cuda_ms(calls[name], iters=10,
                                            warmup=2))
        out[_shape_key(*shape)] = got
        del args, calls
        torch.cuda.empty_cache()
    return out


def measure(sm, dev, reps, parts=PARTS):
    from repro_torch.kernels import flash_attention as FA
    res = {}
    if "bwd" in parts:
        res["flash_bwd_ms"] = measure_bwd(sm, dev, reps)
    if "bwd_sdpa" in parts:
        res["flash_bwd_and_sdpa_ms"] = measure_bwd_sdpa(sm, dev, reps)
    if "flash" in parts:
        for name, b, win in (("window_b4", sm.SERVE_B, 4096),
                             ("causal_b1", 1, 0)):
            q, k, v = sm._attn_inputs(dev, 100, b, sm.SERVE_S, 32, 32, 112)

            def call():
                return FA.flash_attention_cuda(q, k, v, window=win)
            res[f"flash_{name}_ms"] = sm.cuda_ms(call, iters=10 * reps)
            res[f"flash_{name}_device_ms"] = sm.device_busy(
                lambda: [call() for _ in range(10)],
                cpu=False)["device_s"] * 100
            del q, k, v
    if "ssd" in parts:
        res["ssd_ms"] = measure_ssd(sm, dev, reps)
    if "scan_bwd" in parts:
        res.update(measure_scan_bwd(sm, dev, reps))
    if "grid" in parts:
        res["grid_64x64_max_x_s"] = measure_grid(sm, dev, reps)
        res["grid_solves_per_s"] = GRID[0] * GRID[1] / min(
            res["grid_64x64_max_x_s"])
    if "prefill" in parts:
        res["prefill_s"] = measure_prefill(sm, dev, reps)
        res["prefill_tok_per_s"] = sm.SERVE_B * sm.SERVE_S / min(
            res["prefill_s"])
    return res


def measure_ssd(sm, dev, reps):
    from repro_torch.kernels import ssd_scan as SSD
    q, k, v, la, beta = sm.ssd_inputs(dev, 200, sm.SERVE_B, sm.SERVE_S, 112,
                                      64)
    return sm.cuda_ms(lambda: SSD.ssd_scan_cuda(q, k, v, la, beta,
                                                chunk=256), iters=10 * reps)


def measure_scan_bwd(sm, dev, reps):
    """The SSD backward at zamba2's and the pair's at xlstm's training
    shape: ms between CUDA events, and device ms by kernel name."""
    import torch
    from repro_torch.kernels import ssd_scan_bwd as SB
    out = {}
    for pair, name in ((False, "ssd_bwd"), (True, "mlstm_bwd")):
        b, s, h, dk, dv = ((1, sm.TRAIN_S, sm.XLSTM_H, sm.XLSTM_D,
                            sm.XLSTM_D) if pair else
                           (1, sm.TRAIN_S, 112, 64, 64))
        x = sm.ssd_bwd_inputs(dev, 790 + pair, b, s, h, dk, dv,
                              sm.SLOW_FORGET_BIAS, not pair)
        kern = SB.mlstm_scan_bwd_cuda if pair else SB.ssd_scan_bwd_cuda

        def call():
            return sm.ssd_bwd_call(kern, x, pair, False)
        out[f"{name}_ms"] = [sm.cuda_ms(call, iters=10, warmup=2)
                             for _ in range(reps)]
        top = sm.device_busy(call, cpu=False, top=20)["top"]
        out[f"{name}_launch_ms"] = {
            t["kernel"].split("(")[0].split("::")[-1]: t["device_s"] * 1e3
            for t in top if "ssd_bwd::" in t["kernel"]}
        del x
        torch.cuda.empty_cache()
    return out


def measure_grid(sm, dev, reps):
    from repro_torch.sched import solve_targets_grid_torch
    mus, mixes = sm.skewed_grid(GRID[2], GRID[0], GRID[1], sm.K, sm.L,
                                sm.N_TASKS)
    solve_targets_grid_torch(mus[:1], mixes[:2], device=dev)

    def grid():
        if not solve_targets_grid_torch(mus, mixes, device=dev)[2].all():
            raise AssertionError("a grid point did not converge")
    return _wall(grid, reps)


def measure_prefill(sm, dev, reps):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    cfg = get_arch(sm.SERVE_ARCH)
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, max_len=sm.SERVE_S + 8)
    toks = torch.randint(0, cfg.vocab_size, (sm.SERVE_B, sm.SERVE_S),
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    engine.prefill({"tokens": toks[:1, :256]})

    def prefill():
        if not bool(torch.isfinite(engine.prefill({"tokens": toks})[0])
                    .all()):
            raise AssertionError("prefill logits not finite")
    return _wall(prefill, reps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=PARTS,
                    help="what to time (default: all)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if not (root / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch under {root}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sm = _smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    res = {"root": str(root), "card": card,
           **measure(sm, torch.device("cuda"), args.reps, args.parts)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
