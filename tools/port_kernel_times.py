#!/usr/bin/env python3
"""Time the port's flash-attention and SSD-scan kernels, its GrIn grid
solve and zamba2-7b prefill from any checkout of the repository, on chip_smoke.py's inputs and
with its timer, so that two versions can be compared in one run on one
NVIDIA GPU:

    python3 tools/port_kernel_times.py --root OLD_CHECKOUT
    python3 tools/port_kernel_times.py --root .

It imports `repro_torch` from ROOT/src (building that tree's kernels) and
this tree's `chip_smoke.py` for the shapes, seeds, input makers and
`cuda_ms`, and calls only entry points every version of the port has:
`kernels.flash_attention.flash_attention_cuda` on the smoke's serving
call (B = 4, S = 8192, H = KV = 32, dh = 112, window 4096) and its causal
B = 1 case, `kernels.ssd_scan.ssd_scan_cuda` on the smoke's serving-shape
SSD inputs,
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


def measure(sm, dev, reps):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.model import Model
    from repro_torch.sched import solve_targets_grid_torch
    from repro_torch.serve.engine import ServeEngine
    flash = {}
    for name, b, win in (("window_b4", sm.SERVE_B, 4096), ("causal_b1", 1, 0)):
        q, k, v = sm._attn_inputs(dev, 100, b, sm.SERVE_S, 32, 32, 112)
        flash[name] = sm.cuda_ms(lambda: FA.flash_attention_cuda(
            q, k, v, window=win), iters=10 * reps)
        del q, k, v
    q, k, v, la, beta = sm.ssd_inputs(dev, 200, sm.SERVE_B, sm.SERVE_S, 112,
                                      64)
    ssd = sm.cuda_ms(lambda: SSD.ssd_scan_cuda(q, k, v, la, beta,
                                               chunk=256), iters=10 * reps)
    del q, k, v, la, beta
    mus, mixes = sm.skewed_grid(GRID[2], GRID[0], GRID[1], sm.K, sm.L,
                                sm.N_TASKS)
    solve_targets_grid_torch(mus[:1], mixes[:2], device=dev)

    def grid():
        if not solve_targets_grid_torch(mus, mixes, device=dev)[2].all():
            raise AssertionError("a grid point did not converge")
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
    return {"flash_window_b4_ms": flash["window_b4"],
            "flash_causal_b1_ms": flash["causal_b1"], "ssd_ms": ssd,
            "grid_64x64_max_x_s": _wall(grid, reps),
            "prefill_s": _wall(prefill, reps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
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
           **measure(sm, torch.device("cuda"), args.reps)}
    res["grid_solves_per_s"] = GRID[0] * GRID[1] / min(
        res["grid_64x64_max_x_s"])
    res["prefill_tok_per_s"] = sm.SERVE_B * sm.SERVE_S / min(res["prefill_s"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
