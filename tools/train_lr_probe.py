#!/usr/bin/env python3
"""The train phase's losses at other learning rates, on an NVIDIA GPU:

    python3 tools/train_lr_probe.py [--lrs 1e-5 2e-6 5e-7] [--warmup 1]
        [--steps 6] [--arch qwen2.5-3b] [--layers N]

Trains `--arch` (qwen2.5-3b by default; zamba2-7b with `--layers 27` and
xlstm-1.3b are the train-hybrid and train-ssm phases' models) at full
width through `launch.train.train` as `chip_smoke.py`'s train phases do
(the same batch, sequence,
microbatches, seed and data), once per learning rate (warmup `--warmup`
steps, cosine decay over the run), and prints each run's losses, gradient
norms and peak memory. Shows how the smoke's TRAIN_LR was chosen: from a
random initialisation on the synthetic Zipfian corpus, every AdamW step
moves each parameter by about the learning rate, and too large a rate
overshoots after the first step. Writes `chiprun_out/train_lr_probe.json`.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", type=float, nargs="+",
                    default=[1e-5, 2e-6, 5e-7])
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    import tempfile

    import torch
    import chip_smoke as cs
    from repro_torch.launch import train as T
    from repro_torch.train.optimizer import OptimizerConfig
    if not torch.cuda.is_available():
        print("train_lr_probe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    steps = args.steps or cs.TRAIN_STEPS
    out = {}
    for lr in args.lrs:
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as d:
            res = T.train(args.arch or cs.TRAIN_ARCH, steps=steps,
                          batch=cs.TRAIN_B, seq=cs.TRAIN_S,
                          microbatches=cs.TRAIN_MICRO, smoke=False,
                          layers=args.layers, ckpt_dir=d, ckpt_every=steps + 1,
                          device="cuda", opt=OptimizerConfig(
                              lr=lr, warmup_steps=args.warmup,
                              decay_steps=steps),
                          log=lambda *a: None)
        row = {"losses": [h["loss"] for h in res["history"]],
               "grad_norms": [h["grad_norm"] for h in res["history"]],
               "s": [h["s"] for h in res["history"]],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        out[f"lr {lr:g} warmup {args.warmup}"] = row
        print(f"lr {lr:g} (warmup {args.warmup}): losses "
              f"{[round(x, 4) for x in row['losses']]} grad norms "
              f"{[round(x, 2) for x in row['grad_norms']]} s "
              f"{[round(x, 2) for x in row['s']]} peak "
              f"{row['peak_gb']:.2f} GB", flush=True)
        del res
        torch.cuda.empty_cache()
    path = ROOT / "chiprun_out"
    path.mkdir(exist_ok=True)
    (path / "train_lr_probe.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
