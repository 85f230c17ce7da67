#!/usr/bin/env python3
"""What the embedding lookup's fixed-order backward costs a training step,
on one NVIDIA GPU:

    python3 tools/embedding_backward_time.py [--arch qwen2.5-3b] [--reps 10]

Takes `--arch`'s token table at full width (random bf16, (V, d_model)) and
one microbatch of the train phases' data (1 x 4096 tokens of the Zipfian
corpus, step 0), and times the lookup's forward and backward (the
gradient of the rows against a random cotangent) by two routes,
alternated `--reps` times with CUDA events: `layers.embedding_rows` (each
row's gradients summed in float32 in a fixed order) and plain indexing
(autograd's index backward, bf16 adds one by one). Prints each route's
median ms, their difference, and that difference times the train phases'
microbatches a step (chip_smoke.TRAIN_MICRO). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.train.data import DataConfig, batch_for_step
    if not torch.cuda.is_available():
        print("embedding_backward_time: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = get_arch(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                     device=dev) * 0.02).bfloat16().requires_grad_()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=4096, global_batch=1)
    tok = torch.from_numpy(batch_for_step(dc, 0)["tokens"]).to(dev)
    g = torch.randn((*tok.shape, cfg.d_model), generator=gen,
                    device=dev).bfloat16()
    routes = {"embedding_rows": L.embedding_rows,
              "index": lambda w_, t: w_[t]}

    def once(fn) -> float:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        torch.autograd.grad(fn(w, tok), w, g)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    for fn in routes.values():               # warm up
        for _ in range(3):
            once(fn)
    times = {n: [] for n in routes}
    for _ in range(args.reps):
        for n, fn in routes.items():
            times[n].append(once(fn))
    med = {n: statistics.median(t) for n, t in times.items()}
    distinct = int(torch.unique(tok).numel())
    print(f"{cfg.name}: table {cfg.vocab_size} x {cfg.d_model} bf16, "
          f"{tok.numel()} tokens ({distinct} distinct), forward + backward "
          f"median of {args.reps}: "
          + ", ".join(f"{n} {m:.4f} ms" for n, m in med.items())
          + f"; difference {med['embedding_rows'] - med['index']:.4f} ms "
          f"a microbatch, "
          f"{cs.TRAIN_MICRO * (med['embedding_rows'] - med['index']):.4f} "
          f"ms a step of {cs.TRAIN_MICRO} microbatches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
