#!/usr/bin/env python3
"""Run some of `chip_smoke.py`'s phases alone on an NVIDIA GPU:

    python3 tools/smoke_phases.py model-kernels serve-moe serve-audio \\
        serve-vlm

Builds the kernels as the smoke does (`chip_smoke.build_kernels`), then
runs each named phase in order with the smoke's own function, constants
and checks, and prints the card's name and power limit, each phase's
output, verdict and seconds. The phases that need no shared engine or
process pool can be named: model-kernels, serve-xlstm, serve-moe,
serve-audio, serve-vlm, ops-rmsnorm, train, train-hybrid, train-ssm,
train-moe, train-sharded (its ranks are processes of their own, each
loading the kernels built here), dryrun (after the train phases it
reads), examples.
Details go to `chiprun_out/smoke_phases_detail.json`. Exits 1 if a phase
fails. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PHASES = {"model-kernels": "phase_model_kernels",
          "serve-xlstm": "phase_serve_xlstm", "serve-moe": "phase_serve_moe",
          "serve-audio": "phase_serve_audio", "serve-vlm": "phase_serve_vlm",
          "ops-rmsnorm": "phase_ops_rmsnorm", "train": "phase_train",
          "train-hybrid": "phase_train_hybrid", "train-ssm": "phase_train_ssm",
          "train-moe": "phase_train_moe",
          "train-sharded": "phase_train_sharded", "dryrun": "phase_dryrun",
          "examples": "phase_examples"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+", choices=sorted(PHASES))
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("smoke_phases: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    detail = {"build_s": cs.build_kernels()}
    dev, failed = torch.device("cuda"), []
    for name in args.phases:
        print(f"[{name}]")
        t0 = time.perf_counter()
        try:
            getattr(cs, PHASES[name])(dev, detail)
        except Exception:                # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        detail[f"{name}_s"] = time.perf_counter() - t0
        print(f"[{name}] {'FAIL' if name in failed else 'ok'} "
              f"({detail[f'{name}_s']:.1f} s)")
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "smoke_phases_detail.json").write_text(
        json.dumps(detail, indent=1, default=str))
    print(f"failed: {failed}" if failed else "all phases ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
