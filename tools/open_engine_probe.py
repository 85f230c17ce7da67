#!/usr/bin/env python3
"""Two measurements of the open engine (`repro_torch.traffic`) on
`chip_smoke.py`'s fig_faults workload (2x4 system, u = 1.1, a two-burst
storm, 20,000 arrivals):

    python3 tools/open_engine_probe.py --spread --device cpu
    python3 tools/open_engine_probe.py --steps            # on a card

`--spread`: the grin-p+refresh+ckpt point of arrival seed 2 run again
with 12 other size streams (`seeds` 100-111) on the same arrivals and
storm: how far one run's per-class p99 moves with the size stream alone.
`--steps`: the 18-point batch cut to its first 2,000 arrivals, timed as
the eager loop and as the captured-graph loop (`cuda_graph`), with their
results compared. Prints the card's name and power limit when on a card,
then one JSON line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

REPLICAS, STEPS_ARRIVALS = 12, 2000


def spread(dev, T, W, seeds):
    import numpy as np
    import chip_smoke as cs
    from repro_torch.traffic import simulate_open_batch
    mu, cls, spec, arr, storm, mix, variants = cs.faults_workload(T, W, seeds)
    work = (mu, cls, spec, arr, storm, mix,
            [v for v in variants if v[0] == "grin-p+refresh+ckpt"])
    full, points, _ = cs.open_fault_batch(dev, work, T, W, seeds,
                                          cs.TRAFFIC_QCAP)
    i = [p[3] for p in points].index(2)

    def rep(a):
        return np.repeat(np.asarray(a)[i:i + 1], REPLICAS, axis=0)
    fb = full["faults"]
    fb = dataclasses.replace(fb, **{f: rep(getattr(fb, f)) for f in (
        "times", "scale", "seg_targets", "ckpt_period", "restart_overhead",
        "fail_counts", "hedge", "ckpt_age", "hedge_q", "hedge_min")})
    out = simulate_open_batch(device=dev, **dict(
        full, targets=rep(full["targets"]), arr_times=rep(full["arr_times"]),
        arr_types=rep(full["arr_types"]), modes=rep(full["modes"]),
        seeds=[100 + r for r in range(REPLICAS)], faults=fb))
    p99 = out["class_quantiles"][:, :, 1]
    return {"point": ["grin-p+refresh+ckpt", 2], "size_seeds": REPLICAS,
            "class_p99": p99.T.tolist(), "goodput": out["goodput"].tolist()}


def steps(dev, T, W, seeds):
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.traffic import simulate_open_batch
    work = cs.faults_workload(T, W, seeds)
    full, _, _ = cs.open_fault_batch(dev, work, T, W, seeds, cs.TRAFFIC_QCAP)
    batch = cs.shorter(full, STEPS_ARRIVALS)
    row, res = {}, {}
    for graph in (False, True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[graph] = simulate_open_batch(device=dev, cuda_graph=graph,
                                         **batch)
        torch.cuda.synchronize()
        key = "graph" if graph else "eager"
        row.setdefault(key + "_ms_per_step", []).append(
            (time.perf_counter() - t0) / res[graph]["steps"] * 1e3)
    row["steps"] = res[True]["steps"]
    row["differing_outputs"] = [
        k for k, v in res[False].items() if k != "device" and not
        np.array_equal(np.asarray(v), np.asarray(res[True][k]),
                       equal_nan=True)]
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import torch
    dev = torch.device(a.device)
    out = {"device": str(dev)}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    T, W, seeds = 20000, 2000, (0, 1, 2)
    if a.spread:
        out["spread"] = spread(dev, T, W, seeds)
    if a.steps:
        out["steps"] = steps(dev, T, W, seeds)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
