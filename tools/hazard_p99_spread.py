#!/usr/bin/env python3
"""How far one point's latency-class p99 moves with the task-size stream
alone, on `benchmarks/fig_hazard.py`'s workload.

    python3 tools/hazard_p99_spread.py [--variant lb] [--point 1]
                                       [--streams 12] [--procs 6]

For one point of the smoke's hazard workload (`chip_smoke.hazard_workload`
at 20,000 arrivals: a variant and an index into its 12-point availability
grid) it keeps the arrivals and the drawn outages and changes only the
size streams: the host fault loop (`run_open_faults`, through
`ClosedNetworkSimulator`) under the point's own seed and `--streams` - 1
others, with the arrivals replayed as a fixed trace, and the open device
engine under `--streams` engine seeds. It prints both sets of class-0
p99s. Runs on the CPU (the engine's plain path), in `--procs` host
processes; a few minutes. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

T, W, SEEDS = 20000, 2000, (0, 1, 2)


def _point(variant: str, index: int):
    import chip_smoke as cs
    work = cs.hazard_workload(T, SEEDS)
    points = [p for p in work[6] if p[0] == variant]
    return work, points[index]


def _host_p99(args):
    """Class-0 p99 of the host fault loop on the point's arrivals (a
    fixed trace) with the size stream of `seed`."""
    import numpy as np
    import chip_smoke as cs
    from repro_torch.sim import ClosedNetworkSimulator, make_distribution
    from repro_torch.traffic import (TraceArrivals, TrafficSpec,
                                     open_sim_config)
    variant, index, seed = args
    work, (_, pname, sc, s) = _point(variant, index)
    mu, cls, _, arr, _, mix, _ = work
    times, types = arr[s]
    spec = TrafficSpec(tuple(TraceArrivals(times=tuple(
        float(t) for t in times[types == c])) for c in range(2)), np.eye(2))
    cfg = open_sim_config(mu, spec, n_arrivals=T, warmup_arrivals=W,
                          queue_capacity=cs.TRAFFIC_QCAP, class_of_type=cls,
                          target_mix=mix,
                          distribution=make_distribution("exponential"),
                          order="PS", seed=seed, faults=sc)
    m = ClosedNetworkSimulator(cfg, device="cpu").run(cs.open_policy(pname))
    return float(m.class_quantiles[0][1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="lb")
    ap.add_argument("--point", type=int, default=1)
    ap.add_argument("--streams", type=int, default=12)
    ap.add_argument("--procs", type=int, default=6)
    a = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.traffic import simulate_open_batch
    work, point = _point(a.variant, a.point)
    seed = point[3]
    host_seeds = [seed] + [100 + r for r in range(a.streams - 1)]
    with multiprocessing.get_context("spawn").Pool(a.procs) as pool:
        pending = pool.map_async(_host_p99, [(a.variant, a.point, s)
                                             for s in host_seeds])
        batch, _, _ = cs.open_fault_batch(
            torch.device("cpu"), work[:6] + ([point],), T, W, SEEDS,
            cs.TRAFFIC_QCAP)
        R = a.streams
        tile = (lambda x: np.repeat(x, R, axis=0))
        fb = batch["faults"]
        fb = dataclasses.replace(fb, **{
            f.name: tile(getattr(fb, f.name)) for f in dataclasses.fields(fb)
            if isinstance(getattr(fb, f.name), np.ndarray)})
        out = simulate_open_batch(
            device="cpu", **dict(
                batch, targets=tile(batch["targets"]),
                arr_times=tile(batch["arr_times"]),
                arr_types=tile(batch["arr_types"]), modes=tile(
                    batch["modes"]), faults=fb,
                seeds=[seed] + [100 + r for r in range(R - 1)]))
        host = pending.get()
    print(f"{a.variant} point {a.point} (seed {seed}): class-0 p99, s")
    print(f"  host, the point's own size stream: {host[0]:.2f}")
    print(f"  host, {R - 1} other size streams: "
          f"{np.round(sorted(host[1:]), 2).tolist()}")
    print(f"  engine, {R} size streams: "
          f"{np.round(np.sort(out['class_quantiles'][:, 0, 1]), 2).tolist()}")


if __name__ == "__main__":
    main()
