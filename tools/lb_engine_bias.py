#!/usr/bin/env python3
"""Per-class LB throughput of the two batched closed engines against the
host event core, over many seeds, on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/lb_engine_bias.py --seeds 24

The workload is `benchmarks/fig_priority.py`'s (four 3x3 systems from
`random_affinity_matrix` with seed 5, class mixes (2, 2, 2) and (8, 8, 8)
flattened to six rows), at the two points where LB's per-class rates once
looked biased: system 1 under PRIO (the batch class, 48,000 completions
after 9,600) and system 3 under PS (class 0, 6,000 after 1,200). Each
seed runs on the reference's `simulate_batch` (JAX), the port's
`simulate_batch` (`device="cpu"`) and the reference's host core (which the
port's reproduces bit for bit). Prints, per point, the host mean and its
standard error, each engine's mean relative to it, and the per-seed
relative errors. Like the parity tests, it imports both packages.
"""
from __future__ import annotations

import argparse

import numpy as np

POINTS = ((1, "PRIO", 1, 48000, 9600), (3, "PS", 0, 6000, 1200))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=24)
    seeds = list(range(ap.parse_args().seeds))
    import repro.sched  # noqa: F401  (import order: sched before sim)
    from repro.core import random_affinity_matrix
    from repro.core.priority import class_of_flat, flat_mu, flatten_mixes
    from repro.sched.priority import priority_sim_config
    from repro.sim import ClosedNetworkSimulator, make_distribution
    from repro.sim.engine_jax import MODE_LB
    from repro.sim.engine_jax import simulate_batch as ref_batch
    from repro_torch.sim import make_distribution as port_dist
    from repro_torch.sim import simulate_batch as port_batch
    rng = np.random.default_rng(5)
    systems = [random_affinity_matrix(rng, 3, 3) for _ in range(4)]
    cm = np.array(((2, 2, 2), (8, 8, 8)))
    mixf, cls = flatten_mixes(cm), class_of_flat(2, 3)
    types0 = np.repeat(np.arange(6), mixf)
    B = len(seeds)
    for si, order, c, n, warm in POINTS:
        mu = np.broadcast_to(flat_mu(systems[si], 2), (B, 6, 3))
        args = (mu, np.zeros((B, 6, 3), np.int64), np.tile(types0, (B, 1)),
                seeds)
        kw = dict(order=order, n_completions=n, warmup_completions=warm,
                  modes=np.full(B, MODE_LB), class_of_type=cls)
        ref = np.asarray(ref_batch(*args, distribution=make_distribution(
            "exponential"), **kw)["class_throughput"])[:, c]
        port = port_batch(*args, distribution=port_dist("exponential"),
                          device="cpu", **kw)["class_throughput"][:, c]
        host = np.array([ClosedNetworkSimulator(priority_sim_config(
            systems[si], cm, distribution=make_distribution("exponential"),
            order=order, n_completions=n, warmup_completions=warm,
            seed=s)).run("lb").class_throughput[c] for s in seeds])
        m = host.mean()
        print(f"system {si} {order} class {c}, {B} seeds: host {m:.4f} "
              f"(standard error {host.std() / np.sqrt(B) / m:.4f} "
              f"relative); reference engine {ref.mean() / m - 1:+.4f}; "
              f"port engine {port.mean() / m - 1:+.4f}")
        print(f"  per seed, reference {np.round(ref / host - 1, 3).tolist()}")
        print(f"  per seed, port      {np.round(port / host - 1, 3).tolist()}")


if __name__ == "__main__":
    main()
