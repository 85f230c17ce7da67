"""Fleet-level scheduling on the PyTorch port: the steps of
`schedule_cluster.py` through `repro_torch` — GrIn placing LM workload
classes across a heterogeneous fleet with roofline-derived affinity
matrices, batched targets for anticipated mixes in one device solve
(`solve_targets_grid_torch`), straggler mitigation and elastic pool loss.

Run:  PYTHONPATH=src python examples/schedule_cluster_torch.py [--device cpu]
(`--device` is where the batched solve and the scheduler run: cuda by
default, which raises without a card.)
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import exhaustive_solve, grin_solve
from repro_torch.sched import (ChipSpec, ClusterScheduler, StepCost,
                               affinity_from_roofline, get_policy,
                               serving_step_costs, solve_targets_grid_torch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- a heterogeneous fleet: three pool types --------------------------
    v5e = ChipSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    v5p_like = ChipSpec("tpu-v5p-like", peak_flops=459e12, hbm_bw=2765e9,
                        link_bw=100e9)
    v4_like = ChipSpec("tpu-v4-like", peak_flops=275e12, hbm_bw=1228e9,
                       link_bw=50e9)
    pools = [(v5e, 64), (v5p_like, 16), (v4_like, 32)]

    # ---- workload classes: prefill/decode/train of a 7B model -------------
    costs = serving_step_costs(n_params=7e9, seq_len=32768, batch=8)
    costs.append(StepCost("train_micro", flops=6 * 7e9 * 0.5e6,
                          hbm_bytes=6 * 7e9 * 4, collective_bytes=7e9 * 4))

    mu = affinity_from_roofline(costs, pools)
    print("roofline-derived mu (tasks/s):")
    for i, c in enumerate(costs):
        print(f"  {c.name:12s}", np.round(mu[i], 2))

    n_tasks = np.array([12, 30, 6])
    g = grin_solve(mu, n_tasks)
    _, xopt = exhaustive_solve(mu, n_tasks)
    print(f"\nGrIn placement (rows=classes, cols=pools):\n{g.N}")
    print(f"GrIn X={g.x_sys:.2f}  exhaustive X={xopt:.2f} "
          f"(gap {100 * (xopt - g.x_sys) / xopt:.2f}%)")

    # ---- batched target pre-solve for the expected mixes (on device) ------
    mixes = np.array([[12, 30, 6], [8, 34, 6], [16, 26, 6], [12, 24, 12]])
    targets, xs, _ = solve_targets_grid_torch(mu[None], mixes, device=dev)
    print("\nbatched GrIn targets for 4 anticipated type mixes (X per mix):",
          np.round(xs[0], 1))

    # ---- straggler mitigation: pool 1 degrades to 40% ---------------------
    sched = ClusterScheduler(mu, policy=get_policy("grin"),
                             resolve_rate_rel_change=0.2, device=dev)
    for i, nt in enumerate(n_tasks):
        for _ in range(nt):
            sched.route(i)
    print("\nlive counts before degradation:\n", sched.counts.copy())
    # slow completions on pool 1 (observed 2.5x the expected time)
    for _ in range(8):
        sched.complete(1, 1, service_s=2.5 * (1.0 / sched.base_mu[1, 1]))
        sched.route(1)
    print("mu column 1 scaled by:",
          np.round(sched.mu[:, 1] / sched.base_mu[:, 1], 2))
    print("re-solves so far:", sched.resolves)

    # ---- elastic: pool 2 dies ---------------------------------------------
    sched.pool_lost(2)
    g2 = grin_solve(sched.mu, n_tasks)
    print("\nafter pool loss, GrIn placement:\n", g2.N, f"\nX={g2.x_sys:.2f}")


if __name__ == "__main__":
    main()
