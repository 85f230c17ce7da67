"""Quickstart on the PyTorch port: the paper's result in seconds.

The steps of `quickstart.py`, through `repro_torch`:
1. Build an affinity matrix for a CPU+GPU-like platform.
2. Solve the optimal placement with CAB (and GrIn for k x l).
3. Simulate the closed network under 5 policies and see CAB win.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(`--device` is where the simulator's scheduler runs: cuda by default,
which raises without a card.)
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (cab_solve, classify_2x2, exhaustive_solve,
                              grin_solve)
from repro_torch.sched import available_policies, get_policy
from repro_torch.sim import (ClosedNetworkSimulator, SimConfig,
                             make_distribution)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- the paper's P1-biased example (Sec. 5) ---------------------------
    mu = np.array([[20.0, 15.0],   # P1-type tasks: fast on P1, still ok on P2
                   [3.0, 8.0]])    # P2-type tasks: slow everywhere, best on P2
    print("affinity case:", classify_2x2(mu).value)

    n1, n2 = 10, 10
    sol = cab_solve(mu, n1, n2)
    print(f"CAB policy={sol.policy}  S_max=(N11={sol.s_max[0]}, "
          f"N22={sol.s_max[1]})  X_max={sol.x_max:.2f} tasks/s")
    print("  -> 'Accelerate the Fastest': ONE task alone on P1, everything "
          "else shares P2 (the counter-intuitive optimum)\n")

    # ---- simulate all policies (constructed via the registry) -------------
    print("registry:", ", ".join(available_policies()))
    cfg = SimConfig(mu=mu, n_programs_per_type=np.array([n1, n2]),
                    distribution=make_distribution("exponential"),
                    order="PS", n_completions=6000, warmup_completions=1000)
    sim = ClosedNetworkSimulator(cfg, device=dev)
    print(f"{'policy':6s} {'X':>8s} {'E[T]':>8s} {'EDP':>8s}")
    for d in map(get_policy, ("cab", "rd", "bf", "lb", "jsq")):
        m = sim.run(d)
        print(f"{d.name:6s} {m.throughput:8.2f} {m.mean_response_time:8.3f} "
              f"{m.edp:8.3f}")

    # ---- GrIn for a 3-pool fleet ------------------------------------------
    rng = np.random.default_rng(0)
    mu3 = rng.uniform(1, 30, size=(3, 3))
    nt = np.array([7, 6, 7])
    g = grin_solve(mu3, nt)
    _, xopt = exhaustive_solve(mu3, nt)
    print(f"\nGrIn on random 3x3: X={g.x_sys:.2f} vs exhaustive {xopt:.2f} "
          f"(gap {100 * (xopt - g.x_sys) / xopt:.2f}%)")


if __name__ == "__main__":
    main()
