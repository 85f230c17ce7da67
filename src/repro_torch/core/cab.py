"""CAB (Choose-between-AF-and-BF) optimal policy for two processor types.

Paper Lemma 4 / Table 1. The optimal state S_max = (N11, N22) depends only on
the ORDERING of affinity-matrix elements:

  general-symmetric (mu11 > mu21, mu22 > mu12)  -> BF:  S_max = (N1, N2)
  P1-biased        (mu11 > mu21, mu12 > mu22)   -> AF:  S_max = (1,  N2)
  P2-biased        (mu21 > mu11, mu22 > mu12)   -> AF': S_max = (N1, 1)
  non-affinity (homogeneous / big.LITTLE)       -> any -N1 < N22-N11 < N2
  symmetric                                     -> BF:  S_max = (N1, N2)

AF ("Accelerate-the-Fastest") runs exactly ONE task alone on the processor
holding the globally fastest (task, processor) rate; everything else shares
the other processor — the paper's counter-intuitive discovery.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.affinity import AffinityCase, classify_2x2
from repro_torch.core.throughput import state_from_pair, system_throughput


@dataclasses.dataclass(frozen=True)
class CABSolution:
    case: AffinityCase
    policy: str                 # "BF" | "AF" | "ANY"
    s_max: tuple[int, int]      # (N11, N22)
    state: np.ndarray           # full 2x2 state matrix
    x_max: float                # closed-form maximum throughput


def cab_closed_form_x(case: AffinityCase, n1: int, n2: int, mu: np.ndarray) -> float:
    """Closed-form X_max (paper eq. 16-18 and case (a))."""
    mu = np.asarray(mu, dtype=np.float64)
    n = n1 + n2
    if case in (AffinityCase.HOMOGENEOUS, AffinityCase.BIG_LITTLE,
                AffinityCase.GENERAL_SYMMETRIC):
        return float(mu[0, 0] + mu[1, 1])
    if case is AffinityCase.SYMMETRIC:
        return float(2.0 * mu[0, 0])
    if case is AffinityCase.P1_BIASED:
        # eq. 16: one P1-task alone on P1; (N1-1) P1-tasks + N2 P2-tasks on P2
        if n1 == 0:
            return float(mu[1, 1])  # degenerate: only P2 tasks -> all on P2
        return float((n1 - 1) / max(n - 1, 1) * mu[0, 1]
                     + n2 / max(n - 1, 1) * mu[1, 1] + mu[0, 0])
    if case is AffinityCase.P2_BIASED:
        # eq. 17: one P2-task alone on P2; (N2-1) P2-tasks + N1 P1-tasks on P1
        if n2 == 0:
            return float(mu[0, 0])
        return float((n2 - 1) / max(n - 1, 1) * mu[1, 0]
                     + n1 / max(n - 1, 1) * mu[0, 0] + mu[1, 1])
    raise ValueError(f"no closed form for case {case}")


def cab_solve(mu: np.ndarray, n1: int, n2: int) -> CABSolution:
    """Return the CAB optimal state for the 2x2 system (Table 1).

    Matrices outside the paper's affinity labeling (eq. 2) — possible when mu
    is measured live under contention — fall back to the exact argmax over
    the (N11, N22) throughput map (eq. 4), which Table 1 compresses.
    """
    mu = np.asarray(mu, dtype=np.float64)
    case = classify_2x2(mu)
    if case is AffinityCase.INVALID:
        from repro_torch.core.throughput import throughput_map_2x2
        xmap = throughput_map_2x2(n1, n2, mu)
        i, j = np.unravel_index(int(np.argmax(xmap)), xmap.shape)
        state = state_from_pair(int(i), int(j), n1, n2)
        return CABSolution(case=case, policy="EXH", s_max=(int(i), int(j)),
                           state=state, x_max=float(xmap[i, j]))

    if case in (AffinityCase.HOMOGENEOUS, AffinityCase.BIG_LITTLE):
        # Any interior state is optimal; pick the balanced canonical one that
        # keeps both queues non-empty: split each type evenly when possible.
        n11 = n1 if n2 > 0 else max(n1 - 1, 0)
        n22 = n2 if n1 > 0 else max(n2 - 1, 0)
        # keep -N1 < N22 - N11 < N2: all-own-processor satisfies it when both
        # types present; degenerate single-type handled above.
        s = (n11, n22)
        policy = "ANY"
    elif case in (AffinityCase.SYMMETRIC, AffinityCase.GENERAL_SYMMETRIC):
        s = (n1, n2)
        policy = "BF"
    elif case is AffinityCase.P1_BIASED:
        s = (min(1, n1), n2)
        policy = "AF"
    else:  # P2_BIASED
        s = (n1, min(1, n2))
        policy = "AF"

    state = state_from_pair(s[0], s[1], n1, n2)
    # Prefer the exact achieved throughput of the canonical state; the closed
    # form assumes n1, n2 >= 1 in the biased cases.
    x = system_throughput(state, mu)
    return CABSolution(case=case, policy=policy, s_max=s, state=state, x_max=x)


def cab_target_state(mu: np.ndarray, n_tasks: np.ndarray) -> np.ndarray:
    """Target 2x2 placement N* for the dispatcher (rows: types, cols: procs)."""
    n_tasks = np.asarray(n_tasks)
    return cab_solve(mu, int(n_tasks[0]), int(n_tasks[1])).state
