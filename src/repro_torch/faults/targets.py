"""Per-fault-segment routing targets on the what-if solver fabric.

``refresh_targets=False`` keeps the fault-free target pinned through every
topology event (the "static" baseline). ``refresh_targets=True`` re-solves
N* for each availability segment under the segment-scaled mu — exactly the
re-solve `elastic_what_if` prices, run as ONE batched
`solve_targets_grid_torch` call over all distinct segments when the policy
batches on the device: on the card that is one launch of the fused GrIn
solve (`grin_block_solve`), however long the storm schedule.
"""
from __future__ import annotations

import numpy as np

from repro_torch.faults.scenario import FaultRealization
from repro_torch.sched.api import Policy, solve_targets_grid_torch

# Crashed pools enter the solver with this relative mu floor instead of an
# exact zero (keeps the closed forms finite); routing never selects them
# anyway because the availability mask wins.
_CRASH_MU_REL = 1e-9


def segment_targets(policy: Policy, mu: np.ndarray, mix: np.ndarray,
                    real: FaultRealization, *, refresh: bool,
                    device=None) -> np.ndarray:
    """(S + 1, k, l) int64 targets, one per availability segment.

    With `refresh`, a policy with `supports_torch_batch` solves its
    distinct segment rows (each through `policy.device_mu`, which folds a
    priority policy's class weights into the rows) as one (S_uniq, 1)
    grid on `device` (default "cuda"); other policies solve per row on the
    host."""
    mu = np.asarray(mu, dtype=np.float64)
    mix = np.asarray(mix, dtype=np.int64)
    n_seg = real.scale.shape[0]
    base = np.asarray(policy.solve_target(mu, mix), dtype=np.int64)
    if not refresh:
        return np.broadcast_to(base, (n_seg,) + base.shape).copy()

    floor = _CRASH_MU_REL * float(mu.max())
    # Hazard-realized schedules repeat scale rows heavily (every up segment
    # is all-ones, every repair of the same pool reproduces the same row):
    # solve each distinct row once and scatter back through the inverse map.
    uniq, inv = np.unique(real.scale, axis=0, return_inverse=True)
    inv = np.asarray(inv).reshape(-1)
    n_uniq = uniq.shape[0]
    scaled = [np.maximum(mu * np.maximum(uniq[u], 0.0)[None, :], floor)
              for u in range(n_uniq)]
    unchanged_u = [bool((uniq[u] == 1.0).all()) for u in range(n_uniq)]
    if policy.supports_torch_batch:
        mus = np.stack([policy.device_mu(m) for m in scaled])
        tgts, _, _ = solve_targets_grid_torch(
            mus, mix[None, :], objective=policy.torch_objective,
            power=policy.power, device=device)
        out_u = np.asarray(tgts[:, 0], dtype=np.int64)
    else:
        out_u = np.stack([base if unchanged_u[u]
                          else np.asarray(policy.solve_target(scaled[u], mix),
                                          dtype=np.int64)
                          for u in range(n_uniq)])
    out = out_u[inv].copy()
    unchanged = [unchanged_u[inv[s]] for s in range(n_seg)]
    # Down pools carry zero target: closed solvers park surplus population
    # on zero-gain columns arbitrarily, and while the availability mask
    # already makes those slots unroutable, a zero column keeps the
    # per-segment target an honest statement of where work should sit.
    out = np.where((real.scale > 0.0)[:, None, :], out, 0)
    # Healthy segments keep the exact fault-free target so refresh mode is a
    # no-op outside fault windows (and bit-identical to static there).
    for s in range(n_seg):
        if unchanged[s]:
            out[s] = base
    return out


__all__ = ["segment_targets"]
