"""Priority-class policies + workload plumbing (arXiv:1712.03246).

The registry entries `grin-p` and `cab-p` are target policies over the
CLASS-MAJOR FLATTENED problem (see `repro_torch.core.priority`): the affinity
matrix a `SchedulerCore` holds for them has C*k rows — row (c*k + i) is
class c's i-type — and the (C*k, l) target they solve keeps per-(class,
type) deficit rows, so the shared routing machinery needs no new state.
Weights fold into the matrix the SOLVER ranks moves under (`device_mu`),
never into the physical rates routing and EWMA folding observe.

`priority_sim_config` builds the matching flattened `SimConfig` (tiled mu,
flattened per-class mixes, `class_of_type` map, optional per-class size
distributions) for both simulation engines; `order="PRIO"` selects the
strict-priority preemption-free service order (class 0 first; within a
class, FCFS). `priority_open_config` builds the open-network counterpart
(`repro_torch.traffic`): one arrival process per class on the same
flattened substrate.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.grin import grin_solve
from repro_torch.core.priority import (cab_priority_solve, class_of_flat,
                                       flat_mu, flatten_mixes)
from repro_torch.sched.api import Policy, register_policy


def _weights_vector(weights) -> np.ndarray:
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1 or w.size < 1 or (w < 0).any():
        raise ValueError(f"weights must be a nonneg 1-D vector; got {w!r}")
    return w


def _flat_k(mu: np.ndarray, n_classes: int) -> int:
    rows = np.asarray(mu).shape[0]
    if rows % n_classes:
        raise ValueError(
            f"flattened affinity has {rows} rows, not a multiple of "
            f"C={n_classes} classes (build it with priority_sim_config / "
            "flat_mu)")
    return rows // n_classes


class _WeightedFlatPolicy(Policy):
    """Shared base of the priority policies: hold the class-weight vector
    and fold it into the flattened affinity rows (`device_mu` — the one
    place weights enter mu; watts and routing rates stay physical)."""

    def __init__(self, weights=(1.0,)):
        self.class_weights = _weights_vector(weights)

    def device_mu(self, mu):
        k = _flat_k(mu, len(self.class_weights))
        return np.repeat(self.class_weights, k)[:, None] * np.asarray(
            mu, dtype=np.float64)


@register_policy("grin-p", "grinp", "grin_p")
class GrInPriorityPolicy(_WeightedFlatPolicy):
    """GrIn-P: block-move GrIn on the class-weighted flattened problem —
    maximizes sum_c w_c X_c for any (C, k, l). With C=1 and w=(1,) the
    weighting is the float-exact identity, so targets, routing decisions
    and device solves are bit-identical to plain `grin`."""

    name = "GrIn-P"
    supports_torch_batch = True

    def solve_target(self, mu, n_tasks):
        return grin_solve(self.device_mu(mu), n_tasks).N


@register_policy("cab-p", "cabp", "cab_p")
class CABPriorityPolicy(_WeightedFlatPolicy):
    """CAB-P: Table-1 analytical optimum of the class-weighted flattened
    2 x 2 problem (two classes of one type, or one class of two types, on
    two pools). C=1 with w=(1,) reduces bit-identically to `cab`."""

    name = "CAB-P"
    pool_limit = 2

    def solve_target(self, mu, n_tasks):
        C = len(self.class_weights)
        k = _flat_k(mu, C)
        base = np.asarray(mu, dtype=np.float64)[:k]
        mixes = np.asarray(n_tasks, dtype=np.int64).reshape(C, k)
        return cab_priority_solve(base, mixes, self.class_weights).reshape(
            C * k, -1)


def priority_sim_config(mu, class_mixes, weights=None, *,
                        distribution=None, class_distributions=None,
                        order: str = "PS", **kwargs):
    """Build the flattened `SimConfig` for a multi-class workload.

    mu: (k, l) physical affinities; class_mixes: (C, k) per-class type
    counts. The returned config runs on BOTH engines: its mu is the (C*k, l)
    physical tile, its program counts the flattened mixes, and
    `class_of_type` maps each flat row back to its class so the engines
    report per-class X / E / response time / occupancy. `weights` is
    accepted for symmetry but lives on the POLICY (grin-p/cab-p), not the
    simulator — the substrate is class-blind; pass it to `get_policy`.
    `class_distributions` (len C) gives each class its own task-size
    distribution; `order="PRIO"` selects strict-priority preemption-free
    service (class 0 first).
    """
    from repro_torch.sim.simulator import SimConfig  # sim imports sched
    del weights                                   # scheduling-side knob only
    class_mixes = np.asarray(class_mixes, dtype=np.int64)
    if class_mixes.ndim != 2:
        raise ValueError(f"class_mixes must be (C, k); got {class_mixes.shape}")
    C, k = class_mixes.shape
    if class_distributions is not None:
        class_distributions = tuple(class_distributions)
        if len(class_distributions) != C:
            raise ValueError(f"need {C} class_distributions; got "
                             f"{len(class_distributions)}")
        if distribution is None:
            distribution = class_distributions[0]
    if distribution is None:
        raise ValueError("need `distribution` (or `class_distributions`)")
    return SimConfig(mu=flat_mu(mu, C),
                     n_programs_per_type=flatten_mixes(class_mixes),
                     distribution=distribution, order=order,
                     class_of_type=class_of_flat(C, k),
                     class_distributions=class_distributions, **kwargs)


def priority_open_config(mu, processes, class_type_probs=None, *,
                         distribution=None, class_distributions=None,
                         order: str = "PRIO", **kwargs):
    """Build the flattened OPEN-network `SimConfig` for a multi-class
    workload (`repro_torch.traffic`): one arrival process per class, types
    drawn within each class from `class_type_probs` ((C, k) rows, default
    uniform), on the same class-major flattened substrate as
    `priority_sim_config`. Remaining kwargs (n_arrivals, warmup_arrivals,
    queue_capacity, admit_limits, deadlines, seed, power, ...) pass through
    to `repro_torch.traffic.open_sim_config`.
    """
    from repro_torch.traffic.arrivals import TrafficSpec
    from repro_torch.traffic.config import open_sim_config
    mu = np.asarray(mu, dtype=np.float64)
    k = mu.shape[0]
    C = len(processes)
    probs = (np.full((C, k), 1.0 / k) if class_type_probs is None
             else np.asarray(class_type_probs, dtype=np.float64))
    if probs.shape != (C, k):
        raise ValueError(f"class_type_probs must be (C={C}, k={k}); got "
                         f"{probs.shape}")
    # class c's mass sits on its own flat rows c*k .. c*k + k - 1
    flat_probs = np.zeros((C, C * k))
    for c in range(C):
        flat_probs[c, c * k:(c + 1) * k] = probs[c]
    if class_distributions is not None:
        class_distributions = tuple(class_distributions)
        if distribution is None:
            distribution = class_distributions[0]
    if distribution is None:
        raise ValueError("need `distribution` (or `class_distributions`)")
    spec = TrafficSpec(processes=tuple(processes), type_probs=flat_probs)
    return open_sim_config(flat_mu(mu, C), spec, distribution=distribution,
                           order=order, class_of_type=class_of_flat(C, k),
                           class_distributions=class_distributions, **kwargs)
