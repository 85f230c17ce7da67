"""Open-network run configuration.

`OpenTraffic` bundles everything that turns a closed `SimConfig` into an
open one: the arrival spec, the offered-arrival count and warmup, the
finite per-processor queue, the static per-class admission limits, the
response-time histogram, and optional per-class SLO deadlines. Setting
`SimConfig.traffic` to an instance flips BOTH engines into open mode —
arrivals inject tasks, completions depart instead of recirculating, and
`n_programs_per_type` becomes the REFERENCE MIX the target policies solve
their placement N* at (deficit routing then pins live placements to those
proportions; by default the mix is the expected type split scaled to the
full queue capacity l * queue_capacity).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.traffic.arrivals import TrafficSpec
from repro_torch.traffic.quantiles import LogHistogram


@dataclasses.dataclass(frozen=True)
class OpenTraffic:
    """Open-mode parameters attached to `SimConfig.traffic`.

    spec:            per-class arrival processes + type distribution.
    n_arrivals:      offered arrivals per run (the simulated horizon ends
                     at the last arrival; later completions are outside
                     the measurement window).
    warmup_arrivals: arrivals before the measurement window opens (the
                     window is [t_warm, t_end] with t_warm the warmup-th
                     arrival's time and t_end the last arrival's).
    queue_capacity:  finite per-processor queue; a task routed to a full
                     processor is dropped.
    admit_limits:    (C,) static in-system admission caps (class c sheds
                     when the total population reaches admit_limits[c]);
                     None admits up to physical capacity (capacity drops
                     only). See `repro_torch.traffic.admission`.
    hist:            the log-histogram quantile accumulator spec.
    deadlines:       (C,) per-class SLO deadlines for deadline-met
                     accounting (None: not tracked).
    """

    spec: TrafficSpec
    n_arrivals: int
    warmup_arrivals: int = 0
    queue_capacity: int = 8
    admit_limits: np.ndarray | None = None
    hist: LogHistogram = dataclasses.field(default_factory=LogHistogram)
    deadlines: np.ndarray | None = None

    def __post_init__(self):
        if not 0 <= self.warmup_arrivals < self.n_arrivals:
            raise ValueError("need 0 <= warmup_arrivals < n_arrivals")
        if self.n_arrivals < 2:
            raise ValueError("need at least 2 arrivals")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")

    def n_slots(self, l: int) -> int:
        """Physical in-system capacity: l processors * queue_capacity."""
        return l * self.queue_capacity

    def resolved_admit_limits(self, l: int) -> np.ndarray:
        """(C,) admission caps clamped into [0, n_slots]; default = no
        shedding (every class admits to physical capacity)."""
        ns = self.n_slots(l)
        if self.admit_limits is None:
            return np.full(self.spec.n_classes, ns, dtype=np.int64)
        lim = np.asarray(self.admit_limits, dtype=np.int64)
        if lim.shape != (self.spec.n_classes,):
            raise ValueError(f"admit_limits must be ({self.spec.n_classes},); "
                             f"got {lim.shape}")
        return np.clip(lim, 0, ns)

    def resolved_deadlines(self) -> np.ndarray:
        """(C,) deadlines; +inf (never missed) when not tracking SLOs."""
        if self.deadlines is None:
            return np.full(self.spec.n_classes, np.inf)
        d = np.asarray(self.deadlines, dtype=np.float64)
        if d.shape != (self.spec.n_classes,):
            raise ValueError(f"deadlines must be ({self.spec.n_classes},); "
                             f"got {d.shape}")
        return d


def derive_target_mix(spec: TrafficSpec, l: int,
                      queue_capacity: int) -> np.ndarray:
    """Reference mix for open-mode target solving: the long-run per-type
    arrival split scaled to the full capacity population l * queue_capacity
    (largest-remainder rounded) — the placement proportions the deficit
    router pins at saturation."""
    from repro_torch.core.slsqp import round_largest_remainder
    rates = spec.type_rates()
    n_ref = l * queue_capacity
    raw = rates / rates.sum() * n_ref
    return round_largest_remainder(raw[None, :], np.array([n_ref]))[0]


def open_sim_config(mu, spec: TrafficSpec, *, n_arrivals: int,
                    warmup_arrivals: int = 0, queue_capacity: int = 8,
                    admit_limits=None, deadlines=None,
                    hist: LogHistogram | None = None,
                    class_of_type=None, target_mix=None, **kwargs):
    """Build an open-mode `SimConfig` that runs on BOTH engines.

    mu is the (k, l) affinity matrix (class-major flattened for multi-class
    workloads, as in `priority_sim_config`); `class_of_type` maps its rows
    to the spec's classes (default: all class 0). `target_mix` overrides the
    reference mix target policies solve at (default: `derive_target_mix`).
    Remaining kwargs (distribution, order, power, seed, ...) pass through
    to `SimConfig`; `n_completions`/`warmup_completions` are bookkeeping
    only in open mode (the arrival horizon governs the run).
    """
    from repro_torch.sim.simulator import SimConfig  # sim imports traffic
    mu = np.asarray(mu, dtype=np.float64)
    k, l = mu.shape
    if spec.type_probs.shape[1] != k:
        raise ValueError(f"spec.type_probs covers {spec.type_probs.shape[1]} "
                         f"types; mu has k={k} rows")
    cls = (np.zeros(k, dtype=np.int64) if class_of_type is None
           else np.asarray(class_of_type, dtype=np.int64))
    C = spec.n_classes
    if int(cls.max()) + 1 != C:
        raise ValueError(f"class_of_type implies {int(cls.max()) + 1} "
                         f"classes; spec has {C}")
    # each class's type mass must sit on its own rows
    for c in range(C):
        if spec.type_probs[c][cls != c].sum() > 1e-12:
            raise ValueError(f"class {c} arrivals draw types outside its "
                             "class rows (check type_probs vs class_of_type)")
    mix = (derive_target_mix(spec, l, queue_capacity) if target_mix is None
           else np.asarray(target_mix, dtype=np.int64))
    tr = OpenTraffic(spec=spec, n_arrivals=int(n_arrivals),
                     warmup_arrivals=int(warmup_arrivals),
                     queue_capacity=int(queue_capacity),
                     admit_limits=admit_limits,
                     hist=hist if hist is not None else LogHistogram(),
                     deadlines=deadlines)
    kwargs.setdefault("n_completions", int(n_arrivals))
    kwargs.setdefault("warmup_completions", 0)
    return SimConfig(mu=mu, n_programs_per_type=mix, class_of_type=cls,
                     traffic=tr, **kwargs)


__all__ = ["OpenTraffic", "open_sim_config", "derive_target_mix"]
