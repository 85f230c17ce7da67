"""Carry state across from the reference package as plain values.

The scheduler has no weights; what carries over between the JAX package and
this one is configuration and live scheduling state. Both cross as plain
Python / NumPy values, so neither package imports the other:

  * `sim_config_from_reference(fields)` builds a `SimConfig` from a dict of
    plain values (the reference config's fields, with the distribution and
    power model given by name / parameters);
  * `scheduler_core_state(core)` exports a SchedulerCore's routing state —
    from either package, read through the attributes they share — as NumPy
    arrays, and `scheduler_core_from_state(arrays, policy, device)` rebuilds
    a port core from them that routes identically from there on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.affinity import PowerModel
from repro_torch.sched.api import SchedulerCore
from repro_torch.sim.distributions import make_distribution
from repro_torch.sim.simulator import SimConfig

_UNPORTED_FIELDS = ("type_mix", "class_of_type", "class_distributions",
                    "traffic", "faults")


def sim_config_from_reference(fields: dict) -> SimConfig:
    """A SimConfig from plain values: `mu`, `n_programs_per_type`,
    `distribution` (a registry name or {"name": ..., **params}), and
    optionally `order`, `power` ({"alpha": .., "coeff": ..}),
    `n_completions`, `warmup_completions` and `seed`. Fields the port does
    not simulate yet must be absent or None."""
    for name in _UNPORTED_FIELDS:
        if fields.get(name) is not None:
            raise NotImplementedError(f"SimConfig.{name} is not yet ported")
    dist = fields["distribution"]
    if isinstance(dist, str):
        dist = make_distribution(dist)
    else:
        params = dict(dist)
        dist = make_distribution(params.pop("name"), **params)
    kw = {}
    for name in ("order", "n_completions", "warmup_completions", "seed"):
        if fields.get(name) is not None:
            kw[name] = fields[name]
    if fields.get("power") is not None:
        kw["power"] = PowerModel(**dict(fields["power"]))
    return SimConfig(mu=np.asarray(fields["mu"], dtype=np.float64),
                     n_programs_per_type=np.asarray(
                         fields["n_programs_per_type"], dtype=np.int64),
                     distribution=dist, **kw)


def scheduler_core_state(core) -> dict:
    """A SchedulerCore's routing state as NumPy arrays: nominal, base and
    live mu, counts, backlog, the straggler EWMA, the pinned mix (absent
    when unpinned), the mu-version token and the cached targets with their
    keys. Only single-class cores (no class weights) are supported."""
    entries = list(core._targets.items())
    if any(key[2] is not None for key, _ in entries):
        raise NotImplementedError("class-weighted targets are not ported")
    k, l = core.mu.shape
    out = {
        "nominal_mu": np.asarray(core.nominal_mu, dtype=np.float64),
        "base_mu": np.asarray(core.base_mu, dtype=np.float64),
        "mu": np.asarray(core.mu, dtype=np.float64),
        "counts": np.asarray(core.counts, dtype=np.int64),
        "backlog": np.asarray(core.backlog_work, dtype=np.float64),
        "tracker_rates": np.asarray(core.tracker.rates, dtype=np.float64),
        "tracker_seen": np.asarray(core.tracker.seen, dtype=bool),
        "mu_token": np.asarray(core._mu_token, dtype=np.int64),
        "target_mixes": np.asarray([key[0] for key, _ in entries],
                                   dtype=np.int64).reshape(-1, k),
        "target_tokens": np.asarray([key[1] for key, _ in entries],
                                    dtype=np.int64),
        "targets": np.asarray([t for _, t in entries],
                              dtype=np.int64).reshape(-1, k, l),
    }
    if core._mix is not None:
        out["mix"] = np.asarray(core._mix, dtype=np.int64)
    return out


def scheduler_core_from_state(arrays: dict, policy, device=None,
                              **core_kwargs) -> SchedulerCore:
    """Rebuild a port SchedulerCore from `scheduler_core_state` arrays.

    The cached targets keep their keys (mix, mu-token), so a target the
    source core had solved is a cache hit here and routing continues
    decision for decision."""
    core = SchedulerCore(policy, np.asarray(arrays["nominal_mu"]),
                         device=device, **core_kwargs)
    core.base_mu = np.asarray(arrays["base_mu"], dtype=np.float64).copy()
    core._set_mu(np.asarray(arrays["mu"], dtype=np.float64).copy())
    core._mu_token = int(arrays["mu_token"])
    core._counts_rows = np.asarray(arrays["counts"],
                                   dtype=np.int64).tolist()
    core._backlog = np.asarray(arrays["backlog"], dtype=np.float64).tolist()
    core.tracker.rates = np.asarray(arrays["tracker_rates"],
                                    dtype=np.float64).copy()
    core.tracker.seen = np.asarray(arrays["tracker_seen"], dtype=bool).copy()
    for mix, token, target in zip(arrays["target_mixes"],
                                  arrays["target_tokens"], arrays["targets"]):
        core._targets[(tuple(int(x) for x in mix), int(token), None)] = \
            np.asarray(target, dtype=np.int64)
    if "mix" in arrays:
        core.notify_type_counts(arrays["mix"])
    return core
