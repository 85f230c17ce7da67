"""Carry state across from the reference package as plain values.

What carries over between the JAX package and this one is configuration,
live scheduling state and model weights. All cross as plain Python / NumPy
values, so neither package imports the other:

  * `sim_config_from_reference(fields)` builds a `SimConfig` from a dict of
    plain values (the reference config's fields, with the distributions and
    power model given by name / parameters, open traffic and fault
    scenarios as dicts of their fields);
  * `scheduler_core_state(core)` exports a SchedulerCore's routing state —
    from either package, read through the attributes they share — as NumPy
    arrays (a priority policy's class weights and the DVFS frequencies
    included), and `scheduler_core_from_state(arrays, policy, device)`
    rebuilds a port core from them that routes identically from there on;
  * `model_params_from_reference(cfg, tree)` builds a port `Model` from the
    reference's parameter pytree given as nested dicts of NumPy arrays,
    unstacking its scanned layer stacks into the port's module lists.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.affinity import PowerModel
from repro_torch.sched.api import SchedulerCore
from repro_torch.sim.distributions import make_distribution
from repro_torch.sim.simulator import SimConfig

_PROCESSES = {"poisson": "PoissonArrivals", "mmpp": "MMPPArrivals",
              "diurnal": "DiurnalArrivals", "trace": "TraceArrivals"}


def _distribution(spec):
    """A distribution from a registry name or {"name": ..., **params}."""
    if isinstance(spec, str):
        return make_distribution(spec)
    params = dict(spec)
    return make_distribution(params.pop("name"), **params)


def _as_dict(value, name: str) -> dict:
    if not isinstance(value, dict):
        raise TypeError(f"{name} must be a dict of plain values; got "
                        f"{type(value).__name__}")
    return dict(value)


def open_traffic_from_reference(fields: dict):
    """An `OpenTraffic` from plain values: `processes` (a list of
    {"name": "poisson" | "mmpp" | "diurnal" | "trace", **the process's
    fields}), `type_probs` ((C, k)), `n_arrivals`, and optionally
    `warmup_arrivals`, `queue_capacity`, `admit_limits`, `deadlines` and
    `hist` ({"lo", "hi", "n_bins"})."""
    from repro_torch import traffic
    f = _as_dict(fields, "traffic")
    procs = []
    for spec in f.pop("processes"):
        spec = _as_dict(spec, "an arrival process")
        cls = getattr(traffic, _PROCESSES[spec.pop("name")])
        procs.append(cls(**{k: tuple(v) if isinstance(v, (list, np.ndarray))
                            else v for k, v in spec.items()}))
    spec = traffic.TrafficSpec(tuple(procs),
                               np.asarray(f.pop("type_probs"), np.float64))
    if f.get("hist") is not None:
        f["hist"] = traffic.LogHistogram(**_as_dict(f["hist"], "hist"))
    for name in ("admit_limits", "deadlines"):
        if f.get(name) is not None:
            f[name] = np.asarray(f[name])
    return traffic.OpenTraffic(spec=spec, **{k: v for k, v in f.items()
                                             if v is not None})


def fault_scenario_from_reference(fields: dict):
    """A `FaultScenario` from plain values: `events` as (time, pool, scale)
    triples and the scenario's other fields."""
    from repro_torch.faults import FaultScenario, PoolEvent
    f = _as_dict(fields, "faults")
    events = tuple(PoolEvent(float(t), int(j), float(s))
                   for t, j, s in f.pop("events", ()))
    if "hedge_classes" in f:
        f["hedge_classes"] = tuple(int(c) for c in f["hedge_classes"])
    return FaultScenario(events=events, **f)


def sim_config_from_reference(fields: dict) -> SimConfig:
    """A SimConfig from plain values: `mu`, `n_programs_per_type`,
    `distribution` (a registry name or {"name": ..., **params}), and
    optionally `order`, `power` ({"alpha": .., "coeff": ..}),
    `n_completions`, `warmup_completions`, `seed`, `type_mix` ((k,)
    probabilities), `class_of_type` ((k,) ints) and `class_distributions`
    (a list of specs like `distribution`), `traffic` (the dict
    `open_traffic_from_reference` takes) and `faults` (the dict
    `fault_scenario_from_reference` takes)."""
    kw = {}
    if fields.get("traffic") is not None:
        kw["traffic"] = open_traffic_from_reference(fields["traffic"])
    if fields.get("faults") is not None:
        kw["faults"] = fault_scenario_from_reference(fields["faults"])
    for name in ("order", "n_completions", "warmup_completions", "seed"):
        if fields.get(name) is not None:
            kw[name] = fields[name]
    if fields.get("power") is not None:
        kw["power"] = PowerModel(**dict(fields["power"]))
    if fields.get("type_mix") is not None:
        kw["type_mix"] = np.asarray(fields["type_mix"], dtype=np.float64)
    if fields.get("class_of_type") is not None:
        kw["class_of_type"] = np.asarray(fields["class_of_type"],
                                         dtype=np.int64)
    if fields.get("class_distributions") is not None:
        kw["class_distributions"] = tuple(
            _distribution(d) for d in fields["class_distributions"])
    return SimConfig(mu=np.asarray(fields["mu"], dtype=np.float64),
                     n_programs_per_type=np.asarray(
                         fields["n_programs_per_type"], dtype=np.int64),
                     distribution=_distribution(fields["distribution"]), **kw)


def scheduler_core_state(core) -> dict:
    """A SchedulerCore's routing state as NumPy arrays: nominal, base and
    live mu, the DVFS frequencies, counts, backlog, the straggler EWMA, the
    pinned mix (absent when unpinned), a priority policy's class weights
    (absent for single-class policies), the mu-version token and the cached
    targets with their keys. Entries cached under other class weights than
    the policy's current ones are never served again and are left out."""
    w = core.policy.class_weights
    wkey = None if w is None else tuple(float(x) for x in w)
    entries = [(key, t) for key, t in core._targets.items()
               if key[2] == wkey]
    k, l = core.mu.shape
    out = {
        "nominal_mu": np.asarray(core.nominal_mu, dtype=np.float64),
        "base_mu": np.asarray(core.base_mu, dtype=np.float64),
        "mu": np.asarray(core.mu, dtype=np.float64),
        "frequencies": np.asarray(core.frequencies, dtype=np.float64),
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
    if w is not None:
        out["class_weights"] = np.asarray(w, dtype=np.float64)
    return out


def scheduler_core_from_state(arrays: dict, policy, device=None,
                              **core_kwargs) -> SchedulerCore:
    """Rebuild a port SchedulerCore from `scheduler_core_state` arrays.

    The cached targets keep their keys (mix, mu-token, class weights), so a
    target the source core had solved is a cache hit here and routing
    continues decision for decision. A priority policy takes the source's
    class weights."""
    core = SchedulerCore(policy, np.asarray(arrays["nominal_mu"]),
                         device=device, **core_kwargs)
    if "class_weights" in arrays:
        core.set_class_weights(arrays["class_weights"])
    core._freq = np.asarray(arrays["frequencies"], dtype=np.float64).copy()
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
        core._targets[(tuple(int(x) for x in mix), int(token),
                       core._weights_key())] = np.asarray(target,
                                                          dtype=np.int64)
    if "mix" in arrays:
        core.notify_type_counts(arrays["mix"])
    return core


@torch.no_grad()
def _load(module: torch.nn.Module, tree: dict, index=(), prefix="") -> int:
    """Copy `tree`'s leaves (indexed by `index` along their leading stacked
    axes) into the same-named parameters of `module`; returns how many."""
    n = 0
    for key, val in tree.items():
        if isinstance(val, dict):
            n += _load(getattr(module, key), val, index, f"{prefix}{key}.")
            continue
        p = getattr(module, key, None)
        if not isinstance(p, torch.Tensor):
            raise KeyError(f"the port has no parameter {prefix}{key}")
        arr = np.asarray(val)[index]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{prefix}{key}: reference {arr.shape} vs port "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, order="C")))
        n += 1
    return n


def model_params_from_reference(cfg, tree: dict, device=None):
    """A port `Model` for `cfg` holding the reference's parameters `tree`
    (nested dicts of NumPy arrays, e.g. `jax.tree.map(np.asarray,
    params)`). The top-level `embed`, `lm_head`, `ln_f`, audio's codebook
    `embed` (K, V, d) and `heads` (K, d, V) and vlm's `patch_proj` cross as
    they are. The scanned stacks unstack along their leading axes:
    `stack` (n_layers, ...) into the blocks of the dense, audio and vlm
    families, and of the moe family, whose blocks carry a `moe` subtree
    (`router`, `w_in`, `w_out`) in place of `mlp`; `stack_groups` (groups,
    attn_every, ...) and `stack_tail` (rest, ...) into the hybrid's Mamba2
    blocks in order, `shared` into its shared block; the ssm family's
    `stack_groups["mlstm"]` (groups, slstm_every - 1, ...) and
    `stack_groups["slstm"]` (groups, ...) into its mLSTM and sLSTM blocks
    in order. Every port parameter must be filled."""
    from repro_torch.models.model import Model
    model = Model(cfg, device=device)
    n = _load(model, {k: tree[k] for k in ("embed", "lm_head", "ln_f",
                                           "heads", "patch_proj")
                      if k in tree})
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        for i, blk in enumerate(model.layers):
            n += _load(blk, tree["stack"], (i,))
    elif cfg.family == "ssm":
        groups = tree["stack_groups"]
        m = cfg.slstm_every - 1
        for i, blk in enumerate(model.mlstm):
            n += _load(blk, groups["mlstm"], divmod(i, m))
        for gi, blk in enumerate(model.slstm):
            n += _load(blk, groups["slstm"], (gi,))
    else:
        ae = cfg.attn_every
        g = cfg.n_layers // ae
        for i, blk in enumerate(model.mamba):
            if i < g * ae:
                n += _load(blk, tree["stack_groups"], divmod(i, ae))
            else:
                n += _load(blk, tree["stack_tail"], (i - g * ae,))
        n += _load(model.shared, tree["shared"])
    expected = sum(1 for _ in model.parameters())
    if n != expected:
        raise ValueError(f"filled {n} of the port's {expected} parameters")
    return model
