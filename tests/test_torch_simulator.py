"""Port parity: the host event core (`repro_torch.sim.simulator`).

The port's `ClosedNetworkSimulator` is the reference's event loop op for op,
on the same NumPy streams and the same host float64 solvers, so it must
reproduce the reference's `SimMetrics` to float64 resolution (rtol 1e-12;
in practice bit for bit) on every path: the fast path (target policies:
grin, cab, grin-p), the compat path (SystemView policies: lb, jsq, rd),
under PS, FCFS and PRIO, with and without the class map, per-class size
distributions and piecewise type re-draws. Both packages' configs are built
from the same plain values through `convert.sim_config_from_reference`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro.sched import get_policy as rget  # noqa: E402
from repro.sim import ClosedNetworkSimulator as RSim  # noqa: E402
from repro.sim import SimConfig as RCfg  # noqa: E402
from repro.sim import make_distribution as rdist  # noqa: E402
from repro.sim import run_policy_sweep as rsweep  # noqa: E402
from repro.core.affinity import PowerModel as RPower  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.sched import get_policy  # noqa: E402
from repro_torch.sim import (ClosedNetworkSimulator,  # noqa: E402
                             run_policy_sweep)

RTOL = 1e-12
FIELDS = ("throughput", "mean_response_time", "mean_energy", "edp",
          "little_product", "completed", "elapsed", "state_occupancy",
          "mean_power", "class_throughput", "class_response_time",
          "class_energy", "class_occupancy")
N_COMP, WARM = 1200, 200


def _fields(variant, policy, order, seed=1):
    """Plain values of one config. cab needs two pools; the class variants
    are the flattened two-class system (row c*k + i is class c's type i)."""
    l = 2 if policy == "cab" else 3
    rng = np.random.default_rng(40 + l)
    f = {"order": order, "n_completions": N_COMP, "warmup_completions": WARM,
         "seed": seed, "distribution": "exponential",
         "power": {"alpha": 0.5, "coeff": 1.0}}
    if variant in ("plain", "type_mix"):
        f["mu"] = rng.uniform(1, 30, size=(2, l))
        f["n_programs_per_type"] = np.array([5, 7])
        if variant == "type_mix":
            f["type_mix"] = np.array([0.3, 0.7])
        return f
    # two classes of one type (cab: a 2 x 2 flat problem) or of two types
    k = 1 if policy == "cab" else 2
    base = rng.uniform(1, 30, size=(k, l))
    f["mu"] = np.tile(base, (2, 1))
    f["n_programs_per_type"] = (np.array([3, 9]) if k == 1
                                else np.array([3, 2, 7, 8]))
    f["class_of_type"] = np.repeat([0, 1], k)
    if variant == "class_dists":
        f["class_distributions"] = ["constant", {"name": "uniform"}]
    return f


def _reference_cfg(f):
    kw = {k: f[k] for k in ("order", "n_completions", "warmup_completions",
                            "seed")}
    for k in ("type_mix", "class_of_type"):
        if k in f:
            kw[k] = f[k]
    if "class_distributions" in f:
        kw["class_distributions"] = tuple(
            rdist(d if isinstance(d, str) else d["name"])
            for d in f["class_distributions"])
    return RCfg(mu=f["mu"], n_programs_per_type=f["n_programs_per_type"],
                distribution=rdist(f["distribution"]),
                power=RPower(**f["power"]), **kw)


def _assert_same(a, b):
    for name in FIELDS:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.shape == y.shape, name
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("variant", ["plain", "classes", "class_dists",
                                     "type_mix"])
@pytest.mark.parametrize("order", ["PS", "FCFS", "PRIO"])
@pytest.mark.parametrize("policy", ["grin", "cab", "lb", "jsq", "rd"])
def test_host_core_reproduces_reference(policy, order, variant):
    f = _fields(variant, policy, order)
    ref = RSim(_reference_cfg(f)).run(policy)
    port = ClosedNetworkSimulator(convert.sim_config_from_reference(f),
                                  device="cpu").run(policy)
    _assert_same(ref, port)
    assert port.class_throughput.sum() == pytest.approx(port.throughput,
                                                        rel=1e-9)


@pytest.mark.parametrize("order", ["PS", "PRIO"])
def test_host_core_priority_policy_reproduces_reference(order):
    f = _fields("class_dists", "grin", order, seed=3)
    ref = RSim(_reference_cfg(f)).run(rget("grin-p", weights=[4.0, 1.0]))
    port = ClosedNetworkSimulator(
        convert.sim_config_from_reference(f), device="cpu").run(
            get_policy("grin-p", weights=[4.0, 1.0]))
    _assert_same(ref, port)


def test_run_policy_sweep_matches_reference():
    f = _fields("classes", "grin", "PRIO", seed=2)
    pinned = np.array([[2, 1, 0], [0, 2, 0], [3, 2, 2], [4, 0, 4]])
    ref = rsweep(_reference_cfg(f),
                 ["grin", "lb", rget("fixed", target=pinned),
                  rget("fixed", target=pinned)])
    port = run_policy_sweep(
        convert.sim_config_from_reference(f),
        ["grin", "lb", get_policy("fixed", target=pinned),
         get_policy("fixed", target=pinned)], device="cpu")
    assert list(port) == list(ref) == ["GrIn", "LB", "Opt", "Opt#2"]
    for name in ref:
        _assert_same(ref[name], port[name])
    with pytest.raises(ValueError, match="unknown engine"):
        run_policy_sweep(convert.sim_config_from_reference(f), ["grin"],
                         engine="jax", device="cpu")


def test_run_policy_sweep_torch_engine_runs_target_policies():
    f = _fields("classes", "grin", "PRIO", seed=2)
    cfg = convert.sim_config_from_reference(f)
    out = run_policy_sweep(cfg, ["grin", "lb"], engine="torch",
                           device="cpu")
    host = ClosedNetworkSimulator(cfg, device="cpu").run("lb")
    _assert_same(out["LB"], host)          # SystemView: the host core
    assert out["GrIn"].meta["kernel_mode"] == "torch-reference"
    assert out["GrIn"].class_throughput.shape == (2,)


@pytest.mark.parametrize("policy", ["grin", "lb"])
def test_prio_with_one_class_is_fcfs_exactly(policy):
    f = _fields("plain", policy, "FCFS", seed=0)
    fcfs = ClosedNetworkSimulator(convert.sim_config_from_reference(f),
                                  device="cpu").run(policy)
    prio = ClosedNetworkSimulator(convert.sim_config_from_reference(
        dict(f, order="PRIO")), device="cpu").run(policy)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(fcfs, name)),
                                      np.asarray(getattr(prio, name)))


def test_unported_fields_and_the_device_default(monkeypatch):
    f = _fields("plain", "grin", "PS")
    cfg = convert.sim_config_from_reference(f)
    # traffic and faults are ported: what stays refused is what the
    # reference refuses (a class count the spec does not have, hedges and
    # type re-draws outside open mode)
    from repro_torch.faults import FaultScenario, crash
    traffic = {"processes": [{"name": "poisson", "lam": 1.0}] * 3,
               "type_probs": np.full((3, 2), 0.5), "n_arrivals": 20}
    with pytest.raises(ValueError, match="classes"):
        ClosedNetworkSimulator(convert.sim_config_from_reference(
            dict(f, traffic=traffic)), device="cpu")
    hedged = convert.sim_config_from_reference(f)
    hedged.faults = FaultScenario(hedge_classes=(0,))
    with pytest.raises(ValueError, match="open"):
        ClosedNetworkSimulator(hedged, device="cpu")
    mixed = convert.sim_config_from_reference(dict(f, type_mix=[0.5, 0.5]))
    mixed.faults = FaultScenario(events=crash(0, 1.0, 2.0))
    with pytest.raises(ValueError, match="type_mix"):
        ClosedNetworkSimulator(mixed, device="cpu")
    with pytest.raises(ValueError, match="order"):
        ClosedNetworkSimulator(convert.sim_config_from_reference(
            dict(f, order="LIFO")), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClosedNetworkSimulator(cfg)
