"""Port parity: the batched engine's priority classes, PRIO order, per-class
size distributions and piecewise type re-draws (`repro_torch.sim.
engine_torch`), held to the port's own host event core.

The engine draws from torch generators and the host core from NumPy, so
parity is statistical, at the multi-class gates of
`tests/test_conformance.py` with its grid, seeds and counts: per-class X
and E/task within 0.2 per point and 0.08 on the grid mean. Strict priority
can starve the batch class on a saturated column; both engines must then
agree the class is dead (under 2% of the point's total rate). The C == 1
reduction is exact: an all-zeros class map changes no number."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.affinity import PowerModel  # noqa: E402
from repro_torch.sched import get_policy  # noqa: E402
from repro_torch.sched.priority import (flat_mu, flatten_mixes,  # noqa: E402
                                        priority_sim_config)
from repro_torch.sim import (ClosedNetworkSimulator, SimConfig,  # noqa: E402
                             make_distribution, simulate_batch,
                             simulate_policy, sweep)
from repro_torch.sim.engine_torch import _cfg_mix_and_types0  # noqa: E402

CPU = "cpu"
POWER = PowerModel(alpha=0.5)
DIST = make_distribution("exponential")
PMU_BASE = [np.random.default_rng(21).uniform(1, 30, size=(2, 3)),
            np.random.default_rng(22).uniform(1, 30, size=(2, 3))]
PCLASS_MIXES = np.array([[[3, 2], [7, 8]],       # (M, C, k): small latency
                         [[2, 4], [9, 5]]])      # class + a big batch class
PSEEDS = [0, 1]
P_COMP, P_WARM = 3000, 600
P_PT_TOL, P_MEAN_TOL = 0.2, 0.08


def _cfg(mu, cm, seed, order, **kw):
    return priority_sim_config(mu, cm, distribution=DIST, order=order,
                               power=POWER, n_completions=P_COMP,
                               warmup_completions=P_WARM, seed=seed, **kw)


def _gate(pairs):
    """pairs: (host SimMetrics, engine row dict) -> per-class rel errors,
    asserting the starvation rule."""
    x_rel, e_rel = [], []
    for h, d in pairs:
        assert h.class_throughput.sum() == pytest.approx(h.throughput,
                                                         rel=1e-9)
        assert d["class_throughput"].sum() == pytest.approx(
            d["throughput"], rel=1e-5)
        for c in range(len(h.class_throughput)):
            hx, dx = h.class_throughput[c], d["class_throughput"][c]
            if hx == 0 or dx == 0:
                assert hx < 0.02 * h.throughput, (c, hx, dx)
                assert dx < 0.02 * d["throughput"], (c, hx, dx)
                continue
            x_rel.append(abs(dx - hx) / hx)
            e_rel.append(abs(d["class_energy"][c] - h.class_energy[c])
                         / h.class_energy[c])
    assert max(x_rel) < P_PT_TOL and max(e_rel) < P_PT_TOL, (x_rel, e_rel)
    assert np.mean(x_rel) < P_MEAN_TOL and np.mean(e_rel) < P_MEAN_TOL, \
        (x_rel, e_rel)


def _rows(res, i):
    return {k: v[i] for k, v in res.items() if k != "device"}


@pytest.mark.parametrize("order", ["PS", "PRIO"])
@pytest.mark.parametrize("policy", ["grin-p", "lb", "jsq"])
def test_engine_per_class_conformance_with_host_core(policy, order):
    pol = (get_policy("grin-p", weights=[3.0, 1.0]) if policy == "grin-p"
           else get_policy(policy))
    grid, dev = sweep(_cfg(PMU_BASE[0], PCLASS_MIXES[0], PSEEDS[0], order),
                      pol, mixes=flatten_mixes(PCLASS_MIXES), seeds=PSEEDS,
                      mus=np.stack([flat_mu(m, 2) for m in PMU_BASE]),
                      device=CPU)
    pairs = []
    for i, (g, mix, s) in enumerate(grid):
        cm = mix.reshape(2, 2)
        h = ClosedNetworkSimulator(_cfg(PMU_BASE[g], cm, s, order),
                                   device=CPU).run(pol)
        pairs.append((h, _rows(dev, i)))
    _gate(pairs)


@pytest.mark.parametrize("variant", ["class_distributions", "type_mix"])
def test_engine_distributions_and_type_mix_held_to_host_core(variant):
    """The grid again under PRIO with per-class sizes (uniform latency
    class, exponential batch class), or with each program's next type
    re-drawn from the class mix's proportions. Under `type_mix` the engine
    pins the deficit target at the expected mix (the reference engine's
    quasi-static rule), so the host core is held to the same rule: it
    routes toward that pinned target (a `fixed` policy). Against a host
    core that re-solves at every realised mix, both engines (the
    reference's too) sit high, beyond the mean gate (ROADMAP queue C)."""
    pol = get_policy("grin-p", weights=[3.0, 1.0])
    points = [(g, cm, s) for g in range(len(PMU_BASE))
              for cm in PCLASS_MIXES for s in PSEEDS]

    def kw(cm):
        if variant == "type_mix":
            return {"type_mix": cm.reshape(-1) / cm.sum()}
        return {"class_distributions": (make_distribution("uniform"), DIST)}
    cfgs = [_cfg(PMU_BASE[g], cm, s, "PRIO", **kw(cm)) for g, cm, s in points]
    pinned = [pol.solve_target(c.mu, _cfg_mix_and_types0(c)[0]) for c in cfgs]
    dev = simulate_batch(
        np.stack([c.mu for c in cfgs]), np.stack(pinned),
        np.stack([_cfg_mix_and_types0(c)[1] for c in cfgs]),
        [c.seed for c in cfgs], distribution=DIST, order="PRIO",
        n_completions=P_COMP, warmup_completions=P_WARM, power=POWER,
        class_of_type=cfgs[0].class_of_type,
        class_distributions=cfgs[0].class_distributions,
        type_mix=(np.stack([c.type_mix for c in cfgs])
                  if variant == "type_mix" else None), device=CPU)
    pairs = []
    for i, (cfg, target) in enumerate(zip(cfgs, pinned)):
        host_pol = (get_policy("fixed", target=target)
                    if variant == "type_mix" else pol)
        h = ClosedNetworkSimulator(cfg, device=CPU).run(host_pol)
        pairs.append((h, _rows(dev, i)))
    _gate(pairs)


def test_c1_engine_metrics_equal_metrics_without_classes():
    rng = np.random.default_rng(13)
    base = dict(mu=rng.uniform(1, 30, (3, 3)),
                n_programs_per_type=np.array([10, 10, 10]),
                distribution=DIST, order="PRIO", n_completions=1500,
                warmup_completions=300, seed=3)
    plain = simulate_policy(SimConfig(**base), "grin", device=CPU)
    tagged = simulate_policy(SimConfig(class_of_type=np.zeros(3, np.int64),
                                       **base), get_policy("grin-p"),
                             device=CPU)
    fcfs = simulate_policy(SimConfig(**dict(base, order="FCFS")), "grin",
                           device=CPU)
    for name in ("throughput", "mean_response_time", "mean_energy",
                 "mean_power", "state_occupancy", "class_throughput",
                 "class_response_time", "class_energy", "class_occupancy"):
        a = np.asarray(getattr(plain, name))
        np.testing.assert_array_equal(a, np.asarray(getattr(tagged, name)))
        # one class: PRIO is FCFS
        np.testing.assert_array_equal(a, np.asarray(getattr(fcfs, name)))
    assert plain.class_throughput.shape == (1,)


def test_prio_cuts_the_latency_class_response_time():
    rng = np.random.default_rng(18)
    mu = rng.uniform(1, 30, (2, 3))
    mixes = np.array([[2, 1], [7, 10]])
    pol = get_policy("grin-p", weights=[8.0, 1.0])
    rt = {}
    for order in ("FCFS", "PRIO"):
        cfg = priority_sim_config(mu, mixes, distribution=DIST, order=order,
                                  n_completions=P_COMP,
                                  warmup_completions=P_WARM, seed=2)
        host = ClosedNetworkSimulator(cfg, device=CPU).run(pol)
        dev = simulate_policy(cfg, pol, device=CPU)
        assert dev.class_response_time[0] == pytest.approx(
            host.class_response_time[0], rel=0.15)
        rt[order] = dev.class_response_time[0]
    assert rt["PRIO"] < rt["FCFS"]
