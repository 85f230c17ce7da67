"""Port parity: the batched closed-network engine (`repro_torch.sim`).

The engines draw task sizes from different random streams (torch
generators vs numpy / JAX), so parity is statistical: the port's device
engine is held to the reference's host event core — the oracle — at the
`tests/test_conformance.py` gates (per point 15%, grid mean 5%, on X and
E/task), and to the JAX engine on the same grid. Structural identities
(Little's law, power integral / X == per-completion E) hold exactly as the
model predicts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro.core.affinity import PowerModel as RPower  # noqa: E402
from repro.sim import ClosedNetworkSimulator, sweep_jax  # noqa: E402
from repro.sim import SimConfig as RCfg  # noqa: E402
from repro.sim import make_distribution as rdist  # noqa: E402
from repro_torch.core.affinity import PowerModel  # noqa: E402
from repro_torch.sched import get_policy  # noqa: E402
from repro_torch.sim import (SimConfig, compare_policies,  # noqa: E402
                             make_distribution, simulate_batch,
                             simulate_policy, sweep)

MUS = np.stack([np.random.default_rng(11).uniform(1, 30, size=(3, 3)),
                np.random.default_rng(12).uniform(1, 30, size=(3, 3))])
MIXES = np.array([[10, 10, 10], [6, 14, 10]])
SEEDS = [0, 1]
N_COMPLETIONS, WARMUP = 4000, 800
PT_TOL, MEAN_TOL = 0.15, 0.05


def _cfg(order, mu=MUS[0], mix=MIXES[0], seed=0, dist="exponential",
         n=N_COMPLETIONS, warm=WARMUP):
    return SimConfig(mu=mu, n_programs_per_type=np.asarray(mix),
                     distribution=make_distribution(dist), order=order,
                     power=PowerModel(alpha=0.5), n_completions=n,
                     warmup_completions=warm, seed=seed)


def _host(policy, order, g, mix, seed):
    return ClosedNetworkSimulator(RCfg(
        mu=MUS[g], n_programs_per_type=np.asarray(mix),
        distribution=rdist("exponential"), order=order,
        power=RPower(alpha=0.5), n_completions=N_COMPLETIONS,
        warmup_completions=WARMUP, seed=seed)).run(policy)


@pytest.mark.parametrize("policy,order", [("grin", "PS"), ("grin", "FCFS"),
                                          ("lb", "PS"), ("jsq", "FCFS"),
                                          ("rd", "PS"), ("bf", "FCFS")])
def test_engine_conformance_with_host_oracle(policy, order):
    grid, dev = sweep(_cfg(order), policy, mixes=MIXES, seeds=SEEDS,
                      mus=MUS, device="cpu")
    assert [(g, s) for g, _, s in grid] == [
        (g, s) for g in range(2) for _ in MIXES for s in SEEDS]
    x_rel, e_rel = [], []
    for i, (g, mix, s) in enumerate(grid):
        h = _host(policy, order, g, mix, s)
        x_rel.append(abs(dev["throughput"][i] - h.throughput) / h.throughput)
        e_rel.append(abs(dev["mean_energy"][i] - h.mean_energy)
                     / h.mean_energy)
        assert dev["little_product"][i] == pytest.approx(30, rel=0.05)
        assert dev["mean_power"][i] / dev["throughput"][i] == pytest.approx(
            dev["mean_energy"][i], rel=0.03)
    assert max(x_rel) < PT_TOL and max(e_rel) < PT_TOL, (x_rel, e_rel)
    assert np.mean(x_rel) < MEAN_TOL and np.mean(e_rel) < MEAN_TOL


def test_engine_agrees_with_jax_engine():
    rc = RCfg(mu=MUS[0], n_programs_per_type=MIXES[0],
              distribution=rdist("exponential"), order="PS",
              power=RPower(alpha=0.5), n_completions=N_COMPLETIONS,
              warmup_completions=WARMUP, seed=0)
    _, jx = sweep_jax(rc, "grin", mixes=MIXES, seeds=SEEDS, mus=MUS)
    _, tx = sweep(_cfg("PS"), "grin", mixes=MIXES, seeds=SEEDS, mus=MUS,
                  device="cpu")
    for key in ("throughput", "mean_energy"):
        rel = np.abs(tx[key] - jx[key]) / jx[key]
        assert rel.max() < PT_TOL and rel.mean() < MEAN_TOL, (key, rel)
    assert tx["state_occupancy"].shape == jx["state_occupancy"].shape
    np.testing.assert_allclose(tx["state_occupancy"].sum(axis=(1, 2)), 30,
                               rtol=0.05)


def test_compare_policies_and_single_runs():
    cfg = _cfg("PS", n=1500, warm=300)
    pinned = np.array([[10, 0, 0], [0, 10, 0], [0, 0, 10]])
    rows = compare_policies(
        cfg, ["grin", "grin-e", "lb", "jsq",
              get_policy("fixed", target=pinned),
              get_policy("fixed", target=pinned)], seeds=[0, 1],
        device="cpu")
    assert list(rows) == ["GrIn", "GrIn-E", "LB", "JSQ", "Opt", "Opt#2"]
    assert all(len(v) == 2 for v in rows.values())
    x = {k: np.mean([m.throughput for m in v]) for k, v in rows.items()}
    assert x["GrIn"] >= x["LB"]
    assert rows["GrIn"][0].meta["kernel_mode"] == "torch-reference"
    assert rows["GrIn"][0].class_throughput.sum() == pytest.approx(
        rows["GrIn"][0].throughput, rel=1e-6)
    single = simulate_policy(cfg, "grin", device="cpu")
    assert single.throughput == pytest.approx(rows["GrIn"][0].throughput,
                                              rel=1e-6)   # same seed stream


@pytest.mark.parametrize("dist", ["uniform", "constant", "bounded_pareto",
                                  "hyperexp", "weibull"])
def test_size_distributions_have_unit_mean(dist):
    from repro_torch.sim.engine_torch import _draws
    sizes, rd, _ = _draws([0, 1], 20000, (make_distribution(dist),), 4,
                          torch.device("cpu"))
    sizes = sizes[0]
    assert sizes.shape == (20000, 2) and (sizes > 0).all()
    assert float(sizes.mean()) == pytest.approx(1.0, rel=0.06)
    assert int(rd.min()) >= 0 and int(rd.max()) == 3


def test_engine_validates_inputs(monkeypatch):
    t0 = np.zeros((1, 4), dtype=np.int64)
    tgt = np.zeros((1, 3, 3), dtype=np.int64)
    kw = dict(distribution=make_distribution("exponential"),
              n_completions=50, warmup_completions=10, device="cpu")
    with pytest.raises(ValueError, match="unknown order"):
        simulate_batch(MUS[0], tgt, t0, [0], order="LIFO", **kw)
    # the closed engine takes no fault inputs yet (ROADMAP A4); open
    # traffic has its own engine, and sweeps of it go there
    from repro_torch.faults import FaultScenario, crash
    cfg = _cfg("PS", n=50, warm=10)
    cfg.faults = FaultScenario(events=crash(0, 1.0, 2.0))
    with pytest.raises(NotImplementedError, match="A4"):
        simulate_policy(cfg, "grin", device="cpu")
    cfg.faults, cfg.traffic = None, object()
    with pytest.raises(ValueError, match="simulate_open_batch"):
        sweep(cfg, "grin", device="cpu")
    with pytest.raises(ValueError, match="warmup"):
        simulate_batch(MUS[0], tgt, t0, [0], **dict(kw, warmup_completions=50))
    with pytest.raises(ValueError, match="all mixes"):
        sweep(_cfg("PS"), "grin", mixes=np.array([[1, 1, 1]]), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_batch(MUS[0], tgt, t0, [0], **{k: v for k, v in kw.items()
                                                if k != "device"})
