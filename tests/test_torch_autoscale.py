"""Port parity: the autoscale governor (`repro_torch.sched.autoscale`).

The guarded candidate grid and the phantom mixes equal the reference's;
`price_frequency_grid` (one batched grid solve, big-M phantom guards)
returns the reference's targets exactly and its guard-corrected X and
J/task within 1e-3 relative (float32 solves of rows that carry rates up
to GUARD_W = 1e4); parked candidates price like host float64 solves of
the live submatrix (X within 5e-3, energy within 2e-2, the reference's
own tolerances); the governor, the threshold scaler and the fluid runner
make the reference's decisions on seeded traces; every decision epoch is
one grid solve backed by one batched solve; decisions reach an attached
core's recorder. The reference's unseeded hypothesis property
(`tests/test_autoscale.py:33`) is not carried over: it does not hold for
the greedy solve (ROADMAP queue C)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro.core import DVFSModel as RDVFS  # noqa: E402
from repro.core import PROPORTIONAL_POWER as RPP  # noqa: E402
from repro.core import grin_block_solve as rgrin  # noqa: E402
from repro.sched import autoscale as RA  # noqa: E402
from repro.traffic import make_load_traces as rtraces  # noqa: E402
from repro_torch.core import (DVFSModel, PROPORTIONAL_POWER,  # noqa: E402
                              grin_block_solve)
from repro_torch.obs import TraceRecorder  # noqa: E402
from repro_torch.sched import SchedulerCore  # noqa: E402
from repro_torch.sched import autoscale as PA  # noqa: E402
from repro_torch.sched.priority import GrInPriorityPolicy  # noqa: E402
from repro_torch.traffic import make_load_traces  # noqa: E402

CPU = "cpu"
LEVELS = (0.5, 0.75, 1.0, 1.25)
DVFS, RDV = DVFSModel(alpha=3.0, levels=LEVELS), RDVFS(alpha=3.0,
                                                        levels=LEVELS)
MU = np.array([[14.0, 3.0, 3.0, 2.0],      # benchmarks/fig_autoscale.py
               [2.0, 11.0, 3.0, 9.0],
               [4.0, 4.0, 8.0, 4.0]])
TYPE_PROBS = (0.4, 0.35, 0.25)
REL = 1e-3


def _grid(l, seed):
    rng = np.random.default_rng(seed)
    g = rng.choice([0.0, 0.5, 0.75, 1.0, 1.25], size=(9, l))
    g[0] = 1.0
    g[np.arange(9), np.arange(9) % l] = np.maximum(g[np.arange(9),
                                                     np.arange(9) % l], 0.5)
    return g


@pytest.mark.parametrize("seed", [0, 1])
def test_price_frequency_grid_equals_reference(seed):
    g = _grid(4, seed)
    mixes = np.array([[10, 8, 6], [3, 12, 9]])
    np.testing.assert_array_equal(
        PA.guarded_candidate_mus(MU, g, DVFS),
        RA.guarded_candidate_mus(MU, g, RDV))
    np.testing.assert_array_equal(PA.guarded_mixes(mixes, 4),
                                  RA.guarded_mixes(mixes, 4))
    P = PROPORTIONAL_POWER.power_matrix(MU)
    p = PA.price_frequency_grid(MU, P, g, mixes, DVFS, device=CPU)
    r = RA.price_frequency_grid(MU, RPP.power_matrix(MU), g, mixes, RDV)
    assert p["targets"].shape == (9, 2, 3, 4) and p["conv"].all()
    np.testing.assert_array_equal(p["targets"], r["targets"])
    np.testing.assert_array_equal(p["conv"], np.asarray(r["conv"]))
    np.testing.assert_allclose(p["x"], r["x"], rtol=REL)
    np.testing.assert_allclose(p["energy"], r["energy"], rtol=REL)
    # parked pools hold no real task
    for c in range(9):
        assert p["targets"][c][:, :, g[c] == 0].sum() == 0


def test_guard_encoding_matches_host_submatrix_solves():
    """The reference's guard check on the port: parked candidates price
    like the host float64 block solve of the live submatrix, a
    dump-site-bait slow type included."""
    rng = np.random.default_rng(7)
    mu = rng.uniform(2.0, 30.0, size=(3, 4))
    mu[2] = [1.0, 1.2, 0.9, 1.1]                     # slow everywhere
    mix = np.array([12, 9, 7])
    parked_sets = [[], [2], [1, 3], [0, 2, 3]]
    grid = np.ones((len(parked_sets), 4))
    for c, parked in enumerate(parked_sets):
        grid[c, parked] = 0.0
    P = PROPORTIONAL_POWER.power_matrix(mu)
    priced = PA.price_frequency_grid(mu, P, grid, mix[None, :], DVFS,
                                     device=CPU)
    for c, parked in enumerate(parked_sets):
        tg = priced["targets"][c, 0]
        assert tg[:, parked].sum() == 0
        assert np.array_equal(tg.sum(axis=1), mix)
        x_host, e_host = PA.price_config_host(mu, P, grid[c], mix, DVFS)
        assert x_host == rgrin(mu[:, [j for j in range(4)
                                      if j not in parked]], mix).x_sys
        assert abs(priced["x"][c, 0] - x_host) < 5e-3 * x_host
        assert abs(priced["energy"][c, 0] - e_host) < 2e-2 * e_host
    assert PA.price_config_host(mu, P, np.zeros(4), mix, DVFS) == \
        (0.0, np.inf)


def test_one_batched_solve_per_decision_epoch(monkeypatch):
    import repro_torch.sched.api as api
    grid_calls, dev_calls = [], []
    real_grid, real_dev = PA.solve_targets_grid_torch, \
        api.grin_solve_batch_torch

    def count_grid(mus, mixes, *a, **k):
        grid_calls.append(np.asarray(mus).shape)
        return real_grid(mus, mixes, *a, **k)

    def count_dev(*a, **k):
        dev_calls.append(1)
        return real_dev(*a, **k)

    monkeypatch.setattr(PA, "solve_targets_grid_torch", count_grid)
    monkeypatch.setattr(api, "grin_solve_batch_torch", count_dev)
    mu = np.random.default_rng(5).uniform(3.0, 25.0, size=(2, 3))
    gov = PA.AutoscaleGovernor(mu, dvfs=DVFS, device=CPU)
    for e in range(4):
        gov.observe([22.0, 11.0], 4.0)
        dec = gov.decide(now=4.0 * (e + 1))
        assert len(grid_calls) == len(dev_calls) == e + 1
        assert grid_calls[e] == (3 * 3 + 1, 2 + 3, 3 + 1)
        assert dec.n_candidates == 3 * 3 + 1
    assert gov.solve_calls == 4


def _controllers(pkg, dvfs, **kw):
    return {"static": lambda: pkg.StaticScaler(4),
            "naive": lambda: pkg.UtilizationScaler(4, dvfs),
            "governor": lambda: pkg.AutoscaleGovernor(
                MU, dvfs=dvfs, config=pkg.GovernorConfig(epoch=4.0,
                                                         headroom=1.15),
                **kw)}


@pytest.mark.parametrize("trace", ["diurnal", "bursty", "flash"])
def test_controllers_decide_like_the_reference(trace):
    """`benchmarks/fig_autoscale.py`'s workload cut to a 64 s horizon and
    one seed: the same frequency traces, goodput, energy and decisions."""
    mix = np.round(np.asarray(TYPE_PROBS) * 40).astype(np.int64)
    base = 0.70 * grin_block_solve(MU, mix).x_sys / 1.85
    kw = dict(base=base, horizon=64.0, period=32.0, amplitude=0.85)
    n = int(1.6 * base * 64.0) + 64
    times, types = make_load_traces(TYPE_PROBS, **kw)[trace].sample(0, n)
    rt, ry = rtraces(TYPE_PROBS, **kw)[trace].sample(0, n)
    np.testing.assert_array_equal(times, rt)
    pc, rc = _controllers(PA, DVFS, device=CPU), _controllers(RA, RDV)
    for name in pc:
        p = PA.run_autoscaled(MU, times, types, pc[name](), dvfs=DVFS,
                              epoch=4.0, queue_slots=400, horizon=64.0)
        r = RA.run_autoscaled(MU, rt, ry, rc[name](), dvfs=RDV, epoch=4.0,
                              queue_slots=400, horizon=64.0)
        np.testing.assert_array_equal(p.freq_trace, r.freq_trace)
        for f in ("served", "dropped", "energy", "goodput", "x_per_joule",
                  "mean_backlog"):
            assert getattr(p, f) == getattr(r, f), (name, f)
        assert len(p.decisions) == len(r.decisions)
        for a, b in zip(p.decisions, r.decisions):
            assert a.action == b.action and a.time == b.time
            np.testing.assert_array_equal(a.freqs, b.freqs)
            assert abs(a.x_cap - b.x_cap) <= REL * max(b.x_cap, 1.0)
            assert abs(a.power_pred - b.power_pred) <= \
                REL * max(b.power_pred, 1.0)
        if name == "governor":
            assert len(p.decisions) == len(p.times) == 16
            ev = PA.decisions_to_events(p.decisions, 4)
            rev = RA.decisions_to_events(r.decisions, 4)
            assert [(e.time, e.pool, e.scale) for e in ev] == \
                [(e.time, e.pool, e.scale) for e in rev]


def test_governor_under_budget_and_on_a_live_core():
    """Power-cap emergencies, the minimum active pool count, the actions
    on a live core, and the decision records through its recorder."""
    rec = TraceRecorder()
    mu = MU[:2, :3]
    core = SchedulerCore(GrInPriorityPolicy((2.0, 1.0)), mu, recorder=rec,
                         device=CPU)
    pg = PA.AutoscaleGovernor(mu, dvfs=DVFS, core=core,
                              budget=PA.BudgetSpec(power_cap=1.0),
                              config=PA.GovernorConfig(min_active=2,
                                                       hysteresis=0.0))
    rg = RA.AutoscaleGovernor(mu, dvfs=RDV,
                              budget=RA.BudgetSpec(power_cap=1.0),
                              config=RA.GovernorConfig(min_active=2,
                                                       hysteresis=0.0))
    assert pg.device == core.device
    live = [0, 1, 2]
    for e in range(6):
        for g in (pg, rg):
            g.observe([9.0, 4.0] if e < 3 else [0.5, 0.2], 1.0)
        dp, dr = pg.decide(now=float(e)), rg.decide(now=float(e))
        assert dp.action == dr.action
        np.testing.assert_array_equal(dp.freqs, dr.freqs)
        assert (dp.freqs > 0).sum() >= 2
        live = pg.apply_to_core(core, dp, live)
        assert core.l == len(live) == int((dp.freqs > 0).sum())
    gov = [ev for ev in rec.events if ev.layer == "governor"]
    assert len(gov) == 6 and gov[0].kind == "decision" and gov[-1].t == 5.0
    assert gov[0].data["freqs"] == list(pg.decisions[0].freqs)
    assert gov[0].data["power_cap"] == 1.0
