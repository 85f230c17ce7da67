"""Port parity: stochastic availability (`repro_torch.faults.hazard`) and
the closed device engine's fault inputs.

Host pieces bit-equal to the reference on the same inputs: the Weibull
algebra, the up/down realizations (per-pool streams [seed, 4, pool]), the
hazard scenarios and the restart-vs-resume economics; the torch twins at
float32 (rtol 1e-5 against the reference's JAX twins). The closed engine:
a scenario that never fires, a null process and telemetry off leave a run
bit for bit as it was; an unreachable checkpoint age equals no
checkpoints bit for bit; with storms, transient failures and checkpoints
its runs meet the engine gates (15% per run, 5% mean on X and E/task)
against the port's host fault loop, which is bit-equal to the
reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro.faults import hazard as RH  # noqa: E402
from repro_torch.faults import (FaultScenario, UpDownProcess,  # noqa: E402
                                age_checkpoint_policy, build_fault_batch,
                                completion_forecast,
                                completion_forecast_torch, crash,
                                expected_completion_exp,
                                expected_completion_exp_torch,
                                expected_completion_weibull,
                                make_hazard_scenario, make_storm,
                                optimal_ckpt_period, realize_availability,
                                weibull_theta)
from repro_torch.faults import hazard as PH  # noqa: E402
from repro_torch.sched import get_policy  # noqa: E402
from repro_torch.sim import (ClosedNetworkSimulator,  # noqa: E402
                             SimConfig, compare_policies, make_distribution,
                             simulate_batch, simulate_policy, sweep)

CPU = "cpu"
MU = np.random.default_rng(31).uniform(1, 30, size=(3, 3))
MIX = np.array([6, 6, 6])
DIST = make_distribution("exponential")
PROCS = [UpDownProcess(mtbf=20.0, mttr=4.0, up_shape=1.7, down_shape=0.9),
         UpDownProcess(mtbf=15.0, mttr=3.0, up_shape=2.0, pools=(1,)),
         UpDownProcess(mtbf=8.0, mttr=2.0, scale=0.4),
         UpDownProcess(mtbf=np.inf, mttr=1.0)]
NEVER = FaultScenario(events=crash(1, 1e9, 2e9))


def _rproc(p):
    return RH.UpDownProcess(**dataclasses.asdict(p))


@pytest.mark.parametrize("shape", [0.7, 1.0, 2.2])
def test_weibull_algebra_bit_equal(shape):
    t = np.linspace(0.0, 9.0, 31)
    assert weibull_theta(3.0, shape) == RH.weibull_theta(3.0, shape)
    np.testing.assert_array_equal(PH.weibull_hazard(t, 3.0, shape),
                                  RH.weibull_hazard(t, 3.0, shape))
    np.testing.assert_array_equal(PH.weibull_cum_hazard(t, 3.0, shape),
                                  RH.weibull_cum_hazard(t, 3.0, shape))
    with pytest.raises(ValueError):
        weibull_theta(1.0, 0.0)


@pytest.mark.parametrize("i", range(len(PROCS)))
@pytest.mark.parametrize("seed", [0, 5])
def test_realizations_bit_equal(i, seed):
    p = PROCS[i]
    ev = realize_availability(p, 3, 100.0, seed)
    ref = RH.realize_availability(_rproc(p), 3, 100.0, seed)
    assert [(e.time, e.pool, e.scale) for e in ev] == \
        [(e.time, e.pool, e.scale) for e in ref]
    sc = make_hazard_scenario(p, 3, 100.0, seed, fail_prob=0.01,
                              ckpt_period=0.5)
    rs = RH.make_hazard_scenario(_rproc(p), 3, 100.0, seed, fail_prob=0.01,
                                 ckpt_period=0.5)
    assert sc.name == rs.name
    a, b = sc.realize(3), rs.realize(3)
    np.testing.assert_array_equal(a.times, b.times)
    np.testing.assert_array_equal(a.scale, b.scale)
    if p.is_null:
        assert ev == () and make_hazard_scenario(p, 3, 100.0, seed).is_null


def test_updown_validation_matches_reference():
    for kw in (dict(mtbf=0.0, mttr=1.0), dict(mtbf=1.0, mttr=np.inf),
               dict(mtbf=1.0, mttr=1.0, up_shape=0.0),
               dict(mtbf=1.0, mttr=1.0, scale=1.0),
               dict(mtbf=1.0, mttr=1.0, pools=())):
        with pytest.raises(ValueError):
            UpDownProcess(**kw)
        with pytest.raises(ValueError):
            RH.UpDownProcess(**kw)
    with pytest.raises(ValueError):
        realize_availability(PROCS[0], 3, np.inf, 0)


@pytest.mark.parametrize("shape", [1.0, 2.2, 0.8])
def test_restart_economics_bit_equal(shape):
    w = np.array([0.1, 0.5, 2.0])
    np.testing.assert_array_equal(expected_completion_exp(w, 0.3, 0.05),
                                  RH.expected_completion_exp(w, 0.3, 0.05))
    for wi in (0.0, 0.7, 3.0):
        assert expected_completion_weibull(wi, 4.0, shape, 0.1) == \
            RH.expected_completion_weibull(wi, 4.0, shape, 0.1)
    ages = np.array([0.0, 0.4, 1.9, 2.5])
    np.testing.assert_array_equal(
        completion_forecast(ages, 2.0, 4.0, shape, 0.1),
        RH.completion_forecast(ages, 2.0, 4.0, shape, 0.1))
    assert completion_forecast(0.3, 2.0, 4.0, shape, 0.1) == \
        RH.completion_forecast(0.3, 2.0, 4.0, shape, 0.1)
    assert optimal_ckpt_period(0.05, 0.2) == RH.optimal_ckpt_period(0.05,
                                                                     0.2)
    assert optimal_ckpt_period(0.0, 0.2) == np.inf
    assert age_checkpoint_policy(10.0, shape, 0.2) == \
        RH.age_checkpoint_policy(10.0, shape, 0.2)


@pytest.mark.parametrize("shape", [1.0, 2.2])
def test_torch_twins_match_reference_twins(shape):
    ages = np.array([0.0, 0.4, 1.9, 2.5])
    p = completion_forecast_torch(ages, 2.0, 4.0, shape, 0.1, device=CPU)
    r = np.asarray(RH.completion_forecast_jax(ages, 2.0, 4.0, shape, 0.1))
    assert p.dtype == torch.float32 and p.shape == (4,)
    np.testing.assert_allclose(p.numpy(), r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        p.numpy(), completion_forecast(ages, 2.0, 4.0, shape, 0.1),
        rtol=1e-4)
    w = np.array([0.1, 0.5, 2.0])
    np.testing.assert_allclose(
        expected_completion_exp_torch(w, 0.3, 0.05, device=CPU).numpy(),
        np.asarray(RH.expected_completion_exp_jax(w, 0.3, 0.05)),
        rtol=1e-6)


def _batch_kw(order="PS", modes=None, n=1500):
    return dict(distribution=DIST, order=order, n_completions=n,
                warmup_completions=n // 5, device=CPU, modes=modes,
                class_of_type=[0, 1, 1] if order == "PRIO" else None)


@pytest.mark.parametrize("order", ["PS", "FCFS", "PRIO"])
@pytest.mark.parametrize("mode", [0, 2, 3])
def test_never_firing_and_null_process_closed_device_bit_identical(order,
                                                                   mode):
    """The fault stanza with nothing to do (a scenario whose crash lies
    past the run, a null hazard process) and telemetry on leave every
    result as the fault-free run's, bit for bit."""
    tgt = np.asarray(get_policy("grin").solve_target(MU, MIX))[None]
    types0 = np.repeat(np.arange(3), 6)[None]
    kw = _batch_kw(order, [mode], n=600)
    base = simulate_batch(MU[None], tgt, types0, [7], **kw)
    runs = {"telemetry": simulate_batch(MU[None], tgt, types0, [7],
                                        telemetry_bins=6,
                                        telemetry_horizon=5.0, **kw)}
    for name, sc in (("never", NEVER),
                     ("null", make_hazard_scenario(PROCS[-1], 3, 100.0, 0))):
        fb = build_fault_batch([sc], MU[None], tgt, seeds=[7],
                               mode="closed", n_completions=600, device=CPU)
        runs[name] = simulate_batch(MU[None], tgt, types0, [7], faults=fb,
                                    **kw)
        assert int(runs[name]["failures"][0]) == 0
        assert int(runs[name]["topology_events"][0]) == 0
    for name, out in runs.items():
        for key in base:
            if key != "device":
                assert np.array_equal(np.asarray(base[key]),
                                      np.asarray(out[key])), (name, key)
    tel = runs["telemetry"]["telemetry"]
    assert tel["occupancy"].shape == (1, 6, 3) and (tel["hedges"] == 0).all()
    # a closed population: the charged occupancy is n programs a second
    occ = tel["occupancy"][0].sum() / 5.0
    np.testing.assert_allclose(occ, types0.shape[1], rtol=1e-4)


def test_ckpt_age_semantics_closed_device():
    tgt = np.asarray(get_policy("grin").solve_target(MU, MIX))[None]
    types0 = np.repeat(np.arange(3), 6)[None]
    base_kw = dict(events=crash(1, 6.0, 10.0), fail_prob=0.1)

    def run(sc):
        fb = build_fault_batch([sc], MU[None], tgt, seeds=[7], mode="closed",
                               n_completions=1500, device=CPU)
        return simulate_batch(MU[None], tgt, types0, [7], faults=fb,
                              **_batch_kw())

    full = run(FaultScenario(**base_kw))
    grid = run(FaultScenario(ckpt_period=0.02, **base_kw))
    aged = run(FaultScenario(ckpt_period=0.02, ckpt_age=50.0, **base_kw))
    # an unreachable age threshold is no checkpoints, bit for bit
    assert float(aged["wasted_work"][0]) == float(full["wasted_work"][0])
    assert float(aged["throughput"][0]) == float(full["throughput"][0])
    assert float(grid["wasted_work"][0]) < float(full["wasted_work"][0])
    assert int(full["failures"][0]) > 0 and full["completed"][0] == 1200


def _cfg(order, faults, seed=0, n=3000, warm=600):
    return SimConfig(mu=MU, n_programs_per_type=MIX, distribution=DIST,
                     order=order, n_completions=n, warmup_completions=warm,
                     seed=seed, faults=faults)


@pytest.mark.parametrize("order", ["PS", "FCFS"])
def test_closed_engine_with_faults_meets_gates_against_host(order):
    """A two-burst storm, 3% transient failures, checkpoints and refreshed
    targets: `compare_policies` over three seeds against the host fault
    loop, run for run; checkpoints cut the wasted work."""
    storm = make_storm(3, n_bursts=2, group_size=1, window=(10.0, 40.0),
                       downtime=6.0, seed=2)
    xs, es = [], []
    for ck in (None, 0.05):
        sc = FaultScenario(events=storm, fail_prob=0.03, ckpt_period=ck,
                           refresh_targets=True)
        rows = compare_policies(_cfg(order, sc), ["grin", "lb"],
                                seeds=[0, 1, 2], device=CPU)
        wasted = []
        for name, key in (("GrIn", "grin"), ("LB", "lb")):
            for s, m in zip([0, 1, 2], rows[name]):
                h = ClosedNetworkSimulator(_cfg(order, sc, seed=s),
                                           device=CPU).run(key)
                assert m.topology_events == h.topology_events >= 1
                assert m.completed == 2400 and m.failures > 0
                xs.append(abs(m.throughput - h.throughput) / h.throughput)
                es.append(abs(m.mean_energy - h.mean_energy)
                          / h.mean_energy)
                wasted.append(m.wasted_work)
        if ck is None:
            no_ckpt = np.mean(wasted)
    assert np.mean(wasted) < 0.6 * no_ckpt
    assert max(xs) < 0.15 and max(es) < 0.15
    assert np.mean(xs) < 0.05 and np.mean(es) < 0.05


def test_hazard_scenario_on_every_closed_entry_point():
    """simulate_policy, sweep and compare_policies take `cfg.faults` (a
    hazard-drawn scenario) and agree where they run the same point."""
    sc = make_hazard_scenario(
        UpDownProcess(mtbf=15.0, mttr=3.0, up_shape=2.2), 3, 60.0, 1,
        fail_prob=0.02, ckpt_period=0.05, refresh_targets=True)
    cfg = _cfg("PS", sc, n=800, warm=100)
    one = simulate_policy(cfg, "grin", device=CPU)
    grid, res = sweep(cfg, "grin", seeds=[0], device=CPU)
    rows = compare_policies(cfg, ["grin", "jsq"], device=CPU)
    assert one.topology_events >= 1
    assert one.throughput == float(res["throughput"][0]) \
        == rows["GrIn"].throughput
    assert one.wasted_work == float(res["wasted_work"][0])
    # a slower policy's run lasts longer and meets more of the schedule
    assert rows["JSQ"].topology_events >= one.topology_events
