"""Port parity: fault injection (`repro_torch.faults`).

Host pieces against the reference, on the same inputs: storm generation,
realization and per-arrival failure counts bit-equal (the reference's
goldens included); `segment_targets` equal int64 targets with and without
refresh; `build_fault_batch` equal arrays; the host fault loops
(`run_open_faults`, `run_closed_faults`) the reference's SimMetrics at
rtol 1e-12; `route_backup` and the masked device router decision-equal.
The open engine with faults is held to the port's host fault loop on a
reduced `benchmarks/fig_faults.py` grid at the traffic gates, and a
scenario that never fires must leave the engine's run as it was."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro import faults as RF  # noqa: E402
from repro.sched import get_policy as rget  # noqa: E402
from repro.sched.api import SchedulerCore as RCore  # noqa: E402
from repro.sched.api import deficit_route_masked_jax  # noqa: E402
from repro.sim import ClosedNetworkSimulator as RSim  # noqa: E402
from repro.sim import SimConfig as RCfg  # noqa: E402
from repro.sim import make_distribution as rdist  # noqa: E402
from repro.traffic import PoissonArrivals as RPA  # noqa: E402
from repro.traffic import TrafficSpec as RTS  # noqa: E402
from repro.traffic.config import open_sim_config as ropen  # noqa: E402
from repro_torch import faults as PF  # noqa: E402
from repro_torch.sched import get_policy  # noqa: E402
from repro_torch.sched.api import (SchedulerCore, SystemView,  # noqa: E402
                                   deficit_route_masked_torch,
                                   deficit_route_torch)
from repro_torch.sim import (ClosedNetworkSimulator,  # noqa: E402
                             SimConfig, make_distribution, simulate_policy)
from repro_torch.sim.engine_torch import (MODE_DEFICIT,  # noqa: E402
                                          _BASELINE_MODES)
from repro_torch.traffic import (PoissonArrivals, TrafficSpec,  # noqa: E402
                                 open_sim_config, simulate_open_batch)

RTOL = 1e-12
CPU = "cpu"
MU = np.array([[12.0, 2.0, 2.0, 1.5], [1.5, 9.0, 2.0, 8.0]])  # fig_faults
SHARES = np.array([0.25, 0.75])
MIX = np.array([2, 6])
FIELDS = ("throughput", "mean_response_time", "mean_energy",
          "little_product", "completed", "elapsed", "state_occupancy",
          "mean_power", "class_throughput", "class_energy", "goodput",
          "wasted_work", "failures", "topology_events", "reroute_latency",
          "recovery_time", "spec_hedges", "offered", "dropped",
          "class_dropped", "class_quantiles")
X_REL, P99_REL, P_PT_TOL, P_MEAN_TOL = 0.05, 0.30, 0.2, 0.08


def _assert_metrics_equal(p, r, fields=FIELDS):
    for f in fields:
        a, b = getattr(p, f), getattr(r, f)
        if b is None:
            assert a is None, f
            continue
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=RTOL, err_msg=f)


def _storm(pkg, l, **kw):
    kw = {"n_bursts": 2, "group_size": 2, "window": (20.0, 50.0),
          "downtime": 6.0, "seed": 3, **kw}
    return pkg.make_storm(l, **kw)


def test_storms_realizations_and_failure_counts_are_bit_equal():
    for kw in ({}, {"n_bursts": 3, "seed": 11, "downtime": 40.0},
               {"scale": 0.25, "seed": 4}):
        r, p = _storm(RF, 4, **kw), _storm(PF, 4, **kw)
        assert [(e.time, e.pool, e.scale) for e in r] \
            == [(e.time, e.pool, e.scale) for e in p]
        rr = RF.FaultScenario(events=r).realize(4)
        pr = PF.FaultScenario(events=p).realize(4)
        np.testing.assert_array_equal(rr.times, pr.times)
        np.testing.assert_array_equal(rr.scale, pr.scale)
        np.testing.assert_array_equal(rr.padded(9).times, pr.padded(9).times)
    # the reference's goldens (tests/test_faults.py)
    storm = _storm(PF, 3)
    assert [(e.time, e.pool, e.scale) for e in storm][:2] == [
        (23.08398844894454, 1, 0.0), (29.08398844894454, 1, 1.0)]
    sc = PF.FaultScenario(fail_prob=0.3)
    assert sc.fail_counts(7, 20).tolist() == [1, 3, 1, 0, 0, 0, 0, 0, 0, 3,
                                              4, 0, 0, 0, 1, 1, 1, 0, 0, 0]
    for seed in (0, 8):
        np.testing.assert_array_equal(
            sc.fail_counts(seed, 300),
            RF.FaultScenario(fail_prob=0.3).fail_counts(seed, 300))
    a = PF.crash(0, 2.0, 5.0) + PF.degrade(1, 1.0, 0.5, 4.0)
    b = PF.degrade(0, 3.0, 0.5)
    comp = PF.compose_event_streams(a, b, 2)
    ref = RF.compose_event_streams(
        RF.crash(0, 2.0, 5.0) + RF.degrade(1, 1.0, 0.5, 4.0),
        RF.degrade(0, 3.0, 0.5), 2)
    assert [(e.time, e.pool, e.scale) for e in comp] \
        == [(e.time, e.pool, e.scale) for e in ref]
    assert PF.FaultScenario(events=PF.crash(0, 1.0, 2.0), ckpt_period=0.5,
                            ckpt_age=0.2).preserved_work(1.3) \
        == RF.FaultScenario(events=RF.crash(0, 1.0, 2.0), ckpt_period=0.5,
                            ckpt_age=0.2).preserved_work(1.3)
    with pytest.raises(ValueError):
        PF.FaultScenario(events=PF.crash(0, 5.0, 9.0) + PF.crash(1, 5.0, 9.0)
                         ).realize(2, require_alive=True)


@pytest.mark.parametrize("policy", ["grin", "grin-p", "cab-p", "grin-e"])
@pytest.mark.parametrize("refresh", [False, True])
def test_segment_targets_equal_the_reference(policy, refresh):
    mu = MU if policy != "cab-p" else MU[:, :2]
    kw = {"weights": [2.0, 1.0]} if policy.endswith("-p") else {}
    events = (_storm(PF, mu.shape[1], n_bursts=3, group_size=1)
              + PF.degrade(mu.shape[1] - 1, 60.0, 0.3, 70.0))
    r_events = tuple(RF.PoolEvent(e.time, e.pool, e.scale) for e in events)
    pr = PF.FaultScenario(events=events).realize(mu.shape[1])
    rr = RF.FaultScenario(events=r_events).realize(mu.shape[1])
    p = PF.segment_targets(get_policy(policy, **kw), mu, MIX, pr,
                           refresh=refresh, device=CPU)
    r = RF.segment_targets(rget(policy, **kw), mu, MIX, rr, refresh=refresh)
    assert p.dtype == np.int64
    np.testing.assert_array_equal(p, r)


def test_fault_batches_equal_the_reference():
    pol_p, pol_r = (get_policy("grin-p", weights=[2.0, 1.0]),
                    rget("grin-p", weights=[2.0, 1.0]))
    tgt = np.asarray(pol_p.solve_target(MU, MIX))
    kw = dict(fail_prob=0.1, ckpt_period=0.05, hedge_classes=(0,),
              hedge_quantile=0.9, refresh_targets=True)
    ps = [PF.FaultScenario(events=_storm(PF, 4), **kw), PF.FaultScenario()]
    rs = [RF.FaultScenario(events=_storm(RF, 4), **kw), RF.FaultScenario()]
    p = PF.build_fault_batch(ps, MU, tgt, seeds=[3, 4], mode="open",
                             policies=pol_p, mixes=MIX, n_arrivals=200,
                             n_classes=2, device=CPU)
    r = RF.build_fault_batch(rs, MU, tgt, seeds=[3, 4], mode="open",
                             policies=pol_r, mixes=MIX, n_arrivals=200,
                             n_classes=2)
    for f in ("times", "scale", "seg_targets", "ckpt_period",
              "restart_overhead", "extra_steps", "fail_counts", "hedge",
              "ckpt_age", "hedge_q", "hedge_min"):
        np.testing.assert_array_equal(np.asarray(getattr(p, f)),
                                      np.asarray(getattr(r, f)), err_msg=f)
    pc = PF.build_fault_batch([PF.FaultScenario(fail_prob=0.05)], MU, tgt,
                              seeds=[0], mode="closed", n_completions=900,
                              device=CPU)
    rc = RF.build_fault_batch([RF.FaultScenario(fail_prob=0.05)], MU, tgt,
                              seeds=[0], mode="closed", n_completions=900)
    assert pc.extra_steps == rc.extra_steps


def _open_pair(order, policy_kw, seed=2, n=1500, **fault_kw):
    """The same open fault config on both packages."""
    xk = 1.0 / max(s / MU[c].max() for c, s in enumerate(SHARES))
    storm = dict(n_bursts=2, group_size=2, window=(30.0, 80.0),
                 downtime=10.0, seed=11)
    rc = ropen(MU, RTS(tuple(RPA(1.1 * xk * s) for s in SHARES), np.eye(2)),
               n_arrivals=n, warmup_arrivals=n // 10, queue_capacity=8,
               class_of_type=[0, 1], target_mix=MIX,
               distribution=rdist("exponential"), order=order, seed=seed,
               faults=RF.FaultScenario(events=RF.make_storm(4, **storm),
                                       **fault_kw))
    pc = open_sim_config(
        MU, TrafficSpec(tuple(PoissonArrivals(1.1 * xk * s) for s in SHARES),
                        np.eye(2)),
        n_arrivals=n, warmup_arrivals=n // 10, queue_capacity=8,
        class_of_type=[0, 1], target_mix=MIX,
        distribution=make_distribution("exponential"), order=order,
        seed=seed, faults=PF.FaultScenario(events=PF.make_storm(4, **storm),
                                           **fault_kw))
    return rc, pc


@pytest.mark.parametrize("policy,order,fault_kw", [
    ("grin-p", "PS", dict(fail_prob=0.05, refresh_targets=True,
                          hedge_classes=(0,))),
    ("grin-p", "PRIO", dict(fail_prob=0.05, refresh_targets=True,
                            ckpt_period=0.05, restart_overhead=0.01)),
    ("grin", "FCFS", dict(fail_prob=0.02, hedge_quantile=0.9,
                          hedge_min_obs=16, ckpt_period=0.1, ckpt_age=0.05)),
    ("lb", "PS", dict(fail_prob=0.05, hedge_classes=(0,))),
    ("jsq", "PRIO", dict(fail_prob=0.05, hedge_quantile=0.8,
                         hedge_min_obs=8)),
    ("rd", "FCFS", dict(fail_prob=0.05))])
def test_host_open_fault_loop_is_bit_equal(policy, order, fault_kw):
    rc, pc = _open_pair(order, None, **fault_kw)
    kw = {"weights": [2.0, 1.0]} if policy == "grin-p" else {}
    r = RSim(rc).run(rget(policy, **kw))
    p = ClosedNetworkSimulator(pc, device=CPU).run(get_policy(policy, **kw))
    _assert_metrics_equal(p, r)
    assert p.topology_events == 2 and p.failures > 0


@pytest.mark.parametrize("policy,order", [("grin", "PS"), ("lb", "FCFS"),
                                          ("jsq", "PRIO"), ("rd", "PS")])
def test_host_closed_fault_loop_is_bit_equal(policy, order):
    mu = np.random.default_rng(31).uniform(1, 30, size=(3, 3))
    kw = dict(fail_prob=0.05, ckpt_period=0.02, refresh_targets=True)
    storm = dict(n_bursts=2, group_size=1, window=(5.0, 15.0), downtime=3.0,
                 seed=2)
    rc = RCfg(mu=mu, n_programs_per_type=np.array([6, 6, 6]),
              distribution=rdist("exponential"), order=order,
              n_completions=1500, warmup_completions=300, seed=7,
              faults=RF.FaultScenario(events=RF.make_storm(3, **storm),
                                      **kw))
    pc = SimConfig(mu=mu, n_programs_per_type=np.array([6, 6, 6]),
                   distribution=make_distribution("exponential"), order=order,
                   n_completions=1500, warmup_completions=300, seed=7,
                   faults=PF.FaultScenario(events=PF.make_storm(3, **storm),
                                           **kw))
    r = RSim(rc).run(policy)
    p = ClosedNetworkSimulator(pc, device=CPU).run(policy)
    _assert_metrics_equal(p, r, [f for f in FIELDS if f not in (
        "class_quantiles", "offered", "dropped", "class_dropped",
        "spec_hedges")])
    assert np.isnan(p.recovery_time) and p.failures > 0
    # the closed device engine takes no fault inputs yet
    with pytest.raises(NotImplementedError, match="A4"):
        simulate_policy(pc, policy, device=CPU)


@pytest.mark.parametrize("policy", ["grin", "lb", "jsq", "rd", "bf"])
def test_route_backup_is_decision_equal(policy):
    mu = np.random.default_rng(5).uniform(1, 30, size=(3, 4))
    r, p = RCore(policy, mu, seed=3), SchedulerCore(policy, mu, seed=3,
                                                    device=CPU)
    rng = np.random.default_rng(0)
    for step in range(80):
        t = int(rng.integers(3))
        avail = rng.random(4) > 0.3 if step % 2 else None
        excl = int(rng.integers(-1, 4))
        if policy in ("grin",):
            view = None
        else:
            view = SystemView(counts=r.counts, backlog_work=r.backlog_work,
                              backlog_tasks=r.counts.sum(axis=0), mu=mu)
        jr = r.route_backup(t, excl, avail=avail, view=view,
                            rng=np.random.default_rng(step))
        jp = p.route_backup(t, excl, avail=avail, view=view,
                            rng=np.random.default_rng(step))
        assert jr == jp
        np.testing.assert_array_equal(r.counts, p.counts)
        if step % 3 == 0:
            jj = r.route(t)
            assert p.route(t) == jj


def test_masked_device_router_is_decision_equal():
    rng = np.random.default_rng(9)
    k, l, B = 4, 6, 64
    tgt = rng.integers(0, 9, size=(B, k, l))
    cnt = rng.integers(0, 9, size=(B, k, l))
    rank = np.stack([np.argsort(np.argsort(-rng.uniform(size=(k, l)), 1), 1)
                     for _ in range(B)])
    t = rng.integers(0, k, size=B)
    avail = rng.random((B, l)) > 0.4
    avail[:, 0] |= ~avail.any(axis=1)
    tt = [torch.as_tensor(a) for a in (tgt, rank, cnt, t)]
    masked = deficit_route_masked_torch(*tt, torch.as_tensor(avail)).numpy()
    ref = [int(deficit_route_masked_jax(tgt[b], rank[b], cnt[b], t[b],
                                        avail[b])) for b in range(B)]
    np.testing.assert_array_equal(masked, ref)
    assert avail[np.arange(B), masked].all()
    up = torch.ones((B, l), dtype=torch.bool)
    np.testing.assert_array_equal(
        deficit_route_masked_torch(*tt, up).numpy(),
        deficit_route_torch(*tt).numpy())
    for b in range(8):                  # the unbatched form
        np.testing.assert_array_equal(
            deficit_route_masked_torch(*[x[b] for x in tt],
                                       torch.as_tensor(avail[b])).numpy(),
            masked[b])


def _open_batch(faults, order="PS", mode=MODE_DEFICIT):
    tgt = np.asarray(get_policy("grin").solve_target(MU, MIX))[None]
    spec = TrafficSpec((PoissonArrivals(4.0), PoissonArrivals(11.0)),
                       np.eye(2))
    times, tys = spec.sample(7, 300)
    return simulate_open_batch(
        MU, tgt, times[None], tys[None], [7],
        distribution=make_distribution("exponential"), queue_capacity=6,
        order=order, warmup_arrivals=50, modes=[mode], class_of_type=[0, 1],
        faults=faults, device=CPU)


@pytest.mark.parametrize("order", ["PS", "FCFS", "PRIO"])
def test_never_firing_faults_leave_the_engine_run_unchanged(order):
    tgt = np.asarray(get_policy("grin").solve_target(MU, MIX))[None]
    never = PF.FaultScenario(events=PF.crash(0, 1e9, 2e9))
    fb = PF.build_fault_batch([never], MU, tgt, seeds=[7], mode="open",
                              n_arrivals=300, n_classes=2, device=CPU)
    base, far = _open_batch(None, order), _open_batch(fb, order)
    assert float(far["throughput"][0]) == float(base["throughput"][0])
    assert int(far["dropped"][0]) == int(base["dropped"][0])
    np.testing.assert_allclose(far["mean_response_time"],
                               base["mean_response_time"], rtol=2e-7)
    assert int(far["failures"][0]) == 0
    assert int(far["topology_events"][0]) == 0


def test_open_fault_engine_meets_the_gates_against_the_host_loop():
    """A reduced fig_faults.py grid (the six variants, seed 0, 2,000
    arrivals) in one engine call on the CPU, each point held to the port's
    host fault loop on the same arrivals and fault realization."""
    T, W = 2000, 200
    xk = 1.0 / max(s / MU[c].max() for c, s in enumerate(SHARES))
    spec = TrafficSpec(tuple(PoissonArrivals(1.1 * xk * s) for s in SHARES),
                       np.eye(2))
    times, tys = spec.sample(0, T)
    tw, te = float(times[W - 1]), float(times[-1])
    storm = PF.make_storm(4, n_bursts=2, group_size=2,
                          window=(tw + 0.15 * (te - tw),
                                  tw + 0.65 * (te - tw)),
                          downtime=0.06 * (te - tw), seed=11)

    def sc(**kw):
        return PF.FaultScenario(events=storm, fail_prob=0.02, **kw)
    variants = [("grin-p", sc()), ("grin-p", sc(refresh_targets=True)),
                ("grin-p", sc(refresh_targets=True, hedge_classes=(0,))),
                ("grin-p", sc(refresh_targets=True, ckpt_period=0.05)),
                ("lb", sc()), ("jsq", sc())]
    pols = [get_policy(p, **({"weights": [2.0, 1.0]} if p == "grin-p"
                             else {})) for p, _ in variants]
    tgt = np.stack([np.asarray(p.solve_target(MU, MIX)) if p.needs_target
                    else np.zeros(MU.shape, np.int64) for p in pols])
    modes = [MODE_DEFICIT if p.needs_target else _BASELINE_MODES[p.key]
             for p in pols]
    B = len(variants)
    fb = PF.build_fault_batch(
        [s for _, s in variants], MU, tgt, seeds=[0] * B, mode="open",
        policies=[p if p.needs_target else None for p in pols], mixes=MIX,
        n_arrivals=T, n_classes=2, device=CPU)
    out = simulate_open_batch(
        MU, tgt, np.repeat(times[None], B, 0), np.repeat(tys[None], B, 0),
        [0] * B, distribution=make_distribution("exponential"),
        queue_capacity=8, warmup_arrivals=W, modes=modes,
        class_of_type=[0, 1], faults=fb, device=CPU)
    x_rel, e_rel = [], []
    for i, ((_, s), pol) in enumerate(zip(variants, pols)):
        cfg = open_sim_config(MU, spec, n_arrivals=T, warmup_arrivals=W,
                              queue_capacity=8, class_of_type=[0, 1],
                              target_mix=MIX,
                              distribution=make_distribution("exponential"),
                              seed=0, faults=s)
        h = ClosedNetworkSimulator(cfg, device=CPU).run(pol)
        assert h.topology_events == int(out["topology_events"][i]) == 2
        assert abs(out["goodput"][i] - h.goodput) / h.goodput < X_REL
        for c in range(2):
            hx, dx = h.class_throughput[c], out["class_throughput"][i][c]
            x_rel.append(abs(dx - hx) / hx)
            e_rel.append(abs(out["class_energy"][i][c] - h.class_energy[c])
                         / h.class_energy[c])
    for rel in (x_rel, e_rel):
        assert max(rel) < P_PT_TOL and np.mean(rel) < P_MEAN_TOL, rel
    # checkpointing cuts the wasted work of the same storm
    assert out["wasted_work"][3] < out["wasted_work"][1]


def test_every_route_mode_runs_under_a_storm_with_both_hedges():
    """All five route modes, class hedges and the speculative hedge on two
    pools, one of them down for a while: a backup then has no pool to go
    to, and every mode must still pick a valid column."""
    mu = MU[:, :2]
    spec = TrafficSpec((PoissonArrivals(3.0), PoissonArrivals(6.0)),
                       np.eye(2))
    times, tys = spec.sample(5, 300)
    tgt = np.asarray(get_policy("grin").solve_target(mu, MIX))
    sc = PF.FaultScenario(events=PF.crash(1, 10.0, 30.0), fail_prob=0.05,
                          hedge_classes=(0,), hedge_quantile=0.5,
                          hedge_min_obs=4)
    fb = PF.build_fault_batch([sc] * 5, mu, tgt, seeds=list(range(5)),
                              mode="open", n_arrivals=300, n_classes=2,
                              device=CPU)
    out = simulate_open_batch(
        mu, np.repeat(tgt[None], 5, 0), np.repeat(times[None], 5, 0),
        np.repeat(tys[None], 5, 0), list(range(5)),
        distribution=make_distribution("exponential"), queue_capacity=4,
        order="FCFS", modes=list(range(5)), class_of_type=[0, 1], faults=fb,
        device=CPU)
    assert (out["topology_events"] == 1).all()
    assert (out["completed"] > 0).all() and (out["wasted_work"] > 0).all()
