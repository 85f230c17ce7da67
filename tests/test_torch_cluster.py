"""Port parity: the threaded cluster stack, roofline rates, the locked
`ClusterScheduler` (and the baselines on it), the load generators and
open-trace replay on the virtual-time harness.

Host code with threads and wall time is held with deterministic service
functions: the rates bit-equal (float64), scheduler decisions equal to the
reference's and to a bare `SchedulerCore`, `replay_open` metrics equal to
the reference's on `VirtualTimeCluster(measure_real=False)` at rtol 1e-12
(exact quantiles of the same samples)."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro.sched import scheduler as rscheduler  # noqa: E402
from repro.sched.baselines import \
    BaselineClusterScheduler as RBaseline  # noqa: E402
from repro.sched.cluster import ChipSpec as RChip  # noqa: E402
from repro.sched import rates as rrates  # noqa: E402
from repro.sched.priority import GrInPriorityPolicy as RGrInP  # noqa: E402
from repro.sched.virtual import VirtualTimeCluster as RVTC  # noqa: E402
from repro.traffic import AdmissionController as RAdm  # noqa: E402
from repro.traffic import SLOClass as RSLO  # noqa: E402
from repro.traffic import loadgen as rloadgen  # noqa: E402
from repro.traffic import replay_open as rreplay  # noqa: E402
from repro_torch.sched import (BaselineClusterScheduler,  # noqa: E402
                               ChipSpec, ClusterScheduler,
                               HeterogeneousCluster, PoolSpec,
                               SchedulerCore, affinity_from_roofline,
                               run_closed_loop, serving_step_costs,
                               step_time_roofline)
from repro_torch.sched.priority import GrInPriorityPolicy  # noqa: E402
from repro_torch.sched.virtual import VirtualTimeCluster  # noqa: E402
from repro_torch.traffic import (AdmissionController, SLOClass,  # noqa: E402
                                 flash_crowd_times, make_load_traces,
                                 replay_open)

CPU = "cpu"
MU = np.array([[20.0, 15.0], [3.0, 8.0]])


@pytest.mark.parametrize("chips", [1, 4])
def test_roofline_rates_equal_reference(chips):
    spec = dict(name="x", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    pc, rc = ChipSpec(**spec), RChip(**spec)
    pcost = serving_step_costs(7e9, 1024, 4, decode_tokens=32)
    rcost = rrates.serving_step_costs(7e9, 1024, 4, decode_tokens=32)
    assert [c.__dict__ for c in pcost] == [c.__dict__ for c in rcost]
    for p, r in zip(pcost, rcost):
        assert step_time_roofline(p, pc, chips) == \
            rrates.step_time_roofline(r, rc, chips)
    pools_p = [(pc, chips), (ChipSpec(name="y", peak_flops=50e12,
                                      hbm_bw=3e12), 1)]
    pools_r = [(rc, chips), (RChip(name="y", peak_flops=50e12,
                                   hbm_bw=3e12), 1)]
    np.testing.assert_array_equal(affinity_from_roofline(pcost, pools_p),
                                  rrates.affinity_from_roofline(rcost,
                                                                pools_r))


def test_chip_spec_defaults_are_the_h100():
    c = ChipSpec()
    assert (c.name, c.peak_flops, c.hbm_bw) == ("h100-sxm", 989e12, 3.35e12)


@pytest.mark.parametrize("policy,k,l", [("cab", 2, 2), ("grin", 3, 4),
                                        ("grin-e", 3, 4), ("lb", 3, 4),
                                        ("jsq", 3, 4), ("rd", 3, 4)])
def test_cluster_scheduler_decisions_equal_reference_and_core(policy, k, l):
    rng = np.random.default_rng(4)
    mu = rng.uniform(1, 30, size=(k, l))
    p = ClusterScheduler(mu, policy=policy, seed=2, device=CPU)
    r = rscheduler.ClusterScheduler(mu, policy=policy, seed=2)
    core = SchedulerCore(policy, mu, seed=2, device=CPU)
    for _ in range(150):
        t = int(rng.integers(k))
        if p.counts.sum() >= 10:        # a closed population of ten
            tt, j = np.argwhere(p.counts > 0)[0]
            svc = 1.7 / mu[tt, j]
            for s in (p, r, core):
                s.complete(int(tt), int(j), svc)
        assert p.route(t) == r.route(t) == core.route(t)
    np.testing.assert_array_equal(p.counts, r.counts)
    np.testing.assert_array_equal(p.mu, r.mu)
    assert p.resolves == r.resolves and p.name == r.name


@pytest.mark.parametrize("kind", ["lb", "jsq", "rd", "bf"])
def test_baseline_scheduler_is_a_cluster_scheduler(kind):
    rng = np.random.default_rng(6)
    mu = rng.uniform(1, 30, size=(2, 3))
    b = BaselineClusterScheduler(mu, kind, seed=1, device=CPU)
    assert isinstance(b, ClusterScheduler) and b.kind == kind
    r = RBaseline(mu, kind, seed=1)
    core = SchedulerCore(kind, mu, seed=1, device=CPU)
    for _ in range(60):
        t = int(rng.integers(2))
        assert b.route(t) == r.route(t) == core.route(t)
    b.pool_lost(1)
    r.pool_lost(1)
    assert b.route(0) == r.route(0) and b.l == 2


def test_threaded_cluster_runs_closed_loop_with_real_callables():
    """Two pools of one worker thread each run instant callables; every
    completion feeds the locked scheduler, whose counts stay a closed
    population."""
    calls = []
    lock = threading.Lock()

    def fn(tag):
        def run(size):
            with lock:
                calls.append(tag)
        return run

    specs = [PoolSpec(name=f"p{j}", service_fns={0: fn((j, 0)),
                                                 1: fn((j, 1))})
             for j in range(2)]
    cluster = HeterogeneousCluster(specs)
    sched = ClusterScheduler(MU, policy="cab", device=CPU)
    x = run_closed_loop(cluster, sched, [0, 0, 1, 1], lambda t: 1.0,
                        duration_s=0.6, warmup_s=0.1)
    assert x > 0 and len(cluster.completions) == len(calls) > 4
    assert sched.counts.sum() <= 4
    rec = cluster.completions[0]
    assert rec.finish_t >= rec.start_t >= rec.enqueue_t
    mu = HeterogeneousCluster(specs).measure_rates(2, reps=3)
    assert mu.shape == (2, 2) and (mu > 0).all()


@pytest.mark.parametrize("seed", [0, 3])
def test_load_traces_equal_reference(seed):
    probs = (0.4, 0.35, 0.25)
    np.testing.assert_array_equal(
        flash_crowd_times(20.0, 60.0, seed=seed),
        rloadgen.flash_crowd_times(20.0, 60.0, seed=seed))
    p = make_load_traces(probs, base=20.0, horizon=60.0, seed=seed)
    r = rloadgen.make_load_traces(probs, base=20.0, horizon=60.0, seed=seed)
    assert list(p) == list(r) == ["diurnal", "bursty", "flash"]
    for name in p:
        tp, yp = p[name].sample(seed, 900)
        tr, yr = r[name].sample(seed, 900)
        np.testing.assert_array_equal(tp, tr)
        np.testing.assert_array_equal(yp, yr)


def _det_fns(mu):
    return [{t: (lambda s, t=t, j=j: s / mu[t, j]) for t in range(2)}
            for j in range(mu.shape[1])]


@pytest.mark.parametrize("load,feed", [(0.8, False), (1.4, False),
                                       (1.4, True)])
def test_replay_open_equals_reference(load, feed):
    """The serving replay loop (GrIn-P placement, admission with a
    protected class, FCFS pools in virtual time) on deterministic service
    times: the same admit / shed / defer decisions and the same metrics."""
    mu = np.array([[9.0, 2.5], [1.5, 4.0]])
    rng = np.random.default_rng(11)
    x_knee = 1.0 / max(0.4 / mu[0].max(), 0.6 / mu[1].max())
    times = np.cumsum(rng.exponential(1.0 / (load * x_knee), size=400))
    types = (rng.uniform(size=400) < 0.6).astype(np.int64)
    sizes = rng.uniform(0.5, 1.5, size=400)
    it_p, it_r = iter(sizes), iter(sizes)
    slo = dict(deadline=1.0, percentile=0.9, protected=True)
    p_adm = AdmissionController(
        SchedulerCore(GrInPriorityPolicy((2.0, 1.0)), mu, device=CPU),
        (SLOClass(**slo), SLOClass(deadline=8.0, percentile=0.9)),
        class_of_type=[0, 1], queue_capacity=6, window=64, adapt_every=8)
    r_adm = RAdm(repro.sched.SchedulerCore(RGrInP((2.0, 1.0)), mu),
                 (RSLO(**slo), RSLO(deadline=8.0, percentile=0.9)),
                 class_of_type=[0, 1], queue_capacity=6, window=64,
                 adapt_every=8)
    p = replay_open(VirtualTimeCluster(_det_fns(mu), measure_real=False),
                    p_adm, times, types, size_fn=lambda t: next(it_p),
                    warmup=40, feed_tracker=feed)
    r = rreplay(RVTC(_det_fns(mu), measure_real=False), r_adm, times,
                types, size_fn=lambda t: next(it_r), warmup=40,
                feed_tracker=feed)
    for f in ("throughput", "elapsed", "class_completed", "class_shed",
              "class_deferred", "class_mean_response", "class_p50",
              "class_p99", "class_deadline_met", "limits"):
        np.testing.assert_allclose(np.asarray(getattr(p, f), float),
                                   np.asarray(getattr(r, f), float),
                                   rtol=1e-12, err_msg=f)
    assert p.class_completed.sum() > 0
    if load > 1.0:
        assert p.class_shed.sum() + p.class_deferred.sum() > 0
    with pytest.raises(ValueError, match="matching 1-D"):
        replay_open(VirtualTimeCluster(_det_fns(mu), measure_real=False),
                    p_adm, times[:5], types[:4])
