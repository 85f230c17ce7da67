"""Port parity: the flight recorder and the profiling spans
(`repro_torch.obs`).

The recorder keeps the reference's ring buffer, schema and bytes: the
same host run (the open host loop under GrIn-P with admission, the closed
fault loop with its breakpoints) exported to Chrome trace JSON by both
packages gives byte-equal files. Recording and profiling are off by
default and leave every result as it was; `span.ready` waits on the card
only while profiling is on (it never touches CUDA for CPU tensors)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro import obs as RO  # noqa: E402
from repro.faults import FaultScenario as RFS  # noqa: E402
from repro.faults import crash as rcrash  # noqa: E402
from repro.sched.api import as_core as ras_core  # noqa: E402
from repro.sched.priority import GrInPriorityPolicy as RGrInP  # noqa: E402
from repro.sim import ClosedNetworkSimulator as RSim  # noqa: E402
from repro.sim import SimConfig as RCfg  # noqa: E402
from repro.sim import make_distribution as rdist  # noqa: E402
from repro.traffic import AdmissionController as RAdm  # noqa: E402
from repro.traffic import PoissonArrivals as RPA  # noqa: E402
from repro.traffic import SLOClass as RSLO  # noqa: E402
from repro.traffic import TrafficSpec as RTS  # noqa: E402
from repro.traffic.config import open_sim_config as ropen  # noqa: E402
from repro.traffic.host import run_open as rrun_open  # noqa: E402
from repro_torch.faults import FaultScenario, crash  # noqa: E402
from repro_torch.obs import (Profiler, TraceRecorder,  # noqa: E402
                             enable_profiling, get_profiler, profile_block)
from repro_torch.obs.profile import ProfileSpan  # noqa: E402
from repro_torch.sched import SchedulerCore, get_policy  # noqa: E402
from repro_torch.sched.api import (as_core, solve_targets_grid_torch,  # noqa
                                   solve_targets_torch)
from repro_torch.sched.priority import GrInPriorityPolicy  # noqa: E402
from repro_torch.sim import (ClosedNetworkSimulator,  # noqa: E402
                             SimConfig, make_distribution)
from repro_torch.traffic import (AdmissionController,  # noqa: E402
                                 PoissonArrivals, SLOClass, TrafficSpec)
from repro_torch.traffic.config import open_sim_config  # noqa: E402
from repro_torch.traffic.host import run_open  # noqa: E402

CPU = "cpu"
MU = np.array([[6.0, 2.0], [2.0, 5.0]])
QCAP = 6


def test_recorder_ring_buffer_schema_and_spans_equal_reference(tmp_path):
    """The same events (numpy payloads, an unknown layer, a dropped
    event and a profiling span) export to the same bytes."""
    paths = []
    for pkg, rec in (("p", TraceRecorder(capacity=4)),
                     ("r", RO.TraceRecorder(capacity=4))):
        rec.record("sched", "route", type=0, pool=1,
                   deficit=np.array([1, -1]))
        rec.record("admission", "shed", t=0.25, cls=np.int64(1))
        rec.record("custom", "x", t=0.5, v=np.float32(0.5))
        rec.record("faults", "breakpoint", t=1.0, crashed=[1])
        rec.record("governor", "decision", t=2.0, freqs=[1.0, 0.0])
        assert len(rec) == 4 and rec.dropped == 1
        p = tmp_path / f"{pkg}.json"
        span = (ProfileSpan if pkg == "p" else RO.profile.ProfileSpan)(
            "solve", t0=1.0, dur=0.25)
        assert rec.export(str(p), spans=[span]) == 5
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    doc = json.loads(paths[0].read_text())
    assert doc["metadata"] == {"dropped": 1, "capacity": 4}
    with pytest.raises(ValueError):
        TraceRecorder(capacity=0)


def test_scheduler_core_records_like_the_reference():
    p_rec, r_rec = TraceRecorder(), RO.TraceRecorder()
    p = SchedulerCore(get_policy("opt"), MU, recorder=p_rec, device=CPU)
    r = repro.sched.SchedulerCore(repro.sched.get_policy("opt"), MU,
                                  recorder=r_rec)
    for core in (p, r):
        core.reset(MU, np.array([3, 3]))
        j = core.route(0)
        core.route(1)
        core.unroute(0, j)
        core.route_backup(0, exclude=j)
        core.route_many(np.array([0, 1], np.int64))
        core.reset(MU)
        core.route(1)                   # unpinned: the array path
    assert p_rec.counts() == r_rec.counts()
    assert [(e.t, e.layer, e.kind, e.data) for e in p_rec.events] == \
        [(e.t, e.layer, e.kind, e.data) for e in r_rec.events]
    lb = SchedulerCore("lb", MU, recorder=TraceRecorder(), device=CPU)
    lb.route(0)
    assert lb.recorder.events[0].data["policy"] == "lb"


def _open_pair():
    rspec = RTS((RPA(0.7 * MU[0].max()), RPA(0.7 * MU[1].max())), np.eye(2))
    pspec = TrafficSpec((PoissonArrivals(0.7 * MU[0].max()),
                         PoissonArrivals(0.7 * MU[1].max())), np.eye(2))
    kw = dict(n_arrivals=300, warmup_arrivals=40, queue_capacity=QCAP,
              class_of_type=[0, 1], target_mix=np.array([6, 6]), order="PS",
              seed=3)
    return (ropen(MU, rspec, distribution=rdist("exponential"), **kw),
            open_sim_config(MU, pspec,
                            distribution=make_distribution("exponential"),
                            **kw))


def test_open_host_run_exports_the_reference_bytes(tmp_path):
    rc, pc = _open_pair()
    r_rec, p_rec = RO.TraceRecorder(), TraceRecorder()
    rrun_open(RSim(rc), ras_core(RGrInP((2.0, 1.0)), MU, recorder=r_rec))
    run_open(ClosedNetworkSimulator(pc, device=CPU),
             as_core(GrInPriorityPolicy((2.0, 1.0)), MU, recorder=p_rec,
                     device=CPU))
    pr, rr = tmp_path / "p.json", tmp_path / "r.json"
    assert p_rec.export(str(pr)) == r_rec.export(str(rr)) > 0
    assert pr.read_bytes() == rr.read_bytes()
    assert p_rec.counts()[("sched", "route")] > 0


def test_admission_and_fault_loop_record_like_the_reference(tmp_path):
    """Admission decisions (admit / defer / shed / adapt) and the closed
    fault loop's breakpoints, with routes and re-solves, byte-equal."""
    slo = dict(deadline=0.5, percentile=0.9, protected=True)
    p_rec, r_rec = TraceRecorder(), RO.TraceRecorder()
    p_adm = AdmissionController(
        SchedulerCore(GrInPriorityPolicy((2.0, 1.0)), MU, recorder=p_rec,
                      device=CPU),
        (SLOClass(**slo), SLOClass(deadline=4.0, percentile=0.9)),
        class_of_type=[0, 1], queue_capacity=2, window=8, adapt_every=2)
    r_adm = RAdm(repro.sched.SchedulerCore(RGrInP((2.0, 1.0)), MU,
                                           recorder=r_rec),
                 (RSLO(**slo), RSLO(deadline=4.0, percentile=0.9)),
                 class_of_type=[0, 1], queue_capacity=2, window=8,
                 adapt_every=2)
    rng = np.random.default_rng(2)
    for i in range(40):
        t = int(rng.integers(2))
        out = [adm.offer(t, 0.1 * i) for adm in (p_adm, r_adm)]
        assert out[0] == out[1]
        if out[0][0] == "admit" and i % 2:
            for adm in (p_adm, r_adm):
                adm.complete(t, out[0][1], response_s=0.3 + 0.1 * t)
    kw = dict(fail_prob=0.05, ckpt_period=0.05, refresh_targets=False)
    cfg_kw = dict(mu=MU, n_programs_per_type=np.array([3, 3]), order="PS",
                  n_completions=400, warmup_completions=50, seed=0)
    RSim(RCfg(distribution=rdist("exponential"),
              faults=RFS(events=rcrash(1, 2.0, 3.0) + rcrash(0, 4.0, 5.0),
                         **kw), **cfg_kw)).run(
        ras_core(repro.sched.get_policy("lb"), MU, recorder=r_rec))
    m = ClosedNetworkSimulator(SimConfig(
        distribution=make_distribution("exponential"),
        faults=FaultScenario(events=crash(1, 2.0, 3.0) + crash(0, 4.0, 5.0),
                             **kw), **cfg_kw),
        device=CPU).run(as_core(get_policy("lb"), MU, recorder=p_rec,
                                device=CPU))
    assert m.topology_events >= 1
    c = p_rec.counts()
    assert c[("faults", "breakpoint")] == m.topology_events
    assert {("admission", k) for k in ("admit", "shed", "adapt")} <= set(c)
    pr, rr = tmp_path / "p.json", tmp_path / "r.json"
    p_rec.export(str(pr))
    r_rec.export(str(rr))
    assert pr.read_bytes() == rr.read_bytes()


def test_profiler_disabled_is_inert_and_ready_is_identity(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(a))
    prof = Profiler(enabled=False)
    x = torch.ones(3)
    with prof.span("x") as sp:
        assert sp.ready(x) is x
    assert prof.spans == [] and synced == []
    prof = Profiler(enabled=True, max_spans=4)
    for i in range(6):
        with prof.span("a" if i % 2 else "b") as sp:
            assert sp.ready((x, [x], {"k": x})) is not None
    # CPU tensors: nothing on the card to wait for
    assert synced == [] and len(prof.spans) == 4
    agg = prof.summary()
    assert set(agg) == {"a", "b"}
    assert all(r["count"] == 2 and r["max_s"] >= r["mean_s"] > 0.0
               for r in agg.values())
    top = prof.top_spans(3)
    assert top[0].dur >= top[1].dur >= top[2].dur


def test_profile_block_captures_the_solver_spans():
    assert not get_profiler().enabled
    get_profiler().clear()
    mus = np.stack([MU, MU[::-1]])
    with profile_block("t") as prof:
        assert prof is get_profiler() and prof.enabled
        t1, _ = solve_targets_torch(MU, np.array([[4, 4]]), device=CPU)
        t2, _, _ = solve_targets_grid_torch(mus, np.array([[4, 4]]),
                                            device=CPU)
        core = SchedulerCore("grin", MU, device=CPU)
        core.reset(MU, np.array([4, 4]))
        core.route_many(np.array([0, 1, 1], np.int64))
    assert not get_profiler().enabled
    names = [s.name for s in prof.spans]
    for name in ("solve_targets_torch", "solve_targets_grid_torch",
                 "grin_solve_batch_torch", "route_many"):
        assert name in names, names
    # the batched solve's span sits inside the entry point's
    assert names.index("grin_solve_batch_torch") < \
        names.index("solve_targets_torch")
    assert t1.shape == (1, 2, 2) and t2.shape == (2, 1, 2, 2)
    n = len(prof.spans)
    solve_targets_torch(MU, np.array([[4, 4]]), device=CPU)
    assert len(get_profiler().spans) == n      # off again: no spans
    enable_profiling(False)
