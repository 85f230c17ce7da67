"""Port parity: open traffic (`repro_torch.traffic`).

The host pieces are the reference's op for op on the same NumPy streams:
arrival realizations are bit-equal, histogram quantiles equal to float64
resolution, and the host open loop (`run_open`, dispatched by
`ClosedNetworkSimulator.run` when `SimConfig.traffic` is set) reproduces
the reference's SimMetrics at rtol 1e-12. The open device engine draws its
own task sizes, so it is held to the port's host loop statistically, on a
reduced `benchmarks/fig_traffic.py` grid, at that benchmark's gates (total
X within 0.05, each class's p99 within 0.30) and the multi-class
conformance gates (per (point, class) X and E/task within 0.2, their
means within 0.08)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro.sched import get_policy as rget  # noqa: E402
from repro.sched.api import SchedulerCore as RCore  # noqa: E402
from repro.sched.priority import priority_open_config as rpoc  # noqa: E402
from repro.sim import ClosedNetworkSimulator as RSim  # noqa: E402
from repro.sim import make_distribution as rdist  # noqa: E402
from repro import traffic as RT  # noqa: E402
from repro.traffic.config import derive_target_mix as rderive  # noqa: E402
from repro.traffic.config import open_sim_config as ropen  # noqa: E402
from repro.traffic.quantiles import hist_quantile_rows_jax  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import traffic as PT  # noqa: E402
from repro_torch.sched import get_policy, priority_open_config  # noqa: E402
from repro_torch.sched.api import SchedulerCore  # noqa: E402
from repro_torch.sim import (ClosedNetworkSimulator,  # noqa: E402
                             make_distribution, run_policy_sweep)
from repro_torch.sim.engine_torch import (MODE_DEFICIT,  # noqa: E402
                                          _BASELINE_MODES)
from repro_torch.traffic.quantiles import (  # noqa: E402
    hist_quantile_rows_torch)

RTOL = 1e-12
CPU = "cpu"
MU = np.array([[8.0, 2.0], [2.0, 6.0]])      # fig_traffic.py's system
SHARES = np.array([0.25, 0.75])
DEADLINES = np.array([1.25, 10.0])
FIELDS = ("throughput", "mean_response_time", "mean_energy", "edp",
          "little_product", "completed", "elapsed", "state_occupancy",
          "mean_power", "class_throughput", "class_response_time",
          "class_energy", "class_occupancy", "offered", "dropped",
          "class_dropped", "class_quantiles", "class_deadline_met")
X_REL, P99_REL, P_PT_TOL, P_MEAN_TOL = 0.05, 0.30, 0.2, 0.08


def _procs(pkg):
    return [pkg.PoissonArrivals(3.0),
            pkg.MMPPArrivals(rates=(8.0, 0.5), mean_dwell=(2.0, 6.0)),
            pkg.DiurnalArrivals(4.0, amplitude=0.6, period=50.0),
            pkg.TraceArrivals(times=(0.0, 0.4, 1.1, 1.5, 3.2),
                              time_scale=0.7)]


@pytest.mark.parametrize("i", range(4))
def test_arrival_processes_and_merged_streams_are_bit_equal(i):
    rng_r, rng_p = np.random.default_rng(3), np.random.default_rng(3)
    r, p = _procs(RT)[i], _procs(PT)[i]
    np.testing.assert_array_equal(r.sample(rng_r, 500), p.sample(rng_p, 500))
    assert p.rate == r.rate
    assert p.scaled(1.7).rate == r.scaled(1.7).rate
    probs = np.array([[0.5, 0.5, 0.0], [0.0, 0.2, 0.8]])
    rs = RT.TrafficSpec((r, RT.PoissonArrivals(2.0)), probs)
    ps = PT.TrafficSpec((p, PT.PoissonArrivals(2.0)), probs)
    for seed in (0, 7):
        for a, b in zip(rs.sample(seed, 700), ps.sample(seed, 700)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rs.type_rates(), ps.type_rates())


def test_histogram_quantiles_match_the_reference():
    rng = np.random.default_rng(0)
    samples = rng.lognormal(0.0, 1.5, size=3000)
    rh, ph = RT.LogHistogram(), PT.LogHistogram()
    np.testing.assert_array_equal(rh.counts(samples), ph.counts(samples))
    counts = np.stack([rh.counts(samples[:n]) for n in (0, 1, 17, 3000)])
    np.testing.assert_array_equal(rh.quantiles(counts[1:]),
                                  ph.quantiles(counts[1:]))
    np.testing.assert_array_equal(RT.exact_quantiles(samples),
                                  PT.exact_quantiles(samples))
    assert np.isnan(ph.quantile(counts[0], 0.5))
    for q in (0.5, 0.99, 0.999):
        ref = np.asarray(hist_quantile_rows_jax(counts, q, rh.lo,
                                                rh.log_growth), np.float64)
        port = hist_quantile_rows_torch(torch.as_tensor(counts, dtype=torch
                                                        .float64),
                                        q, ph.lo, ph.log_growth).numpy()
        np.testing.assert_allclose(port, ref, rtol=1e-6)   # jax: float32
        np.testing.assert_allclose(port[1:], ph.quantiles(counts[1:], (q,))
                                   [:, 0], rtol=1e-13)


def test_open_config_admission_and_priority_open_config():
    rs = RT.TrafficSpec(tuple(RT.PoissonArrivals(7.0 * s) for s in SHARES),
                        np.eye(2))
    ps = PT.TrafficSpec(tuple(PT.PoissonArrivals(7.0 * s) for s in SHARES),
                        np.eye(2))
    np.testing.assert_array_equal(rderive(rs, 2, 8),
                                  PT.derive_target_mix(ps, 2, 8))
    slo = [PT.SLOClass(1.0, protected=True), PT.SLOClass(5.0)]
    np.testing.assert_array_equal(
        PT.default_admit_limits(slo, 16),
        RT.default_admit_limits([RT.SLOClass(1.0, protected=True),
                                 RT.SLOClass(5.0)], 16))
    with pytest.raises(ValueError, match="class rows"):
        PT.open_sim_config(MU, PT.TrafficSpec(
            (PT.PoissonArrivals(1.0),) * 2, np.array([[0.5, 0.5], [0, 1.0]])),
            n_arrivals=10, class_of_type=[0, 1],
            distribution=make_distribution("exponential"))
    # the adaptive controller admits, sheds and defers as the reference's
    r_ac = RT.AdmissionController(RCore("grin", MU), [
        RT.SLOClass(0.3, protected=True), RT.SLOClass(5.0)], [0, 1], 2,
        mode="defer", adapt_every=4)
    p_ac = PT.AdmissionController(SchedulerCore("grin", MU, device=CPU), [
        PT.SLOClass(0.3, protected=True), PT.SLOClass(5.0)], [0, 1], 2,
        mode="defer", adapt_every=4)
    rng = np.random.default_rng(1)
    for step in range(60):
        t = int(rng.integers(2))
        assert r_ac.offer(t, float(step)) == p_ac.offer(t, float(step))
        if step % 3 == 2 and r_ac.in_system:
            j = int(np.argmax(r_ac.core.counts[t])) \
                if r_ac.core.counts[t].sum() else None
            if j is not None:
                r_ac.complete(t, j, 0.5 + 0.1 * step)
                p_ac.complete(t, j, 0.5 + 0.1 * step)
        assert r_ac.drain(float(step)) == p_ac.drain(float(step))
    np.testing.assert_array_equal(r_ac.limits, p_ac.limits)
    np.testing.assert_array_equal(r_ac.shed, p_ac.shed)
    # priority_open_config: the same flattened config on both packages
    kw = dict(n_arrivals=900, warmup_arrivals=90, queue_capacity=4, seed=2)
    rc = rpoc(MU, [RT.PoissonArrivals(2.0), RT.PoissonArrivals(5.0)],
              distribution=rdist("exponential"), **kw)
    pc = priority_open_config(
        MU, [PT.PoissonArrivals(2.0), PT.PoissonArrivals(5.0)],
        distribution=make_distribution("exponential"), **kw)
    np.testing.assert_array_equal(rc.mu, pc.mu)
    np.testing.assert_array_equal(rc.n_programs_per_type,
                                  pc.n_programs_per_type)
    np.testing.assert_array_equal(rc.traffic.spec.type_probs,
                                  pc.traffic.spec.type_probs)
    r = RSim(rc).run(rget("grin-p", weights=[2.0, 1.0]))
    p = ClosedNetworkSimulator(pc, device=CPU).run(
        get_policy("grin-p", weights=[2.0, 1.0]))
    for f in FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(p, f), float),
                                   np.asarray(getattr(r, f), float),
                                   rtol=RTOL, err_msg=f)


def _cfgs(order, seed=3, n=1500, admit=None, processes=None):
    """The same open config in both packages, built from plain values."""
    procs = processes or [{"name": "poisson", "lam": 9.0 * s}
                          for s in SHARES]
    fields = {"mu": MU, "n_programs_per_type": np.array([4, 12]),
              "distribution": "exponential", "order": order, "seed": seed,
              "n_completions": n, "warmup_completions": 0,
              "class_of_type": np.array([0, 1]),
              "traffic": {"processes": procs, "type_probs": np.eye(2),
                          "n_arrivals": n, "warmup_arrivals": n // 10,
                          "queue_capacity": 8, "admit_limits": admit,
                          "deadlines": DEADLINES}}
    rsp = RT.TrafficSpec(tuple(getattr(RT, {
        "poisson": "PoissonArrivals", "mmpp": "MMPPArrivals"}[p["name"]])(
        **{k: v for k, v in p.items() if k != "name"}) for p in procs),
        np.eye(2))
    rc = ropen(MU, rsp, n_arrivals=n, warmup_arrivals=n // 10,
               queue_capacity=8, admit_limits=admit, deadlines=DEADLINES,
               class_of_type=[0, 1], target_mix=np.array([4, 12]),
               distribution=rdist("exponential"), order=order, seed=seed)
    return rc, convert.sim_config_from_reference(fields)


@pytest.mark.parametrize("policy,order", [
    ("grin", "PS"), ("grin-p", "PRIO"), ("grin-p", "FCFS"), ("lb", "PS"),
    ("lb", "FCFS"), ("jsq", "PRIO"), ("cab-p", "PS"), ("rd", "FCFS")])
def test_host_open_loop_is_bit_equal(policy, order):
    admit = np.array([16, 5]) if policy in ("jsq", "grin-p") else None
    rc, pc = _cfgs(order, admit=admit)
    kw = {"weights": [2.0, 1.0]} if policy.endswith("-p") else {}
    r = RSim(rc).run(rget(policy, **kw))
    p = ClosedNetworkSimulator(pc, device=CPU).run(get_policy(policy, **kw))
    for f in FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(p, f), float),
                                   np.asarray(getattr(r, f), float),
                                   rtol=RTOL, err_msg=f)
    assert p.dropped > 0 and p.offered == 1350


def test_bursty_arrivals_through_the_host_loop_are_bit_equal():
    procs = [{"name": "mmpp", "rates": (6.0, 0.5), "mean_dwell": (2.0, 5.0)},
             {"name": "poisson", "lam": 6.0}]
    rc, pc = _cfgs("PS", seed=5, processes=procs)
    r = RSim(rc).run("jsq")
    p = ClosedNetworkSimulator(pc, device=CPU).run("jsq")
    for f in FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(p, f), float),
                                   np.asarray(getattr(r, f), float),
                                   rtol=RTOL, err_msg=f)


def test_open_engine_meets_the_gates_against_the_host_loop():
    """A reduced fig_traffic.py grid (four variants x three loads, seed
    0) in one batched engine call on the CPU, each point held to the
    port's host open loop on the same arrivals."""
    T, W = 3000, 300
    xk = 1.0 / max(s / MU[c].max() for c, s in enumerate(SHARES))
    dist = make_distribution("exponential")
    specs = {u: PT.TrafficSpec(tuple(PT.PoissonArrivals(u * xk * s)
                                     for s in SHARES), np.eye(2))
             for u in (0.5, 0.95, 1.2)}
    mix = PT.derive_target_mix(specs[1.2], 2, 8)
    variants = {"grin-p": [16, 16], "lb": [16, 16], "jsq": [16, 16],
                "jsq+adm": [16, 4]}
    pts = [(v, u) for v in variants for u in specs]
    mode, tgt, pols = [], [], {}
    for v in variants:
        name = v.split("+")[0]
        pols[v] = get_policy(name, **({"weights": [2.0, 1.0]}
                                      if name == "grin-p" else {}))
        if pols[v].needs_target:
            mode.append(MODE_DEFICIT)
            tgt.append(np.asarray(pols[v].solve_target(MU, mix)))
        else:
            mode.append(_BASELINE_MODES[pols[v].key])
            tgt.append(np.zeros((2, 2), np.int64))
    arr = {u: specs[u].sample(0, T) for u in specs}
    nv = len(specs)
    out = PT.simulate_open_batch(
        MU, np.repeat(np.stack(tgt), nv, axis=0),
        np.stack([arr[u][0] for _, u in pts]),
        np.stack([arr[u][1] for _, u in pts]), [0] * len(pts),
        distribution=dist, queue_capacity=8, warmup_arrivals=W,
        modes=np.repeat(mode, nv), class_of_type=[0, 1],
        admit_limits=np.array([variants[v] for v, _ in pts]),
        deadlines=DEADLINES, device=CPU)
    x_rel, e_rel, p99_rel = [], [], []
    for i, (v, u) in enumerate(pts):
        cfg = PT.open_sim_config(
            MU, specs[u], n_arrivals=T, warmup_arrivals=W, queue_capacity=8,
            admit_limits=variants[v], deadlines=DEADLINES,
            class_of_type=[0, 1], target_mix=mix, distribution=dist,
            seed=0)
        h = ClosedNetworkSimulator(cfg, device=CPU).run(pols[v])
        assert abs(out["throughput"][i] - h.throughput) / h.throughput \
            < X_REL, (v, u)
        for c in range(2):
            hx, dx = h.class_throughput[c], out["class_throughput"][i][c]
            x_rel.append(abs(dx - hx) / hx)
            e_rel.append(abs(out["class_energy"][i][c] - h.class_energy[c])
                         / h.class_energy[c])
            hp = h.class_quantiles[c][1]
            p99_rel.append(abs(out["class_quantiles"][i][c][1] - hp) / hp)
    assert max(p99_rel) < P99_REL, p99_rel
    for rel in (x_rel, e_rel):
        assert max(rel) < P_PT_TOL and np.mean(rel) < P_MEAN_TOL, rel
    # admission at overload: the protected class stops dropping
    i_adm = pts.index(("jsq+adm", 1.2))
    assert out["class_dropped"][i_adm][0] == 0
    assert out["class_dropped"][i_adm][1] > 0.1 * (T - W) * SHARES[1]


def test_open_configs_run_on_the_engine_through_the_user_entry_points():
    _, pc = _cfgs("PS", n=800)
    sweep = run_policy_sweep(pc, ["grin", "lb"], engine="torch", device=CPU)
    host = run_policy_sweep(pc, ["grin", "lb"], device=CPU)
    # target policies run on the open engine; SystemView ones on the host
    assert sweep["GrIn"].meta["device"] == "cpu"
    assert sweep["LB"].meta is None
    for name, m in sweep.items():
        assert m.offered == 720 and m.class_quantiles.shape == (2, 3)
        assert abs(m.throughput - host[name].throughput) \
            < 0.1 * host[name].throughput
    with pytest.raises(ValueError, match="simulate_open_batch"):
        from repro_torch.sim import sweep as engine_sweep
        engine_sweep(pc, "grin", device=CPU)


def test_open_engine_validates_and_defaults_to_the_card(monkeypatch):
    t = np.sort(np.random.default_rng(0).uniform(0, 10, (1, 50)), axis=1)
    ty = np.zeros((1, 50), dtype=np.int64)
    tgt = np.zeros((1, 2, 2), dtype=np.int64)
    kw = dict(distribution=make_distribution("exponential"),
              queue_capacity=4, device=CPU)
    with pytest.raises(ValueError, match="unknown order"):
        PT.simulate_open_batch(MU, tgt, t, ty, [0], order="LIFO", **kw)
    with pytest.raises(ValueError, match="warmup"):
        PT.simulate_open_batch(MU, tgt, t, ty, [0], warmup_arrivals=50, **kw)
    with pytest.raises(ValueError, match="cuda_graph"):
        PT.simulate_open_batch(MU, tgt, t, ty, [0], cuda_graph=True, **kw)
    with pytest.raises(TypeError, match="traffic"):
        convert.sim_config_from_reference({
            "mu": MU, "n_programs_per_type": [1, 1],
            "distribution": "exponential", "traffic": object()})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.simulate_open_batch(MU, tgt, t, ty, [0], **{
            k: v for k, v in kw.items() if k != "device"})
