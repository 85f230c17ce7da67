"""Port parity: the scheduling API (`repro_torch.sched`, `repro_torch.convert`).

Route decisions are integer-keyed and must match the reference exactly:
the `tests/test_api.py` goldens replay on the port's core, a JAX core and a
port core driven through the same operations decide identically, and a JAX
core's state carried across with `convert` keeps routing identically.
Batched solves and what-ifs match at float32 resolution."""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched as rsched  # noqa: E402
from repro.sched import api as rapi  # noqa: E402
from repro.sim.distributions import Exponential  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cab_target_state, grin_solve  # noqa: E402
from repro_torch.core.throughput import system_throughput  # noqa: E402
from repro_torch.sched import api as tapi  # noqa: E402
from repro_torch.sched import (BaselineClusterScheduler,  # noqa: E402
                               SchedulerCore, SystemView, get_policy,
                               solve_targets_grid_torch, solve_targets_torch)

CPU = "cpu"
MU = np.array([[20.0, 15.0], [3.0, 8.0]])


def _mu3(seed=4):
    return np.random.default_rng(seed).uniform(1, 30, size=(3, 3))


def test_registry_ports_the_slice_and_refuses_the_rest():
    names = tapi.available_policies()
    for key in ("cab", "cab-e", "grin", "grin-e", "grin-edp", "opt", "fixed",
                "rd", "bf", "lb", "jsq"):
        assert key in names
        assert get_policy(key if key != "fixed" else "opt").name == \
            rapi.get_policy(key if key != "fixed" else "opt").name
    for key in ("grin+", "slsqp", "grin-p", "cab-p"):
        assert key in names
        assert get_policy(key).name == rapi.get_policy(key).name
    assert names == rapi.available_policies()
    with pytest.raises(KeyError, match="unknown policy"):
        get_policy("nope")
    assert get_policy("grin-e").torch_objective == "max-x-e"
    assert get_policy("grin").supports_torch_batch
    assert not get_policy("lb").needs_target
    with pytest.raises(ValueError, match="exactly 2 pools"):
        SchedulerCore("cab", _mu3(), device=CPU)


def test_cluster_route_sequence_replays_reference_golden():
    """tests/test_api.py's pre-refactor golden, on the port's core."""
    mu3, nt3 = _mu3(4), np.array([6, 7, 5])
    core = SchedulerCore("grin", mu3, device=CPU)
    rng = np.random.default_rng(7)
    seq = []
    for i, n in enumerate(nt3):
        for _ in range(n):
            seq.append(core.route(i))
    for _ in range(300):
        occ = np.argwhere(core.counts > 0)
        t, j = occ[rng.integers(len(occ))]
        core.complete(int(t), int(j))
        seq.append(core.route(int(t)))
    assert hashlib.sha256(bytes(seq)).hexdigest() == \
        "714ffe05723f2597ecca36afba1e5cca02569385128c6ef1b7f1e987e3c1215e"
    assert core.counts.tolist() == [[1, 0, 5], [0, 7, 0], [0, 0, 5]]


@pytest.mark.parametrize("policy", ["cab", "grin", "cab-e", "grin-e",
                                    "opt", "lb", "jsq", "bf", "rd"])
def test_decisions_match_reference_core(policy):
    """Same seeded churn with views, pinned mixes and timed completions
    through both cores: every decision and the final books agree."""
    mu = MU if policy.startswith("cab") else _mu3(11)
    k, l = mu.shape
    port = SchedulerCore(policy, mu, device=CPU, seed=3)
    ref = rapi.SchedulerCore(policy, mu, seed=3)
    rng = np.random.default_rng(1)
    resident = []
    for step in range(250):
        if resident and (len(resident) >= 12 or rng.random() < 0.5):
            t, j = resident.pop(int(rng.integers(len(resident))))
            dt = float(rng.exponential(1.0 / mu[t, j]))
            port.complete(t, j, service_s=dt)
            ref.complete(t, j, service_s=dt)
        t = int(rng.integers(k))
        if step % 50 == 0:
            mix = rng.integers(1, 4, size=k)
            port.notify_type_counts(mix)
            ref.notify_type_counts(mix)
        j = port.route(t)
        assert j == ref.route(t), f"diverged at step {step}"
        resident.append((t, j))
    np.testing.assert_array_equal(port.counts, ref.counts)
    np.testing.assert_array_equal(port.backlog_work, ref.backlog_work)
    np.testing.assert_array_equal(port.mu, ref.mu)


def test_view_routing_matches_old_dispatcher_rule():
    mu = _mu3(11)
    core = SchedulerCore("grin", mu, device=CPU)
    counts = np.zeros((3, 3), dtype=np.int64)
    rng = np.random.default_rng(0)
    for _ in range(60):
        t = int(rng.integers(3))
        mix = counts.sum(axis=1)
        mix[t] += 1
        core.notify_type_counts(mix)
        j = core.route(t, view=SystemView(counts=counts,
                                          backlog_work=np.zeros(3),
                                          backlog_tasks=counts.sum(axis=0),
                                          mu=mu))
        target = grin_solve(mu, mix).N
        deficit = target[t] - counts[t]
        best = np.flatnonzero(deficit == deficit.max())
        assert j == int(best[np.argmax(mu[t][best])])
        counts[t, j] += 1


def test_route_many_is_decision_identical_to_route_and_reference():
    mu = _mu3(6)
    mix = np.array([9, 4, 7])
    types = np.random.default_rng(2).integers(0, 3, size=150)
    a = SchedulerCore("grin", mu, device=CPU).reset(n_tasks=mix)
    b = SchedulerCore("grin", mu, device=CPU).reset(n_tasks=mix)
    r = rapi.SchedulerCore("grin", mu).reset(n_tasks=mix)
    js = a.route_many(types)
    assert js.tolist() == [b.route(int(t)) for t in types]
    assert js.tolist() == r.route_many(types).tolist()
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.backlog_work, b.backlog_work)


def test_device_router_key_matches_reference_helper():
    import jax.numpy as jnp
    rng = np.random.default_rng(8)
    target = rng.integers(0, 6, size=(3, 4))
    counts = rng.integers(0, 6, size=(3, 4))
    rank = tapi._mu_tiebreak_ranks(rng.integers(1, 3, size=(3, 4)) * 1.0)
    for t in range(3):
        got = tapi.deficit_route_torch(torch.as_tensor(target),
                                       torch.as_tensor(rank),
                                       torch.as_tensor(counts), t)
        want = rapi.deficit_route_jax(jnp.asarray(target), jnp.asarray(rank),
                                      jnp.asarray(counts), t)
        assert int(got) == int(want)
    batched = tapi.deficit_route_torch(
        torch.as_tensor(np.stack([target] * 3)),
        torch.as_tensor(np.stack([rank] * 3)),
        torch.as_tensor(np.stack([counts] * 3)), torch.arange(3))
    assert batched.tolist() == [
        int(tapi.deficit_route_torch(torch.as_tensor(target),
                                     torch.as_tensor(rank),
                                     torch.as_tensor(counts), t))
        for t in range(3)]


def test_solve_targets_match_reference():
    mu3 = _mu3(4)
    mixes = np.array([[60, 70, 50], [30, 30, 30], [10, 80, 20]])
    for solver in ("block", "single"):
        t, x = solve_targets_torch(mu3, mixes, solver=solver, device=CPU)
        tr, xr = rapi.solve_targets_jax(mu3, mixes, solver=solver)
        np.testing.assert_array_equal(t.sum(axis=2), mixes)
        np.testing.assert_allclose(
            [system_throughput(n, mu3) for n in t],
            [system_throughput(n, mu3) for n in tr], rtol=2e-6)
        np.testing.assert_allclose(x, xr, rtol=2e-6)
    mus = np.stack([_mu3(s) for s in (1, 2)])
    t, x, c = solve_targets_grid_torch(mus, mixes, objective="max-x-e",
                                       device=CPU)
    tr, xr, cr = rapi.solve_targets_grid_jax(mus, mixes,
                                             objective="max-x-e")
    assert t.shape == (2, 3, 3, 3) and c.all()
    np.testing.assert_array_equal(c, cr)
    np.testing.assert_allclose(x, xr, rtol=2e-6)
    with pytest.raises(ValueError, match="n_tasks_batch"):
        solve_targets_torch(mu3, np.array([1, 2]), device=CPU)
    with pytest.raises(ValueError, match="solver='block'"):
        solve_targets_torch(mu3, mixes, solver="single", objective="min-e",
                            device=CPU)


def test_repair_restores_exact_row_sums():
    raw = np.array([[[2.4, 2.4, 2.2], [0.5, 0.5, 0.0]]])
    out = tapi._repair_targets(raw, np.array([[7, 1]]))
    np.testing.assert_array_equal(out.sum(axis=2), [[7, 1]])
    np.testing.assert_array_equal(
        out, rapi._repair_targets(raw, np.array([[7, 1]])))


def test_warm_targets_cache_and_stats():
    mu3 = _mu3(4)
    core = SchedulerCore("grin", mu3, device=CPU, cache_capacity=4)
    mixes = [[6, 7, 5], [3, 3, 3], [1, 8, 2], [10, 1, 1], [2, 2, 14]]
    assert core.warm_targets(mixes) == 5
    assert core.stats["cache_size"] == 4
    assert core.stats["cache_evictions"] == 1
    r0 = core.resolves
    for mix in mixes[1:]:
        core.notify_type_counts(mix)
        core.route(0)
        core.complete(0, int(core.counts[0].argmax()))
    assert core.resolves == r0                  # warmed: no host re-solve
    core.notify_type_counts(mixes[0])
    core.route(0)
    assert core.resolves == r0 + 1              # the evicted one re-solves
    assert core.stats["cache_hits"] >= 4
    assert core.warm_targets(mixes[2:]) == 0
    core_h = SchedulerCore("opt", mu3, device=CPU)
    assert core_h.warm_targets([[2, 2, 2]]) == 1 and core_h.resolves == 1


def test_elastic_what_if_matches_reference():
    mu3 = _mu3(4)
    mixes = np.array([[6, 7, 5], [3, 9, 3]])
    cols = np.array([[25.0, 4.0, 12.0]])
    got = SchedulerCore("grin-e", mu3, device=CPU).elastic_what_if(
        mixes, added_columns=cols)
    want = rapi.SchedulerCore("grin-e", mu3).elastic_what_if(
        mixes, added_columns=cols)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert np.isfinite(got["pool_lost"]).all()


def test_pool_lost_added_and_stragglers():
    mu3 = _mu3(1)
    core = SchedulerCore("grin", mu3, device=CPU)
    for t in (0, 1, 2, 0, 1):
        core.route(t)
    r0 = core.resolves
    core.pool_lost(2)
    assert core.mu.shape == (3, 2) and core.counts.shape == (3, 2)
    assert core.nominal_mu.shape == (3, 2)
    core.route(0)
    assert core.resolves > r0
    core.pool_added(np.array([25.0, 25.0, 25.0]))
    assert core.mu.shape == (3, 3) and core.backlog_work.shape == (3,)
    cab = SchedulerCore("cab", MU, resolve_rate_rel_change=0.2, device=CPU)
    for t in (0,) * 10 + (1,) * 10:
        cab.route(t)
    r0 = cab.resolves
    for _ in range(10):
        cab.complete(1, 1, service_s=3.0 / MU[1, 1])
        cab.route(1)
    assert cab.mu[0, 1] < MU[0, 1] and cab.resolves > r0
    np.testing.assert_array_equal(cab.base_mu, MU)
    cab.reset()
    np.testing.assert_array_equal(cab.mu, MU)
    with pytest.raises(IndexError):
        cab.unroute(0, 5)
    with pytest.raises(ValueError, match="no matching route"):
        cab.unroute(0, 0)


def test_state_carried_from_reference_core_keeps_routing_identically():
    mu = _mu3(9)
    ref = rapi.SchedulerCore("grin", mu, resolve_rate_rel_change=0.1)
    ref.warm_targets([[5, 5, 5], [2, 9, 4]])
    ref.notify_type_counts([5, 5, 5])
    rng = np.random.default_rng(4)
    live = []
    for _ in range(40):
        t = int(rng.integers(3))
        live.append((t, ref.route(t)))
    port = convert.scheduler_core_from_state(
        convert.scheduler_core_state(ref), "grin", device=CPU,
        resolve_rate_rel_change=0.1)
    for name in ("mu", "base_mu", "nominal_mu", "counts", "backlog_work"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert port._mu_token == ref._mu_token
    assert set(port._targets) == set(ref._targets)
    t = int(rng.integers(3))
    j = port.route(t)
    assert j == ref.route(t)
    live.append((t, j))
    assert port.resolves == 0          # the carried target is a cache hit
    for step in range(120):
        if live and rng.random() < 0.5:
            t, j = live.pop(int(rng.integers(len(live))))
            dt = float(rng.exponential(2.0 / mu[t, j]))   # EWMA folds in
            port.complete(t, j, service_s=dt)
            ref.complete(t, j, service_s=dt)
        if step == 60:
            port.notify_type_counts([2, 9, 4])
            ref.notify_type_counts([2, 9, 4])
        t = int(rng.integers(3))
        j = port.route(t)
        assert j == ref.route(t), f"diverged at step {step}"
        live.append((t, j))
    types = rng.integers(0, 3, size=50)
    assert port.route_many(types).tolist() == ref.route_many(types).tolist()
    np.testing.assert_array_equal(port.counts, ref.counts)
    np.testing.assert_array_equal(port.mu, ref.mu)
    assert (port.resolves, port._mu_token) == (ref.resolves, ref._mu_token)


def test_sim_config_from_reference_fields():
    from repro.sim.simulator import SimConfig as RCfg
    rc = RCfg(mu=MU, n_programs_per_type=np.array([4, 5]),
              distribution=Exponential(), order="FCFS", n_completions=900,
              warmup_completions=100, seed=3)
    fields = {"mu": rc.mu, "n_programs_per_type": rc.n_programs_per_type,
              "distribution": {"name": rc.distribution.name},
              "order": rc.order,
              "power": {"alpha": rc.power.alpha, "coeff": rc.power.coeff},
              "n_completions": rc.n_completions,
              "warmup_completions": rc.warmup_completions, "seed": rc.seed,
              "type_mix": rc.type_mix, "faults": rc.faults}
    cfg = convert.sim_config_from_reference(fields)
    assert (cfg.order, cfg.n_completions, cfg.warmup_completions,
            cfg.seed) == ("FCFS", 900, 100, 3)
    assert cfg.distribution.name == "exponential"
    assert cfg.power.alpha == rc.power.alpha
    mixed = convert.sim_config_from_reference(dict(fields, type_mix=[0.5, 0.5]))
    np.testing.assert_array_equal(mixed.type_mix, [0.5, 0.5])
    # open traffic and faults cross as dicts of plain values (ported)
    opened = convert.sim_config_from_reference(dict(fields, traffic={
        "processes": [{"name": "poisson", "lam": 2.0},
                      {"name": "mmpp", "rates": [4.0, 0.5],
                       "mean_dwell": [1.0, 3.0]}],
        "type_probs": np.eye(2), "n_arrivals": 50, "queue_capacity": 3,
        "hist": {"lo": 1e-3, "hi": 1e3, "n_bins": 64}},
        faults={"events": [(1.0, 0, 0.0), (2.0, 0, 1.0)], "fail_prob": 0.1,
                "hedge_classes": [0]}))
    assert opened.traffic.spec.processes[1].rates == (4.0, 0.5)
    assert (opened.traffic.queue_capacity, opened.traffic.hist.n_bins) \
        == (3, 64)
    assert opened.faults.events[0].scale == 0.0
    assert opened.faults.hedge_classes == (0,)
    with pytest.raises(TypeError, match="traffic"):
        convert.sim_config_from_reference(dict(fields, traffic=object()))


def test_baseline_cluster_scheduler_and_device_default(monkeypatch):
    b = BaselineClusterScheduler(MU, "lb", device=CPU)
    r = rsched.BaselineClusterScheduler(MU, "lb")
    for t in (0, 1, 1, 0, 1):
        assert b.route(t) == r.route(t)
    b.complete(1, int(np.argmax(b.counts[1])))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SchedulerCore("grin", _mu3())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_targets_torch(_mu3(), np.array([[2, 2, 2]]))
    assert cab_target_state(MU, [3, 3]).shape == (2, 2)
