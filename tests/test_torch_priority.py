"""Port parity: the priority-class subsystem (`repro_torch.core.priority`,
`repro_torch.sched.priority`).

Tolerances: the host float64 closed forms, class-axis deltas and solvers
are copies and must equal the reference's exactly (rtol 1e-12 where a sum
is reordered). The batched GrIn-P runs here on the CPU through the plain
per-step loop (on the card the fused CUDA solve, held against that loop in
`tests/test_torch_cuda.py`); against the reference's batched solver its
placements must be identical except at documented near-ties, points where
two placements' weighted X agree to float32 resolution (2e-6 relative)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro.core import priority as rp  # noqa: E402
from repro.core.affinity import PowerModel as RPower  # noqa: E402
from repro.sched import SchedulerCore as RCore  # noqa: E402
from repro.sched import get_policy as rget  # noqa: E402
from repro_torch.core import grin_solve_batch_torch  # noqa: E402
from repro_torch.core import priority as tp  # noqa: E402
from repro_torch.core.affinity import PowerModel as TPower  # noqa: E402
from repro_torch.sched import SchedulerCore, get_policy  # noqa: E402
from repro_torch.sched.priority import (flat_mu, flatten_mixes,  # noqa: E402
                                        priority_sim_config)
from repro_torch.sim import make_distribution  # noqa: E402

CPU = "cpu"
RTOL32 = 2e-6


def _state(rng, C, k, l, n_max=12):
    return rng.integers(0, n_max, size=(C, k, l))


@pytest.mark.parametrize("seed", range(4))
def test_closed_forms_match_reference(seed):
    rng = np.random.default_rng(seed)
    C, k, l = int(rng.integers(1, 4)), int(rng.integers(1, 4)), \
        int(rng.integers(2, 5))
    N = _state(rng, C, k, l)
    mu = rng.uniform(1, 30, (k, l))
    w = rng.uniform(0.1, 8.0, C)
    power = TPower(alpha=0.5)
    np.testing.assert_array_equal(tp.priority_mu(mu, w),
                                  rp.priority_mu(mu, w))
    np.testing.assert_array_equal(tp.flat_mu(mu, C), rp.flat_mu(mu, C))
    np.testing.assert_array_equal(tp.class_of_flat(C, k),
                                  rp.class_of_flat(C, k))
    np.testing.assert_array_equal(
        tp.unflatten_state(tp.flatten_state(N), C), N)
    np.testing.assert_array_equal(tp.class_throughputs(N, mu),
                                  rp.class_throughputs(N, mu))
    assert tp.weighted_system_throughput(N, mu, w) == \
        rp.weighted_system_throughput(N, mu, w)
    np.testing.assert_array_equal(
        tp.class_energy_per_task(N, mu, power),
        rp.class_energy_per_task(N, mu, RPower(alpha=0.5)))
    xc = tp.class_throughputs_batch_torch(torch.as_tensor(N[None]),
                                          torch.as_tensor(mu))[0]
    np.testing.assert_allclose(xc.numpy(), rp.class_throughputs(N, mu),
                               rtol=1e-5)
    assert tuple(tp.class_throughputs_batch_torch(
        torch.as_tensor(np.stack([N, N])), torch.as_tensor(
            np.stack([mu, mu]))).shape) == (2, C)


@pytest.mark.parametrize("seed", range(2))
def test_class_axis_block_deltas_match_reference(seed):
    rng = np.random.default_rng(100 + seed)
    C, k, l = 2, 2, 3
    N = _state(rng, C, k, l) + 1
    mu = rng.uniform(1, 30, (k, l))
    w = rng.uniform(0.5, 5.0, C)
    for c in range(C):
        for p in range(k):
            for m in (1, 2, 4):
                for tf, rf, extra in (
                        (tp.delta_xw_add_block_priority,
                         rp.delta_xw_add_block_priority, ()),
                        (tp.delta_xw_remove_block_priority,
                         rp.delta_xw_remove_block_priority, ()),
                        (tp.delta_w_add_block_priority,
                         rp.delta_w_add_block_priority, "P"),
                        (tp.delta_w_remove_block_priority,
                         rp.delta_w_remove_block_priority, "P")):
                    a = (tf(N, mu, w, TPower(alpha=0.5), c, p, m) if extra
                         else tf(N, mu, w, c, p, m))
                    b = (rf(N, mu, w, RPower(alpha=0.5), c, p, m) if extra
                         else rf(N, mu, w, c, p, m))
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_host_solvers_match_reference(seed):
    rng = np.random.default_rng(30 + seed)
    mu = rng.uniform(1, 30, (3, 3))
    mixes = rng.integers(1, 9, size=(2, 3))
    w = np.array([4.0, 1.0])
    a, b = tp.grin_priority_solve(mu, mixes, w), rp.grin_priority_solve(
        mu, mixes, w)
    np.testing.assert_array_equal(a.N, b.N)
    assert (a.weighted_x, a.moves, a.sweeps) == (b.weighted_x, b.moves,
                                                 b.sweeps)
    np.testing.assert_array_equal(a.class_x, b.class_x)
    mu1 = rng.uniform(1, 30, (1, 2))
    cm = rng.integers(1, 8, size=(2, 1))
    w2 = rng.uniform(0.5, 6.0, 2)
    np.testing.assert_array_equal(tp.cab_priority_solve(mu1, cm, w2),
                                  rp.cab_priority_solve(mu1, cm, w2))
    # the registry policies over the flattened matrix
    for key, m, mx, ww in (("grin-p", mu, mixes, w),
                           ("cab-p", mu1, cm, w2)):
        mf, fx = flat_mu(m, 2), flatten_mixes(mx)
        np.testing.assert_array_equal(
            get_policy(key, weights=ww).solve_target(mf, fx),
            rget(key, weights=ww).solve_target(mf, fx))
        np.testing.assert_array_equal(get_policy(key, weights=ww)
                                      .device_mu(mf),
                                      rget(key, weights=ww).device_mu(mf))


@pytest.mark.parametrize("objective", ["max-x", "max-x-e"])
def test_batched_priority_solver_matches_reference(objective):
    rng = np.random.default_rng(50)
    B, C, k, l = 12, 2, 3, 4
    mu = rng.uniform(1, 30, (k, l))
    mixes = np.stack([np.stack([rng.multinomial(n, rng.dirichlet([0.3] * k))
                                for n in (20, 180)]) for _ in range(B)])
    w = np.array([4.0, 1.0])
    power = dict(alpha=0.5)
    N, xw, conv, moves = tp.grin_solve_priority_batch_torch(
        mu, mixes, w, objective=objective, power=TPower(**power), device=CPU)
    Nr, xr, convr, movesr = rp.grin_solve_priority_batch_jax(
        mu, mixes, w, objective=objective, power=RPower(**power))
    Nr = np.asarray(Nr)
    assert tuple(N.shape) == (B, C, k, l)
    assert conv.all() and np.asarray(convr).all()
    np.testing.assert_array_equal(N.numpy().sum(axis=3), mixes)
    same = (N.numpy() == Nr).reshape(B, -1).all(axis=1)
    xt = np.array([tp.weighted_system_throughput(n, mu, w) for n in N])
    xj = np.array([rp.weighted_system_throughput(n, mu, w) for n in Nr])
    # placements equal, or a documented near-tie: same weighted X at
    # float32 resolution
    np.testing.assert_allclose(xt[~same], xj[~same], rtol=RTOL32)
    assert same.sum() >= B - 1, same
    np.testing.assert_array_equal(moves.numpy()[same],
                                  np.asarray(movesr)[same])
    np.testing.assert_allclose(xw.numpy(), np.asarray(xr), rtol=RTOL32)


def test_c1_unit_weight_is_plain_grin():
    rng = np.random.default_rng(11)
    mu = rng.uniform(1, 30, (3, 3))
    mix = np.array([[10, 8, 12]])
    host = tp.grin_priority_solve(mu, mix, [1.0])
    assert host.weighted_x == rp.grin_priority_solve(mu, mix, [1.0]).weighted_x
    np.testing.assert_array_equal(host.N[0], get_policy("grin").solve_target(
        mu, mix[0]))
    Np, xp, cp, mp = tp.grin_solve_priority_batch_torch(
        mu, mix[:, None, :], [1.0], device=CPU)
    N0, x0, c0, m0 = grin_solve_batch_torch(mu, mix, device=CPU)
    assert torch.equal(Np[:, 0], N0) and torch.equal(xp, x0)
    assert torch.equal(mp, m0) and torch.equal(cp, c0)
    a = SchedulerCore("grin", mu, device=CPU).reset(mu, mix[0])
    b = SchedulerCore(get_policy("grin-p"), mu, device=CPU).reset(mu, mix[0])
    types = rng.integers(0, 3, 200)
    assert [a.route(int(t)) for t in types] == \
        [b.route(int(t)) for t in types]


def test_set_class_weights_changes_the_warm_cache_key():
    rng = np.random.default_rng(16)
    mu = rng.uniform(1, 30, (2, 3))
    flat = flatten_mixes(np.array([[5, 3], [7, 9]]))
    cores = [SchedulerCore(get_policy("grin-p", weights=[4.0, 1.0]),
                           flat_mu(mu, 2), device=CPU),
             RCore(rget("grin-p", weights=[4.0, 1.0]), flat_mu(mu, 2))]
    for core in cores:
        core.reset(n_tasks=flat)
    for core in cores:
        skew = core._target_for(flat).copy()
        core.set_class_weights([1.0, 1.0])
        unit = core._target_for(flat)
        assert core.resolves == 2 and not np.array_equal(skew, unit)
        core.set_class_weights([4.0, 1.0])
        np.testing.assert_array_equal(core._target_for(flat), skew)
        assert core.resolves == 2
        assert set(core._targets) == {
            (tuple(flat), core._mu_token, (4.0, 1.0)),
            (tuple(flat), core._mu_token, (1.0, 1.0))}
    np.testing.assert_array_equal(cores[0]._target_for(flat),
                                  cores[1]._target_for(flat))
    with pytest.raises(ValueError, match="class_weights"):
        SchedulerCore("grin", mu, device=CPU).set_class_weights([1.0])
    with pytest.raises(ValueError, match="nonneg"):
        cores[0].set_class_weights([1.0, -5.0])


def test_priority_sim_config_and_shape_bounds():
    rng = np.random.default_rng(19)
    mu = rng.uniform(1, 30, (2, 2))
    mixes = np.array([[3, 2], [4, 5]])
    dist = make_distribution("exponential")
    cfg = priority_sim_config(mu, mixes, distribution=dist, order="PRIO",
                              n_completions=100, warmup_completions=10)
    np.testing.assert_array_equal(cfg.class_of_type, [0, 0, 1, 1])
    np.testing.assert_array_equal(cfg.n_programs_per_type, [3, 2, 4, 5])
    np.testing.assert_array_equal(cfg.mu, np.tile(mu, (2, 1)))
    with pytest.raises(ValueError, match="class_distributions"):
        priority_sim_config(mu, mixes, class_distributions=(dist,),
                            n_completions=100, warmup_completions=10)
    # the fused solve's bounds: 48 KB of shared memory a block, k*l*l < 2^22
    from repro_torch.kernels.grin_moves import check_solve_shape
    check_solve_shape(2 * 4, 6)
    with pytest.raises(ValueError, match="shared memory"):
        check_solve_shape(64 * 4, 6)
    with pytest.raises(ValueError, match="2\\^22"):
        check_solve_shape(4, 1100)


def test_priority_core_state_carried_from_reference_routes_identically():
    """convert carries a priority policy's class weights and the DVFS
    frequencies across; the rebuilt port core is served the carried
    targets and routes decision for decision."""
    from repro_torch import convert
    rng = np.random.default_rng(24)
    mu = flat_mu(rng.uniform(1, 30, (2, 3)), 2)
    flat = flatten_mixes(np.array([[4, 3], [8, 6]]))
    ref = RCore(rget("grin-p", weights=[4.0, 1.0]), mu)
    ref.set_frequencies([1.0, 0.75, 1.25])
    ref.set_class_weights([3.0, 1.0])
    ref.notify_type_counts(flat)
    types = rng.integers(0, 4, 60)
    head = [ref.route(int(t)) for t in types[:20]]
    state = convert.scheduler_core_state(ref)
    port = convert.scheduler_core_from_state(
        state, get_policy("grin-p", weights=[1.0, 1.0]), device=CPU)
    np.testing.assert_array_equal(port.policy.class_weights, [3.0, 1.0])
    np.testing.assert_array_equal(port.frequencies, [1.0, 0.75, 1.25])
    np.testing.assert_array_equal(port.counts, ref.counts)
    assert len(head) == 20 and port.resolves == 0
    assert [port.route(int(t)) for t in types[20:]] == \
        [ref.route(int(t)) for t in types[20:]]
    assert port.resolves == 0           # the carried target was served
    back = convert.scheduler_core_state(port)
    for key in ("class_weights", "frequencies", "targets", "mu"):
        np.testing.assert_array_equal(back[key], convert.scheduler_core_state(
            ref)[key])


def test_elastic_what_if_weighted_x_physical_energy_matches_reference():
    """Priority what-ifs: the X grids are the policy's weighted objective,
    energy and EDP stay physical, on both packages (float32 grids, rtol
    1e-5)."""
    rng = np.random.default_rng(20)
    mu = flat_mu(rng.uniform(1, 30, (2, 3)), 2)
    flat = flatten_mixes(np.array([[2, 2], [6, 6]]))[None]
    cols = rng.uniform(1, 30, size=(1, 4))
    port = SchedulerCore(get_policy("grin-p", weights=[4.0, 1.0]), mu,
                         device=CPU).elastic_what_if(flat,
                                                     added_columns=cols)
    ref = RCore(rget("grin-p", weights=[4.0, 1.0]), mu).elastic_what_if(
        flat, added_columns=cols)
    assert set(port) == set(ref)
    for key in ref:
        np.testing.assert_allclose(port[key], np.asarray(ref[key]),
                                   rtol=1e-5, err_msg=key)
