"""Port parity: GrIn+, SLSQP, the DVFS model and the SchedulerCore's DVFS
and topology members (`repro_torch.core.{grin_plus,slsqp,energy}`,
`repro_torch.sched.api`).

All are host float64 code copied from the reference, so results must be
identical: placements, move counts and throughputs exactly, SLSQP's
continuous optimum to rtol 1e-12 (same scipy call on the same inputs), the
DVFS float32 batch to float32 resolution (rtol 1e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro.core import energy as renergy  # noqa: E402
from repro.core import grin_plus as rgp  # noqa: E402
from repro.core import slsqp as rsl  # noqa: E402
from repro.sched import SchedulerCore as RCore  # noqa: E402
from repro.sched import get_policy as rget  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import grin_plus as tgp  # noqa: E402
from repro_torch.core import slsqp as tsl  # noqa: E402
from repro_torch.sched import SchedulerCore, get_policy  # noqa: E402

CPU = "cpu"


def _case(seed, k=3, l=3, n=(6, 7, 5)):
    rng = np.random.default_rng(seed)
    return rng.uniform(1, 30, size=(k, l)), np.asarray(n)


@pytest.mark.parametrize("seed", range(3))
def test_grin_plus_solvers_match_reference(seed):
    mu, nt = _case(60 + seed)
    for name in ("grin_plus_solve", "grin_multistart_solve"):
        a, b = getattr(tgp, name)(mu, nt), getattr(rgp, name)(mu, nt)
        np.testing.assert_array_equal(a.N, b.N)
        assert (a.x_sys, a.moves, a.sweeps) == (b.x_sys, b.moves, b.sweeps)
    N0 = np.zeros((3, 3), dtype=np.int64)
    N0[:, 0] = nt
    a, b = tgp.grin_solve_from(mu, N0), rgp.grin_solve_from(mu, N0)
    np.testing.assert_array_equal(a.N, b.N)
    assert (a.x_sys, a.moves) == (b.x_sys, b.moves)
    np.testing.assert_array_equal(
        get_policy("grin+").solve_target(mu, nt),
        rget("grin+").solve_target(mu, nt))


@pytest.mark.parametrize("seed", range(2))
def test_slsqp_and_rounding_match_reference(seed):
    mu, nt = _case(70 + seed, k=2, l=3, n=(9, 4))
    a, b = tsl.slsqp_solve(mu, nt), rsl.slsqp_solve(mu, nt)
    np.testing.assert_allclose(a.N, b.N, rtol=1e-12, atol=1e-12)
    assert a.x_sys == pytest.approx(b.x_sys, rel=1e-12)
    assert (a.success, a.message) == (b.success, b.message)
    assert tsl.slsqp_integer_rounded_x(a, mu, nt) == \
        rsl.slsqp_integer_rounded_x(b, mu, nt)
    np.testing.assert_array_equal(tsl.round_largest_remainder(a.N, nt),
                                  rsl.round_largest_remainder(b.N, nt))
    np.testing.assert_array_equal(
        get_policy("slsqp").solve_target(mu, nt),
        rget("slsqp").solve_target(mu, nt))
    assert get_policy("slsqp").integer_target is False


def test_dvfs_model_and_scenario_identities_match_reference():
    mu, nt = _case(80)
    P = 0.7 * mu ** 0.5
    f = np.array([0.5, 1.0, 1.25])
    for kw in ({}, {"alpha": 2.5, "levels": (0.6, 1.0), "idle_frac": 0.2}):
        a, b = tenergy.DVFSModel(**kw), renergy.DVFSModel(**kw)
        assert a.levels == b.levels
        np.testing.assert_array_equal(a.scale_mu(mu, f), b.scale_mu(mu, f))
        np.testing.assert_array_equal(a.scale_power(P, f),
                                      b.scale_power(P, f))
        assert a.energy_scale(0.75) == b.energy_scale(0.75)
        np.testing.assert_array_equal(a.idle_power(P, [1.0, 0.0, 2.0]),
                                      b.idle_power(P, [1.0, 0.0, 2.0]))
        fs = np.array([[1.0, 1.0, 1.0], [0.5, 0.75, 1.25]])
        tm, tp = a.scale_torch(mu, P, fs, device=CPU)
        rm, rp = b.scale_jax(mu, P, fs)
        np.testing.assert_allclose(tm.numpy(), np.asarray(rm), rtol=1e-6)
        np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=1e-6)
    for bad in ({"alpha": 0.5}, {"levels": (1.0, 0.5)}, {"idle_frac": 1.0}):
        with pytest.raises(ValueError):
            tenergy.DVFSModel(**bad)
    N = get_policy("grin").solve_target(mu, nt)
    assert tenergy.scenario_identities(N, mu) == \
        renergy.scenario_identities(N, mu)


def test_set_frequencies_and_pool_added_frequency_match_reference():
    mu, nt = _case(90)
    port = SchedulerCore("grin", mu, device=CPU).reset(mu, nt)
    ref = RCore("grin", mu).reset(mu, nt)
    rng = np.random.default_rng(5)
    types = rng.integers(0, 3, 40)
    for core in (port, ref):
        np.testing.assert_array_equal(core.frequencies, np.ones(3))
        core.set_frequencies([0.5, 1.0, 1.25])
        core.pool_added(np.array([12.0, 3.0, 7.0]), frequency=0.75)
    for name in ("mu", "base_mu", "nominal_mu", "frequencies"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert port._mu_token == ref._mu_token
    assert [port.route(int(t)) for t in types] == \
        [ref.route(int(t)) for t in types]
    port.pool_lost(1)
    ref.pool_lost(1)
    np.testing.assert_array_equal(port.frequencies, ref.frequencies)
    for bad in ([1.0, 1.0], [1.0, 0.0, 1.0], [1.0, np.inf, 1.0]):
        with pytest.raises(ValueError, match="frequencies"):
            port.set_frequencies(bad)
    with pytest.raises(ValueError, match="frequency"):
        port.pool_added(np.ones(3), frequency=0.0)


@pytest.mark.parametrize("refresh", [True, False])
def test_repin_target_under_refresh_on_topology_matches_reference(refresh):
    mu, nt = _case(95)
    pinned = get_policy("grin").solve_target(mu, nt)
    port = SchedulerCore(get_policy("fixed", target=pinned), mu, device=CPU,
                         refresh_on_topology=refresh).reset(mu, nt)
    ref = RCore(rget("fixed", target=pinned), mu,
                refresh_on_topology=refresh).reset(mu, nt)
    types = np.random.default_rng(6).integers(0, 3, 30)
    for core in (port, ref):
        core.pool_lost(0)
    np.testing.assert_array_equal(port.policy._fixed, ref.policy._fixed)
    if not refresh:             # the pinned target keeps its old shape
        for core in (port, ref):
            with pytest.raises(ValueError, match="re-pinned"):
                core.route(int(types[0]))
        return
    assert port.policy._fixed.shape == (3, 2)
    assert port.policy._fixed.sum() == nt.sum()      # re-homed, not lost
    for core in (port, ref):
        core.pool_added(np.array([9.0, 9.0, 9.0]))
    np.testing.assert_array_equal(port.policy._fixed, ref.policy._fixed)
    assert [port.route(int(t)) for t in types] == \
        [ref.route(int(t)) for t in types]
    get_policy("grin").repin_target(mu, lost=0)      # solvers: a no-op
