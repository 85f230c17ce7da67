"""Port parity: closed forms (`repro_torch.core.{throughput,energy,
affinity,cab,exhaustive,slsqp}`).

Host float64 forms are copies of the reference's and must match it
exactly; the batched float32 torch forms match the reference's jnp forms to
float32 resolution (rtol 2e-6: a few ulps, the sum order may differ)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.throughput as rt  # noqa: E402
import repro.core.energy as re_  # noqa: E402
from repro.core import affinity as raff  # noqa: E402
from repro.core import cab as rcab  # noqa: E402
from repro.core import exhaustive as rex  # noqa: E402
from repro.core import slsqp as rsl  # noqa: E402
import repro_torch.core.throughput as tt  # noqa: E402
import repro_torch.core.energy as te  # noqa: E402
from repro_torch.core import affinity as taff  # noqa: E402
from repro_torch.core import cab as tcab  # noqa: E402
from repro_torch.core import exhaustive as tex  # noqa: E402
from repro_torch.core import slsqp as tsl  # noqa: E402

RTOL32 = 2e-6


def _state(seed, k=4, l=6, busy=True):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1.0, 30.0, size=(k, l))
    N = rng.integers(0 if not busy else 1, 9, size=(k, l))
    N[rng.integers(k), rng.integers(l)] = 0
    return N, mu


@pytest.mark.parametrize("seed", range(4))
def test_host_closed_forms_match_exactly(seed):
    N, mu = _state(seed)
    P = 0.5 * mu ** 0.7
    for fn in ("column_throughputs", "power_rate_columns"):
        np.testing.assert_array_equal(getattr(tt, fn)(N, mu),
                                      getattr(rt, fn)(N, mu))
    assert tt.system_throughput(N, mu) == rt.system_throughput(N, mu)
    for p in range(N.shape[0]):
        for fn in ("delta_x_add", "delta_x_remove"):
            np.testing.assert_array_equal(getattr(tt, fn)(N, mu, p),
                                          getattr(rt, fn)(N, mu, p))
        for m in (1, 2, 5):
            for fn in ("delta_x_add_block", "delta_x_remove_block"):
                np.testing.assert_array_equal(getattr(tt, fn)(N, mu, p, m),
                                              getattr(rt, fn)(N, mu, p, m))
            for fn in ("delta_w_add_block", "delta_w_remove_block"):
                np.testing.assert_array_equal(getattr(tt, fn)(N, P, p, m),
                                              getattr(rt, fn)(N, P, p, m))
            for s, d in ((0, 1), (2, 5), (3, 3)):
                for fn in ("delta_energy_move_block", "delta_edp_move_block"):
                    assert getattr(tt, fn)(N, mu, P, p, s, d, m) == \
                        getattr(rt, fn)(N, mu, P, p, s, d, m)
    power = taff.PowerModel(alpha=0.5, coeff=2.0)
    rpower = raff.PowerModel(alpha=0.5, coeff=2.0)
    assert te.expected_energy_per_task(N, mu, power) == \
        re_.expected_energy_per_task(N, mu, rpower)
    assert te.expected_delay(N, mu) == re_.expected_delay(N, mu)
    assert te.edp(N, mu, power) == re_.edp(N, mu, rpower)
    np.testing.assert_array_equal(power.power_matrix(mu),
                                  rpower.power_matrix(mu))


def test_batched_torch_forms_match_jax_to_float32_resolution():
    rng = np.random.default_rng(9)
    Ns = rng.integers(0, 50, size=(24, 4, 6)).astype(np.float32)
    Ns[3] = 0.0                                     # empty state: X = 0
    mus = rng.uniform(1, 30, size=(24, 4, 6)).astype(np.float32)
    power = taff.PowerModel(alpha=0.5, coeff=1.5)
    rpower = raff.PowerModel(alpha=0.5, coeff=1.5)
    Ps_t = te.power_matrix_torch(torch.as_tensor(mus), power)
    Ps_r = np.array(re_.power_matrix_jax(mus, rpower))
    np.testing.assert_allclose(Ps_t.numpy(), Ps_r, rtol=RTOL32)
    Nt, mt = torch.as_tensor(Ns), torch.as_tensor(mus)
    np.testing.assert_allclose(
        tt.system_throughput_batch_torch(Nt, mt).numpy(),
        np.asarray(__import__("jax").vmap(rt.system_throughput_jax)(Ns, mus)),
        rtol=RTOL32)
    np.testing.assert_allclose(
        tt.system_throughput_batch_torch(Nt, mt[0]).numpy(),
        np.asarray(rt.system_throughput_batch_jax(Ns, mus[0])), rtol=RTOL32)
    np.testing.assert_allclose(
        tt.column_throughputs_torch(Nt[5], mt[5]).numpy(),
        np.asarray(rt.column_throughputs_jax(Ns[5], mus[5])), rtol=RTOL32)
    for tf, rf, extra in (
            (te.expected_energy_batch_torch, re_.expected_energy_batch_jax,
             (Ps_r,)),
            (te.expected_delay_batch_torch, re_.expected_delay_batch_jax, ()),
            (te.edp_batch_torch, re_.edp_batch_jax, (Ps_r,))):
        got = tf(Nt, mt, *(torch.as_tensor(a) for a in extra)).numpy()
        want = np.asarray(rf(Ns, mus, *extra))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL32)


@pytest.mark.parametrize("seed", range(3))
def test_two_by_two_solutions_match_exactly(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        mu = rng.uniform(1, 30, size=(2, 2))
        n1, n2 = (int(v) for v in rng.integers(0, 12, size=2))
        assert taff.classify_2x2(mu).value == raff.classify_2x2(mu).value
        np.testing.assert_allclose(tt.throughput_map_2x2(n1, n2, mu),
                                   rt.throughput_map_2x2(n1, n2, mu),
                                   rtol=RTOL32)
        t, r = tcab.cab_solve(mu, n1, n2), rcab.cab_solve(mu, n1, n2)
        assert t.s_max == r.s_max and t.policy == r.policy
        np.testing.assert_array_equal(t.state, r.state)
        np.testing.assert_array_equal(
            tcab.cab_target_state(mu, [n1, n2]),
            rcab.cab_target_state(mu, [n1, n2]))


def test_invalid_two_by_two_falls_back_to_the_same_map_argmax():
    mu = np.array([[2.0, 5.0], [7.0, 3.0]])       # violates eq. 2 (case b.4)
    assert taff.classify_2x2(mu) is taff.AffinityCase.INVALID
    np.testing.assert_array_equal(tcab.cab_solve(mu, 6, 5).state,
                                  rcab.cab_solve(mu, 6, 5).state)


def test_exhaustive_and_rounding_match_exactly():
    rng = np.random.default_rng(4)
    mu = rng.uniform(1, 30, size=(3, 3))
    nt = np.array([3, 2, 4])
    Nt, xt = tex.exhaustive_solve(mu, nt)
    Nr, xr = rex.exhaustive_solve(mu, nt)
    np.testing.assert_array_equal(Nt, Nr)
    assert xt == xr
    assert tex.exhaustive_count(nt, 3) == rex.exhaustive_count(nt, 3)
    cont = rng.uniform(0, 5, size=(3, 4))
    cont *= (np.array([7, 9, 4]) / cont.sum(axis=1))[:, None]
    np.testing.assert_array_equal(
        tsl.round_largest_remainder(cont, [7, 9, 4]),
        rsl.round_largest_remainder(cont, [7, 9, 4]))
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(
        taff.random_affinity_matrix(rng_a, 3, 4),
        raff.random_affinity_matrix(rng_b, 3, 4))
