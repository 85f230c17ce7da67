"""Port parity: the GrIn solvers (`repro_torch.core.{grin,grin_energy}`).

Host solvers (f64) are copies and must match the reference exactly. The
batched device solver runs here on the CPU through the plain scorer and is
held to: the same Algorithm-1 init, X_sys within float32 resolution of the
reference's batched solver, equal converged flags, exact row sums after the
repair, and block X_sys >= single-move X_sys (the reference's acceptance
criterion for the block solver)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import grin as rg  # noqa: E402
from repro.core import grin_energy as rge  # noqa: E402
from repro.core.affinity import PowerModel as RPower  # noqa: E402
from repro_torch.core import grin as tg  # noqa: E402
from repro_torch.core import grin_energy as tge  # noqa: E402
from repro_torch.core.affinity import PowerModel as TPower  # noqa: E402
from repro_torch.core.throughput import system_throughput  # noqa: E402

RTOL32 = 2e-6


def _grid(seed, B=16, k=4, l=6, n=240):
    """Skewed mixes (Dirichlet 0.3), as the reference's solver benchmark."""
    rng = np.random.default_rng(seed)
    mus = rng.uniform(1, 30, size=(B, k, l))
    mixes = np.array([rng.multinomial(n, p)
                      for p in rng.dirichlet([0.3] * k, size=B)])
    return mus, mixes


@pytest.mark.parametrize("seed", range(3))
def test_host_solvers_match_exactly(seed):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1, 30, size=(3, 4))
    nt = rng.integers(1, 12, size=3)
    np.testing.assert_array_equal(tg.grin_init(mu, nt), rg.grin_init(mu, nt))
    a, b = tg.grin_solve(mu, nt), rg.grin_solve(mu, nt)
    np.testing.assert_array_equal(a.N, b.N)
    assert (a.x_sys, a.moves, a.sweeps) == (b.x_sys, b.moves, b.sweeps)
    a, b = tg.grin_block_solve(mu, nt * 40), rg.grin_block_solve(mu, nt * 40)
    np.testing.assert_array_equal(a.N, b.N)
    assert (a.x_sys, a.moves, a.converged, a.history) == \
        (b.x_sys, b.moves, b.converged, b.history)
    assert tg._ladder(1000) == rg._ladder(1000)
    for obj in ("max-x-e", "min-e", "min-edp"):
        a = tge.grin_energy_solve(mu, nt, TPower(alpha=0.5), obj)
        b = rge.grin_energy_solve(mu, nt, RPower(alpha=0.5), obj)
        np.testing.assert_array_equal(a.N, b.N)
        assert (a.x_sys, a.energy, a.edp, a.moves, a.converged) == \
            (b.x_sys, b.energy, b.edp, b.moves, b.converged)


def test_init_matches_reference_including_ties():
    import jax
    rng = np.random.default_rng(5)
    mus = rng.integers(1, 4, size=(24, 4, 5)).astype(np.float32)  # many ties
    mixes = rng.integers(0, 7, size=(24, 4)).astype(np.float32)
    want = np.asarray(jax.vmap(rg._grin_init_jax)(mus, mixes))
    got = tg._grin_init_torch(torch.as_tensor(mus), torch.as_tensor(mixes))
    np.testing.assert_array_equal(got.numpy(), want)


def test_single_move_solver_matches_reference():
    mus, mixes = _grid(2, B=3, n=60)
    for mu, mix in zip(mus, mixes):
        N, conv, moves = tg.grin_solve_torch(mu, mix, return_info=True,
                                             device="cpu")
        Nr, convr, movesr = rg.grin_solve_jax(mu, mix, return_info=True)
        np.testing.assert_array_equal(N.numpy(), np.asarray(Nr))
        assert bool(conv) == bool(convr) and int(moves) == int(movesr)


@pytest.mark.parametrize("objective", ["max-x", "max-x-e", "min-e",
                                       "min-edp"])
def test_batched_block_solver_matches_reference(objective):
    mus, mixes = _grid(10)
    N, xs, conv, moves = tg.grin_solve_batch_torch(
        mus, mixes, objective=objective, power=TPower(alpha=0.5),
        device="cpu")
    Nr, xr, convr, _ = rg.grin_solve_batch_jax(
        mus, mixes, objective=objective, power=RPower(alpha=0.5))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(convr))
    assert conv.all()
    xt = np.array([system_throughput(n, m) for n, m in zip(N.numpy(), mus)])
    xj = np.array([system_throughput(n, m)
                   for n, m in zip(np.asarray(Nr), mus)])
    np.testing.assert_allclose(xt, xj, rtol=RTOL32)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xr), rtol=RTOL32)
    np.testing.assert_array_equal(N.numpy().sum(axis=2), mixes)
    assert moves.dtype == torch.int32 and (moves >= 0).all()


@pytest.mark.parametrize("objective", ["max-x", "max-x-e", "min-e",
                                       "min-edp"])
def test_batched_block_solver_per_instance_mu_matches_reference(objective):
    """(B, k, l) per-instance affinities and an explicit P, as the grid
    solves pass them."""
    mus, mixes = _grid(12)
    P = 0.5 * mus ** 0.75
    N, xs, conv, _ = tg.grin_solve_batch_torch(
        mus, mixes, objective=objective, P=P, device="cpu")
    Nr, xr, convr, _ = rg.grin_solve_batch_jax(mus, mixes,
                                               objective=objective, P=P)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(convr))
    np.testing.assert_allclose(xs.numpy(), np.asarray(xr), rtol=RTOL32)
    np.testing.assert_array_equal(N.numpy().sum(axis=2), mixes)


@pytest.mark.parametrize("objective", ["max-x", "max-x-e", "min-e",
                                       "min-edp"])
def test_per_step_entry_point_is_the_cpu_path(objective):
    """On the CPU `grin_solve_batch_torch` runs the per-step loop, so the
    entry point that always runs it gives the same tensors."""
    mus, mixes = _grid(13, B=6)
    a = tg.grin_solve_batch_torch(mus, mixes, objective=objective,
                                  device="cpu")
    b = tg.grin_solve_batch_steps_torch(mus, mixes, objective=objective,
                                        device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("objective", ["max-x", "max-x-e", "min-e",
                                       "min-edp"])
def test_per_step_loop_takes_the_plain_scorer_on_any_device(objective):
    """The fused solve's plain version on the card is the per-step loop with
    the plain scorer passed in; on the CPU that is the default scorer."""
    from repro_torch.kernels.grin_moves import block_move_scores_reference
    mus, mixes = _grid(17, B=5)
    a = tg.grin_solve_batch_steps_torch(mus, mixes, objective=objective,
                                        device="cpu")
    b = tg.grin_solve_batch_steps_torch(mus, mixes, objective=objective,
                                        device="cpu",
                                        scorer=block_move_scores_reference)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_phase_scale_matches_the_closed_forms():
    """The threshold's scale, summed in the fused kernel's order, agrees
    with X_sys, |E[E]| and |EDP| to float32 resolution."""
    from repro_torch.core.energy import (edp_batch_torch,
                                         expected_energy_batch_torch)
    from repro_torch.core.throughput import system_throughput_torch
    from repro_torch.kernels import grin_moves as G
    rng = np.random.default_rng(4)
    N = torch.as_tensor(rng.integers(0, 40, size=(16, 4, 6)),
                        dtype=torch.float32)
    N[0] = 0.0                                  # X_sys = 0: inf scale
    mus = torch.as_tensor(rng.uniform(1, 30, size=(16, 4, 6)),
                          dtype=torch.float32)
    Ps = 0.7 * mus ** 0.5
    want = {G.OBJ_X: system_throughput_torch(N, mus),
            G.OBJ_XE: system_throughput_torch(N, mus),
            G.OBJ_E: expected_energy_batch_torch(N, mus, Ps).abs(),
            G.OBJ_E_GUARD: expected_energy_batch_torch(N, mus, Ps).abs(),
            G.OBJ_EDP: edp_batch_torch(N, mus, Ps).abs()}
    for obj, w in want.items():
        got = tg.phase_scale(N, mus, Ps, obj)
        torch.testing.assert_close(got, w, rtol=RTOL32, atol=0)


def test_block_dominates_single_move_and_tracks_host_mirror():
    mus, mixes = _grid(11, B=12, n=480)
    N, _, conv, _ = tg.grin_solve_batch_torch(mus, mixes, device="cpu")
    assert conv.all()
    for n, mu, mix in zip(N.numpy(), mus, mixes):
        x_block = system_throughput(n, mu)
        x_single = system_throughput(
            tg.grin_solve_torch(mu, mix, device="cpu").numpy(), mu)
        assert x_block >= x_single - RTOL32 * (1 + x_single)
        x_host = tg.grin_block_solve(mu, mix).x_sys
        assert x_block >= x_host - 4e-6 * (1 + x_host)


def test_batched_solver_validates_and_defaults_to_the_card(monkeypatch):
    mus, mixes = _grid(1, B=2)
    with pytest.raises(ValueError, match="n_tasks_batch"):
        tg.grin_solve_batch_torch(mus[0], mixes[0], device="cpu")
    with pytest.raises(ValueError, match="unknown objective"):
        tg.grin_solve_batch_torch(mus, mixes, objective="max-y",
                                  device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.grin_solve_batch_torch(mus, mixes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.grin_solve_torch(mus[0], mixes[0])
