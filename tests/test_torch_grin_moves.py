"""Port parity: the block-move scorer (`repro_torch.kernels.grin_moves`).

The port's plain PyTorch version is held against the reference's jnp path
(`block_move_scores(use_kernel=False)`) on seeded states, for all five
objectives and both output modes:

  * gains: the same -inf pattern, finite entries within 1e-5 * (1 + |g|)
    (float32; the two frameworks may sum the columns in another order);
  * best_idx: exact wherever the instance's m=1 margin — the gap between
    the steepest direction and the runner-up — exceeds the near-tie band
    1e-5 * (1 + |base|); inside the band a one-ulp difference may pick the
    other direction, which is equally good;
  * best_gain / base_gain: within 1e-5 * (1 + |g|).

The CUDA kernel itself runs only on a card: `tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import grin_moves as ref  # noqa: E402
from repro_torch.kernels import grin_moves as port  # noqa: E402

TOL = 1e-5


def _case(seed, B=32, k=4, l=6, M=9, n_max=300):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1.0, 30.0, size=(B, k, l)).astype(np.float32)
    P = (0.7 * mu ** 0.5).astype(np.float32)
    N = np.stack([np.stack([rng.multinomial(int(rng.integers(0, n_max)),
                                            rng.dirichlet([0.5] * l))
                            for _ in range(k)]) for _ in range(B)])
    N = N.astype(np.float32)
    N[0] = 0.0                          # an empty state: every move -inf
    N[1, :, 1:] = 0.0                   # one busy column: drains
    sizes = (2.0 ** np.arange(M - 1, -1, -1)).astype(np.float32)
    return N, mu, P, sizes


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _margin(g1):
    s = np.sort(g1, axis=1)
    top, second = s[:, -1], s[:, -2]
    with np.errstate(invalid="ignore"):
        return np.where(np.isfinite(top), top - second, np.inf), top


@pytest.mark.parametrize("return_gains", [True, False])
@pytest.mark.parametrize("objective", [port.OBJ_X, port.OBJ_XE, port.OBJ_E,
                                       port.OBJ_EDP, port.OBJ_E_GUARD])
def test_plain_scorer_matches_reference(objective, return_gains):
    assert (port.OBJ_X, port.OBJ_XE, port.OBJ_E, port.OBJ_EDP,
            port.OBJ_E_GUARD) == (ref.OBJ_X, ref.OBJ_XE, ref.OBJ_E,
                                  ref.OBJ_EDP, ref.OBJ_E_GUARD)
    N, mu, P, sizes = _case(100 + objective)
    rg, rbi, rbg, rbase = (None if v is None else np.asarray(v) for v in
                           ref.block_move_scores(N, mu, sizes,
                                                 use_kernel=False,
                                                 return_gains=True, P=P,
                                                 objective=objective))
    tg, tbi, tbg, tbase = port.block_move_scores(
        _t(N), _t(mu), _t(sizes), return_gains=return_gains, P=_t(P),
        objective=objective)
    if return_gains:
        tg = tg.numpy()
        np.testing.assert_array_equal(np.isfinite(tg), np.isfinite(rg))
        np.testing.assert_array_equal(np.isneginf(tg), np.isneginf(rg))
        fin = np.isfinite(rg)
        assert (np.abs(tg[fin] - rg[fin]) <= TOL * (1 + np.abs(rg[fin]))).all()
    else:
        assert tg is None
    assert tbi.dtype == torch.int32
    B = N.shape[0]
    g1 = rg.reshape(B, len(sizes), -1)[:, -1]
    margin, top = _margin(g1)
    clear = margin > TOL * (1 + np.abs(top))
    if objective == port.OBJ_XE:
        clear &= False                  # the energy tie-break decides: below
    sel = np.flatnonzero(clear)
    np.testing.assert_array_equal(tbi.numpy()[sel], rbi[sel])
    both = np.isfinite(rbase)
    np.testing.assert_array_equal(np.isfinite(tbase.numpy()), both)
    assert (np.abs(tbase.numpy()[both] - rbase[both])
            <= TOL * (1 + np.abs(rbase[both]))).all()
    fin = np.isfinite(rbg)
    assert (np.abs(tbg.numpy()[fin] - rbg[fin])
            <= TOL * (1 + np.abs(rbg[fin]))).all()


def test_xe_selection_matches_reference_on_clear_cases():
    """OBJ_XE picks among near-tied directions by energy drop; on seeded
    cases the selection is exact (no second near-tie in the energy drop)."""
    N, mu, P, sizes = _case(7)
    r = ref.block_move_scores(N, mu, sizes, use_kernel=False, P=P,
                              objective=ref.OBJ_XE)
    t = port.block_move_scores(_t(N), _t(mu), _t(sizes), P=_t(P),
                               objective=port.OBJ_XE)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(r[1]))


def test_plain_scorer_matches_pallas_interpret():
    """Against the Pallas kernel body itself (interpret mode on the CPU) on
    the (16, 4, 6, 11) case of tests/test_solver_block.py, where ROADMAP
    queue C measured the reference's own interpret-vs-jnp gap (2.1e-6, in
    full 2.1457672e-6 = 9 float32 ulps at magnitude 2): gains within that
    gap, selections equal."""
    rng = np.random.default_rng(0)
    for b, k, l in ((5, 3, 3), (16, 4, 6)):     # same draws as that test
        N = rng.integers(0, 20, size=(b, k, l)).astype(np.float32)
        mu = rng.uniform(1, 30, size=(b, k, l)).astype(np.float32)
    sizes = (2.0 ** np.arange(10, -1, -1)).astype(np.float32)
    rg, rbi, rbg, rbase = (np.asarray(v) for v in
                           ref.block_move_gains_pallas(N, mu, sizes,
                                                       interpret=True))
    tg, tbi, tbg, tbase = (v.numpy() for v in port.block_move_scores(
        _t(N), _t(mu), _t(sizes)))
    fin = np.isfinite(rg)
    np.testing.assert_array_equal(np.isfinite(tg), fin)
    assert np.abs(tg[fin] - rg[fin]).max() <= 2.1457672e-6
    np.testing.assert_array_equal(tbi, rbi)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    N, mu, P, sizes = _case(5, B=4)
    before = dict(port.launches)
    out = port.block_move_scores(_t(N), _t(mu), _t(sizes), P=_t(P),
                                 objective=port.OBJ_E)
    plain = port.block_move_scores_reference(_t(N), _t(mu), _t(sizes),
                                             P=_t(P), objective=port.OBJ_E)
    for a, b in zip(out, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert port.launches == before
    with pytest.raises(ValueError, match="power matrix"):
        port.block_move_scores(_t(N), _t(mu), _t(sizes),
                               objective=port.OBJ_E)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises instead."""
    N, mu, _, sizes = _case(5, B=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.block_move_gains_cuda(_t(N), _t(mu), _t(sizes))


def test_fused_solve_wrapper_refuses_cpu_tensors_and_bad_inputs():
    """The fused solve's wrapper launches on CUDA tensors only; on the CPU
    it raises (the per-step loop is the CPU's path) and counts nothing."""
    N, mu, P, _ = _case(6, B=4)
    sizes = _t((2.0 ** np.arange(3, -1, -1)).astype(np.float32))
    before = dict(port.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.grin_block_solve_cuda(_t(N), _t(mu), sizes, 10)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.grin_block_solve_cuda(_t(N), _t(mu), sizes, 10, P=_t(P),
                                   objective=port.OBJ_EDP)
    with pytest.raises(ValueError, match="power matrix"):
        port.grin_block_solve_cuda(_t(N), _t(mu), sizes, 10,
                                   objective=port.OBJ_E)
    with pytest.raises(ValueError, match="OBJ_X, OBJ_XE"):
        port.grin_block_solve_cuda(_t(N), _t(mu), sizes, 10, P=_t(P),
                                   objective=port.OBJ_E_GUARD)
    with pytest.raises(ValueError, match="N0 must be"):
        port.grin_block_solve_cuda(_t(N[0]), _t(mu), sizes, 10)
    assert port.launches == before
    assert set(port.launches) == {"block_move_gains", "grin_solve"}
