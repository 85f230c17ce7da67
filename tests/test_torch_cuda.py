"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip elsewhere. They import nothing of JAX, so they run on a machine with
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: gains within 1e-5 * (1 + |g|) (float32, the two differ only in
the order of the column sums); best_idx equal wherever the m=1 direction
margin exceeds that band.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import grin_moves as G  # noqa: E402

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _states(seed, B, k=4, l=6, n=600):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1.0, 30.0, size=(B, k, l)).astype(np.float32)
    N = np.stack([np.stack([rng.multinomial(int(rng.integers(0, n)),
                                            rng.dirichlet([0.5] * l))
                            for _ in range(k)]) for _ in range(B)])
    return N.astype(np.float32), mu, (0.7 * mu ** 0.5).astype(np.float32)


@pytest.mark.parametrize("objective", [G.OBJ_X, G.OBJ_XE, G.OBJ_E, G.OBJ_EDP,
                                       G.OBJ_E_GUARD])
def test_block_move_kernel_matches_plain_version(cuda, objective):
    N, mu, P = _states(11 + objective, B=257)
    sizes = 2.0 ** np.arange(9, -1, -1, dtype=np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in (N, mu, sizes, P)]
    before = G.launches["block_move_gains"]
    kg, kbi, kbg, kbase = G.block_move_scores(
        *args[:3], P=args[3], objective=objective)
    assert G.launches["block_move_gains"] == before + 1
    pg, pbi, pbg, pbase = G.block_move_scores_reference(
        *args[:3], P=args[3], objective=objective)
    torch.cuda.synchronize()
    fin = torch.isfinite(pg)
    assert torch.equal(torch.isfinite(kg), fin)
    assert ((kg[fin] - pg[fin]).abs() <= TOL * (1 + pg[fin].abs())).all()
    fb = torch.isfinite(pbase)
    assert torch.equal(torch.isfinite(kbase), fb)
    assert ((kbase[fb] - pbase[fb]).abs() <= TOL * (1 + pbase[fb].abs())).all()
    if objective != G.OBJ_XE:       # the energy tie-break band decides there
        g1 = pg.reshape(len(N), len(sizes), -1)[:, -1]
        top2 = torch.topk(g1, 2, dim=1).values
        clear = ((top2[:, 0] - top2[:, 1]).nan_to_num(0.0, torch.inf)
                 > TOL * (1 + top2[:, 0].abs().nan_to_num(0.0, 0.0, 0.0)))
        assert torch.equal(kbi[clear], pbi[clear])


def test_block_move_kernel_selection_only_matches_with_gains(cuda):
    N, mu, _ = _states(3, B=1001, k=3, l=3, n=30)
    sizes = 2.0 ** np.arange(5, -1, -1, dtype=np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in (N, mu, sizes)]
    full = G.block_move_gains_cuda(*args)
    sel = G.block_move_gains_cuda(*args, return_gains=False)
    assert sel[0] is None
    for a, b in zip(full[1:], sel[1:]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous float32"):
        G.block_move_gains_cuda(args[0].double(), *args[1:])
