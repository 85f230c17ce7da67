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


# ------------------------------------------------------------ model kernels
#
# Tolerances (the reference sweep's, tests/test_kernels.py): attention
# 2e-2 in bfloat16 (the kernel takes bfloat16 only); SSD y 2e-4 in float32 and 5e-2 in
# bfloat16, the final state 1e-4 (float32 state from the same inputs on both sides);
# RMSNorm 1e-5 in float32 and 2e-2 in bfloat16.

def _rand(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev).to(dtype)


@pytest.mark.parametrize("b,s,h,kv,dh", [
    (1, 128, 4, 4, 128), (2, 200, 8, 2, 96), (2, 300, 6, 1, 64),
    (1, 64, 4, 2, 112), (1, 333, 2, 2, 32)])
@pytest.mark.parametrize("window", [0, 50])
def test_flash_attention_kernel_matches_plain_version(cuda, b, s, h, kv, dh,
                                                      window):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import flash_attention_ref
    dt = torch.bfloat16
    rng = np.random.default_rng(s + dh)
    q = _rand(rng, (b, s, h, dh), dt, cuda)
    k = _rand(rng, (b, s, kv, dh), dt, cuda)
    v = _rand(rng, (b, s, kv, dh), dt, cuda)
    before = FA.launches["flash_attention"]
    out = FA.flash_attention_cuda(q, k, v, causal=True, window=window)
    assert FA.launches["flash_attention"] == before + 1
    plain = FA.flash_attention_plain(q, k, v, causal=True, window=window,
                                     chunk_q=64, chunk_k=64)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    for other in (plain, ref):
        torch.testing.assert_close(out.float(), other.float(), atol=2e-2,
                                   rtol=2e-2)


def test_flash_attention_kernel_reads_strided_views(cuda):
    """k and v split out of one projection, as the model passes them."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    b, s, h, kv, dh = 2, 130, 4, 2, 112
    qkv = _rand(rng, (b, s, (h + 2 * kv) * dh), torch.bfloat16, cuda)
    q, k, v = torch.split(qkv, [h * dh, kv * dh, kv * dh], dim=-1)
    q, k, v = (t.reshape(b, s, -1, dh) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, window=64)
    plain = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), window=64)
    torch.testing.assert_close(out.float().cpu(), plain.float(), atol=2e-2,
                               rtol=2e-2)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(q.float(), k.float(), v.float())


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 130, 3, 16, 32, 32), (1, 64, 2, 64, 64, 16), (2, 96, 4, 8, 128, 32),
    (1, 700, 3, 64, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_matches_plain_version(cuda, b, s, h, dk, dv, chunk,
                                               dtype):
    from repro_torch.kernels import ssd_scan as SSD
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(s + dk)
    q = _rand(rng, (b, s, h, dk), dt, cuda)
    k = _rand(rng, (b, s, h, dk), dt, cuda)
    v = _rand(rng, (b, s, h, dv), dt, cuda)
    log_a = -torch.nn.functional.softplus(_rand(rng, (b, s, h), torch.float32,
                                                cuda))
    beta = torch.sigmoid(_rand(rng, (b, s, h), torch.float32, cuda))
    before = SSD.launches["ssd_scan"]
    y, state = SSD.ssd_scan_cuda(q, k, v, log_a, beta, chunk=chunk)
    assert SSD.launches["ssd_scan"] == before + 1
    yp, sp = SSD.ssd_scan_plain(q, k, v, log_a, beta, chunk=chunk)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, sp, atol=1e-4, rtol=1e-4)


def test_ssd_scan_kernel_reads_head_broadcast_views(cuda):
    """Mamba2 passes B and C expanded over heads (head stride 0)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(9)
    b, s, h, ds, hd = 2, 300, 6, 16, 32
    Bc = _rand(rng, (b, s, ds), torch.bfloat16, cuda)
    Cc = _rand(rng, (b, s, ds), torch.bfloat16, cuda)
    x = _rand(rng, (b, s, h * hd), torch.bfloat16, cuda).reshape(b, s, h, hd)
    log_a = -torch.nn.functional.softplus(_rand(rng, (b, s, h), torch.float32,
                                                cuda))
    beta = torch.sigmoid(_rand(rng, (b, s, h), torch.float32, cuda))
    Bh = Bc[:, :, None, :].expand(b, s, h, ds)
    Ch = Cc[:, :, None, :].expand(b, s, h, ds)
    y, state = ops.ssd_scan(Ch, Bh, x, log_a, beta, chunk=32)
    yp, sp = ops.ssd_scan(*(t.cpu() for t in (Ch, Bh, x, log_a, beta)),
                          chunk=32)
    torch.testing.assert_close(y.float().cpu(), yp.float(), atol=5e-2,
                               rtol=5e-2)
    torch.testing.assert_close(state.cpu(), sp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(64, 256), (2, 37, 256), (5, 128),
                                   (3, 3584), (7, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain_version(cuda, shape, dtype):
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as RN
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(shape[-1])
    x = _rand(rng, shape, dt, cuda)
    w = _rand(rng, (shape[-1],), torch.float32, cuda) * 0.1
    before = RN.launches["rmsnorm"]
    out = ops.rmsnorm(x, w)
    assert RN.launches["rmsnorm"] == before + 1
    plain = RN.rmsnorm_plain(x, w)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
