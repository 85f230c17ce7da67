"""The SSD scan's gradient in the port against the reference, on the CPU.

The reference has no backward kernel: it differentiates its jnp route,
`repro.models.linear_scan.linear_scan_chunked`, with `jax.vjp`. So that
vjp is the oracle of the port's plain backwards, `ssd_scan_bwd_plain` and
`mlstm_scan_bwd_plain` (the float32 math the CUDA backward kernels
compute); for mLSTM's pair the reference's two calls (the memory's scan
and the normaliser's, v = ones) are differentiated together. Inputs are
float32, drawn with numpy from a seed and handed to both. Tolerance: for
every gradient, max |port - ref| / (rms(ref) + |ref|) <= TOL = 2e-5
(float32; the two differ in summation order and chunking only, and read
~1e-6). The plain backward with its reverse carry cut between chunks reads
above 0.1 at slow decay, so the check sees a carry fault.

The card's route (the forward kernels and the backward kernels in
`torch.autograd.Function`s) is held here on CPU stand-ins: the kernels'
wrappers replaced by their plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models.linear_scan import linear_scan_chunked as ref_scan  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels import ssd_scan_bwd as SB  # noqa: E402
from repro_torch.kernels import ssd_scan_wide as SSDW  # noqa: E402
from repro_torch.models.linear_scan import linear_scan_chunked  # noqa: E402

TOL = 2e-5
FAST, SLOW = 0.0, 6.0       # forget-gate biases: log_a ~ -0.8 or -0.004


def grad_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (np.sqrt((b ** 2).mean())
                                   + np.abs(b))).max())


def _inputs(seed, b, s, h, dk, dv, bias, shared, final):
    """q, k ((B, S, 1, dk) when shared by the heads), v, log_a =
    log_sigmoid(. + bias), beta = sigmoid(.), dy, and d_state (zero unless
    `final`), dnm, dn for the pair, float32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    hq = 1 if shared else h

    def randn(*shape):
        return rng.standard_normal(shape).astype(f)
    q = randn(b, s, hq, dk) / np.sqrt(dk)
    k = randn(b, s, hq, dk)
    v = randn(b, s, h, dv)
    log_a = -np.log1p(np.exp(-(randn(b, s, h) + bias))).astype(f)
    beta = (1.0 / (1.0 + np.exp(-randn(b, s, h)))).astype(f)
    dy = randn(b, s, h, dv)
    zero = np.zeros((b, h, dk, dv), f)
    d_state = randn(b, h, dk, dv) if final else zero
    dnm = randn(b, s, h, 1)
    dn = randn(b, h, dk, 1) if final else zero[..., :1]
    return q, k, v, log_a, beta, dy, d_state, dnm, dn


def _ref_grads(x, chunk, pair):
    """jax.vjp of the reference's scan (and with `pair` of its normaliser's
    too) at the cotangents; q and k broadcast over the heads inside."""
    q, k, v, log_a, beta, dy, d_state, dnm, dn = x
    b, s, h, dk = *v.shape[:3], q.shape[-1]

    def f(q, k, v, log_a, beta):
        qb, kb = (jnp.broadcast_to(t, (b, s, h, dk)) for t in (q, k))
        out = ref_scan(qb, kb, v, log_a, beta, chunk=chunk)
        if pair:
            ones = jnp.ones((b, s, h, 1), jnp.float32)
            out = (*out, *ref_scan(qb, kb, ones, log_a, beta, chunk=chunk))
        return out
    _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in x[:5]))
    cts = (dy, d_state, dnm, dn) if pair else (dy, d_state)
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(t) for t in cts))]


def _port_grads(x, chunk, pair, final, cut_carry=False):
    q, k, v, log_a, beta, dy, d_state, dnm, dn = (torch.from_numpy(t)
                                                  for t in x)
    h = v.shape[2]
    q, k = (t.expand(t.shape[0], t.shape[1], h, t.shape[3]) for t in (q, k))
    if pair:
        out = SB.mlstm_scan_bwd_plain(
            q, k, v, log_a, beta, dy, dnm, d_state if final else None,
            dn if final else None, chunk=chunk, cut_carry=cut_carry)
    else:
        out = SB.ssd_scan_bwd_plain(q, k, v, log_a, beta, dy,
                                    d_state if final else None, chunk=chunk,
                                    cut_carry=cut_carry)
    return [t.numpy() for t in out]


# (B, S, H, dk, dv, chunk, forget bias, q / k shared by the heads, a final
# state cotangent): S a multiple of neither chunk, chunks of 16 and 32
SSD_CASES = [
    (2, 50, 3, 16, 16, 16, FAST, False, True),
    (2, 50, 3, 16, 16, 16, SLOW, False, True),
    (2, 50, 3, 16, 16, 16, SLOW, True, False),
    (1, 70, 2, 16, 16, 32, SLOW, True, True),
    (1, 70, 2, 32, 8, 32, FAST, False, False),
    (1, 70, 2, 32, 8, 16, SLOW, True, True),
    (2, 45, 2, 16, 1, 16, SLOW, False, True),
    (1, 70, 3, 16, 1, 32, FAST, True, False),
]
PAIR_CASES = [
    (2, 50, 3, 16, 16, 16, SLOW, False, True),
    (1, 70, 2, 32, 8, 32, FAST, False, True),
    (1, 70, 2, 16, 16, 32, SLOW, False, False),
]


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,bias,shared,final", SSD_CASES)
def test_ssd_bwd_plain_matches_reference_vjp(b, s, h, dk, dv, chunk, bias,
                                             shared, final):
    x = _inputs(1, b, s, h, dk, dv, bias, shared, final)
    want = _ref_grads(x, chunk, pair=False)
    got = _port_grads(x, chunk, pair=False, final=final)
    for name, g, w in zip(("dq", "dk", "dv", "dlog_a", "dbeta"), got, want):
        assert g.shape == w.shape, name
        assert grad_err(g, w) <= TOL, (name, grad_err(g, w))


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,bias,shared,final", PAIR_CASES)
def test_mlstm_bwd_plain_matches_reference_pair_vjp(b, s, h, dk, dv, chunk,
                                                    bias, shared, final):
    x = _inputs(2, b, s, h, dk, dv, bias, shared, final)
    want = _ref_grads(x, chunk, pair=True)
    got = _port_grads(x, chunk, pair=True, final=final)
    for name, g, w in zip(("dq", "dk", "dv", "dlog_a", "dbeta"), got, want):
        assert g.shape == w.shape, name
        assert grad_err(g, w) <= TOL, (name, grad_err(g, w))


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("final", [False, True])
def test_cut_reverse_carry_fails_the_tolerance(pair, final):
    """The negative control: the reverse carry cut between chunks (dS
    entering a chunk its own term alone) reads far beyond TOL at slow decay
    in dk, dv, dlog_a and dbeta (dq does not use the reverse carry)."""
    x = _inputs(3, 2, 50, 3, 16, 16, SLOW, False, final)
    want = _ref_grads(x, 16, pair)
    got = _port_grads(x, 16, pair, final, cut_carry=True)
    errs = [grad_err(g, w) for g, w in zip(got, want)]
    assert errs[0] <= TOL
    assert min(errs[1:]) > 1e4 * TOL, errs


def test_chunk_beyond_the_tile_is_the_same_recurrence():
    """The backward walks chunks of min(chunk, 64) tokens: chunk 256 and
    chunk 64 are one computation, and both match the vjp at chunk 256."""
    x = _inputs(4, 1, 150, 2, 16, 8, SLOW, True, True)
    a = _port_grads(x, 256, False, True)
    b = _port_grads(x, 64, False, True)
    want = _ref_grads(x, 256, pair=False)
    for g, h, w in zip(a, b, want):
        np.testing.assert_array_equal(g, h)
        assert grad_err(g, w) <= TOL


# ------------------------------------------------------------ card route

@pytest.fixture
def card_stand_in(monkeypatch):
    """`ops` as on the card, with the scan kernels' wrappers replaced by
    stand-ins that count a call and compute the plain versions."""
    calls = {"fwd": 0, "wide_fwd": 0, "pair_fwd": 0, "bwd": 0,
             "wide_bwd": 0, "pair_bwd": 0}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            with torch.no_grad():
                return fn(*args, **kw)
        return run

    def no_plain(*args, **kw):
        raise AssertionError("the plain scan ran on the card route")
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    monkeypatch.setattr(ops, "linear_scan_chunked", no_plain)
    monkeypatch.setattr(SSD, "ssd_scan_cuda",
                        counted("fwd", linear_scan_chunked))
    monkeypatch.setattr(SSDW, "ssd_scan_wide_cuda",
                        counted("wide_fwd", linear_scan_chunked))
    monkeypatch.setattr(SSDW, "mlstm_scan_cuda",
                        counted("pair_fwd", SSDW.mlstm_scan_plain))
    monkeypatch.setattr(SB, "ssd_scan_bwd_cuda",
                        counted("bwd", SB.ssd_scan_bwd_plain))
    monkeypatch.setattr(SB, "ssd_scan_wide_bwd_cuda",
                        counted("wide_bwd", SB.ssd_scan_bwd_plain))
    monkeypatch.setattr(SB, "mlstm_scan_bwd_cuda",
                        counted("pair_bwd", SB.mlstm_scan_bwd_plain))
    return calls


def _leaves(seed, b, s, h, dk, dv, dtype, shared):
    """Leaves and a function making the scan's inputs from them as a Mamba2
    layer makes them: q and k one row a token expanded over the heads when
    `shared` (head stride 0), else strided views of one projection; log_a
    and beta float32, through the gates."""
    rng = np.random.default_rng(seed)

    def t(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt).requires_grad_(True)
    base = [t(b, s, dk), t(b, s, dk)] if shared else [t(b, s, h, 2 * dk)]
    leaves = [*base, t(b, s, h, dv), t(b, s, h, dt=torch.float32),
              t(b, s, h, dt=torch.float32)]

    def make():
        if shared:
            q, k = (x[:, :, None].expand(b, s, h, dk) for x in leaves[:2])
        else:
            q, k = leaves[0][..., :dk], leaves[0][..., dk:]
        v, la_raw, beta_raw = leaves[-3:]
        return (q, k, v, torch.nn.functional.logsigmoid(la_raw + SLOW),
                torch.sigmoid(beta_raw))
    return make, leaves


def _grads(loss_of, leaves):
    for x in leaves:
        x.grad = None
    loss_of().backward()
    return [x.grad.clone() for x in leaves]


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("final", [False, True])
def test_card_route_ssd_scan_is_the_kernel_pair_under_grad(card_stand_in,
                                                           shared, final):
    """Under grad `ops.ssd_scan` on the card is `_SSDScan`: one forward and
    one backward call, autograd's gradients of the plain route (q and k
    shared by the heads summed over them), a None state cotangent when the
    state is unused; without grad, the forward alone."""
    b, s, h, dk, dv = 2, 45, 3, 16, 8
    make, leaves = _leaves(5, b, s, h, dk, dv, torch.float32, shared)
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, h, dk, dv)).astype(np.float32))

    def loss(scan):
        def run():
            y, st = scan(*make(), chunk=16)
            return (y.square().sum() + (st * w).sum()) if final \
                else y.square().sum()
        return run
    got = _grads(loss(ops.ssd_scan), leaves)
    assert card_stand_in["fwd"] == 1 and card_stand_in["bwd"] == 1
    want = _grads(loss(linear_scan_chunked), leaves)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, rtol=1e-5, atol=1e-5 * float(
            x.abs().max()))
    with torch.no_grad():
        ops.ssd_scan(*make(), chunk=16)
    assert card_stand_in["fwd"] == 2 and card_stand_in["bwd"] == 1


def test_card_route_mlstm_scan_is_the_kernel_pair_under_grad(card_stand_in):
    """Under grad `ops.mlstm_scan` on the card is `_MLSTMScan`: one call of
    the pair forward and one of its backward, autograd's gradients of the
    two plain scans, with C and n unused (None cotangents) as in
    training, and with their cotangents."""
    b, s, h, dk, dv = 2, 45, 2, 16, 8
    make, leaves = _leaves(7, b, s, h, dk, dv, torch.float32, False)

    def loss(scan, final):
        def run():
            y, C, nm, n = scan(*make(), chunk=16)
            out = (y / nm.abs().clamp(min=1.0)).square().sum()
            return out + C.sum() + 2 * n.sum() if final else out
        return run
    for i, final in enumerate((False, True)):
        got = _grads(loss(ops.mlstm_scan, final), leaves)
        assert card_stand_in["pair_fwd"] == card_stand_in["pair_bwd"] == i + 1
        want = _grads(loss(SSDW.mlstm_scan_plain, final), leaves)
        for g, x in zip(got, want):
            torch.testing.assert_close(g, x, rtol=1e-5, atol=1e-5 * float(
                x.abs().max()))


def test_card_route_keeps_dtypes_and_takes_wide_states(card_stand_in):
    """bf16 q, k, v get bf16 gradients and float32 log_a, beta float32 ones;
    states wider than 128 go to the wide kernel's pair with the normaliser
    off (`ssd_scan_wide_bwd_cuda`)."""
    make, leaves = _leaves(8, 1, 40, 2, 16, 8, torch.bfloat16, False)
    y, _ = ops.ssd_scan(*make(), chunk=16)
    y.float().sum().backward()
    assert [x.grad.dtype for x in leaves] == [torch.bfloat16] * 2 + [
        torch.float32] * 2
    make, leaves = _leaves(9, 1, 20, 1, 136, 8, torch.float32, False)
    y, _ = ops.ssd_scan(*make(), chunk=16)
    y.sum().backward()
    assert card_stand_in["wide_fwd"] == card_stand_in["wide_bwd"] == 1
    assert all(torch.isfinite(x.grad).all() for x in leaves)


def test_bwd_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 2, 16))
    la = torch.zeros((1, 8, 2))
    with pytest.raises(ValueError, match="CUDA"):
        SB.ssd_scan_bwd_cuda(q, q, q, la, la, q)
    with pytest.raises(ValueError, match="CUDA"):
        SB.mlstm_scan_bwd_cuda(q, q, q, la, la, q, q[..., :1])
    sizes = SB.scratch_numel(1, 4096, 4, 512, 512, 256, normaliser=True)
    # 64-token chunks, a 64 x 64 slot per tile of 512 x 513 (8 x 9 tiles),
    # then the scores' two images a chunk
    assert sizes["s_in"] == 4 * 64 * (72 + 2) * 64 * 64
    assert sizes["ds_out"] == 4 * 64 * 72 * 64 * 64 + 4 * 64   # and lt
    assert sizes["fin"] == 4 * 8 * 9                   # 64 x 64 tiles


def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_launch_names_are_the_header_kernels():
    """chip_smoke's SSD_BWD_LAUNCHES are the `__global__` kernels of
    `csrc/ssd_bwd.cuh` (`bwd_<name>`), both ways, so the smoke's per-launch
    times read every kernel; each call's `kernel_launches` names are among
    them, the fused launch exactly where the state is one 64 x 64 tile."""
    import re
    from pathlib import Path
    header = (Path(SB.__file__).resolve().parent / "csrc" / "ssd_bwd.cuh"
              ).read_text()
    kernels = set(re.findall(r"__global__[^;{]*?\bvoid\s+(\w+)\s*\(",
                             header))
    launches = _smoke().SSD_BWD_LAUNCHES
    assert kernels == {f"bwd_{n}" for n in launches}
    assert len(set(launches)) == len(launches)
    for dk, dv, norm, fused in [(64, 64, False, True), (16, 1, True, True),
                                (64, 63, True, True), (64, 64, True, False),
                                (128, 96, False, False),
                                (512, 512, True, False)]:
        names = SB.kernel_launches(dk, dv, norm)
        assert set(names) <= set(launches)
        assert ("fused" in names) == fused == SB.fused(dk, dv, norm)
        assert ("scores" in names) == ("grads" in names) == (not fused)
        sizes = SB.scratch_numel(1, 300, 2, dk, dv, 64, norm)
        states = 2 * 5 * -(-dk // 64) * -(-(dv + norm) // 64) * 64 * 64
        assert sizes["s_in"] == states + (0 if fused else 2 * 5 * 2 * 4096)
        assert sizes["ds_out"] == states + 2 * 5
