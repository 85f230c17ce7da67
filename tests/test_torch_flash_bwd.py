"""Flash attention's gradient in the port against the reference, on the CPU.

The reference has no backward kernel: its tests differentiate the jnp
chunked attention (`repro.models.attention.chunked_attention`). So the
oracle of the port's backward is `jax.vjp` of that function, held against
`flash_attention_bwd_plain` (the FA2 formulas the CUDA backward kernel
computes, in float32), and the LSE the forward kernel stores against
`jax.nn.logsumexp` of the reference's masked scores. Inputs are float32,
drawn with numpy from a seed and handed to both; tolerances 2e-5 of the
largest gradient entry (float32, the two differ in summation order only)
and 2e-5 on the LSE.

On the CPU `ops.flash_attention` is the plain route, differentiated by
autograd. The card's route (the kernel forward with its LSE and the
backward kernel in a `torch.autograd.Function`) and the guard on the
kernel without a backward (RMSNorm's) are held here on CPU stand-ins: the
kernels' wrappers replaced by the plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as RA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402

TOL = 2e-5


def _inputs(seed, b, s, h, kv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh), (b, s, h, dh))]


def _ref_lse(q, k, window):
    """logsumexp of the reference's masked, scaled scores, (B, H, S)."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qg = jnp.asarray(q).reshape(b, s, kv, h // kv, dh)
    sc = jnp.einsum("bsngd,btnd->bngst", qg, jnp.asarray(k)) / np.sqrt(dh)
    pos = jnp.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    sc = jnp.where(mask[None, None, None], sc, RA.NEG_INF)
    return np.asarray(jax.nn.logsumexp(sc, axis=-1).reshape(b, h, s))


CASES = [
    (1, 96, 4, 4, 32, 0),       # causal
    (2, 80, 4, 4, 16, 24),      # windowed
    (1, 72, 6, 2, 16, 0),       # GQA, 3 query heads a kv head
    (2, 75, 4, 1, 8, 30),       # ragged S (not a multiple of the chunks)
]


@pytest.mark.parametrize("b,s,h,kv,dh,window", CASES)
def test_bwd_plain_and_lse_match_reference_vjp(b, s, h, kv, dh, window):
    q, k, v, do = _inputs(s + dh, b, s, h, kv, dh)

    def ref(q_, k_, v_):
        return RA.chunked_attention(q_, k_, v_, causal=True, window=window,
                                    chunk_q=32, chunk_k=32)
    out, vjp = jax.vjp(jax.jit(ref), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = chunked_attention(tq, tk, tv, window=window, chunk_q=32,
                               chunk_k=32, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), _ref_lse(q, k, window),
                               atol=TOL, rtol=TOL)
    got = FA.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                       window=window, chunk_q=40, chunk_k=24)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max(), err_msg=name)


def split_model(q, k, v, o, lse, do, *, splits, window):
    """The backward kernel's split in plain float32: dk and dv of each
    split of a kv head's query heads (split i takes heads i * g / splits ..
    (i + 1) * g / splits - 1 of each group of g), as `flash_attention_bwd_
    plain` gives them for those heads alone, summed in split order; dq
    unsplit. Returns (dq, dk, dv, [per-split (dk, dv)])."""
    h, kv = q.shape[2], k.shape[2]
    g = h // kv
    hps = g // splits
    parts, dk, dv = [], None, None
    for i in range(splits):
        heads = [n * g + i * hps + j for n in range(kv) for j in range(hps)]
        _, dk_i, dv_i = FA.flash_attention_bwd_plain(
            q[:, :, heads], k, v, o[:, :, heads], lse[:, heads],
            do[:, :, heads], window=window, chunk_q=40, chunk_k=24)
        parts.append((dk_i, dv_i))
        dk = dk_i if dk is None else dk + dk_i
        dv = dv_i if dv is None else dv + dv_i
    dq = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)[0]
    return dq, dk, dv, parts


@pytest.mark.parametrize("b,s,h,kv,dh,window,splits", [
    (1, 72, 6, 2, 16, 0, 3),        # group 3, each head its own split
    (1, 80, 8, 2, 16, 20, 2),       # group 4 in two splits, windowed
    (2, 75, 8, 1, 8, 30, 4),        # group 8 in four, ragged S
    (1, 64, 12, 2, 16, 0, 6)])      # group 6, the card test's split edge
def test_split_model_matches_reference_vjp(b, s, h, kv, dh, window, splits):
    """The per-split partials of dk and dv summed in the kernel's fixed
    order give `jax.vjp` of the reference's chunked attention and the
    unsplit plain backward; each split alone does not (it is a share of
    the group), so the sum is needed."""
    q, k, v, do = _inputs(s + h, b, s, h, kv, dh)

    def ref(q_, k_, v_):
        return RA.chunked_attention(q_, k_, v_, causal=True, window=window,
                                    chunk_q=32, chunk_k=32)
    _, vjp = jax.vjp(jax.jit(ref), *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = chunked_attention(tq, tk, tv, window=window, chunk_q=32,
                               chunk_k=32, return_lse=True)
    dq, dk, dv, parts = split_model(tq, tk, tv, o, lse, tdo, splits=splits,
                                    window=window)
    whole = FA.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                         window=window)
    for name, g, w, x in zip(("dq", "dk", "dv"), (dq, dk, dv), want, whole):
        tol = TOL * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), x.numpy(), rtol=0, atol=tol,
                                   err_msg=name)
    for dk_i, dv_i in parts:
        assert np.abs(dk_i.numpy() - want[1]).max() > 100 * TOL * np.abs(
            want[1]).max()
        assert np.abs(dv_i.numpy() - want[2]).max() > 100 * TOL * np.abs(
            want[2]).max()


@pytest.mark.parametrize("b,s,h,kv,dh,window", CASES[1:3])
def test_cpu_route_differentiates_the_plain_attention(b, s, h, kv, dh,
                                                      window):
    """On the CPU, autograd through `ops.flash_attention` (the plain
    chunked route) gives `flash_attention_bwd_plain`'s gradients."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(7, b, s, h, kv, dh))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*leaves, window=window, block_q=32,
                        block_k=32).backward(do)
    o, lse = chunked_attention(q, k, v, window=window, return_lse=True)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, atol=TOL * float(
            w.abs().max()), rtol=0)


@pytest.fixture
def card_stand_in(monkeypatch):
    """`ops` as on the card, with the CUDA wrappers replaced by stand-ins
    that count a launch and compute the plain versions."""
    calls = {"fwd": 0, "fwd_lse": 0, "bwd": 0}

    def fwd(q, k, v, *, causal=True, window=0, return_lse=False):
        calls["fwd_lse" if return_lse else "fwd"] += 1
        with torch.no_grad():
            return chunked_attention(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)

    def bwd(q, k, v, o, lse, do, *, causal=True, window=0):
        calls["bwd"] += 1
        return FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=causal, window=window)

    def no_plain(*args, **kw):
        raise AssertionError("the plain attention ran on the card route")
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    monkeypatch.setattr(ops, "chunked_attention", no_plain)
    monkeypatch.setattr(FA, "flash_attention_cuda", fwd)
    monkeypatch.setattr(FA, "flash_attention_bwd_cuda", bwd)
    return calls


def test_card_route_is_the_kernel_pair_under_grad(card_stand_in):
    """Under grad the card route is the autograd Function: one forward
    with the LSE, one backward call, the plain backward's gradients of
    strided q, k, v views; without grad, the forward alone."""
    b, s, h, kv, dh, window = 2, 70, 6, 2, 16, 20
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal(
        (b, s, (h + 2 * kv) * dh)).astype(np.float32)).requires_grad_(True)
    q, k, v = (t.reshape(b, s, -1, dh) for t in torch.split(
        qkv, [h * dh, kv * dh, kv * dh], dim=-1))
    do = torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(
        np.float32))
    ops.flash_attention(q, k, v, window=window).backward(do)
    assert card_stand_in == {"fwd": 0, "fwd_lse": 1, "bwd": 1}
    with torch.no_grad():
        o, lse = chunked_attention(q, k, v, window=window, return_lse=True)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            window=window)
        ops.flash_attention(q, k, v, window=window)
    assert card_stand_in == {"fwd": 1, "fwd_lse": 1, "bwd": 1}
    got = torch.split(qkv.grad, [h * dh, kv * dh, kv * dh], dim=-1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.reshape(w.shape), w)


def test_kernels_without_backward_raise_under_grad(card_stand_in,
                                                   monkeypatch):
    """Trap: a ctypes kernel returns a tensor without a grad_fn, so a
    backward through it would cut every gradient upstream silently. On the
    card `rmsnorm` (no backward kernel, and off every model's path) raises
    under grad, before reaching its kernel; `ssd_scan` and `mlstm_scan`
    under grad are their autograd Functions, whose backward is a kernel
    (held in tests/test_torch_ssd_bwd.py)."""
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssd_scan_wide as SSDW
    from repro_torch.models.linear_scan import linear_scan_chunked
    monkeypatch.setattr(SSD, "ssd_scan_cuda", linear_scan_chunked)
    monkeypatch.setattr(SSDW, "mlstm_scan_cuda", SSDW.mlstm_scan_plain)
    x = torch.zeros((1, 8, 2, 4), requires_grad=True)
    la, beta = torch.zeros((1, 8, 2)), torch.ones((1, 8, 2))
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.rmsnorm(x, torch.zeros(4))
    y, _ = ops.ssd_scan(x, x, x, la, beta)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    y, *_ = ops.mlstm_scan(x, x, x, la, beta)
    assert type(y.grad_fn).__name__ == "_MLSTMScanBackward"
    # the gate is grad mode and requires_grad, not the device alone
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(x, torch.zeros(4))


def test_bwd_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, do = (torch.zeros(s, dtype=torch.bfloat16) for s in
                   ((1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32),
                    (1, 8, 4, 32)))
    lse = torch.zeros((1, 4, 8))
    FA.check_bwd_inputs(q, k, v, q, lse, do)
    with pytest.raises(ValueError, match="lse"):
        FA.check_bwd_inputs(q, k, v, q, lse[..., :4], do)
    with pytest.raises(ValueError, match="bfloat16"):
        FA.check_bwd_inputs(q, k, v, q, lse, do.float())
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd_cuda(q, k, v, q, lse, do)
