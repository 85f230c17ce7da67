"""The port's model-kernel entry points (`repro_torch.kernels.ops`) against
the reference's, on the CPU.

The reference runs its Pallas kernels in interpret mode (as
tests/test_kernels.py does, scoped per test); the port takes its plain
routes (a CPU tensor never reaches a CUDA kernel). Inputs are drawn with
numpy from a seed and handed to both. Shapes and tolerances are the
reference sweep's: attention 5e-6 in float32 and 2e-2 in bfloat16, SSD y
2e-4 in float32 and 5e-2 in bfloat16, the SSD final state 1e-4, RMSNorm
1e-5 in float32 and 2e-2 in bfloat16. Each port result is also held
against the port's own sequential oracles (`repro_torch.kernels.ref`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     rmsnorm_ref, ssd_scan_ref)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    """The reference's ops.* reach their Pallas kernels in interpret mode."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")


_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = _DT[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,h,kv,dh", [
    (1, 128, 4, 4, 128),     # MHA aligned
    (2, 200, 8, 2, 96),      # GQA, padded seq + head_dim
    (2, 300, 6, 1, 64),      # MQA
    (1, 64, 4, 2, 112),      # zamba2-like head_dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 50])
def test_flash_attention_matches_reference(b, s, h, kv, dh, dtype, window):
    rng = np.random.default_rng(1000 + s + dh + window)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (b, s, n, dh), dtype)
                                    for n in (h, kv, kv))
    ref = rops.flash_attention(jq, jk, jv, causal=True, window=window,
                               block_q=64, block_k=64)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              block_q=64, block_k=64)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = 5e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)
    oracle = flash_attention_ref(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 130, 3, 16, 32, 32),
    (1, 64, 2, 64, 64, 16),
    (2, 96, 4, 8, 128, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_reference(b, s, h, dk, dv, chunk, dtype):
    rng = np.random.default_rng(2000 + s + dk)
    (jq, tq), (jk, tk) = (_pair(rng, (b, s, h, dk), dtype) for _ in range(2))
    jv, tv = _pair(rng, (b, s, h, dv), dtype)
    la = -np.logaddexp(0.0, rng.standard_normal((b, s, h))).astype(np.float32)
    bt = (1 / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(
        np.float32)
    yr, sr = rops.ssd_scan(jq, jk, jv, jnp.asarray(la), jnp.asarray(bt),
                           chunk=chunk)
    y, state = ops.ssd_scan(tq, tk, tv, torch.from_numpy(la),
                            torch.from_numpy(bt), chunk=chunk)
    assert y.dtype == tv.dtype and y.shape == tv.shape
    assert state.dtype == torch.float32 and state.shape == (b, h, dk, dv)
    tol = 2e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(y), _np(yr), atol=tol, rtol=tol)
    # the final state: the port's own (the kernel's output on a card) vs the
    # reference wrapper's recomputation, both float32
    np.testing.assert_allclose(state.numpy(), np.asarray(sr), atol=1e-4,
                               rtol=1e-4)
    fold = lambda x: x.transpose(1, 2).reshape(b * h, s, x.shape[-1])
    fold2 = lambda x: x.transpose(1, 2).reshape(b * h, s)
    yo, so = ssd_scan_ref(fold(tq).float(), fold(tk).float(),
                          fold(tv).float(), fold2(torch.from_numpy(la)),
                          fold2(torch.from_numpy(bt)))
    yo = yo.reshape(b, h, s, dv).transpose(1, 2)
    np.testing.assert_allclose(_np(y), yo.numpy(), atol=tol, rtol=tol)
    np.testing.assert_allclose(state.reshape(b * h, dk, dv).numpy(),
                               so.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s,h,dv,chunk", [(45, 2, 512, 16), (70, 3, 1, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_at_mlstm_state_widths_matches_reference(s, h, dv, chunk,
                                                          dtype):
    """mLSTM's two calls: dk = dv = 512 (its memory) and dk = 512, dv = 1
    (its normaliser, v = ones as the layer passes it), at S not a multiple
    of the chunk; the widths the card sends to `ssd_scan_wide_cuda`.
    Tolerances as above: y 2e-4 (float32) / 5e-2 (bfloat16), state 1e-4."""
    assert ops.ssd_kernel_for(512, dv) == "ssd_scan_wide"
    rng = np.random.default_rng(4000 + s + dv)
    dk = 512
    (jq, tq), (jk, tk) = (_pair(rng, (1, s, h, dk), dtype) for _ in range(2))
    jq, tq = jq / np.sqrt(dk).astype(np.float32), tq / np.sqrt(dk)
    if dv == 1:
        jv = jnp.ones((1, s, h, 1), _DT[dtype][0])
        tv = torch.ones((1, s, h, 1), dtype=_DT[dtype][1])
    else:
        jv, tv = _pair(rng, (1, s, h, dv), dtype)
    la = -np.logaddexp(0.0, -rng.standard_normal((1, s, h))).astype(
        np.float32)                                  # log_sigmoid
    bt = (1 / (1 + np.exp(-rng.standard_normal((1, s, h))))).astype(
        np.float32)
    yr, sr = rops.ssd_scan(jq, jk, jv, jnp.asarray(la), jnp.asarray(bt),
                           chunk=chunk)
    y, state = ops.ssd_scan(tq, tk, tv, torch.from_numpy(la),
                            torch.from_numpy(bt), chunk=chunk)
    assert y.dtype == tv.dtype and y.shape == (1, s, h, dv)
    assert state.dtype == torch.float32 and state.shape == (1, h, dk, dv)
    tol = 2e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(y), _np(yr), atol=tol, rtol=tol)
    np.testing.assert_allclose(state.numpy(), np.asarray(sr), atol=1e-4,
                               rtol=1e-4)


def test_ssd_kernel_choice_by_state_width():
    """On the card, states up to 128 x 128 go to ssd_scan.cu (Mamba2's
    path, unchanged), wider ones up to 512 x 512 to ssd_scan_wide.cu, and
    wider still are refused (nothing goes to the plain version)."""
    pick = ops.ssd_kernel_for
    assert pick(64, 64) == pick(128, 128) == pick(16, 1) == "ssd_scan"
    for dk, dv in ((512, 512), (512, 1), (129, 64), (64, 200)):
        assert pick(dk, dv) == "ssd_scan_wide"
    with pytest.raises(ValueError, match="<= 512"):
        pick(513, 1)


def test_ssd_final_state_matches_reference_oracle():
    """The reference's test_ssd_final_state_matches_ref, on the port."""
    from repro.kernels.ref import ssd_scan_ref as rssd_ref
    b, s, h, dk, dv = 1, 64, 2, 8, 16
    rng = np.random.default_rng(7)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((b, s, h))).astype(np.float32)
    bt = (1 / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(
        np.float32)
    _, state = ops.ssd_scan(*(torch.from_numpy(a) for a in (q, k, v, la, bt)),
                            chunk=16)
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(b * h, s, x.shape[-1])
    fold2 = lambda x: x.transpose(0, 2, 1).reshape(b * h, s)
    _, sr = rssd_ref(fold(q), fold(k), fold(v), fold2(la), fold2(bt))
    np.testing.assert_allclose(state.numpy().reshape(b * h, dk, dv),
                               np.asarray(sr), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(64, 256), (2, 37, 256), (5, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(shape, dtype):
    rng = np.random.default_rng(3000 + shape[-1] + len(shape))
    jx, tx = _pair(rng, shape, dtype)
    w = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    ref = rops.rmsnorm(jx, jnp.asarray(w))
    out = ops.rmsnorm(tx, torch.from_numpy(w))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(rmsnorm_ref(tx,
                                                         torch.from_numpy(w))),
                               atol=tol, rtol=tol)


def test_ops_dispatch_on_device():
    """A CPU tensor takes the plain route; the CUDA wrappers refuse CPU
    tensors, so nothing reaches a kernel by accident."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssd_scan_wide as SSDW
    x = torch.zeros(2, 8, 2, 32)
    la = torch.zeros(2, 8, 2)
    wide = torch.zeros(2, 8, 2, 512)
    before = (FA.launches["flash_attention"], SSD.launches["ssd_scan"],
              SSDW.launches["ssd_scan_wide"], RN.launches["rmsnorm"])
    ops.flash_attention(x, x, x)
    ops.ssd_scan(x, x, x, la, la)
    ops.ssd_scan(wide, wide, wide[..., :1], la, la)
    ops.rmsnorm(x, torch.zeros(32))
    assert (FA.launches["flash_attention"], SSD.launches["ssd_scan"],
            SSDW.launches["ssd_scan_wide"], RN.launches["rmsnorm"]) == before
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        SSD.ssd_scan_cuda(x, x, x, la, la)
    with pytest.raises(ValueError, match="CUDA"):
        SSDW.ssd_scan_wide_cuda(x, x, x, la, la)
    with pytest.raises(ValueError, match="CUDA"):
        RN.rmsnorm_cuda(x[0, 0], torch.zeros(32))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rmsnorm(x.to("meta"), torch.zeros(32))
