"""mLSTM's pair of scans (`kernels.ops.mlstm_scan`: its memory and its
normaliser, one call of the wide SSD kernel on a card) on the CPU.

On CPU tensors the pair is the two plain `linear_scan_chunked` calls the
reference's mLSTM makes, so it equals two `ops.ssd_scan` calls bit for bit
and counts no kernel launch; `apply_mlstm` makes exactly one pair call and
no other scan, and still matches the reference's mLSTM (float32, atol
2e-4, rtol 2e-3, as tests/test_torch_models.py). The wrapper's scratch
layout (what the C entry point checks it is given) is plain arithmetic,
checked here at the serving shape. Inputs are drawn with numpy from a
seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as rget_arch  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import _load  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels import ssd_scan_wide as SSDW  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


def _inputs(seed, b, s, h, dk, dv, dtype, forget_bias=0.0):
    """mLSTM's scan inputs: q scaled by 1/sqrt(dk), log_a =
    log_sigmoid(. + forget_bias), beta = sigmoid(.)."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((b, s, h, dk)).astype(
        np.float32) / np.sqrt(dk)).to(dt)
    k = torch.from_numpy(rng.standard_normal((b, s, h, dk)).astype(
        np.float32)).to(dt)
    v = torch.from_numpy(rng.standard_normal((b, s, h, dv)).astype(
        np.float32)).to(dt)
    g = rng.standard_normal((2, b, s, h)).astype(np.float32)
    log_a = torch.nn.functional.logsigmoid(torch.from_numpy(g[0])
                                           + forget_bias)
    beta = torch.sigmoid(torch.from_numpy(g[1]))
    return q, k, v, log_a, beta


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,forget_bias", [
    (2, 100, 4, 32, 32, 32, 0.0), (1, 45, 2, 512, 512, 16, 6.0),
    (2, 7, 3, 24, 40, 256, 0.0), (1, 70, 2, 129, 1, 32, 6.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_on_cpu_equals_two_ssd_scan_calls_bit_for_bit(
        b, s, h, dk, dv, chunk, forget_bias, dtype):
    """(y, C) of the memory's `ops.ssd_scan` and (nm, n) of the
    normaliser's (v = ones in v's dtype), exactly; no launch counted."""
    args = _inputs(b + s + dk, b, s, h, dk, dv, dtype, forget_bias)
    before = {**SSD.launches, **SSDW.launches}
    y, C, nm, n = ops.mlstm_scan(*args, chunk=chunk)
    assert {**SSD.launches, **SSDW.launches} == before
    q, k, v, log_a, beta = args
    ones = torch.ones((b, s, h, 1), dtype=v.dtype)
    ry, rC = ops.ssd_scan(q, k, v, log_a, beta, chunk=chunk)
    rnm, rn = ops.ssd_scan(q, k, ones, log_a, beta, chunk=chunk)
    for got, ref in ((y, ry), (C, rC), (nm, rnm), (n, rn)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, ref)
    assert nm.dtype == v.dtype and n.shape == (b, h, dk, 1)
    assert all(torch.equal(x, r) for x, r in zip(
        SSDW.mlstm_scan_plain(*args, chunk=chunk), (y, C, nm, n)))


def test_apply_mlstm_makes_one_pair_call_and_no_other_scan(monkeypatch):
    """The full-sequence mLSTM calls `ops.mlstm_scan` once, with the
    model's chunk, and never `ops.ssd_scan`."""
    cfg = smoke_config(get_arch("xlstm-1.3b")).with_(dtype="float32")
    p = L.init_mlstm(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []
    real = ops.mlstm_scan

    def pair(*a, **kw):
        calls.append(kw.get("chunk"))
        return real(*a, **kw)

    def single(*a, **kw):
        raise AssertionError("apply_mlstm called ops.ssd_scan")
    monkeypatch.setattr(ops, "mlstm_scan", pair)
    monkeypatch.setattr(ops, "ssd_scan", single)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y, cache = L.apply_mlstm(p, x, cfg, want_cache=True)
    assert calls == [cfg.ssm_chunk]
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert cache["n"].shape == (2, cfg.n_heads, cfg.resolved_head_dim, 1)


@pytest.mark.parametrize("s", [33, 64])
@torch.no_grad()
def test_apply_mlstm_through_the_pair_matches_reference(s):
    """The port's mLSTM (its scans now one `ops.mlstm_scan` call) against
    the reference's two `ops.ssd_scan` calls: y and both carried states,
    at S below and at a multiple of the chunk (32)."""
    rc = rsmoke(rget_arch("xlstm-1.3b")).with_(dtype="float32")
    pc = smoke_config(get_arch("xlstm-1.3b")).with_(dtype="float32")
    rp = RL.init_mlstm(jax.random.PRNGKey(16), rc)
    pp = L.MLSTM(pc, "cpu")
    assert _load(pp, jax.tree.map(np.asarray, rp)) == 5
    a = np.random.default_rng(s).standard_normal(
        (2, s, rc.d_model)).astype(np.float32)
    ry, rcache = RL.apply_mlstm(rp, jnp.asarray(a), rc, want_cache=True)
    py, pcache = L.apply_mlstm(pp, torch.from_numpy(a), pc, want_cache=True)
    for port, ref in ((py, ry), (pcache["C"], rcache["C"]),
                      (pcache["n"], rcache["n"])):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   atol=2e-4, rtol=2e-3)


def test_pair_wrapper_refuses_cpu_tensors():
    """`mlstm_scan_cuda` takes CUDA tensors only: nothing reaches the
    kernel by accident, and no launch is counted."""
    args = _inputs(0, 1, 8, 1, 512, 512, "float32")
    before = dict(SSDW.launches)
    with pytest.raises(ValueError, match="CUDA"):
        SSDW.mlstm_scan_cuda(*args)
    assert SSDW.launches == before


def test_scratch_layout_at_the_serving_shape():
    """What one call allocates at xlstm-1.3b's prefill (B = 4, S = 8192,
    H = 4, dk = dv = 512, chunk 256): on the bf16 route G (256^2) and the
    entering states (512 x 512) per (row, chunk), each as hi and lo bf16,
    decays, and the normaliser's entering states for the pair (674 MB, 673
    MB for the scan alone, as the wrappers' docstrings say); on the float32
    route G and the chunk states in float32."""
    shape = (4, 8192, 4, 512, 512, 256)
    rn = 4 * 4 * 32
    n = SSDW.scratch_numel(*shape, torch.bfloat16, normaliser=True)
    assert n == {"dec": 3 * rn * 256, "lt": rn, "g": rn * 256 * 256,
                 "s_in": rn * 512 * 512, "n_in": rn * 512}
    nbytes = 4 * (n["dec"] + n["lt"] + n["n_in"]) + 2 * 2 * (n["g"] +
                                                             n["s_in"])
    assert round(nbytes / 1e6) == 674
    assert round((nbytes - 4 * n["n_in"]) / 1e6) == 673
    assert SSDW.scratch_numel(*shape, torch.bfloat16)["n_in"] == 0
    f32 = SSDW.scratch_numel(*shape, torch.float32)
    assert 4 * (f32["g"] + f32["s_in"]) == 2 * 2 * (n["g"] + n["s_in"])
    # padding: C, dk to 64, dv to the states' tile (64 up to 64, else 256)
    small = SSDW.scratch_numel(1, 45, 2, 129, 136, 16, torch.bfloat16)
    assert small["g"] == 2 * 3 * 64 * 64
    assert small["s_in"] == 2 * 3 * 192 * 256 and small["n_in"] == 0
    assert SSDW.scratch_numel(1, 45, 2, 24, 7, 16, torch.bfloat16)[
        "s_in"] == 2 * 3 * 64 * 64
    f32 = SSDW.scratch_numel(1, 45, 2, 129, 136, 16, torch.float32)
    assert f32["g"] == 2 * 3 * 16 * 16 and f32["s_in"] == 2 * 3 * -(
        -129 * 136 // 256) * 256
