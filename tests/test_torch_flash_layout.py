"""What surrounds the flash-attention kernels, on the CPU: the TMA tensor
maps the wrappers compute (forward and backward), the dh padding, the
backward's split of the query heads over blocks, and what the kernels
refuse (`repro_torch.kernels.flash_attention`). The kernels themselves,
and the block order they decide, run only on a card
(tests/test_torch_cuda.py).

Also the plain version at the kernel's 128 x 128 tiles against the
reference's `flash_attention_pallas`, run in interpret mode as
tests/test_torch_model_kernels.py runs it: float32 within 5e-6, the
reference sweep's tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_tensor_map_of_contiguous_q_and_k():
    q = _bf16(2, 300, 8, 112)
    dims, strides, box = FA.tensor_map(tuple(q.shape), q.stride(),
                                       FA.BLOCK_Q)
    assert dims == (112, 8, 300, 2)                 # innermost first
    assert strides == (112 * 2, 8 * 112 * 2, 300 * 8 * 112 * 2)
    assert box == (64, 1, 128, 1)
    k = _bf16(2, 300, 2, 112)
    dims, strides, box = FA.tensor_map(tuple(k.shape), k.stride(),
                                       FA.BLOCK_K)
    assert dims == (112, 2, 300, 2)
    assert strides == (224, 2 * 224, 300 * 2 * 224)
    assert box == (FA.PANEL, 1, FA.BLOCK_K, 1)


def test_tensor_map_of_a_strided_v_view():
    """v split out of a wider qkv projection keeps the projection's strides;
    nothing is copied."""
    b, s, h, kv, dh = 2, 130, 4, 2, 112
    qkv = _bf16(b, s, (h + 2 * kv) * dh)
    q, k, v = torch.split(qkv, [h * dh, kv * dh, kv * dh], dim=-1)
    v = v.reshape(b, s, kv, dh)
    assert not v.is_contiguous()
    dims, strides, box = FA.tensor_map(tuple(v.shape), v.stride(),
                                       FA.BLOCK_K)
    row = (h + 2 * kv) * dh * 2                     # bytes per token
    assert dims == (dh, kv, s, b)
    assert strides == (dh * 2, row, s * row)
    assert all(x % 16 == 0 for x in strides)
    flat = FA.tensor_maps(q.reshape(b, s, h, dh), k.reshape(b, s, kv, dh), v)
    assert len(flat) == 33
    assert flat[22:] == [*dims, *strides, *box]     # v's 11 values last
    assert flat[7:11] == [64, 1, FA.BLOCK_Q, 1]     # q's box


def test_tensor_map_replaces_the_stride_of_an_extent_one_dim():
    """A dim of extent 1 is only read at 0: its stride becomes the packed
    one, a positive multiple of 16 bytes, whatever the view says."""
    q = _bf16(1, 64, 1, 32)
    dims, strides, _ = FA.tensor_map((1, 64, 1, 32), (5, 32, 3, 1), 128)
    assert dims == (32, 1, 64, 1)
    assert strides == (64, 64, 64 * 64)
    assert FA.kernel_takes_strides(q.as_strided((1, 64, 1, 32),
                                                (5, 32, 3, 1)))


@pytest.mark.parametrize("dh,padded", [(32, 64), (64, 64), (96, 128),
                                       (112, 128), (128, 128)])
def test_head_dim_padding(dh, padded):
    assert dh in FA.HEAD_DIMS
    assert FA.padded_head_dim(dh) == padded
    assert padded % FA.PANEL == 0 and padded - dh < FA.PANEL


def _qkv(dtype=torch.bfloat16, dh=112, h=4, kv=2):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((1, 40, h, dh), generator=g).to(dtype),
            torch.randn((1, 40, kv, dh), generator=g).to(dtype),
            torch.randn((1, 40, kv, dh), generator=g).to(dtype))


def test_check_inputs_accepts_what_the_kernel_takes():
    FA.check_inputs(*_qkv())
    for dh in FA.HEAD_DIMS:
        FA.check_inputs(*_qkv(dh=dh))


def test_check_inputs_refuses_float32():
    with pytest.raises(ValueError, match="bfloat16"):
        FA.check_inputs(*_qkv(torch.float32))


@pytest.mark.parametrize("dh", [16, 48, 80, 256])
def test_check_inputs_refuses_other_head_dims(dh):
    with pytest.raises(ValueError, match="head_dim"):
        FA.check_inputs(*_qkv(dh=dh))


def test_check_inputs_refuses_misaligned_strides():
    q, k, v = _qkv()
    wide = torch.zeros((1, 40, 2, 120), dtype=torch.bfloat16)
    odd = wide[..., 4:116]                  # base 8 bytes past alignment
    assert odd.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="strides or alignment"):
        FA.check_inputs(q, odd, v)
    ragged = torch.zeros((1, 40, 2 * 117), dtype=torch.bfloat16)[
        ..., :224].reshape(1, 40, 2, 112)   # token stride 234: not 16 bytes
    with pytest.raises(ValueError, match="strides or alignment"):
        FA.check_inputs(q, k, ragged)
    with pytest.raises(ValueError, match="strides or alignment"):
        FA.check_inputs(q, k.transpose(-1, -2).contiguous().transpose(
            -1, -2), v)                     # dh not unit-stride


def test_check_inputs_refuses_bad_shapes():
    q, k, v = _qkv(h=4, kv=3)
    with pytest.raises(ValueError, match="incompatible"):
        FA.check_inputs(q, k, v)
    q, k, v = _qkv()
    with pytest.raises(ValueError):
        FA.check_inputs(q, k, v[:, :, :1])


# ------------------------------------------------ the backward's host side

def test_bwd_tensor_maps_of_contiguous_and_strided_inputs():
    """The backward's four maps (q, k, v, do), 11 values each, are
    `tensor_map` of each tensor at BWD_BOX rows: q, k and v split out of one
    qkv projection keep its strides, do is contiguous."""
    b, s, h, kv, dh = 2, 130, 4, 2, 112
    qkv = _bf16(b, s, (h + 2 * kv) * dh)
    q, k, v = (t.reshape(b, s, -1, dh) for t in torch.split(
        qkv, [h * dh, kv * dh, kv * dh], dim=-1))
    do = _bf16(b, s, h, dh)
    flat = FA.bwd_tensor_maps(q, k, v, do)
    assert len(flat) == 44
    row = (h + 2 * kv) * dh * 2                     # bytes per qkv token
    assert flat[0:11] == [dh, h, s, b, dh * 2, row, s * row, 64, 1, 64, 1]
    assert flat[11:22] == [dh, kv, s, b, dh * 2, row, s * row, 64, 1, 64, 1]
    assert flat[22:33] == flat[11:22]               # v: k's dims and strides
    assert flat[33:44] == [dh, h, s, b, dh * 2, h * dh * 2, s * h * dh * 2,
                           64, 1, 64, 1]
    for i, t in enumerate((q, k, v, do)):
        dims, strides, box = FA.tensor_map(tuple(t.shape), t.stride(),
                                           FA.BWD_BOX)
        assert flat[11 * i:11 * i + 11] == [*dims, *strides, *box]
        assert all(x % 16 == 0 for x in strides)


def _smoke_bwd_shapes():
    return _smoke().BWD_SHAPES


H100_SMS = 132          # the SMs of an H100 SXM, which the plans are for
# (B, S, H, KV, dh, window) -> the split, dK / dV blocks, dQ blocks
BWD_PLANS = {
    (1, 4096, 16, 2, 128, 0): (4, 256, 512),        # qwen2.5-3b's
    (1, 8192, 32, 32, 112, 4096): (1, 2048, 2048),  # MHA: nothing to split
    (4, 1500, 24, 24, 64, 0): (1, 1152, 1152),
    (2, 2048, 24, 8, 64, 0): (1, 256, 768),         # group 3, unsplit
}


@pytest.mark.parametrize("shape", list(BWD_PLANS))
def test_bwd_plan_at_the_smoke_shapes(shape):
    """The backward's split of the query heads at each of the smoke's
    BWD_SHAPES (an H100's 132 SMs): the smallest divisor of the group that
    gives at least 1.5 dK / dV blocks an SM, else the whole group; at least
    256 dK / dV blocks at the training shape, against 64 unsplit; the
    scratch the wrapper allocates, the partials only with a split."""
    assert shape in _smoke_bwd_shapes()
    b, s, h, kv, dh, _ = shape
    plan = FA.bwd_plan(b, s, s, h, kv, dh, sms=H100_SMS)
    assert (plan["splits"], plan["dkdv_blocks"], plan["dq_blocks"]) == \
        BWD_PLANS[shape]
    n_kt = -(-s // FA.BWD_BLOCK_K)
    assert plan["dkdv_blocks"] == b * kv * n_kt * plan["splits"]
    assert 2 * plan["dkdv_blocks"] >= 3 * H100_SMS or \
        plan["splits"] == h // kv
    assert plan["heads_per_split"] * plan["splits"] == h // kv
    sq_pad = -(-s // 64) * 64
    part = 2 * plan["splits"] * b * s * kv * dh if plan["splits"] > 1 else 0
    assert plan["partial_floats"] == part
    assert plan["scratch_floats"] == b * h * sq_pad * 2 + part
    assert plan["scratch_bytes"] == 4 * plan["scratch_floats"]
    if shape[:5] == (1, 4096, 16, 2, 128):
        assert plan["dkdv_blocks"] >= 256 > b * kv * n_kt
        assert plan["partial_floats"] * 4 == 33_554_432     # 33.6 MB


def test_bwd_plan_takes_a_given_split_and_refuses_others():
    plan = FA.bwd_plan(1, 1000, 1000, 12, 2, 64, sms=H100_SMS, splits=3)
    assert (plan["splits"], plan["heads_per_split"]) == (3, 2)
    assert FA.bwd_plan(1, 1000, 1000, 12, 2, 64, sms=1)["splits"] == 1
    assert FA.bwd_plan(1, 100, 100, 12, 2, 64, sms=1000)["splits"] == 6
    for bad in (0, 4, 7):
        with pytest.raises(ValueError, match="does not divide"):
            FA.bwd_plan(1, 1000, 1000, 12, 2, 64, sms=H100_SMS,
                        splits=bad)


def _bwd_args():
    q, k, v = _qkv(h=4, kv=2, dh=64)
    do = torch.zeros_like(q)
    lse = torch.zeros((1, 4, 40))
    return q, k, v, q.clone(), lse, do


def test_check_bwd_inputs_accepts_what_the_kernel_takes():
    FA.check_bwd_inputs(*_bwd_args())
    q, k, v, o, lse, do = _bwd_args()
    wide = torch.zeros((1, 40, 8, 64), dtype=torch.bfloat16)
    FA.check_bwd_inputs(q, k, v, o, lse, wide[:, :, :4])     # a head slice


@pytest.mark.parametrize("which", ["o", "do"])
def test_check_bwd_inputs_refuses_what_tma_cannot_take(which):
    """do goes through a TMA map and o through its strides: both need dh
    unit-stride, a 16-byte aligned base and 16-byte multiples for the
    other strides."""
    args = list(_bwd_args())
    i = {"o": 3, "do": 5}[which]
    odd = torch.zeros((1, 40, 4, 72), dtype=torch.bfloat16)[..., 4:68]
    assert odd.data_ptr() % 16 == 8
    ragged = torch.zeros((1, 40, 260), dtype=torch.bfloat16)[
        ..., :256].reshape(1, 40, 4, 64)       # token stride 260 elements
    assert ragged.stride(1) == 260 and (260 * 2) % 16 == 8
    col = torch.zeros((1, 40, 64, 4), dtype=torch.bfloat16).transpose(-1, -2)
    for bad in (odd, ragged, col):
        args[i] = bad
        with pytest.raises(ValueError, match="strides or alignment"):
            FA.check_bwd_inputs(*args)


def test_check_bwd_inputs_refuses_other_lse_and_shapes():
    q, k, v, o, lse, do = _bwd_args()
    with pytest.raises(ValueError, match="lse"):
        FA.check_bwd_inputs(q, k, v, o, lse.transpose(1, 2).contiguous()
                            .transpose(1, 2), do)   # not contiguous
    with pytest.raises(ValueError, match="lse"):
        FA.check_bwd_inputs(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError, match="do must be"):
        FA.check_bwd_inputs(q, k, v, o, lse, do[:, :20])
    k3, v3 = (torch.zeros((1, 40, 3, 64), dtype=torch.bfloat16)
              for _ in range(2))
    with pytest.raises(ValueError, match="incompatible"):
        FA.check_bwd_inputs(q, k3, v3, o, lse, do)     # 4 heads on 3


def test_kernel_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel; ops.flash_attention sends it
    to the plain version instead."""
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_cuda(*_qkv())


# --------------------------------------- the plain version at 128 x 128

@pytest.fixture
def _interpret_mode(monkeypatch):
    """The reference's ops.* reach their Pallas kernels in interpret mode."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("b,s,h,kv,dh,window", [
    (1, 300, 2, 1, 112, 130),     # window not a multiple of the 128 tile
    (1, 260, 4, 2, 64, 200),
    (2, 200, 2, 2, 96, 50),       # window inside one tile
])
def test_plain_version_at_kernel_tiles_matches_reference(
        _interpret_mode, b, s, h, kv, dh, window):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as rops
    rng = np.random.default_rng(300 + s + window)
    arrs = [rng.standard_normal((b, s, n, dh)).astype(np.float32)
            for n in (h, kv, kv)]
    ref = rops.flash_attention(*(jnp.asarray(a) for a in arrs), causal=True,
                               window=window, block_q=FA.BLOCK_Q,
                               block_k=FA.BLOCK_K)
    out = FA.flash_attention_plain(*(torch.from_numpy(a) for a in arrs),
                                   causal=True, window=window,
                                   chunk_q=FA.BLOCK_Q, chunk_k=FA.BLOCK_K)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-6,
                               rtol=5e-6)


# ------------------------------- what the smoke reports beside the kernel

def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dh", [64, 112, 128])
def test_smoke_padded_bound_counts_the_padded_p_v(dh):
    """Q K^T over dh and P V over the padded dh; bytes unchanged; equal to
    the unpadded bound where nothing is padded."""
    sm = _smoke()
    args = (4, 8192, 32, 32, dh, 4096)
    bound, _, nbytes, ops = sm.attention_bound(*args)
    pbound, _, pbytes, pops = sm.attention_padded_bound(
        *args, FA.padded_head_dim(dh))
    pairs = sm.attention_pairs(8192, 4096)
    assert ops == 4 * dh * 4 * 32 * pairs
    assert pops == 2 * (dh + FA.padded_head_dim(dh)) * 4 * 32 * pairs
    assert pbytes == nbytes
    assert (pbound == bound) == (dh == FA.padded_head_dim(dh))
    if dh == 112:
        assert pops * 14 == ops * 15            # 1/14 more tensor work


def test_smoke_reads_registers_and_spills_from_ptxas():
    sm = _smoke()
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z5k_ILi112EEv' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z5k_ILi112EEv",
        "    120 bytes stack frame, 200 bytes spill stores, 196 bytes "
        "spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z5k_ILi64EEv' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 151 registers, used 1 barriers"])
    stats = sm.ptxas_kernel_stats(log)
    assert stats["_Z5k_ILi112EEv"] == {"spill_stores": 200,
                                       "spill_loads": 196, "registers": 168}
    assert stats["_Z5k_ILi64EEv"] == {"spill_stores": 0, "spill_loads": 0,
                                      "registers": 151}


def test_smoke_reports_serialized_wgmma_from_ptxas(monkeypatch):
    """The smoke prints each kernel ptxas's C7512 warning names, cut to the
    kernel's own name after the anonymous namespace."""
    from repro_torch.kernels import build
    sm = _smoke()
    name = ("_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_2b1a21a58"
            "bwd_dkdvILi128EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE")
    log = ("ptxas info    : (C7512) Potential Performance Loss: "
           "wgmma.mma_async instructions are serialized due to insufficient "
           f"register resources for the function '{name}'\n"
           "ptxas info    : Used 168 registers")
    monkeypatch.setattr(build, "build_log",
                        {"flash_attention_bwd": {"ptxas": log}})
    assert sm.ptxas_serialized("flash_attention_bwd") == [
        "bwd_dkdvILi128EEEv14CUtensorMap_stS1_S1_"]
    assert sm.ptxas_serialized("flash_attention") == []


def test_cached_build_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """A library built by an earlier process still reports ptxas's
    registers and spills: the build leaves the report beside it."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_log", {})
    so = build._library_path("fa_test", FA.SOURCES, build.MODEL_NVCC_FLAGS)
    so.write_bytes(b"")
    so.with_suffix(".ptxas.txt").write_text("ptxas info : Used 168 "
                                            "registers")
    assert build.start_build("fa_test", FA.SOURCES,
                             build.MODEL_NVCC_FLAGS) is None
    build.finish_build("fa_test", None)
    assert build.build_log["fa_test"]["cached"]
    assert "Used 168 registers" in build.build_log["fa_test"]["ptxas"]
