"""What surrounds the flash-attention kernel, on the CPU: the TMA tensor
maps the wrapper computes, the dh padding and what the kernel refuses
(`repro_torch.kernels.flash_attention`). The kernel itself, and the block
order it decides, run only on a card (tests/test_torch_cuda.py).

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
