"""The chunked SSD linear recurrence at wide states, as a hand-written CUDA
kernel, alone or as mLSTM's memory and normaliser in one call.

`csrc/ssd_scan_wide.cu` is the counterpart of the TPU kernel
`ssd_scan_pallas` at the states `csrc/ssd_scan.cu` does not take: dk, dv up
to 512 (mLSTM's 512 x 512 memory and 512 x 1 normaliser). Two wrappers
launch it, each counting one launch a call (whatever the number of its
phases) under its own name in `launches`:

  * `ssd_scan_wide_cuda(q, k, v, log_a, beta)` -> (y, state): the scan
    alone ("ssd_scan_wide"; `kernels.ops.ssd_scan` picks it on the card for
    states wider than 128);
  * `mlstm_scan_cuda(q, k, v, log_a, beta)` -> (y, state, nm, n): the scan
    and, from the same decays and causal scores, the normaliser's scan with
    v = ones (dv = 1), whose column of ones is never stored ("mlstm_scan";
    `kernels.ops.mlstm_scan`, mLSTM's full-sequence path).

bf16 inputs run in four launches on the tensor cores (decays; chunk states
with the carry over chunks fused in; causal scores; outputs); float32
inputs in the first design's five CUDA-core launches (plus the
normaliser's second pass). Both read the model layout (B, S, H, d) in place
through strides. The plain version is `models.linear_scan.
linear_scan_chunked` (twice, for the pair).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import MODEL_NVCC_FLAGS, load_library
from repro_torch.kernels.ssd_scan import DTYPES, check_inputs
from repro_torch.models.linear_scan import linear_scan_chunked

SOURCES = ("ssd_scan_wide.cu",)
MAX_DIM = 512           # dk, dv: the range the kernel is tested at
MAX_CHUNK = 256         # tokens per chunk: the decay scan's block

# Launches of the CUDA kernel, one per call of each wrapper (its four or
# five phases count once); the plain version never counts.
launches = {"ssd_scan_wide": 0, "mlstm_scan": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


ssd_scan_plain = linear_scan_chunked


def mlstm_scan_plain(q, k, v, log_a, beta, *, chunk=256):
    """The pair's plain version: the memory's scan and the normaliser's
    (v = ones in v's dtype), two `linear_scan_chunked` calls. Returns (y,
    state, nm, n)."""
    ones = torch.ones((*v.shape[:3], 1), dtype=v.dtype, device=v.device)
    y, state = linear_scan_chunked(q, k, v, log_a, beta, chunk=chunk)
    nm, n = linear_scan_chunked(q, k, ones, log_a, beta, chunk=chunk)
    return y, state, nm, n


def _ceil(x: int, m: int) -> int:
    return -(-x // m) * m


def scratch_numel(b, s, h, dk, dv, chunk, dtype, normaliser=False) -> dict:
    """Elements of each scratch buffer of one call (the C entry point checks
    the sizes it is given): per (row, chunk) pair, decays `dec` (3 x C
    floats) and `lt`; on the bf16 route the scores `g` (Cp^2) and the
    entering states `s_in` (dkp x dvp), each held twice (hi and lo bf16),
    and the normaliser's entering states `n_in` (dkp floats); on the float32
    route `g` (C^2 floats) and the chunk states `s_in`. Cp, dkp: C and dk
    rounded up to 64; dvp: dv rounded up to the states' tile (64 for dv <=
    64, else 256)."""
    c = min(chunk, MAX_CHUNK, s)
    rn = b * h * -(-s // c)
    out = {"dec": 3 * rn * c, "lt": rn}
    if dtype == torch.bfloat16:
        tile = 64 if dv <= 64 else 256
        out.update(g=rn * _ceil(c, 64) ** 2,
                   s_in=rn * _ceil(dk, 64) * _ceil(dv, tile),
                   n_in=rn * _ceil(dk, 64) if normaliser else 0)
    else:
        out.update(g=rn * c * c, s_in=rn * _ceil(dk * dv, 256), n_in=0)
    return out


def _kernel_lib():
    fn = load_library("ssd_scan_wide", SOURCES,
                      MODEL_NVCC_FLAGS).ssd_scan_wide_fwd
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, log_a, beta, y, state, nm, n, chunk):
    """One call of the kernel (the normaliser with it when nm is given)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, MAX_CHUNK, s)
    sizes = scratch_numel(b, s, h, dk, dv, c, q.dtype, nm is not None)
    # scratch, released on return: the caching allocator hands its memory
    # only to work queued after the kernel on this stream
    f32 = dict(dtype=torch.float32, device=q.device)
    wide = (dict(dtype=torch.bfloat16, device=q.device)
            if q.dtype == torch.bfloat16 else f32)
    parts = 2 if q.dtype == torch.bfloat16 else 1       # hi and lo
    dec = torch.empty((3, sizes["dec"] // 3), **f32)
    lt = torch.empty((sizes["lt"],), **f32)
    g = torch.empty((parts * sizes["g"],), **wide)
    s_in = torch.empty((parts * sizes["s_in"],), **wide)
    n_in = torch.empty((max(sizes["n_in"], 1),), **f32)
    ptrs = [q, k, v, log_a, beta, y, state, nm, n, dec[0], dec[1], dec[2],
            lt, g, s_in, n_in]
    nm_strides = nm.stride()[:3] if nm is not None else (0, 0, 0)
    dims = [b, s, h, dk, dv, c, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *log_a.stride(), *beta.stride(),
            *y.stride()[:3], *nm_strides, sizes["g"], sizes["s_in"],
            sizes["n_in"]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_lib()(
            (ctypes.c_ulonglong * len(ptrs))(
                *(0 if t is None else t.data_ptr() for t in ptrs)),
            (ctypes.c_longlong * len(dims))(*dims), DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_wide_fwd launch failed: CUDA error "
                           f"{rc}")


def ssd_scan_wide_cuda(q, k, v, log_a, beta, *, chunk=256):
    """As `ssd_scan.ssd_scan_cuda`, for dk, dv <= 512 (`MAX_DIM`; dv = 1
    included). Chunks of C = min(chunk, 256, S) tokens (the same
    recurrence: exact in real arithmetic). Scratch (`scratch_numel`,
    released on return): 673 MB at B = 4, S = 8192, H = 4, dk = dv = 512,
    C = 256, bf16. One call counts one launch of "ssd_scan_wide". Returns
    (y (B, S, H, dv) in v's dtype, final state (B, H, dk, dv) float32)."""
    check_inputs("ssd_scan_wide_cuda", q, k, v, log_a, beta, chunk, MAX_DIM,
                 "the range the kernel is tested at")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    y = torch.empty((b, s, h, dv), dtype=v.dtype, device=q.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    if y.numel() == 0 or s == 0:
        state.zero_()
        return y, state
    _launch(q, k, v, log_a, beta, y, state, None, None, chunk)
    launches["ssd_scan_wide"] += 1
    return y, state


def mlstm_scan_cuda(q, k, v, log_a, beta, *, chunk=256):
    """mLSTM's memory and normaliser in one call of the kernel: the scan of
    v and, as if a column of ones stood beside v (never stored), the scan
    of ones, over decays and causal scores computed once. Inputs as
    `ssd_scan_wide_cuda`. nm is rounded to v's dtype as the second of two
    `ssd_scan_wide_cuda` calls would round it. Scratch (`scratch_numel(...,
    normaliser=True)`): 674 MB at xlstm-1.3b's prefill. One call counts one
    launch of "mlstm_scan". Returns (y (B, S, H, dv), state (B, H, dk, dv)
    float32, nm (B, S, H, 1) in v's dtype, n (B, H, dk, 1) float32)."""
    check_inputs("mlstm_scan_cuda", q, k, v, log_a, beta, chunk, MAX_DIM,
                 "the range the kernel is tested at")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    y = torch.empty((b, s, h, dv), dtype=v.dtype, device=q.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    nm = torch.empty((b, s, h, 1), dtype=v.dtype, device=q.device)
    n = torch.empty((b, h, dk, 1), dtype=torch.float32, device=q.device)
    if y.numel() == 0 or s == 0:
        state.zero_()
        n.zero_()
        return y, state, nm, n
    _launch(q, k, v, log_a, beta, y, state, nm, n, chunk)
    launches["mlstm_scan"] += 1
    return y, state, nm, n
