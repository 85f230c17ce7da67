"""The chunked SSD linear recurrence at wide states, as a hand-written CUDA
kernel.

`ssd_scan_wide_cuda` launches `csrc/ssd_scan_wide.cu`, the counterpart of
the TPU kernel `ssd_scan_pallas` at the states `csrc/ssd_scan.cu` does not
take: dk, dv up to 512 (mLSTM's 512 x 512 memory and 512 x 1 normaliser).
It runs the chunk-parallel form in five launches (decays, causal scores,
chunk states, the carry over chunks, outputs), float32 on the CUDA cores,
writes y and the final state, and reads the model layout (B, S, H, d) in
place through strides, as `ssd_scan.ssd_scan_cuda` does. The plain version
is `models.linear_scan.linear_scan_chunked`; `kernels.ops.ssd_scan` picks
this kernel on the card for states wider than 128.
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

# Launches of the CUDA kernel (its five phases count once a call); the plain
# version never counts.
launches = {"ssd_scan_wide": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


ssd_scan_plain = linear_scan_chunked


def _kernel_lib():
    fn = load_library("ssd_scan_wide", SOURCES,
                      MODEL_NVCC_FLAGS).ssd_scan_wide_fwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P] * 13 + [I] * 6 + [L] * 18 + [I, P]
    fn.restype = I
    return fn


def ssd_scan_wide_cuda(q, k, v, log_a, beta, *, chunk=256):
    """As `ssd_scan.ssd_scan_cuda`, for dk, dv <= 512 (`MAX_DIM`; dv = 1
    included). Chunks of C = min(chunk, 256, S) tokens (the same
    recurrence: exact in real arithmetic). The float32 scratch is
    R*n*(C*C + E + 3*C + 1) floats for R = B*H rows, n = ceil(S / C)
    chunks and E = dk*dv rounded up to 256: 671 MB at B = 4, S = 8192,
    H = 4, dk = dv = 512, C = 256.
    Returns (y (B, S, H, dv) in v's dtype, final state (B, H, dk, dv)
    float32)."""
    check_inputs("ssd_scan_wide_cuda", q, k, v, log_a, beta, chunk, MAX_DIM,
                 "the range the kernel is tested at")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    y = torch.empty((b, s, h, dv), dtype=v.dtype, device=q.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    if y.numel() == 0 or s == 0:
        state.zero_()
        return y, state
    c = min(chunk, MAX_CHUNK, s)
    rn = b * h * -(-s // c)                        # (row, chunk) pairs
    # scratch, released on return: the caching allocator hands its memory
    # only to work queued after the kernel on this stream
    f32 = dict(dtype=torch.float32, device=q.device)
    dec = torch.empty((3, rn * c), **f32)          # lc, beta, w per token
    lt = torch.empty((rn,), **f32)
    scores = torch.empty((rn * c * c,), **f32)
    chunk_states = torch.empty((rn * -(-dk * dv // 256) * 256,), **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
            beta.data_ptr(), y.data_ptr(), state.data_ptr(),
            dec[0].data_ptr(), dec[1].data_ptr(), dec[2].data_ptr(),
            lt.data_ptr(), scores.data_ptr(), chunk_states.data_ptr(),
            b, s, h, dk, dv, c,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *log_a.stride(), *beta.stride(), *y.stride()[:3],
            DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_wide_fwd launch failed: CUDA error "
                           f"{rc}")
    launches["ssd_scan_wide"] += 1
    return y, state
