"""Chunked SSD linear recurrence as a hand-written CUDA kernel and its plain
version.

`ssd_scan_cuda` launches `csrc/ssd_scan.cu`, the counterpart of the TPU
kernel `ssd_scan_pallas`: one block per (batch, head) row walks the
sequence with the float32 state in shared memory and writes y and the final
state. It reads the model layout (B, S, H, d) in place through strides; a
head stride of 0 (Mamba2's B and C expanded over heads) is read without a
copy. The plain version is `models.linear_scan.linear_scan_chunked`. The
public entry point is `kernels.ops.ssd_scan`, which picks one by the
tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import MODEL_NVCC_FLAGS, load_library
from repro_torch.models.linear_scan import linear_scan_chunked

SOURCES = ("ssd_scan.cu",)
MAX_DIM = 128           # dk, dv: the state must fit in shared memory
MAX_TILE = 64           # tokens per sub-tile inside the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel; the plain version never counts.
launches = {"ssd_scan": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


ssd_scan_plain = linear_scan_chunked


def _kernel_lib():
    fn = load_library("ssd_scan", SOURCES, MODEL_NVCC_FLAGS).ssd_scan_fwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P] * 7 + [I] * 6 + [L] * 18 + [I, P]
    fn.restype = I
    return fn


def ssd_scan_cuda(q, k, v, log_a, beta, *, chunk=256):
    """q, k: (B, S, H, dk); v: (B, S, H, dv), one dtype (float32 or
    bfloat16), unit stride on the last axis; log_a, beta: (B, S, H) float32;
    dk, dv <= 128. The kernel walks each chunk in sub-tiles of
    min(chunk, 64) tokens. Returns (y (B, S, H, dv) in v's dtype, final
    state (B, H, dk, dv) float32)."""
    ts = (q, k, v, log_a, beta)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError("ssd_scan_cuda takes CUDA tensors on one device")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3] or log_a.shape != q.shape[:3] \
            or beta.shape != q.shape[:3]:
        raise ValueError(f"ssd_scan_cuda: q, k (B, S, H, dk), v (B, S, H, "
                         f"dv), log_a, beta (B, S, H); got "
                         f"{[tuple(t.shape) for t in ts]}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if dk > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"ssd_scan_cuda: dk, dv <= {MAX_DIM} (the state "
                         f"lives in shared memory); got {dk}, {dv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"ssd_scan_cuda: q, k, v one dtype of float32/"
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if log_a.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError("ssd_scan_cuda: log_a and beta must be float32")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("ssd_scan_cuda: q, k, v need a unit stride on the "
                         "last axis")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")
    y = torch.empty((b, s, h, dv), dtype=v.dtype, device=q.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    if y.numel() == 0 or s == 0:
        state.zero_()
        return y, state
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
            beta.data_ptr(), y.data_ptr(), state.data_ptr(),
            b, s, h, dk, dv, min(chunk, MAX_TILE),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *log_a.stride(), *beta.stride(), *y.stride()[:3],
            _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed: CUDA error {rc}")
    launches["ssd_scan"] += 1
    return y, state
