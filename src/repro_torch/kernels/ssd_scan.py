"""Chunked SSD linear recurrence as a hand-written CUDA kernel and its plain
version.

`ssd_scan_cuda` launches `csrc/ssd_scan.cu`, the counterpart of the TPU
kernel `ssd_scan_pallas` for states up to 128 x 128 (Mamba2's 64 x 64
heads): one block per (batch, head, slice of 64 dv columns; the whole
serving head) walks the sequence in sub-tiles on the tensor cores, with
its slice of the float32 state in registers, and writes y and the final
state. It reads the model layout (B, S, H, d) in place through strides; a
head stride of 0 (Mamba2's B and C expanded over heads) is read without a
copy. Wider states (mLSTM's) go to `kernels.ssd_scan_wide`. The plain
version is `models.linear_scan.linear_scan_chunked`. The public entry
point is `kernels.ops.ssd_scan`, which picks one by the tensor's device
and, on the card, a kernel by the state's width.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import MODEL_NVCC_FLAGS, load_library
from repro_torch.models.linear_scan import linear_scan_chunked

SOURCES = ("ssd_scan.cu",)
MAX_DIM = 128           # dk, dv: the state's shared copy must fit
MAX_TILE = 64           # tokens per sub-tile inside the kernel
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # codes for q, k, v, y

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


def check_inputs(name, q, k, v, log_a, beta, chunk, max_dim, why):
    """The checks of this wrapper and `ssd_scan_wide.ssd_scan_wide_cuda`;
    `why` says what caps dk and dv."""
    ts = (q, k, v, log_a, beta)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3] or log_a.shape != q.shape[:3] \
            or beta.shape != q.shape[:3]:
        raise ValueError(f"{name}: q, k (B, S, H, dk), v (B, S, H, dv), "
                         f"log_a, beta (B, S, H); got "
                         f"{[tuple(t.shape) for t in ts]}")
    dk, dv = q.shape[-1], v.shape[-1]
    if dk > max_dim or dv > max_dim:
        raise ValueError(f"{name}: dk, dv <= {max_dim} ({why}); got {dk}, "
                         f"{dv}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v one dtype of float32/bfloat16; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if log_a.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError(f"{name}: log_a and beta must be float32")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v need a unit stride on the last "
                         f"axis")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")


def ssd_scan_cuda(q, k, v, log_a, beta, *, chunk=256):
    """q, k: (B, S, H, dk); v: (B, S, H, dv), one dtype (float32 or
    bfloat16), unit stride on the last axis; log_a, beta: (B, S, H) float32;
    dk, dv <= 128 (`MAX_DIM`; wider states: `ssd_scan_wide`). The
    kernel walks each chunk in sub-tiles of min(chunk, 64) tokens, one
    block per 64 columns of dv. Returns (y (B, S, H, dv) in v's dtype,
    final state (B, H, dk, dv) float32)."""
    check_inputs("ssd_scan_cuda", q, k, v, log_a, beta, chunk, MAX_DIM,
                 "the state's bf16 copy lives in shared memory; wider "
                 "states go to ssd_scan_wide.ssd_scan_wide_cuda")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
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
            DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed: CUDA error {rc}")
    launches["ssd_scan"] += 1
    return y, state

