"""Row-wise RMSNorm as a hand-written CUDA kernel and its plain version.

`rmsnorm_cuda` launches `csrc/rmsnorm.cu` (one block per row, float32
statistics, a (1 + w) scale; the counterpart of the TPU kernel
`rmsnorm_pallas`). The plain version is `kernels.ref.rmsnorm_ref`. The
public entry point is `kernels.ops.rmsnorm`, which picks one by the
tensor's device. CUDA C++ rather than Triton, so the port keeps one build
system (nvcc, plain C entry points, ctypes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import MODEL_NVCC_FLAGS, load_library
from repro_torch.kernels.ref import rmsnorm_ref

SOURCES = ("rmsnorm.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel; the plain version never counts.
launches = {"rmsnorm": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


rmsnorm_plain = rmsnorm_ref


def _kernel_lib():
    fn = load_library("rmsnorm", SOURCES, MODEL_NVCC_FLAGS).rmsnorm_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, ctypes.c_longlong, I, ctypes.c_float, I, I, I, P]
    fn.restype = I
    return fn


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """x: (T, D) contiguous CUDA float32/bfloat16; w: (D,) contiguous
    float32/bfloat16 on the same device. Returns (T, D) in x's dtype."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("rmsnorm_cuda takes CUDA tensors on one device")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_cuda: x (T, D) and w (D,); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm_cuda takes float32/bfloat16; got "
                         f"{x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda takes contiguous x and w")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rows, d = x.shape
    vec = int(d * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows,
                           d, float(eps), _DTYPES[x.dtype], _DTYPES[w.dtype],
                           vec, stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm_fwd launch failed: CUDA error {rc}")
    launches["rmsnorm"] += 1
    return out
