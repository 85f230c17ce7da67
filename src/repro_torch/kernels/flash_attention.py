"""Causal flash attention (GQA, sliding window) as a hand-written CUDA
kernel and its plain version.

`flash_attention_cuda` launches `csrc/flash_attention.cu`, the counterpart
of the TPU kernel `flash_attention_pallas`, for bfloat16 inputs (the
serving engine's dtype) on the tensor cores (mma.sync, float32
accumulation); it raises on float32, which no path on the card sends. It
reads the model layout (B, S, heads, dh) in place through strides and
writes a contiguous bfloat16 (B, Sq, H, dh) output. The
plain version is `models.attention.chunked_attention`, the online-softmax
recurrence in PyTorch. The public entry point is
`kernels.ops.flash_attention`, which picks one by the tensor's device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import MODEL_NVCC_FLAGS, load_library
from repro_torch.models.attention import chunked_attention

SOURCES = ("flash_attention.cu",)
# Instantiated in the CUDA source: the registry's head dims (112 for
# zamba2-7b, 128 for yi / qwen / granite), the reference sweep's 64 and 96,
# and 32, the reduced `smoke_config` models' (the serve CLI on a card).
HEAD_DIMS = (32, 64, 96, 112, 128)

# Launches of the CUDA kernel; the plain version never counts.
launches = {"flash_attention": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


flash_attention_plain = chunked_attention


def _kernel_lib():
    fn = load_library("flash_attention", SOURCES,
                      MODEL_NVCC_FLAGS).flash_attention_fwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, P, I, I, I, I, I, I] + [L] * 12 + [
        I, I, ctypes.c_float, P]
    fn.restype = I
    return fn


def kernel_takes_strides(*tensors) -> bool:
    """True when the kernel can read these bfloat16 tensors in place: unit
    stride on dh, and other strides and base pointers 16-byte aligned (the
    tile loads are 16 bytes wide)."""
    for t in tensors:
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s % 8 for s in t.stride()[:-1]):
            return False
    return True


def flash_attention_cuda(q, k, v, *, causal=True, window=0):
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh); CUDA bfloat16, dh in
    HEAD_DIMS, H % KV == 0, strides the kernel takes
    (`kernel_takes_strides`). Scale 1/sqrt(dh). Returns (B, Sq, H, dh)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_cuda: q (B, Sq, H, dh), k/v (B, "
                         f"Sk, KV, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    _, sk, kv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or kv == 0 or h % kv:
        raise ValueError(f"flash_attention_cuda: incompatible shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {dh} not in "
                         f"{HEAD_DIMS}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"flash_attention_cuda takes bfloat16 q, k, v; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not kernel_takes_strides(q, k, v):
        raise ValueError("flash_attention_cuda: strides or alignment the "
                         "kernel does not take (see kernel_takes_strides)")
    if b * h > 65535:
        raise ValueError(f"flash_attention_cuda: B*H = {b * h} > 65535")
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kv, dh,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(bool(causal)), int(window), 1.0 / math.sqrt(dh), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc}")
    launches["flash_attention"] += 1
    return out
