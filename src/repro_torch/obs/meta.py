"""Run metadata: make every perf number attributable.

`run_meta()` captures the execution substrate a measurement ran on — torch
and CUDA versions, the card's name, the gain-scoring path (the hand-written
CUDA kernel or the plain PyTorch version), compute dtype — and the engine
stamps it onto every SimMetrics row, so a number always says where it was
measured.
"""
from __future__ import annotations

import platform

import torch


def kernel_mode(device) -> str:
    """Which gain-scoring path `repro_torch.kernels.grin_moves` takes for
    tensors on `device`: "cuda" (the hand-written kernel) or
    "torch-reference" (the plain PyTorch version, CPU tensors only)."""
    return "cuda" if torch.device(device).type == "cuda" else \
        "torch-reference"


def run_meta(device) -> dict:
    """Machine-readable substrate block for metrics rows."""
    dev = torch.device(device)
    on_gpu = dev.type == "cuda"
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev) if on_gpu
                        else platform.processor() or "cpu"),
        "kernel_mode": kernel_mode(dev),
        "dtype": "float32",              # the engines' device state dtype
        "python": platform.python_version(),
        "platform": platform.system().lower(),
    }


__all__ = ["run_meta", "kernel_mode"]
