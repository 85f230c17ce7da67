"""PyTorch + CUDA port of the heterogeneous-multicore scheduler.

Mirrors the module layout of the JAX package `repro`. The scheduling path:
the closed-form throughput/energy model (`core`), the block-move GrIn
solver whose per-step move scoring runs in a hand-written CUDA kernel
(`kernels.grin_moves`), the largest-deficit `SchedulerCore` (`sched.api`)
and the batched closed-network simulator (`sim.engine_torch`). The serving
path: model configs (`configs`), the dense and hybrid model stack
(`models`) whose prefill runs hand-written flash-attention and SSD-scan
kernels (`kernels.ops`), the `ServeEngine` (`serve.engine`), the
virtual-time pools (`sched.virtual`) and the serve CLI (`launch.serve`).
Imports torch, numpy and scipy only.

Every entry point takes `device=` and runs on the GPU unless the caller asks
for the CPU explicitly (`device="cpu"`): a tensor on the CPU takes the plain
PyTorch version of each kernel, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, or "cuda" when omitted.

    Raises when CUDA is asked for (explicitly or by default) and absent —
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: cuda | cpu")
    return dev


__all__ = ["resolve_device"]
