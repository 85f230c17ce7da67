"""Meshes (the reference's `launch/mesh.py`): the production shapes, with
no devices attached, and a small mesh over the cards that exist."""
from __future__ import annotations

import torch

from repro_torch.parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips): the
    shape the dry-run sizes cells on; no devices attached."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_debug_mesh(n_devices: int | None = None, *, multi_pod: bool = False,
                    devices=None) -> Mesh:
    """A small mesh over `devices`, else over the first `n_devices` CUDA
    cards, else over every card there is (`torch.cuda.device_count()`),
    factored as the reference factors it: model 2 where n is even, the rest
    data (multi-pod: 2 pods). A mesh of more devices than exist carries
    none. Raises when there is no card and neither n nor devices is
    given."""
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        n = len(devices)
    else:
        n = n_devices or torch.cuda.device_count()
        if n < 1:
            raise RuntimeError("make_debug_mesh: no CUDA device; pass "
                               "n_devices or devices")
        devices = (tuple(torch.device("cuda", i) for i in range(n))
                   if n <= torch.cuda.device_count() else ())
    if multi_pod and n % 2 == 0:
        model = 2 if n % 4 == 0 else 1
        return Mesh(("pod", "data", "model"), (2, n // 2 // model, model),
                    devices)
    model = 2 if n % 2 == 0 else 1
    return Mesh(("data", "model"), (n // model, model), devices)


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
