"""Meshes (the reference's `launch/mesh.py`): the production shapes, with
no devices attached, and a small mesh over the ranks of the world or the
cards that exist."""
from __future__ import annotations

import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips): the
    shape the dry-run sizes cells on; no devices attached."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def factor(n: int, multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(axis names, sizes) of a debug mesh of n, as the reference factors
    it: model 2 where n is even, the rest data (multi-pod: 2 pods)."""
    if multi_pod and n % 2 == 0:
        model = 2 if n % 4 == 0 else 1
        return ("pod", "data", "model"), (2, n // 2 // model, model)
    model = 2 if n % 2 == 0 else 1
    return ("data", "model"), (n // model, model)


def mesh_over_ranks(ranks, names: tuple, sizes: tuple) -> Mesh:
    """The mesh `sizes` over `ranks` (row-major) with this process's rank
    of the world, its process groups made (by the mesh's ranks only); a
    process outside `ranks` gets the mesh with no rank of its own."""
    me = C.world()["rank"]
    mesh = Mesh(tuple(names), tuple(sizes), ranks=tuple(ranks),
                rank=me if me in ranks else None)
    if mesh.rank is not None:
        C.bind(mesh)
    return mesh


def make_debug_mesh(n_devices: int | None = None, *, multi_pod: bool = False,
                    devices=None) -> Mesh:
    """In a world of ranks (`parallel.collectives.init_world`) and with
    neither n nor devices given: the mesh over the world's ranks, with
    this process's rank and its process groups. Otherwise a small mesh
    over `devices`, else over the first `n_devices` CUDA cards, else over
    every card there is (`torch.cuda.device_count()`). Factored as the
    reference factors it (`factor`). A mesh of more devices than exist
    carries none. Raises when there is no card, no world and neither n nor
    devices is given."""
    world = C.world()
    if world["rank"] is not None and n_devices is None and devices is None:
        return mesh_over_ranks(range(world["size"]),
                               *factor(world["size"], multi_pod))
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
    return Mesh(*factor(n, multi_pod), devices)


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
