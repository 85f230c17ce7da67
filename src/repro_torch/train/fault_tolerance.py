"""Fault tolerance: the checkpoint/restart loop, elastic re-meshing and
straggler mitigation (the reference's `train/fault_tolerance.py`).

1. **Checkpoint/restart** — `run_with_recovery` wraps the step loop: any
   exception triggers restore-from-latest and replay (the data pipeline is
   step-indexed, so replay is exact). Checkpoint cadence + async writes keep
   the overhead off the step path. The port's update writes the state in
   place, so a fault inside it (`PartialUpdateError`) is replayed only
   from a checkpoint; with none it is raised.

2. **Elastic scaling** — `ElasticMeshManager` rebuilds the mesh when the
   healthy set changes (an injectable provider: the live ranks of the
   world by default, or devices, the CUDA cards outside a world) and
   re-shards state onto it: on a mesh of ranks (a new process group over
   the survivors) each rank takes its pieces; on a mesh of one device each
   tensor is moved there.

3. **Straggler mitigation** — per-pool observed step-rates feed an EWMA into
   the paper's scheduler (repro_torch.sched): a slow pool's mu column drops,
   GrIn re-solves, and load migrates away. `StragglerTracker` is that EWMA.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np
import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as S
from repro_torch.parallel.sharding import Mesh

log = logging.getLogger("repro_torch.ft")


class PartialUpdateError(RuntimeError):
    """A step failed after it began to write its state in place: the state
    is part old, part new, and only a restore can make it whole again."""


def run_with_recovery(step_fn: Callable, state, data_iter,
                      *, ckpt_dir: str, ckpt_every: int = 100,
                      max_steps: int = 1000, max_restarts: int = 3,
                      async_ckpt: bool = True):
    """Run step_fn(state, batch) with checkpoint/restore-based recovery.

    Returns (state, steps_completed, restarts). Step indices come from the
    data iterator, so replay after a restore is exact. The port's steps
    update the state in place: a fault raised before the step's update
    leaves it whole, and with no checkpoint the replay starts from it, as
    the reference's does from its last state. A `PartialUpdateError` (a
    fault inside the update) leaves it torn: it is replayed from the latest
    checkpoint, which overwrites every leaf, and re-raised when there is
    none.
    """
    # imported here: the scheduler imports this module for StragglerTracker
    # and needs none of the model stack that checkpoints import
    from repro_torch.train import checkpoint as ckpt
    restarts = 0
    pending = None
    step = int(state.step) if hasattr(state, "step") else 0
    while step < max_steps:
        try:
            for i, batch in data_iter:
                if i >= max_steps:
                    break
                state, metrics = step_fn(state, batch)
                step = i + 1
                if step % ckpt_every == 0:
                    if pending is not None:
                        pending.join()
                    pending = ckpt.save(ckpt_dir, step, state,
                                        async_=async_ckpt)
            break
        except Exception as e:  # noqa: BLE001 — any fault triggers recovery
            restarts += 1
            log.warning("step %d failed (%s); restart %d", step, e, restarts)
            # Drain any in-flight async checkpoint BEFORE touching ckpt_dir:
            # restoring (or re-raising) while the writer thread is mid-file
            # would race latest_step/restore against a half-written step.
            if pending is not None:
                pending.join()
                pending = None
            ckpt.barrier(state)     # rank 0's files are written for all
            if restarts > max_restarts:
                raise
            latest = ckpt.latest_step(ckpt_dir)
            if latest is not None:
                state, step = ckpt.restore(ckpt_dir, state)
            elif isinstance(e, PartialUpdateError):
                raise   # a torn state and nothing to restore it from
            data_iter.seek(step) if hasattr(data_iter, "seek") else None
    if pending is not None:
        pending.join()
    return state, step, restarts


def cuda_devices() -> list:
    """The CUDA cards there are, as devices."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def live_units() -> list:
    """The default provider: the ranks of the world when this process is
    one of a world (`parallel.collectives.init_world`), else the CUDA
    cards."""
    world = C.world()
    if world["rank"] is not None:
        return list(range(world["size"]))
    return cuda_devices()


@dataclasses.dataclass
class ElasticMeshManager:
    """Rebuild the mesh and re-shard state when the healthy set changes."""

    axis_names: tuple
    device_provider: Callable = live_units   # injectable for failure tests

    def current_mesh(self) -> Mesh:
        """The mesh over what the provider returns, factored as the
        reference factors it (model as large as 16, 8, 4, 2 or 1 divides):
        over ranks (ints) a mesh of ranks with its process groups, made by
        those ranks only; over devices a mesh of devices."""
        from repro_torch.launch.mesh import mesh_over_ranks
        units = tuple(self.device_provider())
        n = len(units)
        # factor n into (data, model): keep model as square as possible
        model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
        names, sizes = tuple(self.axis_names[-2:]), (n // model, model)
        if units and all(isinstance(u, int) for u in units):
            return mesh_over_ranks(units, names, sizes)
        return Mesh(names, sizes, units)

    def reshard(self, tree, spec_tree, mesh: Mesh, *, src=None):
        """`tree` (dicts and lists of tensors and numbers) placed on `mesh`
        by `spec_tree` (a matching tree of `Spec`s). Its tensors are whole
        on this rank (restored from a checkpoint, say), or with `src` (a
        (mesh, spec tree) pair) this rank's pieces on the mesh `src`, each
        gathered whole over it first (every rank of `src` takes part: a
        planned shrink, where the leaving ranks still answer). On a mesh of
        ranks each rank keeps its pieces (None on a rank outside it); on a
        mesh of one device each tensor is moved there. A mesh of several
        devices and no ranks holds no state: it raises."""
        if src is not None:
            tree = _gather_tree(tree, src[1], src[0])
        if mesh.ranks and mesh.rank is None:
            return None                 # not one of the mesh's ranks
        if S.live(mesh):
            return _map(tree, spec_tree,
                        lambda x, s: S.local_slice(x, s, mesh).clone())
        if mesh.size != 1:
            raise ValueError(f"reshard onto {mesh.shape} with no ranks: a "
                             f"mesh of devices and no processes holds no "
                             f"state")
        if mesh.rank is not None:       # a mesh of one rank: its device
            dev = C.world()["device"]
        elif len(mesh.devices) == 1:
            dev = torch.device(mesh.devices[0])
        else:
            raise ValueError(f"reshard onto a mesh of one with "
                             f"{len(mesh.devices)} devices attached")
        return _map(tree, spec_tree, lambda x, s: x.to(dev))


def _map(node, spec, fn):
    """fn(tensor, spec) over a tree of dicts, lists and tuples."""
    if isinstance(node, dict):
        return {k: _map(v, spec[k], fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map(v, s, fn) for v, s in zip(node, spec))
    return fn(node, spec) if isinstance(node, torch.Tensor) else node


def _gather_tree(tree, spec_tree, mesh):
    """Every piece of `tree` (laid out by `spec_tree` on the mesh of ranks
    `mesh`) gathered whole; a rank outside `mesh` gets the tree back."""
    if not S.live(mesh):
        return tree
    return _map(tree, spec_tree, lambda x, s: S.gather_whole(x, s, mesh))


class StragglerTracker:
    """EWMA of per-pool speed RELATIVE to expectation (1.0 = nominal).

    Observations must be normalized per task class (expected/actual service
    time) — raw rates would conflate a pool's task mix with its health."""

    def __init__(self, n_pools: int, alpha: float = 0.3):
        self.alpha = alpha
        self.rates = np.ones(n_pools)     # relative speed, 1.0 = nominal
        self.seen = np.zeros(n_pools, dtype=bool)

    def observe(self, pool: int, rel_speed: float):
        """rel_speed = expected_service_s / actual_service_s."""
        if not self.seen[pool]:
            self.rates[pool] = rel_speed
            self.seen[pool] = True
        else:
            self.rates[pool] = (self.alpha * rel_speed
                                + (1 - self.alpha) * self.rates[pool])

    def slowdown_factors(self) -> np.ndarray:
        """Per-pool relative speed (<1 = straggler, >1 = faster than nominal).

        Normalized so the fleet-best healthy pool anchors at its own scale —
        the scheduler multiplies base mu columns by these factors."""
        return np.where(self.seen, self.rates, 1.0)
