"""Fault tolerance: the checkpoint/restart loop, elastic re-meshing and
straggler mitigation (the reference's `train/fault_tolerance.py`).

1. **Checkpoint/restart** — `run_with_recovery` wraps the step loop: any
   exception triggers restore-from-latest and replay (the data pipeline is
   step-indexed, so replay is exact). Checkpoint cadence + async writes keep
   the overhead off the step path. The port's update writes the state in
   place, so a fault inside it (`PartialUpdateError`) is replayed only
   from a checkpoint; with none it is raised.

2. **Elastic scaling** — `ElasticMeshManager` rebuilds the mesh when the
   healthy-device set changes (an injectable device-list provider; the CUDA
   cards by default) and re-shards live state onto it. The port runs on one
   card: on a mesh of one device re-sharding moves each tensor there, and
   on a larger mesh it raises.

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


@dataclasses.dataclass
class ElasticMeshManager:
    """Rebuild the mesh and re-shard state when the device set changes."""

    axis_names: tuple
    device_provider: Callable = cuda_devices   # injectable for failure tests

    def current_mesh(self) -> Mesh:
        devs = tuple(self.device_provider())
        n = len(devs)
        # factor n into (data, model): keep model as square as possible
        model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
        return Mesh(tuple(self.axis_names[-2:]), (n // model, model), devs)

    def reshard(self, tree, spec_tree, mesh: Mesh):
        """`tree` (dicts and lists of tensors) on `mesh`: on one device each
        tensor moved to it; sharding over several is not ported."""
        if mesh.size != 1 or len(mesh.devices) != 1:
            raise NotImplementedError(
                f"reshard onto a mesh of {mesh.size} devices "
                f"({len(mesh.devices)} attached): the port runs on one card")
        dev = torch.device(mesh.devices[0])

        def move(node, spec):
            if isinstance(node, dict):
                return {k: move(v, spec[k]) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(move(v, s) for v, s in zip(node, spec))
            return node.to(dev) if isinstance(node, torch.Tensor) else node
        return move(tree, spec_tree)


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
