"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains an architecture from a seeded random initialisation on the
synthetic Zipfian corpus (`train.data`): the microbatched AdamW step
(`train.train_step`), checkpoints every `--ckpt-every` steps and restart on
a fault (`train.fault_tolerance.run_with_recovery`). `--smoke` (the
default) trains the reduced same-family config, `--full` the registry's.
Runs on the card unless `--device cpu` is given. On the card every family
trains through its kernels and the kernels' backward kernels (flash
attention, the SSD scan, mLSTM's pair); the moe family's routed experts
through their fixed-order backward (`models.layers.dispatch_rows`,
`combine_rows`), so two runs give the same gradients. The run is bound to
a one-device mesh (`parallel.use_mesh(launch.mesh.make_debug_mesh(...))`),
as the reference's launcher binds its mesh. `train(...)` is the same run
as a function.

Sharded: under `python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.train ...` (or in any process that joined a world with
`parallel.collectives.init_world`) the dense and moe families train on a
mesh over the world's ranks (`make_debug_mesh`: model 2 where N is even,
the rest data), each rank on cuda:(LOCAL_RANK % the cards) or the CPU:
masters and moments placed by `param_pspec_tree` (fsdp over "data", tp
over "model"; each rank draws the one-device initial state a block at a
time and keeps its pieces), the sharded train step (`train.train_step`),
checkpoints gathered to rank 0. The transport is NCCL where each rank has
a card of its own, gloo (staging CUDA tensors through pinned host memory)
where ranks share one or on the CPU; it is printed.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.model import Model, count_params
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import live, use_mesh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, DataPipeline
from repro_torch.train.fault_tolerance import run_with_recovery
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import init_train_state, make_train_step

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_launch_train")


class Batches:
    """(index, batch) from a `DataPipeline`, as tensors on `device`;
    `seek(step)` restarts the stream at batch `step` (the replay after a
    restore)."""

    def __init__(self, dc: DataConfig, device, start: int = 0):
        self.dc, self.device = dc, device
        self.pipe = DataPipeline(dc, start_step=start)

    def __iter__(self):
        return self

    def __next__(self):
        i, b = next(self.pipe)
        return i, {k: torch.from_numpy(v).to(self.device)
                   for k, v in b.items()}

    def seek(self, step: int):
        self.pipe.close()
        self.pipe = DataPipeline(self.dc, start_step=step)

    def close(self):
        self.pipe.close()


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
          microbatches: int = 1, smoke: bool = True, layers: int | None = None,
          ckpt_dir: str | None = None, ckpt_every: int = 50, device=None,
          seed: int = 0, opt: OptimizerConfig | None = None,
          step_wrapper=None, log=print, config=None,
          resume: bool = False, grad_hook=None) -> dict:
    """Train `arch` (`smoke_config` of it unless `smoke=False`, cut to
    `layers` blocks when given; `config`, when given, is the config to
    train in place of the registry's) for `steps` steps of `batch` x `seq`
    tokens in `microbatches` microbatches, from parameters drawn from a
    `torch.Generator` seeded `seed`, or with `resume` from the latest
    checkpoint in `ckpt_dir` where there is one; `opt` defaults to the
    reference launcher's AdamW (warmup over 10 steps, decay over `steps`).
    `step_wrapper`, if given, wraps the logged step function (the card
    smoke measures and injects faults there); `grad_hook`, if given, is
    the train step's (`make_train_step`). Returns {"cfg", "model",
    "state", "steps", "restarts", "history"}: history one dict per step
    run, with its loss, grad_norm, lr and seconds. In a world of several
    ranks the run is sharded over a mesh of them (module docstring):
    every rank calls `train` alike, with `device` its own ("cuda" picks
    cuda:(LOCAL_RANK % the cards)); only rank 0 logs."""
    world = C.world()
    sharded = world["rank"] is not None and world["size"] > 1
    dev = resolve_device(device) if not sharded else C.rank_device(
        device or world["device"])
    if sharded and world["rank"] != 0:
        log = _silent
    cfg = config or get_arch(arch)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    if smoke:
        cfg = smoke_config(cfg)
    log(f"[train] {cfg.name}: {count_params(cfg) / 1e6:.1f}M params "
        f"(family={cfg.family}) on {dev}")
    mesh = make_debug_mesh() if sharded else make_debug_mesh(devices=[dev])
    model = Model(cfg, device="meta" if sharded else dev)
    opt = opt or OptimizerConfig(warmup_steps=10, decay_steps=steps)
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed), opt,
        mesh=mesh)
    step_fn = make_train_step(model, opt, microbatches=microbatches,
                              grad_hook=grad_hook)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=batch, n_codebooks=cfg.n_codebooks,
                    n_patches=cfg.n_patches, d_model=cfg.d_model)
    history = []

    def logged_step(s, b):
        t0 = time.perf_counter()
        s, m = step_fn(s, b)            # its float metrics synchronise
        m["s"] = time.perf_counter() - t0
        history.append({"step": s.step, **m})
        if s.step % 10 == 0 or s.step in (1, steps):
            log(f"[train] step {s.step:4d} loss={m['loss']:.4f} "
                f"({m['s']:.2f}s/step)")
        return s, m

    ckpt_dir = ckpt_dir or DEFAULT_CKPT_DIR
    start = 0
    if resume and ckpt.latest_step(ckpt_dir) is not None:
        state, start = ckpt.restore(ckpt_dir, state)
        log(f"[train] resumed from the checkpoint at step {start}")
    batches = Batches(dc, dev, start=start)
    log(f"[train] mesh: {mesh.shape}"
        + (f" over {mesh.size} ranks ({world['transport']})"
           if live(mesh) else ""))
    try:
        with use_mesh(mesh):
            state, n, restarts = run_with_recovery(
                step_wrapper(logged_step) if step_wrapper else logged_step,
                state, batches, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                max_steps=steps)
    finally:
        batches.close()
    log(f"[train] done: {n} steps, {restarts} restarts; checkpoints at "
        f"{ckpt_dir}")
    return {"cfg": cfg, "model": model, "state": state, "steps": n,
            "restarts": restarts, "history": history}


def _silent(*args, **kw) -> None:
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", dest="smoke", action="store_true",
                      default=True, help="reduced config (the default)")
    size.add_argument("--full", dest="smoke", action="store_false",
                      help="the registry's config at full width and depth")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:   # torch.distributed.run
        C.init_world(args.device)
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          microbatches=args.microbatches, smoke=args.smoke,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          device=args.device, seed=args.seed)
    C.leave_world()


if __name__ == "__main__":
    main()
