#!/usr/bin/env python3
"""The bf16 rounding floor of the train-sharded phase's gradient check, on
one NVIDIA GPU:

    python3 tools/sharded_grad_floor.py [--archs A ...] [--layers N] \
        [--against-float32]

A data-parallel step sums each data shard's gradients, taken over fewer
rows, in float32 across the shards; one rank takes them over all the rows
of a microbatch at once. This tool takes one step's gradients on one rank
(chip_smoke's train-sharded cell: SHARDED_B x SHARDED_S tokens, the
arch cut to its SHARDED_LAYERS blocks or `--layers`, at cfg.dtype) with
SHARDED_MICRO
microbatches and with SHARDED_MICRO x 2 (each microbatch one data shard's
rows), and prints ||a - b|| / ||b|| per leaf group, the worst first: the
rounding the split alone moves. For the moe family the first routes each
half of a microbatch's rows alone (`per_shard_moe(2)`, as the mesh's data
shards route), so both route the same rows together. Each with the
embedding's fixed-order float32 backward (`layers.embedding_rows`) and
with autograd's index backward in its place (bf16 adds one by one).

With `--against-float32`, for each arch the bf16 rounding itself, per
leaf group: the step at cfg.dtype through the kernels (the main route),
the same at twice the microbatches, with the plain scans and attention,
and at float32 through the scan kernels (attention plain: the flash
kernels take bf16 only) against float32 with the plain scans and
attention (float32 throughout: the reference), each group's figure
printed. Builds the kernels as the smoke does. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def index_backward():
    """`layers.embedding_rows` as plain indexing (autograd's backward)."""
    from repro_torch.models import layers as L
    real = L.embedding_rows
    L.embedding_rows = lambda w, tok: w[tok]
    try:
        yield
    finally:
        L.embedding_rows = real


@contextlib.contextmanager
def per_shard_moe(shards: int):
    """`layers.apply_moe` with each call's rows cut into `shards` equal
    shards in order, each routed and filled to capacity alone, the outputs
    put back in order and the auxes averaged: a mesh's per-shard dispatch
    on one device."""
    import torch
    from repro_torch.models import layers as L
    real = L.apply_moe

    def chunked(p, x, cfg):
        ys, auxes = zip(*(real(p, xs, cfg) for xs in x.chunk(shards, 0)))
        return torch.cat(ys, 0), sum(a.float() for a in auxes) / shards
    L.apply_moe = chunked
    try:
        yield
    finally:
        L.apply_moe = real


def step_grads(cfg, dev, micro: int, batch: dict, shards: int = 1) -> dict:
    import torch
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    import chip_smoke as cs
    opt = OptimizerConfig(lr=cs.TRAIN_LR, warmup_steps=1, decay_steps=1)
    model = Model(cfg, device=dev)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0),
                             opt)
    grads = {}
    with per_shard_moe(shards):
        make_train_step(model, opt, microbatches=micro,
                        grad_hook=grads.update)(state, batch)
    return grads


def against_float32(cfg, dev, batch) -> None:
    """Print each route's gradients against float32 with the plain scans
    and attention, per leaf group (module docstring)."""
    import torch
    import chip_smoke as cs
    m, f32 = cs.SHARDED_MICRO, cfg.with_(dtype="float32")
    plain = (cs.plain_attention, cs.plain_scans)
    routes = {"bf16 kernels": (cfg, m, ()),
              "bf16 kernels at twice the microbatches": (cfg, 2 * m, ()),
              "bf16 plain scans and attention": (cfg, m, plain),
              "float32 scan kernels": (f32, m, (cs.plain_attention,)),
              "float32 plain": (f32, m, plain)}
    grads = {}
    for name, (c, micro, ctxs) in routes.items():
        with contextlib.ExitStack() as st:
            for ctx in ctxs:
                st.enter_context(ctx())
            grads[name] = step_grads(c, dev, micro, batch)
    want = grads.pop("float32 plain")
    pairs = [(n, "float32 plain") for n in grads] + [
        ("bf16 kernels", "bf16 kernels at twice the microbatches"),
        ("bf16 kernels", "bf16 plain scans and attention")]
    for a, b in pairs:
        rel = cs.group_rel_errs(grads[a], want if b == "float32 plain"
                                else grads[b])
        print(f"{cfg.name} ({cfg.n_layers} blocks), {a} against {b}: "
              + ", ".join(f"{g} {v:.2e}" for g, v in sorted(rel.items())),
              flush=True)
    del grads, want
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import chip_smoke as cs
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+", default=list(cs.SHARDED_ARCHS))
    ap.add_argument("--layers", type=int, default=None,
                    help="blocks (default: the phase's for each arch)")
    ap.add_argument("--against-float32", action="store_true",
                    help="each route's gradients against float32 instead")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.train.data import DataConfig, batch_for_step
    if not torch.cuda.is_available():
        print("sharded_grad_floor: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs.build_kernels()
    dev = torch.device("cuda")
    for arch in args.archs:
        cfg = get_arch(arch).with_(
            n_layers=args.layers or cs.SHARDED_LAYERS[arch])
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=cs.SHARDED_S,
                        global_batch=cs.SHARDED_B,
                        n_codebooks=cfg.n_codebooks,
                        n_patches=cfg.n_patches, d_model=cfg.d_model)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in batch_for_step(dc, 0).items()}
        if args.against_float32:
            against_float32(cfg, dev, batch)
            continue
        for name, ctx in (("float32 fixed-order embedding backward",
                           contextlib.nullcontext),
                          ("autograd's index backward", index_backward)):
            with ctx():
                a = step_grads(cfg, dev, cs.SHARDED_MICRO, batch,
                               shards=2 if cfg.family == "moe" else 1)
                b = step_grads(cfg, dev, 2 * cs.SHARDED_MICRO, batch)
            rel = cs.group_rel_errs(a, b)
            del a, b
            torch.cuda.empty_cache()
            worst = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
            print(f"{cfg.name} ({cfg.n_layers} blocks), {name}: "
                  f"{cs.SHARDED_MICRO} against {2 * cs.SHARDED_MICRO} "
                  f"microbatches, worst groups "
                  + ", ".join(f"{g} {v:.2e}" for g, v in worst), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
