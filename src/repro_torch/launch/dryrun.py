"""Dry-run: size every (arch x shape) cell on the single-pod 16x16 mesh and
the 2x16x16 multi-pod mesh (the reference's `launch/dryrun.py`), on the
meta device: nothing is allocated, nothing is computed, nothing launches.

Each cell's `Model` is built on the meta device and its function is run
there at the full shape: train, `Model.loss` and its backward on one
microbatch; prefill, `Model.prefill`; decode, `Model.decode_step` on
`init_cache`. The kernel wrappers give the plain versions' output shapes
on meta tensors (`kernels.ops._MetaShapes`). A record holds the sharding
mode, the microbatch count, and per device the bytes of the parameters,
the gradients, the optimizer moments, the compute copy and the caches,
each leaf divided by its `even_spec` shard count, and for a train cell the
activation stash (what autograd keeps between one microbatch's forward and
its backward, measured on the meta run). The reference also records XLA's
cost analysis and its compiled HLO's collective bytes; a PyTorch program
has neither, so each record marks them as not applicable.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch yi-6b]
      [--shape train_4k] [--mesh single|multi|both] [--out reports/dryrun]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import all_cells, get_arch, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.launch.shapes import (batch_pspec, cache_pspec_tree,
                                       resolve_microbatches)
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import (RULES_PREFILL_MULTI,
                                           RULES_PREFILL_SINGLE,
                                           RULES_PURE_DP_MULTI,
                                           RULES_PURE_DP_SINGLE,
                                           compute_param_specs, even_spec,
                                           param_pspec_tree, shard_count,
                                           use_mesh)
from repro_torch.train.train_step import compute_copy, loss_and_grads

NOT_APPLICABLE = ("not applicable: the reference reads XLA's cost analysis "
                  "and the collectives of its compiled SPMD HLO; a PyTorch "
                  "program on one card has neither, and none is estimated")


def _per_device(shapes: dict, specs: dict, dtype, mesh) -> int:
    """Bytes a device holds of tensors of `shapes` ({name: shape}) in
    `dtype`, each cut into its spec's shard count."""
    size = torch.empty((), dtype=dtype).element_size()
    return sum(math.prod(s) * size // shard_count(even_spec(specs[n], s,
                                                            mesh), mesh)
               for n, s in shapes.items())


def _tree_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of the tensors of a cache tree, each cut into its
    spec's shard count."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v, s, mesh) for v, s in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return 0
    return (tree.numel() * tree.element_size()
            // shard_count(even_spec(specs, tree.shape, mesh), mesh))


def _meta_batch(cfg: ModelConfig, kind: str, rows: int, seq: int) -> dict:
    shape = ((rows, cfg.n_codebooks, seq) if cfg.family == "audio"
             else (rows, seq))
    batch = {"tokens": torch.zeros(shape, dtype=torch.int32, device="meta")}
    if kind == "train":
        batch["targets"] = torch.zeros(shape, dtype=torch.int32,
                                       device="meta")
    if cfg.family == "vlm" and kind != "decode":
        batch["patch_embeds"] = torch.zeros(
            (rows, cfg.n_patches, cfg.d_model), device="meta")
    return batch


def _saved_bytes(fn):
    """(fn(), bytes of the tensors autograd saved for the backward while
    fn ran)."""
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, saved[0]


def lower_cell(arch: str, shape_name: str, mesh, *, zero_stage: int = 2,
               serve_tp_only: bool = True, sharding_mode: str = "auto",
               cfg: ModelConfig | None = None,
               shape: ShapeConfig | None = None, trace: bool = True):
    """Size one (arch, shape) cell on `mesh`. Returns (outputs, info):
    outputs the meta run's results (train: (loss, grads); prefill:
    (logits, cache); decode: (logits, cache)), None when `trace` is False
    (the byte counts of the state only). `cfg` and `shape` override the
    registry's (a cut depth, the smoke's batch).

    The sharding choices are the reference's: `sharding_mode="auto"`
    takes pure ZeRO-3 data parallelism for a train cell on one pod (the
    compute copy then stays fully sharded, `zero_stage` 3), FSDP without
    TP for prefill (`serve_tp_only` off), and 2-D dp x tp otherwise;
    `zero_stage` 2 shards the compute copy by TP only, `serve_tp_only` the
    serving parameters."""
    cfg = cfg or get_arch(arch)
    shape = shape or get_shape(shape_name)
    if sharding_mode == "auto":
        if shape.kind == "train" and "pod" not in mesh.axis_names:
            sharding_mode = "pure_dp"
        elif shape.kind == "prefill":
            sharding_mode = "prefill_fsdp"
        else:
            sharding_mode = "2d"
    info = {"arch": cfg.name, "shape": shape.name, "mesh": dict(mesh.shape),
            "kind": shape.kind, "layers": cfg.n_layers,
            "zero_stage": zero_stage, "serve_tp_only": serve_tp_only,
            "sharding_mode": sharding_mode}
    rules, dp = None, None
    multi = "pod" in mesh.axis_names
    if sharding_mode == "pure_dp" and shape.kind == "train":
        rules = RULES_PURE_DP_MULTI if multi else RULES_PURE_DP_SINGLE
        dp = rules["dp"]
        zero_stage = info["zero_stage"] = 3
    if sharding_mode in ("pure_dp", "prefill_fsdp") \
            and shape.kind == "prefill":
        rules = RULES_PREFILL_MULTI if multi else RULES_PREFILL_SINGLE
        dp = rules["dp"]
        serve_tp_only = info["serve_tp_only"] = False
        info["sharding_mode"] = "prefill_fsdp"
    n_dp = math.prod(mesh.shape[a] for a in (dp or dp_axes(mesh)))
    dt = getattr(torch, cfg.dtype)
    model = Model(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out = None
    with use_mesh(mesh, rules):
        info["batch_specs"] = {k: list(v) for k, v in batch_pspec(
            cfg, shape, mesh, dp=dp).items()}
        mem = {}
        if shape.kind == "train":
            micro = resolve_microbatches(cfg, shape, mesh, dp=dp)
            info["microbatches"] = micro
            pspecs = param_pspec_tree(shapes)
            cspecs = pspecs if zero_stage == 3 else compute_param_specs(
                shapes)
            f32 = torch.float32
            mem["params"] = _per_device(shapes, pspecs, f32, mesh)
            mem["grads"] = mem["params"]           # float32 accumulators
            mem["opt_moments"] = 2 * mem["params"]
            mem["compute_copy"] = _per_device(shapes, cspecs, dt, mesh)
            mem["micro_grads"] = mem["compute_copy"]
            rows = max(shape.global_batch // micro, 1)
            b_local = max(shape.global_batch // n_dp, 1)
            info["stash_estimate"] = ((b_local // micro) * shape.seq_len
                                      * cfg.d_model * 2 * cfg.n_layers)
            if trace:
                pc = compute_copy(dict(model.named_parameters()), dt)
                batch = _meta_batch(cfg, "train", rows, shape.seq_len)
                out, saved = _saved_bytes(
                    lambda: loss_and_grads(model, pc, batch))
                mem["activation_stash"] = saved // n_dp
        else:
            pfn = compute_param_specs if serve_tp_only else param_pspec_tree
            mem["params"] = _per_device(shapes, pfn(shapes), dt, mesh)
            if trace:
                model.to(dt)
                with torch.no_grad():
                    if shape.kind == "prefill":
                        out = model.prefill(_meta_batch(
                            cfg, "prefill", shape.global_batch,
                            shape.seq_len), cache_len=shape.seq_len)
                    else:
                        cache = model.init_cache(shape.global_batch,
                                                 shape.seq_len)
                        tok = _meta_batch(cfg, "decode", shape.global_batch,
                                          1)["tokens"]
                        out = model.decode_step(tok, cache,
                                                shape.seq_len - 1)
                cache = out[1]
                mem["caches"] = _tree_bytes(
                    cache, cache_pspec_tree(cfg, mesh, cache), mesh)
        mem["total"] = sum(mem.values())
        info["per_device_bytes"] = mem
    info["cost"] = NOT_APPLICABLE
    info["collectives"] = NOT_APPLICABLE
    return out, info


def run_cell(arch: str, shape_name: str, mesh, *, verbose=True,
             **kw) -> dict:
    """`lower_cell` timed and printed; returns its info."""
    t0 = time.perf_counter()
    _, info = lower_cell(arch, shape_name, mesh, **kw)
    info["lower_s"] = round(time.perf_counter() - t0, 2)
    if verbose:
        mem = info["per_device_bytes"]
        print(f"[dryrun] {info['arch']} x {info['shape']} x "
              f"{tuple(mesh.shape.values())} {info['sharding_mode']} "
              f"meta run {info['lower_s']} s, per device "
              f"{mem['total'] / 2**30:.2f} GiB "
              f"({', '.join(f'{k} {v / 2**30:.2f}' for k, v in mem.items() if k != 'total')})",
              flush=True)
    return info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="reports/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi", make_production_mesh(multi_pod=True)))
    cells = [(cfg.name, shp.name) for cfg, shp in all_cells()
             if (not args.arch or cfg.name == args.arch)
             and (not args.shape or shp.name == args.shape)]
    failures = []
    for mesh_name, mesh in meshes:
        for arch, shp in cells:
            out_path = os.path.join(args.out,
                                    f"{arch}__{shp}__{mesh_name}.json")
            if os.path.exists(out_path):
                print(f"[dryrun] skip existing {out_path}", flush=True)
                continue
            try:
                info = run_cell(arch, shp, mesh)
                info["status"] = "ok"
            except Exception as e:  # noqa: BLE001 — record every cell
                info = {"arch": arch, "shape": shp, "mesh": mesh_name,
                        "status": "fail", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                        "cost": NOT_APPLICABLE, "collectives": NOT_APPLICABLE}
                failures.append((arch, shp, mesh_name, str(e)))
                print(f"[dryrun] FAIL {arch} x {shp} x {mesh_name}: {e}",
                      flush=True)
            with open(out_path, "w") as f:
                json.dump(info, f, indent=1)
    print(f"\n[dryrun] done; {len(failures)} failures")
    for f_ in failures:
        print("  FAIL:", f_)


if __name__ == "__main__":
    main()
