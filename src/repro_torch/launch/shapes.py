"""Per-(arch x shape) runtime knobs (the reference's `launch/shapes.py`):
microbatch counts and the partition specs of batches and caches, all
recorded by the dry-run."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import dp_axes
from repro_torch.parallel.sharding import Spec, even_spec

# Activation stash budget per device for the recomputed layer stack (bytes).
_ACT_BUDGET = 4 << 30


def resolve_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh,
                         dp=None) -> int:
    """Smallest power-of-two microbatch count whose per-layer residual stash
    (B_local_micro x S x D x 2 bytes x n_layers) fits the activation budget."""
    if shape.kind != "train":
        return 1
    if shape.microbatches:
        return shape.microbatches
    n_dp = math.prod(mesh.shape[a] for a in (dp or dp_axes(mesh)))
    b_local = max(shape.global_batch // n_dp, 1)
    n = 1
    while n < b_local:
        stash = (b_local // n) * shape.seq_len * cfg.d_model * 2 * cfg.n_layers
        if stash <= _ACT_BUDGET:
            break
        n *= 2
    return n


def batch_pspec(cfg: ModelConfig, shape: ShapeConfig, mesh, dp=None) -> dict:
    """Specs of a cell's batch: the batch axis over dp."""
    dp = dp or dp_axes(mesh)
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            spec = {"tokens": Spec(dp, None, None)}
        else:
            spec = {"tokens": Spec(dp, None)}
        if shape.kind == "train":
            spec["targets"] = spec["tokens"]
        if cfg.family == "vlm":
            spec["patch_embeds"] = Spec(dp, None, None)
        return spec
    if cfg.family == "audio":
        return {"tokens": Spec(dp, None, None)}
    return {"tokens": Spec(dp, None)}


def _leaf_spec(cfg: ModelConfig, name: str, ndim: int, dp, tp_size: int):
    """A cache leaf's spec by its name and rank (leading dims replicated)."""
    tp = "model"

    def lead(n_extra):
        return (None,) * (ndim - n_extra)
    if name in ("k", "v"):                  # (..., B, Sc, KV, hd)
        if cfg.n_kv_heads % tp_size == 0:
            return Spec(*lead(4), dp, None, tp, None)
        return Spec(*lead(4), dp, tp, None, None)
    if name == "kpos":
        return Spec(*lead(1), None)
    if name == "idx":
        return Spec(*lead(0))
    if name == "state":                     # (..., B, Hs, ds, hd)
        hs_ok = cfg.n_ssm_heads % tp_size == 0
        return Spec(*lead(4), dp, tp if hs_ok else None, None, None)
    if name == "conv":                      # (..., B, W-1, ch)
        return Spec(*lead(3), dp, None, tp)
    if name == "C":                         # (..., B, H, dk, dv)
        return Spec(*lead(4), dp, None, tp, None)
    if name == "n":
        if ndim >= 4:                       # mlstm normaliser (..., B, H, dk, 1)
            return Spec(*lead(4), dp, None, tp, None)
        return Spec(*lead(2), dp, tp)
    if name == "c":                         # slstm (..., B, D)
        return Spec(*lead(2), dp, tp)
    return Spec(*((None,) * ndim))


def cache_pspec_tree(cfg: ModelConfig, mesh, cache):
    """Specs of the port's cache (`Model.init_cache`: dicts and lists of
    tensors, and an int `idx`), leaf by leaf, named by the dict key that
    holds the leaf. Attention KV: heads over 'model' when divisible, else
    the sequence axis. SSM states: heads / feature dims over 'model'. Batch
    over dp everywhere."""
    dp, tp_size = dp_axes(mesh), mesh.shape["model"]

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return _leaf_spec(cfg, name, len(getattr(node, "shape", ())), dp,
                          tp_size)
    return walk(cache, None)


def attach(mesh, shape_tree, spec_tree):
    """Meta tensors of `shape_tree`'s leaves' shapes and dtypes, each
    carrying its spec as `.spec` (axes that do not divide dropped, as
    `even_spec` drops them); leaves that are not tensors pass through."""
    if isinstance(shape_tree, dict):
        return {k: attach(mesh, v, spec_tree[k]) for k, v in
                shape_tree.items()}
    if isinstance(shape_tree, (list, tuple)):
        return [attach(mesh, v, s) for v, s in zip(shape_tree, spec_tree)]
    if not isinstance(shape_tree, torch.Tensor):
        return shape_tree
    t = torch.empty(shape_tree.shape, dtype=shape_tree.dtype, device="meta")
    t.spec = even_spec(spec_tree, t.shape, mesh)
    return t
