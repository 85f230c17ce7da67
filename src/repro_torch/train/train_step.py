"""The train step: microbatched gradient accumulation + AdamW (the
reference's `train/train_step.py`).

`make_train_step(model, opt_cfg, microbatches)` returns
`train_step(state, batch) -> (state, metrics)`. The float32 masters are the
`Model`'s own parameters (`TrainState.params`, keyed by their module
names). Once a step a `cfg.dtype` compute copy of them is made (the
reference's default `zero_stage=2` cast), and each microbatch's loss and
gradients are taken at that copy through `torch.func.functional_call`,
which installs it in the model for the forward and the backward together
(the per-block recompute of the backward reads it too). The microbatches'
gradients are summed in float32 and divided by their count, and
`apply_updates` updates the masters and the optimizer state in place.

On a mesh of ranks (every family) the state is sharded as the
reference's launcher places it: each rank holds its pieces of the float32
masters and moments by `param_pspec_tree` (fsdp over "data", tp over
"model"; `TrainState.mesh` and the whole `shapes` say how). Once a step
the compute copy is cast and gathered over "data" into the TP-only pieces
of `compute_param_specs` (ZeRO-2), with the leaves whose pieces do not
follow the rank's heads regrouped into them (attention's `wqkv` and
`bqkv`, mLSTM's, sLSTM's and Mamba2's, a replicated norm's rows or
columns picked) and the experts gathered whole
(`models.model.compute_views`); each data rank takes its rows of each
microbatch; the gradients are mapped back (the regrouped columns summed
over "model") and reduce-scattered over "data" into each master's piece
(`reduce_grads_to_masters`), every sum in a fixed rank order, and the
clipping norm counts each element once over the mesh. Not ported there:
`zero_stage=3` (the masters used directly, gathered a layer at a time;
nor off a mesh) and int8 gradient compression.
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.model import check_mesh, compute_views
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as S
from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                         init_opt_state)


@dataclasses.dataclass
class TrainState:
    params: dict        # name -> float32 master (the model's parameters)
    opt: dict           # {"m", "v"[, "err"]: name -> float32, "step": int}
    step: int
    mesh: S.Mesh | None = None  # on a mesh of ranks: params, m, v are pieces
    shapes: dict | None = None  # ... of tensors of these whole shapes


def init_train_state(model, generator: torch.Generator,
                     opt_cfg: OptimizerConfig, mesh=None) -> TrainState:
    """Initialise the model's parameters from `generator` (`Model.init`)
    and zero optimizer state. On a mesh of ranks (`mesh`, else the ambient
    one) the model may be on the meta device: each parameter is drawn
    whole on the generator's device, a block at a time, and this rank keeps
    its piece by `param_pspec_tree`, so the pieces are those of the
    one-device initial state from the same seed, bit for bit."""
    mesh = mesh or S.current_mesh()
    if not S.live(mesh):
        model.init(generator)
        params = dict(model.named_parameters())
        return TrainState(params=params,
                          opt=init_opt_state(params, opt_cfg), step=0)
    check_mesh(model.cfg, mesh)
    _no_compression_on_a_mesh(opt_cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    with S.use_mesh(mesh):
        specs = S.param_pspec_tree(shapes)
    pieces = {}

    def keep(name, whole):
        pieces[name] = S.local_slice(whole, specs[name], mesh).clone()
    model.init(generator, sink=keep)
    params = {n: pieces[n] for n in shapes}
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                      step=0, mesh=mesh, shapes=shapes)


def _no_compression_on_a_mesh(opt_cfg: OptimizerConfig) -> None:
    if opt_cfg.compress_grads:
        raise NotImplementedError("int8 gradient compression "
                                  "(compress_grads) on a mesh of ranks is "
                                  "not ported")


class _LossAndGrads(nn.Module):
    """`model.loss(batch)` and its gradients with respect to `leaves`, as
    one module call: under `torch.func.functional_call` the parameters it
    is given stay installed in the model until the backward is done."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch, leaves):
        total, metrics = self.model.loss(batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (total.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)


def loss_and_grads(model, params: dict, batch: dict):
    """`model.loss(batch)` at `params` (name -> tensor, every parameter of
    the model, each requiring grad) in place of the model's own. Returns
    (total, metrics, grads) with grads a dict keyed like `params` (zeros
    for a parameter the batch does not reach)."""
    names = list(params)
    call = _LossAndGrads(model)
    total, metrics, grads = torch.func.functional_call(
        call, {f"model.{n}": params[n] for n in names},
        (batch, [params[n] for n in names]))
    return total, metrics, dict(zip(names, grads))


def compute_copy(params: dict, dtype: torch.dtype) -> dict:
    """The step's compute copy of the masters, requiring grad (the masters
    themselves when they are already of `dtype`, detached)."""
    return {n: p.detach().to(dtype).requires_grad_() for n, p in
            params.items()}


def split_micro(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n microbatches of B / n rows, in order."""
    out = [{} for _ in range(n)]
    for key, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} not divisible by {n} "
                             f"microbatches")
        for i in range(n):
            out[i][key] = x[i * (b // n):(i + 1) * (b // n)]
    return out


def sharded_compute_copy(state: TrainState, dtype: torch.dtype,
                         views: dict) -> dict:
    """This rank's compute copy on the state's mesh, requiring grad: the
    TP-only pieces (`cast_and_reshard_compute_params`), then the `views`
    (`compute_views`): columns along a dimension gathered over "model"
    where split there and picked, or a piece gathered whole."""
    mesh, shapes = state.mesh, state.shapes
    out = S.cast_and_reshard_compute_params(state.params, shapes, dtype,
                                            mesh)
    for n, (kind, dim, idx) in views.items():
        x = out[n]
        if x.shape[dim] != shapes[n][dim]:
            x = C.all_gather(x, mesh, "model", dim)
        if kind == "columns":
            x = x.index_select(dim, idx.to(x.device))
        out[n] = x
    return {n: x.requires_grad_() for n, x in out.items()}


def sharded_grads(grads: dict, state: TrainState, views: dict) -> dict:
    """The gradients of this rank's compute copy (float32, its data shard's
    share) as gradients of its master pieces: each view undone (regrouped
    columns put back and summed over "model"; a whole leaf's piece taken,
    the model ranks having computed the same), then summed over "data"
    (`reduce_grads_to_masters`)."""
    mesh, shapes = state.mesh, state.shapes
    with S.use_mesh(mesh):
        cspecs = S.compute_param_specs(shapes)
    for n, (kind, dim, idx) in views.items():
        g = grads[n]
        if kind == "columns":
            size = list(g.shape)
            size[dim] = shapes[n][dim]
            full = g.new_zeros(size)
            full.index_copy_(dim, idx.to(g.device), g)
            g = (C.reduce_scatter(full, mesh, "model", dim)
                 if cspecs[n][dim] is not None
                 else C.all_reduce(full, mesh, "model"))
        elif cspecs[n][dim] is not None:
            g = S.local_slice(g, S.Spec(*([None] * dim + ["model"])), mesh)
        grads[n] = g
    return S.reduce_grads_to_masters(grads, shapes, mesh)


def grad_sq_over_mesh(state: TrainState):
    """reduce_sq for `apply_updates` on the state's mesh: each leaf's sum
    of squares counted on one rank of the ranks that hold the same piece
    (its coordinate 0 on every mesh axis its spec leaves replicated), then
    summed over the mesh in the ranks' order."""
    mesh = state.mesh
    with S.use_mesh(mesh):
        specs = S.param_pspec_tree(state.shapes)
    mine = {n for n, sp in specs.items()
            if all(mesh.coords[a] == 0 for a in mesh.axis_names
                   if a not in S.spec_axes(sp))}

    def reduce_sq(sq: dict):
        total = None
        for n, v in sq.items():
            v = v if n in mine else torch.zeros_like(v)
            total = v if total is None else total + v
        return C.all_reduce(total, mesh, None)
    return reduce_sq


def make_train_step(model, opt_cfg: OptimizerConfig, microbatches: int = 1,
                    zero_stage: int = 2, grad_hook=None):
    """train_step(state, batch) -> (state, metrics {"loss", "ce", "aux",
    "grad_norm", "lr"}), updating `state` in place: "ce" and "aux" are the
    loss's cross-entropy and MoE load-balancing parts (0 outside the moe
    family), each a mean over the microbatches as "loss" is. On a state of
    a mesh of ranks, `batch` is the global batch (each data rank takes its
    rows of each microbatch). `grad_hook`, if given, is called with the
    gradients of the masters (this rank's pieces) before the update."""
    if zero_stage != 2:
        raise ValueError(
            f"zero_stage={zero_stage} is not ported, on a mesh of ranks or "
            f"off one: only 2 (a compute copy cast and gathered once a "
            f"step)")
    dtype = L._dtype(model.cfg)

    def train_step(state: TrainState, batch: dict):
        mesh = state.mesh if S.live(state.mesh) else None
        with S.use_mesh(mesh) if mesh is not None else nullcontext():
            return _step(state, batch, mesh)

    def _step(state, batch, mesh):
        views = {}
        if mesh is not None:
            check_mesh(model.cfg, mesh)
            _no_compression_on_a_mesh(opt_cfg)
            views = compute_views(model.cfg, state.shapes, mesh)
            params_c = sharded_compute_copy(state, dtype, views)
        else:
            params_c = compute_copy(state.params, dtype)
        g_sum, l_sum, parts = None, 0.0, {"ce": 0.0, "aux": 0.0}
        for mb in split_micro(batch, microbatches):
            if mesh is not None:        # this data rank's rows
                mb = {k: S.constrain(x, "dp", *[None] * (x.dim() - 1),
                                     src=(None,) * x.dim())
                      for k, x in mb.items()}
            loss, m, grads = loss_and_grads(model, params_c, mb)
            for k in parts:
                parts[k] = parts[k] + m[k]
            if g_sum is None:
                g_sum = {n: g.float() for n, g in grads.items()}
            else:
                for n, g in grads.items():
                    g_sum[n].add_(g)
            del grads
            l_sum = l_sum + loss
        del params_c
        if microbatches > 1:
            for g in g_sum.values():
                g.div_(microbatches)
        reduce_sq = None
        if mesh is not None:
            g_sum = sharded_grads(g_sum, state, views)
            reduce_sq = grad_sq_over_mesh(state)
        if grad_hook is not None:
            grad_hook(g_sum)
        opt_metrics = apply_updates(state.params, g_sum, state.opt, opt_cfg,
                                    reduce_sq=reduce_sq)
        del g_sum
        state.step += 1
        return state, {"loss": float(l_sum / microbatches),
                       **{k: float(v / microbatches)
                          for k, v in parts.items()}, **opt_metrics}

    return train_step

