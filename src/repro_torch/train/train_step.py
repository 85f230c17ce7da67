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

The reference's ZeRO stages choose how the masters are sharded over a
mesh; on one card nothing is sharded, so only `zero_stage=2` (one compute
copy a step) is taken.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                         init_opt_state)


@dataclasses.dataclass
class TrainState:
    params: dict        # name -> float32 master (the model's parameters)
    opt: dict           # {"m", "v"[, "err"]: name -> float32, "step": int}
    step: int


def init_train_state(model, generator: torch.Generator,
                     opt_cfg: OptimizerConfig) -> TrainState:
    """Initialise the model's parameters from `generator` (`Model.init`)
    and zero optimizer state."""
    model.init(generator)
    params = dict(model.named_parameters())
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg),
                      step=0)


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


def make_train_step(model, opt_cfg: OptimizerConfig, microbatches: int = 1,
                    zero_stage: int = 2):
    """train_step(state, batch) -> (state, metrics {"loss", "grad_norm",
    "lr"}), updating `state` in place."""
    if zero_stage != 2:
        raise ValueError(f"zero_stage={zero_stage}: on one card only 2 (a "
                         f"compute copy cast once a step) has a meaning")
    dtype = L._dtype(model.cfg)

    def train_step(state: TrainState, batch: dict):
        params_c = compute_copy(state.params, dtype)
        g_sum, l_sum = None, 0.0
        for mb in split_micro(batch, microbatches):
            loss, _, grads = loss_and_grads(model, params_c, mb)
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
        opt_metrics = apply_updates(state.params, g_sum, state.opt, opt_cfg)
        del g_sum
        state.step += 1
        return state, {"loss": float(l_sum / microbatches), **opt_metrics}

    return train_step
