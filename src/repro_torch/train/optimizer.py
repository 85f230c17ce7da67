"""AdamW with a warmup + cosine schedule, global-norm clipping and optional
int8 gradient compression with error feedback (the reference's
`train/optimizer.py`).

The optimizer state mirrors the parameters: a dict of float32 first and
second moments `m` and `v` keyed like the parameters, the step count, and
with compression the error-feedback residual `err`. `apply_updates`
updates the parameters and the state in place, one leaf at a time, on the
leaves' own device: at qwen2.5-3b's width the largest leaf is 1.2 GB, so a
leaf's temporaries stay small beside the 37 GB of masters and moments.
The scalars (learning rate, bias corrections, clip scale) are computed in
float32 as the reference computes them. Parameters of one dimension
(norms, biases) take no weight decay.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.train.fault_tolerance import PartialUpdateError


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # int8 gradient compression with error feedback (OFF by default)
    compress_grads: bool = False


def lr_at(cfg: OptimizerConfig, step) -> float:
    """Linear warmup + cosine decay to min_lr_ratio * lr, in float32."""
    f = np.float32
    step = f(step)
    warm = np.minimum(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    t = np.clip((step - f(cfg.warmup_steps))
                / f(max(cfg.decay_steps - cfg.warmup_steps, 1)), f(0), f(1))
    cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * t))
    return float(f(cfg.lr) * warm * (f(cfg.min_lr_ratio)
                                     + f(1 - cfg.min_lr_ratio) * cos))


def init_opt_state(params: dict, cfg: OptimizerConfig) -> dict:
    """Zero float32 moments (and residual) for a dict of parameters."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    state = {"m": zeros(), "v": zeros(), "step": 0}
    if cfg.compress_grads:
        state["err"] = zeros()
    return state


def quantize_int8(x):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: OptimizerConfig) -> dict:
    """One AdamW step on `params` (a dict of float tensors, updated in
    place) with `grads` (same keys, any float dtype; read, not kept) and
    `state` (from `init_opt_state`, updated in place). Returns the metrics
    {"grad_norm", "lr"} as Python floats. A fault inside it is raised as
    `PartialUpdateError`: some leaves may be updated and others not."""
    try:
        return _apply_updates(params, grads, state, cfg)
    except Exception as e:
        raise PartialUpdateError(
            f"the optimizer update failed part way: {e!r}") from e


@torch.no_grad()
def _apply_updates(params, grads, state, cfg):
    step = state["step"] + 1
    gf = {}
    for n, g in grads.items():
        g = g.float()
        if cfg.compress_grads:
            # error feedback: transmit q(g + err), keep the residual
            e = state["err"][n]
            tot = g + e
            q, s = quantize_int8(tot)
            g = dequantize_int8(q, s)
            torch.sub(tot, g, out=e)
        gf[n] = g
    sq = torch.zeros((), dtype=torch.float32,
                     device=next(iter(gf.values())).device)
    for g in gf.values():
        sq = sq + torch.sum(torch.square(g))
    gnorm = float(torch.sqrt(sq))
    f = np.float32
    scale = (min(f(1.0), f(cfg.grad_clip) / max(f(gnorm), f(1e-12)))
             if cfg.grad_clip > 0 else 1.0)
    lr = lr_at(cfg, step)
    b1c = float(f(1.0) - f(cfg.b1) ** f(step))
    b2c = float(f(1.0) - f(cfg.b2) ** f(step))
    for n, p in params.items():
        g = gf.pop(n)
        if scale != 1.0:
            g = g * float(scale)
        _adamw_leaf(p, g, state["m"][n], state["v"][n], lr, b1c, b2c, cfg)
        del g
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}


def _adamw_leaf(p, g, m, v, lr: float, b1c: float, b2c: float,
                cfg: OptimizerConfig):
    """AdamW on one leaf, in place: its moments m and v, then p."""
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    decay = cfg.weight_decay if p.dim() >= 2 else 0.0
    pf = p.float()
    p.copy_(pf - lr * (delta + decay * pf))
