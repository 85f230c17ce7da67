"""Plain PyTorch oracles for the model kernels (allclose targets in tests):
the sequential definitions each kernel is held against."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh). fp32 softmax, GQA."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, dh).float()
    s = torch.einsum("bsngd,btnd->bngst", qg, k.float())
    s = s / math.sqrt(dh)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngst,btnd->bsngd", p, v.float())
    return o.reshape(b, sq, h, dh).to(q.dtype)


def ssd_scan_ref(q, k, v, log_a, beta):
    """Sequential linear recurrence oracle.

    q, k: (BH, S, dk); v: (BH, S, dv); log_a, beta: (BH, S).
    S_t = exp(log_a_t) S_{t-1} + beta_t k_t v_t^T;  y_t = q_t @ S_t.
    Returns y (BH, S, dv) and final state (BH, dk, dv), float32.
    """
    bh, s, dk = k.shape
    dv, vdt = v.shape[-1], v.dtype
    q, k, v = q.float(), k.float(), v.float()
    la, bt = log_a.float(), beta.float()
    S = torch.zeros((bh, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        S = (torch.exp(la[:, t])[:, None, None] * S
             + bt[:, t, None, None] * (k[:, t, :, None] * v[:, t, None, :]))
        ys.append(torch.einsum("bk,bkv->bv", q[:, t], S))
    y = torch.stack(ys, dim=1) if ys else v[:, :0]
    return y.to(vdt), S


def rmsnorm_ref(x, w, eps=1e-5):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)
