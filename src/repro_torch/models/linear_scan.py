"""Generic chunked linear-recurrence ("state space dual") primitive.

Per head, with state S in R^{dk x dv}:

    S_t = a_t * S_{t-1} + beta_t * k_t v_t^T          (a_t in (0, 1])
    y_t = q_t @ S_t                                    -> R^{dv}

Mamba2 maps (k=B_t, v=x_t, q=C_t, a=exp(dt*A), beta=dt). Three tiers:

  * `linear_scan_ref`     — sequential oracle.
  * `linear_scan_chunked` — chunked parallel form (intra-chunk attention-like
                            + inter-chunk state carry); the CPU route of
                            `kernels.ops.ssd_scan`.
  * `repro_torch.kernels.ssd_scan` — the hand-written CUDA kernel.

Numerical stability: all decay products live in log space; every exp argument
is a difference of cumulative logs ordered so that it is <= 0.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def linear_scan_ref(q, k, v, log_a, beta, s0=None):
    """Sequential oracle.

    q, k: (B, S, H, dk); v: (B, S, H, dv); log_a, beta: (B, S, H).
    Returns y: (B, S, H, dv), final state (B, H, dk, dv).
    """
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    S = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
         if s0 is None else s0)
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    la, bt = log_a.to(f32), beta.to(f32)
    ys = []
    for t in range(s):
        S = (torch.exp(la[:, t])[..., None, None] * S
             + bt[:, t, :, None, None] * kf[:, t, :, :, None]
             * vf[:, t, :, None, :])
        ys.append(torch.einsum("bhk,bhkv->bhv", qf[:, t], S))
    return torch.stack(ys, dim=1).to(v.dtype), S


def linear_scan_step(q, k, v, log_a, beta, state):
    """One decode step. q,k: (B,H,dk); v: (B,H,dv); log_a,beta: (B,H);
    state: (B,H,dk,dv). Returns (y (B,H,dv), new_state)."""
    S = (torch.exp(log_a.to(f32))[..., None, None] * state
         + beta.to(f32)[..., None, None]
         * k.to(f32)[..., :, None] * v.to(f32)[..., None, :])
    y = torch.einsum("bhk,bhkv->bhv", q.to(f32), S)
    return y.to(v.dtype), S


def linear_scan_chunked(q, k, v, log_a, beta, s0=None, chunk=256):
    """Chunked parallel form; exact same math as the sequential oracle."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    n = -(-s // c)
    S = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
         if s0 is None else s0)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    ys = []
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        qi, ki, vi = q[:, sl].to(f32), k[:, sl].to(f32), v[:, sl].to(f32)
        lai, bi = log_a[:, sl].to(f32), beta[:, sl].to(f32)
        pad = c - qi.shape[1]
        if pad:     # a = 1 (log 0) and beta = 0 on the pad: state unchanged
            zf = lambda x: torch.nn.functional.pad(
                x, (0, 0) * (x.ndim - 2) + (0, pad))
            qi, ki, vi, lai, bi = zf(qi), zf(ki), zf(vi), zf(lai), zf(bi)
        lci = torch.cumsum(lai, dim=1)                   # (B, c, H) inclusive
        lti = lci[:, -1]                                 # (B, H)
        # intra-chunk: D[t, u] = exp(lc[t] - lc[u]) for u <= t else 0.
        # Mask BEFORE exp: above-diagonal diffs are positive and overflow.
        diff = lci[:, :, None, :] - lci[:, None, :, :]    # (B, c, c, H)
        dmat = torch.exp(torch.where(tri[None, :, :, None], diff, -1e30))
        scores = torch.einsum("bthk,buhk->btuh", qi, ki) * dmat
        y_intra = torch.einsum("btuh,buh,buhv->bthv", scores, bi, vi)
        # inter-chunk: y_t += exp(lc[t]) * q_t @ S_prev
        y_inter = torch.exp(lci)[..., None] * torch.einsum(
            "bthk,bhkv->bthv", qi, S)
        # state update: S = exp(lt) S + sum_u exp(lt - lc[u]) b_u k_u v_u^T
        w = torch.exp(lti[:, None, :] - lci) * bi        # (B, c, H)
        S = (torch.exp(lti)[..., None, None] * S
             + torch.einsum("buh,buhk,buhv->bhkv", w, ki, vi))
        ys.append((y_intra + y_inter)[:, :c - pad])
    return torch.cat(ys, dim=1).to(v.dtype), S
