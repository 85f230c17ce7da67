"""Attention implementations (plain PyTorch).

Three tiers, as in the reference package:
  * `naive_attention`    — oracle, O(S^2) memory, tiny tests only.
  * `chunked_attention`  — online-softmax over KV chunks, bounded memory;
                           the CPU route of `kernels.ops.flash_attention`.
  * `repro_torch.kernels.flash_attention` — the hand-written CUDA kernel
                           (the route for CUDA tensors).

All support GQA (H grouped over KV heads, no materialized head repeat),
causality, and optional sliding windows. Layout: (B, S, heads, dh).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gqa_reshape(q, n_kv):
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Oracle. q: (B,Sq,H,dh); k,v: (B,Sk,KV,dh). Returns (B,Sq,H,dh)."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    qg = _gqa_reshape(q, kv).float()
    scores = torch.einsum("bsngd,btnd->bngst", qg, k.float())
    scores = scores / math.sqrt(dh)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnd->bsngd", p, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      chunk_q=1024, chunk_k=1024, return_lse=False):
    """Online-softmax attention, O(chunk_q * chunk_k) score memory.

    Outer loop over query chunks, inner loop over KV chunks with a running
    (max, sum, acc) carry — the flash-attention recurrence in plain torch.
    Every (q chunk, k chunk) pair is visited, as in the reference: a row
    whose first chunk is fully masked picks up exp(0) terms that the finite
    NEG_INF's correction exp(NEG_INF - m) = 0 wipes at its first real key.

    With `return_lse` also returns each row's log-sum-exp of its masked,
    scaled scores, m + log(l), as (B, H, Sq) float32: what the backward
    recomputes the softmax from (`kernels.flash_attention`).
    """
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    kv = k.shape[2]
    g = h // kv
    cq = min(chunk_q, sq)
    ck = min(chunk_k, sk)
    nq, nk = -(-sq // cq), -(-sk // ck)
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    outs, lses = [], []
    for i in range(nq):
        qc = qf[:, i * cq:(i + 1) * cq]
        rows = qc.shape[1]
        if rows < cq:                              # zero-padded tail rows
            qc = torch.nn.functional.pad(qc, (0, 0, 0, 0, 0, cq - rows))
        qc = qc.reshape(b, cq, kv, g, dh)
        qpos = torch.arange(i * cq, (i + 1) * cq, device=dev) + q_offset
        m = torch.full((b, cq, kv, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, cq, kv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, cq, kv, g, dh), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            kc = kf[:, j * ck:(j + 1) * ck]
            vc = vf[:, j * ck:(j + 1) * ck]
            if kc.shape[1] < ck:
                pad = (0, 0, 0, 0, 0, ck - kc.shape[1])
                kc = torch.nn.functional.pad(kc, pad)
                vc = torch.nn.functional.pad(vc, pad)
            kpos = torch.arange(j * ck, (j + 1) * ck, device=dev)
            mask = (kpos < sk)[None, :].expand(cq, ck)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.einsum("bcngd,btnd->bcngt", qc, kc) * scale
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bcngt,btnd->bcngd",
                                                       p, vc)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.reshape(b, cq, h, dh)[:, :rows])
        if return_lse:
            lse = m + torch.log(torch.clamp(l, min=1e-30))
            lses.append(lse.reshape(b, cq, h)[:, :rows].transpose(1, 2))
    out = torch.cat(outs, dim=1).to(q.dtype)
    if return_lse:
        return out, torch.cat(lses, dim=2)
    return out


def decode_attention(q, k_cache, v_cache, pos, *, window=0, kpos=None):
    """Single-step attention against a cache.

    q: (B, 1, H, dh); caches: (B, S, KV, dh); pos: current position (number
    of tokens already cached). `kpos` optionally supplies the absolute
    position of every cache slot (ring buffers); defaults to arange(S).
    """
    b, _, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, dh).float()
    scores = torch.einsum("bngd,btnd->bngt", qg, k_cache.float())
    scores = scores / math.sqrt(dh)
    if kpos is None:
        kpos = torch.arange(s, device=q.device)
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid &= kpos > pos - window
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngt,btnd->bngd", p, v_cache.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)
