"""Layer library: the blocks the dense, hybrid (zamba2) and ssm (xLSTM)
families use.

Conventions, as in the reference package:
  * every block is an `nn.Module` holding its parameters (param_dtype,
    default float32) in the reference's orientation — (d_in, d_out), used
    as `x @ W` — so weights cross from the JAX package unchanged
    (`repro_torch.convert`); compute casts to cfg.dtype (default bf16) at
    use. The math is plain functions on tensors (`apply_*`).
  * every `apply_*` works in two modes:
      mode="full"   — whole sequence (prefill); returns fresh cache pieces
                      when `want_cache`.
      mode="decode" — one token against a cache. Unlike the reference,
                      which returns new cache arrays, decode updates the
                      cache tensors in place (no copy of the KV ring per
                      step) and returns the same dict.
  * the reference's sharding annotations (`parallel.sharding.constrain`)
    have no counterpart: on one card they are no-ops.
  * MoE blocks are not ported yet (`models.model.Model` raises for their
    family).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import decode_attention
from repro_torch.models.linear_scan import linear_scan_step

f32 = torch.float32


# ---------------------------------------------------------------- utilities

def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _param(shape, cfg, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=_pdtype(cfg), device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


@torch.no_grad()
def normal_(p: torch.Tensor, generator: torch.Generator, scale: float):
    """Fill p with N(0, 1) * scale drawn in float32 from `generator` (on the
    generator's device), as the reference's `dense_init` draws."""
    z = torch.randn(p.shape, generator=generator, dtype=f32,
                    device=generator.device)
    p.copy_(z.mul_(scale))


@torch.no_grad()
def dense_init(p: torch.Tensor, generator: torch.Generator, scale=None):
    fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
    normal_(p, generator, scale if scale is not None
            else 1.0 / math.sqrt(fan_in))


def rmsnorm(x, w, eps):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope(x, positions, theta):
    """x: (..., S, H, dh) with positions (S,), or one step with positions
    (1,). Standard half-split rotation."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=f32, device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].to(f32) * freqs                  # (S, half)
    cos = torch.cos(ang)[..., None, :]                           # heads axis
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim)
        self.wqkv = _param((d, (h + 2 * kv) * hd), cfg, device)
        self.wo = _param((h * hd, d), cfg, device)
        if cfg.qkv_bias:
            self.bqkv = _param(((h + 2 * kv) * hd,), cfg, device, 0.0)
        else:
            self.register_parameter("bqkv", None)

    def init(self, cfg: ModelConfig, generator: torch.Generator):
        h, hd = cfg.n_heads, cfg.resolved_head_dim
        dense_init(self.wqkv, generator)
        dense_init(self.wo, generator, 1.0 / math.sqrt(h * hd))
        if self.bqkv is not None:
            self.bqkv.zero_()


def init_attention(cfg: ModelConfig, generator, device=None) -> Attention:
    p = Attention(cfg, device)
    p.init(cfg, generator)
    return p


def apply_attention(p: Attention, x, cfg: ModelConfig, *, positions,
                    mode="full", cache=None, want_cache=False, window=0):
    """x: (B, S, D). positions: (S,) absolute (full) or int pos (decode).

    cache (decode or prefill-output): {"k","v": (B, Sc, KV, hd),
    "kpos": (Sc,) int32, "idx": write count}.
    """
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = _dtype(cfg)
    qkv = x @ p.wqkv.to(dt)
    if p.bqkv is not None:
        qkv = qkv + p.bqkv.to(dt)
    q, k, v = torch.split(qkv, [h * hd, kv * hd, kv * hd], dim=-1)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)

    if mode == "decode":
        pos = int(positions)          # number of tokens already in cache
        pt = torch.full((1,), pos, device=x.device)     # no host copy
        q = rope(q, pt, cfg.rope_theta)
        k = rope(k, pt, cfg.rope_theta)
        # Write into the slot holding the oldest (or empty, kpos=-1)
        # position; correctness only depends on kpos, not slot order, so
        # this covers both append-style full caches and sliding-window ring
        # buffers. The index stays on the device (no host sync).
        widx = torch.argmin(cache["kpos"]).reshape(1)
        cache["k"].index_copy_(1, widx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, widx, v.to(cache["v"].dtype))
        cache["kpos"].index_fill_(0, widx, pos)
        out = decode_attention(q, cache["k"], cache["v"], pos, window=window,
                               kpos=cache["kpos"])
        cache["idx"] += 1
        new_cache = cache
    else:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  block_q=cfg.attn_chunk_q,
                                  block_k=cfg.attn_chunk_k)
        new_cache = None
        if want_cache:
            sc = min(window, s) if window else s
            new_cache = {
                "k": k[:, -sc:].to(dt, copy=True),
                "v": v[:, -sc:].to(dt, copy=True),
                "kpos": positions[-sc:].to(torch.int32),
                "idx": s,
            }
    y = out.reshape(b, s, h * hd) @ p.wo.to(dt)
    return y, new_cache


def attention_cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
                         window: int, device=None):
    sc = min(window, seq_len) if window else seq_len
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = _dtype(cfg)
    return {
        "k": torch.zeros((batch, sc, kv, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, sc, kv, hd), dtype=dt, device=device),
        "kpos": torch.full((sc,), -1, dtype=torch.int32, device=device),
        "idx": 0,
    }


# ---------------------------------------------------------------- MLP

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wu = _param((d, f), cfg, device)
        self.wd = _param((f, d), cfg, device)
        if cfg.mlp_style == "swiglu":
            self.wg = _param((d, f), cfg, device)
        else:
            self.register_parameter("wg", None)

    def init(self, cfg: ModelConfig, generator: torch.Generator):
        if self.wg is not None:
            dense_init(self.wg, generator)
        dense_init(self.wu, generator)
        dense_init(self.wd, generator, 1.0 / math.sqrt(cfg.d_ff))


def init_mlp(cfg: ModelConfig, generator, device=None) -> MLP:
    p = MLP(cfg, device)
    p.init(cfg, generator)
    return p


def apply_mlp(p: MLP, x, cfg: ModelConfig):
    dt = _dtype(cfg)
    u = x @ p.wu.to(dt)
    if p.wg is not None:                            # SwiGLU (3 matrices)
        h = F.silu(x @ p.wg.to(dt)) * u
    else:                                           # GeLU (2 matrices)
        h = F.gelu(u, approximate="tanh")           # jax.nn.gelu's default
    return h @ p.wd.to(dt)


# ---------------------------------------------------------------- Mamba2

class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, din, ds, hs = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.n_ssm_heads)
        conv_ch = din + 2 * ds
        self.in_proj = _param((d, 2 * din + 2 * ds + hs), cfg, device)
        self.conv_w = _param((cfg.ssm_conv_width, conv_ch), cfg, device)
        self.conv_b = _param((conv_ch,), cfg, device, 0.0)
        self.A_log = _param((hs,), cfg, device)
        self.Dskip = _param((hs,), cfg, device, 1.0)
        self.dt_bias = _param((hs,), cfg, device, -2.0)
        self.out_proj = _param((din, d), cfg, device)
        self.norm_g = _param((din,), cfg, device, 0.0)
        with torch.no_grad():
            self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, hs)))

    def init(self, cfg: ModelConfig, generator: torch.Generator):
        dense_init(self.in_proj, generator)
        dense_init(self.conv_w, generator, 0.5)
        dense_init(self.out_proj, generator, 1.0 / math.sqrt(cfg.d_inner))


def init_mamba(cfg: ModelConfig, generator, device=None) -> Mamba:
    p = Mamba(cfg, device)
    p.init(cfg, generator)
    return p


def _causal_conv_full(u, w, b):
    """u: (B, S, C); depthwise causal conv width W. Returns (B, S, C)."""
    W = w.shape[0]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + u.shape[1]] * w[i][None, None, :]
              for i in range(W))
    return out + b[None, None, :]


def apply_mamba(p: Mamba, x, cfg: ModelConfig, *, mode="full", cache=None,
                want_cache=False):
    """Mamba2 (SSD) block. cache: {"state": (B,Hs,ds,hd) f32,
    "conv": (B, W-1, conv_ch)}."""
    b, s, d = x.shape
    din, ds, hs, hd = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                       cfg.ssm_head_dim)
    W = cfg.ssm_conv_width
    dt = _dtype(cfg)
    proj = x @ p.in_proj.to(dt)
    z, xs, Bc, Cc, dts = torch.split(proj, [din, din, ds, ds, hs], dim=-1)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)                  # (B,S,conv_ch)

    if mode == "decode":
        hist = torch.cat([cache["conv"].to(dt), conv_in], dim=1)
        cw = p.conv_w.to(dt)
        conv_out = (sum(hist[:, i:i + 1] * cw[i][None, None]
                        for i in range(W)) + p.conv_b.to(dt)[None, None])
        new_conv = hist[:, 1:]
    else:
        conv_out = _causal_conv_full(conv_in, p.conv_w.to(dt),
                                     p.conv_b.to(dt))
        new_conv = None
        if want_cache:
            padded = F.pad(conv_in, (0, 0, max(W - 1 - s, 0), 0))
            new_conv = padded[:, -(W - 1):].clone()
    conv_out = F.silu(conv_out)
    xs, Bc, Cc = torch.split(conv_out, [din, ds, ds], dim=-1)

    xh = xs.reshape(b, s, hs, hd)                               # v
    Bh = Bc[:, :, None, :].expand(b, s, hs, ds)                 # k, no copy
    Ch = Cc[:, :, None, :].expand(b, s, hs, ds)                 # q
    dtv = F.softplus(dts.float() + p.dt_bias.float())           # (B,S,Hs)
    A = -torch.exp(p.A_log.float())                             # (Hs,) < 0
    log_a = dtv * A[None, None, :]                              # <= 0

    if mode == "decode":
        y, state = linear_scan_step(Ch[:, 0], Bh[:, 0], xh[:, 0],
                                    log_a[:, 0], dtv[:, 0], cache["state"])
        y = y[:, None]                                          # (B,1,Hs,hd)
        cache["state"], cache["conv"] = state, new_conv
        new_cache = cache
    else:
        y, state = ops.ssd_scan(Ch, Bh, xh, log_a, dtv, chunk=cfg.ssm_chunk)
        new_cache = ({"state": state, "conv": new_conv} if want_cache
                     else None)

    y = y + p.Dskip.to(dt)[None, None, :, None] * xh
    y = y.reshape(b, s, din)
    y = rmsnorm(y * F.silu(z), p.norm_g, cfg.norm_eps)
    return y @ p.out_proj.to(dt), new_cache


def mamba_cache_spec(cfg: ModelConfig, batch: int, device=None):
    return {
        "state": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=f32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             cfg.d_inner + 2 * cfg.ssm_state),
                            dtype=_dtype(cfg), device=device),
    }


# ---------------------------------------------------------------- xLSTM

class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
        self.wqkv = _param((d, 3 * h * hd), cfg, device)
        self.wif = _param((d, 2 * h), cfg, device)
        self.w_ogate = _param((d, h * hd), cfg, device)
        self.wo = _param((h * hd, d), cfg, device)
        self.ln_inner = _param((h, hd), cfg, device, 0.0)

    def init(self, cfg: ModelConfig, generator: torch.Generator):
        h, hd = cfg.n_heads, cfg.resolved_head_dim
        dense_init(self.wqkv, generator)
        dense_init(self.wif, generator, 0.02)
        dense_init(self.w_ogate, generator, 0.02)
        dense_init(self.wo, generator, 1.0 / math.sqrt(h * hd))


def init_mlstm(cfg: ModelConfig, generator, device=None) -> MLSTM:
    p = MLSTM(cfg, device)
    p.init(cfg, generator)
    return p


def apply_mlstm(p: MLSTM, x, cfg: ModelConfig, *, mode="full", cache=None,
                want_cache=False):
    """mLSTM: matrix-memory linear attention with sigmoid forget / input
    gates. cache: {"C": (B,H,hd,hd) f32, "n": (B,H,hd,1) f32}. The memory
    and its normaliser are two SSD scans (a 512 x 512 and a 512 x 1 state
    per head at xlstm-1.3b's width), one `ops.mlstm_scan` call over the
    full sequence."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    dt = _dtype(cfg)
    qkv = x @ p.wqkv.to(dt)
    q, k, v = (t.reshape(b, s, h, hd)
               for t in torch.split(qkv, h * hd, dim=-1))
    q = q / math.sqrt(hd)
    gates = (x @ p.wif.to(dt)).float()
    ig, fg = torch.split(gates, h, dim=-1)                      # (B,S,H)
    log_f = F.logsigmoid(fg)
    i_in = torch.sigmoid(ig)

    if mode == "decode":
        ones = torch.ones((b, h, 1), dtype=dt, device=x.device)
        y, C = linear_scan_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
                                i_in[:, 0], cache["C"])
        _, n = linear_scan_step(q[:, 0], k[:, 0], ones, log_f[:, 0],
                                i_in[:, 0], cache["n"])
        nm = torch.einsum("bhk,bhkv->bhv", q[:, 0].float(), n)
        y = (y / torch.clamp(nm.abs(), min=1.0)).to(dt)[:, None]
        cache["C"], cache["n"] = C, n
        new_cache = cache
    else:
        y, C, nm, n = ops.mlstm_scan(q, k, v, log_f, i_in,
                                     chunk=cfg.ssm_chunk)
        y = (y / torch.clamp(nm.float().abs(), min=1.0)).to(dt)
        new_cache = {"C": C, "n": n} if want_cache else None

    y = rmsnorm(y, p.ln_inner, cfg.norm_eps)
    og = torch.sigmoid(x @ p.w_ogate.to(dt)).reshape(b, s, h, hd)
    y = (y * og).reshape(b, s, h * hd)
    return y @ p.wo.to(dt), new_cache


def mlstm_cache_spec(cfg: ModelConfig, batch: int, device=None):
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    return {"C": torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, h, hd, 1), dtype=f32, device=device)}


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.w_gates = _param((d, 4 * d), cfg, device)

    def init(self, cfg: ModelConfig, generator: torch.Generator):
        dense_init(self.w_gates, generator, 0.02)


def init_slstm(cfg: ModelConfig, generator, device=None) -> SLSTM:
    p = SLSTM(cfg, device)
    p.init(cfg, generator)
    return p


def gated_cumsum(f, x):
    """c_t = f_t c_{t-1} + x_t along axis 1 from c_{-1} = 0, for (B, S, D)
    float32 f and x: the reference's associative scan with the combine
    (f_a, x_a), (f_b, x_b) -> (f_a f_b, x_b + f_b x_a), in its doubling
    form (ceil(log2 S) steps, each one pass over the sequence)."""
    s, step = f.shape[1], 1
    while step < s:
        x = torch.cat([x[:, :step], x[:, step:] + f[:, step:] * x[:, :-step]],
                      dim=1)
        if 2 * step < s:
            f = torch.cat([f[:, :step], f[:, step:] * f[:, :-step]], dim=1)
        step *= 2
    return x


def apply_slstm(p: SLSTM, x, cfg: ModelConfig, *, mode="full", cache=None,
                want_cache=False):
    """sLSTM with per-channel scalar memory and no recurrent hidden-to-gate
    weights (the reference's adaptation), so c and n are linear recurrences
    (`gated_cumsum`). cache: {"c", "n": (B, D) f32}."""
    b, s, d = x.shape
    dt = _dtype(cfg)
    pre = (x @ p.w_gates.to(dt)).float()
    ig, fg, zg, og = torch.split(pre, d, dim=-1)                # (B,S,D)
    i = torch.exp(torch.clamp(ig, -8.0, 8.0))
    f = torch.sigmoid(fg)
    z = torch.tanh(zg)
    o = torch.sigmoid(og)

    if mode == "decode":
        c = f[:, 0] * cache["c"] + i[:, 0] * z[:, 0]
        n = f[:, 0] * cache["n"] + i[:, 0]
        hcur = (o[:, 0] * c / torch.clamp(n, min=1.0))[:, None]
        cache["c"], cache["n"] = c, n
        return hcur.to(dt), cache

    c = gated_cumsum(f, i * z)
    n = gated_cumsum(f, i)
    hseq = o * c / torch.clamp(n, min=1.0)
    new_cache = ({"c": c[:, -1].clone(), "n": n[:, -1].clone()}
                 if want_cache else None)
    return hseq.to(dt), new_cache


def slstm_cache_spec(cfg: ModelConfig, batch: int, device=None):
    return {"c": torch.zeros((batch, cfg.d_model), dtype=f32, device=device),
            "n": torch.zeros((batch, cfg.d_model), dtype=f32, device=device)}
