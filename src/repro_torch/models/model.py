"""The model API of the port, for the dense and hybrid (zamba2) families.

`Model(cfg, device=...)` is an `nn.Module` whose parameters are allocated on
the device (uninitialised); `init(generator)` fills them with the
reference's initial distributions from a `torch.Generator`, and
`repro_torch.convert.model_params_from_reference` fills them with the JAX
package's own parameters instead. Then:

    forward(batch) -> logits (fp32), (B, S, V)
    init_cache(batch_size, cache_len) -> cache
    prefill(batch, cache_len) -> (last_logits, cache)
    decode_step(tokens, cache, pos) -> (logits, cache)

The reference stacks each family's layers along a leading axis and scans
over them; here they are an `nn.ModuleList` applied in a Python loop in the
same order. The hybrid family is `n_layers` Mamba2 blocks with ONE shared
attention + MLP block applied after every `attn_every` of them (13 times in
zamba2-7b: 81 = 13 x 6 + a tail of 3). Caches are plain dicts and lists:
{"mamba": [per Mamba block], "attn": [per attention application]}.
Loss, training and the MoE / ssm / audio / vlm families are not ported yet.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_FAMILIES = ("dense", "hybrid")


class DenseBlock(nn.Module):
    """Pre-norm attention + MLP (the dense stack, and zamba2's shared
    block)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L._param((cfg.d_model,), cfg, device, 0.0)
        self.ln2 = L._param((cfg.d_model,), cfg, device, 0.0)
        self.attn = L.Attention(cfg, device)
        self.mlp = L.MLP(cfg, device)

    def init(self, cfg, generator):
        self.attn.init(cfg, generator)
        self.mlp.init(cfg, generator)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = L._param((cfg.d_model,), cfg, device, 0.0)
        self.mamba = L.Mamba(cfg, device)

    def init(self, cfg, generator):
        self.mamba.init(cfg, generator)


def _apply_dense_block(p: DenseBlock, x, cfg, *, positions, mode, cache,
                       want_cache, window=0):
    a, c = L.apply_attention(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps), cfg,
                             positions=positions, mode=mode, cache=cache,
                             want_cache=want_cache, window=window)
    x = x + a
    x = x + L.apply_mlp(p.mlp, L.rmsnorm(x, p.ln2, cfg.norm_eps), cfg)
    return x, c


def _apply_mamba_block(p: MambaBlock, x, cfg, *, mode, cache, want_cache):
    y, c = L.apply_mamba(p.mamba, L.rmsnorm(x, p.ln, cfg.norm_eps), cfg,
                         mode=mode, cache=cache, want_cache=want_cache)
    return x + y, c


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family not in _FAMILIES:
            raise NotImplementedError(f"the {cfg.family!r} family "
                                      f"({cfg.name}) is not yet ported")
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = L._param((V, d), cfg, dev)
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = L._param((d, V), cfg, dev)
        self.ln_f = L._param((d,), cfg, dev, 0.0)
        if cfg.family == "dense":
            self.layers = nn.ModuleList(DenseBlock(cfg, dev)
                                        for _ in range(cfg.n_layers))
        else:
            self.mamba = nn.ModuleList(MambaBlock(cfg, dev)
                                       for _ in range(cfg.n_layers))
            self.shared = DenseBlock(cfg, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---------------- init ----------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter from `generator` with the reference's
        initial distributions (embeddings N(0, 0.02^2), dense weights
        N(0, 1/fan_in), norms 0, Mamba2's A_log / Dskip / dt_bias fixed)."""
        cfg = self.cfg
        L.normal_(self.embed, generator, 0.02)
        if self.lm_head is not None:
            L.normal_(self.lm_head, generator, 0.02)
        blocks = (self.layers if cfg.family == "dense"
                  else [*self.mamba, self.shared])
        for blk in blocks:
            blk.init(cfg, generator)
        return self

    # ---------------- embedding / head ----------------
    def _embed(self, tokens):
        return self.embed[tokens].to(L._dtype(self.cfg))

    def _head(self, x):
        cfg = self.cfg
        dt = L._dtype(cfg)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        w = self.embed.T if self.lm_head is None else self.lm_head
        return (x @ w.to(dt)).float()

    # ---------------- stack application ----------------
    def _run_stack(self, x, *, positions, mode, caches, want_cache):
        cfg = self.cfg
        keep = want_cache or mode == "decode"
        if cfg.family == "dense":
            new = []
            for i, blk in enumerate(self.layers):
                x, c = _apply_dense_block(
                    blk, x, cfg, positions=positions, mode=mode,
                    cache=caches["attn"][i] if caches else None,
                    want_cache=want_cache)
                new.append(c)
            return x, ({"attn": new} if keep else None)
        g = cfg.n_layers // cfg.attn_every
        mam, att = [], []
        for i, blk in enumerate(self.mamba):
            x, c = _apply_mamba_block(
                blk, x, cfg, mode=mode,
                cache=caches["mamba"][i] if caches else None,
                want_cache=want_cache)
            mam.append(c)
            gi, last = divmod(i + 1, cfg.attn_every)
            if last == 0 and gi <= g:       # after each full group of blocks
                x, c = _apply_dense_block(
                    self.shared, x, cfg, positions=positions, mode=mode,
                    cache=caches["attn"][gi - 1] if caches else None,
                    want_cache=want_cache, window=cfg.sliding_window)
                att.append(c)
        return x, ({"mamba": mam, "attn": att} if keep else None)

    # ---------------- public API ----------------
    def forward(self, batch: dict):
        """batch: {"tokens": (B, S) int}. Returns fp32 logits (B, S, V)."""
        x = self._embed(batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._run_stack(x, positions=positions, mode="full",
                               caches=None, want_cache=False)
        return self._head(x)

    def init_cache(self, batch: int, cache_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        if cfg.family == "dense":
            return {"attn": [L.attention_cache_spec(cfg, batch, cache_len, 0,
                                                    dev)
                             for _ in range(cfg.n_layers)]}
        g = cfg.n_layers // cfg.attn_every
        return {"mamba": [L.mamba_cache_spec(cfg, batch, dev)
                          for _ in range(cfg.n_layers)],
                "attn": [L.attention_cache_spec(cfg, batch, cache_len,
                                                cfg.sliding_window, dev)
                         for _ in range(g)]}

    @torch.no_grad()
    def prefill(self, batch: dict, cache_len: int | None = None):
        """Full-sequence pass building the cache; the head is applied ONLY to
        the final position. `cache_len` pads attention caches with empty
        slots (kpos = -1) so subsequent decode steps have room to append."""
        x = self._embed(batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        x, caches = self._run_stack(x, positions=positions, mode="full",
                                    caches=None, want_cache=True)
        logits = self._head(x[:, -1:])
        if cache_len is not None:
            caches = _pad_attention_caches(caches, cache_len,
                                           self.cfg.sliding_window)
        return logits, caches

    @torch.no_grad()
    def decode_step(self, tokens, cache, pos: int):
        """tokens: (B, 1); pos: number of tokens already processed. Returns
        (logits_for_new_token, cache); the cache is updated in place."""
        x = self._embed(tokens)
        x, cache = self._run_stack(x, positions=pos, mode="decode",
                                   caches=cache, want_cache=False)
        return self._head(x), cache


def _pad_attention_caches(caches, cache_len: int, window: int):
    """Pad every attention cache's sequence axis to its target ring size:
    min(window, cache_len) for windowed attention, else cache_len. Empty
    slots carry kpos = -1 (masked out by decode_attention)."""
    target = min(window, cache_len) if window else cache_len
    for c in caches["attn"]:
        cur = c["k"].shape[1]
        if cur < target:
            pad = (0, 0, 0, 0, 0, target - cur)
            c["k"] = torch.nn.functional.pad(c["k"], pad)
            c["v"] = torch.nn.functional.pad(c["v"], pad)
            c["kpos"] = torch.nn.functional.pad(c["kpos"], (0, target - cur),
                                                value=-1)
    return caches


def count_params(cfg: ModelConfig) -> int:
    """Parameter count, from a model built on the meta device."""
    m = Model(cfg, device="meta")
    return int(sum(math.prod(p.shape) for p in m.parameters()))
