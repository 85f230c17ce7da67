"""The model API of the port, for all six families: dense, moe, audio,
vlm, hybrid (zamba2) and ssm (xLSTM).

`Model(cfg, device=...)` is an `nn.Module` whose parameters are allocated on
the device (uninitialised); `init(generator)` fills them with the
reference's initial distributions from a `torch.Generator`, and
`repro_torch.convert.model_params_from_reference` fills them with the JAX
package's own parameters instead. Then:

    forward(batch) -> logits (fp32), (B, S, V); audio (B, S, K, V)
    forward(batch, with_aux=True) -> (logits, aux)
    init_cache(batch_size, cache_len) -> cache
    prefill(batch, cache_len) -> (last_logits, cache)
    decode_step(tokens, cache, pos) -> (logits, cache)
    loss(batch) -> (total, {"ce", "aux"})

A batch is {"tokens": (B, S)}; audio's tokens are (B, K, S), one row per
codebook (embeddings summed over the codebooks, one head each), and vlm's
batch may carry "patch_embeds" (B, n_patches, d), projected by
`patch_proj` and put before the tokens. Decode takes tokens only ((B, 1),
audio (B, K, 1)). `aux` is the moe family's summed load-balancing loss
(float32; 0 for the others).

The reference stacks each family's layers along a leading axis and scans
over them; here they are an `nn.ModuleList` applied in a Python loop in the
same order. The dense, moe, audio and vlm families are `n_layers` blocks of
attention then an MLP (moe: routed experts). The hybrid family is
`n_layers` Mamba2 blocks with ONE shared attention + MLP block applied
after every `attn_every` of them (13 times in zamba2-7b: 81 = 13 x 6 + a
tail of 3). The ssm family is n_layers / slstm_every groups, each of
slstm_every - 1 mLSTM blocks then one sLSTM block (xlstm-1.3b: 6 x (7 + 1)
= 48). Caches are plain dicts and lists: {"attn": [per block]},
{"mamba": [per Mamba block], "attn": [per attention application]}, or
{"mlstm": [...], "slstm": [...]} per block in order.

Training: `loss` is the reference's mean next-token cross-entropy (audio
over every codebook, vlm over the token positions after the patches,
weighted by an optional "loss_mask") plus the MoE load-balancing loss, in
float32, over `cfg.loss_chunk` positions at a time. The parameters do not
require grad: `repro_torch.train.train_step` differentiates a compute copy
installed with `torch.func.functional_call`. Under grad, with `cfg.remat`,
every block of a full-sequence pass and every loss chunk is recomputed in
the backward (`torch.utils.checkpoint`, the reference's per-block
`jax.checkpoint`), so a block's activations and one chunk's float32
logits live at a time.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_FAMILIES = ("dense", "moe", "audio", "vlm", "hybrid", "ssm")
_ATTENTION_STACKS = ("dense", "moe", "audio", "vlm")


class DenseBlock(nn.Module):
    """Pre-norm attention + MLP (the dense, audio and vlm stacks, and
    zamba2's shared block), or + routed experts (`moe`, the moe stack)."""

    def __init__(self, cfg: ModelConfig, device=None, moe: bool = False):
        super().__init__()
        self.ln1 = L._param((cfg.d_model,), cfg, device, 0.0)
        self.ln2 = L._param((cfg.d_model,), cfg, device, 0.0)
        self.attn = L.Attention(cfg, device)
        if moe:
            self.moe = L.MoE(cfg, device)
        else:
            self.mlp = L.MLP(cfg, device)

    def init(self, cfg, generator):
        self.attn.init(cfg, generator)
        (self.moe if hasattr(self, "moe") else self.mlp).init(cfg, generator)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = L._param((cfg.d_model,), cfg, device, 0.0)
        self.mamba = L.Mamba(cfg, device)

    def init(self, cfg, generator):
        self.mamba.init(cfg, generator)


class MLSTMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = L._param((cfg.d_model,), cfg, device, 0.0)
        self.mlstm = L.MLSTM(cfg, device)

    def init(self, cfg, generator):
        self.mlstm.init(cfg, generator)


class SLSTMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = L._param((cfg.d_model,), cfg, device, 0.0)
        self.slstm = L.SLSTM(cfg, device)

    def init(self, cfg, generator):
        self.slstm.init(cfg, generator)


def _apply_dense_block(p: DenseBlock, x, cfg, *, positions, mode, cache,
                       want_cache, window=0):
    """Returns (x, cache, aux): aux the MoE block's load-balancing loss, or
    None after an MLP."""
    a, c = L.apply_attention(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps), cfg,
                             positions=positions, mode=mode, cache=cache,
                             want_cache=want_cache, window=window)
    x = x + a
    h = L.rmsnorm(x, p.ln2, cfg.norm_eps)
    if hasattr(p, "moe"):
        m, aux = L.apply_moe(p.moe, h, cfg)
    else:
        m, aux = L.apply_mlp(p.mlp, h, cfg), None
    return x + m, c, aux


def _apply_mamba_block(p: MambaBlock, x, cfg, *, mode, cache, want_cache):
    y, c = L.apply_mamba(p.mamba, L.rmsnorm(x, p.ln, cfg.norm_eps), cfg,
                         mode=mode, cache=cache, want_cache=want_cache)
    return x + y, c


def _apply_mlstm_block(p: MLSTMBlock, x, cfg, *, mode, cache, want_cache):
    y, c = L.apply_mlstm(p.mlstm, L.rmsnorm(x, p.ln, cfg.norm_eps), cfg,
                         mode=mode, cache=cache, want_cache=want_cache)
    return x + y, c


def _apply_slstm_block(p: SLSTMBlock, x, cfg, *, mode, cache, want_cache):
    y, c = L.apply_slstm(p.slstm, L.rmsnorm(x, p.ln, cfg.norm_eps), cfg,
                         mode=mode, cache=cache, want_cache=want_cache)
    return x + y, c


def _call(remat: bool, fn, *args, **kw):
    """fn(*args, **kw), recomputed in the backward when `remat`."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


def _nll(logits, targets):
    """-log softmax(logits)[target] along the last axis, float32."""
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, targets[..., None].long())[..., 0]


def _ssm_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, mLSTM blocks a group) of the ssm family."""
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab_size
        self.register_parameter("lm_head", None)
        self.register_parameter("heads", None)
        self.register_parameter("patch_proj", None)
        if cfg.family == "audio":
            self.embed = L._param((cfg.n_codebooks, V, d), cfg, dev)
            self.heads = L._param((cfg.n_codebooks, d, V), cfg, dev)
        else:
            self.embed = L._param((V, d), cfg, dev)
            if not cfg.tie_embeddings:
                self.lm_head = L._param((d, V), cfg, dev)
        if cfg.family == "vlm":
            self.patch_proj = L._param((d, d), cfg, dev)
        self.ln_f = L._param((d,), cfg, dev, 0.0)
        if cfg.family in _ATTENTION_STACKS:
            self.layers = nn.ModuleList(
                DenseBlock(cfg, dev, moe=cfg.family == "moe")
                for _ in range(cfg.n_layers))
        elif cfg.family == "ssm":
            g, m = _ssm_groups(cfg)
            self.mlstm = nn.ModuleList(MLSTMBlock(cfg, dev)
                                       for _ in range(g * m))
            self.slstm = nn.ModuleList(SLSTMBlock(cfg, dev)
                                       for _ in range(g))
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
        initial distributions (embeddings and heads N(0, 0.02^2), dense
        weights N(0, 1/fan_in), the MoE router N(0, 0.02^2), norms 0,
        Mamba2's A_log / Dskip / dt_bias fixed; the mLSTM gates and sLSTM
        gate weights N(0, 0.02^2))."""
        cfg = self.cfg
        for head in (self.embed, self.lm_head, self.heads):
            if head is not None:
                L.normal_(head, generator, 0.02)
        if self.patch_proj is not None:
            L.dense_init(self.patch_proj, generator)
        if cfg.family in _ATTENTION_STACKS:
            blocks = self.layers
        elif cfg.family == "ssm":
            blocks = [*self.mlstm, *self.slstm]
        else:
            blocks = [*self.mamba, self.shared]
        for blk in blocks:
            blk.init(cfg, generator)
        return self

    # ---------------- embedding / head ----------------
    def _embed(self, batch: dict):
        cfg = self.cfg
        dt = L._dtype(cfg)
        tok = batch["tokens"]
        if cfg.family == "audio":                  # (B, K, S): summed rows
            x = self.embed[0][tok[:, 0]]
            for k in range(1, cfg.n_codebooks):
                x = x + self.embed[k][tok[:, k]]
            x = x.to(dt)
        else:
            x = self.embed[tok].to(dt)
        if self.patch_proj is not None and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(dt) @ self.patch_proj.to(dt)
            x = torch.cat([pe, x], dim=1)
        return x

    def _head(self, x):
        cfg = self.cfg
        dt = L._dtype(cfg)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        if self.heads is not None:                 # (B, S, K, V)
            return torch.einsum("bsd,kdv->bskv", x, self.heads.to(dt)).float()
        w = self.embed.T if self.lm_head is None else self.lm_head
        return (x @ w.to(dt)).float()

    # ---------------- stack application ----------------
    def _run_stack(self, x, *, positions, mode, caches, want_cache):
        """Returns (x, caches, aux): aux the summed load-balancing loss of
        the MoE blocks (a float32 0 for the other families)."""
        cfg = self.cfg
        keep = want_cache or mode == "decode"
        remat = (cfg.remat and mode == "full" and not want_cache
                 and torch.is_grad_enabled())
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in _ATTENTION_STACKS:
            new = []
            for i, blk in enumerate(self.layers):
                x, c, a = _call(
                    remat, _apply_dense_block,
                    blk, x, cfg, positions=positions, mode=mode,
                    cache=caches["attn"][i] if caches else None,
                    want_cache=want_cache)
                new.append(c)
                if a is not None:
                    aux = aux + a
            return x, ({"attn": new} if keep else None), aux
        if cfg.family == "ssm":
            _, m = _ssm_groups(cfg)
            mls, sls = [], []
            for gi, sblk in enumerate(self.slstm):
                for i in range(gi * m, (gi + 1) * m):
                    x, c = _call(
                        remat, _apply_mlstm_block,
                        self.mlstm[i], x, cfg, mode=mode,
                        cache=caches["mlstm"][i] if caches else None,
                        want_cache=want_cache)
                    mls.append(c)
                x, c = _call(
                    remat, _apply_slstm_block,
                    sblk, x, cfg, mode=mode,
                    cache=caches["slstm"][gi] if caches else None,
                    want_cache=want_cache)
                sls.append(c)
            return x, ({"mlstm": mls, "slstm": sls} if keep else None), aux
        g = cfg.n_layers // cfg.attn_every
        mam, att = [], []
        for i, blk in enumerate(self.mamba):
            x, c = _call(
                remat, _apply_mamba_block,
                blk, x, cfg, mode=mode,
                cache=caches["mamba"][i] if caches else None,
                want_cache=want_cache)
            mam.append(c)
            gi, last = divmod(i + 1, cfg.attn_every)
            if last == 0 and gi <= g:       # after each full group of blocks
                x, c, _ = _call(
                    remat, _apply_dense_block,
                    self.shared, x, cfg, positions=positions, mode=mode,
                    cache=caches["attn"][gi - 1] if caches else None,
                    want_cache=want_cache, window=cfg.sliding_window)
                att.append(c)
        return x, ({"mamba": mam, "attn": att} if keep else None), aux

    # ---------------- public API ----------------
    def forward(self, batch: dict, with_aux: bool = False):
        """batch: {"tokens": (B, S) int} (audio (B, K, S); vlm optionally
        "patch_embeds" (B, n_patches, d)). Returns fp32 logits (B, S, V)
        (audio (B, S, K, V); vlm over the patches and the tokens), and with
        `with_aux` also the summed load-balancing loss: (logits, aux)."""
        x = self._embed(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, aux = self._run_stack(x, positions=positions, mode="full",
                                    caches=None, want_cache=False)
        logits = self._head(x)
        return (logits, aux) if with_aux else logits

    def loss(self, batch: dict):
        """Mean next-token cross-entropy plus the MoE load-balancing loss:
        (total, {"ce", "aux"}), float32 scalars. batch as `forward` takes
        it plus "targets" ((B, S); audio (B, K, S)) and optionally
        "loss_mask" ((B, S) float; not audio's). Over `cfg.loss_chunk`
        positions at a time unless it is 0 or the family is audio (the
        reference's `loss` and `_loss_chunked`)."""
        cfg = self.cfg
        if cfg.loss_chunk and cfg.family != "audio":
            return self._loss_chunked(batch)
        logits, aux = self.forward(batch, with_aux=True)
        targets = batch["targets"]
        if cfg.family == "audio":
            # logits (B, S, K, V), targets (B, K, S)
            nll = _nll(logits, targets.transpose(1, 2))
            mask = torch.ones_like(nll)
        else:
            if cfg.family == "vlm":
                logits = logits[:, logits.shape[1] - targets.shape[1]:]
            nll = _nll(logits, targets)
            mask = batch.get("loss_mask")
            mask = torch.ones_like(nll) if mask is None else mask.float()
        ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    def _loss_chunk_nll(self, x, targets, mask):
        """Masked nll summed over one chunk of positions."""
        return (_nll(self._head(x), targets) * mask).sum()

    def _loss_chunked(self, batch: dict):
        """`loss` over sequence chunks of `cfg.loss_chunk` positions: each
        chunk's (B, chunk, V) float32 logits are made, reduced and (under
        grad) dropped, and remade in the backward."""
        cfg = self.cfg
        x = self._embed(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, aux = self._run_stack(x, positions=positions, mode="full",
                                    caches=None, want_cache=False)
        targets = batch["targets"]
        if cfg.family == "vlm":
            x = x[:, x.shape[1] - targets.shape[1]:]
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32,
                           device=x.device) if mask is None else mask.float())
        remat = torch.is_grad_enabled()
        c = min(cfg.loss_chunk, x.shape[1])
        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, x.shape[1], c):
            nll_sum = nll_sum + _call(
                remat, self._loss_chunk_nll, x[:, i:i + c],
                targets[:, i:i + c], mask[:, i:i + c])
        ce = nll_sum / torch.clamp(mask.sum(), min=1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    def init_cache(self, batch: int, cache_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        if cfg.family in _ATTENTION_STACKS:
            return {"attn": [L.attention_cache_spec(cfg, batch, cache_len, 0,
                                                    dev)
                             for _ in range(cfg.n_layers)]}
        if cfg.family == "ssm":
            g, m = _ssm_groups(cfg)
            return {"mlstm": [L.mlstm_cache_spec(cfg, batch, dev)
                              for _ in range(g * m)],
                    "slstm": [L.slstm_cache_spec(cfg, batch, dev)
                              for _ in range(g)]}
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
        slots (kpos = -1) so subsequent decode steps have room to append
        (the ssm family's recurrent states need no room). A vlm prefill
        with patches fills n_patches + S positions."""
        x = self._embed(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, caches, _ = self._run_stack(x, positions=positions, mode="full",
                                       caches=None, want_cache=True)
        logits = self._head(x[:, -1:])
        if cache_len is not None:
            caches = _pad_attention_caches(caches, cache_len,
                                           self.cfg.sliding_window)
        return logits, caches

    @torch.no_grad()
    def decode_step(self, tokens, cache, pos: int):
        """tokens: (B, 1) (audio (B, K, 1)); pos: number of positions
        already processed. Returns (logits_for_new_token, cache); the cache
        is updated in place."""
        x = self._embed({"tokens": tokens})
        x, cache, _ = self._run_stack(x, positions=pos, mode="decode",
                                      caches=cache, want_cache=False)
        return self._head(x), cache


def _pad_attention_caches(caches, cache_len: int, window: int):
    """Pad every attention cache's sequence axis to its target ring size:
    min(window, cache_len) for windowed attention, else cache_len. Empty
    slots carry kpos = -1 (masked out by decode_attention). A cache without
    attention (the ssm family's) passes through."""
    target = min(window, cache_len) if window else cache_len
    for c in caches.get("attn", ()):
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
