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

On a mesh of ranks (`parallel.sharding.live`) every family trains
sharded as the reference places it (`check_mesh` raises, naming the
family and its heads, where they do not divide the model axis; serving
there raises): each rank holds its data shard's rows and its pieces of the
weights, the layers split over "model" (`models.layers`), the embedding
and the logits over the vocabulary where it divides (a lookup in this
rank's rows summed over "model", each of audio's codebooks alike; the
cross-entropy from this rank's piece of the logits, its max, sum of
exponentials and target logit reduced over "model", `_vocab_parallel_nll`;
`forward` gathers the pieces), vlm's `patch_proj` column-parallel and
gathered, and the loss's mean taken over every data shard's positions
(`reduce_from` over "dp": each rank's gradients are its share of the
global loss's). `init(generator, sink=...)` draws the parameters a block
at a time for the train step to keep only its pieces; `compute_views`
says which of them the compute copy regroups or gathers.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as S

_FAMILIES = ("dense", "moe", "audio", "vlm", "hybrid", "ssm")
_ATTENTION_STACKS = ("dense", "moe", "audio", "vlm")


def check_mesh(cfg: ModelConfig, mesh=None) -> None:
    """On a mesh of several ranks, raise NotImplementedError where `cfg`'s
    heads (or sLSTM's channels) do not divide the model axis, naming the
    family and the heads. Every family runs there otherwise."""
    mesh = mesh or S.current_mesh()
    if not S.live(mesh):
        return
    tp = mesh.shape.get("model", 1)
    if cfg.family in _ATTENTION_STACKS or cfg.family == "hybrid":
        L.attention_heads(cfg, tp, 0)
    if cfg.family == "hybrid":
        L.mamba_columns(cfg, tp, 0)
    if cfg.family == "ssm":
        L.mlstm_columns(cfg, tp, 0)
        L.slstm_columns(cfg, tp, 0)


def compute_views(cfg: ModelConfig, shapes: dict, mesh) -> dict:
    """{parameter name: view} of the parameters whose compute copy on a
    mesh of ranks is not the TP-only piece of `compute_param_specs`:
    ("columns", dim, index) where the rank's pieces along `dim` do not
    follow its heads (gathered over "model" where split, then picked):
    attention's `wqkv` and `bqkv` (the rank's q, k and v heads' columns,
    `layers.qkv_columns`), mLSTM's `wqkv`, `wif` and `ln_inner`, sLSTM's
    `w_gates`, Mamba2's `in_proj`, `conv_w`, `conv_b` and `norm_g`
    (`layers.mlstm_columns`, `slstm_columns`, `mamba_columns`); and
    ("whole", 0, None) for the experts' `w_in` and `w_out`, which the MoE
    block uses whole (the reference's `shard_map` takes them replicated).
    Empty off a mesh of ranks or with a model axis of one."""
    tp = mesh.shape.get("model", 1) if S.live(mesh) else 1
    if tp == 1:
        return {}
    m = mesh.coords["model"]
    by_block = {}
    if cfg.family in _ATTENTION_STACKS or cfg.family == "hybrid":
        cols = L.qkv_columns(cfg, tp, m)
        by_block["attn"] = {"wqkv": cols, "bqkv": cols}
    if cfg.family == "hybrid":
        mc = L.mamba_columns(cfg, tp, m)
        by_block["mamba"] = {"in_proj": mc["in_proj"], "conv_w": mc["conv"],
                             "conv_b": mc["conv"], "norm_g": mc["inner"]}
    if cfg.family == "ssm":
        by_block["mlstm"] = L.mlstm_columns(cfg, tp, m)
        by_block["slstm"] = {"w_gates": L.slstm_columns(cfg, tp, m)}
    out = {}
    for name, shape in shapes.items():
        *_, block, leaf = ("",) + tuple(name.split("."))
        if leaf in by_block.get(block, {}):
            dim = 0 if leaf == "ln_inner" else len(shape) - 1
            out[name] = ("columns", dim, by_block[block][leaf])
        elif leaf in ("w_in", "w_out"):
            out[name] = ("whole", 0, None)
    return out


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
    def _blocks(self) -> list:
        """(name prefix, block) in the order `init` draws them."""
        cfg = self.cfg
        if cfg.family in _ATTENTION_STACKS:
            return [(f"layers.{i}", b) for i, b in enumerate(self.layers)]
        if cfg.family == "ssm":
            return ([(f"mlstm.{i}", b) for i, b in enumerate(self.mlstm)]
                    + [(f"slstm.{i}", b) for i, b in enumerate(self.slstm)])
        return ([(f"mamba.{i}", b) for i, b in enumerate(self.mamba)]
                + [("shared", self.shared)])

    @torch.no_grad()
    def _init_top(self, generator: torch.Generator) -> None:
        for head in (self.embed, self.lm_head, self.heads):
            if head is not None:
                L.normal_(head, generator, 0.02)
        if self.patch_proj is not None:
            L.dense_init(self.patch_proj, generator)

    @torch.no_grad()
    def init(self, generator: torch.Generator, sink=None) -> "Model":
        """Fill every parameter from `generator` with the reference's
        initial distributions (embeddings and heads N(0, 0.02^2), dense
        weights N(0, 1/fan_in), the MoE router N(0, 0.02^2), norms 0,
        Mamba2's A_log / Dskip / dt_bias fixed; the mLSTM gates and sLSTM
        gate weights N(0, 0.02^2)).

        With `sink`, a function of (name, tensor), the model itself is left
        as it is (it may be on the meta device): the parameters are made
        whole on the generator's device, the top-level ones first, then a
        block at a time, each handed to `sink` and dropped. The values are
        those `init` would fill in, drawn in the same order."""
        cfg = self.cfg
        if sink is None:
            self._init_top(generator)
            for _, blk in self._blocks():
                blk.init(cfg, generator)
            return self
        dev = generator.device
        top = Model(cfg.with_(n_layers=0), device=dev)
        top._init_top(generator)
        for name, p in top.named_parameters():
            if "." not in name:
                sink(name, p)
        del top
        for prefix, blk in self._blocks():
            fresh = (DenseBlock(cfg, dev, moe=hasattr(blk, "moe"))
                     if isinstance(blk, DenseBlock) else type(blk)(cfg, dev))
            fresh.init(cfg, generator)
            for name, p in fresh.named_parameters():
                sink(f"{prefix}.{name}", p)
            del fresh
        return self

    # ---------------- embedding / head ----------------
    def _embed(self, batch: dict):
        cfg = self.cfg
        dt = L._dtype(cfg)
        tok = batch["tokens"]
        if cfg.family == "audio":                  # (B, K, S): summed rows
            # each codebook's rows in float32, added in codebook order;
            # split over "model", this rank's rows' sum is summed over it
            split = self.embed.shape[1] != cfg.vocab_size
            x = None
            for k in range(cfg.n_codebooks):
                e = (_vocab_rows(self.embed[k], tok[:, k]) if split
                     else L.embedding_rows(self.embed[k], tok[:, k]))
                x = e.float() if x is None else x + e.float()
            x = (S.reduce_from(x, "tp") if split else x).to(dt)
        elif self.embed.shape[0] != cfg.vocab_size:   # rows over "model"
            x = S.reduce_from(_vocab_rows(self.embed, tok), "tp").to(dt)
        else:
            x = L.embedding_rows(self.embed, tok).to(dt)
        if self.patch_proj is not None and "patch_embeds" in batch:
            w = self.patch_proj.to(dt)
            pe = batch["patch_embeds"].to(dt) @ w
            if w.shape[1] != cfg.d_model:   # column-parallel, gathered
                pe = S.constrain(pe, "dp", None, None, src=("dp", None, "tp"))
            x = torch.cat([pe, x], dim=1)
        return x

    def _head_piece(self, x):
        """(logits in cfg.dtype, split): the whole logits, or on a mesh of
        ranks where the vocabulary is split over "model" this rank's piece
        of them (split True)."""
        cfg = self.cfg
        dt = L._dtype(cfg)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        w = (self.heads if self.heads is not None else
             self.embed.T if self.lm_head is None else self.lm_head)
        split = w.shape[-1] != cfg.vocab_size  # this rank's vocabulary piece
        if split:
            x = S.copy_to(x, "tp")
        if self.heads is not None:                 # (B, S, K, V)
            return torch.einsum("bsd,kdv->bskv", x, w.to(dt)), split
        return x @ w.to(dt), split

    def _head(self, x):
        """float32 logits over the whole vocabulary (a split one's pieces
        gathered over "model")."""
        logits, split = self._head_piece(x)
        if split:
            logits = S.constrain(logits, "dp", *[None] * (logits.dim() - 1),
                                 src=("dp", *[None] * (logits.dim() - 2),
                                      "tp"))
        return logits.float()

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
        check_mesh(self.cfg)
        x, aux = self._hidden(batch)
        logits = self._head(x)
        return (logits, aux) if with_aux else logits

    def _hidden(self, batch: dict):
        """(the stack's output over the whole sequence, the summed
        load-balancing loss)."""
        x = self._embed(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, aux = self._run_stack(x, positions=positions, mode="full",
                                    caches=None, want_cache=False)
        return x, aux

    def loss(self, batch: dict):
        """Mean next-token cross-entropy plus the MoE load-balancing loss:
        (total, {"ce", "aux"}), float32 scalars. batch as `forward` takes
        it plus "targets" ((B, S); audio (B, K, S)) and optionally
        "loss_mask" ((B, S) float; not audio's). Over `cfg.loss_chunk`
        positions at a time unless it is 0 or the family is audio (the
        reference's `loss` and `_loss_chunked`)."""
        cfg = self.cfg
        check_mesh(cfg)
        if cfg.loss_chunk and cfg.family != "audio":
            return self._loss_chunked(batch)
        x, aux = self._hidden(batch)
        logits, split = self._head_piece(x)
        nll_of = _vocab_parallel_nll if split else _nll
        targets = batch["targets"]
        if cfg.family == "audio":
            # logits (B, S, K, V), targets (B, K, S)
            nll = nll_of(logits.float(), targets.transpose(1, 2))
            mask = torch.ones_like(nll)
        else:
            if cfg.family == "vlm":
                logits = logits[:, logits.shape[1] - targets.shape[1]:]
            nll = nll_of(logits.float(), targets)
            mask = batch.get("loss_mask")
            mask = torch.ones_like(nll) if mask is None else mask.float()
        ce = _mean_over_shards((nll * mask).sum(), mask)
        return ce + aux, {"ce": ce, "aux": aux}

    def _loss_chunk_nll(self, x, targets, mask):
        """Masked nll summed over one chunk of positions (with the
        vocabulary split over "model", from this rank's piece of the
        logits: `_vocab_parallel_nll`)."""
        logits, split = self._head_piece(x)
        nll = (_vocab_parallel_nll(logits.float(), targets) if split
               else _nll(logits.float(), targets))
        return (nll * mask).sum()

    def _loss_chunked(self, batch: dict):
        """`loss` over sequence chunks of `cfg.loss_chunk` positions: each
        chunk's (B, chunk, V) float32 logits are made, reduced and (under
        grad) dropped, and remade in the backward."""
        cfg = self.cfg
        x, aux = self._hidden(batch)
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
        ce = _mean_over_shards(nll_sum, mask)
        return ce + aux, {"ce": ce, "aux": aux}

    def init_cache(self, batch: int, cache_len: int) -> dict:
        _no_serving_on_a_mesh()
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
        _no_serving_on_a_mesh()
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
        _no_serving_on_a_mesh()
        x = self._embed({"tokens": tokens})
        x, cache, _ = self._run_stack(x, positions=pos, mode="decode",
                                      caches=cache, want_cache=False)
        return self._head(x), cache


def _no_serving_on_a_mesh() -> None:
    if S.live(S.current_mesh()):
        raise NotImplementedError("serving on a mesh of ranks is not "
                                  "ported: the caches are whole")


def _vocab_rows(w, tok):
    """This rank's part of the embedding rows of `tok` where it holds rows
    [m V / tp, (m + 1) V / tp) of the table `w` (its piece over "model"):
    its own rows looked up (`embedding_rows`), zeros for the others. Their
    sum over "model" (`reduce_from`, float32) is the rows exactly: one
    nonzero term."""
    rows = w.shape[0]
    local = tok.long() - L.tp_rank()[1] * rows
    inside = (local >= 0) & (local < rows)
    return torch.where(inside[..., None],
                       L.embedding_rows(w, local.clamp(0, rows - 1)), 0.0)


def _vocab_parallel_nll(logits, targets):
    """-log softmax(logits)[target] where `logits` (float32) is this rank's
    piece [m V / tp, (m + 1) V / tp) of the vocabulary: the max over the
    vocabulary (a shift, out of the gradient), the sum of exponentials and
    the target's logit each reduced over "model" (fixed order), so no
    rank holds the whole logits; log(sum) - (logit - max) as `_nll`
    computes it."""
    mesh, axes = S.mesh_axes("tp")
    rows = logits.shape[-1]
    m = C.all_reduce_max(logits.detach().amax(-1), mesh, axes)
    z = logits - m[..., None]
    sumexp = S.reduce_from(torch.exp(z).sum(-1), "tp")
    local = targets.long() - L.tp_rank()[1] * rows
    inside = (local >= 0) & (local < rows)
    zt = z.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    zt = S.reduce_from(torch.where(inside, zt, 0.0), "tp")
    return torch.log(sumexp) - zt


def _mean_over_shards(nll_sum, mask):
    """nll_sum / the positions' weight, over every data shard's positions
    on a mesh of ranks: this rank's share summed over "dp" (identity in
    the backward, so each rank's gradients are its share's)."""
    den = mask.sum()
    mesh = S.current_mesh()
    if S.live(mesh) and S.logical_size("dp", mesh) > 1:
        mesh, axes = S.mesh_axes("dp", mesh)
        den = C.all_reduce(den.detach(), mesh, axes)
        return S.reduce_from(nll_sum / torch.clamp(den, min=1.0), "dp")
    return nll_sum / torch.clamp(den, min=1.0)


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
