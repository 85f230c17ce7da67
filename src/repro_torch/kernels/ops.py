"""Public wrappers around the model kernels, dispatching on the tensor's
device as the reference's `kernels/ops.py` dispatches on the backend:

  * CPU tensors  -> the plain PyTorch routes the reference takes off the TPU
                    (`chunked_attention`, `linear_scan_chunked`,
                    `rmsnorm_ref`): identical math, bounded memory.
  * CUDA tensors -> the hand-written kernels (`flash_attention_cuda`,
                    `ssd_scan_cuda` or `ssd_scan_wide_cuda` by the state's
                    width, `mlstm_scan_cuda` for mLSTM's pair of scans,
                    `rmsnorm_cuda`), or an error. Nothing falls back
                    to the plain route on a card.

The wrappers keep the model layout at their interface ((B, S, heads, dh),
(..., D)); the kernels read it in place through strides, so nothing is
folded to (B*H, S, dh) and nothing is padded in memory. Where a view's
strides do not suit a kernel the wrapper makes it contiguous first.

Gradients. On a CPU tensor autograd differentiates the plain routes. On a
CUDA tensor under grad (grad mode on and an input that requires grad) each
scan and attention wrapper is a `torch.autograd.Function` whose forward is
the kernel and whose backward is a kernel too: `flash_attention` (forward
with the rows' log-sum-exp, backward `flash_attention_bwd_cuda`),
`ssd_scan` (backward `ssd_scan_bwd.ssd_scan_bwd_cuda`, or
`ssd_scan_wide_bwd_cuda` for states wider than 128) and `mlstm_scan`
(`mlstm_scan_bwd_cuda`, the memory and the normaliser in one call).
`rmsnorm` has no backward kernel (no model calls it: they use the plain
`models.layers.rmsnorm`), so on a CUDA tensor under grad it raises: a
ctypes kernel returns a tensor without a `grad_fn`, and a backward through
it would leave every gradient upstream of it silently zero.

Meta tensors (`launch.dryrun` runs the models on the meta device to size
a cell without allocating it) take `_MetaShapes`: outputs of the plain
version's shapes and dtypes, computed and launched nowhere.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_scan_bwd as _ssdb
from repro_torch.kernels import ssd_scan_wide as _ssdw
from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.models.attention import chunked_attention
from repro_torch.models.linear_scan import linear_scan_chunked


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}: cuda | cpu")


class _MetaShapes(torch.autograd.Function):
    """A wrapper's outputs on the meta device (`launch.dryrun` runs the
    models there): empty tensors of the plain version's output shapes and
    dtypes, and in the backward empty gradients of the inputs' shapes. It
    computes nothing and launches nothing; its inputs are saved for the
    backward, as the kernels' Functions save theirs, so the dry-run counts
    what a step keeps between its forward and its backward."""

    @staticmethod
    def forward(ctx, outs, *inputs):
        ctx.ins = [(t.shape, t.dtype) if isinstance(t, torch.Tensor)
                   else None for t in inputs]
        ctx.save_for_backward(*(t for t in inputs
                                if isinstance(t, torch.Tensor)))
        res = tuple(torch.empty(s, dtype=d, device="meta") for s, d in outs)
        return res if len(res) > 1 else res[0]

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(None if m is None else
                        torch.empty(m[0], dtype=m[1], device="meta")
                        for m in ctx.ins))


def _on_meta(x: torch.Tensor) -> bool:
    return x.device.type == "meta"


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors) -> None:
    """Raise when a CUDA kernel without a backward would be differentiated
    (Trap: its output has no grad_fn, so the gradients would be cut)."""
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"ops.{name} on the card has no backward kernel (no model calls "
            f"it under grad: they use the plain models.layers.rmsnorm); run "
            f"it under torch.no_grad(), or on the CPU where autograd "
            f"differentiates the plain route")


class _FlashAttention(torch.autograd.Function):
    """The flash kernel with its backward kernel: the forward stores the
    rows' log-sum-exp beside o and saves both; the backward recomputes P
    from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = _fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if not _fa.kernel_takes_strides(do):
            do = do.contiguous()
        dq, dk, dv = _fa.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=0,
                    block_q=128, block_k=128):
    """Model-layout flash attention. q: (B, S, H, dh); k, v: (B, S, KV, dh).

    `block_q`/`block_k` are the reference's tile sizes (on the TPU; the
    model passes `cfg.attn_chunk_q`/`attn_chunk_k`, 1024 at full width).
    The CPU route uses them as its chunk sizes; the CUDA kernel ignores
    them and tiles by its own 128 query rows x 128 keys. On the card it
    takes bfloat16 only (the serving engine's dtype) and raises on
    float32; under grad it is `_FlashAttention` (kernel forward with LSE,
    kernel backward), else the forward kernel alone."""
    if _on_meta(q):
        return _MetaShapes.apply(((q.shape[:-1] + v.shape[-1:], q.dtype),),
                                 q, k, v)
    if not _on_card(q):
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk_q=block_q, chunk_k=block_k)
    q, k, v = (t if _fa.kernel_takes_strides(t) else t.contiguous()
               for t in (q, k, v))
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)


def _heads_one(t):
    """t (B, S, H, d) shared by its heads (head stride 0) as its (B, S, 1,
    d) row: what an autograd Function takes, so that its backward returns
    the sum over the heads and autograd spreads it back."""
    return t[:, :, :1] if _ssdb.shared_heads(t) else t


def _heads_all(t, h):
    return t.expand(t.shape[0], t.shape[1], h, t.shape[3])


class _SSDScan(torch.autograd.Function):
    """The SSD kernel (`ssd_scan_cuda`, or `ssd_scan_wide_cuda` above 128)
    with its backward kernel. q and k arrive as (B, S, 1, dk) where they
    are shared by the heads; the backward kernel sums their gradients over
    the heads. A None cotangent of the final state (its value unused, as
    in training) seeds no carry."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, beta, chunk, wide):
        ctx.set_materialize_grads(False)
        h = v.shape[2]
        qe, ke = _heads_all(q, h), _heads_all(k, h)
        kernel = _ssdw.ssd_scan_wide_cuda if wide else _ssd.ssd_scan_cuda
        y, state = kernel(qe, ke, v, log_a, beta, chunk=chunk)
        ctx.save_for_backward(q, k, v, log_a, beta)
        ctx.chunk, ctx.wide = chunk, wide
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        q, k, v, log_a, beta = ctx.saved_tensors
        h = v.shape[2]
        dy = torch.zeros_like(v) if dy is None else dy
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        kernel = (_ssdb.ssd_scan_wide_bwd_cuda if ctx.wide
                  else _ssdb.ssd_scan_bwd_cuda)
        dq, dk, dv, dla, db = kernel(
            _heads_all(q, h), _heads_all(k, h), v, log_a, beta, dy,
            d_state, chunk=ctx.chunk)
        return dq, dk, dv, dla, db, None, None


class _MLSTMScan(torch.autograd.Function):
    """mLSTM's pair (`mlstm_scan_cuda`) with its backward kernel
    (`mlstm_scan_bwd_cuda`): the memory's and the normaliser's gradients in
    one call. None cotangents (C and n unused, as in training) seed no
    carry."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, beta, chunk):
        ctx.set_materialize_grads(False)
        out = _ssdw.mlstm_scan_cuda(q, k, v, log_a, beta, chunk=chunk)
        ctx.save_for_backward(q, k, v, log_a, beta)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, dy, dC, dnm, dn):
        q, k, v, log_a, beta = ctx.saved_tensors
        dy, dnm = (None if t is None else t if t.stride(-1) == 1
                   else t.contiguous() for t in (dy, dnm))
        grads = _ssdb.mlstm_scan_bwd_cuda(q, k, v, log_a, beta, dy, dnm, dC,
                                          dn, chunk=ctx.chunk)
        return (*grads, None)


def ssd_kernel_for(dk: int, dv: int) -> str:
    """The kernel `ssd_scan` launches on the card for a (dk, dv) state:
    "ssd_scan" up to 128 x 128, else "ssd_scan_wide" up to 512 x 512."""
    if dk <= _ssd.MAX_DIM and dv <= _ssd.MAX_DIM:
        return "ssd_scan"
    if dk <= _ssdw.MAX_DIM and dv <= _ssdw.MAX_DIM:
        return "ssd_scan_wide"
    raise ValueError(f"ssd_scan on the card: dk, dv <= {_ssdw.MAX_DIM}; "
                     f"got {dk}, {dv}")


def ssd_scan(q, k, v, log_a, beta, *, chunk=256):
    """Model-layout SSD. q, k: (B, S, H, dk); v: (B, S, H, dv);
    log_a, beta: (B, S, H). Returns (y (B, S, H, dv), final_state
    (B, H, dk, dv) float32). On the card, states up to 128 x 128 (Mamba2)
    take `ssd_scan_cuda` and wider ones up to 512 x 512 `ssd_scan_wide_cuda`
    (dv = 1 included), one counted launch a call. mLSTM's memory and
    normaliser go to `mlstm_scan` instead, one call of the wide kernel for
    both. Under grad on the card it is `_SSDScan`: the same forward kernel,
    and `ssd_scan_bwd_cuda` (or `ssd_scan_wide_bwd_cuda`) in the
    backward, one counted launch each."""
    if _on_meta(q):
        b, _, h, dk = q.shape
        return _MetaShapes.apply(((v.shape, v.dtype), ((b, h, dk, v.shape[-1]),
                                  torch.float32)), q, k, v, log_a, beta)
    if not _on_card(q):
        return linear_scan_chunked(q, k, v, log_a, beta, chunk=chunk)
    name = ssd_kernel_for(q.shape[-1], v.shape[-1])
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    log_a, beta = log_a.float(), beta.float()
    if _needs_grad(q, k, v, log_a, beta):
        return _SSDScan.apply(_heads_one(q), _heads_one(k), v, log_a, beta,
                              chunk, name == "ssd_scan_wide")
    kernel = {"ssd_scan": _ssd.ssd_scan_cuda,
              "ssd_scan_wide": _ssdw.ssd_scan_wide_cuda}[name]
    return kernel(q, k, v, log_a, beta, chunk=chunk)


def mlstm_scan(q, k, v, log_a, beta, *, chunk=256):
    """mLSTM's two scans, its memory and its normaliser (v = ones): q, k
    (B, S, H, dk), v (B, S, H, dv), log_a, beta (B, S, H). Returns (y (B,
    S, H, dv), C (B, H, dk, dv) float32, nm (B, S, H, 1) in v's dtype, n
    (B, H, dk, 1) float32). On a CPU these are the two plain
    `linear_scan_chunked` calls the reference makes
    (`ssd_scan_wide.mlstm_scan_plain`); on the card one call
    of `ssd_scan_wide.mlstm_scan_cuda` (dk, dv <= 512), which computes the
    decays and causal scores once for both and never stores the ones.
    Under grad on the card it is `_MLSTMScan`: that kernel, and
    `mlstm_scan_bwd_cuda` in the backward, one call for both scans."""
    if _on_meta(q):
        b, s, h, dk = q.shape
        return _MetaShapes.apply((
            (v.shape, v.dtype), ((b, h, dk, v.shape[-1]), torch.float32),
            ((b, s, h, 1), v.dtype), ((b, h, dk, 1), torch.float32)),
            q, k, v, log_a, beta)
    if not _on_card(q):
        return _ssdw.mlstm_scan_plain(q, k, v, log_a, beta, chunk=chunk)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    log_a, beta = log_a.float(), beta.float()
    if _needs_grad(q, k, v, log_a, beta):
        return _MLSTMScan.apply(q, k, v, log_a, beta, chunk)
    return _ssdw.mlstm_scan_cuda(q, k, v, log_a, beta, chunk=chunk)


def rmsnorm(x, w, *, eps=1e-5):
    """x: (..., D); w: (D,)."""
    if _on_meta(x):
        return _MetaShapes.apply(((x.shape, x.dtype),), x, w)
    if not _on_card(x):
        return rmsnorm_ref(x, w, eps)
    _no_backward("rmsnorm", x, w)
    shape = x.shape
    out = _rn.rmsnorm_cuda(x.reshape(-1, shape[-1]).contiguous(),
                           w.contiguous(), eps)
    return out.reshape(shape)
