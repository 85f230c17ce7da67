"""Public wrappers around the model kernels, dispatching on the tensor's
device as the reference's `kernels/ops.py` dispatches on the backend:

  * CPU tensors  -> the plain PyTorch routes the reference takes off the TPU
                    (`chunked_attention`, `linear_scan_chunked`,
                    `rmsnorm_ref`): identical math, bounded memory.
  * CUDA tensors -> the hand-written kernels (`flash_attention_cuda`,
                    `ssd_scan_cuda`, `rmsnorm_cuda`), or an error. Nothing
                    falls back to the plain route on a card.

The wrappers keep the model layout at their interface ((B, S, heads, dh),
(..., D)); the kernels read it in place through strides, so nothing is
folded to (B*H, S, dh) and nothing is padded in memory. Where a view's
strides do not suit a kernel the wrapper makes it contiguous first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.models.attention import chunked_attention
from repro_torch.models.linear_scan import linear_scan_chunked


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}: cuda | cpu")


def flash_attention(q, k, v, *, causal=True, window=0,
                    block_q=128, block_k=128):
    """Model-layout flash attention. q: (B, S, H, dh); k, v: (B, S, KV, dh).

    `block_q`/`block_k` are the reference's tile sizes (on the TPU; the
    model passes `cfg.attn_chunk_q`/`attn_chunk_k`, 1024 at full width).
    The CPU route uses them as its chunk sizes; the CUDA kernel ignores
    them and tiles by its own 64 x 64. On the card it takes bfloat16 only
    (the serving engine's dtype) and raises on float32."""
    if not _on_card(q):
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk_q=block_q, chunk_k=block_k)
    q, k, v = (t if _fa.kernel_takes_strides(t) else t.contiguous()
               for t in (q, k, v))
    return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)


def ssd_scan(q, k, v, log_a, beta, *, chunk=256):
    """Model-layout SSD. q, k: (B, S, H, dk); v: (B, S, H, dv);
    log_a, beta: (B, S, H). Returns (y (B, S, H, dv), final_state
    (B, H, dk, dv) float32)."""
    if not _on_card(q):
        return linear_scan_chunked(q, k, v, log_a, beta, chunk=chunk)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    return _ssd.ssd_scan_cuda(q, k, v, log_a.float(), beta.float(),
                              chunk=chunk)


def rmsnorm(x, w, *, eps=1e-5):
    """x: (..., D); w: (D,)."""
    if not _on_card(x):
        return rmsnorm_ref(x, w, eps)
    shape = x.shape
    out = _rn.rmsnorm_cuda(x.reshape(-1, shape[-1]).contiguous(),
                           w.contiguous(), eps)
    return out.reshape(shape)
