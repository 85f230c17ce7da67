"""The backward of the chunked SSD scan, as hand-written CUDA kernels and
their plain versions.

The TPU kernel `ssd_scan_pallas` (src/repro/kernels/ssd_scan.py:85) has no
backward kernel: the reference differentiates its jnp route,
`linear_scan_chunked`, with `jax.vjp`. That vjp is what these are held to.
Two wrappers launch the kernels of `csrc/ssd_bwd.cuh`, each counting one
launch a call (whatever the number of its launches) under its own name in
`launches`:

  * `ssd_scan_bwd_cuda` ("ssd_scan_bwd", `csrc/ssd_scan_bwd.cu`): states
    up to 128 x 128 (Mamba2's 64 x 64 heads), q or k shared by all heads
    (head stride 0) summed over the heads in a fixed order;
  * `mlstm_scan_bwd_cuda` ("mlstm_scan_bwd", `csrc/ssd_scan_wide_bwd.cu`):
    mLSTM's pair, the memory and its normaliser (v = ones, dv = 1) in one
    call, dk, dv up to 512; `ssd_scan_wide_bwd_cuda` ("ssd_scan_wide_bwd")
    is the same kernel with the normaliser off, the backward of
    `ssd_scan_wide_cuda`.

The math, per (batch, head) row, over chunks of C = min(chunk, 64) tokens
(the forward's recurrence cut at other points: exact in real arithmetic).
With lc the inclusive cumsum of log_a in the chunk, lt its last entry,
k~_u = beta_u k_u, S_in the state entering the chunk and dS the cotangent
of the state leaving it (`d_state` for the last chunk, else zero):

  dq_t  = sum_{u<=t} e^(lc_t - lc_u) (dy_t . v_u) k~_u + e^(lc_t) S_in dy_t
  dk~_u = sum_{t>=u} e^(lc_t - lc_u) (dy_t . v_u) q_t + e^(lt - lc_u) dS v_u
  dv_u  = sum_{t>=u} e^(lc_t - lc_u) (q_t . k~_u) dy_t
          + e^(lt - lc_u) dS^T k~_u
  dS entering the chunk = e^(lt) dS + sum_t e^(lc_t) q_t dy_t^T
  dk = beta dk~,  dbeta_u = k_u . dk~_u  (no division by beta, which is 0
  on padded rows),
  dL_j = q_j . dq_j - beta_j dbeta_j  (+ <d_state, S_final> at the last
  position), dlog_a_t = sum_{j >= t} dL_j,

the last from y and the final state depending on log_a only through
differences of its global cumsum L. The two terms of dL nearly cancel at
slow decay, so both are taken in float32 from the float32 dq and dk~,
before any rounding.

The kernels (`csrc/ssd_bwd.cuh`, every product on the tensor cores, the
float32 operands as bf16 hi + lo pairs) run it in six or seven launches:
each chunk's own contribution to the states and to the reverse carry, all
chunks in parallel (`bwd_chunk`); the carry over the chunks, elementwise,
in place (`bwd_carry`); then, when the state is one 64 x 64 tile (Mamba2's
heads), the scores and all three gradients of a chunk in one launch
(`bwd_fused`), else the scores once a chunk (`bwd_scores`) and dq, dk~ and
dv per 64 columns (`bwd_grads`); the reverse cumsum (`bwd_finish`); and
the cast of dq and dk, summing shared heads (`bwd_cast`, twice). Every sum
is in a fixed order and there are no atomics, so two runs are bit-equal.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import MODEL_NVCC_FLAGS, load_library
from repro_torch.kernels.ssd_scan import DTYPES, check_inputs

SOURCES = ("ssd_scan_bwd.cu",)
WIDE_SOURCES = ("ssd_scan_wide_bwd.cu",)
TILE = 64           # tokens a chunk and columns a tile inside the kernels
MAX_DIM = 128       # ssd_scan_bwd_cuda: the states of `ssd_scan_cuda`
WIDE_MAX_DIM = 512  # mlstm_scan_bwd_cuda: those of `ssd_scan_wide_cuda`

# Launches of the CUDA kernels, one per wrapper call; the plain versions
# never count.
launches = {"ssd_scan_bwd": 0, "mlstm_scan_bwd": 0, "ssd_scan_wide_bwd": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def shared_heads(t: torch.Tensor) -> bool:
    """Whether t (B, S, H, d) is one row per token shared by its H > 1
    heads (an expanded view, head stride 0): its gradient is the sum over
    the heads, (B, S, 1, d)."""
    return t.shape[2] > 1 and t.stride(2) == 0


def _chunks(x, c, n, dtype):
    """(B, S, ...) -> (B, n, c, ...) in dtype, zero past S."""
    x = x.to(dtype)
    pad = n * c - x.shape[1]
    if pad:
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    return x.reshape(x.shape[0], n, c, *x.shape[2:])


def ssd_scan_bwd_plain(q, k, v, log_a, beta, dy, d_state=None, *,
                       chunk=256, cut_carry=False):
    """The gradients of `linear_scan_chunked(q, k, v, log_a, beta)` at the
    cotangents dy (B, S, H, dv) and d_state (B, H, dk, dv) or None, in
    float32 math op for op as the kernels compute them (module docstring),
    over chunks of min(chunk, TILE) tokens (float64 inputs run it in
    float64, the rounding floor's reference). `cut_carry` drops the reverse
    carry between chunks (dS entering a chunk is the chunk's own term
    alone): the negative control of the checks. Returns (dq, dk, dv,
    dlog_a, dbeta) in the inputs' dtypes; dq (dk) is (B, S, 1, dk), the sum
    over the heads, where q (k) is shared by its heads."""
    f32 = torch.promote_types(q.dtype, torch.float32)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, TILE, s)
    n = -(-s // c)
    Q, K, V, DY, LA, BT = (_chunks(t, c, n, f32)
                           for t in (q, k, v, dy, log_a, beta))
    lc = LA.cumsum(2)
    lt = lc[:, :, -1]                                      # (B, n, H)
    KT = BT[..., None] * K
    w = torch.exp(lt[:, :, None] - lc)
    el = torch.exp(lc)
    # the states entering each chunk (forward) and the cotangents of those
    # leaving it (reverse)
    own = torch.einsum("bnuh,bnuhk,bnuhv->bnhkv", w, KT, V)
    S = torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
    s_in = []
    for i in range(n):
        s_in.append(S)
        S = torch.exp(lt[:, i])[..., None, None] * S + own[:, i]
    s_in = torch.stack(s_in, 1)
    loc = torch.einsum("bnth,bnthk,bnthv->bnhkv", el, Q, DY)
    dS = (torch.zeros_like(S) if d_state is None else d_state.to(f32))
    ds_out = [None] * n
    for i in reversed(range(n)):
        ds_out[i] = dS
        dS = loc[:, i] if cut_carry else (
            torch.exp(lt[:, i])[..., None, None] * dS + loc[:, i])
    ds_out = torch.stack(ds_out, 1)
    del own, loc
    # within each chunk: the decays masked before exp
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    D = torch.exp(torch.where(tri[:, :, None],
                              lc[:, :, :, None] - lc[:, :, None],
                              float("-inf")))              # (B, n, t, u, H)
    A = torch.einsum("bnthv,bnuhv->bntuh", DY, V) * D
    dq = (torch.einsum("bntuh,bnuhk->bnthk", A, KT)
          + el[..., None] * torch.einsum("bnthv,bnhkv->bnthk", DY, s_in))
    dkt = (torch.einsum("bntuh,bnthk->bnuhk", A, Q)
           + w[..., None] * torch.einsum("bnuhv,bnhkv->bnuhk", V, ds_out))
    del A
    G = torch.einsum("bnthk,bnuhk->bntuh", Q, KT) * D
    dvv = (torch.einsum("bntuh,bnthv->bnuhv", G, DY)
           + w[..., None] * torch.einsum("bnuhk,bnhkv->bnuhv", KT, ds_out))
    del G, D, s_in, ds_out
    dbeta = (K * dkt).sum(-1)                              # (B, n, c, H)
    dL = (Q * dq).sum(-1) - BT * dbeta
    dL = dL.reshape(b, n * c, h)[:, :s]
    if d_state is not None:
        dL = dL.clone()
        dL[:, s - 1] += (d_state.to(f32) * S).sum((-2, -1))
    dlog_a = dL.flip(1).cumsum(1).flip(1)

    def seq(x):
        return x.reshape(b, n * c, *x.shape[3:])[:, :s]
    dq, dk_, dvv = seq(dq), seq(BT[..., None] * dkt), seq(dvv)
    if shared_heads(q):
        dq = dq.sum(2, keepdim=True)
    if shared_heads(k):
        dk_ = dk_.sum(2, keepdim=True)
    return (dq.to(q.dtype), dk_.to(k.dtype), dvv.to(v.dtype),
            dlog_a.to(log_a.dtype), seq(dbeta).to(beta.dtype))


def _with_ones(v, x):
    """v (B, S, H, dv) with x (B, S, H, 1) beside it as column dv."""
    return torch.cat([v, x.to(v.dtype)], dim=-1)


def mlstm_scan_bwd_plain(q, k, v, log_a, beta, dy, dnm, dC=None, dn=None, *,
                         chunk=256, cut_carry=False):
    """The gradients of `ssd_scan_wide.mlstm_scan_plain` (the memory's scan
    of v and the normaliser's of ones) at the cotangents dy, dnm (B, S, H,
    1), dC (B, H, dk, dv) and dn (B, H, dk, 1), each None for zero: the
    two scans' gradients summed. They share q, k, log_a and beta, so they
    are one scan of [v | 1] at [dy | dnm] and [dC | dn], as the kernel
    computes them. Returns (dq, dk, dv, dlog_a, dbeta)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    ones = torch.ones((b, s, h, 1), dtype=v.dtype, device=v.device)
    dy = torch.zeros_like(v) if dy is None else dy
    dnm = torch.zeros_like(ones) if dnm is None else dnm
    d_state = None
    if dC is not None or dn is not None:
        zc = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                         device=q.device)
        d_state = torch.cat([zc if dC is None else dC.float(),
                             zc[..., :1] if dn is None else dn.float()], -1)
    dq, dk_, dvx, dla, db = ssd_scan_bwd_plain(
        q, k, _with_ones(v, ones), log_a, beta, _with_ones(dy, dnm),
        d_state, chunk=chunk, cut_carry=cut_carry)
    return dq, dk_, dvx[..., :dv], dla, db


# ------------------------------------------------------------ the kernels

def _bind(fn):
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel_lib():
    return _bind(load_library("ssd_scan_bwd", SOURCES,
                              MODEL_NVCC_FLAGS).ssd_scan_bwd)


def _wide_kernel_lib():
    return _bind(load_library("ssd_scan_wide_bwd", WIDE_SOURCES,
                              MODEL_NVCC_FLAGS).mlstm_scan_bwd)


def fused(dk, dv, normaliser=False) -> bool:
    """Whether the state (dk x dv, plus the normaliser's column) is one
    64 x 64 tile: the scores and gradients then take one launch."""
    return dk <= TILE and dv + int(normaliser) <= TILE


def kernel_launches(dk, dv, normaliser=False) -> tuple:
    """The names of the kernels one call launches (`csrc/ssd_bwd.cuh`'s
    `bwd_<name>`), in order."""
    grads = (("fused",) if fused(dk, dv, normaliser)
             else ("scores", "grads"))
    return ("chunk", "carry", *grads, "finish", "cast")


def scratch_numel(b, s, h, dk, dv, chunk, normaliser=False) -> dict:
    """Elements of each float32 scratch buffer of one call. `s_in` and
    `ds_out` hold a slot of 64 x 64 floats per (row, chunk, 64 x 64 tile of
    the dk x dvx state, dvx = dv + 1 with the normaliser): first each
    chunk's own contribution, then the image (bf16 hi and lo panels) of the
    state entering the chunk and of the cotangent leaving it; after its
    slots `s_in` holds the scores' images (A and G, 2 x 64 x 64 floats per
    (row, chunk)) unless the state is one tile, and `ds_out` each chunk's
    total log decay. Then dq and dk~ scaled by beta before the cast (B, S,
    H, dk each), the partial q . dq and k . dk~ rows (one per 64 columns of
    dk) and the partial <d_state, S_final> (one per tile)."""
    c = min(chunk, TILE, s)
    n = -(-s // c)
    dvx = dv + int(normaliser)
    ks, vs = -(-dk // TILE), -(-dvx // TILE)
    rn = b * h * n
    states = rn * ks * vs * TILE * TILE
    scores = 0 if fused(dk, dv, normaliser) else rn * 2 * TILE * TILE
    return {"s_in": states + scores, "ds_out": states + rn,
            "dq": b * s * h * dk, "dk": b * s * h * dk,
            "dl": b * h * ks * s, "db": b * h * ks * s,
            "fin": b * h * ks * vs}


def _check_bwd(name, q, k, v, log_a, beta, dy, extra, max_dim, why):
    check_inputs(name, q, k, v, log_a, beta, 1, max_dim, why)
    if dy.shape != v.shape or dy.dtype != v.dtype or dy.stride(-1) != 1 \
            or dy.device != q.device:
        raise ValueError(f"{name}: dy like v with a unit last stride; got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    for t, shape in extra:
        if t is not None and (tuple(t.shape) != shape or t.device != q.device
                              or t.dtype not in (torch.float32, v.dtype)):
            raise ValueError(f"{name}: expected {shape} on {q.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(fn, q, k, v, log_a, beta, dy, dnm, d_state, dn, chunk,
            normaliser, cut_carry=False):
    """One call of the kernels; returns (dq, dk, dv, dlog_a, dbeta)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, TILE, s)
    sizes = scratch_numel(b, s, h, dk, dv, c, normaliser)
    f32 = dict(dtype=torch.float32, device=q.device)
    scratch = {key: torch.empty((max(m, 1),), **f32)
               for key, m in sizes.items()}
    sq, sk = shared_heads(q), shared_heads(k)
    dq = torch.empty((b, s, 1 if sq else h, dk), dtype=q.dtype,
                     device=q.device)
    dk_ = torch.empty((b, s, 1 if sk else h, dk), dtype=k.dtype,
                      device=q.device)
    dvv = torch.empty((b, s, h, dv), dtype=v.dtype, device=q.device)
    dla = torch.empty((b, s, h), **f32)
    db = torch.empty((b, s, h), **f32)
    d_state = None if d_state is None else d_state.float().contiguous()
    dn = None if dn is None else dn.float().contiguous()
    ptrs = [q, k, v, dy, dnm, log_a, beta, d_state, dn,
            *(scratch[key] for key in ("s_in", "ds_out", "dq", "dk", "dl",
                                       "db", "fin")),
            dq, dk_, dvv, dla, db]
    dnm_strides = dnm.stride()[:3] if dnm is not None else (0, 0, 0)
    dims = [b, s, h, dk, dv, c, int(normaliser), int(cut_carry), int(sq),
            int(sk), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dy.stride()[:3], *dnm_strides, *log_a.stride(),
            *beta.stride(), *(sizes[key] for key in (
                "s_in", "ds_out", "dq", "dk", "dl", "db", "fin"))]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn((ctypes.c_ulonglong * len(ptrs))(
                    *(0 if t is None else t.data_ptr() for t in ptrs)),
                (ctypes.c_longlong * len(dims))(*dims), DTYPES[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"SSD backward launch failed: CUDA error {rc}")
    return dq, dk_, dvv, dla, db


def ssd_scan_bwd_cuda(q, k, v, log_a, beta, dy, d_state=None, *, chunk=256,
                      cut_carry=False):
    """The backward of `ssd_scan.ssd_scan_cuda` at its inputs and the
    cotangents dy (like v) and d_state ((B, H, dk, dv) float32, or None
    for zero): q, k, v one dtype (float32 or bfloat16) with a unit last
    stride, log_a and beta float32, dk, dv <= 128 (`MAX_DIM`). Chunks of
    min(chunk, 64) tokens. `cut_carry` launches the kernels with the
    reverse carry between chunks cut (a negative control only). One call
    counts one launch of "ssd_scan_bwd". Returns (dq, dk, dv, dlog_a,
    dbeta) as `ssd_scan_bwd_plain` does."""
    _check_bwd("ssd_scan_bwd_cuda", q, k, v, log_a, beta, dy,
               [(d_state, (q.shape[0], q.shape[2], q.shape[3], v.shape[3]))],
               MAX_DIM, "the states of ssd_scan_cuda; wider ones go to "
               "ssd_scan_wide_bwd_cuda")
    out = _launch(_kernel_lib(), q, k, v, log_a, beta, dy, None, d_state,
                  None, chunk, False, cut_carry)
    launches["ssd_scan_bwd"] += 1
    return out


def mlstm_scan_bwd_cuda(q, k, v, log_a, beta, dy, dnm, dC=None, dn=None, *,
                        chunk=256, cut_carry=False):
    """The backward of `ssd_scan_wide.mlstm_scan_cuda` (the memory and the
    normaliser) in one call: cotangents dy (like v), dnm (B, S, H, 1) like
    v, dC (B, H, dk, dv) and dn (B, H, dk, 1) float32 or None for zero;
    dk, dv <= 512 (`WIDE_MAX_DIM`). One call counts one launch of
    "mlstm_scan_bwd". Returns (dq, dk, dv, dlog_a, dbeta) as
    `mlstm_scan_bwd_plain` does."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    dy = torch.zeros_like(v) if dy is None else dy
    dnm = (torch.zeros((b, s, h, 1), dtype=v.dtype, device=v.device)
           if dnm is None else dnm)
    _check_bwd("mlstm_scan_bwd_cuda", q, k, v, log_a, beta, dy,
               [(dnm, (b, s, h, 1)), (dC, (b, h, dk, dv)),
                (dn, (b, h, dk, 1))], WIDE_MAX_DIM,
               "the range the kernel is tested at")
    if dnm.dtype != v.dtype:
        raise ValueError("mlstm_scan_bwd_cuda: dnm in v's dtype")
    if dC is None and dn is not None:
        dC = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    if dn is None and dC is not None:
        dn = torch.zeros((b, h, dk, 1), dtype=torch.float32, device=q.device)
    out = _launch(_wide_kernel_lib(), q, k, v, log_a, beta, dy, dnm, dC,
                  dn, chunk, True, cut_carry)
    launches["mlstm_scan_bwd"] += 1
    return out


def ssd_scan_wide_bwd_cuda(q, k, v, log_a, beta, dy, d_state=None, *,
                           chunk=256):
    """The backward of `ssd_scan_wide.ssd_scan_wide_cuda` (dk, dv <= 512):
    the pair's kernel with the normaliser off. One call counts one launch
    of "ssd_scan_wide_bwd". Returns (dq, dk, dv, dlog_a, dbeta)."""
    _check_bwd("ssd_scan_wide_bwd_cuda", q, k, v, log_a, beta, dy,
               [(d_state, (q.shape[0], q.shape[2], q.shape[3], v.shape[3]))],
               WIDE_MAX_DIM, "the range the kernel is tested at")
    out = _launch(_wide_kernel_lib(), q, k, v, log_a, beta, dy, None,
                  d_state, None, chunk, False)
    launches["ssd_scan_wide_bwd"] += 1
    return out
