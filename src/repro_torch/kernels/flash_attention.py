"""Causal flash attention (GQA, sliding window) as a hand-written CUDA
kernel and its plain version.

`flash_attention_cuda` launches `csrc/flash_attention.cu`, the counterpart
of the TPU kernel `flash_attention_pallas`, for bfloat16 inputs (the
serving engine's dtype); it raises on float32, which no path on the card
sends. The kernel is written for Hopper: TMA loads q, k and v through
tensor maps into a shared-memory ring that one producer warpgroup keeps
filled, and two consumer warpgroups run `wgmma` for Q K^T and P V with the
softmax in between (float32). It reads the model layout (B, S, heads, dh)
in place through strides and writes a contiguous bfloat16 (B, Sq, H, dh)
output. The plain version is `models.attention.chunked_attention`, the
online-softmax recurrence in PyTorch. The public entry point is
`kernels.ops.flash_attention`, which picks one by the tensor's device.

What the kernel is told lives in plain functions on shapes and strides, so
that the CPU tests reach it: `tensor_map` (dims, strides in bytes and box
of each TMA map), `padded_head_dim` and `check_inputs` (what the kernel
refuses). What the kernel decides itself, its ring depth and which (batch,
head, q tile) each block takes, is read from the built library
(`kernel_tiles`, `block_tile`).

The gradient. `flash_attention_cuda(..., return_lse=True)` also stores each
row's log-sum-exp (B, H, Sq) float32; serving passes a null pointer there,
so its output and its code path are the same as without it.
`flash_attention_bwd_cuda` launches `csrc/flash_attention_bwd.cu`, which
computes dq, dk and dv from q, k, v, o, the LSE and do with the FA2
formulas (P recomputed from the LSE), on the same Hopper pattern as the
forward (TMA ring, wgmma, warp specialisation), deterministically: no
atomics; a kv head's query heads are split over `bwd_plan(...)["splits"]`
blocks, whose float32 partials a last launch sums in split order. Its host
side is plain Python too: `bwd_tensor_maps` (the TMA maps of q, k, v and
do), `bwd_plan` (the split, block counts and scratch) and
`check_bwd_inputs`. The TPU package has no backward kernel (its tests
differentiate the jnp chunked route), so this one replaces none; its plain
version is `flash_attention_bwd_plain`, the same formulas in float32 over
chunks.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import MODEL_NVCC_FLAGS, load_library
from repro_torch.models.attention import chunked_attention

SOURCES = ("flash_attention.cu",)
BWD_SOURCES = ("flash_attention_bwd.cu",)
# Instantiated in the CUDA source: the registry's head dims (112 for
# zamba2-7b, 128 for yi / qwen / granite), the reference sweep's 64 and 96,
# and 32, the reduced `smoke_config` models' (the serve CLI on a card).
HEAD_DIMS = (32, 64, 96, 112, 128)
# The rows of the kernel's TMA boxes (csrc/flash_attention.cu: kBQ, kBK;
# its entry point refuses maps with other boxes): 128 query rows per block
# (64 per consumer warpgroup), 128 keys per tile. A box is PANEL columns
# wide: 128 bytes of bfloat16, the width of the 128-byte swizzle.
BLOCK_Q, BLOCK_K, PANEL = 128, 128, 64
ELEM_BYTES = 2
_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled",
           -2: "encoding the tensor map of q failed",
           -3: "encoding the tensor map of k failed",
           -4: "encoding the tensor map of v failed",
           -5: "encoding the tensor map of do failed"}
# The backward's tiles (csrc/flash_attention_bwd.cu: kBK, kSQ, kBQ, kSK,
# kBox; its entry point refuses maps with other boxes): a dK / dV block
# takes 128 keys and steps over 64 queries, a dQ block 128 query rows and
# steps over 64 keys; every TMA box is 64 rows of PANEL columns.
BWD_BLOCK_K, BWD_BLOCK_Q, BWD_BOX = 128, 128, 64

# Launches of the CUDA kernels (the backward's three or four launches count
# once, as one call of its entry point); the plain versions never count.
launches = {"flash_attention": 0, "flash_attention_bwd": 0}
# The plan (`bwd_plan`) of the backward's last launch, as it was launched.
last_bwd_plan: dict = {}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


flash_attention_plain = chunked_attention


def _library():
    return load_library("flash_attention", SOURCES, MODEL_NVCC_FLAGS)


def _kernel_lib():
    fn = _library().flash_attention_fwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, P, P, ctypes.POINTER(ctypes.c_ulonglong)] + [
        I] * 6 + [L] * 3 + [I, I, ctypes.c_float, P]
    fn.restype = I
    return fn


def _bwd_library():
    return load_library("flash_attention_bwd", BWD_SOURCES, MODEL_NVCC_FLAGS)


def _bwd_kernel_lib():
    fn = _bwd_library().flash_attention_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 10 + [I] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_ulonglong),
        I, I, I, ctypes.c_float, P]
    fn.restype = I
    return fn


def padded_head_dim(dh: int) -> int:
    """dh as the kernel holds it in shared memory: the next multiple of the
    64-column TMA box (112 and 96 -> 128, 32 -> 64). Nothing is padded in
    device memory; the box's out-of-bounds fill gives the zeros."""
    return -(-dh // PANEL) * PANEL


def kernel_takes_strides(*tensors) -> bool:
    """True when the kernel can read these bfloat16 tensors in place: unit
    stride on dh, base pointers 16-byte aligned and the other strides
    positive multiples of 16 bytes where their extent exceeds 1 (what a
    TMA tensor map takes)."""
    for t in tensors:
        if t.stride(-1) != 1 or t.data_ptr() % 16:
            return False
        for n, s in zip(t.shape[:-1], t.stride()[:-1]):
            if n > 1 and (s <= 0 or s % 8):
                return False
    return True


def tensor_map(shape, strides, rows: int):
    """The TMA map of one (B, S, heads, dh) tensor with these element
    strides: dims (dh, heads, S, B) innermost first, the strides of heads,
    S and B in bytes, and the box (PANEL, 1, rows, 1). A dim of extent 1 is
    only read at 0, so its stride is replaced by the packed one (TMA wants
    a positive multiple of 16 bytes)."""
    b, s, h, dh = shape
    dims = (dh, h, s, b)
    out, packed = [], dh * ELEM_BYTES
    for n, st in zip((h, s, b), (strides[2], strides[1], strides[0])):
        nbytes = st * ELEM_BYTES if n > 1 else -(-packed // 16) * 16
        out.append(nbytes)
        packed = n * nbytes
    return dims, tuple(out), (PANEL, 1, rows, 1)


def tensor_maps(q, k, v) -> list[int]:
    """The 33 values the C entry point encodes its three maps from: for
    each of q, k, v its dims, strides in bytes and box (`tensor_map`)."""
    flat = []
    for t, rows in ((q, BLOCK_Q), (k, BLOCK_K), (v, BLOCK_K)):
        for part in tensor_map(tuple(t.shape), t.stride(), rows):
            flat.extend(part)
    return flat


def kernel_tiles() -> dict:
    """The built kernel's tiles: query rows per block, keys per tile and
    the depth of its K/V ring (needs nvcc)."""
    out = (ctypes.c_int * 3)()
    _library().flash_attention_tiles(out)
    return {"block_q": out[0], "block_k": out[1], "stages": out[2]}


def block_tile(block: int, n_qtiles: int, h: int, causal: bool):
    """(batch, head, q tile) that block `block` computes, as the built
    kernel decodes its flat index (needs nvcc)."""
    out = (ctypes.c_int * 3)()
    _library().flash_attention_block_tile(block, n_qtiles, h, int(causal),
                                          out)
    return tuple(out)


def check_inputs(q, k, v) -> None:
    """Raise ValueError on what the kernel does not take: shapes other than
    q (B, Sq, H, dh), k/v (B, Sk, KV, dh) with H % KV == 0; dh outside
    HEAD_DIMS; any dtype but bfloat16; strides `kernel_takes_strides`
    refuses."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_cuda: q (B, Sq, H, dh), k/v (B, "
                         f"Sk, KV, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, dh = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kv == 0 or h % kv:
        raise ValueError(f"flash_attention_cuda: incompatible shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {dh} not in "
                         f"{HEAD_DIMS}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"flash_attention_cuda takes bfloat16 q, k, v; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not kernel_takes_strides(q, k, v):
        raise ValueError("flash_attention_cuda: strides or alignment the "
                         "kernel does not take (see kernel_takes_strides)")


def flash_attention_cuda(q, k, v, *, causal=True, window=0,
                         return_lse=False):
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh); CUDA bfloat16 that
    `check_inputs` accepts. Scale 1/sqrt(dh). Returns (B, Sq, H, dh), and
    with `return_lse` also the rows' log-sum-exp (B, H, Sq) float32 (the
    same output; without it the kernel's LSE pointer is null)."""
    _on_one_card(q, k, v)
    check_inputs(q, k, v)
    b, sq, h, dh = q.shape
    _, sk, kv, _ = k.shape
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    maps = (ctypes.c_ulonglong * 33)(*tensor_maps(q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), maps,
            b, sq, sk, h, kv, dh,
            out.stride(0), out.stride(1), out.stride(2),
            int(bool(causal)), int(window), 1.0 / math.sqrt(dh), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{_ERRORS.get(rc, f'CUDA error {rc}')}")
    launches["flash_attention"] += 1
    return (out, lse) if return_lse else out


def _on_one_card(*tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the flash attention kernels take CUDA tensors on "
                         "one device")


def check_bwd_inputs(q, k, v, o, lse, do) -> None:
    """Raise ValueError on what the backward kernel does not take: q, k, v
    as `check_inputs` says, o and do bfloat16 of q's shape, lse float32
    (B, H, Sq) contiguous, and o and do with strides the kernel reads
    (`kernel_takes_strides`: do goes through a TMA map like q, k and v,
    o through its strides in 4-byte pairs)."""
    check_inputs(q, k, v)
    b, sq, h, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention_bwd_cuda: {name} must be "
                             f"bfloat16 {tuple(q.shape)}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not kernel_takes_strides(o, do):
        raise ValueError("flash_attention_bwd_cuda: strides or alignment "
                         "of o / do the kernel does not take")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq)
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd_cuda: lse must be float32 "
                         f"({b}, {h}, {sq}) contiguous; got {lse.dtype} "
                         f"{tuple(lse.shape)}")


def bwd_tensor_maps(q, k, v, do) -> list[int]:
    """The 44 values the backward's C entry point encodes its four TMA maps
    from: for each of q, k, v and do its dims, strides in bytes and box
    (`tensor_map`), every box BWD_BOX rows."""
    flat = []
    for t in (q, k, v, do):
        for part in tensor_map(tuple(t.shape), t.stride(), BWD_BOX):
            flat.extend(part)
    return flat


def bwd_plan(b, sq, sk, h, kv, dh, *, sms, splits=None) -> dict:
    """How the backward spreads its work on a card of `sms` SMs. The dK /
    dV launch has one block per (128-key tile, batch, kv head, split); a
    split takes H / KV / splits of the group's query heads. With more than
    one split the blocks write float32 partials, (2, splits, B, Sk, KV,
    dh), that one more launch sums in split order. `splits` (unless given)
    is the smallest divisor of the group that gives at least 1.5 blocks an
    SM (one block fits an SM), else the whole group: on an H100 at
    qwen2.5-3b's (1, 4096, 16 / 2, 128) 4 splits (256 blocks) ran 0.64 ms
    against 0.67 for 8 (512 blocks, twice the partials to sum) and 0.97
    for 2; at (2, 2048, 24 / 8, 64) one split (256 blocks) 0.41 ms against
    0.43 for 3 (tools/flash_bwd_variants.py). Returns the split, the block
    counts, the padded query count and the float32 scratch the wrapper
    allocates (the (lse, D) rows, then the partials) with its bytes."""
    grp = h // kv
    n_kt = -(-sk // BWD_BLOCK_K)
    base = b * kv * n_kt
    if splits is None:
        splits = next((d for d in range(1, grp + 1)
                       if grp % d == 0 and 2 * base * d >= 3 * sms),
                      max(grp, 1))
    if splits < 1 or grp % splits:
        raise ValueError(f"flash_attention_bwd: splits {splits} does not "
                         f"divide the group of {grp} query heads")
    sq_pad = -(-sq // BWD_BOX) * BWD_BOX
    ld = b * h * sq_pad * 2
    part = 2 * splits * b * sk * kv * dh if splits > 1 else 0
    return {"splits": splits, "heads_per_split": grp // splits,
            "dkdv_blocks": base * splits,
            "dq_blocks": b * h * -(-sq // BWD_BLOCK_Q), "sq_pad": sq_pad,
            "scratch_floats": ld + part, "partial_floats": part,
            "scratch_bytes": 4 * (ld + part)}


def bwd_kernel_tiles() -> dict:
    """The built backward's tiles (needs nvcc): keys per block of its dK /
    dV launch, queries per step of its ring and the ring's depth; query
    rows per block of its dQ launch, keys per step and depth; TMA box
    rows."""
    out = (ctypes.c_int * 7)()
    _bwd_library().flash_attention_bwd_tiles(out)
    return {"dkdv_block_k": out[0], "dkdv_step_q": out[1],
            "dkdv_stages": out[2], "dq_block_q": out[3], "dq_step_k": out[4],
            "dq_stages": out[5], "box_rows": out[6]}


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal=True,
                             window=0):
    """The gradient of `flash_attention_cuda` (scale 1/sqrt(dh)) at output
    gradient do: q (B, Sq, H, dh), k, v (B, Sk, KV, dh), o and do (B, Sq,
    H, dh), all CUDA bfloat16, and the forward's lse (B, H, Sq) float32.
    Returns (dq, dk, dv) bfloat16, contiguous, of q's, k's and v's shapes.
    One call of the C entry point: D = rowsum(do * o) with the LSE rows,
    then dk and dv (a block per 128-key tile of a (batch, kv head) and
    split of its query heads), the splits' fixed-order sum when there is
    more than one, then dq (a block per 128-row query tile); the split is
    `bwd_plan`'s for this card."""
    _on_one_card(q, k, v, o, lse, do)
    check_bwd_inputs(q, k, v, o, lse, do)
    b, sq, h, dh = q.shape
    _, sk, kv, _ = k.shape
    plan = bwd_plan(b, sq, sk, h, kv, dh, sms=torch.cuda
                    .get_device_properties(q.device).multi_processor_count)
    return _bwd_launch(q, k, v, o, lse, do, plan, causal, window)[:3]


def _bwd_launch(q, k, v, o, lse, do, plan, causal, window):
    """Launch the backward with `plan` (a `bwd_plan` of these shapes) on
    inputs `flash_attention_bwd_cuda` has checked. Returns (dq, dk, dv,
    scratch): scratch is the float32 buffer the kernels worked in, the
    (lse, D) rows and then, with more than one split, the partials (2,
    splits, B, Sk, KV, dh) of dk (unscaled) and dv; None when there was
    nothing to launch."""
    b, sq, h, dh = q.shape
    _, sk, kv, _ = k.shape
    dq = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, kv, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_(), None
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_longlong * 15)(*(
        st for t in (q, k, v, o, do) for st in t.stride()[:3]))
    maps = (ctypes.c_ulonglong * 44)(*bwd_tensor_maps(q, k, v, do))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bwd_kernel_lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), b, sq, sk, h, kv, dh, strides,
            maps, plan["splits"], int(bool(causal)), int(window),
            1.0 / math.sqrt(dh), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: "
                           f"{_ERRORS.get(rc, f'CUDA error {rc}')}")
    launches["flash_attention_bwd"] += 1
    last_bwd_plan.clear()
    last_bwd_plan.update(plan)
    return dq, dk, dv, scratch


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True, window=0,
                              chunk_q=1024, chunk_k=1024):
    """The kernel's backward in plain float32 torch, over (chunk_q,
    chunk_k) blocks (the pairs every row of a block has masked are
    skipped): with S = q k^T / sqrt(dh) masked as the forward masks it,
    P = exp(S - lse) (0 where masked), D = rowsum(do * o),
    dv = P^T do, dP = do v^T, dS = P * (dP - D), dq = dS k / sqrt(dh),
    dk = dS^T q / sqrt(dh), with dk and dv summed over the query heads of
    each kv head. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)                       # (B, Sq, H)
    lsef = lse.float().transpose(1, 2)                      # (B, Sq, H)
    dq = torch.zeros((b, sq, h, dh), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, sk, kv, dh), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for i0 in range(0, sq, chunk_q):
        r = min(chunk_q, sq - i0)
        qc = qf[:, i0:i0 + r].reshape(b, r, kv, g, dh)
        doc = dof[:, i0:i0 + r].reshape(b, r, kv, g, dh)
        dc = delta[:, i0:i0 + r].reshape(b, r, kv, g, 1)
        lc = lsef[:, i0:i0 + r].reshape(b, r, kv, g, 1)
        qpos = torch.arange(i0, i0 + r, device=dev)
        for j0 in range(0, sk, chunk_k):
            t = min(chunk_k, sk - j0)
            kpos = torch.arange(j0, j0 + t, device=dev)
            mask = torch.ones((r, t), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window:
                mask &= kpos[None, :] > qpos[:, None] - window
            if not bool(mask.any()):
                continue
            kc, vc = kf[:, j0:j0 + t], vf[:, j0:j0 + t]
            s = torch.einsum("bcngd,btnd->bcngt", qc, kc) * scale
            p = torch.where(mask[None, :, None, None, :], torch.exp(s - lc),
                            0.0)
            dv[:, j0:j0 + t] += torch.einsum("bcngt,bcngd->btnd", p, doc)
            dp = torch.einsum("bcngd,btnd->bcngt", doc, vc)
            ds = p * (dp - dc)
            dq[:, i0:i0 + r] += torch.einsum(
                "bcngt,btnd->bcngd", ds, kc).reshape(b, r, h, dh)
            dk[:, j0:j0 + t] += torch.einsum("bcngt,bcngd->btnd", ds, qc)
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))
