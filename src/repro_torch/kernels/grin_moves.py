"""Batched GrIn block-move gain scoring + move selection (the solver's inner
step), as a hand-written CUDA kernel and its plain PyTorch version.

For a batch of placements N (B, k, l) under affinities mu (B, k, l) and a
ladder of block sizes `sizes` (M,), the exact system-throughput change from
moving sizes[m] p-type tasks from column s to a disjoint column d is

    gain[b, m, p, s, d] = R[b, m, p, s] + A[b, m, p, d]

with (closed forms; see `repro_torch.core.throughput.delta_x_*_block`)

    A[.., j] = m * (mu[p, j] - X_j) / (c_j + m)
    R[.., j] = m * (X_j - mu[p, j]) / (c_j - m)    (c_j > m)
             = -X_j                                (c_j == m, column drains)
             = -inf                                (N[p, j] < m, infeasible)

plus -inf on the s == d diagonal. The energy objectives score the exact
E / EDP drops from the same pairwise dX and the power-rate dW (P in mu's
seat). Selection per instance: the DIRECTION (p, s, d) is the steepest m=1
move (first index among equal maxima), the SIZE the largest ladder entry
whose prefix of doubling slopes stays >= max(runner-up m=1 gain, 0).

`block_move_scores` dispatches on the tensors' device: CPU tensors take the
plain PyTorch version (`_gains_body` / `_energy_gains_body` /
`_select_body`, op for op the reference package's jnp bodies, except that
the column sums and X_sys and W_sys are summed from the left, as the kernel
sums them); CUDA tensors launch the kernel in `csrc/grin_moves.cu` or
raise.

`grin_block_solve_cuda` launches the same source's fused solver: the whole
block-move loop of `core.grin`, one warp per instance, in one launch. Its
plain version is that loop itself (`core.grin.grin_block_steps`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

_NEG = float("-inf")

# Objectives the scorer can rank moves under:
#   OBJ_X       — throughput gains.
#   OBJ_XE      — gains are still dX, but near-tied directions (within
#                 _XE_TIE float32 resolution) break toward the larger energy
#                 drop: "max-X subject to energy" move selection.
#   OBJ_E       — gains are E[E] drops (eq. 19): min-energy descent.
#   OBJ_EDP     — gains are EDP drops (eq. 21): min-EDP descent.
#   OBJ_E_GUARD — E drops restricted to moves whose dX stays within the
#                 _XE_TIE band of zero: the X-plateau energy polish that
#                 follows an OBJ_XE solve (grin-e phase 2).
OBJ_X, OBJ_XE, OBJ_E, OBJ_EDP, OBJ_E_GUARD = 0, 1, 2, 3, 4
_XE_TIE = 4e-6          # float32 near-tie band, matches grin._TOL32

# Launches of the CUDA kernels (one per call on CUDA tensors); the plain
# versions never count.
launches = {"block_move_gains": 0, "grin_solve": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _gains_body(N, mu, sizes):
    """N, mu (B, k, l) float32; sizes (M,) float32 -> gain (B, M, k, l, l)."""
    l = N.shape[-1]
    colsum = _column_sums(N)                             # (B, l)
    w = _column_sums(mu * N)                             # (B, l)
    X = torch.where(colsum > 0, w / torch.clamp(colsum, min=1.0), 0.0)
    m = sizes[None, :, None, None]                       # (1, M, 1, 1)
    cb = colsum[:, None, None, :]                        # (B, 1, 1, l)
    Xb = X[:, None, None, :]
    mub = mu[:, None, :, :]                              # (B, 1, k, l)
    add = m * (mub - Xb) / (cb + m)                      # (B, M, k, l)
    rem = torch.where(cb - m > 0.5,
                      m * (Xb - mub) / torch.clamp(cb - m, min=1.0), -Xb)
    rem = torch.where(N[:, None, :, :] >= m, rem, _NEG)  # infeasible removes
    gain = rem[..., :, None] + add[..., None, :]         # (B, M, k, l, l)
    eye = torch.eye(l, dtype=torch.bool, device=N.device)[None, None, None]
    return torch.where(eye, _NEG, gain)


def _left_sum(t):
    """t summed over its last axis from the left, the order the kernel sums
    in (a library reduction may pair the terms otherwise, and an ulp of a
    column's X or of X_sys moves near-ties)."""
    s = t[..., 0]
    for j in range(1, t.shape[-1]):
        s = s + t[..., j]
    return s


def _column_sums(t):
    """(B, k, l) -> (B, l): each column summed over the rows from the top,
    as the kernel sums it."""
    return _left_sum(t.transpose(-1, -2))


def _energy_gains_body(N, mu, P, sizes, objective):
    """Energy-aware gain scoring: (gain (B, M, k, l, l), tie | None).

    W_j = sum_i N_ij P_ij / c_j has X_j's ratio-of-sums shape, so with the
    pairwise dX and dW the exact objective deltas are

        dE   = (W + dW) / (X + dX) - W / X                      (eq. 19)
        dEDP = ntot * ((W + dW) / (X + dX)^2 - W / X^2)         (eq. 21)

    and gains are the NEGATED deltas (drops). Infeasible moves (src short of
    m tasks, s == d, or a move that drains the system) score -inf."""
    l = N.shape[-1]
    colsum = _column_sums(N)                             # (B, l)
    wx = _column_sums(mu * N)
    wp = _column_sums(P * N)
    X = torch.where(colsum > 0, wx / torch.clamp(colsum, min=1.0), 0.0)
    W = torch.where(colsum > 0, wp / torch.clamp(colsum, min=1.0), 0.0)
    Xs = _left_sum(X)[:, None, None, None, None]         # (B, 1, 1, 1, 1)
    Ws = _left_sum(W)[:, None, None, None, None]
    ntot = _left_sum(colsum)[:, None, None, None, None]
    m = sizes[None, :, None, None]                       # (1, M, 1, 1)
    cb = colsum[:, None, None, :]                        # (B, 1, 1, l)

    def add_rem(Mb, Sb):
        add = m * (Mb - Sb) / (cb + m)
        rem = torch.where(cb - m > 0.5,
                          m * (Sb - Mb) / torch.clamp(cb - m, min=1.0), -Sb)
        return add, rem

    addx, remx = add_rem(mu[:, None, :, :], X[:, None, None, :])
    addw, remw = add_rem(P[:, None, :, :], W[:, None, None, :])
    dX = remx[..., :, None] + addx[..., None, :]         # (B, M, k, l, l)
    dW = remw[..., :, None] + addw[..., None, :]
    eye = torch.eye(l, dtype=torch.bool, device=N.device)[None, None, None]
    feas = (N[:, None, :, :] >= m)[..., :, None] & ~eye
    X1 = Xs + dX
    ok = feas & (X1 > 0) & (Xs > 0)
    e_drop = torch.where(ok, Ws / torch.clamp(Xs, min=1e-30)
                         - (Ws + dW) / torch.clamp(X1, min=1e-30), _NEG)
    if objective == OBJ_XE:
        return torch.where(feas, dX, _NEG), e_drop
    if objective == OBJ_E:
        return e_drop, None
    if objective == OBJ_EDP:
        return torch.where(ok, ntot * (
            Ws / torch.clamp(Xs * Xs, min=1e-30)
            - (Ws + dW) / torch.clamp(X1 * X1, min=1e-30)), _NEG), None
    if objective == OBJ_E_GUARD:
        return torch.where(dX >= -_XE_TIE * (1.0 + Xs), e_drop, _NEG), None
    raise ValueError(f"unknown objective {objective!r}")


def _select_body(gain, tie=None):
    """Move selection on a (B, M, k, l, l) gain tensor whose sizes axis is
    the DESCENDING doubling ladder (2^(M-1), ..., 2, 1). Returns (best_idx
    int32, best_gain, base_gain).

    Direction (p, s, d): the steepest m=1 move (first flat index among
    equal maxima); with a `tie` tensor (OBJ_XE) the best tie score among
    directions whose m=1 gain sits within the _XE_TIE band of the steepest.
    Size: the largest ladder entry whose whole prefix of doubling slopes
    stays >= max(runner-up m=1 gain, 0), where the runner-up masks only the
    chosen direction. base_gain is the steepest m=1 gain — the convergence
    signal."""
    b, msz = gain.shape[:2]
    dirs = gain.shape[2] * gain.shape[3] * gain.shape[4]
    g1 = gain[:, -1].reshape(b, dirs)                    # m=1 slice
    base = g1.max(dim=1).values
    if tie is None:
        d1 = torch.argmax(g1, dim=1)
    else:
        near = g1 >= (base - _XE_TIE * (1.0 + base.abs()))[:, None]
        d1 = torch.argmax(torch.where(near, tie[:, -1].reshape(b, dirs),
                                      _NEG), dim=1)
    col = torch.arange(dirs, device=gain.device)[None, :]
    runner = torch.where(col == d1[:, None], _NEG, g1).max(dim=1).values
    thresh = torch.clamp(runner, min=0.0)
    gd = gain.reshape(b, msz, dirs)
    gsel = gd.gather(2, d1[:, None, None].expand(b, msz, 1))[..., 0]
    gasc = gsel.flip(1)                                  # sizes 1, 2, 4, ...
    sizes_asc = 2.0 ** torch.arange(msz, dtype=torch.float32,
                                    device=gain.device)
    prev_g = torch.cat([torch.zeros((b, 1), dtype=gasc.dtype,
                                    device=gain.device), gasc[:, :-1]], dim=1)
    prev_s = torch.cat([torch.zeros(1, device=gain.device), sizes_asc[:-1]])
    slope = (gasc - prev_g) / (sizes_asc - prev_s)[None, :]
    ok = slope >= thresh[:, None]         # infeasible -> -inf/nan -> False
    prefix = torch.cumprod(ok.to(torch.int32), dim=1).bool()
    idx_asc = torch.clamp(prefix.sum(dim=1) - 1, min=0)
    best = gasc.gather(1, idx_asc[:, None])[:, 0]
    mi = (msz - 1) - idx_asc
    idx = (mi * dirs + d1).to(torch.int32)
    return idx, best, base


def block_move_scores_reference(N, mu, sizes, *, return_gains=True, P=None,
                                objective=OBJ_X):
    """The plain PyTorch version of the kernel, on any device (the card's
    comparison and the CPU path)."""
    if objective == OBJ_X:
        gains, tie = _gains_body(N, mu, sizes), None
    else:
        gains, tie = _energy_gains_body(N, mu, P, sizes, objective)
    bi, bg, base = _select_body(gains, tie)
    return (gains.reshape(gains.shape[0], -1) if return_gains else None,
            bi, bg, base)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/grin_moves.cu), bound through a plain C entry point.
# ---------------------------------------------------------------------------

SOURCES = ("grin_moves.cu",)
_P = ctypes.c_void_p
_I = ctypes.c_int


MAX_SIZES = 32          # ladder entries: one a lane in the kernel
_SOLVE_WARPS = 4        # instances a block (WARPS in csrc/grin_moves.cu)
_SMEM_LIMIT = 48 * 1024  # static shared memory a launch may ask for


def check_solve_shape(k: int, l: int) -> None:
    """Raise unless a (k, l) instance fits the CUDA kernels, as their C
    entry points check it: the block's shared memory, WARPS * (3*k*l + 3*l)
    float32s, within 48 KB, and k*l*l < 2^22 (the directions the kernel
    decodes with exact float reciprocals)."""
    if k * l * l >= 1 << 22:
        raise ValueError(f"a ({k}, {l}) instance has k*l*l = {k * l * l} "
                         f"move directions; the GrIn kernels take < 2^22")
    smem = _SOLVE_WARPS * (3 * k * l + 3 * l) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a ({k}, {l}) instance needs {smem} bytes of shared "
                         f"memory a block; the GrIn kernels take at most "
                         f"{_SMEM_LIMIT}")


def _kernel_lib():
    lib = load_library("grin_moves", SOURCES)
    fn = lib.grin_block_move_scores
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _solve_lib():
    fn = load_library("grin_moves", SOURCES).grin_block_solve
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _check_inputs(ins, shape):
    """Every (name, tensor) a contiguous float32 CUDA tensor on the first
    one's device; mu and P of `shape`."""
    dev = ins[0][1].device
    for name, t in ins:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if name in ("mu", "P") and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got "
                             f"{tuple(t.shape)}")


def block_move_gains_cuda(N, mu, sizes, *, return_gains=True, P=None,
                          objective=OBJ_X):
    """Launch the CUDA kernel on the current stream: (gains (B, F) | None,
    best_idx int32 (B,), best_gain (B,), base_gain (B,)). Inputs must be
    contiguous float32 CUDA tensors: N, mu (and P for energy objectives)
    (B, k, l), sizes (M,) descending with sizes[-1] == 1."""
    if objective not in (OBJ_X, OBJ_XE, OBJ_E, OBJ_EDP, OBJ_E_GUARD):
        raise ValueError(f"unknown objective {objective!r}")
    if N.dim() != 3:
        raise ValueError(f"N must be (B, k, l); got {tuple(N.shape)}")
    b, k, l = N.shape
    ins = [("N", N), ("mu", mu), ("sizes", sizes)]
    if objective != OBJ_X:
        if P is None:
            raise ValueError("energy objectives need the power matrix P")
        ins.append(("P", P))
    _check_inputs(ins, (b, k, l))
    if sizes.dim() != 1 or not 1 <= sizes.numel() <= MAX_SIZES:
        raise ValueError(f"sizes must be a (M,) ladder, 1 <= M <= "
                         f"{MAX_SIZES}")
    msz = sizes.numel()
    f = msz * k * l * l
    dev = N.device
    gains = (torch.empty((b, f), dtype=torch.float32, device=dev)
             if return_gains else None)
    bi = torch.empty(b, dtype=torch.int32, device=dev)
    bg = torch.empty(b, dtype=torch.float32, device=dev)
    base = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return gains, bi, bg, base
    fn = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(N.data_ptr(), mu.data_ptr(),
                 P.data_ptr() if objective != OBJ_X else None,
                 sizes.data_ptr(),
                 gains.data_ptr() if return_gains else None,
                 bi.data_ptr(), bg.data_ptr(), base.data_ptr(),
                 b, k, l, msz, objective, stream)
    if err != 0:
        raise RuntimeError(f"grin_block_move_scores launch failed: CUDA "
                           f"error {err}")
    launches["block_move_gains"] += 1
    return gains, bi, bg, base


def grin_block_solve_cuda(N0, mu, sizes, cap, *, P=None, objective=OBJ_X):
    """The whole block-move solve in one launch of the fused kernel, on the
    current stream, with no host sync: from the initial placements N0
    (B, k, l) under mu (and P for the energy objectives), the steps of
    `core.grin.grin_block_steps` per instance until no move clears the
    convergence threshold or `cap` steps; OBJ_XE runs its energy phase
    (OBJ_E_GUARD, its own cap) in the same launch. Inputs are contiguous
    float32 CUDA tensors, sizes (M,) descending with sizes[-1] == 1.
    Returns (N (B, k, l), converged (B,) bool, moves (B,) int32)."""
    if objective not in (OBJ_X, OBJ_XE, OBJ_E, OBJ_EDP):
        raise ValueError(f"the fused solve takes OBJ_X, OBJ_XE, OBJ_E or "
                         f"OBJ_EDP; got {objective!r}")
    if N0.dim() != 3:
        raise ValueError(f"N0 must be (B, k, l); got {tuple(N0.shape)}")
    b, k, l = N0.shape
    check_solve_shape(k, l)
    ins = [("N0", N0), ("mu", mu), ("sizes", sizes)]
    if objective != OBJ_X:
        if P is None:
            raise ValueError("energy objectives need the power matrix P")
        ins.append(("P", P))
    _check_inputs(ins, (b, k, l))
    if sizes.dim() != 1 or not 1 <= sizes.numel() <= MAX_SIZES:
        raise ValueError(f"sizes must be a (M,) ladder, 1 <= M <= "
                         f"{MAX_SIZES}")
    if int(cap) < 0:
        raise ValueError(f"cap must be >= 0; got {cap}")
    dev = N0.device
    N = N0.clone()
    moves = torch.zeros(b, dtype=torch.int32, device=dev)
    conv = torch.zeros(b, dtype=torch.int32, device=dev)
    if b == 0:
        return N, conv.bool(), moves
    fn = _solve_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(N.data_ptr(), mu.data_ptr(),
                 P.data_ptr() if objective != OBJ_X else None,
                 sizes.data_ptr(), moves.data_ptr(), conv.data_ptr(),
                 b, k, l, sizes.numel(), int(cap), objective, stream)
    if err != 0:
        raise RuntimeError(f"grin_block_solve launch failed: CUDA error "
                           f"{err}")
    launches["grin_solve"] += 1
    return N, conv.bool(), moves


def block_move_scores(N, mu, sizes, *, return_gains: bool = True, P=None,
                      objective: int = OBJ_X):
    """Score every (block size, type, src, dst) move for a batch of states
    and select the next move per instance.

    `sizes` must be DESCENDING with sizes[-1] == 1 (the solver's doubling
    ladder). Returns (gains (B, F) | None, best_idx (B,) int32, best_gain
    (B,), base_gain (B,)): best_idx indexes the flattened (M, k, l, l)
    tensor at the selected move and base_gain is the steepest m=1 gain —
    the convergence signal. All energy objectives need `P` (B, k, l).
    Tensors on the CPU take the plain PyTorch version; CUDA tensors launch
    the kernel (or raise)."""
    if objective != OBJ_X and P is None:
        raise ValueError("energy objectives need the power matrix P")
    if N.device.type == "cuda":
        return block_move_gains_cuda(N, mu, sizes, return_gains=return_gains,
                                     P=P, objective=objective)
    if N.device.type != "cpu":
        raise ValueError(f"unsupported device {N.device}")
    return block_move_scores_reference(N, mu, sizes,
                                       return_gains=return_gains, P=P,
                                       objective=objective)
