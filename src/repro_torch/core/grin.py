"""GrIn (Greedy-Increase) near-optimal placement for k task types x l
processor types (paper Sec. 4.2, Algorithms 1-2, Lemma 8).

A move relocates one p-type task from processor `src` to `dst`. Because the
two columns are disjoint, the exact throughput change is

    dX = dminus[p, src] + dplus[p, dst]

with (paper eq. 33-36, with the remove-delta sign fixed so that dminus is the
CHANGE in X_j caused by the removal — the paper's Lemma-8 prose and Algorithm 2
line 7 disagree on this sign; the math below is the self-consistent version):

    dplus[p, j]  = (mu[p, j] - X_j) / (col_j + 1)
    dminus[p, j] = (X_j - mu[p, j]) / (col_j - 1)     (col_j > 1)
                 = -mu[p, j]                          (col_j == 1, column empties)

GrIn accepts a move only when dX > 0, hence X_sys strictly increases per move
(Lemma 8) and the algorithm terminates at a local maximum. Per-sweep cost is
O(k*l) using the top-2 trick to resolve the src != dst constraint.

Block moves: relocating m same-type tasks between two disjoint columns also
has an exact closed-form delta (`delta_x_add_block`/`delta_x_remove_block`),
so a whole doubling ladder of block sizes can be scored in one vectorized
pass. Each step picks the steepest SINGLE move's direction (the same choice
plain GrIn makes) and then the gain-maximizing ladder size along it —
collapsing O(N) single moves into O(log N)-ish block moves while preserving
Lemma 8 monotonicity (every accepted block strictly increases X_sys).
Convergence is declared on the m=1 signal, so the block solver's fixed
points are exactly the single-move local maxima.

Three implementations: NumPy single-move (host scheduler), NumPy block-move
(host mirror of the device solver, with a per-move X_sys history), and
batched torch: `grin_solve_torch` (single-move steepest ascent) and
`grin_solve_batch_torch` (block-move, batched over (mu, mix) instances — the
production path for device target grids: on the card one launch of the
fused CUDA solve, on the CPU the per-step loop `grin_block_steps`, which
`grin_solve_batch_steps_torch` also runs on the card, one scorer launch a
step).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.throughput import (delta_x_add, delta_x_add_block,
                                         delta_x_remove, delta_x_remove_block,
                                         system_throughput,
                                         system_throughput_torch)

_TOL = 1e-12
# float32 solvers: accept only gains clearly above accumulated rounding
# noise (relative to X_sys), else noise-level "improvements" can 2-cycle
# forever. ~64 ULP at float32. The block solver converges at a finer
# threshold: as the production path it polishes through the gain band the
# single-move baseline stops in (still ~16 ULP above observed noise; a
# noise cycle would only burn iterations until the move cap and report
# converged=False, never corrupt the placement).
_TOL32 = 4e-6
_TOL32_BLOCK = 1e-6


def grin_init(mu: np.ndarray, n_tasks: np.ndarray) -> np.ndarray:
    """Algorithm 1: initial placement from the max-per-column structure."""
    mu = np.asarray(mu, dtype=np.float64)
    n_tasks = np.asarray(n_tasks, dtype=np.int64)
    k, l = mu.shape
    N = np.zeros((k, l), dtype=np.int64)
    # U: 1 at the row achieving the max of each column.
    top_row = np.argmax(mu, axis=0)
    for row in range(k):
        cols = np.where(top_row == row)[0]
        left = int(n_tasks[row])
        if left == 0:
            continue
        if len(cols) > 1:
            # One task to each claimed column (fastest first), remainder to the
            # slowest claimed column (Alg. 1 lines 6-13).
            order = cols[np.argsort(-mu[row, cols])]
            for c in order:
                if left == 0:
                    break
                N[row, c] += 1
                left -= 1
            N[row, order[-1]] += left
        elif len(cols) == 1:
            N[row, cols[0]] = left
        else:
            # Row claims no column: start from its best-fit processor; the
            # greedy loop redistributes (Alg. 1 lines 18-21).
            N[row, int(np.argmax(mu[row]))] = left
    return N


def _best_move_for_row(N: np.ndarray, mu: np.ndarray, p: int):
    """Best (gain, src, dst) move of one p-type task; gain may be <= 0."""
    dplus = delta_x_add(N, mu, p)
    dminus = delta_x_remove(N, mu, p)  # +inf where N[p, j] == 0? -> -inf there
    feas = N[p] > 0
    if not feas.any():
        return 0.0, -1, -1
    dminus = np.where(feas, dminus, -np.inf)
    # top-2 of each to satisfy src != dst in O(l)
    src_order = np.argsort(-dminus)[:2]
    dst_order = np.argsort(-dplus)[:2]
    best = (-np.inf, -1, -1)
    for s in src_order:
        if not np.isfinite(dminus[s]):
            continue
        for d in dst_order:
            if s == d:
                continue
            gain = dminus[s] + dplus[d]
            if gain > best[0]:
                best = (gain, int(s), int(d))
    return best


@dataclasses.dataclass
class GrInResult:
    N: np.ndarray
    x_sys: float
    moves: int
    sweeps: int


def grin_solve(mu: np.ndarray, n_tasks: np.ndarray,
               max_sweeps: int = 10_000) -> GrInResult:
    """Algorithm 2 with repeated row sweeps until a local maximum."""
    mu = np.asarray(mu, dtype=np.float64)
    n_tasks = np.asarray(n_tasks, dtype=np.int64)
    k, _ = mu.shape
    N = grin_init(mu, n_tasks)
    moves = 0
    sweeps = 0
    while sweeps < max_sweeps:
        sweeps += 1
        moved = False
        for p in range(k):
            gain, src, dst = _best_move_for_row(N, mu, p)
            if src >= 0 and gain > _TOL:
                N[p, src] -= 1
                N[p, dst] += 1
                moves += 1
                moved = True
        if not moved:
            break
    return GrInResult(N=N, x_sys=system_throughput(N, mu), moves=moves,
                      sweeps=sweeps)


_LADDER_CAP = 24        # 2^23 tasks: far above any closed population here


def _ladder(total: int) -> list[int]:
    """Doubling ladder of block sizes covering populations up to `total`,
    LARGEST FIRST so first-occurrence argmax ties prefer the biggest block."""
    n_sizes = max(1, min(_LADDER_CAP, int(np.ceil(np.log2(max(total, 2))))
                         + 1))
    return [1 << i for i in range(n_sizes - 1, -1, -1)]


@dataclasses.dataclass
class GrInBlockResult:
    N: np.ndarray
    x_sys: float
    moves: int
    converged: bool
    history: list       # X_sys after each accepted block move (monotone)


def grin_block_solve(mu: np.ndarray, n_tasks: np.ndarray,
                     max_moves: int = 100_000) -> GrInBlockResult:
    """Host block-move GrIn, mirroring the device solver's selection rule:
    the move DIRECTION (p, src, dst) is the steepest single move (identical
    to plain GrIn's choice, so the trajectory is a conservative acceleration
    of the single-move one) and the block SIZE is the largest doubling-
    ladder entry whose prefix of doubling slopes (average marginal gain per
    size-doubling) stays >= max(second-best single-move gain, 0) — the
    run-length guard that stops a block from overshooting past the point
    where the single-move path would have switched direction.

    Terminates when no single move improves — the same fixed-point class as
    Algorithm 2 — and records X_sys after every accepted block move, pinning
    the Lemma-8 monotonicity property in tests.
    """
    mu = np.asarray(mu, dtype=np.float64)
    n_tasks = np.asarray(n_tasks, dtype=np.int64)
    k, l = mu.shape
    N = grin_init(mu, n_tasks)
    sizes = _ladder(int(n_tasks.sum()))[::-1]     # ascending: 1, 2, 4, ...
    history: list[float] = []
    moves = 0
    converged = False
    while moves < max_moves:
        best = (-np.inf, -1, -1, -1)              # m=1 gain, p, src, dst
        runner = -np.inf
        for p in range(k):
            if not (N[p] >= 1).any():
                continue
            dplus = delta_x_add_block(N, mu, p, 1)
            dminus = np.where(N[p] >= 1, delta_x_remove_block(N, mu, p, 1),
                              -np.inf)
            gain = dminus[:, None] + dplus[None, :]
            np.fill_diagonal(gain, -np.inf)
            flat = np.sort(gain, axis=None)
            if flat[-1] > best[0]:
                runner = max(runner, best[0], flat[-2])
                idx = int(np.argmax(gain))
                best = (flat[-1], p, idx // l, idx % l)
            else:
                runner = max(runner, flat[-1])
        gain, p, src, dst = best
        if gain <= _TOL:
            converged = True
            break
        thresh = max(runner, 0.0)
        m_best, g_best, g_prev, m_prev = 1, gain, gain, 1
        for m in sizes[1:]:                       # ascending from 2
            if N[p, src] < m:
                break
            g_m = (delta_x_remove_block(N, mu, p, m)[src]
                   + delta_x_add_block(N, mu, p, m)[dst])
            if (g_m - g_prev) / (m - m_prev) < thresh:
                break
            m_best, g_best = m, g_m
            g_prev, m_prev = g_m, m
        N[p, src] -= m_best
        N[p, dst] += m_best
        moves += 1
        history.append(system_throughput(N, mu))
    return GrInBlockResult(N=N, x_sys=system_throughput(N, mu), moves=moves,
                           converged=converged, history=history)


# ---------------------------------------------------------------------------
# Batched torch GrIn: the device production path. On the card the block
# solver is one launch of the fused kernel: each instance runs to its own
# convergence in its own warp. The per-step loops below advance a whole
# (mu, mix) batch by one move per instance per iteration; converged
# instances carry a mask so they stop mutating (and stop counting moves)
# while the rest of the batch drains. They couple instances only through
# "is any instance still moving": reading that flag waits for the device,
# so it is read every _SYNC_EVERY steps — the masked extra steps change
# nothing.
# ---------------------------------------------------------------------------

_SYNC_EVERY = 8


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx, n).to(torch.float32)


def _grin_init_torch(mus: torch.Tensor, mixes: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 init, batched: mus (B, k, l), mixes (B, k) -> (B, k, l)
    float32 placements."""
    _, k, l = mus.shape
    top_row = torch.argmax(mus, dim=1)                        # (B, l)
    claims = top_row[:, None, :] == torch.arange(
        k, device=mus.device)[None, :, None]                  # (B, k, l)
    n_claimed = claims.sum(dim=2)                             # (B, k)
    # Rows with no claim fall back to their best-fit column.
    bf = torch.nn.functional.one_hot(torch.argmax(mus, dim=2), l).bool()
    eff = torch.where((n_claimed == 0)[..., None], bf, claims)
    # Seed one task on every claimed column, remainder on the slowest claimed.
    slowest = torch.argmin(torch.where(eff, mus, torch.inf), dim=2)  # (B, k)
    nt = mixes.to(torch.float32)
    # Seed at most n_tasks[row] ones per row over claimed columns, fastest
    # first (stable sorts: the ±inf ties keep column order); the remainder
    # goes to the slowest claimed column (Alg. 1).
    order = torch.argsort(-torch.where(eff, mus, -torch.inf), dim=2,
                          stable=True)
    rank_of_col = torch.argsort(order, dim=2, stable=True).to(torch.float32)
    seed = (eff & (rank_of_col < nt[..., None])).to(torch.float32)
    rem = nt - seed.sum(dim=2)
    return seed + _one_hot(slowest, l) * rem[..., None]


def _deltas_torch(N: torch.Tensor, mu: torch.Tensor):
    """Single-move add/remove deltas (eq. 33-36), batched (B, k, l)."""
    colsum = N.sum(dim=1)[:, None, :]                         # (B, 1, l)
    X = torch.where(colsum > 0, (mu * N).sum(dim=1, keepdim=True)
                    / torch.clamp(colsum, min=1.0), 0.0)
    dplus = (mu - X) / (colsum + 1.0)
    dm_reg = (X - mu) / torch.clamp(colsum - 1.0, min=1.0)
    dminus = torch.where(colsum <= 1, -mu, dm_reg)
    return dplus, torch.where(N > 0, dminus, -torch.inf)     # infeasible


def _grin_single_core(mus: torch.Tensor, mixes: torch.Tensor,
                      cap: torch.Tensor):
    """Single-move steepest ascent over a batch; cap (B,) int32 move caps.
    Returns (N, converged, moves)."""
    B, k, l = mus.shape
    N = _grin_init_torch(mus, mixes)
    eye = torch.eye(l, dtype=torch.bool, device=mus.device)
    improved = torch.ones(B, dtype=torch.bool, device=mus.device)
    moves = torch.zeros(B, dtype=torch.int32, device=mus.device)
    it = 0
    while True:
        active = improved & (moves < cap)
        dplus, dminus = _deltas_torch(N, mus)
        # gain[p, s, d] = dminus[p, s] + dplus[p, d], s != d
        gain = dminus[:, :, :, None] + dplus[:, :, None, :]
        gain = torch.where(eye, -torch.inf, gain).reshape(B, -1)
        flat = torch.argmax(gain, dim=1)
        g = gain.gather(1, flat[:, None])[:, 0]
        p, s, d = flat // (l * l), (flat // l) % l, flat % l
        do = g > _TOL32 * (1.0 + system_throughput_torch(N, mus))
        upd = (_one_hot(p, k)[:, :, None]
               * (_one_hot(d, l) - _one_hot(s, l))[:, None, :])
        step = active & do
        N = torch.where(step[:, None, None], N + upd, N)
        moves = moves + step.to(torch.int32)
        improved = torch.where(active, do, improved)
        it += 1
        if it % _SYNC_EVERY == 0 and not bool(
                (improved & (moves < cap)).any()):
            break
    return N, ~improved, moves


def grin_solve_torch(mu, n_tasks, max_moves: int | None = None,
                     return_info: bool = False, device=None):
    """Single-move GrIn on the device; returns the (k, l) float32 placement.

    `max_moves=None` scales the move cap with the population (4 *
    sum(n_tasks) + 64); an explicit int is a HARD cap. With `return_info`
    returns (N, converged, moves) so callers can detect the cap."""
    dev = resolve_device(device)
    mus = torch.as_tensor(mu, dtype=torch.float32, device=dev)[None]
    nt = np.asarray(n_tasks)
    mixes = torch.as_tensor(nt, dtype=torch.float32, device=dev)[None]
    cap = (int(max_moves) if max_moves is not None
           else 4 * int(nt.sum()) + 64)
    N, conv, moves = _grin_single_core(
        mus, mixes, torch.full((1,), cap, dtype=torch.int32, device=dev))
    if return_info:
        return N[0], conv[0], moves[0]
    return N[0]


def phase_scale(N, mus, Ps, objective: int) -> torch.Tensor:
    """Per-instance magnitude a phase's float32 convergence threshold is
    relative to: X_sys for the throughput objectives, |E[E]| (eq. 19) or
    |EDP| (eq. 21) for the energy ones (inf where X_sys is 0). Summed row by
    row and column by column from the left, the order the fused kernel
    sums in, so the per-step loop and the kernel draw the same threshold."""
    from repro_torch.kernels.grin_moves import (OBJ_EDP, OBJ_X, OBJ_XE,
                                                _column_sums, _left_sum)
    c = _column_sums(N)
    cc = torch.clamp(c, min=1.0)
    xs = _left_sum(torch.where(c > 0, _column_sums(mus * N) / cc, 0.0))
    if objective in (OBJ_X, OBJ_XE):
        return xs
    ws = _left_sum(torch.where(c > 0, _column_sums(Ps * N) / cc, 0.0))
    xc = torch.clamp(xs, min=1e-30)
    e = ws / xc
    if objective == OBJ_EDP:
        e = e * (N.sum(dim=(-2, -1)) / xc)
    return torch.where(xs > 0, e.abs(), torch.inf)


def grin_block_steps(N0, mus, sizes, cap: int, *, P=None, objective: int,
                     scorer=None):
    """The block-move loop one step at a time over a batch — the plain
    version of the fused solve (`kernels.grin_moves.grin_block_solve_cuda`).

    Each step scores every instance's moves with `scorer` (by default
    `block_move_scores`: the plain scorer on the CPU, one launch of the
    scorer kernel on the card; `block_move_scores_reference` is the plain
    scorer on any device), and an instance whose steepest m=1 gain clears
    _TOL32_BLOCK * (1 + scale) takes the selected move; the others stop. A
    phase ends when no instance moves or after `cap` steps; under OBJ_XE
    the X-plateau energy phase follows. Returns (N, converged (B,) bool,
    moves (B,) int32)."""
    from repro_torch.kernels.grin_moves import (OBJ_E_GUARD, OBJ_XE,
                                                block_move_scores)
    scorer = block_move_scores if scorer is None else scorer
    B, k, l = N0.shape
    dirs = k * l * l

    def run_phase(N, moves, obj):
        active = torch.ones(B, dtype=torch.bool, device=N.device)
        it = 0
        while it < cap:
            _, bi, _, base = scorer(N, mus, sizes, return_gains=False, P=P,
                                    objective=obj)
            bi = bi.to(torch.int64)
            mi, r = bi // dirs, bi % dirs
            p, s, d = r // (l * l), (r // l) % l, r % l
            # Convergence is the m=1 signal: exhausted => single-move local
            # optimum of the phase objective.
            do = active & (base > _TOL32_BLOCK
                           * (1.0 + phase_scale(N, mus, P, obj)))
            upd = (sizes[mi][:, None, None] * _one_hot(p, k)[:, :, None]
                   * (_one_hot(d, l) - _one_hot(s, l))[:, None, :])
            N = torch.where(do[:, None, None], N + upd, N)
            moves = moves + do.to(torch.int32)
            active = do
            it += 1
            if it % _SYNC_EVERY == 0 and not bool(active.any()):
                break
        return N, moves, ~active

    N, moves, conv = run_phase(
        N0, torch.zeros(B, dtype=torch.int32, device=N0.device), objective)
    if objective == OBJ_XE:
        # Phase 2 of max-X-E: slide along the X plateau (moves whose dX
        # stays within float32 noise of zero) toward lower energy.
        N, moves, conv2 = run_phase(N, moves, OBJ_E_GUARD)
        conv = conv & conv2
    return N, conv, moves


_OBJECTIVE_KEYS = ("max-x", "max-x-e", "min-e", "min-edp")


def _objective_id(objective: str) -> int:
    from repro_torch.kernels.grin_moves import OBJ_E, OBJ_EDP, OBJ_X, OBJ_XE
    ids = dict(zip(_OBJECTIVE_KEYS, (OBJ_X, OBJ_XE, OBJ_E, OBJ_EDP)))
    if objective not in ids:
        raise ValueError(f"unknown objective {objective!r}: "
                         + " | ".join(_OBJECTIVE_KEYS))
    return ids[objective]


def _batch_inputs(mu, n_tasks_batch, n_sizes, max_moves, objective, power,
                  P, device):
    """Device tensors for a batched solve: (initial placements N0, mus, Ps |
    None, sizes (descending ladder), cap, objective id)."""
    dev = resolve_device(device)
    mixes_np = np.asarray(n_tasks_batch)
    if mixes_np.ndim != 2:
        raise ValueError(f"n_tasks_batch must be (B, k); got {mixes_np.shape}")
    B, k = mixes_np.shape
    if not isinstance(mu, torch.Tensor):
        mu = np.array(mu, dtype=np.float32)
    mus = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    if mus.dim() == 2:
        mus = mus.expand((B,) + tuple(mus.shape))
    if mus.dim() != 3 or tuple(mus.shape[:2]) != (B, k):
        raise ValueError(f"mu must be (k={k}, l) or (B={B}, k={k}, l); got "
                         f"{tuple(np.shape(mu))}")
    mus = mus.contiguous()
    obj = _objective_id(objective)
    from repro_torch.kernels.grin_moves import OBJ_X
    if obj == OBJ_X:
        Ps = None
    elif P is not None:
        Ps = torch.as_tensor(P, dtype=torch.float32, device=dev) \
            .expand(mus.shape).contiguous()
    else:
        from repro_torch.core.affinity import PROPORTIONAL_POWER
        from repro_torch.core.energy import power_matrix_torch
        Ps = power_matrix_torch(mus, power or PROPORTIONAL_POWER).contiguous()
    total = int(mixes_np.sum(axis=1).max()) if B else 0
    if n_sizes is None:
        n_sizes = len(_ladder(total))
    cap = int(max_moves) if max_moves is not None else total + 64
    # Largest size first: argmax ties prefer the biggest improving block.
    sizes = 2.0 ** torch.arange(int(n_sizes) - 1, -1, -1,
                                dtype=torch.float32, device=dev)
    mixes = torch.as_tensor(mixes_np, dtype=torch.float32, device=dev)
    return _grin_init_torch(mus, mixes), mus, Ps, sizes, cap, obj


def grin_solve_batch_torch(mu, n_tasks_batch, *, n_sizes: int | None = None,
                           max_moves: int | None = None,
                           objective: str = "max-x", power=None, P=None,
                           device=None):
    """Block-move GrIn over a batch of instances on the device.

    mu: (k, l) shared or (B, k, l) per-instance affinities; n_tasks_batch:
    (B, k) type mixes. Returns torch tensors on the device: (N (B, k, l)
    float32, x_sys (B,), converged (B,) bool, moves (B,) int32). `n_sizes`
    is the doubling-ladder length (derived from the mixes when omitted).
    `max_moves=None` caps each phase at the batch's max population + 64
    steps — hitting the cap (converged False) signals a degenerate
    instance.

    `objective`: "max-x" (throughput ascent), "max-x-e" (throughput ascent
    with energy tie-breaks, then an X-plateau energy polish — GrIn-E),
    "min-e" (E[E] descent, eq. 19) or "min-edp" (EDP descent, eq. 21), with
    the power matrix P = coeff * mu**alpha from `power` (a PowerModel;
    default proportional). `P` ((k, l) or (B, k, l)) overrides the priced
    power matrix for callers whose mu is not the physical rate matrix.

    On the card the whole solve is one launch of the fused kernel
    (`grin_block_solve_cuda`), with no host sync inside; on the CPU it runs
    the per-step loop (`grin_block_steps`) with the plain scorer.
    """
    N0, mus, Ps, sizes, cap, obj = _batch_inputs(
        mu, n_tasks_batch, n_sizes, max_moves, objective, power, P, device)
    if N0.device.type == "cuda":
        from repro_torch.kernels.grin_moves import grin_block_solve_cuda
        N, conv, moves = grin_block_solve_cuda(N0, mus, sizes, cap, P=Ps,
                                               objective=obj)
    else:
        N, conv, moves = grin_block_steps(N0, mus, sizes, cap, P=Ps,
                                          objective=obj)
    return N, system_throughput_torch(N, mus), conv, moves


def grin_solve_batch_steps_torch(mu, n_tasks_batch, *,
                                 n_sizes: int | None = None,
                                 max_moves: int | None = None,
                                 objective: str = "max-x", power=None,
                                 P=None, device=None, scorer=None):
    """`grin_solve_batch_torch` through the per-step loop on any device: the
    fused solve's plain version, kept to hold the kernel against. `scorer`
    as in `grin_block_steps` (by default one scorer launch per step on the
    card). Same arguments and returns otherwise."""
    N0, mus, Ps, sizes, cap, obj = _batch_inputs(
        mu, n_tasks_batch, n_sizes, max_moves, objective, power, P, device)
    N, conv, moves = grin_block_steps(N0, mus, sizes, cap, P=Ps,
                                      objective=obj, scorer=scorer)
    return N, system_throughput_torch(N, mus), conv, moves
