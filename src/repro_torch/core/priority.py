"""Priority-class scheduling math (arXiv:1712.03246, same authors).

Tasks carry a priority class c in {0..C-1} (class 0 = highest priority);
each class has its own type mix (how many tasks of each of the k types it
keeps in flight), its own task-size distribution, and a weight w_c >= 0.
A multi-class placement is a (C, k, l) nonneg-integer tensor N[c, i, j] =
class-c i-type tasks resident on processor j, and the class-weighted system
throughput is

    X_w(N) = sum_c w_c * X_c(N),
    X_c(N) = sum_j sum_i mu[i, j] * N[c, i, j] / col_j

(col_j counts ALL residents of processor j — under processor sharing every
class shares the column equally; the class changes what a completion is
worth, not how fast it runs).

The load-bearing identity of this module: X_w of a (C, k, l) state equals
the SINGLE-CLASS X_sys of its class-major flattening M[(c*k + i), j] =
N[c, i, j] under the class-weighted affinity

    mu_w[(c*k + i), j] = w_c * mu[i, j]

because sum_j (sum_{c,i} w_c mu_ij N_cij) / col_j = sum_c w_c X_c. Every
piece of the single-class machinery — the exact block-move deltas, the
batched block-move GrIn solver, the fused CUDA solve, deficit routing —
therefore generalizes to priority classes by flattening: the class axis
rides along as extra rows of the state, and the kernel scores class-weighted
gains without a single new op. With C == 1 and w = (1,), mu_w == mu exactly
(multiplication by 1.0 is exact in every float width), so the priority
solvers reduce BIT-IDENTICALLY to the single-class ones.

Energy stays physical: a class-c i-type task on processor j draws P[i, j]
regardless of its weight, so the per-class expected energy per task is

    E_c = (sum_j sum_i N[c, i, j] * P[i, j] / col_j) / X_c      (eq. 19
                                                                 restricted
                                                                 to class c)

and the flattened power matrix is the UNWEIGHTED tile P[(c*k + i), j] =
P[i, j] (weights shape preferences, not physics).
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.core.affinity import PROPORTIONAL_POWER, PowerModel
from repro_torch.core.cab import cab_target_state
from repro_torch.core.grin import grin_solve, grin_solve_batch_torch
from repro_torch.core.throughput import (delta_x_add_block,
                                         delta_x_remove_block)


# ---------------------------------------------------------------------------
# Flattening layer: (C, k, l) <-> (C*k, l), class-major.
# ---------------------------------------------------------------------------

def class_of_flat(n_classes: int, k: int) -> np.ndarray:
    """(C*k,) class id of each flattened (class, type) row, class-major."""
    return np.repeat(np.arange(int(n_classes)), int(k))


def flat_mu(mu: np.ndarray, n_classes: int) -> np.ndarray:
    """(C*k, l) PHYSICAL flattened affinity: class c's block is mu itself
    (a class does not change how fast a task runs)."""
    return np.tile(np.asarray(mu, dtype=np.float64), (int(n_classes), 1))


def priority_mu(mu: np.ndarray, weights) -> np.ndarray:
    """(C*k, l) class-WEIGHTED flattened affinity mu_w[(c,i), j] = w_c mu_ij
    — the matrix the solver fabric ranks moves under. float64 host form."""
    mu = np.asarray(mu, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1 or (w < 0).any():
        raise ValueError(f"weights must be a 1-D nonnegative vector; got {w}")
    return (w[:, None, None] * mu[None]).reshape(w.size * mu.shape[0],
                                                 mu.shape[1])


def flatten_state(N: np.ndarray) -> np.ndarray:
    """(C, k, l) -> (C*k, l) class-major."""
    N = np.asarray(N)
    return N.reshape(N.shape[0] * N.shape[1], N.shape[2])


def unflatten_state(M: np.ndarray, n_classes: int) -> np.ndarray:
    """(C*k, l) -> (C, k, l)."""
    M = np.asarray(M)
    return M.reshape(int(n_classes), M.shape[0] // int(n_classes), M.shape[1])


def flatten_mixes(class_mixes: np.ndarray) -> np.ndarray:
    """(..., C, k) per-class type mixes -> (..., C*k) flat mixes."""
    m = np.asarray(class_mixes)
    return m.reshape(m.shape[:-2] + (m.shape[-2] * m.shape[-1],))


# ---------------------------------------------------------------------------
# Class-weighted throughput / per-class energy (host + batched JAX forms).
# ---------------------------------------------------------------------------

def class_throughputs(N: np.ndarray, mu: np.ndarray) -> np.ndarray:
    """(C,) UNWEIGHTED per-class throughput X_c of a (C, k, l) placement."""
    N = np.asarray(N, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    col = N.sum(axis=(0, 1))                                  # (l,) all classes
    num = (mu[None] * N).sum(axis=1)                          # (C, l)
    with np.errstate(divide="ignore", invalid="ignore"):
        per = np.where(col[None] > 0, num / np.maximum(col[None], 1e-300), 0.0)
    return per.sum(axis=1)


def weighted_system_throughput(N: np.ndarray, mu: np.ndarray,
                               weights) -> float:
    """X_w = sum_c w_c X_c; equals system_throughput(flatten(N),
    priority_mu(mu, weights)) exactly — the identity the solver relies on."""
    w = np.asarray(weights, dtype=np.float64)
    return float((w * class_throughputs(N, mu)).sum())


def class_throughputs_batch_torch(Ns, mus) -> torch.Tensor:
    """(B, C) per-class X for a (B, C, k, l) batch under (k, l) or
    (B, k, l) affinities (float32, on Ns's device)."""
    Ns = torch.as_tensor(Ns, dtype=torch.float32)
    mus = torch.as_tensor(mus, dtype=torch.float32, device=Ns.device)
    if mus.dim() == 2:
        mus = mus[None]                                       # (1, k, l)
    col = Ns.sum(dim=(1, 2))                                  # (B, l)
    num = (mus[:, None, :, :] * Ns).sum(dim=2)                # (B, C, l)
    per = torch.where(col[:, None] > 0,
                      num / torch.clamp(col[:, None], min=1.0), 0.0)
    return per.sum(dim=-1)


def class_energy_per_task(N: np.ndarray, mu: np.ndarray,
                          power: PowerModel) -> np.ndarray:
    """(C,) expected energy per class-c task: the class's occupancy-weighted
    power share divided by its completion rate (eq. 19 restricted to one
    class; inf where the class completes nothing)."""
    N = np.asarray(N, dtype=np.float64)
    P = power.power_matrix(mu)
    col = N.sum(axis=(0, 1))
    with np.errstate(divide="ignore", invalid="ignore"):
        share = np.where(col[None] > 0, (P[None] * N).sum(axis=1)
                         / np.maximum(col[None], 1e-300), 0.0).sum(axis=1)
    xc = class_throughputs(N, mu)
    return np.where(xc > 0, share / np.maximum(xc, 1e-300), np.inf)


# ---------------------------------------------------------------------------
# Exact block deltas with a class axis — the flattened single-class closed
# forms re-exposed on (C, k, l) states (host mirror of what the device
# kernel scores; weights in mu's seat for throughput, physical P for power).
# ---------------------------------------------------------------------------

def delta_xw_add_block_priority(N, mu, weights, c: int, p: int,
                                m: int) -> np.ndarray:
    """Exact class-weighted X_w gain per column from ADDING m class-c p-type
    tasks: `delta_x_add_block` on the flattened weighted problem."""
    k = np.asarray(mu).shape[0]
    return delta_x_add_block(flatten_state(N), priority_mu(mu, weights),
                             c * k + p, m)


def delta_xw_remove_block_priority(N, mu, weights, c: int, p: int,
                                   m: int) -> np.ndarray:
    """Exact class-weighted X_w change per column from REMOVING m class-c
    p-type tasks (+inf where fewer than m such tasks reside)."""
    k = np.asarray(mu).shape[0]
    return delta_x_remove_block(flatten_state(N), priority_mu(mu, weights),
                                c * k + p, m)


def delta_w_add_block_priority(N, mu, weights, power: PowerModel, c: int,
                               p: int, m: int) -> np.ndarray:
    """Exact per-column POWER-RATE change from adding m class-c p-type tasks:
    the same closed form with the PHYSICAL tiled power matrix in mu's seat
    (class weights never scale watts)."""
    del weights  # physics: power is class-blind
    k = np.asarray(mu).shape[0]
    C = np.asarray(N).shape[0]
    Pf = np.tile(power.power_matrix(mu), (C, 1))
    return delta_x_add_block(flatten_state(N), Pf, c * k + p, m)


def delta_w_remove_block_priority(N, mu, weights, power: PowerModel, c: int,
                                  p: int, m: int) -> np.ndarray:
    del weights
    k = np.asarray(mu).shape[0]
    C = np.asarray(N).shape[0]
    Pf = np.tile(power.power_matrix(mu), (C, 1))
    return delta_x_remove_block(flatten_state(N), Pf, c * k + p, m)


# ---------------------------------------------------------------------------
# Priority solvers: GrIn-P (any C x k x l) and CAB-P (flattened 2 x 2).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GrInPriorityResult:
    N: np.ndarray               # (C, k, l) placement
    weighted_x: float           # sum_c w_c X_c at the solution
    class_x: np.ndarray         # (C,) per-class throughput
    moves: int
    sweeps: int


def grin_priority_solve(mu: np.ndarray, class_mixes: np.ndarray,
                        weights) -> GrInPriorityResult:
    """Host GrIn-P: Algorithm 2 on the flattened class-weighted problem.

    mu: (k, l) physical affinities; class_mixes: (C, k) per-class type
    counts; weights: (C,). With C == 1 and w == (1,) the flattening is the
    identity and mu_w == mu bit-for-bit, so the returned placement equals
    `grin_solve(mu, mixes[0]).N` exactly.
    """
    class_mixes = np.asarray(class_mixes, dtype=np.int64)
    if class_mixes.ndim != 2:
        raise ValueError(f"class_mixes must be (C, k); got {class_mixes.shape}")
    C, k = class_mixes.shape
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (C,):
        raise ValueError(f"weights must be ({C},); got {w.shape}")
    res = grin_solve(priority_mu(mu, w), flatten_mixes(class_mixes))
    N = unflatten_state(res.N, C)
    return GrInPriorityResult(N=N, weighted_x=weighted_system_throughput(
        N, mu, w), class_x=class_throughputs(N, mu), moves=res.moves,
        sweeps=res.sweeps)


def grin_solve_priority_batch_torch(mu, class_mixes_batch, weights, *,
                                    objective: str = "max-x",
                                    power: PowerModel | None = None,
                                    device=None, **kw):
    """Batched block-move GrIn-P: whole (B, C, k) mix batches solved in one
    `core.grin.grin_solve_batch_torch` call — on the card one launch of the
    fused CUDA solve, which scores (B, M, C*k, l, l) class-weighted block
    gains because the class axis is flattened into the row axis and the
    affinities it ranks with are w_c * mu_ij. `mu` is (k, l), shared, or
    (B, k, l), one system an instance (a whole (mu x mix) grid in one
    launch).

    The weighted rows are formed in float64 (`priority_mu`) and then cast to
    float32, the order the reference package's solver receives them in, so
    near-ties break the same way. Energy objectives price moves against the
    PHYSICAL tiled power matrix (weights never scale watts); `power`
    defaults to proportional as in the single-class solver. On the card the
    flattened shape must fit the fused solve: its wrapper checks the bounds
    (`kernels.grin_moves.check_solve_shape`) before it launches and raises,
    and the solve never drops to the per-step loop.

    Returns (N (B, C, k, l) float32, weighted_x (B,), converged (B,) bool,
    moves (B,) int32) as tensors on the device.
    """
    from repro_torch import resolve_device
    dev = resolve_device(device)
    mixes = np.asarray(class_mixes_batch)
    if mixes.ndim != 3:
        raise ValueError("class_mixes_batch must be (B, C, k); got "
                         f"{mixes.shape}")
    B, C, k = mixes.shape
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (C,):
        raise ValueError(f"weights must be ({C},); got {w.shape}")
    mu = np.asarray(mu, dtype=np.float64)
    if mu.shape[-2] != k or mu.ndim not in (2, 3) \
            or (mu.ndim == 3 and mu.shape[0] != B):
        raise ValueError(f"mu must be ({k}, l) or ({B}, {k}, l); got "
                         f"{mu.shape}")
    l = mu.shape[-1]
    # priority_mu's float64 products, for every system at once
    mu_w = (w[:, None, None] * mu[..., None, :, :]).reshape(
        mu.shape[:-2] + (C * k, l))
    P = None
    if objective != "max-x":
        P = np.tile((power or PROPORTIONAL_POWER).power_matrix(mu),
                    (C, 1))
    N, xw, conv, moves = grin_solve_batch_torch(
        mu_w, flatten_mixes(mixes), objective=objective, power=power,
        P=P, device=dev, **kw)
    return N.reshape(B, C, k, l), xw, conv, moves


def cab_priority_solve(mu: np.ndarray, class_mixes: np.ndarray,
                       weights) -> np.ndarray:
    """CAB-P: the Table-1 analytical optimum of the flattened class-weighted
    problem — exact whenever the flattening is 2 x 2 (two classes of one
    task type, or one class of two types) on two pools. Weighted rows can
    leave the paper's affinity labeling; `cab_solve` then falls back to the
    exact (N11, N22) map argmax, so the result is optimal either way.

    Returns the (C, k, l) target. C == 1 with w == (1,) reduces to
    `cab_target_state(mu, mixes[0])` bit-identically.
    """
    class_mixes = np.asarray(class_mixes, dtype=np.int64)
    C, k = class_mixes.shape
    if C * k != 2 or np.asarray(mu).shape[1] != 2:
        raise ValueError("CAB-P is the flattened two-row/two-pool analytical "
                         f"solution; got C*k={C * k}, l="
                         f"{np.asarray(mu).shape[1]} (use 'grin-p')")
    target = cab_target_state(priority_mu(mu, weights),
                              flatten_mixes(class_mixes))
    return unflatten_state(target, C)
