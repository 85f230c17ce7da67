"""System-state throughput model (paper eq. 4 / 25-28).

State N is a (k tasks x l processors) nonneg-integer matrix, N[i, j] = number
of i-type tasks resident on processor j. Row sums are fixed (N_i tasks of each
type). Under processor sharing, processor j completes work at rate

    X_j = sum_i mu[i, j] * N[i, j] / sum_i N[i, j]      (0 if column empty)

and the system throughput is X_sys = sum_j X_j. Lemma 2/3: the optimal policy
keeps the system in argmax_N X_sys(N) regardless of task-size distribution and
work-conserving processing order.

NumPy float64 forms serve the host scheduler and the host solvers; the
float32 torch forms (`*_torch`) are the batched device counterparts the
block solver and the elastic what-ifs price placements with.
"""
from __future__ import annotations

import numpy as np
import torch


def column_throughputs(N: np.ndarray, mu: np.ndarray) -> np.ndarray:
    """Per-processor throughput X_j (eq. 26). Empty columns contribute 0."""
    N = np.asarray(N, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    col = N.sum(axis=0)
    num = (mu * N).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        X = np.where(col > 0, num / np.maximum(col, 1e-300), 0.0)
    return X


def system_throughput(N: np.ndarray, mu: np.ndarray) -> float:
    """X_sys(N) (eq. 27/28)."""
    return float(column_throughputs(N, mu).sum())


def column_throughputs_torch(N: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Per-processor X_j (eq. 26) in float32 over any leading batch dims:
    N, mu (..., k, l) -> (..., l); empty columns contribute 0."""
    N = N.to(torch.float32)
    col = N.sum(dim=-2)
    num = (mu * N).sum(dim=-2)
    return torch.where(col > 0, num / torch.clamp(col, min=1.0),
                       torch.zeros((), dtype=num.dtype, device=num.device))


def system_throughput_torch(N: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """X_sys in float32: (..., k, l) states -> (...,)."""
    return column_throughputs_torch(N, mu).sum(dim=-1)


def system_throughput_batch_torch(Ns: torch.Tensor,
                                  mu: torch.Tensor) -> torch.Tensor:
    """X_sys for a (B, k, l) batch of states under one (k, l) mu or per-state
    (B, k, l) mus — the inner product of batched target solving."""
    return system_throughput_torch(Ns, mu)


def state_from_pair(n11: int, n22: int, n1: int, n2: int) -> np.ndarray:
    """2x2 state matrix from the (N11, N22) pair (paper Definition 5)."""
    return np.array([[n11, n1 - n11], [n2 - n22, n22]], dtype=np.int64)


def throughput_2x2(n11, n22, n1, n2, mu) -> float:
    """X(N11, N22) closed form (paper eq. 4)."""
    return system_throughput(state_from_pair(n11, n22, n1, n2), mu)


def throughput_map_2x2(n1: int, n2: int, mu: np.ndarray) -> np.ndarray:
    """Full X(S) surface over N11 in [0, n1] x N22 in [0, n2], float32.

    Used for exhaustive 2x2 optimality checks and Table-1 validation. Shape
    (n1+1, n2+1)."""
    mu = np.asarray(mu, dtype=np.float32)
    a = np.arange(n1 + 1, dtype=np.float32)[:, None]
    b = np.arange(n2 + 1, dtype=np.float32)[None, :]
    # Columns: P1 holds (a, n2-b); P2 holds (n1-a, b).
    c1 = a + (np.float32(n2) - b)
    c2 = (np.float32(n1) - a) + b
    x1 = np.where(c1 > 0, (mu[0, 0] * a + mu[1, 0] * (np.float32(n2) - b))
                  / np.maximum(c1, np.float32(1.0)), np.float32(0.0))
    x2 = np.where(c2 > 0, (mu[1, 1] * b + mu[0, 1] * (np.float32(n1) - a))
                  / np.maximum(c2, np.float32(1.0)), np.float32(0.0))
    return (x1 + x2).astype(np.float32)


def delta_x_add(N: np.ndarray, mu: np.ndarray, p: int) -> np.ndarray:
    """X_df+ per processor: gain from ADDING one p-type task (eq. 33-34).

    X_df+[j] = (mu[p, j] - X_j) / (sum_i N[i, j] + 1)
    """
    X = column_throughputs(N, mu)
    col = np.asarray(N, dtype=np.float64).sum(axis=0)
    return (np.asarray(mu, dtype=np.float64)[p] - X) / (col + 1.0)


def delta_x_remove(N: np.ndarray, mu: np.ndarray, p: int) -> np.ndarray:
    """X_df- per processor: change from REMOVING one p-type task (eq. 35-36).

    X_df-[j] = (X_j - mu[p, j]) / (sum_i N[i, j] - 1); +inf where no p-task can
    be removed (N[p, j] == 0). A singleton column (col == 1, removing empties
    it) loses exactly mu[p, j]: the limit formula still applies with the
    convention X_j(empty) = 0, i.e. delta = -mu_pj, handled explicitly.
    """
    N = np.asarray(N, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    X = column_throughputs(N, mu)
    col = N.sum(axis=0)
    out = np.full(N.shape[1], np.inf)
    for j in range(N.shape[1]):
        if N[p, j] <= 0:
            continue
        if col[j] <= 1:
            out[j] = -mu[p, j]  # column becomes empty; we lose its whole rate
        else:
            out[j] = (X[j] - mu[p, j]) / (col[j] - 1.0)
    return out


def delta_x_add_block(N: np.ndarray, mu: np.ndarray, p: int,
                      m: int) -> np.ndarray:
    """Exact gain from ADDING m p-type tasks to each column at once.

    Closed form: (w_j + m*mu_pj)/(c_j + m) - X_j simplifies to

        m * (mu[p, j] - X_j) / (c_j + m)

    which reduces to eq. 33-34 at m=1 and covers the empty column
    (X_j = 0, delta = mu_pj) with no special case.
    """
    X = column_throughputs(N, mu)
    col = np.asarray(N, dtype=np.float64).sum(axis=0)
    return m * (np.asarray(mu, dtype=np.float64)[p] - X) / (col + m)


def delta_x_remove_block(N: np.ndarray, mu: np.ndarray, p: int,
                         m: int) -> np.ndarray:
    """Exact change from REMOVING m p-type tasks from each column at once.

    Closed form: m * (X_j - mu[p, j]) / (c_j - m) for c_j > m (reduces to
    eq. 35-36 at m=1); a fully drained column (c_j == m) loses its whole
    rate X_j; +inf where fewer than m p-tasks reside (N[p, j] < m).
    """
    N = np.asarray(N, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    X = column_throughputs(N, mu)
    col = N.sum(axis=0)
    out = np.full(N.shape[1], np.inf)
    for j in range(N.shape[1]):
        if N[p, j] < m:
            continue
        if col[j] <= m:
            out[j] = -X[j]      # column becomes empty; its whole rate is lost
        else:
            out[j] = m * (X[j] - mu[p, j]) / (col[j] - m)
    return out


# ---------------------------------------------------------------------------
# Energy deltas (paper Sec. 3.4). The per-column POWER RATE
#
#     W_j = sum_i N[i, j] * P[i, j] / c_j           (0 if column empty)
#
# has exactly the same ratio-of-sums structure as X_j with P in place of mu,
# so the block closed forms above apply verbatim; E[E] = sum_j W_j / X_sys
# (eq. 19) and EDP = E[E] * N_total / X_sys (eq. 20-21) then give EXACT
# per-move deltas for the energy objectives — the host mirror of what the
# `repro_torch.kernels.grin_moves` scores on the device.
# ---------------------------------------------------------------------------

def power_rate_columns(N: np.ndarray, P: np.ndarray) -> np.ndarray:
    """Per-processor power rate W_j (empty columns contribute 0)."""
    return column_throughputs(N, P)


def delta_w_add_block(N: np.ndarray, P: np.ndarray, p: int,
                      m: int) -> np.ndarray:
    """Exact W_j change from ADDING m p-type tasks: m*(P_pj - W_j)/(c_j + m)
    — `delta_x_add_block` with the power matrix in mu's seat."""
    return delta_x_add_block(N, P, p, m)


def delta_w_remove_block(N: np.ndarray, P: np.ndarray, p: int,
                         m: int) -> np.ndarray:
    """Exact W_j change from REMOVING m p-type tasks (same structure as
    `delta_x_remove_block`; +inf where infeasible)."""
    return delta_x_remove_block(N, P, p, m)


def delta_energy_move_block(N: np.ndarray, mu: np.ndarray, P: np.ndarray,
                            p: int, src: int, dst: int, m: int) -> float:
    """Exact E[E] change from moving m p-type tasks src -> dst (src != dst).

    E = W_sum / X with W_sum = sum_j W_j, so with the block deltas
    dX = dX-[src] + dX+[dst] and dW = dW-[src] + dW+[dst],

        dE = (W_sum + dW) / (X + dX) - W_sum / X

    (+inf when the move is infeasible or drains the system, X + dX <= 0).
    """
    N = np.asarray(N, dtype=np.float64)
    if src == dst or N[p, src] < m:
        return np.inf
    X = system_throughput(N, mu)
    W = float(power_rate_columns(N, P).sum())
    dx = (delta_x_remove_block(N, mu, p, m)[src]
          + delta_x_add_block(N, mu, p, m)[dst])
    dw = (delta_w_remove_block(N, P, p, m)[src]
          + delta_w_add_block(N, P, p, m)[dst])
    if X + dx <= 0 or X <= 0:
        return np.inf
    return (W + dw) / (X + dx) - W / X


def delta_edp_move_block(N: np.ndarray, mu: np.ndarray, P: np.ndarray,
                         p: int, src: int, dst: int, m: int) -> float:
    """Exact EDP change from moving m p-type tasks src -> dst.

    EDP = E * E[T] = N_total * W_sum / X^2 (Little's law), so the move's
    closed-form delta is N_total * ((W+dW)/(X+dX)^2 - W/X^2).
    """
    N = np.asarray(N, dtype=np.float64)
    if src == dst or N[p, src] < m:
        return np.inf
    X = system_throughput(N, mu)
    W = float(power_rate_columns(N, P).sum())
    dx = (delta_x_remove_block(N, mu, p, m)[src]
          + delta_x_add_block(N, mu, p, m)[dst])
    dw = (delta_w_remove_block(N, P, p, m)[src]
          + delta_w_add_block(N, P, p, m)[dst])
    if X + dx <= 0 or X <= 0:
        return np.inf
    ntot = float(N.sum())
    return ntot * ((W + dw) / (X + dx) ** 2 - W / X ** 2)
