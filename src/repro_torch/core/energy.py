"""Energy / EDP model (paper Sec. 3.4, eq. 19-23, Lemmas 5-7).

Host (float64) scalar forms plus batched torch (B, k, l) forms: the torch
variants are the device-resident objective surface the energy-aware GrIn
solvers (`grin_solve_batch_torch(objective=...)`) and the elastic energy
what-ifs price placements with — one vectorized call per (mu x mix) grid.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.affinity import PowerModel
from repro_torch.core.throughput import system_throughput


def expected_energy_per_task(N: np.ndarray, mu: np.ndarray,
                             power: PowerModel) -> float:
    """E[energy] (eq. 19 generalized to k x l).

    E[E] = (1/X) * sum_j (sum_i N_ij * P_ij) / col_j   (empty columns -> 0)
    """
    N = np.asarray(N, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    P = power.power_matrix(mu)
    X = system_throughput(N, mu)
    if X <= 0:
        return np.inf
    col = N.sum(axis=0)
    per_col = np.where(col > 0, (N * P).sum(axis=0) / np.maximum(col, 1e-300), 0.0)
    return float(per_col.sum() / X)


def expected_delay(N: np.ndarray, mu: np.ndarray) -> float:
    """E[T] = N_total / X (Little's law, eq. 20)."""
    X = system_throughput(N, mu)
    return float(np.asarray(N).sum() / X) if X > 0 else np.inf


def edp(N: np.ndarray, mu: np.ndarray, power: PowerModel) -> float:
    """Energy-Delay Product (eq. 21)."""
    return expected_energy_per_task(N, mu, power) * expected_delay(N, mu)


# ---------------------------------------------------------------------------
# Batched torch forms (eq. 19-21 over a (B, k, l) batch of placements).
# ---------------------------------------------------------------------------

def power_matrix_torch(mu: torch.Tensor, power: PowerModel) -> torch.Tensor:
    """P_ij = coeff * mu_ij ** alpha (paper Sec. 3.2), float32 on mu's
    device."""
    mu = torch.as_tensor(mu, dtype=torch.float32)
    return torch.tensor(power.coeff, dtype=torch.float32, device=mu.device) \
        * mu ** torch.tensor(power.alpha, dtype=torch.float32, device=mu.device)


def _cols(Ns: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Per-column ratio-of-sums sum_i N_ij M_ij / c_j over a batch: the shared
    shape behind both X_j (M=mu) and the power rate W_j (M=P)."""
    col = Ns.sum(dim=-2)
    num = (M * Ns).sum(dim=-2)
    return torch.where(col > 0, num / torch.clamp(col, min=1.0), 0.0)


def _batch_args(Ns, *mats):
    Ns = torch.as_tensor(Ns, dtype=torch.float32)
    return (Ns,) + tuple(
        torch.as_tensor(m, dtype=torch.float32, device=Ns.device)
        .broadcast_to(Ns.shape) for m in mats)


def expected_energy_batch_torch(Ns, mus, Ps) -> torch.Tensor:
    """E[E] (eq. 19) for a (B, k, l) batch: sum_j W_j / X_sys per instance
    (inf where X_sys == 0). mus/Ps broadcast from (k, l)."""
    Ns, mus, Ps = _batch_args(Ns, mus, Ps)
    X = _cols(Ns, mus).sum(dim=-1)
    W = _cols(Ns, Ps).sum(dim=-1)
    return torch.where(X > 0, W / torch.clamp(X, min=1e-30), torch.inf)


def expected_delay_batch_torch(Ns, mus) -> torch.Tensor:
    """E[T] = N_total / X_sys (eq. 20) per batch instance."""
    Ns, mus = _batch_args(Ns, mus)
    X = _cols(Ns, mus).sum(dim=-1)
    return torch.where(X > 0, Ns.sum(dim=(-2, -1)) / torch.clamp(X, min=1e-30),
                       torch.inf)


def edp_batch_torch(Ns, mus, Ps) -> torch.Tensor:
    """EDP = E[E] * E[T] = N_total * sum_j W_j / X_sys^2 (eq. 21), batched."""
    return (expected_energy_batch_torch(Ns, mus, Ps)
            * expected_delay_batch_torch(Ns, mus))
