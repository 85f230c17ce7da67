"""Energy / EDP model (paper Sec. 3.4, eq. 19-23, Lemmas 5-7).

Host (float64) scalar forms plus batched torch (B, k, l) forms: the torch
variants are the device-resident objective surface the energy-aware GrIn
solvers (`grin_solve_batch_torch(objective=...)`) and the elastic energy
what-ifs price placements with — one vectorized call per (mu x mix) grid.
The alpha-power DVFS model (`DVFSModel`) scales both with frequency.
"""
from __future__ import annotations

import dataclasses

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


# ---------------------------------------------------------------------------
# Alpha-power DVFS model (speed scaling): mu ∝ f, P ∝ f^alpha.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DVFSModel:
    """Alpha-power frequency scaling for heterogeneous pools.

    Running pool j at relative frequency f_j scales its service rates
    linearly (mu_ij -> f_j * mu_ij) and its dynamic power polynomially
    (P_ij -> f_j**alpha * P_ij, alpha in [2, 3] for CMOS). At a uniform
    scale f the energy per task is exactly f**(alpha-1) * E(1) — convex
    in f for alpha >= 2. `alpha` here is the power-vs-FREQUENCY exponent;
    it is unrelated to `PowerModel.alpha`, the power-vs-RATE affinity
    exponent (<= 1) of the paper's Sec. 3.2 scenarios.

    `idle_frac` is the static-leakage share: a pool that is powered on
    (f_j > 0) draws idle_frac * max_i P_ij regardless of load, a parked
    pool draws nothing. This is what makes pool-parking worth pricing
    separately from downclocking.
    """
    alpha: float = 3.0
    levels: tuple = (0.5, 0.75, 1.0, 1.25)
    idle_frac: float = 0.10

    def __post_init__(self):
        if self.alpha < 1.0:
            raise ValueError(f"alpha-power exponent must be >= 1; "
                             f"got {self.alpha}")
        lv = tuple(float(f) for f in self.levels)
        if not lv or any(f <= 0 for f in lv) or list(lv) != sorted(lv):
            raise ValueError(f"levels must be sorted positive frequencies; "
                             f"got {self.levels!r}")
        object.__setattr__(self, "levels", lv)
        if not 0.0 <= self.idle_frac < 1.0:
            raise ValueError(f"idle_frac must be in [0, 1); "
                             f"got {self.idle_frac}")

    # ---------------- host (float64) ----------------
    def scale_mu(self, mu: np.ndarray, f) -> np.ndarray:
        """Rates at per-pool frequencies f ((l,) or scalar): f_j * mu_ij."""
        return np.asarray(mu, dtype=np.float64) * np.asarray(f, np.float64)

    def scale_power(self, P: np.ndarray, f) -> np.ndarray:
        """Dynamic power at per-pool frequencies: f_j**alpha * P_ij."""
        return (np.asarray(P, dtype=np.float64)
                * np.asarray(f, np.float64) ** self.alpha)

    def energy_scale(self, f: float) -> float:
        """E(f)/E(1) at a UNIFORM scale f: f**(alpha-1) (convex, alpha>=2)."""
        return float(f) ** (self.alpha - 1.0)

    def idle_power(self, P: np.ndarray, f) -> np.ndarray:
        """(l,) static leakage draw: idle_frac * peak column power while the
        pool is on (f_j > 0), zero when parked."""
        peak = np.asarray(P, dtype=np.float64).max(axis=0)
        on = np.asarray(f, np.float64) > 0
        return np.where(on, self.idle_frac * peak, 0.0)

    # ---------------- device (float32, batched) ----------------
    def scale_torch(self, mu, P, fs, device=None):
        """Batched twin: frequency grid fs (F, l) against one nominal
        (mu, P) pair -> (mus (F, k, l), Ps (F, k, l)) float32 on `device`
        (default "cuda"), the shapes `solve_targets_grid_torch` /
        `expected_energy_batch_torch` consume."""
        from repro_torch import resolve_device
        dev = resolve_device(device)
        fs = torch.as_tensor(np.asarray(fs, np.float32), device=dev)[:, None]
        mu = torch.as_tensor(np.asarray(mu, np.float32), device=dev)[None]
        P = torch.as_tensor(np.asarray(P, np.float32), device=dev)[None]
        return mu * fs, P * fs ** torch.tensor(self.alpha,
                                               dtype=torch.float32,
                                               device=dev)


def scenario_identities(N: np.ndarray, mu: np.ndarray) -> dict:
    """Closed-form checks: eq. 22 (alpha=0) and eq. 23 (alpha=1), l=2 forms
    generalize to E[E] = l*k_coeff/X (const power) and E[E] = k_coeff (prop)."""
    l = np.asarray(N).shape[1]
    X = system_throughput(N, mu)
    return {
        "const_power_energy": l / X,       # eq. 22 with k_coeff=1, general l
        "prop_power_energy": 1.0,          # eq. 23 with k_coeff=1
        "const_power_edp": l * np.asarray(N).sum() / X**2,
        "prop_power_edp": np.asarray(N).sum() / X,
    }
