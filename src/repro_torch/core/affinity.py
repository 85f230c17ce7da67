"""Affinity and power matrices (paper Definitions 3-4, Scenarios 1-2).

The affinity matrix ``mu`` is (k tasks x l processors): ``mu[i, j]`` is the
processing rate of an i-type task on a j-type processor (tasks/sec). The power
matrix follows the exponential power/performance relation P_ij = coeff *
mu_ij**alpha with alpha <= 1 (paper eq. after Def. 4):

  alpha <= 0      strong affinity regime (fast processor also lower power)
  0 < alpha <= 1  weak affinity regime   (fast processor better energy, worse power)
  alpha == 0      Scenario 1 (constant power)
  alpha == 1      Scenario 2 (proportional power)
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class AffinityCase(enum.Enum):
    """Table 1 classification for two processor types."""

    HOMOGENEOUS = "homogeneous"            # mu11 == mu12 == mu21 == mu22
    BIG_LITTLE = "big_little"              # mu11 == mu21, mu12 == mu22, mu11 != mu22
    SYMMETRIC = "symmetric"                # mu11 == mu22 > mu12 == mu21
    GENERAL_SYMMETRIC = "general_symmetric"  # mu11 > mu21, mu22 > mu12 (diagonal dominant)
    P1_BIASED = "p1_biased"                # mu11 > mu21, mu12 > mu22 (P1 fastest for all)
    P2_BIASED = "p2_biased"                # mu21 > mu11, mu22 > mu12 (P2 fastest for all)
    INVALID = "invalid"                    # violates affinity constraints (case b.4)


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """P_ij = coeff * mu_ij ** alpha (paper Sec. 3.2)."""

    alpha: float = 1.0
    coeff: float = 1.0

    def power_matrix(self, mu: np.ndarray) -> np.ndarray:
        return self.coeff * np.asarray(mu, dtype=np.float64) ** self.alpha

    @property
    def regime(self) -> str:
        if self.alpha <= 0:
            return "strong"
        if self.alpha <= 1:
            return "weak"
        raise ValueError(f"alpha must be <= 1, got {self.alpha}")


CONSTANT_POWER = PowerModel(alpha=0.0)       # Scenario 1
PROPORTIONAL_POWER = PowerModel(alpha=1.0)   # Scenario 2


def validate_affinity_2x2(mu: np.ndarray) -> None:
    """Check heterogeneity constraints (paper eq. 2) for affinity systems.

    mu11 > mu12 (P1-type tasks faster on P1) and mu21 < mu22.
    Non-affinity systems (homogeneous / big.LITTLE / symmetric) are permitted
    with equalities, so we only reject strict violations.
    """
    mu = np.asarray(mu, dtype=np.float64)
    if mu.shape != (2, 2):
        raise ValueError(f"expected 2x2 affinity matrix, got {mu.shape}")
    if np.any(mu <= 0):
        raise ValueError("processing rates must be positive")
    if mu[0, 0] < mu[0, 1] or mu[1, 0] > mu[1, 1]:
        # mu11 >= mu12 and mu21 <= mu22 must hold up to relabeling.
        raise ValueError(
            "affinity constraint violated: need mu11 >= mu12 and mu21 <= mu22 "
            f"(got {mu}); relabel task types so type-i favors processor i"
        )


def classify_2x2(mu: np.ndarray, rtol: float = 1e-9) -> AffinityCase:
    """Classify a 2x2 affinity matrix into the Table 1 cases.

    Only element ORDERINGS matter (paper Sec. 3.3, CAB advantage 2).
    """
    mu = np.asarray(mu, dtype=np.float64)
    m11, m12 = mu[0]
    m21, m22 = mu[1]

    def eq(a, b):
        return np.isclose(a, b, rtol=rtol)

    if eq(m11, m12) and eq(m11, m21) and eq(m11, m22):
        return AffinityCase.HOMOGENEOUS
    if eq(m11, m21) and eq(m12, m22) and not eq(m11, m22):
        return AffinityCase.BIG_LITTLE
    if eq(m11, m22) and eq(m12, m21) and m11 > m12:
        return AffinityCase.SYMMETRIC
    # Affinity constraints: mu11 > mu12, mu21 < mu22 (strict from here on).
    if not (m11 > m12 and m21 < m22):
        return AffinityCase.INVALID
    if m11 > m21 and m22 > m12:
        return AffinityCase.GENERAL_SYMMETRIC
    if m11 > m21 and m12 > m22:
        return AffinityCase.P1_BIASED
    if m21 > m11 and m22 > m12:
        return AffinityCase.P2_BIASED
    # m21 > m11 and m12 > m22 would need mu11 both > and < mu21 (case b.4).
    return AffinityCase.INVALID


def random_affinity_matrix(
    rng: np.random.Generator, k: int, l: int, low: float = 1.0, high: float = 30.0
) -> np.ndarray:
    """Random k x l affinity matrix with positive rates (paper Sec. 6 setup)."""
    return rng.uniform(low, high, size=(k, l))
