"""Response-time quantile accumulators.

Two paths, validated against each other:

  * `LogHistogram` — fixed-bin log-spaced histogram, the DEVICE accumulator:
    O(n_bins) memory, one scatter-add per completion inside the open
    engine's event loop, and quantiles recovered afterwards with a
    DOCUMENTED relative error bound. With n_bins bins spanning [lo, hi],
    each bin covers one factor g = (hi/lo)**(1/n_bins); the histogram's
    counts are exact, so the rank-selected bin is exactly the bin
    containing the true order statistic, and returning the bin's
    geometric midpoint lands within a factor sqrt(g) of the truth: rel
    error <= sqrt(g) - 1 for any sample in [lo, hi] (`rel_error_bound`). The defaults (256 bins over 1e-4..1e4)
    bound p50/p99/p999 within 3.7%.
  * `exact_quantiles` — the HOST path: exact order statistics of the full
    sorted sample (the `inverted_cdf` convention, matching the histogram's
    ceil-rank rule so the two paths estimate the same statistic).
"""
from __future__ import annotations

import dataclasses

import numpy as np

QUANTILES = (0.5, 0.99, 0.999)      # the p50/p99/p999 both engines report


@dataclasses.dataclass(frozen=True)
class LogHistogram:
    """Log-spaced fixed-bin histogram over [lo, hi] with n_bins bins.

    Samples below lo clamp into bin 0 and above hi into the last bin, so
    the error bound only covers samples inside [lo, hi] — size the range
    generously (it costs log-width, not memory resolution)."""

    lo: float = 1e-4
    hi: float = 1e4
    n_bins: int = 256

    def __post_init__(self):
        if not (0 < self.lo < self.hi) or self.n_bins < 2:
            raise ValueError(f"need 0 < lo < hi and n_bins >= 2; got "
                             f"({self.lo}, {self.hi}, {self.n_bins})")

    @property
    def growth(self) -> float:
        """Per-bin geometric width g: bin b spans lo * g**b .. lo * g**(b+1)."""
        return (self.hi / self.lo) ** (1.0 / self.n_bins)

    @property
    def log_growth(self) -> float:
        return np.log(self.hi / self.lo) / self.n_bins

    @property
    def rel_error_bound(self) -> float:
        """Worst-case relative error of `quantile` for in-range samples."""
        return float(np.sqrt(self.growth) - 1.0)

    def edges(self) -> np.ndarray:
        """(n_bins + 1,) bin edges, geometric from lo to hi."""
        return self.lo * self.growth ** np.arange(self.n_bins + 1)

    def bin_index(self, x) -> np.ndarray:
        """Bin of each sample (host path), clamped into [0, n_bins - 1]."""
        x = np.maximum(np.asarray(x, dtype=np.float64), 1e-300)
        b = np.floor(np.log(x / self.lo) / self.log_growth)
        return np.clip(b, 0, self.n_bins - 1).astype(np.int64)

    def counts(self, samples) -> np.ndarray:
        """(n_bins,) histogram of a sample array."""
        return np.bincount(self.bin_index(samples), minlength=self.n_bins)

    def quantile(self, counts, q: float) -> float:
        """Quantile estimate from a counts vector: the geometric midpoint of
        the bin holding the ceil(q * n)-th order statistic (inverted-CDF
        rank rule). NaN on an empty histogram."""
        counts = np.asarray(counts, dtype=np.float64)
        total = counts.sum()
        if total <= 0:
            return float("nan")
        rank = min(max(int(np.ceil(q * total)), 1), int(round(total)))
        b = int(np.searchsorted(np.cumsum(counts), rank - 0.5))
        return float(self.lo * self.growth ** (b + 0.5))

    def quantiles(self, counts, qs=QUANTILES) -> np.ndarray:
        counts = np.asarray(counts)
        if counts.ndim == 1:
            return np.asarray([self.quantile(counts, q) for q in qs])
        return np.stack([self.quantiles(row, qs) for row in counts])


def hist_quantile_rows_torch(counts, q, lo: float, log_growth: float):
    """`LogHistogram.quantile` over the rows of a tensor.

    ``counts (..., n_bins)`` running histograms, ``q`` a float or a tensor
    broadcasting against the leading dims; returns ``(...)`` geometric-
    midpoint estimates by the identical ceil-rank rule
    (`searchsorted(cumsum, rank - 0.5)` as a predicate sum), in the dtype
    of ``counts`` (float64 rows reproduce the host method to f64
    resolution). Empty rows return the bin-0 midpoint — callers gate on
    their own minimum-observation count (the speculative-hedge trigger
    masks rows below ``hedge_min_obs`` to +inf).
    """
    import torch
    total = counts.sum(dim=-1)
    q = torch.as_tensor(q, dtype=counts.dtype, device=counts.device)
    rank = torch.minimum(torch.clamp(torch.ceil(q * total), min=1.0),
                         torch.clamp(total, min=1.0))
    cum = torch.cumsum(counts, dim=-1)
    b = (cum < (rank[..., None] - 0.5)).sum(dim=-1)
    return lo * torch.exp(log_growth * (b.to(counts.dtype) + 0.5))


def exact_quantiles(samples, qs=QUANTILES) -> np.ndarray:
    """Exact order-statistic quantiles (inverted-CDF: the ceil(q * n)-th
    sorted sample), the host oracle the histogram path is bounded against.
    NaN-filled for an empty sample."""
    x = np.sort(np.asarray(samples, dtype=np.float64))
    if x.size == 0:
        return np.full(len(qs), np.nan)
    ranks = np.clip(np.ceil(np.asarray(qs) * x.size).astype(np.int64), 1,
                    x.size)
    return x[ranks - 1]


__all__ = ["LogHistogram", "exact_quantiles", "hist_quantile_rows_torch",
           "QUANTILES"]
