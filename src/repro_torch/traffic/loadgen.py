"""Canonical load traces for autoscaling studies.

Three qualitatively different open-arrival shapes at a common mean rate —
the autoscale controllers (`repro_torch.sched.autoscale`) compare on
exactly these:

  diurnal: sinusoidal day/night swing (deep troughs are where parking and
           downclocking pay);
  bursty:  two-state MMPP on/off bursts (tests reaction speed and
           hysteresis);
  flash:   flat load with a flash-crowd step (a plateau at `flash_mult` x
           base in the middle of the horizon), replayed via TraceArrivals.
"""
from __future__ import annotations

import numpy as np

from repro_torch.traffic.arrivals import (DiurnalArrivals, MMPPArrivals,
                                          TraceArrivals, TrafficSpec)


def flash_crowd_times(base: float, horizon: float, *, flash_mult: float = 3.0,
                      flash_frac: tuple = (0.45, 0.65),
                      seed: int = 0) -> np.ndarray:
    """Sorted arrival times of a flat-rate Poisson stream with a
    flash-crowd plateau at `flash_mult * base` over the central
    `flash_frac` window, drawn by thinning at the peak rate."""
    rng = np.random.default_rng([int(seed), 0])
    peak = base * flash_mult
    n_draw = int(peak * horizon * 1.2) + 64
    t = np.cumsum(rng.exponential(1.0 / peak, size=n_draw))
    t = t[t < horizon]
    t0, t1 = horizon * flash_frac[0], horizon * flash_frac[1]
    rate = np.where((t >= t0) & (t < t1), peak, base)
    keep = rng.uniform(size=t.size) < rate / peak
    return t[keep]


def make_load_traces(type_probs, *, base: float = 60.0,
                     horizon: float = 240.0, period: float = 120.0,
                     amplitude: float = 0.85, flash_mult: float = 3.0,
                     seed: int = 0) -> dict:
    """{name: TrafficSpec} for the three canonical shapes, single-class
    over the `type_probs` row (the autoscale loop is class-free)."""
    tp = np.asarray(type_probs, dtype=np.float64)[None, :]
    flash = flash_crowd_times(base, horizon, flash_mult=flash_mult,
                              seed=seed)
    return {
        "diurnal": TrafficSpec(
            (DiurnalArrivals(base=base, amplitude=amplitude,
                             period=period),), tp),
        "bursty": TrafficSpec(
            (MMPPArrivals(rates=(2.4 * base, 0.3 * base),
                          mean_dwell=(0.18 * period, 0.42 * period)),), tp),
        "flash": TrafficSpec(
            (TraceArrivals(times=tuple(float(x) for x in flash)),), tp),
    }


__all__ = ["flash_crowd_times", "make_load_traces"]
