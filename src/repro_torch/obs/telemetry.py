"""Time-resolved telemetry: fixed-bin series shared by host and device.

The device engines (`repro_torch.sim.engine_torch`,
`repro_torch.traffic.engine_torch`) can carry four fixed-bin time series
through the run — per-pool occupancy, per-pool true-work backlog, total
power draw, and in-flight hedge count — and the host oracle loops
accumulate the identical series through `TelemetryAccumulator` (the twin
the conformance cell compares against).

Binning convention (both sides MUST match):

  * the horizon [0, H] splits into `n_bins` equal bins (open mode:
    H = t_end, the last arrival's time; closed mode: the caller supplies
    H);
  * each inter-event interval [t, t + dt) charges its dt-weighted
    quantities to the bin containing the interval's START, with the charge
    clipped at the horizon (time past H charges nothing — the host loop
    stops at the last arrival while the device core keeps draining, so
    unclipped tails would diverge);
  * `telemetry_series` converts the raw integrals to per-bin time
    averages by dividing by the bin width.

Telemetry off (n_bins = 0) skips the stanza in the engine's loop: no
telemetry state is allocated and every result is unchanged.
"""
from __future__ import annotations

import numpy as np
import torch


def telemetry_bin_weights(now, w, bin_width, bins) -> torch.Tensor:
    """The device side of the convention: (B, n_bins) charges, each
    point's interval weight w (B,) in the bin holding its start `now` (B,);
    `bins` is arange(n_bins)[None]."""
    b = torch.clamp((now / bin_width).to(torch.int64), 0, bins.shape[1] - 1)
    return torch.where(bins == b[:, None], w[:, None], 0.0)


class TelemetryAccumulator:
    """Host twin of the device telemetry carries.

    add(t, dt, pool_counts, pool_backlog, power, hedges) charges one
    inter-event interval starting at `t`; series() returns the same
    raw-integral arrays the device core produces.
    """

    def __init__(self, n_bins: int, horizon: float, n_pools: int):
        if n_bins < 1:
            raise ValueError(f"n_bins must be >= 1; got {n_bins}")
        if not horizon > 0:
            raise ValueError(f"horizon must be > 0; got {horizon}")
        self.n_bins = int(n_bins)
        self.horizon = float(horizon)
        self.bin_width = self.horizon / self.n_bins
        self.occupancy = np.zeros((self.n_bins, n_pools))
        self.backlog = np.zeros((self.n_bins, n_pools))
        self.power = np.zeros(self.n_bins)
        self.hedges = np.zeros(self.n_bins)

    def add(self, t: float, dt: float, pool_counts, pool_backlog,
            power: float, hedges: float = 0.0) -> None:
        """Charge the interval [t, t + dt) to the bin containing t, clipped
        at the horizon."""
        if dt <= 0.0 or t >= self.horizon:
            return
        w = min(t + dt, self.horizon) - t
        b = min(int(t / self.bin_width), self.n_bins - 1)
        self.occupancy[b] += w * np.asarray(pool_counts, dtype=np.float64)
        self.backlog[b] += w * np.asarray(pool_backlog, dtype=np.float64)
        self.power[b] += w * power
        self.hedges[b] += w * hedges

    def series(self) -> dict:
        """Raw dt-weighted integrals per bin (device-core layout)."""
        return {"occupancy": self.occupancy.copy(),
                "backlog": self.backlog.copy(), "power": self.power.copy(),
                "hedges": self.hedges.copy(),
                "bin_width": self.bin_width, "horizon": self.horizon}


def telemetry_series(raw: dict) -> dict:
    """Convert raw per-bin integrals to per-bin TIME AVERAGES (divide by
    the bin width). Works on host (`TelemetryAccumulator.series()`) and
    device (`simulate_*_batch` "telemetry" entries, per batch row) output;
    batch leading axes pass through."""
    bw = np.asarray(raw["bin_width"], dtype=np.float64)
    out = {"bin_width": bw, "horizon": raw["horizon"]}
    for key in ("occupancy", "backlog", "power", "hedges"):
        v = np.asarray(raw[key], dtype=np.float64)
        if v.ndim and bw.ndim:        # batched: bin axis follows batch axes
            shape = bw.shape + (1,) * (v.ndim - bw.ndim)
            out[key] = v / np.maximum(bw.reshape(shape), 1e-30)
        else:
            out[key] = v / max(float(bw), 1e-30)
    return out


__all__ = ["TelemetryAccumulator", "telemetry_series",
           "telemetry_bin_weights"]
