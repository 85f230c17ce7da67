"""Open-network traffic: arrival streams, tail-latency quantiles, SLO
admission control, the host open loop and the batched device engine.

  * `arrivals`  — composable `ArrivalProcess` streams (Poisson, MMPP
    bursts, diurnal rate modulation, trace replay) merged per class into
    one (times, types) stream by `TrafficSpec`, bit-equal to the reference
    package's realizations.
  * `quantiles` — the fixed-bin log-histogram response-time accumulator
    and the exact host-side sorted-sample quantile path.
  * `admission` — per-class SLO specs and the adaptive admission
    controller.
  * `config`    — `OpenTraffic` / `open_sim_config`: set
    `SimConfig.traffic` and both engines run in open mode.
  * `host`      — the host open event loop (the oracle), dispatched by
    `ClosedNetworkSimulator.run` whenever `SimConfig.traffic` is set.
  * `engine_torch` — the batched open-network device engine
    (`simulate_open_batch`, `simulate_open_policy`).
  * `loadgen`   — the canonical diurnal / bursty / flash-crowd load
    traces the autoscale controllers compare on.
  * `replay`    — virtual-time open-loop trace replay for the serving path
    (`repro_torch.launch.serve --traffic`).
"""
from repro_torch.traffic.arrivals import (ArrivalProcess, DiurnalArrivals,
                                          MMPPArrivals, PoissonArrivals,
                                          TraceArrivals, TrafficSpec,
                                          load_trace)
from repro_torch.traffic.loadgen import flash_crowd_times, make_load_traces
from repro_torch.traffic.quantiles import LogHistogram, exact_quantiles
from repro_torch.traffic.admission import (AdmissionController, SLOClass,
                                           default_admit_limits)
from repro_torch.traffic.config import (OpenTraffic, derive_target_mix,
                                        open_sim_config)
from repro_torch.traffic.host import run_open
from repro_torch.traffic.engine_torch import (open_metrics_row,
                                              simulate_open_batch,
                                              simulate_open_policy)
from repro_torch.traffic.replay import OpenReplayMetrics, replay_open

__all__ = [s for s in dir() if not s.startswith("_")]
