"""Batched closed-network simulation of the paper's batch network."""
from repro_torch.sim.distributions import (DISTRIBUTIONS, BoundedPareto,
                                           Constant, Exponential,
                                           TaskSizeDistribution, Uniform,
                                           make_distribution)
from repro_torch.sim.engine_torch import (compare_policies, simulate_batch,
                                          simulate_policy, sweep)
from repro_torch.sim.simulator import (ClosedNetworkSimulator, SimConfig,
                                      SimMetrics, run_policy_sweep)

__all__ = [s for s in dir() if not s.startswith("_")]
