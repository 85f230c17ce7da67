"""Paper <-> framework bridge: heterogeneous pools, the unified
Policy/SchedulerCore scheduling API on torch, and the autoscale governor."""
from repro_torch.sched.api import (Policy, SchedulerCore, SystemView, as_core,
                                   available_policies,
                                   deficit_route_masked_torch,
                                   deficit_route_torch,
                                   get_policy, register_policy,
                                   solve_targets_grid_torch,
                                   solve_targets_torch)
from repro_torch.sched.autoscale import (AutoscaleGovernor, BudgetSpec,
                                         Decision, GovernorConfig,
                                         StaticScaler, UtilizationScaler,
                                         decisions_to_events,
                                         price_frequency_grid,
                                         run_autoscaled)
from repro_torch.sched.baselines import BaselineClusterScheduler
from repro_torch.sched.cluster import (ChipSpec, HeterogeneousCluster, Pool,
                                       PoolSpec, TaskRecord)
from repro_torch.sched.priority import (CABPriorityPolicy, GrInPriorityPolicy,
                                        priority_open_config,
                                        priority_sim_config)
from repro_torch.sched.rates import (StepCost, affinity_from_roofline,
                                     serving_step_costs, step_time_roofline)
from repro_torch.sched.scheduler import ClusterScheduler, run_closed_loop

__all__ = [s for s in dir() if not s.startswith("_")]
