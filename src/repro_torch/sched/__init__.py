"""The unified Policy/SchedulerCore scheduling API on torch."""
from repro_torch.sched.api import (Policy, SchedulerCore, SystemView, as_core,
                                   available_policies,
                                   deficit_route_masked_torch,
                                   deficit_route_torch,
                                   get_policy, register_policy,
                                   solve_targets_grid_torch,
                                   solve_targets_torch)
from repro_torch.sched.baselines import BaselineClusterScheduler
from repro_torch.sched.priority import (CABPriorityPolicy, GrInPriorityPolicy,
                                        priority_open_config,
                                        priority_sim_config)

__all__ = [s for s in dir() if not s.startswith("_")]
