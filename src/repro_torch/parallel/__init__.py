"""Sharding and mesh utilities (the reference's `parallel/`): the logical-
axis rules, partition specs of the parameters, and a mesh stand-in. This
round runs on one card, where every spec divides by one; the specs size
the dry-run's cells and say how a multi-card run would shard."""
from repro_torch.parallel.sharding import (Mesh, RULES_MULTI_POD,
                                           RULES_PREFILL_MULTI,
                                           RULES_PREFILL_SINGLE,
                                           RULES_PURE_DP_MULTI,
                                           RULES_PURE_DP_SINGLE,
                                           RULES_SINGLE_POD, Spec,
                                           compute_param_specs, constrain,
                                           current_mesh, even_spec,
                                           logical_to_spec,
                                           param_logical_axes,
                                           param_pspec_tree, rules_for_mesh,
                                           shard_count, use_mesh)

__all__ = [s for s in dir() if not s.startswith("_")]
