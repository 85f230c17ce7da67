"""Sharding and mesh utilities (the reference's `parallel/`): the logical-
axis rules, partition specs of the parameters, a mesh stand-in, and on a
mesh of ranks the local pieces, re-layouts and the compute copy
(`sharding`) over the fixed-order collectives (`collectives`)."""
from repro_torch.parallel.sharding import (Mesh,
                                           RULES_MULTI_POD,
                                           RULES_PREFILL_MULTI,
                                           RULES_PREFILL_SINGLE,
                                           RULES_PURE_DP_MULTI,
                                           RULES_PURE_DP_SINGLE,
                                           RULES_SINGLE_POD, Spec,
                                           cast_and_reshard_compute_params,
                                           compute_param_specs, constrain,
                                           copy_to, current_mesh, even_spec,
                                           gather_params, gather_whole,
                                           live, local_slice,
                                           logical_to_spec,
                                           named_sharding_tree,
                                           param_logical_axes,
                                           param_pspec_tree,
                                           reduce_from,
                                           reduce_grads_to_masters,
                                           rules_for_mesh, shard_count,
                                           use_mesh)

__all__ = [s for s in dir() if not s.startswith("_")]
