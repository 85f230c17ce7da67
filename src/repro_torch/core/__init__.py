"""Paper core: optimal heterogeneous task scheduling (CAB + GrIn), host
float64 forms and batched torch forms."""
from repro_torch.core.affinity import (AffinityCase, PowerModel,
                                       CONSTANT_POWER, PROPORTIONAL_POWER,
                                       classify_2x2, random_affinity_matrix,
                                       validate_affinity_2x2)
from repro_torch.core.cab import (CABSolution, cab_closed_form_x, cab_solve,
                                  cab_target_state)
from repro_torch.core.energy import (DVFSModel, edp, edp_batch_torch,
                                     expected_delay,
                                     expected_delay_batch_torch,
                                     expected_energy_batch_torch,
                                     expected_energy_per_task,
                                     power_matrix_torch, scenario_identities)
from repro_torch.core.exhaustive import exhaustive_count, exhaustive_solve
from repro_torch.core.grin import (GrInBlockResult, GrInResult,
                                   grin_block_solve, grin_init, grin_solve,
                                   grin_solve_batch_steps_torch,
                                   grin_solve_batch_torch, grin_solve_torch)
from repro_torch.core.grin_energy import GrInEnergyResult, grin_energy_solve
from repro_torch.core.priority import (GrInPriorityResult,
                                       cab_priority_solve,
                                       class_energy_per_task, class_of_flat,
                                       class_throughputs,
                                       class_throughputs_batch_torch,
                                       delta_w_add_block_priority,
                                       delta_w_remove_block_priority,
                                       delta_xw_add_block_priority,
                                       delta_xw_remove_block_priority,
                                       flat_mu, flatten_mixes, flatten_state,
                                       grin_priority_solve,
                                       grin_solve_priority_batch_torch,
                                       priority_mu, unflatten_state,
                                       weighted_system_throughput)
from repro_torch.core.grin_plus import (grin_multistart_solve,
                                        grin_plus_solve, grin_solve_from)
from repro_torch.core.slsqp import (SLSQPResult, round_largest_remainder,
                                    slsqp_solve)
from repro_torch.core.throughput import (column_throughputs,
                                         column_throughputs_torch,
                                         delta_edp_move_block,
                                         delta_energy_move_block,
                                         delta_w_add_block,
                                         delta_w_remove_block, delta_x_add,
                                         delta_x_add_block, delta_x_remove,
                                         delta_x_remove_block,
                                         power_rate_columns, state_from_pair,
                                         system_throughput,
                                         system_throughput_batch_torch,
                                         system_throughput_torch,
                                         throughput_2x2, throughput_map_2x2)

__all__ = [s for s in dir() if not s.startswith("_")]
