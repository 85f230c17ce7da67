// The backward of the SSD scan at states up to 128 x 128 (Mamba2's 64 x 64
// heads): the gradients of ssd_scan.cu's y and final state with respect to
// q, k, v, log_a and beta, for the training path of the hybrid family.
//
// Replaces no TPU kernel of its own: the reference has no backward kernel
// for src/repro/kernels/ssd_scan.py::ssd_scan_pallas (pallas_call at :85)
// and differentiates its jnp route with jax.vjp. The kernels, their math,
// their bound and their design are in ssd_bwd.cuh, shared with the wide
// pair's backward (ssd_scan_wide_bwd.cu). What this entry point adds: q and
// k may be Mamba2's B and C, one row per token expanded over the heads (a
// head stride of 0, read in place); their gradients are then the sums over
// the 112 heads, taken in head order by the last launch (sum_q / sum_k),
// so dq and dk leave as (B, S, 1, dk). No normaliser column. At Mamba2's
// 64 x 64 heads the state is one tile, so a chunk's scores and all three
// gradients take one launch (`bwd_fused`, two warpgroups) that reads the
// chunk's dS once; 128 x 128 states take `bwd_scores` and `bwd_grads`.
#include "ssd_bwd.cuh"

// ptrs, dims, dtype and stream as ssd_bwd::entry describes; returns a
// cudaError_t (0 on clean launches).
extern "C" int ssd_scan_bwd(const unsigned long long* ptrs,
                            const long long* dims, int dtype, void* stream) {
  if (dims[6] != 0) return (int)cudaErrorInvalidValue;   // no normaliser
  return ssd_bwd::entry(ptrs, dims, dtype, stream, 128);
}
