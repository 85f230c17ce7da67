// The backward of mLSTM's pair of SSD scans (ssd_scan_wide.cu's
// mlstm_scan_cuda): the memory (dk x dv, up to 512 x 512) and its
// normaliser (v = ones, dv = 1) in one call, for the training path of the
// ssm family; with the normaliser off, the backward of ssd_scan_wide_cuda.
//
// Replaces no TPU kernel of its own: the reference has no backward kernel
// for src/repro/kernels/ssd_scan.py::ssd_scan_pallas (pallas_call at :85)
// and differentiates its two jnp scans with jax.vjp. The kernels, their
// math, their bound and their design are in ssd_bwd.cuh, shared with the
// 64 x 64 backward (ssd_scan_bwd.cu). What this entry point adds: the
// memory and the normaliser share q, k, log_a and beta, so the pair is one
// scan of [v | 1] at the cotangents [dy | dnm] and [dC | dn] (norm = 1):
// the kernels read a column of ones beside v and dnm beside dy, never
// stored, and the two scans' gradients come out summed. The 512 x 513
// state of a head goes through device memory in 64 x 64 tiles (72 a head,
// the normaliser's column in a ninth column tile of its own): each chunk's
// contribution and the carry over the chunks per tile; the scores once a
// chunk (`bwd_scores`); then dq and dk~ per 64 columns of dk and dv per 64
// columns of dv (`bwd_grads`, 24 blocks a chunk).
#include "ssd_bwd.cuh"

// ptrs, dims, dtype and stream as ssd_bwd::entry describes; returns a
// cudaError_t (0 on clean launches).
extern "C" int mlstm_scan_bwd(const unsigned long long* ptrs,
                              const long long* dims, int dtype,
                              void* stream) {
  return ssd_bwd::entry(ptrs, dims, dtype, stream, 512);
}
