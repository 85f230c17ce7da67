// Block-move gain scoring + move selection for the batched GrIn solver, and
// the solver's whole loop fused around it.
//
// Replaces the reference package's Pallas TPU kernel
// repro/kernels/grin_moves.py::block_move_gains_pallas (bodies _kernel,
// _kernel_select, _kernel_obj, _kernel_select_obj) and, in
// grin_block_solve, the loop that calls it once per step
// (repro/core/grin.py::_grin_block_core, lax.while_loop). The scorer
// computes what those bodies compute, under all five objectives (runtime
// switch), for every instance of a batch:
//
//   gains[b, f]  the closed-form gain of move f = ((mi*k + p)*l + s)*l + d
//                (move sizes[mi] p-type tasks from column s to column d),
//                written only when the caller asks for it;
//   best_idx[b]  the steepest m=1 direction (first flat index among equal
//                maxima; under OBJ_XE the best energy drop among directions
//                within 4e-6*(1+|base|) of the steepest), sized by the
//                largest ladder entry whose prefix of doubling slopes stays
//                >= max(runner-up m=1 gain, 0);
//   best_gain[b] that move's gain; base_gain[b] the steepest m=1 gain.
//
// Design: one warp per instance (four per block), a grid-stride loop over
// the batch, no padding of B. The warp stages N, mu and P in shared memory
// and derives the column sums, X and W there; lanes stride over the k*l*l
// directions and over the M*k*l*l moves (coalesced gain writes), a
// (value, index) butterfly of shuffles picks the direction and the
// runner-up (each lane keeps its best and second best from the same pass),
// and the ladder's sizes are scored one a lane, its leading run found by
// one ballot. Directions are decoded with float reciprocals of l and l*l,
// not integer division.
//
// What bounds it on an H100: per instance a step reads 3*k*l floats (N,
// mu, P) and writes three scalars, 300-400 bytes at 4x6; the gains tensor,
// when asked for, adds M*k*l*l floats (7.5 KB at 4x6, M = 13). Even at
// B = 4096 the bytes take well under a microsecond at 3.35 TB/s and the
// float32 arithmetic (about 11 operations per scored move, 30 under the
// energy objectives) a few microseconds at 67 TFLOP/s: a launch and one
// pass of dependent shuffles set a step's time, not memory or arithmetic.
// A solve takes thousands of steps (until its slowest instance
// converges), so launching once a step leaves the card idle between
// launches. grin_block_solve therefore runs each instance's whole solve in
// its warp: N stays in shared memory, and the warp repeats statistics,
// selection, the convergence test against TOL_BLOCK * (1 + scale) and the
// move until no move clears it or `cap` steps; under OBJ_XE the X-plateau
// energy phase (OBJ_E_GUARD) follows in the same launch. Instances are
// independent, so each stops at its own convergence; what remains is the
// slowest instance's chain of dependent steps.
//
// Built with --fmad=false and without --use_fast_math: each product and sum
// rounds on its own, as in the plain PyTorch version, so the two differ only
// by the order of the column sums (and, for the solve's threshold, of the
// sum over columns).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int OBJ_X = 0, OBJ_XE = 1, OBJ_E = 2, OBJ_EDP = 3, OBJ_E_GUARD = 4;
constexpr float XE_TIE = 4e-6f;
constexpr float TOL_BLOCK = 1e-6f;  // core/grin.py _TOL32_BLOCK
constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -INFINITY;

struct Inst {
  const float* N;   // (k, l) shared
  const float* mu;
  const float* P;
  const float* c;   // (l,) column sums
  const float* X;   // (l,) column throughputs
  const float* W;   // (l,) column power rates
  float Xs, Ws, ntot;
  int l;
};

// Gain of moving m p-type tasks s -> d under `obj`; *tie receives the
// energy drop (OBJ_XE's tie-break score).
__device__ float move_gain(const Inst& I, float m, int p, int s, int d,
                           int obj, float* tie) {
  const int l = I.l;
  const float cs = I.c[s], cd = I.c[d];
  const float mus = I.mu[p * l + s], mud = I.mu[p * l + d];
  const float xs = I.X[s], xd = I.X[d];
  const bool drains = !(cs - m > 0.5f);
  const float addx = m * (mud - xd) / (cd + m);
  const float remx = drains ? -xs : m * (xs - mus) / fmaxf(cs - m, 1.0f);
  const bool src_ok = I.N[p * l + s] >= m;
  if (obj == OBJ_X) {
    if (s == d) return NEG;
    return (src_ok ? remx : NEG) + addx;
  }
  const float ps = I.P[p * l + s], pd = I.P[p * l + d];
  const float ws = I.W[s], wd = I.W[d];
  const float addw = m * (pd - wd) / (cd + m);
  const float remw = drains ? -ws : m * (ws - ps) / fmaxf(cs - m, 1.0f);
  const float dX = remx + addx;
  const float dW = remw + addw;
  const bool feas = src_ok && (s != d);
  const float X1 = I.Xs + dX;
  const bool ok = feas && (X1 > 0.0f) && (I.Xs > 0.0f);
  const float e_drop = ok ? I.Ws / fmaxf(I.Xs, 1e-30f)
                                - (I.Ws + dW) / fmaxf(X1, 1e-30f)
                          : NEG;
  switch (obj) {
    case OBJ_XE:
      *tie = e_drop;
      return feas ? dX : NEG;
    case OBJ_E:
      return e_drop;
    case OBJ_EDP:
      return ok ? I.ntot * (I.Ws / fmaxf(I.Xs * I.Xs, 1e-30f)
                            - (I.Ws + dW) / fmaxf(X1 * X1, 1e-30f))
                : NEG;
    default:  // OBJ_E_GUARD
      return (dX >= -XE_TIE * (1.0f + I.Xs)) ? e_drop : NEG;
  }
}

// Warp-wide argmax with ties broken toward the lower index; every lane ends
// with the result.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// Per-warp shared-memory slices of one instance: N, mu, P (k*l each) and the
// column statistics c, X, W (l each).
struct Slices {
  float* N;
  float* mu;
  float* P;
  float* c;
  float* X;
  float* W;
};

__device__ __forceinline__ Slices warp_slices(float* smem, int warp, int kl,
                                              int l) {
  Slices s;
  s.N = smem + warp * (3 * kl + 3 * l);
  s.mu = s.N + kl;
  s.P = s.mu + kl;
  s.c = s.P + kl;
  s.X = s.c + l;
  s.W = s.X + l;
  return s;
}

// Stage instance b's N, mu and P (zeros without P).
__device__ __forceinline__ void stage(const Slices& s, const float* N,
                                      const float* mu, const float* P,
                                      long long off, int kl, int lane) {
  for (int e = lane; e < kl; e += 32) {
    s.N[e] = N[off + e];
    s.mu[e] = mu[off + e];
    s.P[e] = P != nullptr ? P[off + e] : 0.0f;
  }
  __syncwarp();
}

// Column sums, X and W of the staged N, and their sums over the columns
// (every lane gets the same view).
__device__ __forceinline__ Inst column_stats(const Slices& s, int k, int l,
                                             int lane) {
  __syncwarp();
  for (int j = lane; j < l; j += 32) {
    float c = 0.0f, wx = 0.0f, wp = 0.0f;
    for (int i = 0; i < k; ++i) {
      const float n = s.N[i * l + j];
      c += n;
      wx += s.mu[i * l + j] * n;
      wp += s.P[i * l + j] * n;
    }
    s.c[j] = c;
    s.X[j] = c > 0.0f ? wx / fmaxf(c, 1.0f) : 0.0f;
    s.W[j] = c > 0.0f ? wp / fmaxf(c, 1.0f) : 0.0f;
  }
  __syncwarp();
  Inst I{s.N, s.mu, s.P, s.c, s.X, s.W, 0.0f, 0.0f, 0.0f, l};
  for (int j = 0; j < l; ++j) {
    I.Xs += s.X[j];
    I.Ws += s.W[j];
    I.ntot += s.c[j];
  }
  return I;
}

struct Move {
  int idx;         // flat index into (M, k, l, l)
  int p, s, d;     // its type, source and destination
  float m;         // its block size
  float best;      // its gain
  float base;      // the steepest m=1 gain
};

// Direction r = (p * l + s) * l + d decoded by multiplying with float
// reciprocals: exact for r < 2^22 (the entry points check k * l * l), and
// free of integer divisions by a run-time l.
struct Decoder {
  float inv_ll, inv_l;
  int l, ll;
  __device__ __forceinline__ explicit Decoder(int l_)
      : inv_ll(1.0f / static_cast<float>(l_ * l_)),
        inv_l(1.0f / static_cast<float>(l_)), l(l_), ll(l_ * l_) {}
  __device__ __forceinline__ void operator()(int r, int& p, int& s,
                                             int& d) const {
    p = static_cast<int>((static_cast<float>(r) + 0.5f) * inv_ll);
    const int rem = r - p * ll;
    s = static_cast<int>((static_cast<float>(rem) + 0.5f) * inv_l);
    d = rem - s * l;
  }
};

// The scorer's selection for one staged instance; every lane gets it.
// Direction: steepest m=1 move (first index among equal maxima; under
// OBJ_XE the best energy drop inside the tie band). Size: the leading run
// of ladder entries (ascending 1, 2, 4, ...) whose doubling slope stays
// >= max(runner-up, 0), one ladder entry a lane (M <= 32; lane a holds
// sizes[M - 1 - a] in lane_size, and m1 = sizes[M - 1]); NaN compares
// false.
__device__ Move select_move(const Inst& I, const Decoder& dec, float m1,
                            float lane_size, int k, int M, int obj,
                            int lane) {
  const int dirs = k * dec.ll;
  float tie = NEG;
  // One pass: each lane's best (first index among equal maxima) and the
  // best of its other directions, for the runner-up below.
  float bv = NEG, b2 = NEG;
  int bi = INT_MAX;
  for (int r = lane; r < dirs; r += 32) {
    int p, s, d;
    dec(r, p, s, d);
    const float g = move_gain(I, m1, p, s, d, obj, &tie);
    if (g > bv || (g == bv && r < bi)) {
      b2 = fmaxf(b2, bv);
      bv = g;
      bi = r;
    } else {
      b2 = fmaxf(b2, g);
    }
  }
  const float lane_best = bv, lane_second = b2;
  const int lane_bi = bi;
  warp_argmax(bv, bi);
  const float base = bv;
  int d1 = bi;
  if (obj == OBJ_XE) {
    const float band = base - XE_TIE * (1.0f + fabsf(base));
    float tv = NEG;
    int ti = INT_MAX;
    for (int r = lane; r < dirs; r += 32) {
      int p, s, d;
    dec(r, p, s, d);
      const float g = move_gain(I, m1, p, s, d, obj, &tie);
      const float v = g >= band ? tie : NEG;
      if (v > tv || (v == tv && r < ti)) {
        tv = v;
        ti = r;
      }
    }
    warp_argmax(tv, ti);
    d1 = ti;
  }
  // Runner-up: the best m=1 gain with only the chosen direction masked —
  // a lane's best, or its second where its best is d1.
  const float rv = warp_max(lane_bi == d1 ? lane_second : lane_best);

  int p, s, d;
  dec(d1, p, s, d);
  const float thresh = fmaxf(rv, 0.0f);
  const float g = lane < M ? move_gain(I, lane_size, p, s, d, obj, &tie)
                           : NEG;
  float prev_g = __shfl_up_sync(FULL, g, 1);
  if (lane == 0) prev_g = 0.0f;
  const float sa = __int_as_float((127 + lane) << 23);          // 2^lane
  const float prev_s = lane == 0 ? 0.0f : 0.5f * sa;
  const bool ok = lane < M && (g - prev_g) / (sa - prev_s) >= thresh;
  const unsigned fails = __ballot_sync(FULL, !ok);
  const int run = fails != 0u ? __ffs(fails) - 1 : 32;
  const int idx_asc = run > 0 ? run - 1 : 0;
  Move mv;
  mv.best = __shfl_sync(FULL, g, idx_asc);
  mv.m = __shfl_sync(FULL, lane_size, idx_asc);
  mv.idx = (M - 1 - idx_asc) * dirs + d1;
  mv.p = p;
  mv.s = s;
  mv.d = d;
  mv.base = base;
  return mv;
}

// The magnitude a phase's convergence threshold is relative to: X_sys for
// the throughput objectives, |E[E]| (eq. 19) or |EDP| (eq. 21) for the
// energy ones, inf where X_sys is 0 (as the plain loop's scale_for).
__device__ __forceinline__ float objective_scale(const Inst& I, int obj) {
  if (obj == OBJ_X || obj == OBJ_XE) return I.Xs;
  if (!(I.Xs > 0.0f)) return INFINITY;
  const float e = I.Ws / fmaxf(I.Xs, 1e-30f);
  if (obj == OBJ_EDP) return fabsf(e * (I.ntot / fmaxf(I.Xs, 1e-30f)));
  return fabsf(e);
}

__global__ void __launch_bounds__(WARPS * 32)
grin_moves_kernel(const float* __restrict__ N, const float* __restrict__ mu,
                  const float* __restrict__ P,
                  const float* __restrict__ sizes, float* __restrict__ gains,
                  int* __restrict__ best_idx, float* __restrict__ best_gain,
                  float* __restrict__ base_gain, int B, int k, int l, int M,
                  int obj) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kl = k * l;
  const Slices sl = warp_slices(smem, warp, kl, l);
  const int ll = l * l;
  const int dirs = k * ll;
  const long long F = static_cast<long long>(M) * dirs;
  const Decoder dec(l);
  const float m1 = sizes[M - 1];
  const float lane_size = lane < M ? sizes[M - 1 - lane] : 0.0f;

  for (long long b = static_cast<long long>(blockIdx.x) * WARPS + warp;
       b < B; b += static_cast<long long>(gridDim.x) * WARPS) {
    stage(sl, N, mu, obj != OBJ_X ? P : nullptr, b * kl, kl, lane);
    const Inst I = column_stats(sl, k, l, lane);
    if (gains != nullptr) {
      float* g_out = gains + b * F;
      float tie = NEG;
      for (long long f = lane; f < F; f += 32) {
        const int mi = static_cast<int>(f / dirs);
        const int r = static_cast<int>(f - static_cast<long long>(mi) * dirs);
        g_out[f] = move_gain(I, sizes[mi], r / ll, (r / l) % l, r % l, obj,
                             &tie);
      }
    }
    const Move mv = select_move(I, dec, m1, lane_size, k, M, obj, lane);
    if (lane == 0) {
      best_idx[b] = mv.idx;
      best_gain[b] = mv.best;
      base_gain[b] = mv.base;
    }
    __syncwarp();
  }
}

// The whole block-move solve, one warp per instance: the plain loop's
// run_phase (core/grin.py) step for step, on the staged instance, until no
// move clears TOL_BLOCK * (1 + scale) or `cap` steps; under OBJ_XE a second
// phase (OBJ_E_GUARD) with its own cap follows and the converged flags are
// ANDed. N is updated in place.
__global__ void __launch_bounds__(WARPS * 32)
grin_solve_kernel(float* __restrict__ N, const float* __restrict__ mu,
                  const float* __restrict__ P,
                  const float* __restrict__ sizes, int* __restrict__ moves,
                  int* __restrict__ converged, int B, int k, int l, int M,
                  int cap, int obj) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kl = k * l;
  const Slices sl = warp_slices(smem, warp, kl, l);
  const Decoder dec(l);
  const float m1 = sizes[M - 1];
  const float lane_size = lane < M ? sizes[M - 1 - lane] : 0.0f;

  for (long long b = static_cast<long long>(blockIdx.x) * WARPS + warp;
       b < B; b += static_cast<long long>(gridDim.x) * WARPS) {
    stage(sl, N, mu, obj != OBJ_X ? P : nullptr, b * kl, kl, lane);
    int n_moves = 0;
    bool conv = true;
    for (int phase = 0; phase < (obj == OBJ_XE ? 2 : 1); ++phase) {
      const int pobj = phase == 0 ? obj : OBJ_E_GUARD;
      bool phase_conv = false;
      for (int it = 0; it < cap; ++it) {
        const Inst I = column_stats(sl, k, l, lane);
        const Move mv = select_move(I, dec, m1, lane_size, k, M, pobj, lane);
        // Convergence is the m=1 signal (warp-uniform).
        if (!(mv.base > TOL_BLOCK * (1.0f + objective_scale(I, pobj)))) {
          phase_conv = true;
          break;
        }
        if (lane == 0) {
          sl.N[mv.p * l + mv.s] -= mv.m;
          sl.N[mv.p * l + mv.d] += mv.m;
        }
        ++n_moves;
      }
      conv = conv && phase_conv;
    }
    __syncwarp();
    for (int e = lane; e < kl; e += 32) N[b * kl + e] = sl.N[e];
    if (lane == 0) {
      moves[b] = n_moves;
      converged[b] = conv ? 1 : 0;
    }
    __syncwarp();
  }
}

}  // namespace

namespace {

size_t warp_smem_bytes(int k, int l) {
  return static_cast<size_t>(WARPS) * (3 * k * l + 3 * l) * sizeof(float);
}

int grid_for(int B) {
  const long long want = (static_cast<long long>(B) + WARPS - 1) / WARPS;
  return static_cast<int>(want < 65536 ? want : 65536);
}

}  // namespace

// C entry points (bound by ctypes). Each launches on `stream` and returns
// cudaGetLastError() as an int; 0 is success.
//
// grin_block_move_scores: one scoring + selection step. P and gains may be
// null (OBJ_X / the selection-only call).
extern "C" int grin_block_move_scores(const float* N, const float* mu,
                                      const float* P, const float* sizes,
                                      float* gains, int* best_idx,
                                      float* best_gain, float* base_gain,
                                      int B, int k, int l, int M,
                                      int objective, void* stream) {
  if (B <= 0 || k <= 0 || l <= 0 || M <= 0 || M > 32 ||
      static_cast<long long>(k) * l * l >= (1 << 22) || objective < OBJ_X ||
      objective > OBJ_E_GUARD || (objective != OBJ_X && P == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = warp_smem_bytes(k, l);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  grin_moves_kernel<<<grid_for(B), WARPS * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      N, mu, P, sizes, gains, best_idx, best_gain, base_gain, B, k, l, M,
      objective);
  return static_cast<int>(cudaGetLastError());
}

// grin_block_solve: the whole solve from the initial placements in N
// (updated in place) under OBJ_X, OBJ_XE (two phases), OBJ_E or OBJ_EDP;
// writes each instance's accepted moves and converged flag (0 / 1).
extern "C" int grin_block_solve(float* N, const float* mu, const float* P,
                                const float* sizes, int* moves,
                                int* converged, int B, int k, int l, int M,
                                int cap, int objective, void* stream) {
  if (B <= 0 || k <= 0 || l <= 0 || M <= 0 || M > 32 || cap < 0 ||
      static_cast<long long>(k) * l * l >= (1 << 22) ||
      objective < OBJ_X || objective > OBJ_EDP ||
      (objective != OBJ_X && P == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = warp_smem_bytes(k, l);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  grin_solve_kernel<<<grid_for(B), WARPS * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      N, mu, P, sizes, moves, converged, B, k, l, M, cap, objective);
  return static_cast<int>(cudaGetLastError());
}
