// Block-move gain scoring + move selection for the batched GrIn solver.
//
// Replaces the reference package's Pallas TPU kernel
// repro/kernels/grin_moves.py::block_move_gains_pallas (bodies _kernel,
// _kernel_select, _kernel_obj, _kernel_select_obj). It computes what those
// bodies compute, under all five objectives (runtime switch), for every
// instance of a batch:
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
// runner-up, and lane 0 walks the ladder (at most 24 sizes).
//
// What bounds it on an H100: per instance it reads 3*k*l floats (N, mu, P)
// and writes three scalars, 300-400 bytes at 4x6; the gains tensor, when
// asked for, adds M*k*l*l floats (7.5 KB at 4x6, M = 13). The solver calls
// it without gains once per step, so even at B = 4096 the bytes take well
// under a microsecond at 3.35 TB/s and the float32 arithmetic (about 11
// operations per scored move, 30 under the energy objectives) a few
// microseconds at 67 TFLOP/s: the launch and one pass of dependent
// shuffles set the time, not memory or arithmetic. So the kernel fuses the
// whole step — statistics, scoring, both argmaxes and the ladder — into one
// launch with no intermediate in device memory, and never materialises the
// gains tensor on the solver's path.
//
// Built with --fmad=false and without --use_fast_math: each product and sum
// rounds on its own, as in the plain PyTorch version, so the two differ only
// by the order of the column sums.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int OBJ_X = 0, OBJ_XE = 1, OBJ_E = 2, OBJ_EDP = 3, OBJ_E_GUARD = 4;
constexpr float XE_TIE = 4e-6f;
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
  const bool energy = obj != OBJ_X;
  float* sN = smem + warp * (3 * kl + 3 * l);
  float* smu = sN + kl;
  float* sP = smu + kl;
  float* sc = sP + kl;
  float* sX = sc + l;
  float* sW = sX + l;
  const int ll = l * l;
  const int dirs = k * ll;
  const long long F = static_cast<long long>(M) * dirs;
  const float m1 = sizes[M - 1];

  for (long long b = static_cast<long long>(blockIdx.x) * WARPS + warp;
       b < B; b += static_cast<long long>(gridDim.x) * WARPS) {
    const long long off = b * kl;
    for (int e = lane; e < kl; e += 32) {
      sN[e] = N[off + e];
      smu[e] = mu[off + e];
      sP[e] = energy ? P[off + e] : 0.0f;
    }
    __syncwarp();
    for (int j = lane; j < l; j += 32) {
      float c = 0.0f, wx = 0.0f, wp = 0.0f;
      for (int i = 0; i < k; ++i) {
        const float n = sN[i * l + j];
        c += n;
        wx += smu[i * l + j] * n;
        wp += sP[i * l + j] * n;
      }
      sc[j] = c;
      sX[j] = c > 0.0f ? wx / fmaxf(c, 1.0f) : 0.0f;
      sW[j] = c > 0.0f ? wp / fmaxf(c, 1.0f) : 0.0f;
    }
    __syncwarp();
    Inst I{sN, smu, sP, sc, sX, sW, 0.0f, 0.0f, 0.0f, l};
    for (int j = 0; j < l; ++j) {
      I.Xs += sX[j];
      I.Ws += sW[j];
      I.ntot += sc[j];
    }
    float tie = NEG;

    if (gains != nullptr) {
      float* g_out = gains + b * F;
      for (long long f = lane; f < F; f += 32) {
        const int mi = static_cast<int>(f / dirs);
        const int r = static_cast<int>(f - static_cast<long long>(mi) * dirs);
        g_out[f] = move_gain(I, sizes[mi], r / ll, (r / l) % l, r % l, obj,
                             &tie);
      }
    }

    // Direction: steepest m=1 move (first index among equal maxima).
    float bv = NEG;
    int bi = INT_MAX;
    for (int r = lane; r < dirs; r += 32) {
      const float g = move_gain(I, m1, r / ll, (r / l) % l, r % l, obj, &tie);
      if (g > bv || (g == bv && r < bi)) {
        bv = g;
        bi = r;
      }
    }
    warp_argmax(bv, bi);
    const float base = bv;
    int d1 = bi;
    if (obj == OBJ_XE) {
      const float band = base - XE_TIE * (1.0f + fabsf(base));
      float tv = NEG;
      int ti = INT_MAX;
      for (int r = lane; r < dirs; r += 32) {
        const float g =
            move_gain(I, m1, r / ll, (r / l) % l, r % l, obj, &tie);
        const float v = g >= band ? tie : NEG;
        if (v > tv || (v == tv && r < ti)) {
          tv = v;
          ti = r;
        }
      }
      warp_argmax(tv, ti);
      d1 = ti;
    }
    // Runner-up: the best m=1 gain with only the chosen direction masked.
    float rv = NEG;
    for (int r = lane; r < dirs; r += 32) {
      if (r == d1) continue;
      rv = fmaxf(rv, move_gain(I, m1, r / ll, (r / l) % l, r % l, obj, &tie));
    }
    rv = warp_max(rv);

    if (lane == 0) {
      // Size: leading run of ladder entries (ascending 1, 2, 4, ...) whose
      // doubling slope stays >= max(runner-up, 0); NaN compares false.
      const int p = d1 / ll, s = (d1 / l) % l, d = d1 % l;
      const float thresh = fmaxf(rv, 0.0f);
      float prev_g = 0.0f, prev_s = 0.0f, best = 0.0f;
      int run = 0;
      for (int a = 0; a < M; ++a) {
        const float g = move_gain(I, sizes[M - 1 - a], p, s, d, obj, &tie);
        if (a == 0) best = g;
        const float sa = ldexpf(1.0f, a);
        if (!((g - prev_g) / (sa - prev_s) >= thresh)) break;
        best = g;
        ++run;
        prev_g = g;
        prev_s = sa;
      }
      const int idx_asc = run > 0 ? run - 1 : 0;
      best_idx[b] = (M - 1 - idx_asc) * dirs + d1;
      best_gain[b] = best;
      base_gain[b] = base;
    }
    __syncwarp();
  }
}

}  // namespace

// C entry point (bound by ctypes). P and gains may be null (OBJ_X / the
// solver's selection-only call). Launches on `stream` and returns
// cudaGetLastError() as an int; 0 is success.
extern "C" int grin_block_move_scores(const float* N, const float* mu,
                                      const float* P, const float* sizes,
                                      float* gains, int* best_idx,
                                      float* best_gain, float* base_gain,
                                      int B, int k, int l, int M,
                                      int objective, void* stream) {
  if (B <= 0 || k <= 0 || l <= 0 || M <= 0 || objective < OBJ_X ||
      objective > OBJ_E_GUARD || (objective != OBJ_X && P == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(WARPS) * (3 * k * l + 3 * l) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (static_cast<long long>(B) + WARPS - 1) / WARPS;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  grin_moves_kernel<<<blocks, WARPS * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      N, mu, P, sizes, gains, best_idx, best_gain, base_gain, B, k, l, M,
      objective);
  return static_cast<int>(cudaGetLastError());
}
