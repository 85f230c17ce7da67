// The backward of the chunked SSD (state-space dual) scan: the kernels that
// `ssd_scan_bwd.cu` (states up to 128 x 128, Mamba2) and
// `ssd_scan_wide_bwd.cu` (mLSTM's pair up to 512 x 512) launch.
//
// The TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas (pallas_call
// at :85) has no backward; the reference differentiates its jnp route,
// linear_scan_chunked, with jax.vjp. Per (batch, head) row, over chunks of
// T <= 64 tokens, with lc the inclusive cumsum of log_a in the chunk, lt its
// last entry, k~ = beta k, S_in the state entering the chunk and dS the
// cotangent of the state leaving it:
//   dq_t  = sum_{u<=t} e^(lc_t-lc_u) (dy_t.v_u) k~_u + e^(lc_t) S_in dy_t
//   dk~_u = sum_{t>=u} e^(lc_t-lc_u) (dy_t.v_u) q_t + e^(lt-lc_u) dS v_u
//   dv_u  = sum_{t>=u} e^(lc_t-lc_u) (q_t.k~_u) dy_t + e^(lt-lc_u) dS^T k~_u
//   dS before the chunk = e^(lt) dS + sum_t e^(lc_t) q_t dy_t^T
//   dk = beta dk~, dbeta_u = k_u.dk~_u, dL_t = q_t.dq_t - beta_t dbeta_t
//   (+ <d_state, S_final> at t = S - 1), dlog_a_t = sum_{j>=t} dL_j.
// mLSTM's normaliser (v = ones, dv = 1) shares q, k, log_a and beta with
// the memory, so the pair is one scan of [v | 1] at the cotangents
// [dy | dnm] and [dC | dn]: with `norm` the kernels read a column dv of
// ones (in v's place) and of dnm (in dy's), and never store it.
//
// Launches, each over device memory (the 512 x 512 float32 state does not
// fit on chip, and Mamba2's 112 heads x 64 chunks fill the card):
//   1. bwd_states<false>: per (batch, head, 64 x 64 tile of the state), the
//      forward's state entering each chunk, in chunk order, into s_in; and
//      the partial <d_state, S_final> of the tile.
//   2. bwd_states<true>: the same tiles of dS, in reverse chunk order, into
//      ds_out (the cotangent of the state leaving each chunk).
//   3. bwd_dqk: per (batch, head, chunk, 64 columns of dk), dq and dk~ (the
//      decayed scores dy v^T recomputed over every 64 columns of dv), dk,
//      and the partial dL and dbeta rows of those columns.
//   4. bwd_dv: per (batch, head, chunk, 64 columns of dv), dv (the decayed
//      scores q k~^T recomputed over every 64 columns of dk).
//   5. bwd_finish: per (batch, head), dL and dbeta summed over the column
//      tiles in order, the final-state term, and the reverse cumsum.
//   6. bwd_cast: dq and dk to the inputs' dtype, shared heads summed in
//      head order.
// Every sum is taken in one fixed order and nothing uses atomics, so two
// runs are bit-equal.
//
// Arithmetic: float32 on the CUDA cores, the bf16 inputs converted exactly
// on their way into shared memory. A block of 256 threads owns a 64 x 64
// output tile, 4 x 4 entries a thread (rows ty + 16 r, columns tx + 16 c),
// and every product is over 64 entries of two shared tiles with rows of 65
// floats (no bank conflicts whichever way a tile is read). The bound that
// chip_smoke.py's `ssd_bwd_bound` states is taken at the tensor cores'
// bf16 rate of 989 TFLOP/s, which this first design does not use: at
// zamba2's training shape (1, 4096, 112, 64, 64) the chunked backward does
// ~28 GFLOP and moves ~186 MB (bound by the bytes), at xlstm's (1, 4096,
// 4, 512, 512 + 1) ~46 GFLOP (bound by the operations). At the float32
// CUDA-core rate of 67 TFLOP/s that it runs at, the operations alone take
// ~0.42 and ~0.68 ms.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace ssd_bwd {

using repro_torch::from_f;
using repro_torch::to_f;

constexpr int kThreads = 256;
constexpr int kT = 64;           // tokens a chunk (at most)
constexpr int kD = 64;           // state rows / columns a tile
constexpr int kLd = kD + 1;      // row stride of the shared tiles (floats)
constexpr int kTile = kT * kLd;  // floats of one shared tile
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dy;
  const void* dnm;        // (B, S, H, 1), the normaliser's dy, or null
  const float* la;
  const float* beta;
  const float* dstate;    // (B, H, dk, dv) or null
  const float* dn;        // (B, H, dk, 1) or null
  float* s_in;            // (BH, n_ch, dk, dvx): states entering the chunks
  float* ds_out;          // (BH, n_ch, dk, dvx): cotangents leaving them
  float* dq32;            // (B, S, H, dk)
  float* dk32;            // (B, S, H, dk): beta dk~
  float* dl;              // (BH, n_ks, S) partial dL
  float* db;              // (BH, n_ks, S) partial dbeta
  float* fin;             // (BH, n_tiles) partial <d_state, S_final>
  void* dq;               // (B, S, 1 or H, dk) in q's dtype
  void* dk;               // (B, S, 1 or H, dk) in k's dtype
  void* dv;               // (B, S, H, dv) in v's dtype
  float* dla;             // (B, S, H)
  float* dbeta;           // (B, S, H)
  // n_ks, n_vs: 64-column tiles of dk and of dv; n_vtiles: of dvx = dv +
  // norm (the normaliser's column can sit in a tile of its own)
  int S, H, DK, DV, DVX, T, n_ch, n_ks, n_vs, n_vtiles, norm, cut, sum_q,
      sum_k, has_dstate;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long dy_sb, dy_ss, dy_sh, dnm_sb, dnm_ss, dnm_sh;
  long long la_sb, la_ss, la_sh, b_sb, b_ss, b_sh;
};

// Shared memory of the chunk's decays: lc (inclusive cumsum of log_a) and
// beta, zero past the chunk or the sequence.
struct Decays {
  float lc[kT];
  float bt[kT];
};

// All threads: the decays of chunk c of row (b, h); ends with a barrier.
__device__ __forceinline__ void chunk_decays(const Args& a, int b, int h,
                                             int c, Decays& d) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    const float* LA = a.la + b * a.la_sb + h * a.la_sh;
    const float* BT = a.beta + b * a.b_sb + h * a.b_sh;
    const int r0 = tid, r1 = tid + 32;
    const int p0 = c * a.T + r0, p1 = c * a.T + r1;
    const bool in0 = r0 < a.T && p0 < a.S, in1 = r1 < a.T && p1 < a.S;
    float x0 = in0 ? LA[(long long)p0 * a.la_ss] : 0.f;
    float x1 = in1 ? LA[(long long)p1 * a.la_ss] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y0 = __shfl_up_sync(kFull, x0, o);
      const float y1 = __shfl_up_sync(kFull, x1, o);
      if (tid >= o) {
        x0 += y0;
        x1 += y1;
      }
    }
    x1 += __shfl_sync(kFull, x0, 31);
    d.lc[r0] = x0;
    d.lc[r1] = x1;
    d.bt[r0] = in0 ? BT[(long long)p0 * a.b_ss] : 0.f;
    d.bt[r1] = in1 ? BT[(long long)p1 * a.b_ss] : 0.f;
  }
  __syncthreads();
}

// dst[r][j] (row stride kLd) = src[r * ss + j] * (scale ? scale[r] : 1)
// for r < rows, j < cols; column xj (the normaliser's, when 0 <= xj < kD)
// xcol[r * xss], or 1 where xcol is null; 0 elsewhere. src and xcol point at
// the slab's first row.
template <typename T>
__device__ __forceinline__ void load_slab(float* dst, const T* src,
                                          long long ss, int rows, int cols,
                                          const float* scale, int xj,
                                          const T* xcol, long long xss) {
  for (int i = threadIdx.x; i < kT * kD; i += kThreads) {
    const int r = i / kD, j = i - r * kD;
    float x = 0.f;
    if (r < rows) {
      if (j < cols)
        x = to_f(src[r * ss + j]);
      else if (j == xj)
        x = xcol ? to_f(xcol[r * xss]) : 1.f;
      if (scale) x *= scale[r];
    }
    dst[r * kLd + j] = x;
  }
}

// A 64 x 64 tile of a row-major float32 matrix (row stride ld) at its
// (0, 0), zero past rows x cols.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld, int rows, int cols) {
  for (int i = threadIdx.x; i < kD * kD; i += kThreads) {
    const int r = i / kD, j = i - r * kD;
    dst[r * kLd + j] = r < rows && j < cols ? src[r * ld + j] : 0.f;
  }
}

// acc[r][c] += sum_p A(ty + 16 r, p) B(p, tx + 16 c) over p < 64, with A
// stored [row][p] (kAT false) or [p][row], B stored [p][col] (kBT false)
// or [col][p].
template <bool kAT, bool kBT>
__device__ __forceinline__ void mac(float (&acc)[4][4], const float* A,
                                    const float* B, int ty, int tx) {
#pragma unroll 4
  for (int p = 0; p < kD; ++p) {
    float x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = kAT ? A[p * kLd + ty + 16 * r] : A[(ty + 16 * r) * kLd + p];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = kBT ? B[(tx + 16 * c) * kLd + p] : B[p * kLd + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// The block's sum of one value a thread, in a fixed order: lanes by a
// butterfly, then the 8 warps' sums in warp order (thread 0 returns it).
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// 1, 2. The chunk states (kRev false) or the reverse carry (kRev true) of
// one 64 x 64 tile (rows i0.., columns j0.. of dk x dvx) of row (b, h).
template <typename T, bool kRev>
__global__ __launch_bounds__(kThreads) void bwd_states(Args a) {
  __shared__ float X[kTile], Z[kTile];
  __shared__ Decays d;
  __shared__ float w[kT], red[kThreads / 32];
  const int tile = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int i0 = (tile / a.n_vtiles) * kD, j0 = (tile % a.n_vtiles) * kD;
  const int rows = min(kD, a.DK - i0), cols = min(kD, a.DVX - j0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // the forward's x = k scaled by e^(lt - lc) beta and z = v (the
  // normaliser's column ones); the reverse's x = q scaled by e^(lc) and
  // z = dy (the normaliser's column dnm)
  const T* X0 = static_cast<const T*>(kRev ? a.q : a.k) + b * (kRev ? a.q_sb
      : a.k_sb) + h * (kRev ? a.q_sh : a.k_sh) + i0;
  const long long xss = kRev ? a.q_ss : a.k_ss;
  const T* Z0 = static_cast<const T*>(kRev ? a.dy : a.v) + b * (kRev
      ? a.dy_sb : a.v_sb) + h * (kRev ? a.dy_sh : a.v_sh) + j0;
  const long long zss = kRev ? a.dy_ss : a.v_ss;
  const T* N0 = kRev && a.dnm ? static_cast<const T*>(a.dnm) +
      b * a.dnm_sb + h * a.dnm_sh : nullptr;
  const int xj = a.norm ? a.DV - j0 : -1;
  const int zcols = max(0, min(kD, a.DV - j0));

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
      float x = 0.f;
      if (kRev && a.has_dstate && ty + 16 * r < rows && tx + 16 * c < cols) {
        const long long row = (long long)bh * a.DK + i;
        x = j < a.DV ? a.dstate[row * a.DV + j] : a.dn[row];
      }
      acc[r][c] = x;
    }

  float* out = (kRev ? a.ds_out : a.s_in) + (long long)bh * a.n_ch * a.DK *
      a.DVX + (long long)i0 * a.DVX + j0;
  for (int step = 0; step < a.n_ch; ++step) {
    const int c = kRev ? a.n_ch - 1 - step : step;
    float* o = out + (long long)c * a.DK * a.DVX;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        if (ty + 16 * r < rows && tx + 16 * cc < cols)
          o[(long long)(ty + 16 * r) * a.DVX + tx + 16 * cc] = acc[r][cc];
    chunk_decays(a, b, h, c, d);
    const float lt = d.lc[a.T - 1];
    if (tid < kT)
      w[tid] = kRev ? expf(d.lc[tid]) : expf(lt - d.lc[tid]) * d.bt[tid];
    __syncthreads();
    const int pos0 = c * a.T, n = min(a.T, a.S - pos0);
    load_slab(X, X0 + pos0 * xss, xss, n, rows, w, -1, (const T*)nullptr,
              0);
    load_slab(Z, Z0 + pos0 * zss, zss, n, zcols, nullptr, xj,
              N0 ? N0 + pos0 * a.dnm_ss : nullptr, a.dnm_ss);
    __syncthreads();
    const float decay = kRev && a.cut ? 0.f : expf(lt);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r][cc] *= decay;
    mac<true, false>(acc, X, Z, ty, tx);
    __syncthreads();
  }
  if (!kRev && a.has_dstate) {
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * cc;
        if (ty + 16 * r < rows && tx + 16 * cc < cols) {
          const long long row = (long long)bh * a.DK + i;
          part += acc[r][cc] *
                  (j < a.DV ? a.dstate[row * a.DV + j] : a.dn[row]);
        }
      }
    const float s = block_sum(part, red);
    if (tid == 0) a.fin[(long long)bh * gridDim.x + tile] = s;
  }
}

// 3. dq, dk~ (stored as dk = beta dk~) and the partial dL and dbeta rows of
// columns i0.. of dk, chunk c, row (b, h).
template <typename T>
__global__ __launch_bounds__(kThreads, 2) void bwd_dqk(Args a) {
  extern __shared__ float sm[];
  float* Y = sm;              // dy slab (t, j), later q (t, i)
  float* V = Y + kTile;       // v slab (u, j), later k (u, i)
  float* Si = V + kTile;      // S_in tile (i, j), later k~ (u, i)
  float* Ds = Si + kTile;     // dS tile (i, j)
  float* A = Ds + kTile;      // the decayed scores (t, u)
  __shared__ Decays d;
  const int ks = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H;
  const int i0 = ks * kD, icols = min(kD, a.DK - i0);
  const int pos0 = c * a.T, n = min(a.T, a.S - pos0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* Yp = static_cast<const T*>(a.dy) + b * a.dy_sb + h * a.dy_sh +
      pos0 * a.dy_ss;
  const T* Vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh +
      pos0 * a.v_ss;
  const T* Np = a.dnm ? static_cast<const T*>(a.dnm) + b * a.dnm_sb +
      h * a.dnm_sh + pos0 * a.dnm_ss : nullptr;
  const float* St = a.s_in + ((long long)bh * a.n_ch + c) * a.DK * a.DVX +
      (long long)i0 * a.DVX;
  const float* Dt = a.ds_out + ((long long)bh * a.n_ch + c) * a.DK * a.DVX +
      (long long)i0 * a.DVX;
  chunk_decays(a, b, h, c, d);

  float accA[4][4], accQ[4][4], accK[4][4];
  zero(accA);
  zero(accQ);
  zero(accK);
  for (int vs = 0; vs < a.n_vtiles; ++vs) {   // the normaliser's too
    const int j0 = vs * kD, jcols = min(kD, a.DVX - j0);
    const int vcols = max(0, min(kD, a.DV - j0));
    const int xj = a.norm ? a.DV - j0 : -1;
    load_slab(Y, Yp + j0, a.dy_ss, n, vcols, nullptr, xj, Np, a.dnm_ss);
    load_slab(V, Vp + j0, a.v_ss, n, vcols, nullptr, xj, (const T*)nullptr,
              0);
    load_tile(Si, St + j0, a.DVX, icols, jcols);
    load_tile(Ds, Dt + j0, a.DVX, icols, jcols);
    __syncthreads();
    mac<false, true>(accA, Y, V, ty, tx);    // (dy v^T)[t][u]
    mac<false, true>(accQ, Y, Si, ty, tx);   // (dy S_in^T)[t][i]
    mac<false, true>(accK, V, Ds, ty, tx);   // (v dS^T)[u][i]
    __syncthreads();
  }
  // the decayed scores, masked before exp (u <= t)
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int t = ty + 16 * r, u = tx + 16 * cc;
      A[t * kLd + u] = u <= t ? accA[r][cc] * expf(d.lc[t] - d.lc[u]) : 0.f;
    }
  const T* Qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
      pos0 * a.q_ss + i0;
  const T* Kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh +
      pos0 * a.k_ss + i0;
  load_slab(Y, Qp, a.q_ss, n, icols, nullptr, -1, (const T*)nullptr, 0);
  load_slab(V, Kp, a.k_ss, n, icols, nullptr, -1, (const T*)nullptr, 0);
  load_slab(Si, Kp, a.k_ss, n, icols, d.bt, -1, (const T*)nullptr, 0);
  __syncthreads();
  float dq[4][4], dkt[4][4];
  zero(dq);
  zero(dkt);
  mac<false, false>(dq, A, Si, ty, tx);      // sum_u A[t][u] k~[u][i]
  mac<true, false>(dkt, A, Y, ty, tx);       // sum_t A[t][u] q[t][i]
  const float lt = d.lc[a.T - 1];
  float pq[4], pb[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = ty + 16 * r;
    const float eq = expf(d.lc[t]), ek = expf(lt - d.lc[t]);
    pq[r] = pb[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int i = tx + 16 * cc;
      dq[r][cc] = fmaf(eq, accQ[r][cc], dq[r][cc]);
      dkt[r][cc] = fmaf(ek, accK[r][cc], dkt[r][cc]);
      pq[r] = fmaf(Y[t * kLd + i], dq[r][cc], pq[r]);
      pb[r] = fmaf(V[t * kLd + i], dkt[r][cc], pb[r]);
    }
  }
  // the rows' sums over the 16 threads of a row (a half warp), in a fixed
  // order
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      pq[r] += __shfl_xor_sync(kFull, pq[r], o);
      pb[r] += __shfl_xor_sync(kFull, pb[r], o);
    }
  const long long part = ((long long)bh * a.n_ks + ks) * a.S + pos0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = ty + 16 * r;
    if (tx == 0 && t < n) {
      a.dl[part + t] = pq[r] - d.bt[t] * pb[r];
      a.db[part + t] = pb[r];
    }
    if (t < n) {
      const long long row = (((long long)b * a.S + pos0 + t) * a.H + h) *
          a.DK + i0;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = tx + 16 * cc;
        if (i < icols) {
          a.dq32[row + i] = dq[r][cc];
          a.dk32[row + i] = d.bt[t] * dkt[r][cc];
        }
      }
    }
  }
}

// 4. dv over columns j0.. of dv, chunk c, row (b, h).
template <typename T>
__global__ __launch_bounds__(kThreads, 2) void bwd_dv(Args a) {
  extern __shared__ float sm[];
  float* Q = sm;              // q slab (t, i), later dy (t, j)
  float* K = Q + kTile;       // k slab (u, i)
  float* Ds = K + kTile;      // dS tile (i, j)
  float* G = Ds + kTile;      // the decayed scores (t, u)
  __shared__ Decays d;
  const int vs = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H;
  const int j0 = vs * kD, jcols = min(kD, a.DV - j0);
  const int pos0 = c * a.T, n = min(a.T, a.S - pos0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* Qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
      pos0 * a.q_ss;
  const T* Kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh +
      pos0 * a.k_ss;
  const float* Dt = a.ds_out + ((long long)bh * a.n_ch + c) * a.DK * a.DVX +
      j0;
  chunk_decays(a, b, h, c, d);

  float accG[4][4], accV[4][4];
  zero(accG);
  zero(accV);
  for (int ks = 0; ks < a.n_ks; ++ks) {
    const int i0 = ks * kD, icols = min(kD, a.DK - i0);
    load_slab(Q, Qp + i0, a.q_ss, n, icols, nullptr, -1, (const T*)nullptr,
              0);
    load_slab(K, Kp + i0, a.k_ss, n, icols, nullptr, -1, (const T*)nullptr,
              0);
    load_tile(Ds, Dt + (long long)i0 * a.DVX, a.DVX, icols, jcols);
    __syncthreads();
    mac<false, true>(accG, Q, K, ty, tx);    // (q k^T)[t][u]
    mac<false, false>(accV, K, Ds, ty, tx);  // (k dS)[u][j]
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int t = ty + 16 * r, u = tx + 16 * cc;
      G[t * kLd + u] = u <= t ? accG[r][cc] * d.bt[u] *
          expf(d.lc[t] - d.lc[u]) : 0.f;
    }
  const T* Yp = static_cast<const T*>(a.dy) + b * a.dy_sb + h * a.dy_sh +
      pos0 * a.dy_ss + j0;
  load_slab(Q, Yp, a.dy_ss, n, jcols, nullptr, -1, (const T*)nullptr, 0);
  __syncthreads();
  float dv[4][4];
  zero(dv);
  mac<true, false>(dv, G, Q, ty, tx);        // sum_t G[t][u] dy[t][j]
  const float lt = d.lc[a.T - 1];
  T* out = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int u = ty + 16 * r;
    if (u >= n) continue;
    const float ew = d.bt[u] * expf(lt - d.lc[u]);
    const long long row = (((long long)b * a.S + pos0 + u) * a.H + h) *
        a.DV + j0;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = tx + 16 * cc;
      if (j < jcols) out[row + j] = from_f<T>(fmaf(ew, accV[r][cc],
                                                   dv[r][cc]));
    }
  }
}

// 5. dL and dbeta of row (b, h): the column tiles' partials summed in
// order, the final-state term at the last position, and dlog_a as the
// reverse cumsum of dL, in segments of 256 positions (a block scan each,
// warps then their totals, in a fixed order).
__global__ __launch_bounds__(kThreads) void bwd_finish(Args a) {
  __shared__ float wsum[kThreads / 32];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float fin = 0.f;
  if (a.has_dstate) {
    const int tiles = a.n_ks * a.n_vtiles;
    for (int t = 0; t < tiles; ++t) fin += a.fin[(long long)bh * tiles + t];
  }
  float carry = 0.f;
  for (int end = a.S; end > 0; end -= kThreads) {
    const int pos = end - 1 - tid;       // thread 0 the segment's last
    float x = 0.f;
    if (pos >= 0) {
      float db = 0.f;
      for (int ks = 0; ks < a.n_ks; ++ks) {
        const long long p = ((long long)bh * a.n_ks + ks) * a.S + pos;
        x += a.dl[p];
        db += a.db[p];
      }
      if (pos == a.S - 1) x += fin;
      a.dbeta[((long long)b * a.S + pos) * a.H + h] = db;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    if (pos >= 0) a.dla[((long long)b * a.S + pos) * a.H + h] = before + x;
    for (int w = 0; w < kThreads / 32; ++w) carry += wsum[w];
    __syncthreads();
  }
}

// 6. dq or dk (B, S, H, dk) float32 into the input's dtype, or with `sum`
// summed over the heads in head order into (B, S, 1, dk).
template <typename T>
__global__ __launch_bounds__(kThreads) void bwd_cast(const float* src,
                                                     T* dst, long long rows,
                                                     int H, int D, int sum) {
  const long long n = rows * (sum ? 1 : H) * D;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    if (!sum) {
      dst[i] = from_f<T>(src[i]);
      continue;
    }
    const long long r = i / D, j = i - r * D;
    const float* p = src + r * H * D + j;
    float s = 0.f;
    for (int hh = 0; hh < H; ++hh) s += p[(long long)hh * D];
    dst[i] = from_f<T>(s);
  }
}

constexpr size_t kDqkSmem = 5 * kTile * sizeof(float);
constexpr size_t kDvSmem = 4 * kTile * sizeof(float);

template <typename T>
cudaError_t run(Args a, int B, cudaStream_t s) {
  const int BH = B * a.H;
  const int tiles = a.n_ks * a.n_vtiles;
  cudaError_t err;
  if (BH > 65535 || a.n_ch > 65535) return cudaErrorInvalidValue;
  bwd_states<T, false><<<dim3(tiles, BH), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_states<T, true><<<dim3(tiles, BH), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dqk<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDqkSmem);
  if (err != cudaSuccess) return err;
  bwd_dqk<T><<<dim3(a.n_ks, a.n_ch, BH), kThreads, kDqkSmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dv<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDvSmem);
  if (err != cudaSuccess) return err;
  bwd_dv<T><<<dim3(a.n_vs, a.n_ch, BH), kThreads, kDvSmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_finish<<<BH, kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rows = (long long)B * a.S;
  bwd_cast<T><<<1024, kThreads, 0, s>>>(a.dq32, static_cast<T*>(a.dq), rows,
                                        a.H, a.DK, a.sum_q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_cast<T><<<1024, kThreads, 0, s>>>(a.dk32, static_cast<T*>(a.dk), rows,
                                        a.H, a.DK, a.sum_k);
  return cudaGetLastError();
}

// The C entry points' common body. ptrs: q, k, v, dy, dnm, log_a, beta,
// d_state, dn, s_in, ds_out, dq32, dk32, dl, db, fin, dq, dk, dv, dlog_a,
// dbeta. dims: B, S, H, dk, dv, chunk, norm, cut, sum_q, sum_k, then the
// strides (batch, sequence, head) of q, k, v, dy, dnm, log_a, beta, then
// the scratch sizes (elements) of s_in, ds_out, dq32, dk32, dl, db, fin,
// which are checked. dtype: 0 float32, 1 bfloat16.
inline int entry(const unsigned long long* p, const long long* dims,
                 int dtype, void* stream, int max_dim) {
  const long long B = dims[0], S = dims[1], H = dims[2], DK = dims[3],
                  DV = dims[4], T = dims[5], norm = dims[6];
  if (B <= 0 || S <= 0 || H <= 0 || DK <= 0 || DV <= 0 || DK > max_dim ||
      DV > max_dim || T <= 0 || T > kT || S > 0x7fffffffLL ||
      B * H > 65535 || (norm && !p[4]))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = (const void*)p[0];
  a.k = (const void*)p[1];
  a.v = (const void*)p[2];
  a.dy = (const void*)p[3];
  a.dnm = (const void*)p[4];
  a.la = (const float*)p[5];
  a.beta = (const float*)p[6];
  a.dstate = (const float*)p[7];
  a.dn = (const float*)p[8];
  a.s_in = (float*)p[9];
  a.ds_out = (float*)p[10];
  a.dq32 = (float*)p[11];
  a.dk32 = (float*)p[12];
  a.dl = (float*)p[13];
  a.db = (float*)p[14];
  a.fin = (float*)p[15];
  a.dq = (void*)p[16];
  a.dk = (void*)p[17];
  a.dv = (void*)p[18];
  a.dla = (float*)p[19];
  a.dbeta = (float*)p[20];
  a.S = (int)S;
  a.H = (int)H;
  a.DK = (int)DK;
  a.DV = (int)DV;
  a.DVX = (int)(DV + (norm ? 1 : 0));
  a.T = (int)T;
  a.n_ch = (int)((S + T - 1) / T);
  a.n_ks = (int)((DK + kD - 1) / kD);
  a.n_vs = (int)((DV + kD - 1) / kD);
  a.n_vtiles = (a.DVX + kD - 1) / kD;
  a.norm = (int)norm;
  a.cut = (int)dims[7];
  a.sum_q = (int)dims[8];
  a.sum_k = (int)dims[9];
  a.has_dstate = a.dstate != nullptr || a.dn != nullptr;
  if (a.has_dstate && (!a.dstate || (norm && !a.dn)))
    return (int)cudaErrorInvalidValue;
  const long long* st = dims + 10;
  a.q_sb = st[0]; a.q_ss = st[1]; a.q_sh = st[2];
  a.k_sb = st[3]; a.k_ss = st[4]; a.k_sh = st[5];
  a.v_sb = st[6]; a.v_ss = st[7]; a.v_sh = st[8];
  a.dy_sb = st[9]; a.dy_ss = st[10]; a.dy_sh = st[11];
  a.dnm_sb = st[12]; a.dnm_ss = st[13]; a.dnm_sh = st[14];
  a.la_sb = st[15]; a.la_ss = st[16]; a.la_sh = st[17];
  a.b_sb = st[18]; a.b_ss = st[19]; a.b_sh = st[20];
  const long long* sz = dims + 31;
  const long long states = B * H * a.n_ch * DK * a.DVX;
  if (sz[0] < states || sz[1] < states || sz[2] < B * S * H * DK ||
      sz[3] < B * S * H * DK || sz[4] < B * H * a.n_ks * S ||
      sz[5] < B * H * a.n_ks * S ||
      (a.has_dstate && sz[6] < B * H * a.n_ks * a.n_vtiles))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(a, (int)B, s);
  if (dtype == 1) return (int)run<__nv_bfloat16>(a, (int)B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ssd_bwd
