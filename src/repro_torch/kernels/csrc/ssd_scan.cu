// Chunked SSD (state-space dual) linear recurrence, forward, with the final
// state.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas
// (`_kernel` :31, pallas_call at :85). Per (batch, head) row, with state
// S in R^{dk x dv} carried in float32:
//   S_t = exp(log_a_t) S_{t-1} + beta_t k_t v_t^T ;  y_t = q_t S_t
// in the chunked form, chunk by chunk in order: with lc the inclusive cumsum
// of log_a within the chunk and lt its last entry,
//   y_t = sum_{u<=t} exp(lc_t - lc_u) beta_u (q_t . k_u) v_u + exp(lc_t) q_t S
//   S   = exp(lt) S + sum_u exp(lt - lc_u) beta_u k_u v_u^T.
// Decays are formed only for u <= t (masked before exp: the differences
// above the diagonal are positive and would overflow), so every exp argument
// is <= 0. The sequence tail is padded in registers with log_a = 0, beta = 0
// and q = k = v = 0, which leaves y and the state unchanged, so nothing is
// padded in memory. Unlike the TPU kernel, which streams y only (its wrapper
// recomputes the final state with a second plain pass), this kernel writes
// the final state too, so prefill's decode handoff costs no second pass.
//
// Layout: q, k (B, S, H, dk); v, y (B, S, H, dv); log_a, beta (B, S, H),
// float32; each with element strides for batch, sequence and head and a
// unit stride on the last axis. A head stride of 0 is allowed: Mamba2
// passes its per-token B and C, shared by all heads, as expanded views, so
// nothing is repeated in memory. state out: (B, H, dk, dv) float32.
//
// Bound on the card: bytes. At the serving shapes (dk = dv = 64, chunk 256)
// the chunked form does ~80 FLOP per byte of q/k/v/y, under the H100's
// ~300 FLOP/byte line. Design: one block of 256 threads per (batch, head)
// row walks the sequence in order, which the recurrence forces; the state
// (dk x dv floats, at most 64 KB) stays in shared memory for the whole row
// and never goes to device memory until the end. The chunk is walked in
// sub-tiles of at most 64 tokens (the same recurrence with smaller chunks:
// exact in real arithmetic) so that a tile's q and k (transposed, for the
// score block), w-scaled k (for the state update), v, its 64 x 64 decay-
// weighted score block and the state fit in shared memory together (102 KB
// at dk = dv = 64, two blocks per SM; 218 KB at dk = dv = 128). Each of the
// three products — scores q k^T, y = G v + exp(lc) q S, and the state
// update — gives every thread 4 x 4 blocks of outputs, read as float4 rows
// of the operands: 2 shared-memory loads per 16 multiply-adds, with the
// layouts chosen so a warp's float4 loads are contiguous or broadcast.
// Dimensions are padded to multiples of 4 with zeros in shared memory only.
// All arithmetic is float32 on the CUDA cores: no tensor cores, no TMA, no
// overlap of a tile's loads with the previous tile's math yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 64;
constexpr int kMaxDim = 128;
constexpr int kTS = kMaxTile + 4;   // row stride of the transposed q, k tiles
constexpr int kGS = kMaxTile + 1;   // row stride of the score block

struct SsdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* la;
  const float* beta;
  void* y;
  float* state;
  int S, H, dk, dv, tile;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long la_sb, la_ss, la_sh;
  long long b_sb, b_ss, b_sh;
  long long y_sb, y_ss, y_sh;
};

using repro_torch::from_f;
using repro_torch::to_f;

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

size_t smem_bytes(int dk, int dv) {
  const int dkp = round4(dk), dvp = round4(dv);
  return sizeof(float) * (size_t)(2 * dkp * kTS + kMaxTile * dkp +
                                  kMaxTile * dvp + dkp * dvp +
                                  kMaxTile * kGS + 4 * kMaxTile);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += a[i] * b[j]
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a,
                                       float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
}

template <typename T>
__global__ __launch_bounds__(kThreads) void ssd_scan_kernel(SsdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int dk = a.dk, dv = a.dv, T_ = a.tile;
  const int dkp = round4(dk), dvp = round4(dv), tp = round4(T_);
  float* qT = sm;                          // dkp x kTS: q transposed
  float* kT = qT + dkp * kTS;              // dkp x kTS: k transposed
  float* kw = kT + dkp * kTS;              // tile x dkp: w_u k_u
  float* vs = kw + kMaxTile * dkp;         // tile x dvp
  float* St = vs + kMaxTile * dvp;         // dkp x dvp state
  float* G = St + dkp * dvp;               // tile x kGS decay-weighted scores
  float* lc = G + kMaxTile * kGS;          // inclusive cumsum of log_a
  float* wv = lc + kMaxTile;               // exp(lt - lc_u) * beta_u
  float* el = wv + kMaxTile;               // exp(lc_t)
  float* bs = el + kMaxTile;               // beta_u
  __shared__ float lt_s;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* LA = a.la + b * a.la_sb + h * a.la_sh;
  const float* BT = a.beta + b * a.b_sb + h * a.b_sh;
  T* Y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;
  const int nb = tp / 4, nk = dkp / 4, nj = dvp / 4;

  for (int i = tid; i < dkp * dvp; i += kThreads) St[i] = 0.f;

  for (int t0 = 0; t0 < a.S; t0 += T_) {
    __syncthreads();                     // the previous tile is consumed
    // Tile rows t < tp, zero past the tile, the sequence and dk / dv: a
    // zero row has q = k = v = 0 and (below) log_a = beta = 0, so it adds
    // nothing to y or the state.
    for (int i = tid; i < tp * dkp; i += kThreads) {
      const int t = i / dkp, d = i % dkp, pos = t0 + t;
      const bool in = t < T_ && pos < a.S && d < dk;
      qT[d * kTS + t] = in ? to_f(Q[(long long)pos * a.q_ss + d]) : 0.f;
      kT[d * kTS + t] = in ? to_f(K[(long long)pos * a.k_ss + d]) : 0.f;
    }
    for (int i = tid; i < tp * dvp; i += kThreads) {
      const int t = i / dvp, j = i % dvp, pos = t0 + t;
      vs[i] = (t < T_ && pos < a.S && j < dv) ?
          to_f(V[(long long)pos * a.v_ss + j]) : 0.f;
    }
    if (warp == 0) {
      // inclusive cumsum of log_a over the tile (<= 64 entries, 2 a lane)
      const int u0 = lane, u1 = lane + 32;
      const bool in0 = u0 < T_ && t0 + u0 < a.S;
      const bool in1 = u1 < T_ && t0 + u1 < a.S;
      float x0 = in0 ? LA[(long long)(t0 + u0) * a.la_ss] : 0.f;
      float x1 = in1 ? LA[(long long)(t0 + u1) * a.la_ss] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y0 = __shfl_up_sync(0xffffffffu, x0, o);
        const float y1 = __shfl_up_sync(0xffffffffu, x1, o);
        if (lane >= o) {
          x0 += y0;
          x1 += y1;
        }
      }
      x1 += __shfl_sync(0xffffffffu, x0, 31);
      const float lt = __shfl_sync(0xffffffffu, T_ > 32 ? x1 : x0,
                                   (T_ - 1) & 31);
      const float b0 = in0 ? BT[(long long)(t0 + u0) * a.b_ss] : 0.f;
      const float b1 = in1 ? BT[(long long)(t0 + u1) * a.b_ss] : 0.f;
      if (u0 < tp) {
        lc[u0] = x0;
        bs[u0] = b0;
        wv[u0] = expf(lt - x0) * b0;
        el[u0] = expf(x0);
      }
      if (u1 < tp) {
        lc[u1] = x1;
        bs[u1] = b1;
        wv[u1] = expf(lt - x1) * b1;
        el[u1] = expf(x1);
      }
      if (lane == 0) lt_s = lt;
    }
    __syncthreads();

    // G[t][u] = (q_t . k_u) exp(lc_t - lc_u) beta_u for u <= t, else 0
    for (int blk = tid; blk < nb * nb; blk += kThreads) {
      const int tb = blk / nb, ub = blk % nb;
      float acc[4][4] = {};
      if (ub <= tb) {
        for (int d = 0; d < dkp; ++d)
          outer4(acc, ld4(&qT[d * kTS + 4 * tb]), ld4(&kT[d * kTS + 4 * ub]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tb + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = 4 * ub + j;
          G[t * kGS + u] = u <= t ? acc[i][j] * expf(lc[t] - lc[u]) * bs[u]
                                  : 0.f;
        }
      }
    }
    __syncthreads();

    // y_t = sum_{u<=t} G[t][u] v_u + exp(lc_t) q_t S_prev
    for (int blk = tid; blk < nb * nj; blk += kThreads) {
      const int tb = blk / nj, jb = blk % nj;
      float acc[4][4] = {}, ext[4][4] = {};
      const int umax = 4 * tb + 4;         // G is zero above the diagonal
      for (int u = 0; u < umax; ++u) {
        const float4 g = make_float4(
            G[(4 * tb) * kGS + u], G[(4 * tb + 1) * kGS + u],
            G[(4 * tb + 2) * kGS + u], G[(4 * tb + 3) * kGS + u]);
        outer4(acc, g, ld4(&vs[u * dvp + 4 * jb]));
      }
      for (int d = 0; d < dkp; ++d)
        outer4(ext, ld4(&qT[d * kTS + 4 * tb]), ld4(&St[d * dvp + 4 * jb]));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tb + i;
        if (t >= T_ || t0 + t >= a.S) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = 4 * jb + j;
          if (jj < dv)
            Y[(long long)(t0 + t) * a.y_ss + jj] =
                from_f<T>(acc[i][j] + el[t] * ext[i][j]);
        }
      }
    }
    // kw_u = exp(lt - lc_u) beta_u k_u for the state update (nothing in
    // this phase reads kw)
    for (int i = tid; i < tp * dkp; i += kThreads) {
      const int u = i / dkp, d = i % dkp;
      kw[i] = wv[u] * kT[d * kTS + u];
    }
    __syncthreads();

    // S = exp(lt) S + sum_u kw_u v_u^T
    const float elt = expf(lt_s);
    for (int blk = tid; blk < nk * nj; blk += kThreads) {
      const int kb = blk / nj, jb = blk % nj;
      float acc[4][4] = {};
      for (int u = 0; u < tp; ++u)
        outer4(acc, ld4(&kw[u * dkp + 4 * kb]), ld4(&vs[u * dvp + 4 * jb]));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* row = reinterpret_cast<float4*>(&St[(4 * kb + i) * dvp +
                                                    4 * jb]);
        float4 s = *row;
        s.x = elt * s.x + acc[i][0];
        s.y = elt * s.y + acc[i][1];
        s.z = elt * s.z + acc[i][2];
        s.w = elt * s.w + acc[i][3];
        *row = s;
      }
    }
  }
  __syncthreads();
  float* out = a.state + (long long)bh * dk * dv;
  for (int i = tid; i < dk * dv; i += kThreads)
    out[i] = St[(i / dv) * dvp + i % dv];
}

template <typename T>
cudaError_t launch(const SsdArgs& a, int BH, cudaStream_t s) {
  const size_t bytes = smem_bytes(a.dk, a.dv);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<BH, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shapes and strides as described above (strides in elements). dtype codes
// for q, k, v, y: 0 float32, 1 bfloat16. tile: tokens per sub-tile, 1..64.
// Returns a cudaError_t (0 on a clean launch).
extern "C" int ssd_scan_fwd(
    const void* q, const void* k, const void* v, const void* log_a,
    const void* beta, void* y, void* state, int B, int S, int H, int dk,
    int dv, int tile, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long la_sb, long long la_ss,
    long long la_sh, long long b_sb, long long b_ss, long long b_sh,
    long long y_sb, long long y_ss, long long y_sh, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dv <= 0 || dk > kMaxDim ||
      dv > kMaxDim || tile <= 0 || tile > kMaxTile ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  SsdArgs a{q,    k,    v,     static_cast<const float*>(log_a),
            static_cast<const float*>(beta), y, static_cast<float*>(state),
            S,    H,    dk,    dv,   tile,
            q_sb, q_ss, q_sh,  k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            la_sb, la_ss, la_sh, b_sb, b_ss, b_sh, y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, B * H, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, B * H, s);
  return (int)cudaErrorInvalidValue;
}
