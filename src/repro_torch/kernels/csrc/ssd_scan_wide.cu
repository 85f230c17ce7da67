// Chunked SSD (state-space dual) linear recurrence, forward, with the final
// state, at wide states: dk and dv up to 512, dv = 1 included.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas
// (`_kernel` :31, pallas_call at :85) at the shapes csrc/ssd_scan.cu
// refuses: xLSTM's mLSTM calls it at dk = dv = 512 for its matrix memory
// and at dk = 512, dv = 1 for its normaliser
// (src/repro/models/layers.py:395-396). Per (batch, head) row, with state S
// in R^{dk x dv} carried in float32:
//   S_t = exp(log_a_t) S_{t-1} + beta_t k_t v_t^T ;  y_t = q_t S_t
// in the chunked form: with lc the inclusive cumsum of log_a within a chunk
// of C tokens and lt its last entry,
//   y_t = sum_{u<=t} exp(lc_t - lc_u) beta_u (q_t . k_u) v_u + exp(lc_t) q_t S
//   S   = exp(lt) S + sum_u exp(lt - lc_u) beta_u k_u v_u^T.
// Decays are formed only for u <= t (masked before exp: the differences
// above the diagonal are positive and would overflow). The sequence tail
// is read as log_a = 0, beta = 0, q = k = v = 0, which leaves y and the
// state unchanged, so nothing is padded in device memory.
//
// Why not csrc/ssd_scan.cu widened: it walks one row's chunks in order in
// one block, with the state slice in registers and its bf16 copy in shared
// memory. At dk = 512 the 512 x 64 state slice alone needs 256 registers a
// thread, the staged q/k tiles and the state copy need ~410 KB of shared
// memory (227 KB is a block's most), and the serving shape (B * H = 16
// rows) would give 16-128 blocks for 132 SMs, each walking its chunks in
// sequence. This kernel is the chunk-parallel form of the same math instead,
// in five launches on the caller's stream, with every per-chunk quantity in
// device memory (float32 scratch the wrapper allocates):
//
//  1. decays   (row, chunk): lc, beta and w_u = exp(lt - lc_u) beta_u per
//              token, lt per chunk; a block-wide scan.
//  2. scores   (row, chunk, lower-triangular 64 x 64 tile pair):
//              G[t][u] = (q_t . k_u) exp(lc_t - lc_u) beta_u for u <= t,
//              0 above the diagonal, C x C per chunk. Computed once per
//              chunk, not once per dv tile.
//  3. states   (row, chunk, 64-row dk tile x dv tile): the chunk's own
//              contribution S_c = sum_u (w_u k_u) v_u^T.
//  4. carry    (row, dk*dv / 256): in chunk order, each element
//              S_in[c + 1] = exp(lt_c) S_in[c] + S_c, written over S_c's
//              slot (slot c then holds the state entering chunk c), and the
//              final state. The chunk states are stored by (row, block of
//              256 state elements, chunk, element), so one block's chunks
//              lie 1 KB apart: 1.42 ms for this phase at the serving shape
//              on an H100, against 6.6 ms with them a whole state (1 MB)
//              or a 64 x 64 tile (16 KB) apart.
//  5. outputs  (row, chunk, 64-token tile x dv tile):
//              y = G v + exp(lc_t) (q S_in[c]).
//
// At the serving shape (B = 4, S = 8192, H = 4, dk = dv = 512, C = 256)
// that is 512 (row, chunk) pairs: 5,120 score, 32,768 state and 16,384
// output blocks, against the 16 row-blocks of the sequential design. The
// scratch is R*n*C*C + R*n*dk*dv floats (R = B*H rows, n chunks; dk*dv
// rounded up to 256): 134 MB of scores and 537 MB of chunk states there.
//
// Bound on the card: operations. The chunked form does ~172 GFLOP at the
// serving shape: 0.174 ms at the bf16 tensor-core rate, 2.6 ms at the
// float32 CUDA-core rate this design runs at. Every product is a float32
// CUDA-core tile product: a 64 x 64 (or 64 x 16 for dv <= 16) output tile
// per 256-thread block, 4 x 4 (4 x 1) outputs a thread, its operands
// staged in shared memory 16 deep, the next stage's loads in flight in
// registers during the current stage's math.
// Tensor cores (bf16 operands, as csrc/ssd_scan.cu splits float32 ones into
// hi + lo pairs), TMA and wgmma are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows of an output tile (and wide columns)
constexpr int kDepth = 16;      // reduction depth of one shared stage
constexpr int kPad = 4;         // row padding (floats) of the shared tiles
constexpr int kMaxChunk = 256;  // tokens per chunk: the decay scan's block
constexpr int kMaxDim = 512;

using repro_torch::from_f;
using repro_torch::to_f;

struct WideArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* la;
  const float* beta;
  void* y;
  float* state;
  float* lc;   // (R*n, C) inclusive in-chunk cumsum of log_a
  float* bt;   // (R*n, C) beta, 0 past the sequence
  float* w;    // (R*n, C) exp(lt - lc_u) beta_u
  float* lt;   // (R*n)    the chunk's total log decay
  float* G;    // (R*n, C, C) decay-weighted causal scores
  float* cs;   // (R, n_eb, n, kEb) chunk states, then the states entering
               // chunks: element e = d * dv + j of chunk c at cs_at(r, c, e)
  int S, H, dk, dv, C, n, n_eb;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long la_sb, la_ss, la_sh;
  long long b_sb, b_ss, b_sh;
  long long y_sb, y_ss, y_sh;
};

constexpr int kEb = 256;        // state elements of a carry block

// Offset of state element e of (row r, chunk c) in the chunk-state scratch.
__device__ __forceinline__ long long cs_at(const WideArgs& a, long long r,
                                           int c, long long e) {
  return ((r * a.n_eb + e / kEb) * a.n + c) * kEb + e % kEb;
}

// (row, chunk) of this block; row = batch * H + head.
struct RowChunk {
  int rc, c, b, h;
  __device__ explicit RowChunk(const WideArgs& a) {
    rc = blockIdx.x;
    const int r = rc / a.n;
    c = rc - r * a.n;
    b = r / a.H;
    h = r - b * a.H;
  }
};

// Shared operand tiles of one reduction stage, reduction index major.
template <int BN>
struct __align__(16) Stage {
  float a[kDepth][kTile + kPad];
  float b[kDepth][BN + kPad];
};

// acc[i][j] += sum_{kk < K} sa(kk) A(m, kk) B(kk, n) over this thread's
// outputs m = 4 tm + i, n = TN tn + j (tm = tid / 16, tn = tid % 16) of a
// kTile x BN tile. fa(m, kk) and fb(kk, n) load one operand element as
// stored (float or bf16), zero outside the tile's valid rows / columns; the
// reduction edge is masked here. AK / BK: the reduction index is the fast
// one in memory for A / B, which picks the fill order that keeps a warp's
// reads contiguous. The next stage's elements are fetched into registers
// before this stage's math, so their loads are in flight while it runs;
// they are converted to float and scaled by sa only when staged into
// shared memory, since an instruction that used them at the fetch would
// wait for the load there (the chunk states measured 8.5 ms so, 5.3 ms
// without the prefetch).
template <int BN, bool AK, bool BK, typename FA, typename FB, typename SA>
__device__ __forceinline__ void tile_product(float (&acc)[4][BN / 16], int K,
                                             Stage<BN>& st, FA fa, FB fb,
                                             SA sa) {
  using RA = decltype(fa(0, 0));
  using RB = decltype(fb(0, 0));
  constexpr int TN = BN / 16;
  constexpr int NA = kDepth * kTile / kThreads;   // elements a thread stages
  constexpr int NB = kDepth * BN / kThreads;
  static_assert(NA * kThreads == kDepth * kTile && NB * kThreads ==
                kDepth * BN, "whole stages");
  const int tid = threadIdx.x, tm = tid >> 4, tn = tid & 15;
  RA ra[NA];
  RB rb[NB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int i = tid + s * kThreads;
      const int kk = AK ? i % kDepth : i / kTile;
      const int m = AK ? i / kDepth : i % kTile;
      ra[s] = k0 + kk < K ? fa(m, k0 + kk) : from_f<RA>(0.f);
    }
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      const int i = tid + s * kThreads;
      const int kk = BK ? i % kDepth : i / BN;
      const int n = BK ? i / kDepth : i % BN;
      rb[s] = k0 + kk < K ? fb(k0 + kk, n) : from_f<RB>(0.f);
    }
  };
  if (K <= 0) return;
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kDepth) {
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int i = tid + s * kThreads;
      const int kk = AK ? i % kDepth : i / kTile;
      st.a[kk][AK ? i / kDepth : i % kTile] =
          k0 + kk < K ? to_f(ra[s]) * sa(k0 + kk) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      const int i = tid + s * kThreads;
      const int kk = BK ? i % kDepth : i / BN;
      st.b[kk][BK ? i / kDepth : i % BN] = to_f(rb[s]);
    }
    __syncthreads();
    if (k0 + kDepth < K) fetch(k0 + kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&st.a[kk][tm * 4]);
      const float am[4] = {av.x, av.y, av.z, av.w};
      float bn[TN];
      if constexpr (TN == 4) {
        const float4 bv =
            *reinterpret_cast<const float4*>(&st.b[kk][tn * 4]);
        bn[0] = bv.x;
        bn[1] = bv.y;
        bn[2] = bv.z;
        bn[3] = bv.w;
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) bn[j] = st.b[kk][tn * TN + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += am[i] * bn[j];
    }
    __syncthreads();
  }
}

// The scale of operands that need none.
struct One {
  __device__ float operator()(int) const { return 1.f; }
};

// 1. Per (row, chunk): the inclusive cumsum of log_a over the chunk (a
// Hillis-Steele scan, one token a thread), beta, w and lt.
__global__ __launch_bounds__(kThreads) void wide_decay(WideArgs a) {
  __shared__ float s[kThreads];
  const RowChunk p(a);
  const int i = threadIdx.x, pos = p.c * a.C + i;
  const bool in = i < a.C && pos < a.S;
  s[i] = in ? a.la[p.b * a.la_sb + (long long)pos * a.la_ss + p.h * a.la_sh]
            : 0.f;
  for (int off = 1; off < a.C; off <<= 1) {
    __syncthreads();
    const float t = i >= off ? s[i - off] : 0.f;
    __syncthreads();
    s[i] += t;
  }
  __syncthreads();
  const float lt = s[a.C - 1];
  if (i < a.C) {
    const long long o = (long long)p.rc * a.C + i;
    const float bt =
        in ? a.beta[p.b * a.b_sb + (long long)pos * a.b_ss + p.h * a.b_sh]
           : 0.f;
    a.lc[o] = s[i];
    a.bt[o] = bt;
    a.w[o] = expf(lt - s[i]) * bt;
  }
  if (i == 0) a.lt[p.rc] = lt;
}

// 2. G[t][u] for one lower-triangular (t tile, u tile) pair of a chunk.
template <typename T>
__global__ __launch_bounds__(kThreads) void wide_scores(WideArgs a) {
  __shared__ Stage<kTile> st;
  const RowChunk p(a);
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.y) ++ti;
  const int ui = (int)blockIdx.y - ti * (ti + 1) / 2;
  const int t0 = ti * kTile, u0 = ui * kTile, p0 = p.c * a.C;
  const int C = a.C, S = a.S;
  const T* Q = static_cast<const T*>(a.q) + p.b * a.q_sb + p.h * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + p.b * a.k_sb + p.h * a.k_sh;
  auto fq = [&](int m, int d) {               // A(t, d) = q[t][d]
    const int t = t0 + m, pos = p0 + t;
    return t < C && pos < S ? Q[(long long)pos * a.q_ss + d] : from_f<T>(0.f);
  };
  auto fk = [&](int d, int n) {               // B(d, u) = k[u][d]
    const int u = u0 + n, pos = p0 + u;
    return u < C && pos < S ? K[(long long)pos * a.k_ss + d] : from_f<T>(0.f);
  };
  float acc[4][4] = {};
  tile_product<kTile, true, true>(acc, a.dk, st, fq, fk, One{});
  const float* lc = a.lc + (long long)p.rc * C;
  const float* bt = a.bt + (long long)p.rc * C;
  float* G = a.G + (long long)p.rc * C * C;
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + tm * 4 + i;
    if (t >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = u0 + tn * 4 + j;
      if (u >= C) continue;
      G[(long long)t * C + u] =
          u <= t ? acc[i][j] * expf(lc[t] - lc[u]) * bt[u] : 0.f;
    }
  }
}

// 3. A chunk's own state contribution on one (dk tile, dv tile).
template <typename T, int BN>
__global__ __launch_bounds__(kThreads) void wide_chunk_states(WideArgs a) {
  constexpr int TN = BN / 16;
  __shared__ Stage<BN> st;
  const RowChunk p(a);
  const int n_dv = (a.dv + BN - 1) / BN;
  const int d0 = ((int)blockIdx.y / n_dv) * kTile;
  const int j0 = ((int)blockIdx.y % n_dv) * BN;
  const int p0 = p.c * a.C, S = a.S, dk = a.dk, dv = a.dv;
  const T* K = static_cast<const T*>(a.k) + p.b * a.k_sb + p.h * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + p.b * a.v_sb + p.h * a.v_sh;
  const float* w = a.w + (long long)p.rc * a.C;
  auto fk = [&](int m, int u) {               // A(d, u) = k[u][d], times w_u
    const int d = d0 + m, pos = p0 + u;
    return d < dk && pos < S ? K[(long long)pos * a.k_ss + d] : from_f<T>(0.f);
  };
  auto fv = [&](int u, int n) {               // B(u, j) = v[u][j]
    const int j = j0 + n, pos = p0 + u;
    return j < dv && pos < S ? V[(long long)pos * a.v_ss + j] : from_f<T>(0.f);
  };
  float acc[4][TN] = {};
  tile_product<BN, false, false>(acc, a.C, st, fk, fv,
                                 [&](int u) { return w[u]; });
  const long long r = p.rc / a.n;
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + tm * 4 + i;
    if (d >= dk) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int jj = j0 + tn * TN + j;
      if (jj < dv) a.cs[cs_at(a, r, p.c, (long long)d * dv + jj)] = acc[i][j];
    }
  }
}

// 4. The carry over chunks, one state element a thread, one carry block
// (kEb = kThreads elements) a thread block.
__global__ __launch_bounds__(kThreads) void wide_carry(WideArgs a) {
  const long long per = (long long)a.dk * a.dv;
  const long long r = blockIdx.x / a.n_eb;
  const long long e = (blockIdx.x % a.n_eb) * kEb + threadIdx.x;
  if (e >= per) return;
  float* __restrict__ slot = a.cs + cs_at(a, r, 0, e);
  const float* __restrict__ lt = a.lt + r * a.n;
  float cur = 0.f;
  for (int c = 0; c < a.n; ++c, slot += kEb) {
    const float s = *slot;
    *slot = cur;
    cur = expf(__ldg(lt + c)) * cur + s;
  }
  a.state[r * per + e] = cur;
}

// 5. y on one (token tile, dv tile) of a chunk.
template <typename T, int BN>
__global__ __launch_bounds__(kThreads) void wide_outputs(WideArgs a) {
  constexpr int TN = BN / 16;
  __shared__ Stage<BN> st;
  const RowChunk p(a);
  const int n_dv = (a.dv + BN - 1) / BN;
  const int t0 = ((int)blockIdx.y / n_dv) * kTile;
  const int j0 = ((int)blockIdx.y % n_dv) * BN;
  const int C = a.C, S = a.S, dv = a.dv, p0 = p.c * C;
  const T* Q = static_cast<const T*>(a.q) + p.b * a.q_sb + p.h * a.q_sh;
  const T* V = static_cast<const T*>(a.v) + p.b * a.v_sb + p.h * a.v_sh;
  const float* G = a.G + (long long)p.rc * C * C;
  const long long r = p.rc / a.n;
  auto fg = [&](int m, int u) {               // A(t, u) = G[t][u]
    const int t = t0 + m;
    return t < C ? G[(long long)t * C + u] : 0.f;
  };
  auto fv = [&](int u, int n) {               // B(u, j) = v[u][j]
    const int j = j0 + n, pos = p0 + u;
    return j < dv && pos < S ? V[(long long)pos * a.v_ss + j] : from_f<T>(0.f);
  };
  auto fq = [&](int m, int d) {               // A(t, d) = q[t][d]
    const int t = t0 + m, pos = p0 + t;
    return t < C && pos < S ? Q[(long long)pos * a.q_ss + d] : from_f<T>(0.f);
  };
  auto fs = [&](int d, int n) {               // B(d, j) = S_in[d][j]
    const int j = j0 + n;
    return j < dv ? a.cs[cs_at(a, r, p.c, (long long)d * dv + j)] : 0.f;
  };
  float intra[4][TN] = {}, inter[4][TN] = {};
  // keys u < t0 + kTile: G is 0 above the diagonal within the last tile
  tile_product<BN, true, false>(intra, min(C, t0 + kTile), st, fg, fv, One{});
  tile_product<BN, true, false>(inter, a.dk, st, fq, fs, One{});
  T* Y = static_cast<T*>(a.y) + p.b * a.y_sb + p.h * a.y_sh;
  const float* lc = a.lc + (long long)p.rc * C;
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + tm * 4 + i, pos = p0 + t;
    if (t >= C || pos >= S) continue;
    const float el = expf(lc[t]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int jj = j0 + tn * TN + j;
      if (jj < dv)
        Y[(long long)pos * a.y_ss + jj] =
            from_f<T>(intra[i][j] + el * inter[i][j]);
    }
  }
}

template <typename T, int BN>
cudaError_t launch_dv(const WideArgs& a, int rcs, int n_t, int n_dk,
                      cudaStream_t s) {
  const int n_dv = (a.dv + BN - 1) / BN;
  wide_chunk_states<T, BN><<<dim3(rcs, n_dk * n_dv), kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long carry = (long long)(rcs / a.n) * a.n_eb;
  if (carry > 0x7fffffffLL) return cudaErrorInvalidValue;
  wide_carry<<<(int)carry, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wide_outputs<T, BN><<<dim3(rcs, n_t * n_dv), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const WideArgs& a, long long R, cudaStream_t s) {
  const long long rcs = R * a.n;
  if (rcs > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n_t = (a.C + kTile - 1) / kTile;
  const int n_dk = (a.dk + kTile - 1) / kTile;
  wide_decay<<<(int)rcs, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wide_scores<T><<<dim3((int)rcs, n_t * (n_t + 1) / 2), kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dv <= 16 (the normaliser's dv = 1): 64 x 16 tiles waste less
  return a.dv <= 16 ? launch_dv<T, 16>(a, (int)rcs, n_t, n_dk, s)
                    : launch_dv<T, kTile>(a, (int)rcs, n_t, n_dk, s);
}

}  // namespace

// Shapes and strides as described above (strides in elements; q, k, v, y
// with a unit stride on the last axis). chunk: tokens per chunk C, 1..256;
// the scratch pointers hold R*n*C (lc, bt, w), R*n (lt), R*n*C*C (G) and
// R*n*ceil(dk*dv / 256)*256 (cs) floats, with R = B*H and n = ceil(S / C).
// dtype codes for q, k, v, y: 0 float32, 1 bfloat16. Returns a cudaError_t
// (0 when every launch was clean).
extern "C" int ssd_scan_wide_fwd(
    const void* q, const void* k, const void* v, const void* log_a,
    const void* beta, void* y, void* state, void* lc, void* bt, void* w,
    void* lt, void* G, void* cs, int B, int S, int H, int dk, int dv,
    int chunk, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long la_sb, long long la_ss,
    long long la_sh, long long b_sb, long long b_ss, long long b_sh,
    long long y_sb, long long y_ss, long long y_sh, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dv <= 0 || dk > kMaxDim ||
      dv > kMaxDim || chunk <= 0 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  const int n = (S + chunk - 1) / chunk;
  const int n_eb = (int)(((long long)dk * dv + kEb - 1) / kEb);
  WideArgs a{q,
             k,
             v,
             static_cast<const float*>(log_a),
             static_cast<const float*>(beta),
             y,
             static_cast<float*>(state),
             static_cast<float*>(lc),
             static_cast<float*>(bt),
             static_cast<float*>(w),
             static_cast<float*>(lt),
             static_cast<float*>(G),
             static_cast<float*>(cs),
             S, H, dk, dv, chunk, n, n_eb,
             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             la_sb, la_ss, la_sh, b_sb, b_ss, b_sh, y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long R = (long long)B * H;
  if (dtype == 0) return (int)launch_all<float>(a, R, s);
  if (dtype == 1) return (int)launch_all<__nv_bfloat16>(a, R, s);
  return (int)cudaErrorInvalidValue;
}
