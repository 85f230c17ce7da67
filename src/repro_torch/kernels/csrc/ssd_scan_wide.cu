// Chunked SSD (state-space dual) linear recurrence, forward, with the final
// state, at wide states: dk and dv up to 512, dv = 1 included; and mLSTM's
// memory and normaliser in one call.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas
// (`_kernel` :31, pallas_call at :85) at the shapes csrc/ssd_scan.cu
// refuses: xLSTM's mLSTM calls it at dk = dv = 512 for its matrix memory
// and at dk = 512, dv = 1 (v = ones) for its normaliser
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
// With `nm` and `n` given (the mLSTM pair), the same call also returns the
// normaliser's scan, the recurrence with v = ones (dv = 1), as if a column
// of ones stood beside v: nm_t = sum_{u<=t} G[t][u] + exp(lc_t) q_t . n_in
// and its state n. The column is never stored; the decays and the scores G
// are computed once for both.
//
// Bound on the card: operations. At the serving shape (B = 4, S = 8192,
// H = 4, dk = dv = 512, C = 256) the chunked form does ~172 GFLOP: 0.174
// ms at the bf16 tensor-core rate. bf16 inputs (the serving path) take four
// launches on the caller's stream, every product on the tensor cores:
//
//  1. decays  (row, chunk): lc, beta, w_u = exp(lt - lc_u) beta_u, lt; a
//             block-wide scan.
//  2. states  (row, 64-row dk tile, dv tile of 64 or 256), the carry over
//             chunks fused in: the block walks its row's chunks in order
//             with its state tile in wgmma accumulators. At each chunk it
//             writes the entering state S_in[c] as a hi + lo pair of bf16
//             (the outputs' B operand; each warp's rows pass through
//             shared memory so the stores are whole 16-byte pieces of
//             rows), scales the accumulators by
//             exp(lt_c) and adds k^T diag(w) v over the chunk's tokens in
//             64-token slabs: wgmma m64nNk16 with A = (w k)^T in registers
//             (ldmatrix.trans of k, times w, split into hi + lo: two
//             products) and B = v from shared memory. The final state
//             leaves in float32. With the normaliser, the dv-tile-0 blocks
//             also carry n = sum_u w_u k_u on the CUDA cores while the MMAs
//             run.
//  3. scores  (row, chunk, 64-token t tile): G[t][u] = (q_t . k_u)
//             exp(lc_t - lc_u) beta_u over the key tiles u <= t, wgmma
//             m64n64k16 (q and k from shared memory), stored as hi + lo
//             bf16; with the normaliser, nm_t from G's float32 row sums and
//             q_t . n_in on the CUDA cores.
//  4. outputs (row, chunk, 128-token t tile, dv tile of 64 or 256; two
//             warpgroups): y = exp(lc_t) (q S_in[c]) + G v, wgmma with A =
//             q or G (hi and lo) and B = S_in (hi and lo) or v, all from
//             shared memory.
//
// Operands reach shared memory by cp.async into 128-byte-swizzled panels
// (hopper.cuh), in a ring of two or three stages, so the next slab's loads
// are in flight while the current one's MMAs run; 16-byte copies where the
// source is aligned, element copies where it is not (dk = 129, an odd
// head stride), zero-filled past the sequence, the chunk, dk and dv. The
// float32 operands (w k, G, S_in) enter as hi + lo bf16 pairs, ~16
// significant bits, as in csrc/ssd_scan.cu: the state stays within 1e-4 of
// the plain version. Scratch: decays 3*R*n*C floats, G 2 x R*n*Cp^2 and
// S_in 2 x R*n*dkp*dvp bf16 (Cp, dkp: C, dk rounded up to 64; dvp: dv to
// the states' tile), and with the normaliser n_in R*n*dkp floats: 674 MB at
// the serving shape.
//
// What still holds it back (PERF.md section 6 has the phase times and the
// ablations of tools/ssd_wide_variants.py that measured them): no phase is
// bound by its MMAs. The outputs wait on their copies: S_in crosses device
// memory as 537 MB of hi + lo pairs, written once by the states and read
// once per 128-token t tile, with q, G and v besides. The states spend as
// long on their copies and their S_in stores as on the MMAs, which one
// warpgroup a block issues between its own copies (no producer warp, no
// TMA: cp.async keeps the ragged shapes and odd strides on one path). The
// scores and outputs of a chunk are separate launches, and G crosses
// device memory between them.
//
// float32 inputs (a float32 model's forward; the tests' float32 cases)
// keep the first design's five launches on the float32 CUDA cores (decays,
// scores, chunk states, the carry over chunks, outputs; the `f32_*`
// kernels), since hi + lo pairs would cost them their float32 accuracy; the
// normaliser runs there as a second chunk-states / carry / outputs pass
// with v read as ones, over the same decays and scores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro_torch::sm90;
using repro_torch::from_f;
using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 256;  // tokens per chunk: the decay scan's block
constexpr int kMaxDim = 512;
constexpr int kSlab = 64;       // tokens (or state rows) of one ring stage
constexpr unsigned kFull = 0xffffffffu;

struct WideArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* la;
  const float* beta;
  void* y;
  float* state;
  void* nm;    // the normaliser's y (B, S, H, 1) in v's dtype, or null
  float* n_out;  // its final state (B, H, dk, 1), or null
  float* lc;   // (R*n, C) inclusive in-chunk cumsum of log_a
  float* bt;   // (R*n, C) beta, 0 past the sequence
  float* w;    // (R*n, C) exp(lt - lc_u) beta_u
  float* lt;   // (R*n)    the chunk's total log decay
  // bf16 route
  bf16* g_hi;  // (R*n, Cp, Cp) G, hi and lo parts
  bf16* g_lo;
  bf16* s_hi;  // (R*n, dkp, dvp) the state entering each chunk (c >= 1)
  bf16* s_lo;
  float* n_in; // (R*n, dkp) the normaliser state entering each chunk
  // float32 route
  float* G;    // (R*n, C, C)
  float* cs;   // (R, n_eb, n, kEb) chunk states, then the entering states
  int S, H, dk, dv, C, n, n_eb;
  int cp, dkp, dvp;
  int v_ones;  // float32 route: v read as ones (the normaliser's pass)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long la_sb, la_ss, la_sh;
  long long b_sb, b_ss, b_sh;
  long long y_sb, y_ss, y_sh;
  long long nm_sb, nm_ss, nm_sh;
};

// (row, chunk) of a block of the decay and float32 launches; row =
// batch * H + head.
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

// 1. Per (row, chunk): the inclusive cumsum of log_a over the chunk (a
// Hillis-Steele scan, one token a thread), beta, w and lt.
constexpr int kDecayThreads = kMaxChunk;
__global__ __launch_bounds__(kDecayThreads) void wide_decay(WideArgs a) {
  __shared__ float s[kDecayThreads];
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

// ------------------------------------------------ bf16: tensor-core route

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ bool aligned16(const void* p, long long stride) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (stride & 7) == 0;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 p) {
  return *reinterpret_cast<uint32_t*>(&p);
}

// (a, b) as a hi pair of bf16 and the rounded remainder as a lo pair.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// Rows [0, rows) x columns [0, 64 * P) of a bf16 tile into P swizzled
// panels at `dst` (panel stride rows * 128 bytes), row r read from src +
// r * stride (elements; unit column stride). Rows >= valid_rows and
// columns >= valid_cols are zero. `aligned`: src and stride allow 16-byte
// copies; else element copies.
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src,
                                          long long stride, int rows, int P,
                                          int valid_rows, int valid_cols,
                                          bool aligned, int tid, int nthr) {
  const int per_row = P * 8;
  for (int i = tid; i < rows * per_row; i += nthr) {
    const int r = i / per_row, pc = i - r * per_row, col = pc * 8;
    unsigned char* d = dst + (pc >> 3) * rows * 128 + swizzle128(r, pc & 7);
    const int cnt = r < valid_rows ? min(8, valid_cols - col) : 0;
    if (cnt <= 0) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if (aligned) {
      cp_async16(smem_u32(d), src + r * stride + col, 2 * cnt);
    } else {
      const unsigned short* s =
          reinterpret_cast<const unsigned short*>(src + r * stride + col);
      uint32_t wd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = 2 * e < cnt ? s[2 * e] : 0u;
        const uint32_t hi = 2 * e + 1 < cnt ? s[2 * e + 1] : 0u;
        wd[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a,
                                       uint64_t db) {
  static_assert(N == 64 || N == 256, "states tiles are 64 or 256 wide");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n256(d, a, db);
  }
}

template <int N>
__device__ __forceinline__ void mma_ss_mn(float (&d)[N / 2], uint64_t da,
                                          uint64_t db) {
  static_assert(N == 64 || N == 256, "output tiles are 64 or 256 wide");
  if constexpr (N == 64) {
    wgmma_ss_n64_mn(d, da, db, 1);
  } else {
    wgmma_ss_n256_mn(d, da, db, 1);
  }
}

// The dv tile of the states and the outputs: 64 or 256 columns.
inline int dv_tile(int dv) {
  return dv <= 64 ? 64 : 256;
}

// 2. The states with the carry over chunks fused in.
constexpr int kStatesStages = 2;
constexpr int kStatesThreads = 128;

template <int BN>
struct StatesTile {
  static constexpr int K_BYTES = kSlab * 128;              // 64 tokens x 64 d
  static constexpr int V_BYTES = BN / 64 * kSlab * 128;    // 64 tokens x BN
  static constexpr int STAGE = K_BYTES + V_BYTES + 1024;   // + w (256 B)
  // each warp's 16 state rows x 64 columns, hi and lo, on their way out
  static constexpr int WARP_STAGING = 2 * 16 * 128;
  static constexpr int STAGING = kStatesThreads / 32 * WARP_STAGING;
  static constexpr int SMEM = kStatesStages * STAGE + STAGING +
                              2 * kStatesThreads * 4 + 1024;
};

template <int BN>
__global__ void __launch_bounds__(kStatesThreads, 1)
    wide_states(const WideArgs a) {
  using L = StatesTile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* stg = sm + kStatesStages * L::STAGE;
  float* nsh = reinterpret_cast<float*>(stg + L::STAGING);
  const int n_dkt = a.dkp / 64, n_dvt = a.dvp / BN;
  const int r = blockIdx.x / (n_dkt * n_dvt);
  const int rem = blockIdx.x - r * n_dkt * n_dvt;
  const int d0 = rem / n_dvt * 64, j0 = rem % n_dvt * BN;
  const int b = r / a.H, h = r - b * a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* K =
      static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh + d0;
  const bf16* V =
      static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh + j0;
  const bool k_al = aligned16(K, a.k_ss), v_al = aligned16(V, a.v_ss);
  const int C = a.C, S = a.S, ns = (C + kSlab - 1) / kSlab;
  const int steps = a.n * ns;
  const bool norm = a.nm != nullptr && j0 == 0;
  const float* LT = a.lt + (long long)r * a.n;

  auto load = [&](int i) {
    unsigned char* st = sm + (i % kStatesStages) * L::STAGE;
    const int c = i / ns, u0 = (i - c * ns) * kSlab, pos0 = c * C + u0;
    const int rows = min(min(kSlab, C - u0), S - pos0);
    load_tile(st, K + (long long)pos0 * a.k_ss, a.k_ss, kSlab, 1, rows,
              a.dk - d0, k_al, tid, kStatesThreads);
    load_tile(st + L::K_BYTES, V + (long long)pos0 * a.v_ss, a.v_ss, kSlab,
              BN / 64, rows, a.dv - j0, v_al, tid, kStatesThreads);
    if (tid < kSlab) {
      float* ws = reinterpret_cast<float*>(st + L::K_BYTES + L::V_BYTES);
      const long long wi = ((long long)r * a.n + c) * C + u0 + tid;
      cp_async4(smem_u32(ws + tid), a.w + (tid < rows ? wi : 0),
                tid < rows ? 4 : 0);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  float npart = 0.f;      // this thread's share of n at row d0 + tid % 64

#pragma unroll
  for (int s = 0; s < kStatesStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStatesStages - 2>();
    fence_proxy_async();
    __syncthreads();       // slab i landed; slab i - 1's stage is free
    if (i + kStatesStages - 1 < steps) load(i + kStatesStages - 1);
    cp_async_commit();
    unsigned char* st = sm + (i % kStatesStages) * L::STAGE;
    const int c = i / ns, sl = i - c * ns;
    const long long rc = (long long)r * a.n + c;
    if (sl == 0) {         // chunk c starts: acc holds the state entering it
      if (c > 0) {         // S_in[c], hi and lo, 64 columns a pass
        // through this warp's own rows of the staging tile, so the stores
        // to device memory are whole 16-byte pieces of rows
        unsigned char* ws_hi = stg + warp * L::WARP_STAGING;
        unsigned char* ws_lo = ws_hi + 16 * 128;
        const long long o0 = (rc * a.dkp + d0 + 16 * warp) * a.dvp + j0;
#pragma unroll
        for (int p = 0; p < BN / 64; ++p) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int e = 4 * (8 * p + i) + 2 * half;
              uint32_t hi, lo;
              split2(acc[e], acc[e + 1], hi, lo);
              const uint32_t off = swizzle128(g + 8 * half, i) + 4 * tq;
              *reinterpret_cast<uint32_t*>(ws_hi + off) = hi;
              *reinterpret_cast<uint32_t*>(ws_lo + off) = lo;
            }
          }
          __syncwarp();
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int idx = lane + 32 * k, row = idx >> 3, pc = idx & 7;
            const uint32_t off = swizzle128(row, pc);
            const long long o = o0 + row * a.dvp + 64 * p + 8 * pc;
            *reinterpret_cast<uint4*>(a.s_hi + o) =
                *reinterpret_cast<const uint4*>(ws_hi + off);
            *reinterpret_cast<uint4*>(a.s_lo + o) =
                *reinterpret_cast<const uint4*>(ws_lo + off);
          }
          __syncwarp();
        }
      }
      if (norm) {
        nsh[tid] = npart;
        __syncthreads();
        if (c > 0 && tid < 64)
          a.n_in[rc * a.dkp + d0 + tid] = nsh[tid] + nsh[tid + 64];
      }
      const float carry = expf(LT[c]);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] *= carry;
      npart *= carry;
    }
    // A = (w k)^T: 16 rows of dk a warp, 16 tokens a k-step, hi and lo
    const uint32_t kb = smem_u32(st), vb = kb + L::K_BYTES;
    const float* ws = reinterpret_cast<const float*>(st + L::K_BYTES +
                                                     L::V_BYTES);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int u = 16 * kk + ((lane >> 4) << 3) + (lane & 7);
      uint32_t rr[4];
      ldsm4t(rr, kb + swizzle128(u, 2 * warp + ((lane >> 3) & 1)));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&rr[q]));
        const float2 wu = *reinterpret_cast<const float2*>(
            ws + 16 * kk + 2 * tq + (q >> 1) * 8);
        split2(f.x * wu.x, f.y * wu.y, ah[kk][q], al[kk][q]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = sw128_desc(vb + kk * 16 * 128, L::K_BYTES, 1024);
      mma_rs<BN>(acc, ah[kk], db);
      mma_rs<BN>(acc, al[kk], db);
    }
    wgmma_commit();
    if (norm) {            // n's slab sum on the CUDA cores meanwhile
      const int d = tid & 63, u0 = (tid >> 6) * 32;
      float s = 0.f;
      for (int u = u0; u < u0 + 32; ++u)
        s += ws[u] * __bfloat162float(*reinterpret_cast<const bf16*>(
                         st + swizzle128(u, d >> 3) + (d & 7) * 2));
      npart += s;
    }
    wgmma_wait0();
    fence_regs(acc);
  }

  float* out = a.state + (long long)r * a.dk * a.dv;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const int d = d0 + 16 * warp + g + 8 * ((e >> 1) & 1);
    const int j = j0 + 8 * (e >> 2) + 2 * tq + (e & 1);
    if (d < a.dk && j < a.dv) out[(long long)d * a.dv + j] = acc[e];
  }
  if (norm) {
    nsh[tid] = npart;
    __syncthreads();
    if (tid < 64 && d0 + tid < a.dk)
      a.n_out[(long long)r * a.dk + d0 + tid] = nsh[tid] + nsh[tid + 64];
  }
}

// 3. G for one 64-token t tile of a chunk, over the key tiles u <= t.
constexpr int kScoresStages = 3;
constexpr int kScoresThreads = 128;
constexpr int kScoresStage = 2 * kSlab * 128;   // a q and a k panel, 16 KB
constexpr int kScoresSmem = kScoresStages * kScoresStage + 64 * 4 + 1024;

__global__ void __launch_bounds__(kScoresThreads)
    wide_scores(const WideArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  float* qn_s = reinterpret_cast<float*>(sm + kScoresStages * kScoresStage);
  const int n_tt = a.cp / 64;
  const int rc = blockIdx.x / n_tt;
  const int ti = n_tt - 1 - (blockIdx.x - rc * n_tt);   // longest rows first
  const int r = rc / a.n, c = rc - r * a.n, b = r / a.H, h = r - b * a.H;
  const int C = a.C, S = a.S, P = a.dkp / 64, t0 = ti * 64, pc = c * C;
  const int steps = (ti + 1) * P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bool q_al = aligned16(Q, a.q_ss), k_al = aligned16(K, a.k_ss);
  const bool norm = a.nm != nullptr;
  const float* lc = a.lc + (long long)rc * C;
  const float* bt = a.bt + (long long)rc * C;

  auto load = [&](int i) {
    unsigned char* st = sm + (i % kScoresStages) * kScoresStage;
    const int ui = i / P, p = i - ui * P, u0 = ui * 64;
    load_tile(st, Q + (long long)(pc + t0) * a.q_ss + 64 * p, a.q_ss, kSlab,
              1, min(min(kSlab, C - t0), S - pc - t0), a.dk - 64 * p, q_al,
              tid, kScoresThreads);
    load_tile(st + kSlab * 128, K + (long long)(pc + u0) * a.k_ss + 64 * p,
              a.k_ss, kSlab, 1, min(min(kSlab, C - u0), S - pc - u0),
              a.dk - 64 * p, k_al, tid, kScoresThreads);
  };

  float sacc[32];
  float rs0 = 0.f, rs1 = 0.f, qn = 0.f;
  const int ta = t0 + 16 * warp + g, tb = ta + 8;
  const float lca = ta < C ? lc[ta] : 0.f, lcb = tb < C ? lc[tb] : 0.f;

#pragma unroll
  for (int s = 0; s < kScoresStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kScoresStages - 2>();
    fence_proxy_async();
    __syncthreads();       // panels i landed; panels i - 1's stage is free
    unsigned char* st = sm + (i % kScoresStages) * kScoresStage;
    const int ui = i / P, p = i - ui * P;
    const uint32_t qb = smem_u32(st), kb = qb + kSlab * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(sacc, sw128_desc(qb + kk * 32, 16, 1024),
                   sw128_desc(kb + kk * 32, 16, 1024), p > 0 || kk > 0);
    wgmma_commit();
    // the next panels' copies go out while the MMAs run
    if (i + kScoresStages - 1 < steps) load(i + kScoresStages - 1);
    cp_async_commit();
    if (norm && ui == 0 && c > 0) {   // q_t . n_in on the CUDA cores
      const int t = tid >> 1, e0 = (tid & 1) * 32;
      const float* nin = a.n_in + (long long)rc * a.dkp + 64 * p;
      float s = 0.f;
      for (int e = e0; e < e0 + 32; ++e)
        s += __bfloat162float(*reinterpret_cast<const bf16*>(
                 st + swizzle128(t, e >> 3) + (e & 7) * 2)) * nin[e];
      qn += s;
    }
    wgmma_wait0();
    fence_regs(sacc);
    if (p == P - 1) {      // G for (t tile, u tile ui): decay, mask, store
      const int u0 = ui * 64;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const bool lower = (e & 2) != 0;
        const int t = lower ? tb : ta;
        const float lct = lower ? lcb : lca;
        const int u = u0 + 8 * (e >> 2) + 2 * tq;
        float g0 = 0.f, g1 = 0.f;
        if (t < C) {
          if (u <= t) g0 = sacc[e] * expf(lct - lc[u]) * bt[u];
          if (u + 1 <= t) g1 = sacc[e + 1] * expf(lct - lc[u + 1]) * bt[u + 1];
        }
        if (lower) rs1 += g0 + g1; else rs0 += g0 + g1;
        uint32_t hi, lo;
        split2(g0, g1, hi, lo);
        const long long o = ((long long)rc * a.cp + t) * a.cp + u;
        *reinterpret_cast<uint32_t*>(a.g_hi + o) = hi;
        *reinterpret_cast<uint32_t*>(a.g_lo + o) = lo;
      }
    }
  }

  if (norm) {              // nm_t = sum_u G[t][u] + exp(lc_t) q_t . n_in
    rs0 += __shfl_xor_sync(kFull, rs0, 1);
    rs0 += __shfl_xor_sync(kFull, rs0, 2);
    rs1 += __shfl_xor_sync(kFull, rs1, 1);
    rs1 += __shfl_xor_sync(kFull, rs1, 2);
    qn += __shfl_xor_sync(kFull, qn, 1);
    if ((tid & 1) == 0) qn_s[tid >> 1] = qn;
    __syncthreads();
    if (tq == 0) {
      bf16* NM = static_cast<bf16*>(a.nm) + b * a.nm_sb + h * a.nm_sh;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? tb : ta, pos = pc + t;
        if (t < C && pos < S)
          NM[(long long)pos * a.nm_ss] = from_f<bf16>(
              (half ? rs1 : rs0) + expf(lc[t]) * qn_s[t - t0]);
      }
    }
  }
}

// 4. y on one 128-token t tile (two warpgroups of 64 rows) and a dv tile
// of a chunk: exp(lc_t) (q S_in) over dk slabs, then G v over key slabs.
constexpr int kOutStages = 2;
constexpr int kOutThreads = 256;
constexpr int kOutRows = 128;

template <int BN>
struct OutTile {
  static constexpr int A_BYTES = kOutRows * 128;          // 128 rows x 64
  static constexpr int B_BYTES = BN / 64 * kSlab * 128;   // 64 rows x BN
  static constexpr int X_BYTES = A_BYTES > B_BYTES ? A_BYTES : B_BYTES;
  // A1: q or G hi; X: S_in hi or G lo; B1: S_in lo or v
  static constexpr int STAGE = A_BYTES + X_BYTES + B_BYTES;
  static constexpr int SMEM = kOutStages * STAGE + 1024;
};

template <int BN>
__global__ void __launch_bounds__(kOutThreads, 1)
    wide_outputs(const WideArgs a) {
  using L = OutTile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const int C = a.C, S = a.S;
  const int n_tp = (C + kOutRows - 1) / kOutRows;
  const int n_dvo = (a.dv + BN - 1) / BN;
  const int rc = blockIdx.x / (n_tp * n_dvo);
  const int rem = blockIdx.x - rc * n_tp * n_dvo;
  const int tp = rem / n_dvo, j0 = (rem - tp * n_dvo) * BN;
  const int r = rc / a.n, c = rc - r * a.n, b = r / a.H, h = r - b * a.H;
  const int t0 = tp * kOutRows, pc = c * C, P = a.dkp / 64;
  const int n_tt = a.cp / 64;
  const int n_a = c > 0 ? P : 0;                  // q S_in slabs
  const int n_u = min(2 * tp + 2, n_tt);          // key slabs
  const int steps = n_a + n_u;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int lane = wt & 31, warp = wt >> 5, g = lane >> 2, tq = lane & 3;
  const int my_tile = 2 * tp + wg;                // this warpgroup's t tile
  const bool active = my_tile * 64 < C;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* V =
      static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh + j0;
  const bool q_al = aligned16(Q, a.q_ss), v_al = aligned16(V, a.v_ss);

  auto load = [&](int i) {
    unsigned char* st = sm + (i % kOutStages) * L::STAGE;
    unsigned char* x = st + L::A_BYTES;
    unsigned char* b1 = x + L::X_BYTES;
    if (i < n_a) {
      const int p = i;
      load_tile(st, Q + (long long)(pc + t0) * a.q_ss + 64 * p, a.q_ss,
                kOutRows, 1, min(min(kOutRows, C - t0), S - pc - t0),
                a.dk - 64 * p, q_al, tid, kOutThreads);
      const long long so = ((long long)rc * a.dkp + 64 * p) * a.dvp + j0;
      load_tile(x, a.s_hi + so, a.dvp, kSlab, BN / 64, kSlab, BN, true, tid,
                kOutThreads);
      load_tile(b1, a.s_lo + so, a.dvp, kSlab, BN / 64, kSlab, BN, true,
                tid, kOutThreads);
    } else {
      const int u0 = (i - n_a) * 64;
      const long long go = ((long long)rc * a.cp + t0) * a.cp + u0;
      const int g_rows = min(kOutRows, a.cp - t0);
      load_tile(st, a.g_hi + go, a.cp, kOutRows, 1, g_rows, 64, true, tid,
                kOutThreads);
      load_tile(x, a.g_lo + go, a.cp, kOutRows, 1, g_rows, 64, true, tid,
                kOutThreads);
      load_tile(b1, V + (long long)(pc + u0) * a.v_ss, a.v_ss, kSlab, BN / 64,
                min(min(kSlab, C - u0), S - pc - u0), a.dv - j0, v_al, tid,
                kOutThreads);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  const int ra = t0 + 64 * wg + 16 * warp + g, rb = ra + 8;
  const float* lc = a.lc + (long long)rc * C;

#pragma unroll
  for (int s = 0; s < kOutStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kOutStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (i + kOutStages - 1 < steps) load(i + kOutStages - 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t a1 = smem_u32(sm + (i % kOutStages) * L::STAGE);
    const uint32_t x = a1 + L::A_BYTES, b1 = x + L::X_BYTES;
    const uint32_t rows = 64 * 128 * wg;          // this warpgroup's rows
    if (i < n_a) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = sw128_desc(a1 + rows + kk * 32, 16, 1024);
        mma_ss_mn<BN>(acc, da, sw128_desc(x + kk * 2048, kSlab * 128, 1024));
        mma_ss_mn<BN>(acc, da, sw128_desc(b1 + kk * 2048, kSlab * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    } else {
      const int ui = i - n_a;
      if (ui == 0 && n_a > 0) {   // the inter-chunk term's decay exp(lc_t)
        const float ea = ra < C ? expf(lc[ra]) : 0.f;
        const float eb = rb < C ? expf(lc[rb]) : 0.f;
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[e] *= (e & 2) ? eb : ea;
      }
      if (ui <= my_tile) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = sw128_desc(b1 + kk * 2048, kSlab * 128, 1024);
          mma_ss_mn<BN>(acc, sw128_desc(a1 + rows + kk * 32, 16, 1024), db);
          mma_ss_mn<BN>(acc, sw128_desc(x + rows + kk * 32, 16, 1024), db);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
      }
    }
  }
  if (!active) return;

  bf16* Y = static_cast<bf16*>(a.y) + b * a.y_sb + h * a.y_sh;
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int t = (e & 2) ? rb : ra, pos = pc + t;
    const int j = j0 + 8 * (e >> 2) + 2 * tq;
    if (t >= C || pos >= S || j >= a.dv) continue;
    bf16* dst = Y + (long long)pos * a.y_ss + j;
    if (j + 1 < a.dv && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[e], acc[e + 1]);
    } else {
      dst[0] = __float2bfloat16(acc[e]);
      if (j + 1 < a.dv) dst[1] = __float2bfloat16(acc[e + 1]);
    }
  }
}

template <typename Kern>
cudaError_t launch_smem(Kern kern, long long blocks, int threads, int smem,
                        const WideArgs& a, cudaStream_t s) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(int)blocks, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_tc(const WideArgs& a, long long R, cudaStream_t s) {
  const long long rn = R * a.n;
  cudaError_t e = launch_smem(wide_states<BN>, R * (a.dkp / 64) *
                              (a.dvp / BN), kStatesThreads,
                              StatesTile<BN>::SMEM, a, s);
  if (e != cudaSuccess) return e;
  e = launch_smem(wide_scores, rn * (a.cp / 64), kScoresThreads,
                  kScoresSmem, a, s);
  if (e != cudaSuccess) return e;
  return launch_smem(wide_outputs<BN>, rn * ((a.C + kOutRows - 1) /
                     kOutRows) * ((a.dv + BN - 1) / BN), kOutThreads,
                     OutTile<BN>::SMEM, a, s);
}

// ------------------------------------- float32: CUDA-core route (phases)

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows of an output tile (and wide columns)
constexpr int kDepth = 16;      // reduction depth of one shared stage
constexpr int kPad = 4;         // row padding (floats) of the shared tiles
constexpr int kEb = 256;        // state elements of a carry block

// Offset of state element e of (row r, chunk c) in the chunk-state scratch.
__device__ __forceinline__ long long cs_at(const WideArgs& a, long long r,
                                           int c, long long e) {
  return ((r * a.n_eb + e / kEb) * a.n + c) * kEb + e % kEb;
}

// Shared operand tiles of one reduction stage, reduction index major.
template <int BN>
struct __align__(16) Stage {
  float a[kDepth][kTile + kPad];
  float b[kDepth][BN + kPad];
};

// acc[i][j] += sum_{kk < K} sa(kk) A(m, kk) B(kk, n) over this thread's
// outputs m = 4 tm + i, n = TN tn + j (tm = tid / 16, tn = tid % 16) of a
// kTile x BN tile. fa(m, kk) and fb(kk, n) load one operand element,
// zero outside the tile's valid rows / columns; the reduction edge is
// masked here. AK / BK: the reduction index is the fast one in memory for
// A / B, which picks the fill order that keeps a warp's reads contiguous.
// The next stage's elements are fetched into registers before this
// stage's math, so their loads are in flight while it runs.
template <int BN, bool AK, bool BK, typename FA, typename FB, typename SA>
__device__ __forceinline__ void tile_product(float (&acc)[4][BN / 16], int K,
                                             Stage<BN>& st, FA fa, FB fb,
                                             SA sa) {
  constexpr int TN = BN / 16;
  constexpr int NA = kDepth * kTile / kThreads;   // elements a thread stages
  constexpr int NB = kDepth * BN / kThreads;
  static_assert(NA * kThreads == kDepth * kTile && NB * kThreads ==
                kDepth * BN, "whole stages");
  const int tid = threadIdx.x, tm = tid >> 4, tn = tid & 15;
  float ra[NA];
  float rb[NB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int i = tid + s * kThreads;
      const int kk = AK ? i % kDepth : i / kTile;
      const int m = AK ? i / kDepth : i % kTile;
      ra[s] = k0 + kk < K ? fa(m, k0 + kk) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      const int i = tid + s * kThreads;
      const int kk = BK ? i % kDepth : i / BN;
      const int n = BK ? i / kDepth : i % BN;
      rb[s] = k0 + kk < K ? fb(k0 + kk, n) : 0.f;
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
          k0 + kk < K ? ra[s] * sa(k0 + kk) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      const int i = tid + s * kThreads;
      const int kk = BK ? i % kDepth : i / BN;
      st.b[kk][BK ? i / kDepth : i % BN] = rb[s];
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

// v[u][j] of the float32 route, or 1 for the normaliser's pass.
__device__ __forceinline__ float v_at(const WideArgs& a, const float* V,
                                      int pos, int j) {
  return a.v_ones ? 1.f : V[(long long)pos * a.v_ss + j];
}

// G[t][u] for one lower-triangular (t tile, u tile) pair of a chunk.
__global__ __launch_bounds__(kThreads) void f32_scores(WideArgs a) {
  __shared__ Stage<kTile> st;
  const RowChunk p(a);
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.y) ++ti;
  const int ui = (int)blockIdx.y - ti * (ti + 1) / 2;
  const int t0 = ti * kTile, u0 = ui * kTile, p0 = p.c * a.C;
  const int C = a.C, S = a.S;
  const float* Q = static_cast<const float*>(a.q) + p.b * a.q_sb +
                   p.h * a.q_sh;
  const float* K = static_cast<const float*>(a.k) + p.b * a.k_sb +
                   p.h * a.k_sh;
  auto fq = [&](int m, int d) {               // A(t, d) = q[t][d]
    const int t = t0 + m, pos = p0 + t;
    return t < C && pos < S ? Q[(long long)pos * a.q_ss + d] : 0.f;
  };
  auto fk = [&](int d, int n) {               // B(d, u) = k[u][d]
    const int u = u0 + n, pos = p0 + u;
    return u < C && pos < S ? K[(long long)pos * a.k_ss + d] : 0.f;
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

// A chunk's own state contribution on one (dk tile, dv tile).
template <int BN>
__global__ __launch_bounds__(kThreads) void f32_chunk_states(WideArgs a) {
  constexpr int TN = BN / 16;
  __shared__ Stage<BN> st;
  const RowChunk p(a);
  const int n_dv = (a.dv + BN - 1) / BN;
  const int d0 = ((int)blockIdx.y / n_dv) * kTile;
  const int j0 = ((int)blockIdx.y % n_dv) * BN;
  const int p0 = p.c * a.C, S = a.S, dk = a.dk, dv = a.dv;
  const float* K = static_cast<const float*>(a.k) + p.b * a.k_sb +
                   p.h * a.k_sh;
  const float* V = static_cast<const float*>(a.v) + p.b * a.v_sb +
                   p.h * a.v_sh;
  const float* w = a.w + (long long)p.rc * a.C;
  auto fk = [&](int m, int u) {               // A(d, u) = k[u][d], times w_u
    const int d = d0 + m, pos = p0 + u;
    return d < dk && pos < S ? K[(long long)pos * a.k_ss + d] : 0.f;
  };
  auto fv = [&](int u, int n) {               // B(u, j) = v[u][j]
    const int j = j0 + n, pos = p0 + u;
    return j < dv && pos < S ? v_at(a, V, pos, j) : 0.f;
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

// The carry over chunks, one state element a thread, one carry block
// (kEb = kThreads elements) a thread block: slot c then holds the state
// entering chunk c.
__global__ __launch_bounds__(kThreads) void f32_carry(WideArgs a) {
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

// y on one (token tile, dv tile) of a chunk.
template <int BN>
__global__ __launch_bounds__(kThreads) void f32_outputs(WideArgs a) {
  constexpr int TN = BN / 16;
  __shared__ Stage<BN> st;
  const RowChunk p(a);
  const int n_dv = (a.dv + BN - 1) / BN;
  const int t0 = ((int)blockIdx.y / n_dv) * kTile;
  const int j0 = ((int)blockIdx.y % n_dv) * BN;
  const int C = a.C, S = a.S, dv = a.dv, p0 = p.c * C;
  const float* Q = static_cast<const float*>(a.q) + p.b * a.q_sb +
                   p.h * a.q_sh;
  const float* V = static_cast<const float*>(a.v) + p.b * a.v_sb +
                   p.h * a.v_sh;
  const float* G = a.G + (long long)p.rc * C * C;
  const long long r = p.rc / a.n;
  auto fg = [&](int m, int u) {               // A(t, u) = G[t][u]
    const int t = t0 + m;
    return t < C ? G[(long long)t * C + u] : 0.f;
  };
  auto fv = [&](int u, int n) {               // B(u, j) = v[u][j]
    const int j = j0 + n, pos = p0 + u;
    return j < dv && pos < S ? v_at(a, V, pos, j) : 0.f;
  };
  auto fq = [&](int m, int d) {               // A(t, d) = q[t][d]
    const int t = t0 + m, pos = p0 + t;
    return t < C && pos < S ? Q[(long long)pos * a.q_ss + d] : 0.f;
  };
  auto fs = [&](int d, int n) {               // B(d, j) = S_in[d][j]
    const int j = j0 + n;
    return j < dv ? a.cs[cs_at(a, r, p.c, (long long)d * dv + j)] : 0.f;
  };
  float intra[4][TN] = {}, inter[4][TN] = {};
  // keys u < t0 + kTile: G is 0 above the diagonal within the last tile
  tile_product<BN, true, false>(intra, min(C, t0 + kTile), st, fg, fv, One{});
  tile_product<BN, true, false>(inter, a.dk, st, fq, fs, One{});
  float* Y = static_cast<float*>(a.y) + p.b * a.y_sb + p.h * a.y_sh;
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
        Y[(long long)pos * a.y_ss + jj] = intra[i][j] + el * inter[i][j];
    }
  }
}

template <int BN>
cudaError_t launch_f32_dv(const WideArgs& a, int rcs, int n_t, int n_dk,
                          cudaStream_t s) {
  const int n_dv = (a.dv + BN - 1) / BN;
  f32_chunk_states<BN><<<dim3(rcs, n_dk * n_dv), kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long carry = (long long)(rcs / a.n) * a.n_eb;
  if (carry > 0x7fffffffLL) return cudaErrorInvalidValue;
  f32_carry<<<(int)carry, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  f32_outputs<BN><<<dim3(rcs, n_t * n_dv), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_f32(const WideArgs& a, int rcs, cudaStream_t s) {
  const int n_t = (a.C + kTile - 1) / kTile;
  const int n_dk = (a.dk + kTile - 1) / kTile;
  f32_scores<<<dim3(rcs, n_t * (n_t + 1) / 2), kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dv <= 16 (the normaliser's dv = 1): 64 x 16 tiles waste less
  err = a.dv <= 16 ? launch_f32_dv<16>(a, rcs, n_t, n_dk, s)
                   : launch_f32_dv<kTile>(a, rcs, n_t, n_dk, s);
  if (err != cudaSuccess || a.nm == nullptr) return err;
  // the normaliser: v = ones (dv = 1) over the same decays and scores; the
  // chunk-state scratch is free again (stream order)
  WideArgs m = a;
  m.v_ones = 1;
  m.dv = 1;
  m.n_eb = (a.dk + kEb - 1) / kEb;
  m.y = a.nm;
  m.y_sb = a.nm_sb;
  m.y_ss = a.nm_ss;
  m.y_sh = a.nm_sh;
  m.state = a.n_out;
  return launch_f32_dv<16>(m, rcs, n_t, n_dk, s);
}

}  // namespace

// ptrs (16): q, k, v, log_a, beta, y, state, nm, n (nm and n 0 without the
// normaliser), then the scratch: lc, bt, w, lt, g (bf16: hi then lo, each
// g_numel; float32: G), s_in (bf16: hi then lo, each s_numel; float32: the
// chunk states), n_in. dims (30): B, S, H, dk, dv, chunk; the element
// strides (batch, sequence, head) of q, k, v, log_a, beta, y, nm; g_numel,
// s_numel, n_numel, the scratch sizes the caller allocated (elements),
// checked against what this call needs. q, k, v, y, nm have a unit stride on
// the last axis. chunk: tokens per chunk C, 1..256; lc, bt, w hold R*n*C
// floats and lt R*n, with R = B*H and n = ceil(S / C). dtype codes for q,
// k, v, y, nm: 0 float32, 1 bfloat16. Returns a cudaError_t (0 when every
// launch was clean).
extern "C" int ssd_scan_wide_fwd(const unsigned long long* ptrs,
                                 const long long* dims, int dtype,
                                 void* stream) {
  const int B = (int)dims[0], S = (int)dims[1], H = (int)dims[2];
  const int dk = (int)dims[3], dv = (int)dims[4], chunk = (int)dims[5];
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dv <= 0 || dk > kMaxDim ||
      dv > kMaxDim || chunk <= 0 || chunk > kMaxChunk || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int n = (S + chunk - 1) / chunk;
  const long long R = (long long)B * H, rn = R * n;
  if (rn > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool norm = ptrs[7] != 0 && ptrs[8] != 0;
  auto p = [&](int i) { return reinterpret_cast<void*>(ptrs[i]); };
  WideArgs a{};
  a.q = p(0);
  a.k = p(1);
  a.v = p(2);
  a.la = static_cast<const float*>(p(3));
  a.beta = static_cast<const float*>(p(4));
  a.y = p(5);
  a.state = static_cast<float*>(p(6));
  a.nm = norm ? p(7) : nullptr;
  a.n_out = norm ? static_cast<float*>(p(8)) : nullptr;
  a.lc = static_cast<float*>(p(9));
  a.bt = static_cast<float*>(p(10));
  a.w = static_cast<float*>(p(11));
  a.lt = static_cast<float*>(p(12));
  a.S = S;
  a.H = H;
  a.dk = dk;
  a.dv = dv;
  a.C = chunk;
  a.n = n;
  a.n_eb = (int)(((long long)dk * dv + kEb - 1) / kEb);
  a.cp = (chunk + 63) / 64 * 64;
  a.dkp = (dk + 63) / 64 * 64;
  a.dvp = (dv + dv_tile(dv) - 1) / dv_tile(dv) * dv_tile(dv);
  long long* st[7][3] = {{&a.q_sb, &a.q_ss, &a.q_sh},
                         {&a.k_sb, &a.k_ss, &a.k_sh},
                         {&a.v_sb, &a.v_ss, &a.v_sh},
                         {&a.la_sb, &a.la_ss, &a.la_sh},
                         {&a.b_sb, &a.b_ss, &a.b_sh},
                         {&a.y_sb, &a.y_ss, &a.y_sh},
                         {&a.nm_sb, &a.nm_ss, &a.nm_sh}};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) *st[t][i] = dims[6 + 3 * t + i];
  const long long g_numel = dims[27], s_numel = dims[28], n_numel = dims[29];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (g_numel < rn * a.cp * a.cp || s_numel < rn * a.dkp * a.dvp ||
        (norm && n_numel < rn * a.dkp))
      return (int)cudaErrorInvalidValue;
    a.g_hi = static_cast<bf16*>(p(13));
    a.g_lo = a.g_hi + g_numel;
    a.s_hi = static_cast<bf16*>(p(14));
    a.s_lo = a.s_hi + s_numel;
    a.n_in = static_cast<float*>(p(15));
  } else {
    if (g_numel < rn * chunk * chunk || s_numel < rn * a.n_eb * kEb)
      return (int)cudaErrorInvalidValue;
    a.G = static_cast<float*>(p(13));
    a.cs = static_cast<float*>(p(14));
  }
  wide_decay<<<(int)rn, kDecayThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) return (int)launch_f32(a, (int)rn, s);
  return (int)(dv <= 64 ? launch_tc<64>(a, R, s) : launch_tc<256>(a, R, s));
}
