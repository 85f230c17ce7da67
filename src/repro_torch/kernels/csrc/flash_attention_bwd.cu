// Flash attention backward for Hopper (sm_90a): dq, dk and dv of causal /
// windowed GQA attention from q, k, v, the forward's output o, its rows'
// log-sum-exp and the output gradient do. Deterministic: no atomics; every
// gradient element is summed by one thread in a fixed order.
//
// Replaces no TPU kernel: the reference differentiates its jnp chunked
// attention (src/repro/models/attention.py::chunked_attention) and has no
// custom_vjp around `flash_attention_pallas`. It is the backward of this
// port's forward kernel (flash_attention.cu), so training on the card runs
// attention on kernels both ways. The function, for query row i, key j and
// the forward's scale and masks (j < Sk, causal j <= i, window j > i - w):
//   P_ij = exp(s_ij - lse_i) (0 where masked),   D_i = sum_d do_id o_id,
//   dv_j = sum_i P_ij do_i,   dP_ij = do_i . v_j,   dS_ij = P_ij (dP_ij - D_i),
//   dq_i = scale sum_j dS_ij k_j,   dk_j = scale sum_i dS_ij q_i,
// with dk and dv of a kv head summed over the query heads of its group.
//
// Bound on the card: operations, about 2.5x the forward's (five products of
// the forward's size against two; P is recomputed instead of stored). This
// first design is simple and right, not fast: three launches,
//  1. `bwd_delta`: D = rowsum(do * o), one warp a row, float32 (B, H, Sq).
//  2. `bwd_dkdv`: one 256-thread block per (batch, kv head, 128-key tile);
//     each of its 8 warps owns 16 keys and keeps their dk and dv in
//     registers (float32) while the block steps over the query heads of the
//     group and, per head, over the 64-query tiles the key tile meets
//     (causal: from its first key on; window: up to its last key + w).
//     Per step: S^T = K Q^T and dP^T = V dO^T (K, V as the A operands from
//     shared memory, Q, dO as B), P^T and dS^T formed in registers and fed
//     back as bf16 A operands of dV += P^T dO and dK += dS^T Q.
//  3. `bwd_dq`: one block per (batch, head, 128-row query tile), 16 rows a
//     warp, stepping over 64-key tiles (the forward's tile range): S = Q K^T,
//     dP = dO V^T, dS, dQ += dS K.
// All products are mma.sync m16n8k16 (bf16 in, float32 accumulate) on
// ldmatrix fragments; tiles arrive by cp.async (rows past S zero-filled)
// into shared rows padded by 16 bytes, which keeps ldmatrix free of bank
// conflicts. Loads and products do not overlap, and the dK/dV launch has
// only B * KV * ceil(Sk / 128) blocks (64 at qwen2.5-3b's training shape
// on 132 SMs): the places a faster design starts from (PERF.md has the
// times).
//
// Layout: q, o, do (B, Sq, H, dh) and k, v (B, Sk, KV, dh) read through
// element strides (dh unit-stride, rows 16-byte aligned); lse and the
// scratch D (B, H, Sq) float32; dq (B, Sq, H, dh), dk and dv (B, Sk, KV, dh)
// written contiguous, bf16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace repro_torch::sm90;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;       // 8 warps, 16 rows each
constexpr int kBK = 128;            // dK/dV: keys per block
constexpr int kSQ = 64;             // dK/dV: queries per step
constexpr int kBQ = 128;            // dQ: query rows per block
constexpr int kSK = 64;             // dQ: keys per step

struct BwdArgs {
  const bf16 *q, *k, *v, *o, *dO;
  const float* lse;                 // (B, H, Sq)
  float* delta;                     // (B, H, Sq)
  bf16 *dq, *dk, *dv;
  long long st[5][3];               // (b, s, h) element strides: q k v o dO
  int B, Sq, Sk, H, KV, causal, window;
  float scale, scale_log2;
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives row l / 4, columns 2 (l % 4) and +1 of each (of each
// transposed with .trans).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The A fragment (16 x 16) at (row0, col0) of a row-major tile (stride RS).
template <int RS>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* t,
                                       int row0, int col0, int lane) {
  ldsm4(r, t + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + col0 +
               (lane >> 4) * 8);
}
// B fragments of two n-tiles (n0, n0 + 8) x 16 k, with B[k][n] = T[n][k]
// (T row-major over n): r0, r1 for n-tile n0, r2, r3 for n0 + 8.
template <int RS>
__device__ __forceinline__ void frag_b_nk(uint32_t (&r)[4], const bf16* t,
                                          int n0, int k0, int lane) {
  ldsm4(r, t + (n0 + (lane & 7) + ((lane >> 4) & 1) * 8) * RS + k0 +
               ((lane >> 3) & 1) * 8);
}
// The same with B[k][n] = T[k][n] (T row-major over k).
template <int RS>
__device__ __forceinline__ void frag_b_kn(uint32_t (&r)[4], const bf16* t,
                                          int k0, int n0, int lane) {
  ldsm4t(r, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + n0 +
                (lane >> 4) * 8);
}

// Rows [r0, r0 + R) of one head's (S, DH) slice (row stride `ss` elements)
// into shared rows of stride RS; rows at or past S are zero-filled.
template <int DH, int RS, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* head,
                                          long long ss, int r0, int S) {
  constexpr int CH = DH / 8;        // 16-byte pieces a row
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < S;
    const bf16* src = head + (ok ? (r0 + r) * ss : 0) + c * 8;
    cp_async16(smem_u32(dst + r * RS + c * 8), src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ bool valid(const BwdArgs& a, int qp, int kp) {
  bool ok = qp < a.Sq && kp < a.Sk;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && kp > qp - a.window;
  return ok;
}

// ------------------------------------------------------------ D = do . o

__global__ void __launch_bounds__(kThreads)
    bwd_delta(const BwdArgs a, int dh) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.B) * a.Sq * a.H) return;
  const int h = row % a.H;
  const int s = (row / a.H) % a.Sq;
  const int b = row / (static_cast<long long>(a.H) * a.Sq);
  const bf16* o = a.o + b * a.st[3][0] + s * a.st[3][1] + h * a.st[3][2];
  const bf16* d = a.dO + b * a.st[4][0] + s * a.st[4][1] + h * a.st[4][2];
  float acc = 0.f;
  for (int c = 2 * lane; c < dh; c += 64) {
    const float2 of = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 df = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(d + c));
    acc += of.x * df.x + of.y * df.y;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) a.delta[(static_cast<long long>(b) * a.H + h) * a.Sq + s] = acc;
}

// ------------------------------------------------------------- dK and dV

template <int DH>
struct Dims {
  static constexpr int RS = DH + 8;          // padded shared row (elements)
  static constexpr int KT = DH / 16;         // k-steps over dh
  static constexpr int NT = DH / 8;          // n-tiles over dh
  static constexpr int SMEM = (2 * 128 + 2 * 64) * RS * 2 + 2 * 64 * 4;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1) bwd_dkdv(const BwdArgs a) {
  using T = Dims<DH>;
  constexpr int RS = T::RS;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);   // kBK rows
  bf16* sV = sK + kBK * RS;
  bf16* sQ = sV + kBK * RS;                   // kSQ rows
  bf16* sO = sQ + kSQ * RS;                   // dO
  float* sL = reinterpret_cast<float*>(sO + kSQ * RS);   // lse * log2(e)
  float* sD = sL + kSQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int n_kt = (a.Sk + kBK - 1) / kBK;
  const int bkv = blockIdx.x / n_kt, kt = blockIdx.x % n_kt;
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int k0 = kt * kBK;
  const int grp = a.H / a.KV;
  const int key0 = k0 + warp * 16 + (lane >> 2), key1 = key0 + 8;

  load_rows<DH, RS, kBK>(sK, a.k + b * a.st[1][0] + kvh * a.st[1][2],
                         a.st[1][1], k0, a.Sk);
  load_rows<DH, RS, kBK>(sV, a.v + b * a.st[2][0] + kvh * a.st[2][2],
                         a.st[2][1], k0, a.Sk);
  cp_async_commit();

  // the query tiles this key tile meets
  const int q_lo = a.causal ? k0 : 0;
  int q_hi = a.Sq;
  if (a.window > 0) q_hi = min(q_hi, k0 + kBK - 1 + a.window);
  const int qt0 = q_lo / kSQ, qt1 = (q_hi + kSQ - 1) / kSQ;

  float dk[T::NT][4], dv[T::NT][4];
#pragma unroll
  for (int i = 0; i < T::NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int hh = 0; hh < grp; ++hh) {
    const int h = kvh * grp + hh;
    const long long lrow = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kSQ;
      __syncthreads();                  // the last step's reads are done
      load_rows<DH, RS, kSQ>(sQ, a.q + b * a.st[0][0] + h * a.st[0][2],
                             a.st[0][1], q0, a.Sq);
      load_rows<DH, RS, kSQ>(sO, a.dO + b * a.st[4][0] + h * a.st[4][2],
                             a.st[4][1], q0, a.Sq);
      cp_async_commit();
      if (threadIdx.x < kSQ) {
        const int qp = q0 + threadIdx.x;
        sL[threadIdx.x] = qp < a.Sq ? a.lse[lrow + qp] * kLog2e : 0.f;
        sD[threadIdx.x] = qp < a.Sq ? a.delta[lrow + qp] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, 16 keys x kSQ queries a warp
      float s[kSQ / 8][4], dp[kSQ / 8][4];
#pragma unroll
      for (int i = 0; i < kSQ / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < T::KT; ++kk) {
        uint32_t ka[4], va[4];
        frag_a<RS>(ka, sK, warp * 16, kk * 16, lane);
        frag_a<RS>(va, sV, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < kSQ / 16; ++np) {
          uint32_t qb[4], ob[4];
          frag_b_nk<RS>(qb, sQ, np * 16, kk * 16, lane);
          frag_b_nk<RS>(ob, sO, np * 16, kk * 16, lane);
          mma(s[2 * np], ka, qb[0], qb[1]);
          mma(s[2 * np + 1], ka, qb[2], qb[3]);
          mma(dp[2 * np], va, ob[0], ob[1]);
          mma(dp[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      // P^T and dS^T in place of S^T and dP^T
#pragma unroll
      for (int i = 0; i < kSQ / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = i * 8 + 2 * t + (e & 1);
          const float p = valid(a, q0 + c, e < 2 ? key0 : key1)
                              ? exp2f(s[i][e] * a.scale_log2 - sL[c])
                              : 0.f;
          s[i][e] = p;
          dp[i][e] = p * (dp[i][e] - sD[c]);
        }
      // dV += P^T dO and dK += dS^T Q, k over the kSQ queries
#pragma unroll
      for (int ks = 0; ks < kSQ / 16; ++ks) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * ks][0], s[2 * ks][1]),
            pack_bf16(s[2 * ks][2], s[2 * ks][3]),
            pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
            pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dp[2 * ks][0], dp[2 * ks][1]),
            pack_bf16(dp[2 * ks][2], dp[2 * ks][3]),
            pack_bf16(dp[2 * ks + 1][0], dp[2 * ks + 1][1]),
            pack_bf16(dp[2 * ks + 1][2], dp[2 * ks + 1][3])};
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t ob[4], qb[4];
          frag_b_kn<RS>(ob, sO, ks * 16, np * 16, lane);
          frag_b_kn<RS>(qb, sQ, ks * 16, np * 16, lane);
          mma(dv[2 * np], pa, ob[0], ob[1]);
          mma(dv[2 * np + 1], pa, ob[2], ob[3]);
          mma(dk[2 * np], da, qb[0], qb[1]);
          mma(dk[2 * np + 1], da, qb[2], qb[3]);
        }
      }
    }
  }

  // rows key0 and key1 of dk (scaled) and dv, contiguous (B, Sk, KV, DH)
  const long long r0 = ((static_cast<long long>(b) * a.Sk + key0) * a.KV +
                        kvh) * DH;
  const long long r1 = r0 + 8LL * a.KV * DH;
#pragma unroll
  for (int i = 0; i < T::NT; ++i) {
    const int c = i * 8 + 2 * t;
    if (key0 < a.Sk) {
      *reinterpret_cast<uint32_t*>(a.dk + r0 + c) =
          pack_bf16(dk[i][0] * a.scale, dk[i][1] * a.scale);
      *reinterpret_cast<uint32_t*>(a.dv + r0 + c) = pack_bf16(dv[i][0],
                                                              dv[i][1]);
    }
    if (key1 < a.Sk) {
      *reinterpret_cast<uint32_t*>(a.dk + r1 + c) =
          pack_bf16(dk[i][2] * a.scale, dk[i][3] * a.scale);
      *reinterpret_cast<uint32_t*>(a.dv + r1 + c) = pack_bf16(dv[i][2],
                                                              dv[i][3]);
    }
  }
}

// -------------------------------------------------------------------- dQ

template <int DH>
__global__ void __launch_bounds__(kThreads, 1) bwd_dq(const BwdArgs a) {
  using T = Dims<DH>;
  constexpr int RS = T::RS;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // kBQ rows
  bf16* sO = sQ + kBQ * RS;                   // dO
  bf16* sK = sO + kBQ * RS;                   // kSK rows
  bf16* sV = sK + kSK * RS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / n_qt, rank = blockIdx.x % n_qt;
  const int qt = a.causal ? n_qt - 1 - rank : rank;   // longest tiles first
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * kBQ;
  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;

  load_rows<DH, RS, kBQ>(sQ, a.q + b * a.st[0][0] + h * a.st[0][2],
                         a.st[0][1], q0, a.Sq);
  load_rows<DH, RS, kBQ>(sO, a.dO + b * a.st[4][0] + h * a.st[4][2],
                         a.st[4][1], q0, a.Sq);
  cp_async_commit();
  const long long lrow = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const float l0 = row0 < a.Sq ? a.lse[lrow + row0] * kLog2e : 0.f;
  const float l1 = row1 < a.Sq ? a.lse[lrow + row1] * kLog2e : 0.f;
  const float d0 = row0 < a.Sq ? a.delta[lrow + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.delta[lrow + row1] : 0.f;

  // the forward's key-tile range for this query tile
  int kt1 = (a.Sk + kSK - 1) / kSK;
  if (a.causal) kt1 = min(kt1, (q0 + kBQ - 1) / kSK + 1);
  int kt0 = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) kt0 = (q0 - a.window + 1) / kSK;

  float dq[T::NT][4];
#pragma unroll
  for (int i = 0; i < T::NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int kb = kt * kSK;
    __syncthreads();                    // the last step's reads are done
    load_rows<DH, RS, kSK>(sK, a.k + b * a.st[1][0] + kvh * a.st[1][2],
                           a.st[1][1], kb, a.Sk);
    load_rows<DH, RS, kSK>(sV, a.v + b * a.st[2][0] + kvh * a.st[2][2],
                           a.st[2][1], kb, a.Sk);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 16 rows x kSK keys a warp
    float s[kSK / 8][4], dp[kSK / 8][4];
#pragma unroll
    for (int i = 0; i < kSK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::KT; ++kk) {
      uint32_t qa[4], oa[4];
      frag_a<RS>(qa, sQ, warp * 16, kk * 16, lane);
      frag_a<RS>(oa, sO, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < kSK / 16; ++np) {
        uint32_t kb4[4], vb[4];
        frag_b_nk<RS>(kb4, sK, np * 16, kk * 16, lane);
        frag_b_nk<RS>(vb, sV, np * 16, kk * 16, lane);
        mma(s[2 * np], qa, kb4[0], kb4[1]);
        mma(s[2 * np + 1], qa, kb4[2], kb4[3]);
        mma(dp[2 * np], oa, vb[0], vb[1]);
        mma(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }
    // dS in place of dP
#pragma unroll
    for (int i = 0; i < kSK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const float p = valid(a, hi ? row1 : row0, kb + i * 8 + 2 * t + (e & 1))
                            ? exp2f(s[i][e] * a.scale_log2 - (hi ? l1 : l0))
                            : 0.f;
        dp[i][e] = p * (dp[i][e] - (hi ? d1 : d0));
      }
    // dQ += dS K, k over the kSK keys
#pragma unroll
    for (int ks = 0; ks < kSK / 16; ++ks) {
      const uint32_t da[4] = {
          pack_bf16(dp[2 * ks][0], dp[2 * ks][1]),
          pack_bf16(dp[2 * ks][2], dp[2 * ks][3]),
          pack_bf16(dp[2 * ks + 1][0], dp[2 * ks + 1][1]),
          pack_bf16(dp[2 * ks + 1][2], dp[2 * ks + 1][3])};
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t kb4[4];
        frag_b_kn<RS>(kb4, sK, ks * 16, np * 16, lane);
        mma(dq[2 * np], da, kb4[0], kb4[1]);
        mma(dq[2 * np + 1], da, kb4[2], kb4[3]);
      }
    }
  }

  const long long r0 = ((static_cast<long long>(b) * a.Sq + row0) * a.H + h) *
                       DH;
  const long long r1 = r0 + 8LL * a.H * DH;
#pragma unroll
  for (int i = 0; i < T::NT; ++i) {
    const int c = i * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<uint32_t*>(a.dq + r0 + c) =
          pack_bf16(dq[i][0] * a.scale, dq[i][1] * a.scale);
    if (row1 < a.Sq)
      *reinterpret_cast<uint32_t*>(a.dq + r1 + c) =
          pack_bf16(dq[i][2] * a.scale, dq[i][3] * a.scale);
  }
}

// ------------------------------------------------------------------- host

template <int DH>
cudaError_t launch(const BwdArgs& a, cudaStream_t s) {
  using T = Dims<DH>;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dkdv<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dq<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::SMEM);
  if (e != cudaSuccess) return e;
  const long long dkdv_blocks =
      static_cast<long long>(a.B) * a.KV * ((a.Sk + kBK - 1) / kBK);
  const long long dq_blocks =
      static_cast<long long>(a.B) * a.H * ((a.Sq + kBQ - 1) / kBQ);
  if (dkdv_blocks > 0x7fffffffLL || dq_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  bwd_dkdv<DH><<<static_cast<int>(dkdv_blocks), kThreads, T::SMEM, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq<DH><<<static_cast<int>(dq_blocks), kThreads, T::SMEM, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, do bfloat16 (dh unit-stride, rows 16-byte aligned), their
// (b, s, h) element strides in `strides` (15 values, q k v o do in turn),
// lse float32 (B, H, Sq) contiguous, `delta` float32 (B, H, Sq) scratch;
// writes dq (B, Sq, H, dh), dk and dv (B, Sk, KV, dh) contiguous bf16.
// Three launches on `stream`; returns 0 or the first cudaError_t.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dO, void* dq, void* dk, void* dv,
    void* delta, int B, int Sq, int Sk, int H, int KV, int dh,
    const long long* strides, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dO = static_cast<const bf16*>(dO);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_delta<<<static_cast<int>(blocks), kThreads, 0, s>>>(a, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (dh) {
    case 32: return (int)launch<32>(a, s);
    case 64: return (int)launch<64>(a, s);
    case 96: return (int)launch<96>(a, s);
    case 112: return (int)launch<112>(a, s);
    case 128: return (int)launch<128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The built tiles: keys per dK/dV block and queries per step of its loop,
// query rows per dQ block and keys per step of its loop.
extern "C" void flash_attention_bwd_tiles(int* out) {
  out[0] = kBK;
  out[1] = kSQ;
  out[2] = kBQ;
  out[3] = kSK;
}
