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
// Bound on the card: at zamba2's training shape (1, 4096, 112, 64, 64) the
// chunked backward does ~28 GFLOP and must move ~186 MB (bytes bound,
// 0.055 ms); at xlstm's (1, 4096, 4, 512, 512 + 1) ~46 GFLOP (operations
// bound, 0.046 ms at the bf16 tensor-core rate; chip_smoke.py's
// `ssd_bwd_bound`). Every product runs on the tensor cores (wgmma
// m64n64k16 from 128-byte-swizzled shared panels, hopper.cuh), in these
// launches on the caller's stream:
//   1. bwd_chunk  (row, chunk, 64 x 64 state tile; two warpgroups): each
//      chunk's own contribution to the state, L_c = (w k)^T [v | 1] with
//      w_u = e^(lt-lc_u) beta_u, and to the reverse carry, R_c =
//      (e^(lc) q)^T [dy | dnm], float32, into the chunk's slot of s_in and
//      ds_out; lt per (row, chunk) into ds_out's tail.
//   2. bwd_carry  (row, tile, direction): the carry over the chunks, one
//      element a thread, in place: S_in[c + 1] = e^(lt_c) S_in[c] + L_c in
//      chunk order, dS[c - 1] = e^(lt_c) dS[c] + R_c in reverse order
//      (seeded by d_state / dn; `cut` zeroes that decay), each slot
//      rewritten as the bf16 hi + lo panels of the value it holds (the
//      image the next launches copy to shared memory as it lies); and the
//      tile's partial <d_state, S_final>.
//   3. bwd_fused  (row, chunk; two warpgroups), when the state is one
//      tile (dk <= 64 and dv + norm <= 64, Mamba2's heads): q, k, v, dy,
//      S_in and dS land in shared memory once; warpgroup 0 forms the
//      decayed scores A = mask.D.(dy [v|1]^T) and G = mask.D.(q k~^T)
//      into shared panels while warpgroup 1 forms v dS^T and k dS; then
//      warpgroup 0 takes dq, and 1 dk~ and dv.
//      Wider states instead take two launches:
//   3'. bwd_scores (row, chunk; two warpgroups): A over the 64-column
//      slabs of dv + norm and G over those of dk, once a chunk, into
//      s_in's tail as bf16 hi + lo panels;
//   4'. bwd_grads  (row, chunk, role; one warpgroup): dq or dk~ on 64
//      columns of dk (a ring of dy or v slabs and S_in or dS tiles over
//      dv + norm), or dv on 64 columns of dv (k slabs and dS tiles over
//      dk), then the scores' term from A or G.
//   5. bwd_finish (row): dL and dbeta from the q.dq and k.dk~ partials of
//      the column tiles, summed in order, the final-state term, and the
//      reverse cumsum.
//   6. bwd_cast: dq and dk to the inputs' dtype, shared heads summed in
//      head order.
// Every sum is taken in one fixed order and nothing uses atomics, so two
// runs are bit-equal.
//
// Arithmetic: the bf16 inputs q, k, v and dy enter the products exactly;
// every float32 operand (S_in, dS, A, G, and k or q scaled by w or e^(lc))
// enters as a bf16 hi + lo pair, two products (~16 significant bits, as the
// forward, ssd_scan_wide.cu). float32 inputs take the same kernels with
// their inputs split too: three products (hi hi + hi lo + lo hi). The
// accumulators, the decays, dL and dbeta are float32.
//
// Where the time goes (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py's
// inputs; PERF.md section 6): at zamba2's shape ~0.95 ms, the fused
// gradients 0.48, the chunk contributions 0.16, the carry 0.17, the cast
// 0.09; at xlstm's ~1.29 ms, the carry 0.42, the chunk contributions 0.36,
// the gradients 0.36, the scores 0.05. The design moves the states through
// device memory four times (bwd_chunk writes L and R as float32, the carry
// reads them and writes the images, the gradients read S_in once and dS
// twice: ~2.7 GB at xlstm's shape, 64 x 64 slots padding 513 columns to
// 576), and the carry and the gradients run near the card's memory rate
// for those bytes, so that traffic, not the products, bounds it. The fused
// launch reaches ~40% of the memory rate: each block loads, then computes,
// then stores, two blocks to an SM. Slower, and not kept: a persistent
// fused launch with the next chunk's copies in flight; a chunk pass with v
// and dy scaled on their way into shared memory (no register fragments);
// and a walk of each tile over the chunks in order with the state in wgmma
// accumulators (the forward's states launch, writing each image once in
// place of the chunk pass and the carry): as fast at zamba2's shape, 0.93
// against 0.78 ms at xlstm's, each step waiting on its own chain.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace ssd_bwd {

using namespace repro_torch::sm90;
using repro_torch::from_f;
using repro_torch::to_f;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;                 // tokens a chunk (at most)
constexpr int kD = 64;                 // state rows / columns a tile
constexpr int kPanel = kD * 128;       // bytes of a 64 x 64 bf16 panel
constexpr int kImage = 2 * kPanel;     // a tile's hi and lo panels
constexpr int kImageF = kImage / 4;    // ... in floats: a tile's slot
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
  float* s_in;            // (BH, n_ch, tiles) slots: L_c, then S_in's image
  float* ds_out;          // (BH, n_ch, tiles) slots: R_c, then dS's image
  float* lt;              // (BH, n_ch) the chunks' total log decay
  unsigned char* scores;  // (BH, n_ch) A and G images (not fused)
  float* dq32;            // (B, S, H, dk)
  float* dk32;            // (B, S, H, dk): beta dk~
  float* dl;              // (BH, n_ks, S) partial q . dq
  float* db;              // (BH, n_ks, S) partial k . dk~
  float* fin;             // (BH, tiles) partial <d_state, S_final>
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

// Whether the state is one 64 x 64 tile: the fused gradient launch.
inline bool fused(const Args& a) {
  return a.n_ks == 1 && a.n_vtiles == 1;
}

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

// ------------------------------------------------------- shared panels

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 p) {
  return *reinterpret_cast<uint32_t*>(&p);
}

// (x, y) as a hi pair of bf16 and the rounded remainder as a lo pair.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// A 64 x 64 operand in shared memory: the swizzled bf16 panel `hi` and,
// where the operand is a float32 value, its remainder `lo` (null where the
// operand is an exact bf16 input).
struct Opnd {
  unsigned char* hi;
  unsigned char* lo;
};

// 64 token rows x 64 columns of T into an operand: row r from src + r * ss
// (unit column stride), zero at rows >= rows and columns >= cols, except
// column xj (the normaliser's, when 0 <= xj < 64): xsrc[r * xss], or 1
// where xsrc is null. bf16 lands in `hi` by 16-byte cp.async copies where
// the source allows them (element copies elsewhere); float32 is read into
// registers and split into hi and lo.
template <typename T>
__device__ __forceinline__ void load_slab(Opnd o, const T* src, long long ss,
                                          int rows, int cols, int xj,
                                          const T* xsrc, long long xss,
                                          int tid, int nthr) {
  constexpr bool kF = sizeof(T) == 4;
  const bool al = ((reinterpret_cast<uintptr_t>(src) |
                    static_cast<uintptr_t>(ss * (long long)sizeof(T))) &
                   15) == 0;
  for (int i = tid; i < kT * 8; i += nthr) {
    const int r = i >> 3, pc = i & 7, col = pc * 8;
    const uint32_t off = swizzle128(r, pc);
    const int cnt = r < rows ? max(0, min(8, cols - col)) : 0;
    const bool x = r < rows && xj >= col && xj < col + 8;
    const T* s = src + r * ss + col;
    if (!kF && !x && cnt > 0 && al) {
      cp_async16(smem_u32(o.hi + off), s, 2 * cnt);
      continue;
    }
    float f[8];
    if (kF && !x && cnt == 8 && al) {
      const float4 u = *reinterpret_cast<const float4*>(s);
      const float4 w = *reinterpret_cast<const float4*>(s + 4);
      f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
      f[4] = w.x, f[5] = w.y, f[6] = w.z, f[7] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[e] = e < cnt ? to_f(s[e])
               : x && col + e == xj ? (xsrc ? to_f(xsrc[r * xss]) : 1.f)
               : 0.f;
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(f[2 * e], f[2 * e + 1], h[e], l[e]);
    *reinterpret_cast<uint4*>(o.hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    if (kF)
      *reinterpret_cast<uint4*>(o.lo + off) =
          make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// A tile's image (its hi and lo panels, kImage bytes, as bwd_carry and
// bwd_scores lay them in device memory) into shared memory as it lies.
__device__ __forceinline__ void load_image(unsigned char* dst,
                                           const void* src, int tid,
                                           int nthr) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int i = tid; i < kImage / 16; i += nthr)
    cp_async16(smem_u32(dst + 16 * i), s + 16 * i, 16);
}

// ------------------------------------------------------------- wgmma

// D (64 x 64, f32) += A (64 x 16) B (16 x 64), both from swizzled shared
// panels, K-major (0) or MN-major (1).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_R32
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// k-step kk (16 of K) of a 64 x 64 panel: K-major (K along the columns,
// 32 bytes a step) or MN-major (K down the rows, 16 rows a step).
template <int kTr>
__device__ __forceinline__ uint64_t desc(const unsigned char* p, int kk) {
  return kTr ? sw128_desc(smem_u32(p) + 2048 * kk, kPanel, 1024)
             : sw128_desc(smem_u32(p) + 32 * kk, 16, 1024);
}

// d += A B over K = 64, hi hi, then hi lo where B has a lo part and lo hi
// where A has one.
template <int kTA, int kTB, bool kALo, bool kBLo>
__device__ __forceinline__ void mma(float (&d)[32], Opnd A, Opnd B) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t ah = desc<kTA>(A.hi, kk), bh = desc<kTB>(B.hi, kk);
    wgmma_ss<kTA, kTB>(d, ah, bh);
    if constexpr (kBLo) wgmma_ss<kTA, kTB>(d, ah, desc<kTB>(B.lo, kk));
    if constexpr (kALo) wgmma_ss<kTA, kTB>(d, desc<kTA>(A.lo, kk), bh);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(d);
}

// d += A B over K = 64 with A in registers (hi and lo fragments of four
// k-steps) and B an MN-major panel: ah B, al B, and ah B.lo where B has one.
template <bool kBLo>
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t (&ah)[4][4],
                                       uint32_t (&al)[4][4], Opnd B) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = desc<1>(B.hi, kk);
    wgmma_rs_n64(d, ah[kk], bh);
    wgmma_rs_n64(d, al[kk], bh);
    if constexpr (kBLo) wgmma_rs_n64(d, ah[kk], desc<1>(B.lo, kk));
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(d);
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) d[e] = 0.f;
}

// The register A fragments (s x)^T of four k-steps: rows 16 warp.. of the
// panel's 64 columns, K the panel's token rows, x read transposed
// (ldmatrix.trans; hi + lo for float32) and times s[token], split into hi
// and lo.
template <bool kF>
__device__ __forceinline__ void frags_t(uint32_t (&ah)[4][4],
                                        uint32_t (&al)[4][4], Opnd x,
                                        const float* s, int wt) {
  const int lane = wt & 31, warp = wt >> 5, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int u = 16 * kk + ((lane >> 4) << 3) + (lane & 7);
    const uint32_t off = swizzle128(u, 2 * warp + ((lane >> 3) & 1));
    uint32_t rh[4], rl[4];
    ldsm4t(rh, smem_u32(x.hi) + off);
    if constexpr (kF) ldsm4t(rl, smem_u32(x.lo) + off);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float2 f = unpack(rh[q]);
      if constexpr (kF) {
        const float2 g = unpack(rl[q]);
        f.x += g.x;
        f.y += g.y;
      }
      const float2 w = *reinterpret_cast<const float2*>(
          s + 16 * kk + 2 * tq + (q >> 1) * 8);
      split2(f.x * w.x, f.y * w.y, ah[kk][q], al[kk][q]);
    }
  }
}

// The register A fragments of four k-steps of a score image (rows t, the
// columns u its K): (hi + lo) times s[u], split into hi and lo.
__device__ __forceinline__ void frags_scaled(uint32_t (&ah)[4][4],
                                             uint32_t (&al)[4][4], Opnd x,
                                             const float* s, int wt) {
  const int lane = wt & 31, warp = wt >> 5, tq = lane & 3, m = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = swizzle128(16 * warp + (lane & 7) + 8 * (m & 1),
                                    2 * kk + (m >> 1));
    uint32_t rh[4], rl[4];
    ldsm4(rh, smem_u32(x.hi) + off);
    ldsm4(rl, smem_u32(x.lo) + off);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = unpack(rh[q]), g = unpack(rl[q]);
      const int u = 16 * kk + 8 * (q >> 1) + 2 * tq;
      split2((f.x + g.x) * s[u], (f.y + g.y) * s[u + 1], ah[kk][q],
             al[kk][q]);
    }
  }
}

// The accumulator map (hopper.cuh): element e of thread wt holds row
// row_of(e) and column col_of(e) of the warpgroup's 64 x 64 tile.
__device__ __forceinline__ int row_of(int wt, int e) {
  return 16 * (wt >> 5) + ((wt & 31) >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int col_of(int wt, int e) {
  return 8 * (e >> 2) + 2 * (wt & 3) + (e & 1);
}

// Scale row r of the accumulator by s(r).
template <typename F>
__device__ __forceinline__ void scale_rows(float (&d)[32], int wt, F s) {
  const float sa = s(row_of(wt, 0)), sb = s(row_of(wt, 2));
#pragma unroll
  for (int e = 0; e < 32; ++e) d[e] *= (e & 2) ? sb : sa;
}

// The dot products of the accumulator's two rows of this thread with the
// same rows of an operand (hi + lo), summed over the four threads of a row
// in a fixed order: {row_of(wt, 0), row_of(wt, 2)}.
template <bool kF>
__device__ __forceinline__ float2 row_dots(const float (&d)[32], Opnd x,
                                           int wt) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = row_of(wt, e), c = col_of(wt, e);
    const uint32_t off = swizzle128(r, c >> 3) + (c & 7) * 2;
    float2 f = unpack(*reinterpret_cast<const uint32_t*>(x.hi + off));
    if constexpr (kF) {
      const float2 g = unpack(*reinterpret_cast<const uint32_t*>(x.lo + off));
      f.x += g.x;
      f.y += g.y;
    }
    const float p = d[e] * f.x + d[e + 1] * f.y;
    if (e & 2) s1 += p; else s0 += p;
  }
  s0 += __shfl_xor_sync(kFull, s0, 1);
  s0 += __shfl_xor_sync(kFull, s0, 2);
  s1 += __shfl_xor_sync(kFull, s1, 1);
  s1 += __shfl_xor_sync(kFull, s1, 2);
  return make_float2(s0, s1);
}

// ------------------------------------------------------ the score tiles

// The decayed, masked scores from an accumulator of rows t, columns u:
// acc e^(lc_t - lc_u) (A), or with `beta` acc beta_u e^(lc_t - lc_u) (G),
// for u <= t, else 0; stored as the image (hi panel, then lo) at dst,
// shared or device memory.
__device__ __forceinline__ void store_scores(const float (&d)[32],
                                             const Decays& dc, bool beta,
                                             unsigned char* dst, int wt) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int t = row_of(wt, e), u = col_of(wt, e);
    const float lct = dc.lc[t];
    float g0 = u <= t ? d[e] * expf(lct - dc.lc[u]) : 0.f;
    float g1 = u + 1 <= t ? d[e + 1] * expf(lct - dc.lc[u + 1]) : 0.f;
    if (beta) {
      g0 *= dc.bt[u];
      g1 *= dc.bt[u + 1];
    }
    uint32_t hi, lo;
    split2(g0, g1, hi, lo);
    const uint32_t off = swizzle128(t, u >> 3) + (u & 7) * 2;
    *reinterpret_cast<uint32_t*>(dst + off) = hi;
    *reinterpret_cast<uint32_t*>(dst + kPanel + off) = lo;
  }
}

// ------------------------------------------------ the gradients' tails

// Where a block's gradients go: row bh = (b, h), chunk c at pos0, n tokens.
struct Where {
  int bh, b, h, c, pos0, n;
};

// dq on columns i0 of dk from acc = dy S_in^T (over the columns of dvx):
// e^(lc_t) acc + (A beta) k, with q . dq into dl and dq into dq32.
template <bool kF>
__device__ __forceinline__ void tail_dq(const Args& a, float (&d)[32],
                                        const Decays& dc, Opnd A, Opnd k,
                                        Opnd q, Where w, int ks, int wt) {
  scale_rows(d, wt, [&](int t) { return expf(dc.lc[t]); });
  uint32_t ah[4][4], al[4][4];
  frags_scaled(ah, al, A, dc.bt, wt);
  mma_rs<kF>(d, ah, al, k);
  const float2 pq = row_dots<kF>(d, q, wt);
  const int i0 = ks * kD, cols = min(kD, a.DK - i0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row_of(wt, 2 * half);
    if (t >= w.n) continue;
    if ((wt & 3) == 0)
      a.dl[((long long)w.bh * a.n_ks + ks) * a.S + w.pos0 + t] =
          half ? pq.y : pq.x;
    float* row = a.dq32 + (((long long)w.b * a.S + w.pos0 + t) * a.H + w.h) *
        a.DK + i0;
#pragma unroll
    for (int e = 2 * half; e < 32; e += 4) {
      const int i = col_of(wt, e);
      if (i < cols) row[i] = d[e];
      if (i + 1 < cols) row[i + 1] = d[e + 1];
    }
  }
}

// dk~ on columns i0 of dk from acc = v dS^T (over the columns of dvx):
// e^(lt - lc_u) acc + A^T q, with k . dk~ into db and beta dk~ into dk32.
template <bool kF>
__device__ __forceinline__ void tail_dk(const Args& a, float (&d)[32],
                                        const Decays& dc, Opnd A, Opnd q,
                                        Opnd k, Where w, int ks, int wt) {
  const float lt = dc.lc[a.T - 1];
  scale_rows(d, wt, [&](int u) { return expf(lt - dc.lc[u]); });
  mma<1, 1, true, kF>(d, A, q);
  const float2 pb = row_dots<kF>(d, k, wt);
  const int i0 = ks * kD, cols = min(kD, a.DK - i0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int u = row_of(wt, 2 * half);
    if (u >= w.n) continue;
    if ((wt & 3) == 0)
      a.db[((long long)w.bh * a.n_ks + ks) * a.S + w.pos0 + u] =
          half ? pb.y : pb.x;
    const float bu = dc.bt[u];
    float* row = a.dk32 + (((long long)w.b * a.S + w.pos0 + u) * a.H + w.h) *
        a.DK + i0;
#pragma unroll
    for (int e = 2 * half; e < 32; e += 4) {
      const int i = col_of(wt, e);
      if (i < cols) row[i] = bu * d[e];
      if (i + 1 < cols) row[i + 1] = bu * d[e + 1];
    }
  }
}

// dv on columns j0 of dv from acc = k dS (over the rows of dk):
// beta_u e^(lt - lc_u) acc + G^T dy, stored in v's dtype.
template <typename T>
__device__ __forceinline__ void tail_dv(const Args& a, float (&d)[32],
                                        const Decays& dc, Opnd G, Opnd dy,
                                        Where w, int vs, int wt) {
  constexpr bool kF = sizeof(T) == 4;
  const float lt = dc.lc[a.T - 1];
  scale_rows(d, wt, [&](int u) { return dc.bt[u] * expf(lt - dc.lc[u]); });
  mma<1, 1, true, kF>(d, G, dy);
  const int j0 = vs * kD, cols = min(kD, a.DV - j0);
  T* out = static_cast<T*>(a.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int u = row_of(wt, 2 * half);
    if (u >= w.n) continue;
    T* row = out + (((long long)w.b * a.S + w.pos0 + u) * a.H + w.h) * a.DV +
        j0;
#pragma unroll
    for (int e = 2 * half; e < 32; e += 4) {
      const int j = col_of(wt, e);
      if (j < cols) row[j] = from_f<T>(d[e]);
      if (j + 1 < cols) row[j + 1] = from_f<T>(d[e + 1]);
    }
  }
}

// The inputs of row (b, h) at chunk position pos0.
template <typename T>
struct Rows {
  const T *q, *k, *v, *dy, *dnm;
  __device__ Rows(const Args& a, int b, int h, int pos0) {
    q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + pos0 * a.q_ss;
    k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + pos0 * a.k_ss;
    v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + pos0 * a.v_ss;
    dy = static_cast<const T*>(a.dy) + b * a.dy_sb + h * a.dy_sh +
         pos0 * a.dy_ss;
    dnm = a.dnm ? static_cast<const T*>(a.dnm) + b * a.dnm_sb +
                      h * a.dnm_sh + pos0 * a.dnm_ss
                : nullptr;
  }
};

// The 64 columns at i0 of q or k, and those at j0 of [v | 1] or [dy |
// dnm] (with the normaliser's column where it falls in them).
template <typename T>
__device__ __forceinline__ void load_qk(const Args& a, Opnd o, const T* src,
                                        long long ss, int n, int i0, int tid,
                                        int nthr) {
  load_slab<T>(o, src + i0, ss, n, a.DK - i0, -1, (const T*)nullptr, 0, tid,
               nthr);
}
template <typename T>
__device__ __forceinline__ void load_vy(const Args& a, Opnd o, const T* src,
                                        long long ss, const T* x, int n,
                                        int j0, int tid, int nthr) {
  load_slab<T>(o, src + j0, ss, n, a.DV - j0, a.norm ? a.DV - j0 : -1, x,
               a.dnm_ss, tid, nthr);
}

__device__ __forceinline__ long long slot(const Args& a, int bh, int c,
                                          int tile) {
  return (((long long)bh * a.n_ch + c) * a.n_ks * a.n_vtiles + tile) *
         kImageF;
}

// Operands laid out one after another from `p`, each kIn panels (2 for
// float32 inputs, with their lo parts) or an image (2).
template <int kIn>
__device__ __forceinline__ Opnd take(unsigned char*& p) {
  Opnd o{p, kIn == 2 ? p + kPanel : nullptr};
  p += kIn * kPanel;
  return o;
}

// ------------------------------------------------------------ launches

// 1. L_c and R_c of one 64 x 64 tile (rows i0.. of dk, columns j0.. of
// dvx), chunk c, row (b, h): warpgroup 0 L = (w k)^T [v | 1], warpgroup 1
// R = (e^(lc) q)^T [dy | dnm].
constexpr int kChunkThreads = 256;

template <typename T>
constexpr int chunk_smem() {
  return 4 * (sizeof(T) == 4 ? 2 : 1) * kPanel + 1024;
}

template <typename T>
__global__ __launch_bounds__(kChunkThreads) void bwd_chunk(Args a) {
  constexpr bool kF = sizeof(T) == 4;
  constexpr int kIn = kF ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Decays dc;
  __shared__ __align__(16) float sc[2][kT];   // w_u and e^(lc_t)
  unsigned char* p = align1024(smem_raw);
  const Opnd K = take<kIn>(p), V = take<kIn>(p), Q = take<kIn>(p),
             Y = take<kIn>(p);
  const int tile = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, tid = threadIdx.x;
  const int i0 = (tile / a.n_vtiles) * kD, j0 = (tile % a.n_vtiles) * kD;
  const int pos0 = c * a.T, n = min(a.T, a.S - pos0);
  const Rows<T> in(a, b, h, pos0);
  load_qk<T>(a, K, in.k, a.k_ss, n, i0, tid, kChunkThreads);
  load_vy<T>(a, V, in.v, a.v_ss, nullptr, n, j0, tid, kChunkThreads);
  load_qk<T>(a, Q, in.q, a.q_ss, n, i0, tid, kChunkThreads);
  load_vy<T>(a, Y, in.dy, a.dy_ss, in.dnm, n, j0, tid, kChunkThreads);
  cp_async_commit();
  chunk_decays(a, b, h, c, dc);
  const float lt = dc.lc[a.T - 1];
  if (tid < kT) {
    sc[0][tid] = expf(lt - dc.lc[tid]) * dc.bt[tid];
    sc[1][tid] = expf(dc.lc[tid]);
  }
  if (tile == 0 && tid == 0) a.lt[(long long)bh * a.n_ch + c] = lt;
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const int wg = tid >> 7, wt = tid & 127;
  float acc[32];
  zero(acc);
  uint32_t ah[4][4], al[4][4];
  frags_t<kF>(ah, al, wg ? Q : K, sc[wg], wt);
  mma_rs<kF>(acc, ah, al, wg ? Y : V);
  float* out = (wg ? a.ds_out : a.s_in) + slot(a, bh, c, tile);
#pragma unroll
  for (int e = 0; e < 32; e += 2)
    *reinterpret_cast<float2*>(out + row_of(wt, e) * kD + col_of(wt, e)) =
        make_float2(acc[e], acc[e + 1]);
}

// The block's sum of one value a thread, in a fixed order: lanes by a
// butterfly, then the warps' sums in warp order (thread 0 returns it).
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < blockDim.x / 32; ++w) s += red[w];
  return s;
}

// 2. The carry over the chunks of one 64 x 64 tile of row bh, in chunk
// order (the states, z = 0) or in reverse (the cotangents, z = 1). A
// thread owns two 8-column pieces of the tile; it reads each chunk's
// contribution two chunks ahead, and after a barrier (every thread has read
// the slot) rewrites the slot as the image of the value entering it.
constexpr int kCarryThreads = 256;
constexpr int kCarryAhead = 2;

__global__ __launch_bounds__(kCarryThreads) void bwd_carry(Args a) {
  __shared__ float red[kCarryThreads / 32];
  const int tile = blockIdx.x, bh = blockIdx.y, rev = blockIdx.z;
  const int tid = threadIdx.x;
  const int i0 = (tile / a.n_vtiles) * kD, j0 = (tile % a.n_vtiles) * kD;
  float* base = (rev ? a.ds_out : a.s_in) + slot(a, bh, 0, tile);
  const long long step = (long long)a.n_ks * a.n_vtiles * kImageF;
  const float* LT = a.lt + (long long)bh * a.n_ch;
  const long long row0 = (long long)bh * a.DK;

  // the seed (d_state, dn) or the final state's factor at element (r, col)
  auto dstate = [&](int r, int col) {
    const int i = i0 + r, j = j0 + col;
    if (!a.has_dstate || i >= a.DK || j >= a.DVX) return 0.f;
    return j < a.DV ? a.dstate[(row0 + i) * a.DV + j] : a.dn[row0 + i];
  };
  float cur[2][8];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int pc = tid + kCarryThreads * s, r = pc >> 3, col = (pc & 7) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) cur[s][e] = rev ? dstate(r, col + e) : 0.f;
  }
  float nxt[kCarryAhead][2][8], lts[kCarryAhead];
  auto fetch = [&](float (&x)[2][8], float& l, int i) {
    const int c = rev ? a.n_ch - 1 - i : i;
    const float* src = base + c * step;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int pc = tid + kCarryThreads * s;
      const float4 u = *reinterpret_cast<const float4*>(src + 8 * pc);
      const float4 w = *reinterpret_cast<const float4*>(src + 8 * pc + 4);
      x[s][0] = u.x, x[s][1] = u.y, x[s][2] = u.z, x[s][3] = u.w;
      x[s][4] = w.x, x[s][5] = w.y, x[s][6] = w.z, x[s][7] = w.w;
    }
    l = LT[c];
  };
#pragma unroll
  for (int k = 0; k < kCarryAhead; ++k)
    if (k < a.n_ch) fetch(nxt[k], lts[k], k);
  for (int i0c = 0; i0c < a.n_ch; i0c += kCarryAhead) {
#pragma unroll
    for (int k = 0; k < kCarryAhead; ++k) {
      const int i = i0c + k;
      if (i >= a.n_ch) break;
      const int c = rev ? a.n_ch - 1 - i : i;
      unsigned char* img = reinterpret_cast<unsigned char*>(base + c * step);
      __syncthreads();       // every thread has read slot c
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int pc = tid + kCarryThreads * s;
        const uint32_t off = swizzle128(pc >> 3, pc & 7);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split2(cur[s][2 * e], cur[s][2 * e + 1], hi[e], lo[e]);
        *reinterpret_cast<uint4*>(img + off) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(img + kPanel + off) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      const float decay = rev && a.cut ? 0.f : expf(lts[k]);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          cur[s][e] = fmaf(decay, cur[s][e], nxt[k][s][e]);
      if (i + kCarryAhead < a.n_ch) fetch(nxt[k], lts[k], i + kCarryAhead);
    }
  }
  if (!rev && a.has_dstate) {
    float part = 0.f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int pc = tid + kCarryThreads * s, r = pc >> 3, col = (pc & 7) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) part += cur[s][e] * dstate(r, col + e);
    }
    const float sum = block_sum(part, red);
    if (tid == 0)
      a.fin[(long long)bh * a.n_ks * a.n_vtiles + tile] = sum;
  }
}

// 3. The state in one tile: the scores and all three gradients of chunk c,
// row (b, h), from one load of the chunk's operands. Two warpgroups (two
// blocks to an SM at 128 registers): first warpgroup 0 forms A and G into
// shared panels while warpgroup 1 takes the inter-chunk parts of dk~
// (v dS^T) and dv (k dS); then warpgroup 0 takes dq, 1 dk~ and dv.
constexpr int kFusedThreads = 256;

template <typename T>
constexpr int fused_smem() {
  return (4 * (sizeof(T) == 4 ? 2 : 1) + 8) * kPanel + 1024;
}

template <typename T>
__global__ __launch_bounds__(kFusedThreads, 2) void bwd_fused(Args a) {
  constexpr bool kF = sizeof(T) == 4;
  constexpr int kIn = kF ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Decays dc;
  unsigned char* p = align1024(smem_raw);
  const Opnd Q = take<kIn>(p), K = take<kIn>(p), V = take<kIn>(p),
             Y = take<kIn>(p), SI = take<2>(p), DS = take<2>(p),
             A = take<2>(p), G = take<2>(p);
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int pos0 = c * a.T, n = min(a.T, a.S - pos0);
  const Rows<T> in(a, b, h, pos0);
  load_qk<T>(a, Q, in.q, a.q_ss, n, 0, tid, kFusedThreads);
  load_qk<T>(a, K, in.k, a.k_ss, n, 0, tid, kFusedThreads);
  load_vy<T>(a, V, in.v, a.v_ss, nullptr, n, 0, tid, kFusedThreads);
  load_vy<T>(a, Y, in.dy, a.dy_ss, in.dnm, n, 0, tid, kFusedThreads);
  load_image(SI.hi, a.s_in + slot(a, bh, c, 0), tid, kFusedThreads);
  load_image(DS.hi, a.ds_out + slot(a, bh, c, 0), tid, kFusedThreads);
  cp_async_commit();
  chunk_decays(a, b, h, c, dc);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const Where w{bh, b, h, c, pos0, n};
  float acc[32], acv[32];
  zero(acc);
  if (wg == 0) {               // A = dy [v | 1]^T, G = q k~^T
    mma<0, 0, kF, kF>(acc, Y, V);
    store_scores(acc, dc, false, A.hi, wt);
    zero(acc);
    mma<0, 0, kF, kF>(acc, Q, K);
    store_scores(acc, dc, true, G.hi, wt);
    fence_proxy_async();
  } else {                     // v dS^T and k dS, the inter-chunk parts
    mma<0, 0, kF, true>(acc, V, DS);
    zero(acv);
    mma<0, 1, kF, true>(acv, K, DS);
  }
  __syncthreads();
  if (wg == 0) {
    zero(acc);
    mma<0, 0, kF, true>(acc, Y, SI);
    tail_dq<kF>(a, acc, dc, A, K, Q, w, 0, wt);
  } else {
    tail_dk<kF>(a, acc, dc, A, Q, K, w, 0, wt);
    tail_dv<T>(a, acv, dc, G, Y, w, 0, wt);
  }
}

// 3'. A and G of chunk c, row (b, h): warpgroup 0 A = dy [v | 1]^T over
// the 64-column slabs of dvx, warpgroup 1 G = q k~^T over those of dk, in
// a ring of two stages; then their images into the scores scratch.
constexpr int kScoresThreads = 256;

template <typename T>
constexpr int scores_smem() {
  return 2 * 4 * (sizeof(T) == 4 ? 2 : 1) * kPanel + 1024;
}

template <typename T>
__global__ __launch_bounds__(kScoresThreads) void bwd_scores(Args a) {
  constexpr bool kF = sizeof(T) == 4;
  constexpr int kIn = kF ? 2 : 1;
  constexpr int kStage = 4 * kIn * kPanel;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Decays dc;
  unsigned char* sm = align1024(smem_raw);
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int pos0 = c * a.T, n = min(a.T, a.S - pos0);
  const Rows<T> in(a, b, h, pos0);
  const int steps = max(a.n_vtiles, a.n_ks);
  auto stage = [&](int i, int which) {
    unsigned char* p = sm + (i & 1) * kStage + which * kIn * kPanel;
    return take<kIn>(p);
  };
  auto load = [&](int i) {
    if (i < a.n_vtiles) {
      load_vy<T>(a, stage(i, 0), in.dy, a.dy_ss, in.dnm, n, i * kD, tid,
                 kScoresThreads);
      load_vy<T>(a, stage(i, 1), in.v, a.v_ss, nullptr, n, i * kD, tid,
                 kScoresThreads);
    }
    if (i < a.n_ks) {
      load_qk<T>(a, stage(i, 2), in.q, a.q_ss, n, i * kD, tid,
                 kScoresThreads);
      load_qk<T>(a, stage(i, 3), in.k, a.k_ss, n, i * kD, tid,
                 kScoresThreads);
    }
  };
  float acc[32];
  zero(acc);
  load(0);
  cp_async_commit();
  chunk_decays(a, b, h, c, dc);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();           // slabs i landed; stage i - 1 is free
    if (i + 1 < steps) load(i + 1);
    cp_async_commit();
    if (wg == 0 && i < a.n_vtiles)
      mma<0, 0, kF, kF>(acc, stage(i, 0), stage(i, 1));
    if (wg == 1 && i < a.n_ks)
      mma<0, 0, kF, kF>(acc, stage(i, 2), stage(i, 3));
  }
  store_scores(acc, dc, wg == 1, a.scores +
               ((long long)bh * a.n_ch + c) * 2 * kImage + wg * kImage, wt);
}

// 4'. One gradient tile of chunk c, row (b, h), by role r = blockIdx.x:
// r < n_ks dq on the 64 columns r of dk, r < 2 n_ks dk~ on those of r -
// n_ks, else dv on the 64 columns r - 2 n_ks of dv. A ring of three
// stages carries the loop's operands: dy or v slabs with S_in or dS tiles
// over the columns of dvx (dq, dk~), k slabs with dS tiles over the rows of
// dk (dv).
constexpr int kGradsThreads = 128;
constexpr int kGradsStages = 3;

template <typename T>
constexpr int grads_smem() {
  return (kGradsStages * ((sizeof(T) == 4 ? 2 : 1) + 2) + 2 +
          2 * (sizeof(T) == 4 ? 2 : 1)) * kPanel + 1024;
}

template <typename T>
__global__ __launch_bounds__(kGradsThreads) void bwd_grads(Args a) {
  constexpr bool kF = sizeof(T) == 4;
  constexpr int kIn = kF ? 2 : 1;
  constexpr int kStage = (kIn + 2) * kPanel;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Decays dc;
  unsigned char* p = align1024(smem_raw);
  const Opnd SC = take<2>(p), P0 = take<kIn>(p), P1 = take<kIn>(p);
  unsigned char* ring = p;
  const int role = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, tid = threadIdx.x;
  const int pos0 = c * a.T, n = min(a.T, a.S - pos0);
  const int kind = role < a.n_ks ? 0 : role < 2 * a.n_ks ? 1 : 2;
  const int t = kind == 2 ? role - 2 * a.n_ks : role - kind * a.n_ks;
  const Rows<T> in(a, b, h, pos0);
  const int steps = kind == 2 ? a.n_ks : a.n_vtiles;
  auto X = [&](int i) {
    unsigned char* q = ring + (i % kGradsStages) * kStage;
    return take<kIn>(q);
  };
  auto IMG = [&](int i) {
    unsigned char* q = ring + (i % kGradsStages) * kStage + kIn * kPanel;
    return take<2>(q);
  };
  auto load = [&](int i) {
    if (kind == 0) {
      load_vy<T>(a, X(i), in.dy, a.dy_ss, in.dnm, n, i * kD, tid,
                 kGradsThreads);
      load_image(IMG(i).hi, a.s_in + slot(a, bh, c, t * a.n_vtiles + i),
                 tid, kGradsThreads);
    } else if (kind == 1) {
      load_vy<T>(a, X(i), in.v, a.v_ss, nullptr, n, i * kD, tid,
                 kGradsThreads);
      load_image(IMG(i).hi, a.ds_out + slot(a, bh, c, t * a.n_vtiles + i),
                 tid, kGradsThreads);
    } else {
      load_qk<T>(a, X(i), in.k, a.k_ss, n, i * kD, tid, kGradsThreads);
      load_image(IMG(i).hi, a.ds_out + slot(a, bh, c, i * a.n_vtiles + t),
                 tid, kGradsThreads);
    }
  };
  // the scores, and q / k (dq, dk~) or dy (dv) on the block's columns
  load_image(SC.hi, a.scores + ((long long)bh * a.n_ch + c) * 2 * kImage +
                        (kind == 2 ? kImage : 0), tid, kGradsThreads);
  if (kind == 2) {
    load_slab<T>(P0, in.dy + t * kD, a.dy_ss, n, a.DV - t * kD, -1,
                 (const T*)nullptr, 0, tid, kGradsThreads);
  } else {
    load_qk<T>(a, P0, kind ? in.q : in.k, kind ? a.q_ss : a.k_ss, n, t * kD,
               tid, kGradsThreads);
    load_qk<T>(a, P1, kind ? in.k : in.q, kind ? a.k_ss : a.q_ss, n, t * kD,
               tid, kGradsThreads);
  }
#pragma unroll
  for (int s = 0; s < kGradsStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  chunk_decays(a, b, h, c, dc);
  float acc[32];
  zero(acc);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kGradsStages - 2>();
    fence_proxy_async();
    __syncthreads();           // stage i landed; stage i - 1 is free
    if (i + kGradsStages - 1 < steps) load(i + kGradsStages - 1);
    cp_async_commit();
    if (kind == 2)
      mma<0, 1, kF, true>(acc, X(i), IMG(i));      // k dS
    else
      mma<0, 0, kF, true>(acc, X(i), IMG(i));      // dy S_in^T, v dS^T
  }
  const Where w{bh, b, h, c, pos0, n};
  if (kind == 0)
    tail_dq<kF>(a, acc, dc, SC, P0, P1, w, t, tid);
  else if (kind == 1)
    tail_dk<kF>(a, acc, dc, SC, P0, P1, w, t, tid);
  else
    tail_dv<T>(a, acc, dc, SC, P0, w, t, tid);
}

// 5. dL and dbeta of row (b, h): the column tiles' partials summed in
// order, dL = q . dq - beta k . dk~, the final-state term at the last
// position, and dlog_a as the reverse cumsum of dL, in segments of 256
// positions (a block scan each, warps then their totals, in a fixed
// order).
constexpr int kThreads = 256;

__global__ __launch_bounds__(kThreads) void bwd_finish(Args a) {
  __shared__ float wsum[kThreads / 32];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* BT = a.beta + b * a.b_sb + h * a.b_sh;
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
      x -= BT[(long long)pos * a.b_ss] * db;
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

template <typename Kern>
cudaError_t launch(Kern kern, dim3 grid, int threads, int smem,
                   const Args& a, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(Args a, int B, cudaStream_t s) {
  const int BH = B * a.H;
  const int tiles = a.n_ks * a.n_vtiles;
  cudaError_t err;
  if (BH > 65535 || a.n_ch > 65535) return cudaErrorInvalidValue;
  if ((err = launch(bwd_chunk<T>, dim3(tiles, a.n_ch, BH), kChunkThreads,
                    chunk_smem<T>(), a, s)) != cudaSuccess)
    return err;
  if ((err = launch(bwd_carry, dim3(tiles, BH, 2), kCarryThreads, 0, a, s))
      != cudaSuccess)
    return err;
  if (fused(a)) {
    err = launch(bwd_fused<T>, dim3(a.n_ch, BH), kFusedThreads,
                 fused_smem<T>(), a, s);
  } else {
    err = launch(bwd_scores<T>, dim3(a.n_ch, BH), kScoresThreads,
                 scores_smem<T>(), a, s);
    if (err == cudaSuccess)
      err = launch(bwd_grads<T>, dim3(2 * a.n_ks + a.n_vs, a.n_ch, BH),
                   kGradsThreads, grads_smem<T>(), a, s);
  }
  if (err != cudaSuccess) return err;
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
// which are checked: s_in holds a 64 x 64 tile's slot (kImageF floats) per
// (row, chunk, tile) and, unless the state is one tile, the scores' images
// after them (2 kImageF per (row, chunk)); ds_out the slots and lt (one
// per (row, chunk)). dtype: 0 float32, 1 bfloat16.
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
  const long long rn = B * H * a.n_ch;
  const long long states = rn * a.n_ks * a.n_vtiles * kImageF;
  const long long scores = fused(a) ? 0 : rn * 2 * kImageF;
  if (sz[0] < states + scores || sz[1] < states + rn ||
      sz[2] < B * S * H * DK || sz[3] < B * S * H * DK ||
      sz[4] < B * H * a.n_ks * S || sz[5] < B * H * a.n_ks * S ||
      (a.has_dstate && sz[6] < B * H * a.n_ks * a.n_vtiles))
    return (int)cudaErrorInvalidValue;
  a.lt = a.ds_out + states;
  a.scores = reinterpret_cast<unsigned char*>(a.s_in + states);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(a, (int)B, s);
  if (dtype == 1) return (int)run<__nv_bfloat16>(a, (int)B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ssd_bwd
