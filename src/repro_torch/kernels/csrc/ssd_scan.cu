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
// is <= 0. The sequence tail is padded in shared memory and registers with
// log_a = 0, beta = 0 and q = k = v = 0, which leaves y and the state
// unchanged, so nothing is padded in device memory. Unlike the TPU kernel,
// which streams y only (its wrapper recomputes the final state with a second
// plain pass), this kernel writes the final state too.
//
// Layout: q, k (B, S, H, dk); v, y (B, S, H, dv); log_a, beta (B, S, H),
// float32; each with element strides for batch, sequence and head and a
// unit stride on the last axis. A head stride of 0 is allowed: Mamba2
// passes its per-token B and C, shared by all heads, as expanded views, so
// nothing is repeated in memory. state out: (B, H, dk, dv) float32.
//
// Bound on the card: bytes. At the serving shape (B = 4, S = 8192, H = 112,
// dk = dv = 64, chunk 256) the chunked form does ~80 FLOP per byte of
// q/k/v/y, under the H100's ~300 FLOP/byte bf16 tensor-core line: 0.29 ms.
// What held the previous design (one 256-thread block per (batch, head),
// float32 products on the CUDA cores out of shared memory, loads not
// overlapped) at 20x that bound was the CUDA-core arithmetic with two
// shared-memory loads per 16 multiply-adds, and every tile waiting for its
// own loads. This design:
//
//  * Tensor cores. Every product is mma.sync m16n8k16 with bf16 operands
//    and float32 accumulation, its operands read from shared memory by
//    ldmatrix (.trans for the k-major v and state tiles). q, k and v arrive
//    in bf16 and enter exactly; a float32 operand (the decay-weighted
//    scores G, the w-scaled k of the state update, the state S for q S)
//    enters as a hi + lo pair of bf16 values (x - hi rounded again), two
//    products instead of one, which keeps ~16 significant bits: the float32
//    state stays within 1e-4 of the plain version. With float32 inputs
//    every operand is split so and each product takes three mma (hi hi,
//    hi lo, lo hi), read pairwise instead of by ldmatrix.
//  * The state lives in registers, in the accumulator layout of the warp
//    that owns its rows (16 rows of dk a warp, per 16-row m-tile), scaled by
//    exp(lt) and accumulated into by mma each sub-tile; its hi/lo bf16 copy
//    in shared memory feeds the next sub-tile's q S.
//  * Sub-tiles of min(chunk, 64) tokens (the same recurrence with smaller
//    chunks: exact in real arithmetic). Warp w owns query rows 16w..16w+15
//    of a sub-tile, so it scores only key columns u <= 16w+15 (causal).
//  * cp.async double buffering: the next sub-tile's q, k, v slice, log_a
//    and beta are in flight while the current one computes. A 16-byte copy
//    is used where the source is aligned and whole; the ragged edges
//    (dk or dv not a multiple of 8, odd strides) are loaded element-wise.
//    y leaves through shared memory in 16-byte pieces of whole rows.
//  * One block of 4 warps per (batch, head, slice of kSlice = 64 dv
//    columns): the state's and y's columns in a slice depend only on that
//    slice, so dv up to 128 runs as two slices, each recomputing q k^T and
//    the decays. At the serving shape (dv = 64) that is the whole head in
//    one block, 448 blocks, two a SM. Narrower slices (16 or 32 columns,
//    four or two times the blocks) measured slower there: the recomputation
//    costs more than the fuller card gains.
//
// Three block barriers a sub-tile remain: its loads landed, the decays are
// ready, and the state's shared copy is free to be overwritten. Left
// between the kernel and its bound, not yet measured apart: that
// per-sub-tile chain, the causal G v work (warp 3 does four times warp 0's),
// and the q/k tiles every head re-reads from L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kTile = 64;       // tokens per sub-tile (max)
constexpr int kMaxDim = 128;
constexpr int kSlice = 64;      // dv columns a block owns
constexpr int kPadBytes = 16;   // row padding of shared tiles
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct SsdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* la;
  const float* beta;
  void* y;
  float* state;
  int S, H, dk, dv, tile, n_slices;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long la_sb, la_ss, la_sh;
  long long b_sb, b_ss, b_sh;
  long long y_sb, y_ss, y_sh;
};

using repro_torch::from_f;
using repro_torch::to_f;

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}
__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared-memory layout (byte offsets), one function for host and device.
template <typename T>
struct Layout {
  int dkp, qk_row, v_row, st_row;
  size_t q, k, v, la, bt, buf, sth, stl, ys, lc, wv, el, total;
  __host__ __device__ explicit Layout(int dk) {
    dkp = round16(dk);
    qk_row = dkp + kPadBytes / (int)sizeof(T);
    v_row = kSlice + kPadBytes / (int)sizeof(T);
    st_row = kSlice + kPadBytes / (int)sizeof(__nv_bfloat16);
    q = 0;
    k = align16(q + sizeof(T) * kTile * qk_row);
    v = align16(k + sizeof(T) * kTile * qk_row);
    la = align16(v + sizeof(T) * kTile * v_row);
    bt = la + sizeof(float) * kTile;
    buf = align16(bt + sizeof(float) * kTile);     // one stage
    sth = 2 * buf;
    stl = align16(sth + sizeof(__nv_bfloat16) * dkp * st_row);
    ys = align16(stl + sizeof(__nv_bfloat16) * dkp * st_row);
    lc = align16(ys + sizeof(T) * (kThreads / 32) * 16 * v_row);
    wv = lc + sizeof(float) * kTile;
    el = wv + sizeof(float) * kTile;
    total = align16(el + sizeof(float) * kTile);
  }
};

// ------------------------------------------------------ async copies, mma

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t x) {
  return *reinterpret_cast<__nv_bfloat162*>(&x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives row l / 4, columns 2 (l % 4) and +1 of each (of each
// transposed with .trans).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// Operand fragments of m16n8k16 from shared tiles with row stride rs
// (elements). bf16 tiles go through ldmatrix and enter exactly (lo = 0);
// float32 tiles are read pairwise and split into hi + lo.
//
// A (16 x 16) at (row0, col0) of a row-major [row][col] tile.
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t (&h)[4], uint32_t (&l)[4],
                                       const T* t, int rs, int row0,
                                       int col0, int lane) {
  if constexpr (kIsBf16<T>) {
    ldsm4(h, t + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * rs + col0 +
                 (lane >> 4) * 8);
  } else {
    const int g = lane >> 2, c = col0 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = *reinterpret_cast<const float2*>(
          t + (row0 + g + (i & 1) * 8) * rs + c + (i >> 1) * 8);
      split2(f.x, f.y, h[i], l[i]);
    }
  }
}
// B for two n-tiles (n0, n0 + 8) x k16 at k0, from an n-major [n][k] tile:
// h[0], h[1] are b0, b1 of the first n-tile, h[2], h[3] of the second.
template <typename T>
__device__ __forceinline__ void frag_b_nk(uint32_t (&h)[4], uint32_t (&l)[4],
                                          const T* t, int rs, int n0, int k0,
                                          int lane) {
  if constexpr (kIsBf16<T>) {
    ldsm4(h, t + (n0 + (lane >> 4) * 8 + (lane & 7)) * rs + k0 +
                 ((lane >> 3) & 1) * 8);
  } else {
    const int g = lane >> 2, c = k0 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = *reinterpret_cast<const float2*>(
          t + (n0 + (i >> 1) * 8 + g) * rs + c + (i & 1) * 8);
      split2(f.x, f.y, h[i], l[i]);
    }
  }
}
// The same from a k-major [k][n] tile (v, the state).
template <typename T>
__device__ __forceinline__ void frag_b_kn(uint32_t (&h)[4], uint32_t (&l)[4],
                                          const T* t, int rs, int k0, int n0,
                                          int lane) {
  if constexpr (kIsBf16<T>) {
    ldsm4t(h, t + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * rs + n0 +
                  (lane >> 4) * 8);
  } else {
    const int g = lane >> 2, r = k0 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + (i >> 1) * 8 + g, k = r + (i & 1) * 8;
      split2(t[k * rs + n], t[(k + 1) * rs + n], h[i], l[i]);
    }
  }
}
// A = (w_u k_u)^T (16 rows of dk at d0 x 16 tokens at u0) for the state
// update, from the row-major [u][d] k tile, split into hi + lo.
template <typename T>
__device__ __forceinline__ void frag_a_wkt(uint32_t (&h)[4], uint32_t (&l)[4],
                                           const T* k, int rs, int u0, int d0,
                                           const float* w, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  float2 f[4];
  if constexpr (kIsBf16<T>) {
    uint32_t r[4];
    ldsm4t(r, k + (u0 + (lane >> 4) * 8 + (lane & 7)) * rs + d0 +
                  ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(as_bf162(r[i]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + g + (i & 1) * 8, u = u0 + 2 * tq + (i >> 1) * 8;
      f[i] = make_float2(k[u * rs + d], k[(u + 1) * rs + d]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 wu =
        *reinterpret_cast<const float2*>(w + u0 + 2 * tq + (i >> 1) * 8);
    split2(f[i].x * wu.x, f[i].y * wu.y, h[i], l[i]);
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// One row of a tile: kEpc elements of src at e0 into dst, zero past
// `valid` elements; a 16-byte async copy where whole and aligned.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int e0,
                                           int valid) {
  constexpr int kEpc = 16 / sizeof(T);
  if (e0 + kEpc <= valid &&
      (reinterpret_cast<uintptr_t>(src + e0) & 15) == 0) {
    cp_async16(dst + e0, src + e0);
  } else {
#pragma unroll
    for (int e = 0; e < kEpc; ++e)
      dst[e0 + e] = e0 + e < valid ? src[e0 + e] : from_f<T>(0.f);
  }
}

// MT: 16-row m-tiles of dk a warp owns in the state (1 for dk <= 64, else
// 2).
template <typename T, int MT>
__global__ __launch_bounds__(kThreads, 4) void ssd_scan_kernel(SsdArgs a) {
  constexpr bool kSplit = !kIsBf16<T>;
  constexpr int kEpc = 16 / sizeof(T);
  constexpr int NT = kSlice / 8;        // n-tiles of a dv slice
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T> L(a.dk);
  const int dk = a.dk, dv = a.dv, T_ = a.tile;
  const int dkp = L.dkp, KS = dkp / 16, tp = round16(T_);
  const int qr = L.qk_row, vr = L.v_row, sr = L.st_row;
  __nv_bfloat16* STh = reinterpret_cast<__nv_bfloat16*>(smem + L.sth);
  __nv_bfloat16* STl = reinterpret_cast<__nv_bfloat16*>(smem + L.stl);
  float* lc2 = reinterpret_cast<float*>(smem + L.lc);   // lc * log2(e)
  float* wv = reinterpret_cast<float*>(smem + L.wv);
  float* el = reinterpret_cast<float*>(smem + L.el);
  __shared__ float lt_s;

  const int slice = blockIdx.x % a.n_slices;
  const int bh = blockIdx.x / a.n_slices;
  const int b = bh / a.H, h = bh % a.H;
  const int j0 = slice * kSlice;
  const int vvalid = min(kSlice, dv - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + j0;
  const float* LA = a.la + b * a.la_sb + h * a.la_sh;
  const float* BT = a.beta + b * a.b_sb + h * a.b_sh;
  T* Y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + j0;

  // Start sub-tile t0's loads into stage `st`: rows past the sub-tile or
  // the sequence, and columns past dk / the slice, are zero.
  auto load_tile = [&](int st, int t0) {
    unsigned char* base = smem + st * L.buf;
    T* qs = reinterpret_cast<T*>(base + L.q);
    T* ks = reinterpret_cast<T*>(base + L.k);
    T* vs = reinterpret_cast<T*>(base + L.v);
    float* las = reinterpret_cast<float*>(base + L.la);
    float* bts = reinterpret_cast<float*>(base + L.bt);
    const int cpr = dkp / kEpc;
    for (int i = tid; i < tp * cpr; i += kThreads) {
      const int r = i / cpr, e0 = (i - r * cpr) * kEpc, pos = t0 + r;
      const bool in = r < T_ && pos < a.S;
      load_chunk(qs + r * qr, Q + (long long)pos * a.q_ss, e0, in ? dk : 0);
      load_chunk(ks + r * qr, K + (long long)pos * a.k_ss, e0, in ? dk : 0);
    }
    constexpr int vcpr = kSlice / kEpc;
    for (int i = tid; i < tp * vcpr; i += kThreads) {
      const int r = i / vcpr, e0 = (i % vcpr) * kEpc, pos = t0 + r;
      const bool in = r < T_ && pos < a.S;
      load_chunk(vs + r * vr, V + (long long)pos * a.v_ss, e0,
                 in ? vvalid : 0);
    }
    for (int r = tid; r < tp; r += kThreads) {
      const int pos = t0 + r;
      if (r < T_ && pos < a.S) {
        cp_async4(las + r, LA + (long long)pos * a.la_ss);
        cp_async4(bts + r, BT + (long long)pos * a.b_ss);
      } else {
        las[r] = 0.f;
        bts[r] = 0.f;
      }
    }
  };

  // The state rows this warp owns: m-tiles w (and w + 4) of dk, in the
  // accumulator layout.
  float st[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      st[m][n][0] = st[m][n][1] = st[m][n][2] = st[m][n][3] = 0.f;
  for (int i = tid; i < dkp * sr; i += kThreads) {
    STh[i] = __float2bfloat16(0.f);
    STl[i] = __float2bfloat16(0.f);
  }

  const int n_tiles = (a.S + T_ - 1) / T_;
  load_tile(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * T_;
    if (it + 1 < n_tiles) load_tile((it + 1) & 1, t0 + T_);
    cp_async_commit();
    cp_async_wait1();                    // this sub-tile's copies landed
    __syncthreads();
    unsigned char* base = smem + (it & 1) * L.buf;
    const T* qs = reinterpret_cast<const T*>(base + L.q);
    const T* ks = reinterpret_cast<const T*>(base + L.k);
    const T* vs = reinterpret_cast<const T*>(base + L.v);
    const float* las = reinterpret_cast<const float*>(base + L.la);
    const float* bts = reinterpret_cast<const float*>(base + L.bt);

    if (warp == 0) {
      // inclusive cumsum of log_a over the sub-tile (2 entries a lane)
      const int u0 = lane, u1 = lane + 32;
      float x0 = u0 < tp ? las[u0] : 0.f;
      float x1 = u1 < tp ? las[u1] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y0 = __shfl_up_sync(kFull, x0, o);
        const float y1 = __shfl_up_sync(kFull, x1, o);
        if (lane >= o) {
          x0 += y0;
          x1 += y1;
        }
      }
      x1 += __shfl_sync(kFull, x0, 31);
      const float lt = __shfl_sync(kFull, T_ > 32 ? x1 : x0, (T_ - 1) & 31);
      if (u0 < tp) {
        lc2[u0] = x0 * kLog2e;
        wv[u0] = expf(lt - x0) * bts[u0];
        el[u0] = expf(x0);
      }
      if (u1 < tp) {
        lc2[u1] = x1 * kLog2e;
        wv[u1] = expf(lt - x1) * bts[u1];
        el[u1] = expf(x1);
      }
      if (lane == 0) lt_s = lt;
    }
    __syncthreads();

    if (16 * warp < tp) {
      const int r0 = 16 * warp + g, r1 = r0 + 8;
      // G = q k^T over key columns u <= 16w + 15 (n-tiles 0 .. 2w + 1)
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxDim / 16; ++kk) {
        if (kk >= KS) break;
        uint32_t ah[4], al[4];
        frag_a(ah, al, qs, qr, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np > warp) break;
          uint32_t bh[4], bl[4];
          frag_b_nk(bh, bl, ks, qr, 16 * np, 16 * kk, lane);
          mma(s[2 * np], ah, bh[0], bh[1]);
          mma(s[2 * np + 1], ah, bh[2], bh[3]);
          if constexpr (kSplit) {
            mma(s[2 * np], ah, bl[0], bl[1]);
            mma(s[2 * np + 1], ah, bl[2], bl[3]);
            mma(s[2 * np], al, bh[0], bh[1]);
            mma(s[2 * np + 1], al, bh[2], bh[3]);
          }
        }
      }
      // decay-weighted, masked before exp: G[t][u] = s exp(lc_t - lc_u) b_u,
      // as exp2 of log2(e)-scaled sums (2 ulp)
      const float lc0 = lc2[r0], lc1 = lc2[r1];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n > 2 * warp + 1) break;
        const int u = n * 8 + 2 * tq;
        const float2 lu = *reinterpret_cast<const float2*>(lc2 + u);
        const float2 bu = *reinterpret_cast<const float2*>(bts + u);
        s[n][0] = u <= r0 ? s[n][0] * exp2f(lc0 - lu.x) * bu.x : 0.f;
        s[n][1] = u + 1 <= r0 ? s[n][1] * exp2f(lc0 - lu.y) * bu.y : 0.f;
        s[n][2] = u <= r1 ? s[n][2] * exp2f(lc1 - lu.x) * bu.x : 0.f;
        s[n][3] = u + 1 <= r1 ? s[n][3] * exp2f(lc1 - lu.y) * bu.y : 0.f;
      }
      // y = exp(lc_t) q S_prev + G v over this slice's columns
      float y[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxDim / 16; ++kk) {
        if (kk >= KS) break;
        uint32_t ah[4], al[4];
        frag_a(ah, al, qs, qr, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t sh[4], sl[4], unused[4];
          frag_b_kn(sh, unused, STh, sr, 16 * kk, 16 * np, lane);
          frag_b_kn(sl, unused, STl, sr, 16 * kk, 16 * np, lane);
          mma(y[2 * np], ah, sh[0], sh[1]);
          mma(y[2 * np + 1], ah, sh[2], sh[3]);
          mma(y[2 * np], ah, sl[0], sl[1]);
          mma(y[2 * np + 1], ah, sl[2], sl[3]);
          if constexpr (kSplit) {
            mma(y[2 * np], al, sh[0], sh[1]);
            mma(y[2 * np + 1], al, sh[2], sh[3]);
          }
        }
      }
      const float e0 = el[r0], e1 = el[r1];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        y[n][0] *= e0;
        y[n][1] *= e0;
        y[n][2] *= e1;
        y[n][3] *= e1;
      }
#pragma unroll
      for (int ku = 0; ku < 4; ++ku) {
        if (ku > warp) break;
        uint32_t gh[4], gl[4];
        split2(s[2 * ku][0], s[2 * ku][1], gh[0], gl[0]);
        split2(s[2 * ku][2], s[2 * ku][3], gh[1], gl[1]);
        split2(s[2 * ku + 1][0], s[2 * ku + 1][1], gh[2], gl[2]);
        split2(s[2 * ku + 1][2], s[2 * ku + 1][3], gh[3], gl[3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bh[4], bl[4];
          frag_b_kn(bh, bl, vs, vr, 16 * ku, 16 * np, lane);
          mma(y[2 * np], gh, bh[0], bh[1]);
          mma(y[2 * np + 1], gh, bh[2], bh[3]);
          mma(y[2 * np], gl, bh[0], bh[1]);
          mma(y[2 * np + 1], gl, bh[2], bh[3]);
          if constexpr (kSplit) {
            mma(y[2 * np], gh, bl[0], bl[1]);
            mma(y[2 * np + 1], gh, bl[2], bl[3]);
          }
        }
      }
      // y through this warp's staging rows, then out in 16-byte pieces of
      // whole rows (scattered 2-byte stores cost more than the math)
      T* ys = reinterpret_cast<T*>(smem + L.ys) + warp * 16 * vr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int j = n * 8 + 2 * tq;
        store2(ys + g * vr + j, y[n][0], y[n][1]);
        store2(ys + (g + 8) * vr + j, y[n][2], y[n][3]);
      }
      __syncwarp();
      constexpr int ycpr = kSlice / kEpc;
      for (int i = lane; i < 16 * ycpr; i += 32) {
        const int lr = i / ycpr, c0 = (i % ycpr) * kEpc;
        const int t = 16 * warp + lr;
        if (t >= T_ || t0 + t >= a.S) continue;
        T* dst = Y + (long long)(t0 + t) * a.y_ss + c0;
        const T* src = ys + lr * vr + c0;
        if (c0 + kEpc <= vvalid &&
            (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < kEpc && c0 + e < vvalid; ++e) dst[e] = src[e];
        }
      }
    }

    // S = exp(lt) S + sum_u (w_u k_u) v_u^T on this warp's rows of dk
    const float elt = expf(lt_s);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = warp + 4 * m;
      if (mt >= KS) break;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[m][n][e] *= elt;
#pragma unroll
      for (int ku = 0; ku < 4; ++ku) {
        if (16 * ku >= tp) break;
        uint32_t ah[4], al[4];
        frag_a_wkt(ah, al, ks, qr, 16 * ku, 16 * mt, wv, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bh[4], bl[4];
          frag_b_kn(bh, bl, vs, vr, 16 * ku, 16 * np, lane);
          mma(st[m][2 * np], ah, bh[0], bh[1]);
          mma(st[m][2 * np + 1], ah, bh[2], bh[3]);
          mma(st[m][2 * np], al, bh[0], bh[1]);
          mma(st[m][2 * np + 1], al, bh[2], bh[3]);
          if constexpr (kSplit) {
            mma(st[m][2 * np], ah, bl[0], bl[1]);
            mma(st[m][2 * np + 1], ah, bl[2], bl[3]);
          }
        }
      }
    }
    __syncthreads();                     // every q S_prev has read ST
    // the new state's hi/lo copy (ST[d][j]) for the next sub-tile's q S
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = warp + 4 * m;
      if (mt >= KS) break;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = mt * 16 + g + 8 * half;
          const int j = n * 8 + 2 * tq;
          uint32_t hi, lo;
          split2(st[m][n][2 * half], st[m][n][2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(STh + d * sr + j) = hi;
          *reinterpret_cast<uint32_t*>(STl + d * sr + j) = lo;
        }
      }
    }
  }

  float* out = a.state + (long long)bh * dk * dv;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = warp + 4 * m;
    if (mt >= KS) break;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = mt * 16 + g + (e < 2 ? 0 : 8);
        const int j = n * 8 + 2 * tq + (e & 1);
        if (d < dk && j < vvalid)
          out[(long long)d * dv + j0 + j] = st[m][n][e];
      }
    }
  }
}

template <typename T, int MT>
cudaError_t launch(SsdArgs a, int BH, cudaStream_t s) {
  const size_t bytes = Layout<T>(a.dk).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  a.n_slices = (a.dv + kSlice - 1) / kSlice;
  const long long blocks = (long long)BH * a.n_slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_scan_kernel<T, MT><<<(int)blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mt(const SsdArgs& a, int BH, cudaStream_t s) {
  return a.dk <= 64 ? launch<T, 1>(a, BH, s) : launch<T, 2>(a, BH, s);
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
    long long y_sb, long long y_ss, long long y_sh, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dv <= 0 || dk > kMaxDim ||
      dv > kMaxDim || tile <= 0 || tile > kTile ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  SsdArgs a{q,    k,    v,     static_cast<const float*>(log_a),
            static_cast<const float*>(beta), y, static_cast<float*>(state),
            S,    H,    dk,    dv,   tile, 1,
            q_sb, q_ss, q_sh,  k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            la_sb, la_ss, la_sh, b_sb, b_ss, b_sh, y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_mt<float>(a, B * H, s);
  if (dtype == 1) return (int)launch_mt<__nv_bfloat16>(a, B * H, s);
  return (int)cudaErrorInvalidValue;
}
