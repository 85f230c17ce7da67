// Flash attention backward for Hopper (sm_90a): dq, dk and dv of causal /
// windowed GQA attention from q, k, v, the forward's output o, its rows'
// log-sum-exp and the output gradient do. Deterministic: no atomics; every
// gradient element is summed by one thread, or by one thread and then a
// fixed-order sum over splits, in the same order on every run.
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
// Bound on the card: operations. The function is five products of the
// forward's size (S and dP, then dV, dK, dQ) against the forward's two: 2.5x
// its bound. This design recomputes S and dP in the dQ launch, so the card
// does seven: 7/5 of the work the bound counts. That keeps dQ free of
// atomics (one block owns a query tile's dq) at 2/5 more tensor work.
//
// Launches, in order on the caller's stream:
//  1. `bwd_delta`: one warp a row, D = rowsum(do * o) and lse * log2(e)
//     into a float32 (B, H, Sq_pad, 2) scratch, Sq_pad = Sq rounded up to
//     64; padding rows get (+inf, 0), so P = 2^(s - inf) = 0 there.
//  2. `bwd_dkdv`: one block per (128-key tile, batch, kv head, split), two
//     warpgroups of 64 keys each, which hold dK and dV of their keys in
//     float32 registers through the block's steps. Thread 0 loads the key
//     tile's K and V once by TMA and keeps a ring of kStagesKV stages of
//     64-query Q and dO tiles (TMA, 128-byte swizzle) and their (lse, D)
//     rows (one bulk copy) kAheadKV steps ahead of use, each stage behind a
//     "full" mbarrier (expect_tx) and an "empty" one every thread arrives
//     on. A step: S^T = K Q^T and dP^T = V dO^T in one wgmma group
//     (m64n64k16, K / V and Q / dO K-major from shared memory); P^T and
//     dS^T formed in registers (exp2 on the SFU, the mask tested only on
//     tiles that cross the causal diagonal, the window's edge or S),
//     packed to bf16 and fed back as the register A operand of dV += P^T
//     dO and dK += dS^T Q in a second group (m64n{DHP}k16, dO and Q the
//     MN-major B operand). A warpgroup skips the products of a step whose
//     64 x 64 pairs are all masked. The split: a block walks H / KV /
//     splits of its kv head's query heads (the query tiles of each that
//     meet the key tile: causal from its first key, window up to its last
//     key + w). The wrapper picks the split (`kernels/flash_attention.py::
//     bwd_plan`): the smallest divisor of the group that gives 1.5 blocks
//     an SM; 4 at qwen2.5-3b's (1, 4096, 16 / 2, 128), 256 blocks. With one
//     split a block writes dk and dv in bf16; with more, its float32
//     partials (2, splits, B, Sk, KV, dh), and
//  3. `bwd_sum` adds them in split order (one thread 4 columns) and writes
//     bf16: no atomics, so two runs are bit-equal. Key tiles go out in
//     order, tile 0 first: in the causal case it meets the most query
//     tiles, so the longest blocks start first.
//  4. `bwd_dq`: one block per (128-row query tile, batch, head): a producer
//     warp loads Q and dO once and rings 64-key K and V tiles (kStagesQ
//     stages); two consumer warpgroups of 64 rows run S = Q K^T and dP =
//     dO V^T from shared memory, form dS in registers and add dQ += dS K
//     (dS the register A operand, K MN-major). In the causal case the
//     longest query tiles go first.
//
// Registers. ptxas compiles a kernel at the cap its launch bounds give,
// counted in whole warpgroups: 168 a thread for any block of 257-384
// threads (the forward's layout), 255 at 256. A setmaxnreg.inc in the
// consumers' branch of a producer / consumer split did not raise the
// consumers' budget (ptxas honours one only where every warp runs it, at
// kernel entry: tools/flash_bwd_variants.py, dkdv:bounds-384*). The dK /
// dV step holds dK, dV, S^T and dP^T (64 + 64 + 32 + 32 at dh 128) and
// needs 234 registers, so its kernel is the two warpgroups and nothing
// else (at 384 threads it spilled ~700 bytes and ptxas serialized its
// wgmma, C7512); the dQ step needs 168 at dh 128 and keeps a producer
// warp (288 threads).
//
// Five points the first design (mma.sync, cp.async) lost on, and what this
// one does: (1) too few blocks: 64 dK / dV blocks at the training shape
// for 132 SMs; now a group's query heads are split over blocks, with a
// fixed-order sum; (2) uneven causal work: blocks go out longest first,
// and a split carries part of a group; (3) mma.sync: every product is
// wgmma; (4) no overlap: TMA fills the next stages while the warpgroups
// compute, and the two warpgroups run free of each other but for the
// ring; (5) 255 registers with spills: 234 and 168, none spilled.
//
// What still holds it back (PERF.md has the times): inside a warpgroup the
// exponentials and the products of a step do not overlap (no registers
// left for a second S^T); the dQ launch redoes S and dP; and at dh 64 a
// block's K / V load and epilogue are a large share of its few steps, with
// one block an SM.
//
// dh is padded in shared memory only, to DHP = the next multiple of 64
// (112 and 96 -> 128, 32 -> 64), as the forward pads it: every TMA box is
// 64 columns x 64 rows (128 bytes wide, the swizzle's width), and its
// out-of-bounds fill gives the zeros past dh and past S. The S and dP
// products run ceil(dh / 16) k-steps; dV, dK and dQ run at N = DHP (not
// the exact 96 or 112 wgmma allows: one B layout for every head dim).
//
// Layout: q, o, do (B, Sq, H, dh) and k, v (B, Sk, KV, dh) bf16. q, k, v
// and do are read by TMA through rank-4 maps over (dh, heads, S, B) with
// the tensors' own strides, encoded on the host for every call from the
// values `kernels/flash_attention.py::bwd_tensor_maps` computes; o through
// its element strides. lse (B, H, Sq) float32 contiguous. dq (B, Sq, H,
// dh), dk and dv (B, Sk, KV, dh) written contiguous, bf16.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace repro_torch::sm90;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 256;           // two warpgroups, warps 0-7
constexpr int kDkdvThreads = kConsumers;
constexpr int kDqThreads = kConsumers + 32;   // + the producer warp 8
constexpr int kBox = 64;            // rows of every TMA box
constexpr int kBK = 128;            // dK / dV: keys per block (2 x 64)
constexpr int kSQ = 64;             // dK / dV: queries per ring stage
constexpr int kStagesKV = 4;        // dK / dV: Q / dO ring depth
constexpr int kAheadKV = 2;         // dK / dV: steps loaded ahead
constexpr int kBQ = 128;            // dQ: query rows per block (2 x 64)
constexpr int kSK = 64;             // dQ: keys per ring stage
constexpr int kStagesQ = 3;         // dQ: K / V ring depth
constexpr int kRowThreads = 256;    // bwd_delta: 8 rows a block
constexpr int kSumThreads = 256;

struct BwdArgs {
  const bf16 *o, *dO;
  const float* lse;                 // (B, H, Sq)
  float* ld;                        // (B, H, sq_pad, 2): lse * log2(e), D
  float* part;                      // (2, splits, B, Sk, KV, dh) or null
  bf16 *dq, *dk, *dv;
  long long o_st[3], do_st[3];      // (b, s, h) element strides
  int B, Sq, Sk, H, KV, causal, window;
  int splits, sq_pad, n_kt, n_qt;
  float scale, scale_log2;
};

__device__ __forceinline__ bool valid(const BwdArgs& a, int qp, int kp) {
  bool ok = qp < a.Sq && kp < a.Sk;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && kp > qp - a.window;
  return ok;
}

// Which tile block `block` takes. dK / dV: key tile `block / groups` of
// group `block % groups` (groups = B * KV * splits), tile 0 first. dQ: query
// tile of (batch, head) `block % groups` (groups = B * H), counted from the
// last in the causal case: the longest tiles start first either way.
__device__ __forceinline__ void dkdv_block(unsigned block, int groups, int* g,
                                           int* kt) {
  *kt = block / groups;
  *g = block % groups;
}
__device__ __forceinline__ void dq_block(unsigned block, int groups,
                                         int n_qt, int causal, int* bh,
                                         int* qt) {
  const int rank = block / groups;
  *bh = block % groups;
  *qt = causal ? n_qt - 1 - rank : rank;
}

// ------------------------------------------------- D = do . o, and the LSE

__global__ void __launch_bounds__(kRowThreads)
    bwd_delta(const BwdArgs a, int dh) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kRowThreads / 32) +
      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.B) * a.H * a.sq_pad) return;
  const int s = row % a.sq_pad;
  const long long bh = row / a.sq_pad;
  float2 out = make_float2(INFINITY, 0.f);   // a padding row: P = 0
  if (s < a.Sq) {                            // the warp's own row: uniform
    const int h = bh % a.H, b = bh / a.H;
    const bf16* o = a.o + b * a.o_st[0] + s * a.o_st[1] + h * a.o_st[2];
    const bf16* d = a.dO + b * a.do_st[0] + s * a.do_st[1] + h * a.do_st[2];
    float acc = 0.f;
    for (int c = 2 * lane; c < dh; c += 64) {
      const float2 of = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + c));
      const float2 df = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(d + c));
      acc += of.x * df.x + of.y * df.y;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, m);
    out = make_float2(a.lse[bh * a.Sq + s] * kLog2e, acc);
  }
  if (lane == 0) reinterpret_cast<float2*>(a.ld)[row] = out;
}

// ------------------------------------------------------------- dK and dV

template <int DH>
struct KvTile {
  static constexpr int DHP = (DH + 63) / 64 * 64;   // dh padded in smem
  static constexpr int NP = DHP / 64;               // 64-column panels
  static constexpr int KSTEPS = (DH + 15) / 16;     // S, dP k-steps
  static constexpr int K_PANEL = kBK * 128;         // bytes per panel
  static constexpr int K_BYTES = NP * K_PANEL;      // the K or V tile
  static constexpr int Q_PANEL = kSQ * 128;
  static constexpr int Q_BYTES = NP * Q_PANEL;      // a Q or dO tile
  static constexpr int LD_BYTES = kSQ * 8;          // (lse, D) rows
  static constexpr int STAGE = 2 * Q_BYTES;         // Q, then dO
  static constexpr int RING_OFF = 2 * K_BYTES;      // after K and V
  static constexpr int LD_OFF = RING_OFF + kStagesKV * STAGE;
  static constexpr int BAR_OFF = LD_OFF + kStagesKV * LD_BYTES;
  // barriers after; 1 KB of slack to align the base to 1024 bytes
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * kStagesKV) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kDkdvThreads, 1)
    bwd_dkdv(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do, const BwdArgs a) {
  using T = KvTile<DH>;
  constexpr int DHP = T::DHP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sk = base, sv = base + T::K_BYTES;
  auto sq = [&](int s) {
    return base + T::RING_OFF + static_cast<uint32_t>(s) * T::STAGE;
  };
  auto sdo = [&](int s) { return sq(s) + T::Q_BYTES; };
  const uint32_t bars = base + T::BAR_OFF;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStagesKV + s); };

  int g, kt;
  dkdv_block(blockIdx.x, a.B * a.KV * a.splits, &g, &kt);
  const int split = g % a.splits, bkv = g / a.splits;
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int hps = a.H / a.KV / a.splits;          // query heads a block
  const int h0 = kvh * (a.H / a.KV) + split * hps;
  const int k0 = kt * kBK;
  // the query tiles this key tile meets, for each of the block's heads
  const int q_lo = a.causal ? k0 : 0;
  int q_hi = a.Sq;
  if (a.window > 0) q_hi = min(q_hi, k0 + kBK - 1 + a.window);
  const int qt0 = q_lo / kSQ;
  const int n_q = max((q_hi + kSQ - 1) / kSQ - qt0, 0);
  const int n_steps = hps * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStagesKV; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);     // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Step j's Q, dO and (lse, D) rows into stage j % kStagesKV, once both
  // warpgroups are done with step j - kStagesKV there. Thread 0 issues it
  // at the start of step j - kAheadKV, so warpgroup 0 runs at most
  // kStagesKV - kAheadKV steps ahead of warpgroup 1, and warpgroup 1 waits
  // only for loads warpgroup 0 has issued.
  auto issue = [&](int j) {
    const int s = j % kStagesKV;
    const uint32_t par = (j / kStagesKV) & 1;
    const int h = h0 + j / n_q, q0 = (qt0 + j % n_q) * kSQ;
    mbar_wait(empty(s), par ^ 1);       // a fresh barrier passes parity 1
    mbar_expect_tx(full(s), 2 * T::Q_BYTES + T::LD_BYTES);
#pragma unroll
    for (int p = 0; p < T::NP; ++p) {
      tma_load_4d(sq(s) + p * T::Q_PANEL, &tm_q, full(s), 64 * p, h, q0, b);
      tma_load_4d(sdo(s) + p * T::Q_PANEL, &tm_do, full(s), 64 * p, h, q0,
                  b);
    }
    bulk_load(base + T::LD_OFF + s * T::LD_BYTES,
              a.ld + ((static_cast<long long>(b) * a.H + h) * a.sq_pad + q0) *
                         2,
              T::LD_BYTES, full(s));
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * T::K_BYTES);
#pragma unroll
    for (int p = 0; p < T::NP; ++p)
#pragma unroll
      for (int r = 0; r < kBK / kBox; ++r) {
        const uint32_t off = p * T::K_PANEL + r * kBox * 128;
        tma_load_4d(sk + off, &tm_k, kv_full, 64 * p, kvh, k0 + r * kBox, b);
        tma_load_4d(sv + off, &tm_v, kv_full, 64 * p, kvh, k0 + r * kBox, b);
      }
    for (int j = 0; j < kAheadKV && j < n_steps; ++j) issue(j);
  }
  {
    const int cw = threadIdx.x / 128;            // consumer warpgroup 0 / 1
    const int lt = threadIdx.x % 128;
    const int warp = lt / 32, lane = lt % 32, t = lane & 3;
    const int kl = k0 + cw * 64;                 // this warpgroup's keys
    const int key0 = kl + warp * 16 + (lane >> 2), key1 = key0 + 8;
    const uint32_t ka = sk + cw * 64 * 128, va = sv + cw * 64 * 128;
    const float sl2 = a.scale_log2;

    float dk[DHP / 2], dv[DHP / 2];
#pragma unroll
    for (int e = 0; e < DHP / 2; ++e) dk[e] = dv[e] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_steps; ++i) {
      if (threadIdx.x == 0 && i + kAheadKV < n_steps) issue(i + kAheadKV);
      const int s = i % kStagesKV;
      const uint32_t par = (i / kStagesKV) & 1;
      const int q0 = (qt0 + i % n_q) * kSQ;
      mbar_wait(full(s), par);
      // every (query, key) pair of the step masked for these 64 keys
      const bool skip = kl >= a.Sk || (a.causal && q0 + kSQ - 1 < kl) ||
                        (a.window > 0 && q0 >= kl + 63 + a.window);
      if (!skip) {
        // S^T = K Q^T and dP^T = V dO^T in one group
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::KSTEPS; ++kk) {
          const uint32_t off = (kk / 4) * T::K_PANEL + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * T::Q_PANEL + (kk % 4) * 32;
          wgmma_ss_n64(sc, sw128_desc(ka + off, 16, 1024),
                       sw128_desc(sq(s) + qoff, 16, 1024), kk > 0);
          wgmma_ss_n64(dp, sw128_desc(va + off, 16, 1024),
                       sw128_desc(sdo(s) + qoff, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);
        // P^T in place of S^T: element e is key (e & 2 ? key1 : key0),
        // query q0 + 8 (e / 4) + 2 t + (e & 1); its (lse, D) pairs sit
        // two queries to a float4
        const bool edge = kl + 64 > a.Sk || q0 + kSQ > a.Sq ||
                          (a.causal && q0 < kl + 63) ||
                          (a.window > 0 && q0 + kSQ - 1 >= kl + a.window);
        const float4* ld = reinterpret_cast<const float4*>(
            gbase + T::LD_OFF + s * T::LD_BYTES);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const float4 x = ld[4 * (e / 4) + t];
          float p = fast_exp2(fmaf(sc[e], sl2, (e & 1) ? -x.z : -x.x));
          if (edge && !valid(a, q0 + 8 * (e / 4) + 2 * t + (e & 1),
                             (e & 2) ? key1 : key0))
            p = 0.f;
          sc[e] = p;
        }
        uint32_t pa[4][4];
        pack_a<64>(sc, pa);
        // dS^T = P^T (dP^T - D) in place of dP^T; then dV += P^T dO and
        // dK += dS^T Q in one group
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const float4 x = ld[4 * (e / 4) + t];
          dp[e] = sc[e] * (dp[e] - ((e & 1) ? x.w : x.y));
        }
        uint32_t da[4][4];
        pack_a<64>(dp, da);
        fence_regs(dk);
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kSQ / 16; ++j) {
          wgmma_rs<DHP>(dv, pa[j],
                        sw128_desc(sdo(s) + j * 16 * 128, T::Q_PANEL, 1024));
          wgmma_rs<DHP>(dk, da[j],
                        sw128_desc(sq(s) + j * 16 * 128, T::Q_PANEL, 1024));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dk);
        fence_regs(dv);
      }
      mbar_arrive(empty(s));
    }

    // rows key0 and key1, columns 8 j + 2 t (+1) below dh: contiguous
    // (B, Sk, KV, DH) bf16 (dk scaled), or this split's float32 partials
    const long long r0 = ((static_cast<long long>(b) * a.Sk + key0) * a.KV +
                          kvh) * DH;
    const long long r1 = r0 + 8LL * a.KV * DH;
    if (a.part == nullptr) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (key0 < a.Sk) {
          *reinterpret_cast<uint32_t*>(a.dk + r0 + c) =
              pack_bf16(dk[4 * j] * a.scale, dk[4 * j + 1] * a.scale);
          *reinterpret_cast<uint32_t*>(a.dv + r0 + c) =
              pack_bf16(dv[4 * j], dv[4 * j + 1]);
        }
        if (key1 < a.Sk) {
          *reinterpret_cast<uint32_t*>(a.dk + r1 + c) =
              pack_bf16(dk[4 * j + 2] * a.scale, dk[4 * j + 3] * a.scale);
          *reinterpret_cast<uint32_t*>(a.dv + r1 + c) =
              pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
        }
      }
    } else {
      const long long n = static_cast<long long>(a.B) * a.Sk * a.KV * DH;
      float* pk = a.part + split * n;
      float* pv = a.part + (a.splits + split) * n;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (key0 < a.Sk) {
          *reinterpret_cast<float2*>(pk + r0 + c) =
              make_float2(dk[4 * j], dk[4 * j + 1]);
          *reinterpret_cast<float2*>(pv + r0 + c) =
              make_float2(dv[4 * j], dv[4 * j + 1]);
        }
        if (key1 < a.Sk) {
          *reinterpret_cast<float2*>(pk + r1 + c) =
              make_float2(dk[4 * j + 2], dk[4 * j + 3]);
          *reinterpret_cast<float2*>(pv + r1 + c) =
              make_float2(dv[4 * j + 2], dv[4 * j + 3]);
        }
      }
    }
  }
}

// The splits' partials summed in split order, dk scaled, written bf16: n4
// groups of 4 columns of one (B, Sk, KV, dh) tensor.
__global__ void __launch_bounds__(kSumThreads)
    bwd_sum(const BwdArgs a, long long n4) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= n4) return;
#pragma unroll
  for (int w = 0; w < 2; ++w) {       // dk, then dv
    const float4* p =
        reinterpret_cast<const float4*>(a.part) + w * a.splits * n4 + i;
    float4 acc = p[0];
    for (int s = 1; s < a.splits; ++s) {
      const float4 x = p[s * n4];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float f = w == 0 ? a.scale : 1.f;
    reinterpret_cast<uint2*>(w == 0 ? a.dk : a.dv)[i] =
        make_uint2(pack_bf16(acc.x * f, acc.y * f),
                   pack_bf16(acc.z * f, acc.w * f));
  }
}

// -------------------------------------------------------------------- dQ

template <int DH>
struct QTile {
  static constexpr int DHP = (DH + 63) / 64 * 64;
  static constexpr int NP = DHP / 64;
  static constexpr int KSTEPS = (DH + 15) / 16;
  static constexpr int Q_PANEL = kBQ * 128;
  static constexpr int Q_BYTES = NP * Q_PANEL;      // the Q or dO tile
  static constexpr int K_PANEL = kSK * 128;
  static constexpr int K_BYTES = NP * K_PANEL;      // a K or V tile
  static constexpr int STAGE = 2 * K_BYTES;         // K, then V
  static constexpr int RING_OFF = 2 * Q_BYTES;      // after Q and dO
  static constexpr int BAR_OFF = RING_OFF + kStagesQ * STAGE;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * kStagesQ) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kDqThreads, 1)
    bwd_dq(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __grid_constant__ CUtensorMap tm_do, const BwdArgs a) {
  using T = QTile<DH>;
  constexpr int DHP = T::DHP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sqt = base, sdot = base + T::Q_BYTES;
  auto sk = [&](int s) {
    return base + T::RING_OFF + static_cast<uint32_t>(s) * T::STAGE;
  };
  auto sv = [&](int s) { return sk(s) + T::K_BYTES; };
  const uint32_t bars = base + T::BAR_OFF;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStagesQ + s); };

  int bh, qt;
  dq_block(blockIdx.x, a.B * a.H, a.n_qt, a.causal, &bh, &qt);
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * kBQ;
  // the forward's key-tile range for this query tile
  int kt1 = (a.Sk + kSK - 1) / kSK;
  if (a.causal) kt1 = min(kt1, (q0 + kBQ - 1) / kSK + 1);
  int kt0 = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) kt0 = (q0 - a.window + 1) / kSK;
  const int n_tiles = max(kt1 - kt0, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStagesQ; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------- producer
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, 2 * T::Q_BYTES);
#pragma unroll
      for (int p = 0; p < T::NP; ++p)
#pragma unroll
        for (int r = 0; r < kBQ / kBox; ++r) {
          const uint32_t off = p * T::Q_PANEL + r * kBox * 128;
          tma_load_4d(sqt + off, &tm_q, q_full, 64 * p, h, q0 + r * kBox, b);
          tma_load_4d(sdot + off, &tm_do, q_full, 64 * p, h, q0 + r * kBox,
                      b);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStagesQ;
        const uint32_t par = (i / kStagesQ) & 1;
        const int kb = (kt0 + i) * kSK;
        mbar_wait(empty(s), par ^ 1);
        mbar_expect_tx(full(s), 2 * T::K_BYTES);
#pragma unroll
        for (int p = 0; p < T::NP; ++p) {
          tma_load_4d(sk(s) + p * T::K_PANEL, &tm_k, full(s), 64 * p, kvh, kb,
                      b);
          tma_load_4d(sv(s) + p * T::K_PANEL, &tm_v, full(s), 64 * p, kvh, kb,
                      b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    const int cw = threadIdx.x / 128;
    const int lt = threadIdx.x % 128;
    const int warp = lt / 32, lane = lt % 32, t = lane & 3;
    const int r_lo = q0 + cw * 64;                 // this warpgroup's rows
    const int row0 = r_lo + warp * 16 + (lane >> 2), row1 = row0 + 8;
    const float2* ldr = reinterpret_cast<const float2*>(a.ld) +
                        (static_cast<long long>(b) * a.H + h) * a.sq_pad;
    const float2 x0 = row0 < a.Sq ? ldr[row0] : make_float2(INFINITY, 0.f);
    const float2 x1 = row1 < a.Sq ? ldr[row1] : make_float2(INFINITY, 0.f);
    const uint32_t qa = sqt + cw * 64 * 128, oa = sdot + cw * 64 * 128;
    const float sl2 = a.scale_log2;

    float dq[DHP / 2];
#pragma unroll
    for (int e = 0; e < DHP / 2; ++e) dq[e] = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStagesQ;
      const uint32_t par = (i / kStagesQ) & 1;
      const int kb = (kt0 + i) * kSK;
      mbar_wait(full(s), par);
      const bool skip = r_lo >= a.Sq || (a.causal && kb > r_lo + 63) ||
                        (a.window > 0 && kb + kSK - 1 <= r_lo - a.window);
      if (!skip) {
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::KSTEPS; ++kk) {
          const uint32_t qoff = (kk / 4) * T::Q_PANEL + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * T::K_PANEL + (kk % 4) * 32;
          wgmma_ss_n64(sc, sw128_desc(qa + qoff, 16, 1024),
                       sw128_desc(sk(s) + koff, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < T::KSTEPS; ++kk) {
          const uint32_t qoff = (kk / 4) * T::Q_PANEL + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * T::K_PANEL + (kk % 4) * 32;
          wgmma_ss_n64(dp, sw128_desc(oa + qoff, 16, 1024),
                       sw128_desc(sv(s) + koff, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);
        // dS in place of dP: element e is row (e & 2 ? row1 : row0), key
        // kb + 8 (e / 4) + 2 t + (e & 1)
        const bool edge = kb + kSK > a.Sk || r_lo + 64 > a.Sq ||
                          (a.causal && kb + kSK - 1 > r_lo) ||
                          (a.window > 0 && kb <= r_lo + 63 - a.window);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const float2 x = (e & 2) ? x1 : x0;
          float p = fast_exp2(fmaf(sc[e], sl2, -x.x));
          if (edge && !valid(a, (e & 2) ? row1 : row0,
                             kb + 8 * (e / 4) + 2 * t + (e & 1)))
            p = 0.f;
          dp[e] = p * (dp[e] - x.y);
        }
        uint32_t da[4][4];
        pack_a<64>(dp, da);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kSK / 16; ++j)
          wgmma_rs<DHP>(dq, da[j],
                        sw128_desc(sk(s) + j * 16 * 128, T::K_PANEL, 1024));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dq);
      }
      mbar_arrive(empty(s));
    }

    const long long r0 = ((static_cast<long long>(b) * a.Sq + row0) * a.H +
                          h) * DH;
    const long long r1 = r0 + 8LL * a.H * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (row0 < a.Sq)
        *reinterpret_cast<uint32_t*>(a.dq + r0 + c) =
            pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
      if (row1 < a.Sq)
        *reinterpret_cast<uint32_t*>(a.dq + r1 + c) =
            pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
    }
  }
}

// ------------------------------------------------------------------- host

template <int DH>
cudaError_t launch(const CUtensorMap* tm, const BwdArgs& a, cudaStream_t s) {
  using KT = KvTile<DH>;
  using QT = QTile<DH>;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dkdv<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, KT::SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dq<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           QT::SMEM);
  if (e != cudaSuccess) return e;
  const long long dkdv_blocks =
      static_cast<long long>(a.n_kt) * a.B * a.KV * a.splits;
  const long long dq_blocks = static_cast<long long>(a.n_qt) * a.B * a.H;
  const long long n4 = static_cast<long long>(a.B) * a.Sk * a.KV * DH / 4;
  const long long sum_blocks = (n4 + kSumThreads - 1) / kSumThreads;
  if (dkdv_blocks > 0x7fffffffLL || dq_blocks > 0x7fffffffLL ||
      sum_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  bwd_dkdv<DH><<<static_cast<int>(dkdv_blocks), kDkdvThreads, KT::SMEM, s>>>(
      tm[0], tm[1], tm[2], tm[3], a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.part != nullptr) {
    bwd_sum<<<static_cast<int>(sum_blocks), kSumThreads, 0, s>>>(a, n4);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  bwd_dq<DH><<<static_cast<int>(dq_blocks), kDqThreads, QT::SMEM, s>>>(
      tm[0], tm[1], tm[2], tm[3], a);
  return cudaGetLastError();
}

}  // namespace

// Error codes besides cudaError_t values: the driver has no tensor-map
// encoder; or encoding map q, k, v or do failed.
enum { kErrNoEncoder = -1, kErrEncodeQ = -2 };

// q, k, v, o, do bfloat16 as described at the top; `strides` their (b, s,
// h) element strides (15 values, q k v o do in turn; o's are read);
// `maps` 11 values for each of q, k, v and do in turn, as the forward's
// (dims (dh, heads, S, B), strides of heads, S and B in bytes, the box
// (64, 1, 64, 1)); lse float32 (B, H, Sq) contiguous; `scratch` float32:
// B * H * Sq_pad * 2 values, then, when splits > 1, 2 * splits * B * Sk *
// KV * dh more (Sq_pad = Sq rounded up to 64); `splits` divides H / KV.
// Writes dq (B, Sq, H, dh), dk and dv (B, Sk, KV, dh) contiguous bf16.
// Three or four launches on `stream`; returns 0, the first cudaError_t, or
// one of the codes above.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dO, void* dq, void* dk, void* dv,
    void* scratch, int B, int Sq, int Sk, int H, int KV, int dh,
    const long long* strides, const unsigned long long* maps, int splits,
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      splits <= 0 || (H / KV) % splits != 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i) {
    const unsigned long long* m = maps + 11 * i;
    if (m[0] != (unsigned long long)dh || m[7] != 64 || m[8] != 1 ||
        m[9] != (unsigned long long)kBox || m[10] != 1)
      return (int)cudaErrorInvalidValue;
  }
  bind_context();
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrNoEncoder;
  CUtensorMap tm[4];
  const void* ptrs[4] = {q, k, v, dO};
  for (int i = 0; i < 4; ++i)
    if (!encode_map(enc, &tm[i], ptrs[i], maps + 11 * i))
      return kErrEncodeQ - i;
  BwdArgs a{};
  a.o = static_cast<const bf16*>(o);
  a.dO = static_cast<const bf16*>(dO);
  a.lse = static_cast<const float*>(lse);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.causal = causal;
  a.window = window;
  a.splits = splits;
  a.sq_pad = (Sq + kSQ - 1) / kSQ * kSQ;
  a.n_kt = (Sk + kBK - 1) / kBK;
  a.n_qt = (Sq + kBQ - 1) / kBQ;
  a.ld = static_cast<float*>(scratch);
  a.part = splits > 1
               ? a.ld + static_cast<long long>(B) * H * a.sq_pad * 2
               : nullptr;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  for (int j = 0; j < 3; ++j) {
    a.o_st[j] = strides[9 + j];
    a.do_st[j] = strides[12 + j];
  }
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * H * a.sq_pad;
  const long long blocks = (rows + kRowThreads / 32 - 1) / (kRowThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_delta<<<static_cast<int>(blocks), kRowThreads, 0, s>>>(a, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (dh) {
    case 32: return (int)launch<32>(tm, a, s);
    case 64: return (int)launch<64>(tm, a, s);
    case 96: return (int)launch<96>(tm, a, s);
    case 112: return (int)launch<112>(tm, a, s);
    case 128: return (int)launch<128>(tm, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The built tiles: keys per dK / dV block, queries per step of its ring and
// the ring's depth; query rows per dQ block, keys per step of its ring and
// the ring's depth; rows of a TMA box.
extern "C" void flash_attention_bwd_tiles(int* out) {
  out[0] = kBK;
  out[1] = kSQ;
  out[2] = kStagesKV;
  out[3] = kBQ;
  out[4] = kSK;
  out[5] = kStagesQ;
  out[6] = kBox;
}
