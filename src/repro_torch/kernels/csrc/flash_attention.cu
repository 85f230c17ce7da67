// Causal flash attention forward for Hopper (sm_90a): TMA loads into an
// mbarrier-guarded ring, wgmma for both products, one producer warpgroup
// and two consumer warpgroups. Online softmax in float32, GQA, optional
// sliding window, padded-key masking.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (`_kernel` :28, pallas_call at :105). Same
// function: for query row i and key j (0-based positions),
//   s_ij = (q_i . k_j) * scale, masked to NEG_INF = -1e30 unless j < Sk,
//   (causal) j <= i and (window) j > i - window;
//   out_i = sum_j softmax_j(s_ij) v_j / max(l_i, 1e-30), in float32;
// query head h reads kv head h / (H / KV) (no repeated K/V in memory). The
// mask constant is finite on purpose, as in the reference: a row whose first
// visited tile is fully masked gathers exp(0) terms, and the correction
// exp(-1e30 - m) = 0 at its first real key wipes them; -inf would give NaN.
// Whole tiles above the causal diagonal or left of the window are skipped.
//
// Layout: q (B, Sq, H, dh), k/v (B, Sk, KV, dh), out (B, Sq, H, dh). q, k
// and v are read in place by TMA through rank-4 tensor maps over
// (dh, heads, S, B) with the tensors' own strides in bytes, so the model's
// views (k and v split out of one qkv projection) need no copy. The maps are
// encoded on the host for every call from the dims, strides and boxes that
// the Python wrapper computes (`kernels/flash_attention.py::tensor_maps`).
//
// Bound on the card: operations. At the serving shapes (S = 8192, dh = 112,
// window 4096) a query row attends up to 4096 keys at 4*dh FLOP each;
// reading q, k, v and writing out once is ~60x less time than the bf16
// tensor-core work, so the design is about keeping the tensor cores fed:
//
//  * Warpgroup 0 is the producer: after `setmaxnreg.dec` one thread issues
//    TMA loads of the block's Q tile once and of each K and V tile into a
//    ring of kStages stages. Each stage has "full" mbarriers for K and for V
//    (expect_tx; Q K^T starts before V lands) and "empty" mbarriers for K
//    and for V that the consumers arrive on, K as soon as Q K^T is done.
//  * Warpgroups 1 and 2 are consumers (`setmaxnreg.inc`), 64 query rows
//    each of the block's 128. S = Q K^T is `wgmma.mma_async m64n128k16`
//    with Q and K from shared memory (K-major, 128-byte swizzle). P stays in
//    registers: the f32 S accumulator packed to bf16 pairs is the register
//    A fragment of `wgmma m64n{DHP}k16` for O += P V, whose B operand is V
//    in shared memory in its MN-major form (trans-b). The two consumers run
//    free of each other, so one's softmax can overlap the other's wgmma.
//  * Softmax in the log2 domain: one multiply by scale*log2(e) folded into
//    the exponent, exp2 on the special-function unit. The mask is tested
//    only on tiles that cross the causal diagonal, the window's left edge or
//    Sk; interior tiles take no per-element test.
//  * dh is padded in shared memory only, to DHP = the next multiple of 64
//    (112 and 96 -> 128, 32 -> 64): the TMA box is 64 columns (128 bytes,
//    the swizzle's width) and its out-of-bounds fill supplies the zeros past
//    dh. Q K^T runs ceil(dh / 16) k-steps, so only P V pays for the padding
//    (N = DHP): 1/14 more tensor work in all at dh = 112.
//  * Blocks are one flat index over (batch, head, q tile), so B*H has no
//    grid limit, and the blocks in flight together share one head's K and V
//    in L2; in the causal case each head's longest q tiles go first.
//
// What still bounds it (PERF.md has the numbers): the exp2 work (one MUFU
// op per score) and the two products do not overlap; the kernel runs at
// about half its bound. Overlapping tile i's softmax with tile i+1's Q K^T
// inside a warpgroup keeps S, P and O live beside the in-flight wgmma, and
// ptxas then serialises the wgmma (C7512, "insufficient register
// resources") at BK = 128: ptxas's budget for the consumers is the 168
// registers a thread the 384-thread launch bounds give, since a
// setmaxnreg.inc in the consumers' branch does not raise it (measured for
// the backward, csrc/flash_attention_bwd.cu). That overlap at BK = 96 or 64, ping-pong
// turns on named barriers, 3 stages and a 288-thread layout measured no
// faster. So:
// BK = 128, 2 stages, one wgmma group at a time per consumer, O rescaled
// only when a row max moved. Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB of
// shared memory at DHP = 128, 168 registers a thread, no spills.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace repro_torch::sm90;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;            // query rows per block (2 x 64)
constexpr int kBK = 128;            // keys per tile
constexpr int kStages = 2;          // K/V ring depth
constexpr int kThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

struct FwdArgs {
  void* o;
  float* lse;                       // (B, H, Sq) or null (serving)
  long long o_sb, o_ss, o_sh;
  int B, Sq, Sk, H, KV;
  int causal, window;
  int n_qtiles;
  float scale_log2;                 // scale * log2(e)
};

// Key-tile range [begin, end) a q tile [q0, q0 + bq) must visit.
__device__ __forceinline__ void tile_range(const FwdArgs& a, int q0, int bq,
                                           int bk, int* begin, int* end) {
  int e = (a.Sk + bk - 1) / bk;
  if (a.causal) e = min(e, (q0 + bq - 1) / bk + 1);
  int b = 0;
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;   // first key the tile's first row sees
    if (lo > 0) b = lo / bk;
  }
  *begin = b;
  *end = e;
}

// ----------------------------------------------------------------- kernel

template <int DH>
struct Tile {
  static constexpr int DHP = (DH + 63) / 64 * 64;   // dh padded in smem
  static constexpr int NP = DHP / 64;               // 64-column panels
  static constexpr int KSTEPS = (DH + 15) / 16;     // Q K^T k-steps
  static constexpr int Q_PANEL = kBQ * 128;         // bytes per panel
  static constexpr int KV_PANEL = kBK * 128;
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int KV_BYTES = NP * KV_PANEL;    // one K or V tile
  // Q, then K and V per stage; barriers after; 1 KB of slack to align the
  // base to the swizzle's 1024-byte pattern.
  static constexpr int BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * kStages) + 1024;
};

// Online softmax of one S tile in the log2 domain. Element e of sc is row
// (e & 2 ? row1 : row0), key k0 + 8 (e / 4) + 2 t + (e & 1). The mask is
// applied only when `edge`. Leaves the unnormalised P in sc, updates the row
// maxima and this thread's share of the row sums, and returns in c0, c1 the
// corrections O must take before P V is added.
struct Rows {
  int row0, row1, t;
  float m0, m1, l0, l1;
};

__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2], Rows& r,
                                             const FwdArgs& a, int k0,
                                             bool edge, float sl2, float& c0,
                                             float& c1) {
  if (edge) {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      const int kp = k0 + 8 * (e / 4) + 2 * r.t + (e & 1);
      const int qp = (e & 2) ? r.row1 : r.row0;
      bool ok = kp < a.Sk;
      if (a.causal) ok = ok && kp <= qp;
      if (a.window > 0) ok = ok && kp > qp - a.window;
      if (!ok) sc[e] = kNegInf;
    }
  }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int e = 0; e < kBK / 2; e += 4) {
    mx0 = fmaxf(mx0, fmaxf(sc[e], sc[e + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[e + 2], sc[e + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  if (edge) {
    // (s - m) first: a row masked so far has s = m = -1e30 and must gather
    // exp(0) = 1 terms, as the reference does.
    c0 = fast_exp2((r.m0 - mx0) * sl2);
    c1 = fast_exp2((r.m1 - mx1) * sl2);
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e)
      sc[e] = fast_exp2((sc[e] - ((e & 2) ? mx1 : mx0)) * sl2);
  } else {
    // every key valid for every row: the row max is a real logit, so one
    // fused multiply-add per element
    const float b0 = mx0 * sl2, b1 = mx1 * sl2;
    c0 = fast_exp2(fmaf(r.m0, sl2, -b0));
    c1 = fast_exp2(fmaf(r.m1, sl2, -b1));
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e)
      sc[e] = fast_exp2(fmaf(sc[e], sl2, (e & 2) ? -b1 : -b0));
  }
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int e = 0; e < kBK / 2; e += 4) {
    ls0 += sc[e] + sc[e + 1];
    ls1 += sc[e + 2] + sc[e + 3];
  }
  r.l0 = r.l0 * c0 + ls0;
  r.l1 = r.l1 * c1 + ls1;
  r.m0 = mx0;
  r.m1 = mx1;
}

// One block per (batch, head, q tile): flat index (b*H + h) * n_qtiles +
// rank, so the blocks in flight together share their head's K and V in L2;
// within a head the q tile is counted from the last in the causal case, so
// the longest tiles start first. `flash_attention_block_tile` below calls
// the same function on the host, for the tests.
__host__ __device__ __forceinline__ void block_tile(unsigned block,
                                                    int n_qtiles, int H,
                                                    int causal, int* b,
                                                    int* h, int* qt) {
  const int bh = block / n_qtiles, rank = block % n_qtiles;
  *qt = causal ? n_qtiles - 1 - rank : rank;
  *b = bh / H;
  *h = bh % H;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const FwdArgs a) {
  using T = Tile<DH>;
  constexpr int DHP = T::DHP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;   // Q panels
  const uint32_t bars = sq + T::BAR_OFF;
  const uint32_t q_full = bars;
  // per stage: K and V landed (TMA bytes), K and V free again (consumers)
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };
  auto k_tile = [&](int s) {
    return sq + T::Q_BYTES + static_cast<uint32_t>(s) * 2 * T::KV_BYTES;
  };

  int b, h, qt;
  block_tile(blockIdx.x, a.n_qtiles, a.H, a.causal, &b, &h, &qt);
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * kBQ;
  int kt0, kt1;
  tile_range(a, q0, kBQ, kBK, &kt0, &kt1);
  const int n_tiles = max(kt1 - kt0, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 2 * 128);     // every consumer thread arrives
      mbar_init(empty_v(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int p = 0; p < T::NP; ++p)
        tma_load_4d(sq + p * T::Q_PANEL, &tm_q, q_full, 64 * p, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t par = (i / kStages) & 1;
        const int k0 = (kt0 + i) * kBK;
        const uint32_t ks = k_tile(s), vs = ks + T::KV_BYTES;
        mbar_wait(empty_k(s), par ^ 1);   // a fresh barrier passes parity 1
        mbar_expect_tx(full_k(s), T::KV_BYTES);
#pragma unroll
        for (int p = 0; p < T::NP; ++p)
          tma_load_4d(ks + p * T::KV_PANEL, &tm_k, full_k(s), 64 * p, kvh,
                      k0, b);
        mbar_wait(empty_v(s), par ^ 1);
        mbar_expect_tx(full_v(s), T::KV_BYTES);
#pragma unroll
        for (int p = 0; p < T::NP; ++p)
          tma_load_4d(vs + p * T::KV_PANEL, &tm_v, full_v(s), 64 * p, kvh,
                      k0, b);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = (threadIdx.x - 128) / 128;   // consumer warpgroup 0 / 1
    const int lt = threadIdx.x % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int r_lo = q0 + cw * 64;               // this warpgroup's rows
    const int r_hi = min(r_lo + 63, a.Sq - 1);
    Rows r;
    r.row0 = r_lo + warp * 16 + (lane >> 2);
    r.row1 = r.row0 + 8;
    r.t = lane & 3;
    r.m0 = r.m1 = kNegInf;
    r.l0 = r.l1 = 0.f;
    const float sl2 = a.scale_log2;
    const uint32_t qa = sq + cw * 64 * 128;      // its 64 rows of Q

    // Does key tile k0 need the mask for this warpgroup's rows?
    auto edge_tile = [&](int k0) {
      return k0 + kBK > a.Sk || (a.causal && k0 + kBK - 1 > r_lo) ||
             (a.window > 0 && k0 <= r_hi - a.window);
    };
    // S = Q K^T of stage s, issued asynchronously
    auto issue_qk = [&](float (&sc)[kBK / 2], int s) {
      const uint32_t ks = k_tile(s);
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk) {
        const uint32_t off = (kk % 4) * 32;      // 16 columns = 32 bytes
        wgmma_ss_n128(sc,
                      sw128_desc(qa + (kk / 4) * T::Q_PANEL + off, 16, 1024),
                      sw128_desc(ks + (kk / 4) * T::KV_PANEL + off, 16, 1024),
                      kk > 0);
      }
    };
    // O += P V of stage s, V as the MN-major B operand
    auto issue_pv = [&](float (&o)[DHP / 2], uint32_t (&pa)[kBK / 16][4],
                        int s) {
      const uint32_t vs = k_tile(s) + T::KV_BYTES;
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        wgmma_rs<DHP>(o, pa[j],
                      sw128_desc(vs + j * 16 * 128, T::KV_PANEL, 1024));
    };

    float o[DHP / 2];
#pragma unroll
    for (int e = 0; e < DHP / 2; ++e) o[e] = 0.f;
    float sc[kBK / 2];
    uint32_t pa[kBK / 16][4];
    float c0, c1;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t par = (i / kStages) & 1;
      const int k0 = (kt0 + i) * kBK;
      mbar_wait(full_k(s), par);
      wgmma_fence();
      issue_qk(sc, s);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      mbar_arrive(empty_k(s));            // K may be refilled already
      softmax_tile(sc, r, a, k0, edge_tile(k0), sl2, c0, c1);
      pack_a<kBK>(sc, pa);      // P as bf16 A fragments, 16 keys each
      if (c0 != 1.f || c1 != 1.f) {       // a row max moved: rescale O
#pragma unroll
        for (int e = 0; e < DHP / 2; ++e) o[e] *= (e & 2) ? c1 : c0;
      }
      mbar_wait(full_v(s), par);
      fence_regs(o);
      wgmma_fence();
      issue_pv(o, pa, s);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      mbar_arrive(empty_v(s));
    }

    float l0 = r.l0, l1 = r.l1;
    const int row0 = r.row0, row1 = r.row1, t = r.t;

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (a.lse != nullptr && t == 0) {
      // natural log-sum-exp of the row's scaled scores: m * scale + ln(l)
      float* L = a.lse + (static_cast<long long>(b) * a.H + h) * a.Sq;
      if (row0 < a.Sq)
        L[row0] = (r.m0 * sl2 + log2f(fmaxf(l0, 1e-30f))) * (1.f / kLog2e);
      if (row1 < a.Sq)
        L[row1] = (r.m1 * sl2 + log2f(fmaxf(l1, 1e-30f))) * (1.f / kLog2e);
    }
    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                       h * a.o_sh;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {    // columns past dh are padding
      const int c = 8 * j + 2 * t;
      if (row0 < a.Sq)
        *reinterpret_cast<uint32_t*>(O + row0 * a.o_ss + c) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row1 < a.Sq)
        *reinterpret_cast<uint32_t*>(O + row1 * a.o_ss + c) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// ------------------------------------------------------------------- host

template <int DH>
cudaError_t launch(const CUtensorMap* maps, const FwdArgs& a, int blocks,
                   cudaStream_t s) {
  using T = Tile<DH>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  flash_fwd_sm90<DH><<<blocks, kThreads, T::SMEM, s>>>(maps[0], maps[1],
                                                        maps[2], a);
  return cudaGetLastError();
}

}  // namespace

// Error codes besides cudaError_t values: the driver has no tensor-map
// encoder; or encoding map q, k or v failed.
enum { kErrNoEncoder = -1, kErrEncodeQ = -2, kErrEncodeK = -3,
       kErrEncodeV = -4 };

// q, k, v, out bfloat16 as described above. `maps` holds 11 values for each
// of q, k and v in turn: dims (dh, heads, S, B) in elements, strides of
// heads, S and B in bytes, and the box (64, 1, rows, 1). out is written
// through element strides. `lse`, if not null, receives each row's
// log-sum-exp, (B, H, Sq) float32 (what the backward recomputes P from);
// the output is the same either way. Returns 0 on a clean launch, a
// cudaError_t, or one of the codes above.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const unsigned long long* maps, int B, int Sq, int Sk, int H, int KV,
    int dh, long long o_sb, long long o_ss, long long o_sh, int causal,
    int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const int rows[3] = {kBQ, kBK, kBK};
  for (int i = 0; i < 3; ++i) {
    const unsigned long long* m = maps + 11 * i;
    if (m[0] != (unsigned long long)dh || m[7] != 64 || m[8] != 1 ||
        m[9] != (unsigned long long)rows[i] || m[10] != 1)
      return (int)cudaErrorInvalidValue;
  }
  const long long n_qtiles = (Sq + kBQ - 1) / kBQ;
  const long long blocks = n_qtiles * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bind_context();
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrNoEncoder;
  CUtensorMap tm[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!encode_map(enc, &tm[i], ptrs[i], maps + 11 * i))
      return kErrEncodeQ - i;
  FwdArgs a{o,      static_cast<float*>(lse), o_sb,   o_ss,
            o_sh,   B,  Sq, Sk, H, KV, causal, window, (int)n_qtiles,
            scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return (int)launch<32>(tm, a, (int)blocks, s);
    case 64: return (int)launch<64>(tm, a, (int)blocks, s);
    case 96: return (int)launch<96>(tm, a, (int)blocks, s);
    case 112: return (int)launch<112>(tm, a, (int)blocks, s);
    case 128: return (int)launch<128>(tm, a, (int)blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The kernel's tiles as compiled: query rows per block, keys per tile and
// depth of the K/V ring.
extern "C" void flash_attention_tiles(int* out) {
  out[0] = kBQ;
  out[1] = kBK;
  out[2] = kStages;
}

// (batch, head, q tile) that block `block` of a launch with these
// parameters computes, as the kernel decodes it.
extern "C" void flash_attention_block_tile(unsigned block, int n_qtiles,
                                           int H, int causal, int* out) {
  block_tile(block, n_qtiles, H, causal, out, out + 1, out + 2);
}
