// Causal flash attention forward: online softmax in float32, GQA, optional
// sliding window, padded-key masking.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (`_kernel` :28, pallas_call at :105). Same
// function: for query row i and key j (0-based positions),
//   s_ij = (q_i . k_j) * scale, masked to NEG_INF = -1e30 unless j < Sk,
//   (causal) j <= i and (window) j > i - window;
//   out_i = sum_j softmax_j(s_ij) v_j, accumulated in float32;
// query head h reads kv head h / (H / KV) (no repeated K/V in memory). The
// mask constant is finite on purpose, as in the reference: a row whose first
// processed tile is fully masked gathers exp(0) terms, and the correction
// exp(-1e30 - m) = 0 at its first real key wipes them; -inf would give NaN.
// Whole tiles above the causal diagonal or left of the window are skipped.
//
// Layout: q (B, Sq, H, dh), k/v (B, Sk, KV, dh), out (B, Sq, H, dh), each
// with element strides for batch, sequence and head and a unit stride on
// dh; so the model's views (k and v split out of one qkv projection) are
// read in place, with no fold to (B*H, S, dh) and no padding in memory.
//
// Bound on the card: operations. At the serving shapes (S = 8192, dh = 112,
// window 4096) each query row attends up to 4096 keys at 4*dh FLOP each,
// ~60 FLOP per byte of q/k/v/out even if K/V were read once per q tile:
// above the H100's ~300 FLOP/byte line only because tiles re-read K/V from
// L2, so the tensor cores, not HBM, set the bound.
//
// One kernel, bfloat16 in and out (the serving path; the engine serves in
// bfloat16): one block of 4 warps per (batch*head, 64-row q tile). Each warp
// owns 16 query rows, keeps its Q fragments in registers, and runs mma.sync
// m16n8k16 (bf16 in, f32 accumulate) for S = Q K^T and O += P V over 64-key
// tiles staged in shared memory (rows padded by 8 elements so the fragment
// loads are free of bank conflicts). The S accumulator's register layout is
// the A-operand layout of the P V product, so P never leaves registers. Row
// max and row sum are reduced over the 4 threads that share a row with two
// shuffles. dh must be a multiple of 16 (32, 64, 96, 112, 128 are
// instantiated; no padding of dh = 112 to 128 as the TPU needs).
// Not yet here: TMA, wgmma, warp specialisation, pipelined tile loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float scale;
};

// Key-tile range [begin, end) a q tile [q0, q0 + bq) must visit.
__device__ __forceinline__ void tile_range(const AttnArgs& a, int q0, int bq,
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

__device__ __forceinline__ bool key_ok(const AttnArgs& a, int qp, int kp) {
  bool ok = kp < a.Sk;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && kp > qp - a.window;
  return ok;
}

// ------------------------------------------------------------- bf16 / mma

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kBQ = 64;       // query rows per block (4 warps x 16)
constexpr int kBK = 64;       // keys per tile

template <int DH>
__global__ __launch_bounds__(128) void flash_fwd_bf16(AttnArgs a) {
  constexpr int KPAD = DH + 8;      // smem row stride (elements)
  constexpr int KS = DH / 16;       // k-steps over dh for S = Q K^T
  constexpr int NT = kBK / 8;       // n-tiles of S per warp
  constexpr int DT = DH / 8;        // n-tiles of O per warp
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * KPAD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * KPAD];

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int qp0 = q0 + warp * 16 + g, qp1 = qp0 + 8;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * t;
    const uint32_t* r0 =
        reinterpret_cast<const uint32_t*>(Q + (long long)qp0 * a.q_ss + c);
    const uint32_t* r1 =
        reinterpret_cast<const uint32_t*>(Q + (long long)qp1 * a.q_ss + c);
    qa[kk][0] = qp0 < a.Sq ? r0[0] : 0u;
    qa[kk][1] = qp1 < a.Sq ? r1[0] : 0u;
    qa[kk][2] = qp0 < a.Sq ? r0[4] : 0u;      // columns c + 8, c + 9
    qa[kk][3] = qp1 < a.Sq ? r1[4] : 0u;
  }

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  int kt_begin, kt_end;
  tile_range(a, q0, kBQ, kBK, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                      // previous tile fully consumed
    constexpr int CPR = DH / 8;           // 16-byte chunks per row
    for (int i = threadIdx.x; i < kBK * CPR; i += 128) {
      const int r = i / CPR, c = (i % CPR) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < a.Sk) {
        kv4 = *reinterpret_cast<const uint4*>(K + (long long)(k0 + r) * a.k_ss
                                              + c);
        vv4 = *reinterpret_cast<const uint4*>(V + (long long)(k0 + r) * a.v_ss
                                              + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * KPAD + c]) = kv4;
      *reinterpret_cast<uint4*>(&Vs[r * KPAD + c]) = vv4;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kp = &Ks[(n * 8 + g) * KPAD + kk * 16 + 2 * t];
        mma_bf16(s[n], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        s[n][e] = key_ok(a, qp, kp) ? s[n][e] * a.scale : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = __expf(m0 - mx0), c1 = __expf(m1 - mx1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = __expf(s[n][0] - mx0);
      s[n][1] = __expf(s[n][1] - mx0);
      s[n][2] = __expf(s[n][2] - mx1);
      s[n][3] = __expf(s[n][3] - mx1);
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + ls0;                   // this thread's share of the row
    l1 = l1 * c1 + ls1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                        pack_bf16(s[2 * j][2], s[2 * j][3]),
                        pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                        pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        const __nv_bfloat16* vp = &Vs[(16 * j + 2 * t) * KPAD + i * 8 + g];
        mma_bf16(o[i], pa, pack_bf16(vp[0], vp[KPAD]),
                 pack_bf16(vp[8 * KPAD], vp[9 * KPAD]));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* O =
      static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int c = i * 8 + 2 * t;
    if (qp0 < a.Sq)
      *reinterpret_cast<uint32_t*>(O + (long long)qp0 * a.o_ss + c) =
          pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
    if (qp1 < a.Sq)
      *reinterpret_cast<uint32_t*>(O + (long long)qp1 * a.o_ss + c) =
          pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
  }
}

template <int DH>
cudaError_t launch(const AttnArgs& a, int BH, cudaStream_t s) {
  dim3 grid((a.Sq + kBQ - 1) / kBQ, BH);
  flash_fwd_bf16<DH><<<grid, 128, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out as described above, all bfloat16; strides in elements. The
// caller guarantees 16-byte aligned rows (strides and base pointers multiple
// of 8 elements). Returns a cudaError_t (0 on a clean launch).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int KV, int dh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  AttnArgs a{q,    k,    v,    o,    Sq,   Sk,     H,      KV,
             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,
             v_sh, o_sb, o_ss, o_sh, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return (int)launch<32>(a, B * H, s);
    case 64: return (int)launch<64>(a, B * H, s);
    case 96: return (int)launch<96>(a, B * H, s);
    case 112: return (int)launch<112>(a, B * H, s);
    case 128: return (int)launch<128>(a, B * H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
