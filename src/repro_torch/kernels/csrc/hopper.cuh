// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA (tensor maps and bulk copies), cp.async, and warpgroup MMA (wgmma)
// on 128-byte-swizzled shared tiles; on the host, the tensor-map encoder.
//
// A 128-byte-swizzled tile is stored as panels of 64 bf16 columns (128
// bytes a row); within a panel, row r's 16-byte piece c sits at piece
// c ^ (r % 8), and the panel starts on a 1024-byte boundary. TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes this layout, and `swizzle128` gives the
// same address for a copy made by threads (cp.async). `sw128_desc` describes
// such a tile to wgmma: K-major (rows of the K index, as Q and K in
// attention): SBO 1024 (8-row groups), LBO unused, a k-step of 16 adds 32
// bytes inside a panel; MN-major (K down the rows, as V): LBO the distance
// between 64-column panels, SBO 1024 (8-row groups of K).
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte piece `piece` (0..7) of row `row` in a 128-byte
// swizzled panel.
__device__ __forceinline__ uint32_t swizzle128(int row, int piece) {
  return static_cast<uint32_t>(row) * 128u +
         (static_cast<uint32_t>(piece ^ (row & 7)) << 4);
}

// --------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Wait for the phase of `bar` with the given parity to complete. A wait
// that outlasts ~2^32 cycles (seconds) can only be a broken protocol: trap,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// TMA: a 4-d box of the tensor map into shared memory, completion counted
// in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Bulk copy (no tensor map): `bytes` (a multiple of 16) from global to
// shared memory, both 16-byte aligned, completion counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// --------------------------------------------------------------- cp.async

// 16 bytes from global to shared; only the first `src_bytes` (0..16) are
// read, the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes made by threads (st.shared, cp.async), visible to
// wgmma's reads (the async proxy); each writer fences before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor, 128-byte swizzle (see the top).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (its asm does not name them at the wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The f32 accumulator of an m64nN wgmma: element e of a thread holds row
// 16 * warp + lane / 4 + 8 * ((e / 2) % 2) and column 8 * (e / 4) +
// 2 * (lane % 4) + e % 2 of the warpgroup's 64 x N tile; a register A
// operand (4 x 32 bits, 64 x 16) has the same row / column map over its 16
// columns, two bf16 to a register.

#define WG_R8(b)                                                          \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),         \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define WG_D32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"
#define WG_R32 \
  WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24)
#define WG_D64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R64 \
  WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40), \
  WG_R8(48), WG_R8(56)
#define WG_D128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127"
#define WG_R128 \
  WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40), \
  WG_R8(48), WG_R8(56), WG_R8(64), WG_R8(72), WG_R8(80), WG_R8(88), \
  WG_R8(96), WG_R8(104), WG_R8(112), WG_R8(120)

// D (64 x 64, f32) = A (64 x 16, smem, K-major) * B (16 x 64, smem,
// K-major) + (scale_d ? D : 0).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_R32
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) = A (64 x 16, smem, K-major) * B (16 x 64, smem,
// MN-major) + (scale_d ? D : 0).
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WG_R32
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) = A (64 x 16, smem, K-major) * B (16 x 128, smem,
// K-major) + (scale_d ? D : 0).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_R64
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 256, f32) = A (64 x 16, smem, K-major) * B (16 x 256, smem,
// MN-major) + (scale_d ? D : 0).
__device__ __forceinline__ void wgmma_ss_n256_mn(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_D128
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : WG_R128
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_R32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_R64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, registers) * B (16 x 256, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_D128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_R128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x N, f32) += A (64 x 16, registers) * B (16 x N, smem, MN-major),
// N = 64 or 128 (a padded head dim).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    static_assert(N == 64, "N is 64 or 128");
    wgmma_rs_n64(d, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// An f32 accumulator of 64 x N (N / 2 values a thread) in bf16 as the
// register A fragments of N / 16 k-steps of 16 (see the map above).
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    a[j][0] = pack_bf16(x[8 * j + 0], x[8 * j + 1]);
    a[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// 2^x on the special-function unit (about 2 ulp; -inf gives +0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so a library
// needs no -lcuda; null when the driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Make the current device's primary context current on the calling thread
// (cudaSetDevice does so since CUDA 12). The tensor-map encoder needs it,
// and a thread that has made no runtime call yet has none: autograd's
// backward thread, when an attention backward is the first thing it runs.
inline void bind_context() {
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
}

// A rank-4 bf16 map with the 128-byte swizzle from the 11 values the
// Python wrappers compute (`kernels/flash_attention.py::tensor_map`): dims
// innermost first, the three outer strides in bytes, the box.
inline bool encode_map(EncodeTiled enc, CUtensorMap* tm, const void* ptr,
                       const unsigned long long* m) {
  const cuuint64_t dims[4] = {m[0], m[1], m[2], m[3]};
  const cuuint64_t strides[3] = {m[4], m[5], m[6]};
  const cuuint32_t box[4] = {(cuuint32_t)m[7], (cuuint32_t)m[8],
                             (cuuint32_t)m[9], (cuuint32_t)m[10]};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace repro_torch
