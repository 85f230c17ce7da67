// Row-wise RMSNorm with float32 statistics and a (1 + w) scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas
// (`_kernel`, pallas_call at :33): out = x * rsqrt(mean(x^2) + eps) * (1 + w),
// statistics in float32, output in x's type.
//
// Bound on the card: bytes. Each element is read once and written once and
// costs ~4 float operations, far under the ~300 operations per byte the
// H100 needs before compute binds. The design moves each row's bytes once
// from device memory: one block of 256 threads per row reads it with 16-byte
// vector loads, reduces the sum of squares in registers, warp shuffles and
// shared memory, then reads it again (the second read hits L1/L2: a row is
// at most tens of KB) and writes the scaled row with 16-byte stores. The TPU
// kernel's 256-row tiles were a VMEM choice; here any row count works and no
// row padding is needed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f;
using repro_torch::to_f;

constexpr int kThreads = 256;

template <typename TX, typename TW>
__global__ __launch_bounds__(kThreads) void rmsnorm_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
    int d, float eps, int vec) {
  constexpr int VEC = 16 / sizeof(TX);
  __shared__ float warp_sums[kThreads / 32];
  const TX* xr = x + (int64_t)blockIdx.x * d;
  TX* orow = out + (int64_t)blockIdx.x * d;
  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x; i < d / VEC; i += kThreads) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float v = to_f(e[j]);
        ss += v * v;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float v = to_f(xr[i]);
      ss += v * v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = ss;
  __syncthreads();
  if (wid == 0) {
    float t = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) warp_sums[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_sums[0] / (float)d + eps);
  if (vec) {
    for (int i = threadIdx.x; i < d / VEC; i += kThreads) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const TX* e = reinterpret_cast<const TX*>(&raw);
      uint4 res;
      TX* r = reinterpret_cast<TX*>(&res);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        r[j] = from_f<TX>(to_f(e[j]) * inv * (1.f + to_f(w[i * VEC + j])));
      reinterpret_cast<uint4*>(orow)[i] = res;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      orow[i] = from_f<TX>(to_f(xr[i]) * inv * (1.f + to_f(w[i])));
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, long long rows,
                   int d, float eps, int vec, cudaStream_t stream) {
  rmsnorm_kernel<TX, TW><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), d, eps, vec);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) contiguous; w: (d,). dtype codes: 0 float32, 1 bfloat16.
// vec != 0 asks for 16-byte accesses: the caller guarantees 16-byte aligned
// rows (d * sizeof(x) % 16 == 0 and aligned base pointers).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out,
                           long long rows, int d, float eps, int x_dtype,
                           int w_dtype, int vec, void* stream) {
  if (rows <= 0 || d <= 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch<float, float>(x, w, out, rows, d, eps, vec, s);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, vec, s);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, vec, s);
  else if (x_dtype == 1 && w_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, vec,
                                               s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
