// Helpers shared by the port's kernels. Every kernel file exposes plain C
// entry points that launch on the caller's stream and return
// cudaGetLastError(), so the Python wrapper (ctypes) can raise on a refused
// launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pa {

// The JAX package's INF: a large finite sentinel distance for masked slots.
constexpr float kInf = 3.0e38f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// Distance from an f32 query to one int8 or f32 vector, reduced across the
// warp: squared L2 as sum((v - q)^2), MIPS as -sum(v * q). Every lane
// returns the total. On int8 vectors and integer-valued queries every
// partial sum is an integer below 2^24, so the result is exact whatever the
// summation order.
template <bool kMips, typename T>
__device__ __forceinline__ float warp_dist(const float* q, const T* v, int d, int lane) {
  float acc = 0.f;
  for (int t = lane; t < d; t += 32) {
    const float x = static_cast<float>(v[t]);
    if (kMips) {
      acc += x * q[t];
    } else {
      const float df = x - q[t];
      acc += df * df;
    }
  }
  acc = warp_sum(acc);
  return kMips ? -acc : acc;
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace pa
