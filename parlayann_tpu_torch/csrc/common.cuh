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

// (distance, pack) keys in lexicographic order.
__device__ __forceinline__ bool key_less(float da, int pa_, float db, int pb) {
  return da < db || (da == db && pa_ < pb);
}

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

// Asynchronous copies from device memory into shared memory (cp.async).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Fill the 16-byte shared slot `dst` with the `valid` bytes at `src`, zeros
// after. `vec` is the widest copy the array's alignment allows: `valid` is a
// multiple of it. A zero-byte copy reads nothing, but is still handed the
// array's base `safe`, a valid address. vec = 1 (an int8 row length that is
// not a multiple of 4) falls back to plain loads.
__device__ __forceinline__ void stage_slot(char* dst, const char* src, const char* safe,
                                           int valid, int vec) {
  if (vec == 16) {
    cp_async<16>(smem_addr(dst), valid > 0 ? src : safe, valid);
  } else if (vec == 8) {
#pragma unroll
    for (int o = 0; o < 16; o += 8) {
      const int v = min(max(valid - o, 0), 8);
      cp_async<8>(smem_addr(dst + o), v > 0 ? src + o : safe, v);
    }
  } else if (vec == 4) {
#pragma unroll
    for (int o = 0; o < 16; o += 4) {
      const int v = min(max(valid - o, 0), 4);
      cp_async<4>(smem_addr(dst + o), v > 0 ? src + o : safe, v);
    }
  } else {
#pragma unroll
    for (int o = 0; o < 16; ++o) dst[o] = o < valid ? src[o] : 0;
  }
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace pa
