// Block-level bitonic networks over shared memory: the port of
// parlayann_tpu/ops/pallas/bitonic.py (bitonic_sort :51, bitonic_merge :82).
// Its one launch is the bitonic_sort_rows test launch (fusedbeam.cu); the
// walks of kernels 3 and 5 run the warp networks of warp.cuh instead.
//
// Keys are (dist, pack) pairs compared lexicographically. Callers keep every
// entry with dist = INF at one canonical pack, so the order is total up to
// identical elements: the sorted result is unique and equals a stable
// PyTorch lexsort of the same pairs. The TPU networks compared the distance
// alone and broke ties arbitrarily.
//
// Each stage is a compare-exchange of the pairs (lo, lo + stride) spread
// over the block, followed by __syncthreads(). Callers synchronise before
// the first stage. The functions are inline: several kernel files include
// this header into one library.
#pragma once

#include "common.cuh"

namespace pa {

__device__ __forceinline__ void compare_exchange(float* key, int* val, int lo, int hi,
                                                 bool ascending) {
  const float a = key[lo], b = key[hi];
  const int pa_ = val[lo], pb = val[hi];
  const bool swap = ascending ? key_less(b, pb, a, pa_) : key_less(a, pa_, b, pb);
  if (swap) {
    key[lo] = b;
    key[hi] = a;
    val[lo] = pb;
    val[hi] = pa_;
  }
}

// Ascending sort of n (a power of two) entries.
__device__ inline void bitonic_sort(float* key, int* val, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int lo = 2 * stride * (i / stride) + (i % stride);
        compare_exchange(key, val, lo, lo + stride, (lo & size) == 0);
      }
      __syncthreads();
    }
  }
}

// Ascending merge of n (a power of two) entries that form a bitonic
// sequence: non-decreasing, then non-increasing.
__device__ inline void bitonic_merge(float* key, int* val, int n) {
  for (int stride = n >> 1; stride > 0; stride >>= 1) {
    for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
      const int lo = 2 * stride * (i / stride) + (i % stride);
      compare_exchange(key, val, lo, lo + stride, true);
    }
    __syncthreads();
  }
}

}  // namespace pa
