// Kernel 1: expand_distances.
//
// Replaces parlayann_tpu/ops/pallas/expand.py:129 expand_distances (kernel
// body _expand_kernel, expand.py:59). For each of B queries it reads the
// R8 x d inline row of the vertex ids[b] (the neighbour vectors stored
// contiguously, build_inline's layout) and writes the R8 distances to the
// f32 query: squared L2 or negated dot. The JAX kernel casts rows of any
// dtype; here int8 rows (the q8 tier), f32 rows (the full-precision tier)
// and int16 rows (the scalar tiers of 9 to 16 bits) each have a kernel.
//
// What bounds it on the H100: bytes. Each query reads one 4 KB int8 row
// or 16 KB f32 row (R8 = 32, d = 128) from a random place in device memory
// and does two or three flops per value, far below the card's ~300
// flops-per-byte balance point, so the kernel is a gather at memory
// bandwidth. The TPU version needed a grouped DMA ring because each row
// was one DMA descriptor; here a warp reads its row with 16-byte loads,
// 512 bytes per warp-wide load, which keeps every transaction full and
// lets many rows be in flight at once.
//
// int8 rows: one warp per query. When d is a multiple of 16 and d / 16 is a
// power of two no larger than 32, lane l always reads the same 16 query
// values, so it keeps them in registers; the d / 16 lanes that share one
// neighbour reduce with xor shuffles. Otherwise a generic loop reduces one
// neighbour at a time across the whole warp. Both sum in f32; on int8
// vectors and integer-valued queries (the build path) every distance is an
// exact integer, so the result equals the plain PyTorch version bit for bit.
//
// f32 rows: one warp per query, scoring 32 rows at a time with the row
// scoring of kernels 3 and 5 (pa::score32 of warp.cuh: groups of 8 lanes
// read 8 rows in 16-byte chunks, any d and alignment, and sum in one fixed
// f32 order with no fused multiply-add). The plain version replays that
// order (ops/distance.py:gathered_lane_order, chunk 4), so the two agree
// bit for bit.
//
// int16 rows: one warp per query, as the int8 kernel, with 8 values a
// 16-byte load. The sums are exact only in 64 bits: an L2 difference of
// 16-bit levels reaches 65535 and its square 4.29e9 > 2^31, and a MIPS
// product reaches 32767^2, of which d = 128 pass 2^31. So each lane forms
// its differences in int32 (queries are integer levels, rounded half to
// even into int32), its squares or products and their sum in int64, the
// lanes of one neighbour add their int64 sums by xor shuffles, and the
// exact sum is rounded once to f32 (negated first under MIPS). The plain
// version (ops/kernels/expand.py) does the same integer sum in torch int64
// and rounds it the same way, so the two are equal. Bound as the int8
// kernel: the 8 KB row a query (R8 = 32, d = 128) at memory bandwidth. A
// simple kernel, kept right first.

#include "warp.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kMips, bool kVec16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
expand_kernel(const int8_t* __restrict__ inl, const int* __restrict__ ids,
              const float* __restrict__ queries, float* __restrict__ out, int B,
              int n_pad, int R8, int d) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp leaves together
  const int v = min(max(ids[b], 0), n_pad - 1);
  const int8_t* row = inl + static_cast<size_t>(v) * R8 * d;
  const float* q = queries + static_cast<size_t>(b) * d;
  float* o = out + static_cast<size_t>(b) * R8;

  if (kVec16) {
    const int cpn = d >> 4;         // 16-byte chunks per neighbour vector
    const int per_load = 32 / cpn;  // neighbours covered by one warp-wide load
    const int sub = lane & (cpn - 1);
    float qr[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) qr[i] = q[sub * 16 + i];
    const int4* row4 = reinterpret_cast<const int4*>(row);
    for (int j0 = 0; j0 < R8; j0 += per_load) {
      const int j = j0 + lane / cpn;
      float acc = 0.f;
      if (j < R8) {
        const int4 w = __ldg(row4 + static_cast<size_t>(j) * cpn + sub);
        const int8_t* c = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float x = static_cast<float>(c[i]);
          if (kMips) {
            acc += x * qr[i];
          } else {
            const float df = x - qr[i];
            acc += df * df;
          }
        }
      }
      for (int off = cpn >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(pa::kFullMask, acc, off);
      if (j < R8 && sub == 0) o[j] = kMips ? -acc : acc;
    }
  } else {
    for (int j = 0; j < R8; ++j) {
      const float dist = pa::warp_dist<kMips>(q, row + static_cast<size_t>(j) * d, d, lane);
      if (lane == 0) o[j] = dist;
    }
  }
}

template <bool kMips>
cudaError_t launch(const int8_t* inl, const int* ids, const float* q, float* out, int B,
                   int n_pad, int R8, int d, bool vec16, cudaStream_t stream) {
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  if (vec16)
    expand_kernel<kMips, true><<<grid, block, 0, stream>>>(inl, ids, q, out, B, n_pad, R8, d);
  else
    expand_kernel<kMips, false><<<grid, block, 0, stream>>>(inl, ids, q, out, B, n_pad, R8, d);
  return cudaGetLastError();
}

// One warp a query over f32 rows; each warp stages its query (zero-padded
// to nch 16-byte chunks) in its slice of shared memory.
template <bool kMips>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
expand_f32_kernel(const float* __restrict__ inl, const int* __restrict__ ids,
                  const float* __restrict__ queries, float* __restrict__ out, int B,
                  int n_pad, int R8, int d, int nch, int vec) {
  extern __shared__ __align__(16) float squery[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + w;
  if (b >= B) return;  // whole warp leaves together
  float* qf = squery + static_cast<size_t>(w) * 4 * nch;
  const pa::Query q = pa::stage_query<float>(queries + static_cast<size_t>(b) * d, d, nch,
                                             qf, nullptr, lane);
  const int v = min(max(ids[b], 0), n_pad - 1);
  const int row_bytes = d * 4;
  const char* row = reinterpret_cast<const char*>(inl) + static_cast<size_t>(v) * R8 * row_bytes;
  float* o = out + static_cast<size_t>(b) * R8;
  for (int j0 = 0; j0 < R8; j0 += 32) {
    const int j = j0 + lane;
    const float dist = pa::score32<float>(q, row + static_cast<size_t>(j0) * row_bytes,
                                          row_bytes, nch, vec, kMips, j < R8 ? lane : -1, lane);
    if (j < R8) o[j] = dist;
  }
}

// One warp a query over int16 rows. kVec16: d is a multiple of 8, its
// d / 8 16-byte chunks a power of two no larger than 32, and the rows
// 16-byte aligned; then lane l keeps the 8 query levels of its chunk in
// registers. Otherwise the warp strides over each neighbour's d values.
template <bool kMips, bool kVec16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
expand_i16_kernel(const int16_t* __restrict__ inl, const int* __restrict__ ids,
                  const float* __restrict__ queries, float* __restrict__ out, int B,
                  int n_pad, int R8, int d) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp leaves together
  const int v = min(max(ids[b], 0), n_pad - 1);
  const int16_t* row = inl + static_cast<size_t>(v) * R8 * d;
  const float* q = queries + static_cast<size_t>(b) * d;
  float* o = out + static_cast<size_t>(b) * R8;

  if (kVec16) {
    const int cpn = d >> 3;         // 16-byte chunks per neighbour vector
    const int per_load = 32 / cpn;  // neighbours covered by one warp-wide load
    const int sub = lane & (cpn - 1);
    int qr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) qr[i] = __float2int_rn(q[sub * 8 + i]);
    const int4* row4 = reinterpret_cast<const int4*>(row);
    for (int j0 = 0; j0 < R8; j0 += per_load) {
      const int j = j0 + lane / cpn;
      long long acc = 0;
      if (j < R8) {
        const int4 w = __ldg(row4 + static_cast<size_t>(j) * cpn + sub);
        const int16_t* c = reinterpret_cast<const int16_t*>(&w);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int x = c[i];
          if (kMips) {
            acc += static_cast<long long>(x) * qr[i];
          } else {
            const long long df = x - qr[i];
            acc += df * df;
          }
        }
      }
      for (int off = cpn >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(pa::kFullMask, acc, off);
      if (j < R8 && sub == 0) o[j] = __ll2float_rn(kMips ? -acc : acc);
    }
  } else {
    for (int j = 0; j < R8; ++j) {
      const int16_t* c = row + static_cast<size_t>(j) * d;
      long long acc = 0;
      for (int i = lane; i < d; i += 32) {
        const int x = c[i];
        const int qi = __float2int_rn(q[i]);
        if (kMips) {
          acc += static_cast<long long>(x) * qi;
        } else {
          const long long df = x - qi;
          acc += df * df;
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(pa::kFullMask, acc, off);
      if (lane == 0) o[j] = __ll2float_rn(kMips ? -acc : acc);
    }
  }
}

template <bool kMips>
cudaError_t launch_i16(const int16_t* inl, const int* ids, const float* q, float* out, int B,
                       int n_pad, int R8, int d, bool vec16, cudaStream_t stream) {
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  if (vec16)
    expand_i16_kernel<kMips, true><<<grid, block, 0, stream>>>(inl, ids, q, out, B, n_pad, R8, d);
  else
    expand_i16_kernel<kMips, false><<<grid, block, 0, stream>>>(inl, ids, q, out, B, n_pad, R8, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pa_expand_distances(const void* inl, const void* ids, const void* queries,
                                   void* out, int B, int n_pad, int R8, int d, int mips,
                                   void* stream) {
  if (B == 0) return 0;
  const int cpn = d / 16;
  const bool vec16 = d % 16 == 0 && cpn <= 32 && (cpn & (cpn - 1)) == 0 &&
                     (reinterpret_cast<uintptr_t>(inl) & 15) == 0;
  const auto* in = static_cast<const int8_t*>(inl);
  const auto* id = static_cast<const int*>(ids);
  const auto* q = static_cast<const float*>(queries);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = mips ? launch<true>(in, id, q, o, B, n_pad, R8, d, vec16, s)
                               : launch<false>(in, id, q, o, B, n_pad, R8, d, vec16, s);
  return static_cast<int>(err);
}

extern "C" int pa_expand_distances_f32(const void* inl, const void* ids, const void* queries,
                                       void* out, int B, int n_pad, int R8, int d, int mips,
                                       void* stream) {
  if (B == 0) return 0;
  const int nch = (d * 4 + 15) / 16;
  const int vec = pa::widest_load(inl, d * 4);
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * nch * 16;
  auto kernel = mips ? &expand_f32_kernel<true> : &expand_f32_kernel<false>;
  const cudaError_t err = pa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarpsPerBlock * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inl), static_cast<const int*>(ids),
      static_cast<const float*>(queries), static_cast<float*>(out), B, n_pad, R8, d, nch, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pa_expand_distances_i16(const void* inl, const void* ids, const void* queries,
                                       void* out, int B, int n_pad, int R8, int d, int mips,
                                       void* stream) {
  if (B == 0) return 0;
  const int cpn = d / 8;
  const bool vec16 = d % 8 == 0 && cpn <= 32 && (cpn & (cpn - 1)) == 0 &&
                     (reinterpret_cast<uintptr_t>(inl) & 15) == 0;
  const auto* in = static_cast<const int16_t*>(inl);
  const auto* id = static_cast<const int*>(ids);
  const auto* q = static_cast<const float*>(queries);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = mips ? launch_i16<true>(in, id, q, o, B, n_pad, R8, d, vec16, s)
                               : launch_i16<false>(in, id, q, o, B, n_pad, R8, d, vec16, s);
  return static_cast<int>(err);
}

extern "C" const char* pa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
