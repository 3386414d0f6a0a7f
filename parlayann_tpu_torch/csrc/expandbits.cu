// Kernel 6: expand_bits_flat, the packed 1-bit frontier expansion.
//
// Replaces parlayann_tpu/ops/pallas/expand.py:301 expand_bits_flat (kernel
// body _expand_bits_kernel, expand.py:249) and the bits == 1 mode of
// expand_distances (expand.py:129, _expand_kernel :90-94). For each of B
// queries it reads the R8 x W int32-word inline row of the vertex ids[b]
// (the neighbours' packed sign bits stored contiguously, build_inline's
// layout over the word array) and writes
//
//   out[b, j] = popcount(inline[ids[b], j, :] XOR q[b, :])   (as f32)
//
// for every slot j < R8. The counts are exact integers, so the result
// equals the plain PyTorch version bit for bit.
//
// What bounds it on the H100: bytes. A query reads one random row of
// R8 * W * 4 bytes (512 B at W = 4, R8 = 32; 2 KB at W = 16) and does one
// XOR and one popcount per word. At B = 32000 and W = 4 the call must move
// about 21 MB (rows, queries, ids, output), 6.3 us at 3.35 TB/s; at W = 16
// about 72 MB, 21 us. The TPU kernel flattened each row into 128-lane
// vectors because Mosaic refused narrower DMA slices, and summed lane
// groups with rolls; here nothing needs that layout.
//
// Design: one warp per query, as in expand.cu. When W is a multiple of 4
// and W / 4 is a power of two no larger than 32 (W = 4, 8, 16, 32, ...),
// lane l always covers the same 16-byte chunk of a neighbour's words, keeps
// the query's 4 words of that chunk in registers, reads the row with 16-byte
// loads (one int4 per lane covers 32 / (W / 4) neighbours), and the W / 4
// lanes that share a neighbour sum with xor shuffles. Any other W (1, 2, 3,
// 5, ...) takes a generic loop: each lane owns whole neighbours and walks
// their W words, with the query words read through the read-only cache.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ int popc_xor(int4 a, int4 b) {
  return __popc(static_cast<unsigned>(a.x ^ b.x)) + __popc(static_cast<unsigned>(a.y ^ b.y)) +
         __popc(static_cast<unsigned>(a.z ^ b.z)) + __popc(static_cast<unsigned>(a.w ^ b.w));
}

// kCpn = W / 4: 16-byte chunks per neighbour, a power of two <= 32
template <int kCpn>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
expand_bits_vec(const int* __restrict__ inl, const int* __restrict__ ids,
                const int* __restrict__ queries, float* __restrict__ out, int B, int n_pad,
                int R8) {
  constexpr int kPerLoad = 32 / kCpn;  // neighbours covered by one warp-wide load
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp leaves together
  const int v = min(max(ids[b], 0), n_pad - 1);
  const int sub = lane & (kCpn - 1);
  const int4* row = reinterpret_cast<const int4*>(inl + static_cast<size_t>(v) * R8 * 4 * kCpn);
  const int4 q = __ldg(reinterpret_cast<const int4*>(queries + static_cast<size_t>(b) * 4 * kCpn) + sub);
  float* o = out + static_cast<size_t>(b) * R8;
#pragma unroll 4
  for (int j0 = 0; j0 < R8; j0 += kPerLoad) {
    const int j = j0 + lane / kCpn;
    int acc = 0;
    if (j < R8) acc = popc_xor(__ldg(row + static_cast<size_t>(j) * kCpn + sub), q);
#pragma unroll
    for (int off = kCpn >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(pa::kFullMask, acc, off);
    if (j < R8 && sub == 0) o[j] = static_cast<float>(acc);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
expand_bits_generic(const int* __restrict__ inl, const int* __restrict__ ids,
                    const int* __restrict__ queries, float* __restrict__ out, int B, int n_pad,
                    int R8, int W) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const int v = min(max(ids[b], 0), n_pad - 1);
  const int* row = inl + static_cast<size_t>(v) * R8 * W;
  const int* q = queries + static_cast<size_t>(b) * W;
  float* o = out + static_cast<size_t>(b) * R8;
  for (int j = lane; j < R8; j += 32) {
    const int* nb = row + static_cast<size_t>(j) * W;
    int acc = 0;
    for (int w = 0; w < W; ++w) acc += __popc(static_cast<unsigned>(__ldg(nb + w) ^ __ldg(q + w)));
    o[j] = static_cast<float>(acc);
  }
}

template <int kCpn>
void launch_vec(const int* inl, const int* ids, const int* q, float* out, int B, int n_pad,
                int R8, dim3 grid, dim3 block, cudaStream_t s) {
  expand_bits_vec<kCpn><<<grid, block, 0, s>>>(inl, ids, q, out, B, n_pad, R8);
}

}  // namespace

extern "C" int pa_expand_bits(const void* inl, const void* ids, const void* queries, void* out,
                              int B, int n_pad, int R8, int W, void* stream) {
  if (B == 0) return 0;
  const auto* in = static_cast<const int*>(inl);
  const auto* id = static_cast<const int*>(ids);
  const auto* q = static_cast<const int*>(queries);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  const int cpn = W / 4;
  const bool aligned = ((reinterpret_cast<uintptr_t>(inl) | reinterpret_cast<uintptr_t>(queries)) & 15) == 0;
  const bool vec = aligned && W % 4 == 0 && cpn <= 32 && (cpn & (cpn - 1)) == 0;
  if (!vec) {
    expand_bits_generic<<<grid, block, 0, s>>>(in, id, q, o, B, n_pad, R8, W);
  } else {
    switch (cpn) {
      case 1: launch_vec<1>(in, id, q, o, B, n_pad, R8, grid, block, s); break;
      case 2: launch_vec<2>(in, id, q, o, B, n_pad, R8, grid, block, s); break;
      case 4: launch_vec<4>(in, id, q, o, B, n_pad, R8, grid, block, s); break;
      case 8: launch_vec<8>(in, id, q, o, B, n_pad, R8, grid, block, s); break;
      case 16: launch_vec<16>(in, id, q, o, B, n_pad, R8, grid, block, s); break;
      default: launch_vec<32>(in, id, q, o, B, n_pad, R8, grid, block, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
