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
//
// Multi-probe mode (pa_expand_distances_multi): (B, E) ids -> (B, E, R8),
// the counterpart of expand_distances_multi (expand.py:381), which flattens
// the B x E pairs through the single kernel with repeated queries. Its
// callers, the meta-routed top-k of the hierarchical ClusterIndex build and
// of the query seed, send many queries to few blocks: at 10M, 16,384 points
// x 16 probes over 4,070 f32 blocks of 112 x 128 (57 KB), where the single
// mode streams a block from device memory once a pair (15 GB for at most
// 233 MB of distinct blocks). This mode reads each touched block once a
// work item:
//   1. group the pairs by block on the card: a histogram of the clamped
//      ids, a two-pass exclusive scan of it (which also cuts each block's
//      pairs into work items of at most 32 pairs), and a scatter of the
//      pair indices into block order;
//   2. a persistent grid takes work items from a queue, so a hot block's
//      items spread over several SMs. A CTA stages the item's block (or a
//      tile of its rows, where a block does not fit twice in shared memory)
//      and the item's queries with 1-D bulk copies (TMA, completed on an
//      mbarrier) when rows and queries are 16-byte multiples on 16-byte
//      boundaries, else with cp.async into rows padded to 16-byte chunks;
//      the next item's copies are in flight while the current one is
//      scored, so no warp waits on device memory;
//   3. each warp scores one pair at a time from shared memory, through
//      pa::score32's fixed order (the same chunks, sub-lanes and tree as
//      the single f32 mode), so on f32 rows the multi mode equals the
//      single mode and its plain version bit for bit; on int8 rows an
//      integer-valued query in [-128, 127] (the seed's) sums in exact dp4a
//      integers, as the single int8 kernel's sums are exact.
// Bound at the router's shape: bytes (the distinct blocks, the queries, the
// ids and the output, ~0.11 ms) and 3 B E R8 d operations (~0.17 ms) are
// close. Every pair still reads its block from shared memory, so the
// shared-memory bandwidth is the likely limit. A summation order with FMA,
// or the tensor cores, is a later question.

#include <algorithm>

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

// ---- the multi-probe mode ----

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanPer = 4;  // blocks a scan thread takes
constexpr int kSeg = kScanThreads * kScanPer;  // blocks a scan CTA takes

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(pa::smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   pa::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(pa::smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(pa::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(pa::smem_addr(bar))
      : "memory");
}

// A touched block has at most floor(pairs / item_pairs) + 1 work items.
inline long long max_items(long long n_pad, long long P, int item_pairs) {
  return std::min(n_pad, P) + P / item_pairs + 1;
}

__global__ void multi_count(const int* __restrict__ ids, int P, int n_pad, int* cnt) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P; p += gridDim.x * blockDim.x)
    atomicAdd(cnt + min(max(ids[p], 0), n_pad - 1), 1);
}

// Inclusive scan of (a, b) over the CTA's threads; returns the CTA's totals.
__device__ __forceinline__ int2 cta_scan(int& a, int& b, int2* warp_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ta = __shfl_up_sync(pa::kFullMask, a, off);
    const int tb = __shfl_up_sync(pa::kFullMask, b, off);
    if (lane >= off) {
      a += ta;
      b += tb;
    }
  }
  if (lane == 31) warp_tot[w] = make_int2(a, b);
  __syncthreads();
  const int nw = blockDim.x >> 5;
  if (w == 0) {
    int2 x = lane < nw ? warp_tot[lane] : make_int2(0, 0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ta = __shfl_up_sync(pa::kFullMask, x.x, off);
      const int tb = __shfl_up_sync(pa::kFullMask, x.y, off);
      if (lane >= off) {
        x.x += ta;
        x.y += tb;
      }
    }
    warp_tot[lane] = x;
  }
  __syncthreads();
  if (w > 0) {
    a += warp_tot[w - 1].x;
    b += warp_tot[w - 1].y;
  }
  const int2 tot = warp_tot[nw - 1];
  __syncthreads();  // warp_tot is free for the next call
  return tot;
}

// The scan of the histogram runs in two passes of one CTA a segment of kSeg
// blocks, so that the work items' scattered stores spread over the SMs.
// Each thread takes kScanPer consecutive blocks of its CTA's segment.
__device__ __forceinline__ void segment_sums(const int* __restrict__ cnt, int n_pad,
                                             int item_pairs, int* seg, int& np, int& ni) {
  const int t = threadIdx.x, base = blockIdx.x * kSeg;
  int v[kScanPer];  // all loads in flight at once, coalesced
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    const int i = base + j * kScanThreads + t;
    v[j] = i < n_pad ? cnt[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) seg[j * kScanThreads + t] = v[j];
  __syncthreads();
  np = ni = 0;
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    const int x = seg[t * kScanPer + j];
    np += x;
    ni += (x + item_pairs - 1) / item_pairs;
  }
}

// Pass 1: each segment's pair and work-item totals.
__global__ void __launch_bounds__(kScanThreads)
multi_partials(const int* __restrict__ cnt, int n_pad, int item_pairs, int2* partials) {
  __shared__ int seg[kSeg];
  __shared__ int2 warp_tot[32];
  int np, ni;
  segment_sums(cnt, n_pad, item_pairs, seg, np, ni);
  const int2 tot = cta_scan(np, ni, warp_tot);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

// Pass 2: the segment's offset (the totals of the segments before it), then
// each block's first pair position and work items (block, first position,
// pairs); the last segment writes the number of items.
__global__ void __launch_bounds__(kScanThreads)
multi_scan(const int* __restrict__ cnt, int n_pad, int item_pairs, const int2* partials,
           int* first, int4* items, int* n_items) {
  __shared__ int seg[kSeg];
  __shared__ int2 warp_tot[32];
  const int t = threadIdx.x;
  int cp = 0, ci = 0;
  for (int i = t; i < blockIdx.x; i += kScanThreads) {
    cp += partials[i].x;
    ci += partials[i].y;
  }
  const int2 carry = cta_scan(cp, ci, warp_tot);
  int np, ni;
  segment_sums(cnt, n_pad, item_pairs, seg, np, ni);
  int sp = np, si = ni;
  const int2 tot = cta_scan(sp, si, warp_tot);
  int po = carry.x + sp - np, io = carry.y + si - ni;
  for (int j = 0; j < kScanPer; ++j) {
    const int c = blockIdx.x * kSeg + t * kScanPer + j;
    if (c >= n_pad) break;
    const int x = seg[t * kScanPer + j];
    first[c] = po;
    for (int s = 0; s < x; s += item_pairs)
      items[io++] = make_int4(c, po + s, min(item_pairs, x - s), 0);
    po += x;
  }
  if (blockIdx.x == gridDim.x - 1 && t == 0) *n_items = carry.y + tot.y;
}

// Pair p to its block's next position. The order inside a block is the
// atomics'; a pair's distances do not depend on it.
__global__ void multi_scatter(const int* __restrict__ ids, int P, int n_pad, int* cursor,
                              int* order) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P; p += gridDim.x * blockDim.x)
    order[atomicAdd(cursor + min(max(ids[p], 0), n_pad - 1), 1)] = p;
}

struct MultiParams {
  const char* inl;       // (n_pad, R8, d) rows of T
  const int* ids;        // (P) block ids, P = B E
  int* scratch;          // pa_expand_multi_scratch ints
  int P, n_pad;
  const int* order;      // pair indices in block order
  const int4* items;     // (block, first position in order, pairs)
  const int* n_items;
  int* counter;          // the queue: the next task to take
  const float* queries;  // (B, d)
  float* out;            // (B E, R8)
  int E, R8, d, nch, row_bytes;
  int qch;               // 16-byte chunks of an f32 query
  int item_pairs;        // pairs a work item at most (<= 32)
  int tile_rows, tiles;  // a task is one tile of rows of one work item
  int stages;            // buffers in the ring (<= kMaxStages)
  size_t buf_bytes;      // a buffer: the tile, the item's queries, its pairs, its task
  int bulk;              // bulk copies, else cp.async of `vec` / `qvec` bytes
  int vec, qvec;
};

constexpr int kMaxStages = 4;

// Bytes a consumer warp needs for its query, a 16-byte chunk of row: int8
// rows stage 16 f32 and 16 int8 values a chunk (pa::stage_query); f32 rows
// score the item's staged query in place.
template <typename T>
__host__ __device__ constexpr int warp_query_bytes_per_chunk() {
  return sizeof(T) == 1 ? 80 : 0;
}

// Persistent grid of CTAs of one producer warp and kWarps consumer warps
// around a ring of `stages` buffers, each the task's tile (tile_rows rows of
// nch 16-byte chunks), its item's queries (item_pairs x qch chunks), their
// pair indices and the task (pairs, first row, rows; pairs < 0: the queue
// is empty); then each consumer warp's query slot (int8 rows). The producer
// takes tasks from the queue, fills a buffer once the consumers have
// released it, and arrives on its `full` barrier; the bulk copies complete
// on it. It takes G = 32 / item_pairs tasks a round, a lane a pair, and its
// loads run ahead: the next round's pair indices, the round after next's
// items and the queue's next index are in flight while it fills a round's
// buffers, so no copy waits on a chain of loads. Consumer warps score a
// buffer's pairs in turn and release it on its `empty` barrier.
template <typename T, bool kMips, int kWarps>
__global__ void __launch_bounds__((kWarps + 1) * 32)
expand_multi_kernel(const MultiParams p) {
  extern __shared__ __align__(128) char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rs = p.nch * 16;  // a staged row's stride
  const int qs = p.qch * 16;  // a staged query's stride
  const size_t tile_bytes = static_cast<size_t>(p.tile_rows) * rs;
  const int n_tasks = *p.n_items * p.tiles;
  auto tile_of = [&](int s) { return smem + s * p.buf_bytes; };
  auto queries_of = [&](int s) { return tile_of(s) + tile_bytes; };
  auto pairs_of = [&](int s) { return reinterpret_cast<int*>(queries_of(s) + p.item_pairs * qs); };
  auto task_of = [&](int s) {
    return reinterpret_cast<int4*>(pairs_of(s) + ((p.item_pairs + 3) & ~3));
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], p.bulk ? 1 : 32);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (w == kWarps) {  // the producer
    // Lane l fills pair j = l % item_pairs of the g = l / item_pairs-th of
    // the round's G tasks, taken together from the queue.
    const int G = 32 / p.item_pairs, g = lane / p.item_pairs, j = lane % p.item_pairs;
    auto take = [&]() { return lane == 0 ? atomicAdd(p.counter, G) : 0; };
    auto item = [&](int t) { return t < n_tasks ? p.items[t / p.tiles] : make_int4(0, 0, 0, 0); };
    auto pair_of = [&](int t, int4 it) { return t < n_tasks && j < it.z ? p.order[it.y + j] : 0; };
    int t0 = __shfl_sync(pa::kFullMask, take(), 0) + g;
    int t1 = __shfl_sync(pa::kFullMask, take(), 0) + g;
    int t2_raw = take();
    int4 it0 = item(t0), it1 = item(t1);
    int pair0 = pair_of(t0, it0);
    for (int k = 0;; k += G) {
      // the next round's pairs, the round after next's items, one more base
      const int pair1 = pair_of(t1, it1);
      const int t2 = __shfl_sync(pa::kFullMask, t2_raw, 0) + g;
      const int4 it2 = item(t2);
      const int t3_raw = t2 - g < n_tasks ? take() : n_tasks;
      bool done = false;
      for (int h = 0; h < G && !done; ++h) {
        const int s = (k + h) % p.stages;
        if (k + h >= p.stages) mbar_wait(&empty[s], ((k + h) / p.stages - 1) & 1);
        int4* task = task_of(s);
        const bool mine = g == h;
        const bool lead = mine && j == 0;
        done = __shfl_sync(pa::kFullMask, t0, h * p.item_pairs) >= n_tasks;
        if (done) {  // tell the consumers the queue is empty
          if (lead) *task = make_int4(-1, 0, 0, 0);
          __syncwarp();
          if (p.bulk ? lane == 0 : true) mbar_expect_tx(&full[s], 0);
          break;
        }
        const int r0 = t0 % p.tiles * p.tile_rows;
        const int rows = min(p.tile_rows, p.R8 - r0);
        const char* src = p.inl + (static_cast<size_t>(it0.x) * p.R8 + r0) * p.row_bytes;
        const char* q =
            reinterpret_cast<const char*>(p.queries + static_cast<size_t>(pair0 / p.E) * p.d);
        char* dst = tile_of(s);
        char* qdst = queries_of(s) + j * qs;
        const bool has_pair = mine && j < it0.z;
        if (has_pair) pairs_of(s)[j] = pair0;
        if (lead) *task = make_int4(it0.z, r0, rows, 0);
        if (p.bulk) {
          // the consumers' reads of this buffer (generic proxy) before the
          // copies (async proxy) write it
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lead) {
            mbar_expect_tx(&full[s], rows * p.row_bytes + it0.z * p.d * 4);
            bulk_load(dst, src, rows * p.row_bytes, &full[s]);
          }
          __syncwarp();
          if (has_pair) bulk_load(qdst, q, p.d * 4, &full[s]);
        } else {
          // every lane copies a share of the block of task h
          const int lead_lane = h * p.item_pairs;
          const int brows = __shfl_sync(pa::kFullMask, rows, lead_lane);
          const char* bsrc =
              p.inl + (static_cast<size_t>(__shfl_sync(pa::kFullMask, it0.x, lead_lane)) * p.R8 +
                       __shfl_sync(pa::kFullMask, r0, lead_lane)) *
                          p.row_bytes;
          for (int i = lane; i < brows * p.nch; i += 32) {
            const int r = i / p.nch, c = i - r * p.nch;
            pa::stage_slot(dst + r * rs + 16 * c,
                           bsrc + static_cast<size_t>(r) * p.row_bytes + 16 * c, bsrc,
                           min(16, p.row_bytes - 16 * c), p.vec);
          }
          for (int c = 0; has_pair && c < p.qch; ++c)
            pa::stage_slot(qdst + 16 * c, q + 16 * c, q, min(16, p.d * 4 - 16 * c), p.qvec);
          pa::cp_async_commit();
          pa::cp_async_wait_all();
          __syncwarp();
          mbar_expect_tx(&full[s], 0);  // every lane arrives after its copies
        }
      }
      if (done) break;
      t0 = t1;
      it0 = it1;
      pair0 = pair1;
      t1 = t2;
      it1 = it2;
      t2_raw = t3_raw;
    }
    return;
  }

  // a consumer warp
  char* qslot = smem + p.stages * p.buf_bytes +
                static_cast<size_t>(w) * warp_query_bytes_per_chunk<T>() * p.nch;
  for (int k = 0;; ++k) {
    const int s = k % p.stages;
    mbar_wait(&full[s], (k / p.stages) & 1);
    const int4 task = *task_of(s);
    if (task.x < 0) break;
    const char* tile = tile_of(s);
    const float* qbuf = reinterpret_cast<const float*>(queries_of(s));
    const int* pairs = pairs_of(s);
    auto row_chunk = [=](const char* base) {
      return [=](int r, int c) {
        return *reinterpret_cast<const int4*>(base + static_cast<size_t>(r) * rs + 16 * c);
      };
    };
    for (int i = w; i < task.x; i += kWarps) {
      const float* qg = qbuf + i * p.qch * 4;  // zero-padded to qch chunks
      float* o = p.out + static_cast<size_t>(pairs[i]) * p.R8 + task.y;
      if constexpr (sizeof(T) == 4) {
        // f32 rows: the warp's pairs two at a time, sharing each chunk read
        const int i2 = i + kWarps;
        if (i2 < task.x) {
          float* o2 = p.out + static_cast<size_t>(pairs[i2]) * p.R8 + task.y;
          for (int j0 = 0; j0 < task.z; j0 += 32) {
            const float2 dist = pa::score32x2_by(
                qg, qbuf + i2 * p.qch * 4, row_chunk(tile + static_cast<size_t>(j0) * rs),
                p.nch, kMips, j0 + lane < task.z ? lane : -1, lane);
            if (j0 + lane < task.z) {
              o[j0 + lane] = dist.x;
              o2[j0 + lane] = dist.y;
            }
          }
          i = i2;
          continue;
        }
      }
      pa::Query q;
      if constexpr (sizeof(T) == 1) {
        __syncwarp();  // the warp's reads of its previous query are done
        q = pa::stage_query<T>(qg, p.d, p.nch, reinterpret_cast<float*>(qslot),
                               reinterpret_cast<int8_t*>(qslot + 64 * p.nch), lane);
      } else {
        q.qf = qg;
        q.qi = nullptr;
        q.qq = 0;
        q.int_q = false;
      }
      for (int j0 = 0; j0 < task.z; j0 += 32) {
        const float dist = pa::score32_by<T>(
            q, row_chunk(tile + static_cast<size_t>(j0) * rs), p.nch, kMips,
            j0 + lane < task.z ? lane : -1, lane);
        if (j0 + lane < task.z) o[j0 + lane] = dist;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_expect_tx(&empty[s], 0);  // buffer s is free
  }
}

template <typename T, int kWarps>
cudaError_t launch_multi_kernel(MultiParams prm, bool mips, int optin, int max_stages,
                                cudaStream_t stream) {
  auto kernel =
      mips ? &expand_multi_kernel<T, true, kWarps> : &expand_multi_kernel<T, false, kWarps>;
  constexpr int kThreads = (kWarps + 1) * 32;
  const long long warp_q =
      static_cast<long long>(kWarps) * prm.nch * warp_query_bytes_per_chunk<T>();
  const long long rs = static_cast<long long>(prm.nch) * 16, per_pair = prm.qch * 16 + 4;
  // an item of two pairs a consumer warp; the ring of at least two buffers,
  // the warps' queries and 128 bytes of static shared memory fit, an
  // item's queries taking at most half a buffer
  const long long room = optin - 128 - warp_q;
  prm.item_pairs = static_cast<int>(std::min<long long>(2 * kWarps, room / 4 / per_pair));
  // the pair indices padded to 16 bytes, then the task's 16
  const long long extra = prm.item_pairs * (per_pair - 4) + ((prm.item_pairs + 3) & ~3) * 4 + 16;
  const long long fit = prm.item_pairs < 1 ? 0 : (room / 2 - extra) / rs;
  if (fit < 1) return cudaErrorInvalidValue;  // not one row and one query a buffer
  prm.tile_rows = static_cast<int>(std::min<long long>(prm.R8, fit));
  prm.tiles = (prm.R8 + prm.tile_rows - 1) / prm.tile_rows;
  prm.buf_bytes = static_cast<size_t>(prm.tile_rows * rs + extra);
  prm.stages = static_cast<int>(
      std::min<long long>(max_stages, room / static_cast<long long>(prm.buf_bytes)));
  const size_t smem = prm.stages * prm.buf_bytes + static_cast<size_t>(warp_q);
  cudaError_t err = pa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  long long resident = 0;
  err = pa::resident_ctas(reinterpret_cast<const void*>(kernel), kThreads, smem, &resident);
  if (err != cudaSuccess) return err;

  const int P = prm.P, n_pad = prm.n_pad;
  const long long n_items_max = max_items(n_pad, P, prm.item_pairs);
  const int segs = (n_pad + kSeg - 1) / kSeg;
  int4* items = reinterpret_cast<int4*>(prm.scratch);
  int2* partials = reinterpret_cast<int2*>(prm.scratch + 4 * n_items_max);
  int* cnt = prm.scratch + 4 * n_items_max + 2 * segs;
  int* first = cnt + n_pad;
  int* order = first + n_pad;
  int* ctl = order + P;  // the queue's counter, the items' count
  err = cudaMemsetAsync(cnt, 0, sizeof(int) * static_cast<size_t>(n_pad), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(ctl, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int spread = static_cast<int>(std::min<long long>((P + 255) / 256, 1024));
  multi_count<<<spread, 256, 0, stream>>>(prm.ids, P, n_pad, cnt);
  multi_partials<<<segs, kScanThreads, 0, stream>>>(cnt, n_pad, prm.item_pairs, partials);
  multi_scan<<<segs, kScanThreads, 0, stream>>>(cnt, n_pad, prm.item_pairs, partials, first,
                                                items, ctl + 1);
  multi_scatter<<<spread, 256, 0, stream>>>(prm.ids, P, n_pad, first, order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  prm.order = order;
  prm.items = items;
  prm.n_items = ctl + 1;
  prm.counter = ctl;
  const long long grid = std::min(resident, n_items_max * prm.tiles);
  kernel<<<static_cast<int>(grid), kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

// Group the pairs (the scratch holds the work items, the scan's segment
// totals, the histogram, the cursors, the pairs in block order and the
// queue's counter and length, in that order), then score them. Blocks
// probed by many pairs (the router's ~64 a block) get CTAs of 16 consumer
// warps and a ring of up to 3 buffers (3 of its 57 KB blocks fit); blocks of
// few pairs (the query seed's ~6 a block) CTAs of 4 consumer warps, items of
// 8 pairs, four of them taken in one round of the producer's loads, and a
// ring of 4, so that fewer warps idle on a short item. Four such CTAs an
// SM, bound by registers, keep the most warps resident: on the seed's shape
// a longer ring, more or fewer consumer warps, or a register cap (which
// spills) all ran slower.
template <typename T>
cudaError_t launch_multi(MultiParams prm, bool mips, cudaStream_t stream) {
  prm.row_bytes = prm.d * static_cast<int>(sizeof(T));
  prm.nch = (prm.row_bytes + 15) / 16;
  prm.qch = (prm.d * 4 + 15) / 16;
  prm.vec = pa::widest_load(prm.inl, prm.row_bytes);
  prm.qvec = pa::widest_load(prm.queries, prm.d * 4);
  prm.bulk = prm.vec == 16 && prm.qvec == 16;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const bool wide = prm.P >= 16LL * std::min(prm.n_pad, prm.P);
  return wide ? launch_multi_kernel<T, 16>(prm, mips, optin, 3, stream)
              : launch_multi_kernel<T, 4>(prm, mips, optin, 4, stream);
}

}  // namespace

// The int32 scratch pa_expand_distances_multi needs for n_pad blocks and P
// pairs, whatever the work items' size.
extern "C" long long pa_expand_multi_scratch(int n_pad, int P) {
  return 4 * max_items(n_pad, P, 1) + 2 * static_cast<long long>(n_pad) + P + 2 +
         2 * ((n_pad + kSeg - 1) / kSeg);
}

// (B, E) int32 ids (clamped into range) -> (B, E, R8) f32 distances to the
// f32 (f32 = 1) or int8 rows of each pair's block.
extern "C" int pa_expand_distances_multi(const void* inl, const void* ids, const void* queries,
                                         void* out, void* scratch, long long scratch_ints,
                                         int B, int E, int n_pad, int R8, int d, int f32,
                                         int mips, void* stream) {
  const long long P = static_cast<long long>(B) * E;
  if (P == 0) return 0;
  if (P > INT32_MAX || n_pad < 1 || R8 < 1 || d < 1 ||
      scratch_ints < pa_expand_multi_scratch(n_pad, static_cast<int>(P)))
    return static_cast<int>(cudaErrorInvalidValue);
  MultiParams prm{};
  prm.inl = static_cast<const char*>(inl);
  prm.ids = static_cast<const int*>(ids);
  prm.scratch = static_cast<int*>(scratch);
  prm.queries = static_cast<const float*>(queries);
  prm.out = static_cast<float*>(out);
  prm.P = static_cast<int>(P);
  prm.n_pad = n_pad;
  prm.E = E;
  prm.R8 = R8;
  prm.d = d;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f32 ? launch_multi<float>(prm, mips != 0, s) : launch_multi<int8_t>(prm, mips != 0, s);
  return static_cast<int>(err);
}

extern "C" const char* pa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
