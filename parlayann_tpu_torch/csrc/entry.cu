// The entry top-1: each query's nearest point of the sampled entry tier,
// on the tensor cores, with the row argmin kept in registers.
//
// Replaces no Pallas kernel. The JAX package computes the entry top-1 as
// one (B, E) MXU dot with a fused row argmin (parlayann_tpu/index.py:39-55,
// `_entry_top1`), which XLA fuses so that the (B, E) tile never reaches
// HBM. The port computed it as a chain of PyTorch launches (an FP32 cuBLAS
// product, the bias pass, the argmin) that wrote the (B, E) product to
// device memory and read it back three times: at B = 10,000 and E = 4,096,
// 164 MB a pass for a 40 KB answer. This kernel keeps that fusion.
//
// Arithmetic: the key of entry j for a query q is bias[j] + s q.e_j, with
// s = -2 and bias = ||e_j||^2 (L2) or s = -1 and bias = 0 (MIPS), rounded
// once by fmaf: the plain version's bias - 2 dot rounds once too (2 dot is
// exact). The product is 3xTF32 (tf32.cuh's split_tf32: each f32 operand
// split into TF32 hi and lo parts, lo_q hi_e + hi_q lo_e + hi_q hi_e, small
// terms first), so float32-accurate, summed in the tensor cores' f32
// accumulators. The smallest key wins, the lowest position among equal keys
// (argmin's rule).
//
// What bounds it on the H100: operations. 2 B E d multiply-adds three
// times over: at B = 10,000, E = 4,096 and d = 128, 3 x 10.5 GFLOP at
// 495 TFLOP/s (wgmma's dense TF32 rate) is 0.064 ms; the bytes (queries,
// entries, bias, ids) are 7 MB, 0.002 ms. So the products run on wgmma,
// both operands read from shared memory through its descriptors and no
// fragment passing through registers. A CTA takes 128 queries, two
// warpgroups of 64; each issues m64n128k8 products of its 64 queries
// against a 128-entry tile:
//  - the queries are split into hi and lo and stored as K-major
//    128-byte-swizzled tiles (16-byte chunk c of row r at c ^ (r % 8)), up
//    to 128 dimensions at a time (2 x 128 x 128 floats, 128 KB): for d <=
//    128 once a row block, kept for every entry the CTA scans; past it one
//    128-dimension chunk after the other for each tile;
//  - the entry tier is split once a tier (ops/kernels/entry.py's
//    entry_pack: each row's hi parts, then its lo parts) and streams through
//    a ring of three stages of 128 rows x 32 dimensions (both parts, 32 KB,
//    cp.async into the same swizzle; the 2 E d x 4 bytes stay in the 50 MB
//    L2 for every CTA), one stage in flight while one computes and the
//    wgmma of the one before may still read;
//  - a stage is four k-steps of three wgmma; a tile's accumulator (64 f32
//    a thread) starts at its first product and is folded, after the tile's
//    last stage, into a running (key, position) minimum of the thread's two
//    rows in registers, ended by a quad shuffle.
//
// One wave of persistent CTAs runs over the (row block, tile) work items in
// order, each CTA taking an even share, so E is split across CTAs wherever
// the row blocks cannot fill the card (B = 1 or a few hundred queries). A
// row block that one CTA owns writes its ids directly; one that several
// share merges their minima with a 64-bit atomicMax on the inverted
// (order-preserving key << 32 | j), and the last of them (a counter a row
// block) writes the ids. No (B, E) array exists anywhere. PERF.md records
// the designs tried on the card and dropped.

#include <stdint.h>

#include "tf32.cuh"
#include "warp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kET = 128;              // entries a tile
constexpr int kRows = 128;            // queries a CTA
constexpr int kKB = 32;               // dimensions a stage: one 128-byte K-block
constexpr int kQB = 4;                // K-blocks of the queries in shared memory at a time
constexpr int kStages = 3;
constexpr int kPart = kET * kKB * 4;  // bytes of one part (hi or lo) of a 128-row K-block
constexpr int kStageBytes = 2 * kPart;

struct Params {
  const float* q;      // (B, d)
  const float* e;      // (E, 2 dp): each row's hi parts, then its lo parts
  const float* bias;   // (E,)
  const int* eids;     // (E,)
  unsigned long long* keys;  // (B,) merged keys, then (R,) counters; zeroed; null if R == G
  int* out;            // (B,)
  long long W;         // work items, R x T
  int B, E, d, dp;     // dp: d rounded up to a stage (kKB)
  int T, G;            // tiles a row block, CTAs
  int q_vec;           // widest safe load of a query row, bytes
  float scale;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (key, j) as one unsigned key in (key, j) order, -0 counted as +0.
__device__ __forceinline__ unsigned long long pack_key(float key, int j) {
  const uint32_t u = __float_as_uint(key == 0.f ? 0.f : key);
  const uint32_t m = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(m) << 32) | static_cast<uint32_t>(j);
}

__device__ __forceinline__ bool better(float ka, int ja, float kb, int jb) {
  return ka < kb || (ka == kb && ja < jb);
}

// The CTA whose share of the W work items holds item w: CTA c takes
// [c W / G, (c + 1) W / G).
__device__ __forceinline__ long long owner(long long w, long long W, int G) {
  return ((w + 1) * G - 1) / W;
}

// Whether CTAs other than this one scan tiles of the row block whose first
// work item is `base`.
__device__ __forceinline__ bool shared_block(const Params& p, long long base) {
  return owner(base + p.T - 1, p.W, p.G) != owner(base, p.W, p.G);
}

// A segment's minimum (k, j) of row b, from the one thread that holds it.
__device__ __forceinline__ void put_row(const Params& p, bool shared, int b, float k, int j) {
  if (shared) {
    atomicMax(p.keys + b, ~pack_key(k, j));
    __threadfence();
  } else {
    p.out[b] = __ldg(p.eids + j);
  }
}

// After put_row, by every thread of the CTA: the last CTA of a shared row
// block (rows [b0, b0 + rows)) to finish writes its ids.
__device__ __forceinline__ void finish_shared(const Params& p, int rb, int rows,
                                              long long base, int& last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long n = owner(base + p.T - 1, p.W, p.G) - owner(base, p.W, p.G) + 1;
    const unsigned long long done = atomicAdd(p.keys + p.B + rb, 1ull);
    last = done == static_cast<unsigned long long>(n - 1);
  }
  __syncthreads();
  const int b = rb * rows + static_cast<int>(threadIdx.x);
  if (last && threadIdx.x < rows && b < p.B) {
    __threadfence();
    const unsigned long long key = ~__ldcg(p.keys + b);
    p.out[b] = __ldg(p.eids + static_cast<int>(static_cast<uint32_t>(key)));
  }
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A wgmma operand descriptor: K-major, 128-byte swizzle, 8-row groups 1024
// bytes apart, from the tile's shared-memory address (1024-byte aligned).
__device__ __forceinline__ uint64_t desc_of(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (+)= A B over one k-step: A 64 x 8 and B 128 x 8 (K-major) from shared
// memory; scale_d = 0 starts the sum.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1) entry_top1(Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = pa::smem_addr(smem_raw);
  const uint32_t base_s = (raw + 1023u) & ~1023u;  // 1024-aligned: the swizzle's rows
  unsigned char* const sm = smem_raw + (base_s - raw);
  const int nkb = p.dp / kKB;
  const int nq = min(nkb, kQB);                        // K-blocks of the query chunk
  const uint32_t a_s = base_s;                         // [hi, lo][nq][128 rows][128 B]
  const uint32_t ring_s = base_s + 2 * nq * kPart;     // [kStages][hi, lo][128][128 B]
  unsigned char* const a_g = sm;
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
  const long long w_end = (static_cast<long long>(blockIdx.x) + 1) * p.W / p.G;

  for (long long w = static_cast<long long>(blockIdx.x) * p.W / p.G; w < w_end;) {
    const int rb = static_cast<int>(w / p.T);
    const long long base = static_cast<long long>(rb) * p.T;
    const int u_lo = static_cast<int>(w - base);
    const int u_hi = static_cast<int>(min(static_cast<long long>(p.T), w_end - base));
    w = base + u_hi;
    const int b0 = rb * kRows;
    const int n_steps = (u_hi - u_lo) * nkb;
    __syncthreads();  // the previous segment's wgmma reads are done (waited below)

    // step s: K-block s % nkb of tile u_lo + s / nkb, both parts; chunk c
    // of row r at c ^ (r % 8)
    auto prefetch = [&](int s) {
      const uint32_t dst = ring_s + (s % kStages) * kStageBytes;
      const int r0 = (u_lo + s / nkb) * kET;
      const int k0 = (s % nkb) * kKB;
#pragma unroll
      for (int i = 0; i < 2 * kET * 8 / kThreads; ++i) {
        const int slot = tid + i * kThreads;
        const int part = slot / (kET * 8), rem = slot % (kET * 8);
        const int r = rem >> 3, c = rem & 7;
        const bool in = r0 + r < p.E;
        const float* src =
            p.e + static_cast<size_t>(r0 + r) * 2 * p.dp + part * p.dp + k0 + 4 * c;
        pa::cp_async<16>(dst + part * kPart + r * 128 + ((c ^ (r & 7)) << 4), in ? src : p.e,
                         in ? 16 : 0);
      }
    };
    // query chunk ch, split: dimensions [kQB kKB ch, + kQB kKB), 16-byte
    // chunk c of row r's K-block kb at [part][kb][r][c ^ (r & 7)]; four
    // 16-byte loads a thread in flight
    auto load_queries = [&](int ch) {
      const int kbs = min(nq, nkb - ch * kQB), n = kRows * 8 * kbs;
      for (int it0 = tid; it0 < n; it0 += 4 * kThreads) {
        float v[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int it = it0 + u * kThreads;
          const int row = b0 + it / (8 * kbs), col = ch * kQB * kKB + 4 * (it % (8 * kbs));
          const float* src = p.q + static_cast<size_t>(row) * p.d + col;
          const bool in = it < n && row < p.B;
          if (in && p.q_vec >= 16 && col + 4 <= p.d) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(src));
            v[u][0] = x.x, v[u][1] = x.y, v[u][2] = x.z, v[u][3] = x.w;
          } else {
#pragma unroll
            for (int x = 0; x < 4; ++x) v[u][x] = in && col + x < p.d ? __ldg(src + x) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int it = it0 + u * kThreads;
          if (it >= n) break;
          const int r = it / (8 * kbs), cc = it % (8 * kbs), kb = cc >> 3, c = cc & 7;
          uint4 hi, lo;
          pa::split_tf32(v[u][0], hi.x, lo.x);
          pa::split_tf32(v[u][1], hi.y, lo.y);
          pa::split_tf32(v[u][2], hi.z, lo.z);
          pa::split_tf32(v[u][3], hi.w, lo.w);
          const int off = kb * kPart + r * 128 + ((c ^ (r & 7)) << 4);
          *reinterpret_cast<uint4*>(a_g + off) = hi;
          *reinterpret_cast<uint4*>(a_g + nq * kPart + off) = lo;
        }
      }
      fence_async_smem();
    };
    prefetch(0);
    pa::cp_async_commit();
    load_queries(0);
    const int r0 = b0 + 64 * wg + 16 * wq + g;  // this thread's rows: r0, r0 + 8

    float acc[64];
    float bk[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
    int bj[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    // One barrier a step: past it, step s has landed and is visible to the
    // tensor cores' reads for every thread, and every warpgroup's products of
    // step s - 2 are done, so step s + 1 may refill that stage.
    for (int s = 0; s < n_steps; ++s) {
      const int u = u_lo + s / nkb, c = s % nkb;
      if (nkb > kQB && c % kQB == 0 && s > 0) {
        // past d = 128: the tile's next query chunk, once every warpgroup's
        // products over the one in place are done
        wgmma_wait<0>();
        __syncthreads();
        load_queries(c / kQB);
      }
      cp_async_wait<0>();
      fence_async_smem();
      wgmma_wait<1>();
      __syncthreads();
      if (s + 1 < n_steps) prefetch(s + 1);
      pa::cp_async_commit();

      const uint32_t buf = ring_s + (s % kStages) * kStageBytes;
      const uint64_t bh = desc_of(buf), bl = desc_of(buf + kPart);
      const uint32_t ab = a_s + (c % kQB) * kPart + wg * (64 * 128);
      const uint64_t ah = desc_of(ab), al = desc_of(ab + nq * kPart);
      // a k-step is 32 bytes further along the 128-byte rows: 2 in the
      // descriptor's 16-byte units; a tile's first product starts its sums
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32(acc, al + 2 * kk, bh + 2 * kk, c > 0 || kk > 0);
        wgmma_tf32(acc, ah + 2 * kk, bl + 2 * kk, 1);
        wgmma_tf32(acc, ah + 2 * kk, bh + 2 * kk, 1);
      }
      wgmma_commit();
      if (c != nkb - 1) continue;
      wgmma_wait<0>();
      // fold the tile, columns in increasing order so that the first of
      // equal keys stays: acc[4 jj + 2 h + e] is row r0 + 8 h, column
      // 8 jj + 2 t + e of the tile
      const int j0 = u * kET + 2 * t;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * jj + e;
          const float bv = j < p.E ? __ldg(p.bias + j) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float key = fmaf(p.scale, acc[4 * jj + 2 * h + e], bv);
            if (j < p.E && key < bk[h]) {
              bk[h] = key;
              bj[h] = j;
            }
          }
        }
    }
    wgmma_wait<0>();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ok = __shfl_xor_sync(pa::kFullMask, bk[h], off);
        const int oj = __shfl_xor_sync(pa::kFullMask, bj[h], off);
        if (better(ok, oj, bk[h], bj[h])) {
          bk[h] = ok;
          bj[h] = oj;
        }
      }
    }
    const bool shared = shared_block(p, base);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (t == 0 && r0 + 8 * h < p.B) put_row(p, shared, r0 + 8 * h, bk[h], bj[h]);
    }
    if (shared) finish_shared(p, rb, kRows, base, last);
  }
}

// Shared memory: the ring, both parts of the query chunk, 1 KB to align.
size_t smem_bytes(int d) {
  const int nq = min((d + kKB - 1) / kKB, kQB);
  return static_cast<size_t>(kStages) * kStageBytes + 2 * nq * kPart + 1024;
}

}  // namespace

// CTAs that one SM holds at once at dimension d, for the wrapper's grid.
extern "C" int pa_entry_top1_slots(int d, int* blocks) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d);
  cudaError_t err = pa::allow_smem(entry_top1, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, entry_top1, kThreads, smem);
  return static_cast<int>(err);
}

// out[b] = eids[argmin_j bias[j] + scale q_b.e_j] for the B rows of q (B, d)
// over the E entries of the packed tier e (E, 2 dp), dp = d rounded up to
// 32, 16-byte aligned, in `grid` CTAs. `keys` ((B + R) 64-bit words, R =
// ceil(B / 128); zeroed here) is needed when grid != R, and may be null
// otherwise.
extern "C" int pa_entry_top1(const void* q, const void* e, const void* bias, const void* eids,
                             void* keys, void* out, int B, int E, int d, int grid, float scale,
                             void* stream) {
  if (B == 0) return 0;
  if (E < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.e = static_cast<const float*>(e);
  p.bias = static_cast<const float*>(bias);
  p.eids = static_cast<const int*>(eids);
  p.keys = static_cast<unsigned long long*>(keys);
  p.out = static_cast<int*>(out);
  p.B = B;
  p.E = E;
  p.d = d;
  p.dp = (d + kKB - 1) / kKB * kKB;
  p.T = (E + kET - 1) / kET;
  const int R = (B + kRows - 1) / kRows;
  p.W = static_cast<long long>(R) * p.T;
  p.G = grid;
  p.q_vec = pa::widest_load(q, d * 4);
  p.scale = scale;
  // the ring's 16-byte cp.async reads the packed tier
  if (pa::widest_load(e, 2 * p.dp * 4) < 16 || grid < 1 || grid > p.W ||
      (grid != R && keys == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(d);
  cudaError_t err = pa::allow_smem(entry_top1, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid != R) {
    err = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * (static_cast<size_t>(B) + R), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  entry_top1<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
