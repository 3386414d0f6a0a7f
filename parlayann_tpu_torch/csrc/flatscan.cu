// Kernel 4: exact brute-force top-k (flat search) on the tensor cores.
//
// Replaces parlayann_tpu/ops/pallas/flatscan.py:121 flat_topk_pallas
// (kernel body _kernel :54). The TPU kernel computed a (Bt, C) distance
// tile on the MXU and folded it into an M-deep pool per 128-lane class,
// which loses a true top-k entry whenever it shares its lane class and
// chunk with a smaller one (recall ~0.999); the exact top-k of the pool ran
// outside. That pool is TPU machinery (a way to select without lane
// reshapes). This kernel returns the EXACT top-k, ordered by (distance,
// id): the function `select="sort"` computes, which the TPU kernel
// approximated.
//
// Distance algebra (flat.py:44-55 and flatscan.py:28-31): the caller
// passes a bias row b[x] = ||x||^2 (L2) or 0 (MIPS), INF where the point is
// invalid (id >= n_valid, masked out), and a scale s = -2 (L2) or -1
// (MIPS); the kernel selects on fmaf(s, q.x, b[x]), and the wrapper adds
// ||q||^2 back.
//
// Arithmetic: 3xTF32 on mma.sync.m16n8k8. Each f32 operand a is split as
// hi = rna(a), lo = rna(a - hi), rna being cvt.rna.tf32.f32's rounding
// (hi must be rounded so: the tensor core reads a .tf32 operand by dropping
// the low 13 bits, which would leave a - hi wrong by up to 2^-10 relative),
// and the product is lo_q.hi_x + hi_q.lo_x + hi_q.hi_x, small terms first:
// each product misses at most about 3 * 2^-22 of |q_i x_i|. int8 points
// are exact in TF32 (x_lo = 0), so they take two passes. The tensor core's
// own f32 accumulation need not round as IEEE does, so each 32-dimension
// chunk is summed in a fresh accumulator and added to the running sum with
// an ordinary f32 add. On integer-valued queries (the q8 tier's translated
// queries) lo_q = 0, every product is an integer and every partial sum an
// integer below 2^24 (d <= 1024), so the kernel equals the plain version
// bit for bit there.
//
// What bounds it on the H100: the tensor-core rate of 3 TF32 passes. At
// B = 10K queries, N = 100K points and d = 128 the products are 2.56e11
// FLOP a pass, 3 x 2.56e11 / 495e12 = 1.55 ms (495 TFLOP/s is wgmma's
// dense TF32 rate; mma.sync reaches a fraction of it); the selection that
// follows touches each distance once and inserts about k ln(N / k) per
// query. What the design does about the five limits of the earlier
// f32-FMA design:
//  1. no tensor cores: every product is an mma.sync TF32 (above).
//  2. shared-memory-bound inner loop: a warp computes a 32 x 32 tile, two
//     m16 by four n8 fragments, 24 mma (3 passes) per 16 fragment loads of
//     a k8 step; rows are padded to 36 floats (48 bytes for int8), so the
//     8 groupID rows x 4 threadID_in_group columns of a fragment load fall
//     on 32 distinct banks.
//  3. scalar loads without overlap: dimensions stream in chunks of 32
//     through two shared-memory stages filled by cp.async copies of up to
//     16 bytes, one barrier a step: the copy of the next chunk (or of the
//     next tile's first chunk, with its bias row) is in flight while the
//     current one computes and while the tile's selection runs. Bytes past
//     d, queries past B and points past the range are zero-filled.
//  4. a grid that does not fill the card: the grid is (ceil(B / 64), S),
//     split s scanning a contiguous range of points (split s below split
//     s + 1); the wrapper picks S for about four waves and merges the S
//     sorted lists of a row with one stable sort (merge_split_topk).
//  5. the selection waits on the tile: the tile is 64 x 128, and its
//     values are filtered in registers before they reach shared memory: a
//     value that does not beat its row's k-th entry is stored as INF, and
//     a row with no value left skips its ballots. With S > 1 the filter
//     uses the best k-th entry any split of the row has published, so a
//     split that starts late starts with a near-final threshold.
// Selection: warp w keeps the sorted (distance, id) lists of rows w, w + 8,
// ...: a ballot per 32 columns collects the candidates that beat the
// row's k-th entry, and each is inserted; for k <= 32 the list sits in the
// warp's registers while a tile merges (a ballot finds the place, a
// shuffle moves the tail), above 32 the warp shifts it in shared memory.
//
// Shared memory (bytes): stages 2 x 64 x 36 x 4 = 18432 (queries) plus
// 2 x 128 x 36 x 4 = 36864 (f32 points) or 2 x 128 x 48 = 12288 (int8);
// bias 2 x 128 x 4 = 1024; tile 64 x 136 x 4 = 34816; lists 64 x k x 8
// (131072 at k = 256); 1024 of per-row state. f32 at k = 256: 223232 of
// the 232448 a block may use, one CTA per SM; at k = 10: 97280, two CTAs
// per SM.

#include <climits>
#include <type_traits>

#include "bitonic.cuh"
#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 64;    // queries per CTA
constexpr int kCT = 128;   // points per tile
constexpr int kDK = 32;    // dimensions per stage
constexpr int kQS = kDK + 4;     // f32 row stride of a stage, floats
constexpr int kXS8 = kDK + 16;   // int8 row stride of a stage, bytes
constexpr int kTS = kCT + 8;     // row stride of the distance tile, floats

struct Params {
  const float* q;      // (B, d) f32
  const void* x;       // (n, d) f32 or int8
  const float* bias;   // (n,) f32, INF where the point is invalid
  const int* exclude;  // (B,) int32 or null
  unsigned long long* thr;  // (B,) best published k-th key per row, or null (S = 1)
  int B, n, d, k;
  int per_split;       // points per split, a multiple of kCT
  int q_vec, x_vec;    // widest safe copy in bytes: 16, 8, 4, or 1 (plain loads)
  float scale;
  float* out_d;  // (B, S, k)
  int* out_i;    // (B, S, k)
};

using pa::cp_async;
using pa::cp_async_commit;
using pa::cp_async_wait_all;
using pa::mma_tf32;
using pa::smem_addr;
using pa::split_tf32;
using pa::stage_slot;

// (distance, id) as one unsigned key in key_less order (distance bits made
// monotone), for atomicMin; ~0 is "none".
__device__ __forceinline__ unsigned long long pack_key(float d, int id) {
  const uint32_t u = __float_as_uint(d);
  const uint32_t m = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(m) << 32) | static_cast<uint32_t>(id);
}

__device__ __forceinline__ void unpack_key(unsigned long long key, float& d, int& id) {
  if (key == ~0ull) {
    d = pa::kInf;
    id = INT_MAX;
    return;
  }
  const uint32_t m = static_cast<uint32_t>(key >> 32);
  d = __uint_as_float((m & 0x80000000u) ? (m & 0x7fffffffu) : ~m);
  id = static_cast<int>(static_cast<uint32_t>(key));
}

// Insert the candidates of one row of the distance tile `row` (kCT values,
// INF where a value cannot enter) into the row's sorted (distance, id)
// list: a ballot per 32 columns collects those that beat the k-th entry,
// and each is inserted in turn. Leaves the k-th entry in (td, ti).
//
// k <= 32: lane j holds entry j in registers while the tile is merged; an
// insertion is a ballot for its place and a shuffle of the tail up by one.
__device__ __forceinline__ void select_row_regs(float* rd, int* ri, const float* row,
                                                int p0, int k, int lane, float& td,
                                                int& ti) {
  float ed = lane < k ? rd[lane] : pa::kInf;
  int ei = lane < k ? ri[lane] : INT_MAX;
  td = __shfl_sync(pa::kFullMask, ed, k - 1);
  ti = __shfl_sync(pa::kFullMask, ei, k - 1);
  for (int h = 0; h < kCT; h += 32) {
    const float cd = row[h + lane];
    const int cid = p0 + h + lane;
    unsigned mask =
        __ballot_sync(pa::kFullMask, cd < pa::kInf && pa::key_less(cd, cid, td, ti));
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float vd = __shfl_sync(pa::kFullMask, cd, src);
      const int vi = __shfl_sync(pa::kFullMask, cid, src);
      if (!pa::key_less(vd, vi, td, ti)) continue;  // the k-th entry improved
      const int pos =
          __popc(__ballot_sync(pa::kFullMask, lane < k && pa::key_less(ed, ei, vd, vi)));
      const float ud = __shfl_up_sync(pa::kFullMask, ed, 1);
      const int ui = __shfl_up_sync(pa::kFullMask, ei, 1);
      if (lane == pos) {
        ed = vd;
        ei = vi;
      } else if (lane > pos) {
        ed = ud;
        ei = ui;
      }
      td = __shfl_sync(pa::kFullMask, ed, k - 1);
      ti = __shfl_sync(pa::kFullMask, ei, k - 1);
    }
  }
  if (lane < k) {
    rd[lane] = ed;
    ri[lane] = ei;
  }
  __syncwarp();
}

// k > 32: the list stays in shared memory; the warp counts the insertion's
// place and shifts the tail up one chunk of 32 at a time.
__device__ __forceinline__ void select_row_smem(float* rd, int* ri, const float* row,
                                                int p0, int k, int lane, float& td,
                                                int& ti) {
  td = rd[k - 1];
  ti = ri[k - 1];
  for (int h = 0; h < kCT; h += 32) {
    const float cd = row[h + lane];
    const int cid = p0 + h + lane;
    unsigned mask =
        __ballot_sync(pa::kFullMask, cd < pa::kInf && pa::key_less(cd, cid, td, ti));
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float vd = __shfl_sync(pa::kFullMask, cd, src);
      const int vi = __shfl_sync(pa::kFullMask, cid, src);
      if (!pa::key_less(vd, vi, td, ti)) continue;  // the k-th entry improved
      int pos = 0;
      for (int j = lane; j < k; j += 32) pos += pa::key_less(rd[j], ri[j], vd, vi);
      pos = pa::warp_sum(pos);
      // shift [pos, k - 1) one place up, top chunk first
      for (int base = ((k - 1) / 32) * 32; base >= 0; base -= 32) {
        const int j = base + lane;
        const bool w = j > pos && j < k;
        float sd = 0.f;
        int si = 0;
        if (w) {
          sd = rd[j - 1];
          si = ri[j - 1];
        }
        __syncwarp();
        if (w) {
          rd[j] = sd;
          ri[j] = si;
        }
        __syncwarp();
      }
      if (lane == 0) {
        rd[pos] = vd;
        ri[pos] = vi;
      }
      __syncwarp();
      td = rd[k - 1];
      ti = ri[k - 1];
    }
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) flat_topk_kernel(Params p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kXStageBytes = kF32 ? kCT * kQS * 4 : kCT * kXS8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);                  // 2 x kBT x kQS
  unsigned char* xs = smem_raw + 2 * kBT * kQS * 4;                // 2 x kXStageBytes
  float* bs = reinterpret_cast<float*>(xs + 2 * kXStageBytes);     // 2 x kCT
  float* ds = bs + 2 * kCT;                                        // kBT x kTS
  float* ld = ds + kBT * kTS;                                      // kBT x k distances
  int* li = reinterpret_cast<int*>(ld + kBT * p.k);                // kBT x k ids
  __shared__ int excl[kBT];
  __shared__ int hot[kBT];  // rows with a value that beat the k-th entry
  __shared__ float gd[kBT];  // the best k-th entry another split published
  __shared__ int gi[kBT];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const int b0 = blockIdx.x * kBT;
  const int lo = blockIdx.y * p.per_split;
  const int hi = min(p.n, lo + p.per_split);
  const int n_chunks = (p.d + kDK - 1) / kDK;
  const int n_steps = (max(hi - lo, 0) + kCT - 1) / kCT * n_chunks;
  const char* qbase = reinterpret_cast<const char*>(p.q);
  const char* xbase = static_cast<const char*>(p.x);

  for (int i = tid; i < kBT * p.k; i += kThreads) {
    ld[i] = pa::kInf;
    li[i] = INT_MAX;
  }
  for (int i = tid; i < kBT; i += kThreads) {
    excl[i] = (p.exclude != nullptr && b0 + i < p.B) ? p.exclude[b0 + i] : -1;
    hot[i] = 0;
    gd[i] = pa::kInf;
    gi[i] = INT_MAX;
  }

  // queue the copies of step s (tile s / n_chunks, chunk s % n_chunks)
  auto prefetch = [&](int s) {
    const int buf = s & 1;
    const int p0 = lo + (s / n_chunks) * kCT, c = s % n_chunks, k0 = c * kDK;
    // queries: kBT rows x 8 slots of 4 floats
    for (int i = tid; i < kBT * 8; i += kThreads) {
      const int r = i >> 3, sl = i & 7, col = k0 + 4 * sl;
      const int valid = b0 + r < p.B ? min(max(p.d - col, 0), 4) * 4 : 0;
      stage_slot(reinterpret_cast<char*>(qs + (buf * kBT + r) * kQS + 4 * sl),
                 qbase + (static_cast<size_t>(b0 + r) * p.d + col) * 4, qbase, valid,
                 p.q_vec);
    }
    // points: kCT rows x 8 slots of 4 floats, or 2 slots of 16 int8
    constexpr int kSlots = kF32 ? 8 : 2, kPer = kF32 ? 4 : 16;
    for (int i = tid; i < kCT * kSlots; i += kThreads) {
      const int r = i / kSlots, sl = i % kSlots, col = k0 + kPer * sl;
      const int valid =
          p0 + r < hi ? min(max(p.d - col, 0), kPer) * static_cast<int>(sizeof(T)) : 0;
      char* dst = reinterpret_cast<char*>(xs) + buf * kXStageBytes +
                  r * (kF32 ? kQS * 4 : kXS8) + 16 * sl;
      stage_slot(dst, xbase + (static_cast<size_t>(p0 + r) * p.d + col) * sizeof(T), xbase,
                 valid, p.x_vec);
    }
    if (c == 0 && tid < kCT / 4) {  // the tile's bias row, by tile parity
      const int valid = min(max(hi - (p0 + 4 * tid), 0), 4) * 4;
      cp_async<16>(smem_addr(bs + ((s / n_chunks) & 1) * kCT + 4 * tid),
                   valid > 0 ? p.bias + p0 + 4 * tid : p.bias, valid);
    }
  };

  float tot[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mi][ni][e] = 0.f;

  // One barrier a step: past it, step s has landed for every thread and
  // every warp is done with step s - 1, whose stage the copy of step s + 1
  // then refills while step s computes.
  if (n_steps > 0) prefetch(0);
  cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < n_steps) prefetch(s + 1);
    cp_async_commit();

    const int buf = s & 1;
    const float* qb = qs + buf * kBT * kQS + (wm * 32) * kQS;
    const unsigned char* xb = xs + buf * kXStageBytes;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* a = qb + (mi * 16 + g) * kQS + kk + t;
        split_tf32(a[0], ah[mi][0], al[mi][0]);
        split_tf32(a[8 * kQS], ah[mi][1], al[mi][1]);
        split_tf32(a[4], ah[mi][2], al[mi][2]);
        split_tf32(a[8 * kQS + 4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn * 32 + ni * 8 + g;
        uint32_t bh0, bh1, bl0 = 0, bl1 = 0;
        if constexpr (kF32) {
          const float* b = reinterpret_cast<const float*>(xb) + col * kQS + kk + t;
          split_tf32(b[0], bh0, bl0);
          split_tf32(b[4], bh1, bl1);
        } else {
          const signed char* b = reinterpret_cast<const signed char*>(xb) + col * kXS8 + kk + t;
          bh0 = __float_as_uint(static_cast<float>(b[0]));
          bh1 = __float_as_uint(static_cast<float>(b[4]));
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(acc[mi][ni], al[mi], bh0, bh1);
          if constexpr (kF32) mma_tf32(acc[mi][ni], ah[mi], bl0, bl1);
          mma_tf32(acc[mi][ni], ah[mi], bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[mi][ni][e] += acc[mi][ni][e];

    if (s % n_chunks != n_chunks - 1) continue;
    // ---- the tile is summed: biased, masked distances into shared memory.
    // A value that does not beat its row's k-th entry (read once per tile)
    // cannot enter the list during this tile, whose insertions only lower
    // that entry: it is stored as INF, and a row none of whose values pass
    // is not marked hot and skips its ballots. ----
    const int p0 = lo + (s / n_chunks) * kCT;
    const float* bt = bs + ((s / n_chunks) & 1) * kCT;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mi * 16 + g + 8 * h;
        float kd = ld[row * p.k + p.k - 1];
        int ki = li[row * p.k + p.k - 1];
        if (pa::key_less(gd[row], gi[row], kd, ki)) {
          kd = gd[row];
          ki = gi[row];
        }
        const int ex = excl[row];
        const bool live = b0 + row < p.B;
        bool any = false;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn * 32 + ni * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int id = p0 + col + e;
            const float bv = bt[col + e];
            const float dv = fmaf(p.scale, tot[mi][ni][2 * h + e], bv);
            const bool ok =
                live && id < hi && bv < pa::kInf && id != ex && pa::key_less(dv, id, kd, ki);
            v[e] = ok ? dv : pa::kInf;
            any |= ok;
            tot[mi][ni][2 * h + e] = 0.f;
          }
          *reinterpret_cast<float2*>(ds + row * kTS + col) = make_float2(v[0], v[1]);
        }
        if (any) hot[row] = 1;
      }
    }
    __syncthreads();

    // ---- selection: warp w keeps the lists of rows w, w + 8, ... ----
    // With S > 1, a row's full list publishes its k-th entry to p.thr
    // (atomicMin); every split's filter then uses the best one published:
    // a value beyond some list's k-th entry has k entries before it, so it
    // is not in the row's top-k. Lane j reads row warp + 8 j's entry now,
    // for the next tile.
    unsigned long long gkey = ~0ull;
    if (p.thr != nullptr && lane < kBT / 8 && b0 + warp + 8 * lane < p.B)
      gkey = __ldcg(p.thr + b0 + warp + 8 * lane);
    for (int row = warp; row < kBT; row += kThreads / 32) {
      if (!hot[row]) continue;  // warp-uniform; rows past B never pass
      float* rd = ld + row * p.k;
      int* ri = li + row * p.k;
      float td;
      int ti;
      if (p.k <= 32) {
        select_row_regs(rd, ri, ds + row * kTS, p0, p.k, lane, td, ti);
      } else {
        select_row_smem(rd, ri, ds + row * kTS, p0, p.k, lane, td, ti);
      }
      if (lane == 0) {
        hot[row] = 0;
        if (p.thr != nullptr && td < pa::kInf) atomicMin(p.thr + b0 + row, pack_key(td, ti));
      }
    }
    if (lane < kBT / 8) unpack_key(gkey, gd[warp + 8 * lane], gi[warp + 8 * lane]);
    // the next write of ds follows at least one more __syncthreads
  }
  __syncthreads();

  const int S = gridDim.y;
  for (int idx = tid; idx < kBT * p.k; idx += kThreads) {
    const int b = b0 + idx / p.k;
    if (b >= p.B) continue;
    const size_t o = (static_cast<size_t>(b) * S + blockIdx.y) * p.k + idx % p.k;
    const bool ok = ld[idx] < pa::kInf;
    p.out_d[o] = ok ? ld[idx] : pa::kInf;
    p.out_i[o] = ok ? li[idx] : -1;
  }
}

size_t smem_bytes(int k, bool x_int8) {
  const size_t stage_x = x_int8 ? kCT * kXS8 : kCT * kQS * 4;
  return 2 * (kBT * kQS * 4 + stage_x) + 2 * kCT * 4 + kBT * kTS * 4 +
         static_cast<size_t>(kBT) * k * 8;
}

}  // namespace

// CTAs of the kernel one SM holds at once at this k, for the wrapper's
// choice of splits.
extern "C" int pa_flat_topk_resident(int k, int x_int8, int* blocks) {
  const size_t smem = smem_bytes(k, x_int8 != 0);
  auto kernel = x_int8 ? &flat_topk_kernel<int8_t> : &flat_topk_kernel<float>;
  cudaError_t err = pa::allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
  return static_cast<int>(err);
}

extern "C" int pa_flat_topk(const void* q, const void* x, const void* bias,
                            const void* exclude, void* thr, int B, int n, int d, int k,
                            float scale, int x_int8, int splits, int per_split, int q_vec,
                            int x_vec, void* out_d, void* out_i, void* stream) {
  if (B == 0) return 0;
  Params p;
  p.q = static_cast<const float*>(q);
  p.x = x;
  p.bias = static_cast<const float*>(bias);
  p.exclude = static_cast<const int*>(exclude);
  p.thr = static_cast<unsigned long long*>(thr);
  p.B = B;
  p.n = n;
  p.d = d;
  p.k = k;
  p.per_split = per_split;
  p.q_vec = q_vec;
  p.x_vec = x_vec;
  p.scale = scale;
  p.out_d = static_cast<float*>(out_d);
  p.out_i = static_cast<int*>(out_i);
  const size_t smem = smem_bytes(k, x_int8 != 0);
  auto kernel = x_int8 ? &flat_topk_kernel<int8_t> : &flat_topk_kernel<float>;
  cudaError_t err = pa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  if (thr != nullptr) {  // every row starts with no published entry (~0)
    err = cudaMemsetAsync(thr, 0xff, sizeof(unsigned long long) * B, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + kBT - 1) / kBT, splits);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
