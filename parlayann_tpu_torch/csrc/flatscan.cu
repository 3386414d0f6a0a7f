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
// Distance algebra (flat.py:44-55 and flatscan.py:28-31): the kernel
// selects on fmaf(s, q.x, b[x]) with s = -2 (L2) or -1 (MIPS) and a bias
// b[x] = ||x||^2 (L2) or 0 (MIPS), and the wrapper adds ||q||^2 back.
// Unmasked, the caller passes the bias row, INF where the point is invalid
// (id >= n_valid). Masked (valid_mask given), the kernel's own compaction
// pass builds it (below).
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
// ... in shared memory. k <= 32: a ballot per 32 columns collects the
// candidates that beat the row's k-th entry, and each is inserted into the
// list, held in the warp's registers while a tile merges (a ballot finds
// the place, a shuffle moves the tail). 32 < k <= 128: the list is loaded
// into C = 2 (k <= 64) or 4 registers a lane, the tile's survivors are
// gathered in column order into the warp's scratch, sorted descending 32 or
// 32 C at a time (warp.cuh's warp_sort_desc) and merged into the list
// (warp_merge): one network a batch, not one serial insertion a candidate.
// k > 128: each candidate is inserted in shared memory (the warp counts
// its place and shifts the tail one chunk of 32 at a time).
//
// Masked mode (valid_mask given: HNSW's exact scans over a level's inserted
// members, the exact-candidate Vamana build over the inserted prefix). The
// mask may keep a few hundred of 100K points, or half of a level of a few
// thousand; scanning every point and dropping the masked ones through an
// INF bias multiplied each of them on the tensor cores, and a split floor
// made for 100K points left 32 CTAs on 132 SMs at 2,000 rows over 5,256
// points. So:
//  - two compaction passes over the ids below n_valid (compact_count,
//    compact_scatter) write the valid ids in ascending order (mask set,
//    and for L2 a finite ||x||^2, summed in f64 from the rows of the mask
//    only: exact on int8 rows), their bias in the same order and their
//    count, all in device memory; the host never reads the count.
//  - the scan reads rows by id: each tile's 128 ids come into a ring of
//    three shared-memory slots one tile ahead (cp.async), the rows' 16-byte
//    slots are copied from each row's own address, the bias from the
//    compacted row. Exclusion and the list entries use the global id;
//    the compacted order is ascending, so the (distance, id) order holds.
//  - the splits cut the compacted order, not the id range: split s takes
//    tiles [s t, (s + 1) t) with t = max(min_tiles, ceil(tiles / S)),
//    computed on the card from the count (masked_split_tiles); a CTA whose
//    split starts past the count exits at once (split 0 always writes).
//    The wrapper picks S for waves over the card from B and n_valid, and
//    min_tiles from k, so a few thousand points fill the card.
//  - merge_splits_kernel, one warp a row, merges the lists of the splits
//    that hold points (descending batches, warp_merge of up to 8
//    registers a lane): the empty splits cost neither writes nor a sort.
//
// Shared memory (bytes): stages 2 x 64 x 36 x 4 = 18432 (queries) plus
// 2 x 128 x 36 x 4 = 36864 (f32 points) or 2 x 128 x 48 = 12288 (int8);
// bias 2 x 128 x 4 = 1024; masked, the id ring 3 x 128 x 4 = 1536; tile
// 64 x 136 x 4 = 34816; 32 < k <= 128, the survivor scratch 8 x 128 x 8 =
// 8192; lists 64 x k x 8 (131072 at k = 256); 1024 of per-row state. f32
// at k = 256: 223232 of the 232448 a block may use, one CTA per SM; at
// k = 10: 97280, two CTAs per SM; masked int8 at k = 64: 109056, two.

#include <algorithm>
#include <climits>
#include <type_traits>

#include "tf32.cuh"
#include "warp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 64;    // queries per CTA
constexpr int kCT = 128;   // points per tile
constexpr int kDK = 32;    // dimensions per stage
constexpr int kQS = kDK + 4;     // f32 row stride of a stage, floats
constexpr int kXS8 = kDK + 16;   // int8 row stride of a stage, bytes
constexpr int kTS = kCT + 8;     // row stride of the distance tile, floats
constexpr int kScanIds = 4 * kThreads;  // ids a CTA of the compaction scans

struct Params {
  const float* q;      // (B, d) f32
  const void* x;       // (n, d) f32 or int8
  const float* bias;   // unmasked: (n,) by id, INF where invalid; masked: by position
  const int* ids;      // masked: the valid ids, ascending (position -> id)
  const int* count;    // masked: how many, in device memory
  const int* exclude;  // (B,) int32 or null
  unsigned long long* thr;  // (B,) best published k-th key per row, or null (S = 1)
  int B, n, d, k;
  int per_split;       // unmasked: points per split, a multiple of kCT; masked: fewest tiles
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

// Registers a lane of the selection's list network: 1 for k <= 32 (the
// insertion path), 2 or 4 for the sort-and-merge path, 0 for k > 128 (the
// shared-memory insertion).
constexpr int select_regs(int k) { return k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : 0; }

// Masked mode: the tiles a split scans, from the device count. The
// wrapper's split_ranges mirrors this rule.
__host__ __device__ inline int masked_split_tiles(int count, int S, int min_tiles) {
  const int tiles = (count + kCT - 1) / kCT;
  const int even = (tiles + S - 1) / S;
  return even > min_tiles ? even : min_tiles;
}

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
// list; `id_of(c)` is column c's id. Each selection leaves the k-th entry
// in (td, ti).
//
// k <= 32: lane j holds entry j in registers while the tile is merged; a
// ballot per 32 columns collects the candidates that beat the k-th entry,
// and each is inserted in turn: a ballot for its place and a shuffle of the
// tail up by one.
template <typename IdOf>
__device__ __forceinline__ void select_row_regs(float* rd, int* ri, const float* row,
                                                IdOf id_of, int k, int lane, float& td,
                                                int& ti) {
  float ed = lane < k ? rd[lane] : pa::kInf;
  int ei = lane < k ? ri[lane] : INT_MAX;
  td = __shfl_sync(pa::kFullMask, ed, k - 1);
  ti = __shfl_sync(pa::kFullMask, ei, k - 1);
  for (int h = 0; h < kCT; h += 32) {
    const float cd = row[h + lane];
    const int cid = id_of(h + lane);
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

// The k-th entry (element k - 1 = 32 r + l) of a list in C registers a lane.
template <int C>
__device__ __forceinline__ void list_kth(const float (&d)[C], const int (&p)[C], int k,
                                         float& td, int& ti) {
  const int r = (k - 1) >> 5;
  float v = d[0];
  int w = p[0];
#pragma unroll
  for (int i = 1; i < C; ++i) {
    if (r == i) {
      v = d[i];
      w = p[i];
    }
  }
  td = __shfl_sync(pa::kFullMask, v, (k - 1) & 31);
  ti = __shfl_sync(pa::kFullMask, w, (k - 1) & 31);
}

// Insert (vd, vi) into a sorted list in C registers a lane (element 32 r +
// lane in register r): count its place, then move every element at or past
// it up one, the top register first; the last element drops off.
template <int C>
__device__ __forceinline__ void list_insert(float (&d)[C], int (&p)[C], float vd, int vi,
                                            int lane) {
  int pos = 0;
#pragma unroll
  for (int r = 0; r < C; ++r)
    pos += __popc(__ballot_sync(pa::kFullMask, pa::key_less(d[r], p[r], vd, vi)));
#pragma unroll
  for (int r = C - 1; r >= 0; --r) {
    float ud = __shfl_up_sync(pa::kFullMask, d[r], 1);
    int ui = __shfl_up_sync(pa::kFullMask, p[r], 1);
    if (r > 0) {  // lane 0 takes the previous register's last element
      const float cd = __shfl_sync(pa::kFullMask, d[r > 0 ? r - 1 : 0], 31);
      const int ci = __shfl_sync(pa::kFullMask, p[r > 0 ? r - 1 : 0], 31);
      if (lane == 0) {
        ud = cd;
        ui = ci;
      }
    }
    const int i = 32 * r + lane;
    if (i == pos) {
      d[r] = vd;
      p[r] = vi;
    } else if (i > pos) {
      d[r] = ud;
      p[r] = ui;
    }
  }
}

// Survivors a row's tile may have for select_row_net to insert them one at
// a time; more are sorted and merged.
constexpr int kInsertMax = 8;

// 32 < k <= 32 C: the list (element 32 r + lane in register r, INF past k)
// sits in C registers while a tile merges. A ballot per 32 columns counts
// the candidates that beat the k-th entry. Up to kInsertMax of them are
// inserted one at a time (list_insert). More are gathered in column order
// into the warp's scratch (sd, si: kCT slots) and merged a batch at a time:
// up to 32 survivors are sorted descending in one register and replace the
// list's last register where smaller (the list's other elements face INF
// padding), more are sorted 32 C at a time against the whole list; either
// way the result is a bitonic sequence of the 32 C smallest, which
// warp_merge sorts.
template <int C, typename IdOf>
__device__ __forceinline__ void select_row_net(float* rd, int* ri, const float* row,
                                               IdOf id_of, int k, int lane, float* sd,
                                               int* si, float& td, int& ti) {
  float ed[C];
  int ei[C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    const int j = 32 * r + lane;
    ed[r] = j < k ? rd[j] : pa::kInf;
    ei[r] = j < k ? ri[j] : INT_MAX;
  }
  list_kth<C>(ed, ei, k, td, ti);
  constexpr int kChunks = kCT / 32;
  float cd[kChunks];
  int cid[kChunks];
  unsigned m[kChunks];
  int n = 0;
#pragma unroll
  for (int h = 0; h < kChunks; ++h) {
    cd[h] = row[32 * h + lane];
    cid[h] = id_of(32 * h + lane);
    m[h] = __ballot_sync(pa::kFullMask,
                         cd[h] < pa::kInf && pa::key_less(cd[h], cid[h], td, ti));
    n += __popc(m[h]);
  }
  if (n <= kInsertMax) {
#pragma unroll
    for (int h = 0; h < kChunks; ++h) {
      unsigned mask = m[h];
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float vd = __shfl_sync(pa::kFullMask, cd[h], src);
        const int vi = __shfl_sync(pa::kFullMask, cid[h], src);
        if (!pa::key_less(vd, vi, td, ti)) continue;  // the k-th entry improved
        list_insert<C>(ed, ei, vd, vi, lane);
        list_kth<C>(ed, ei, k, td, ti);
      }
    }
  } else {
    const unsigned below = (1u << lane) - 1u;
    int at = 0;
#pragma unroll
    for (int h = 0; h < kChunks; ++h) {
      if ((m[h] >> lane) & 1u) {
        sd[at + __popc(m[h] & below)] = cd[h];
        si[at + __popc(m[h] & below)] = cid[h];
      }
      at += __popc(m[h]);
    }
    __syncwarp();
    for (int b = 0; b < n;) {
      if (n - b <= 32) {
        float bd[1] = {lane < n - b ? sd[b + lane] : pa::kInf};
        int bi[1] = {lane < n - b ? si[b + lane] : INT_MAX};
        pa::warp_sort_desc<1>(bd, bi, lane);
        if (pa::key_less(bd[0], bi[0], ed[C - 1], ei[C - 1])) {
          ed[C - 1] = bd[0];
          ei[C - 1] = bi[0];
        }
        b += 32;
      } else {
        float bd[C];
        int bi[C];
#pragma unroll
        for (int r = 0; r < C; ++r) {
          const int j = b + 32 * r + lane;
          bd[r] = j < n ? sd[j] : pa::kInf;
          bi[r] = j < n ? si[j] : INT_MAX;
        }
        pa::warp_sort_desc<C>(bd, bi, lane);
#pragma unroll
        for (int r = 0; r < C; ++r) {
          if (pa::key_less(bd[r], bi[r], ed[r], ei[r])) {
            ed[r] = bd[r];
            ei[r] = bi[r];
          }
        }
        b += 32 * C;
      }
      pa::warp_merge<C>(ed, ei, lane);
    }
    list_kth<C>(ed, ei, k, td, ti);
  }
#pragma unroll
  for (int r = 0; r < C; ++r) {
    const int j = 32 * r + lane;
    if (j < k) {
      rd[j] = ed[r];
      ri[j] = ei[r];
    }
  }
  __syncwarp();
}

// k > 128: the list stays in shared memory; the warp counts the insertion's
// place and shifts the tail up one chunk of 32 at a time.
template <typename IdOf>
__device__ __forceinline__ void select_row_smem(float* rd, int* ri, const float* row,
                                                IdOf id_of, int k, int lane, float& td,
                                                int& ti) {
  td = rd[k - 1];
  ti = ri[k - 1];
  for (int h = 0; h < kCT; h += 32) {
    const float cd = row[h + lane];
    const int cid = id_of(h + lane);
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

// C: select_regs(k). kMasked: the scan reads the compacted ids (Params.ids).
template <typename T, int C, bool kMasked>
__global__ void __launch_bounds__(kThreads, 2) flat_topk_kernel(Params p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kNet = C == 2 || C == 4;
  constexpr int kXStageBytes = kF32 ? kCT * kQS * 4 : kCT * kXS8;
  const int tid = threadIdx.x;
  int lo, hi;  // the split's points (masked: positions in the compacted order)
  if constexpr (kMasked) {
    const int cnt = *p.count;
    const long long span =
        static_cast<long long>(masked_split_tiles(cnt, gridDim.y, p.per_split)) * kCT;
    const long long l = blockIdx.y * span;
    lo = static_cast<int>(min(l, static_cast<long long>(cnt)));
    hi = static_cast<int>(min(l + span, static_cast<long long>(cnt)));
    if (blockIdx.y > 0 && lo >= hi) return;  // the merge reads only splits with points
  } else {
    lo = blockIdx.y * p.per_split;
    hi = min(p.n, lo + p.per_split);
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);                  // 2 x kBT x kQS
  unsigned char* xs = smem_raw + 2 * kBT * kQS * 4;                // 2 x kXStageBytes
  float* bs = reinterpret_cast<float*>(xs + 2 * kXStageBytes);     // 2 x kCT
  int* ring = reinterpret_cast<int*>(bs + 2 * kCT);                // masked: 3 x kCT ids
  float* ds = reinterpret_cast<float*>(ring + (kMasked ? 3 * kCT : 0));  // kBT x kTS
  float* sd = ds + kBT * kTS;                                      // 8 x kCT survivors
  int* si = reinterpret_cast<int*>(sd + (kNet ? 8 * kCT : 0));
  float* ld = reinterpret_cast<float*>(si + (kNet ? 8 * kCT : 0));  // kBT x k distances
  int* li = reinterpret_cast<int*>(ld + kBT * p.k);                // kBT x k ids
  __shared__ int excl[kBT];
  __shared__ int hot[kBT];  // rows with a value that beat the k-th entry
  __shared__ float gd[kBT];  // the best k-th entry another split published
  __shared__ int gi[kBT];

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const int b0 = blockIdx.x * kBT;
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

  // masked: copy the ids of the tile at position q0 into ring slot `slot`
  // (threads [t0, t0 + kCT / 4), 16 bytes each, zeros past the split)
  auto copy_ids = [&](int q0, int slot, int t0) {
    if (tid >= t0 && tid < t0 + kCT / 4) {
      const int at = q0 + 4 * (tid - t0);
      const int valid = min(max(hi - at, 0), 4) * 4;
      cp_async<16>(smem_addr(ring + slot * kCT + 4 * (tid - t0)),
                   valid > 0 ? p.ids + at : p.ids, valid);
    }
  };
  if constexpr (kMasked) {  // tile 0's ids, before its rows can be copied
    if (n_steps > 0) copy_ids(lo, 0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }

  // queue the copies of step s (tile s / n_chunks, chunk s % n_chunks);
  // masked, chunk 0 of tile u also brings tile u + 1's ids
  auto prefetch = [&](int s) {
    const int buf = s & 1;
    const int u = s / n_chunks, c = s % n_chunks, k0 = c * kDK;
    const int p0 = lo + u * kCT;
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
    const int* tids = ring + (u % 3) * kCT;
    for (int i = tid; i < kCT * kSlots; i += kThreads) {
      const int r = i / kSlots, sl = i % kSlots, col = k0 + kPer * sl;
      const bool in = p0 + r < hi;
      int row = p0 + r;
      if constexpr (kMasked) row = in ? tids[r] : 0;
      const int valid = in ? min(max(p.d - col, 0), kPer) * static_cast<int>(sizeof(T)) : 0;
      char* dst = reinterpret_cast<char*>(xs) + buf * kXStageBytes +
                  r * (kF32 ? kQS * 4 : kXS8) + 16 * sl;
      stage_slot(dst, xbase + (static_cast<size_t>(row) * p.d + col) * sizeof(T), xbase,
                 valid, p.x_vec);
    }
    if (c == 0 && tid < kCT / 4) {  // the tile's bias row, by tile parity
      const int valid = min(max(hi - (p0 + 4 * tid), 0), 4) * 4;
      cp_async<16>(smem_addr(bs + (u & 1) * kCT + 4 * tid),
                   valid > 0 ? p.bias + p0 + 4 * tid : p.bias, valid);
    }
    if constexpr (kMasked) {
      if (c == 0 && p0 + kCT < hi) copy_ids(p0 + kCT, (u + 1) % 3, kCT / 4);
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
  // then refills while step s computes. Masked, tile u's ids (copied with
  // tile u - 1's first chunk) have landed before its first chunk's copy is
  // queued, and its ring slot is next written with tile u + 3's, after
  // tile u's selection.
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
    const int u = s / n_chunks;
    const int p0 = lo + u * kCT;
    const float* bt = bs + (u & 1) * kCT;
    const int* tids = ring + (u % 3) * kCT;
    auto id_of = [&](int col) {
      if constexpr (kMasked) {
        return tids[col];
      } else {
        return p0 + col;
      }
    };
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
            const int id = id_of(col + e);
            const float bv = bt[col + e];
            const float dv = fmaf(p.scale, tot[mi][ni][2 * h + e], bv);
            const bool ok = live && p0 + col + e < hi && bv < pa::kInf && id != ex &&
                            pa::key_less(dv, id, kd, ki);
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
      const float* dr = ds + row * kTS;
      float td;
      int ti;
      if constexpr (C == 1) {
        select_row_regs(rd, ri, dr, id_of, p.k, lane, td, ti);
      } else if constexpr (kNet) {
        select_row_net<C>(rd, ri, dr, id_of, p.k, lane, sd + warp * kCT, si + warp * kCT,
                          td, ti);
      } else {
        select_row_smem(rd, ri, dr, id_of, p.k, lane, td, ti);
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

size_t smem_bytes(int k, bool x_int8, bool masked) {
  const size_t stage_x = x_int8 ? kCT * kXS8 : kCT * kQS * 4;
  const int c = select_regs(k);
  return 2 * (kBT * kQS * 4 + stage_x) + 2 * kCT * 4 + (masked ? 3 * kCT * 4 : 0) +
         kBT * kTS * 4 + (c == 2 || c == 4 ? 2 * 8 * kCT * 4 : 0) +
         static_cast<size_t>(kBT) * k * 8;
}

using KernelFn = void (*)(Params);

template <typename T, bool M>
KernelFn kernel_of(int k) {
  switch (select_regs(k)) {
    case 1:
      return &flat_topk_kernel<T, 1, M>;
    case 2:
      return &flat_topk_kernel<T, 2, M>;
    case 4:
      return &flat_topk_kernel<T, 4, M>;
    default:
      return &flat_topk_kernel<T, 0, M>;
  }
}

KernelFn kernel_for(int k, bool x_int8, bool masked) {
  if (x_int8) return masked ? kernel_of<int8_t, true>(k) : kernel_of<int8_t, false>(k);
  return masked ? kernel_of<float, true>(k) : kernel_of<float, false>(k);
}

// ---- masked mode: compaction and the merge of the splits ----

// ||x||^2 of one row of d values (16-byte chunks, loads of `vec` bytes):
// int8 exactly (dp4a), f32 summed in f64 and rounded once.
template <typename T>
__device__ __forceinline__ float row_norm(const T* row, int d, int vec) {
  const int nbytes = d * static_cast<int>(sizeof(T));
  const int nch = (nbytes + 15) / 16;
  if constexpr (sizeof(T) == 1) {
    int acc = 0;
    for (int c = 0; c < nch; ++c) {
      const int4 w = pa::load_chunk(row, c, nbytes, vec);
      acc = __dp4a(w.x, w.x, __dp4a(w.y, w.y, __dp4a(w.z, w.z, __dp4a(w.w, w.w, acc))));
    }
    return static_cast<float>(acc);
  } else {
    double acc = 0.0;
    for (int c = 0; c < nch; ++c) {
      const int4 w = pa::load_chunk(row, c, nbytes, vec);
      const float v[4] = {__int_as_float(w.x), __int_as_float(w.y), __int_as_float(w.z),
                          __int_as_float(w.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) acc += static_cast<double>(v[i]) * v[i];
    }
    return static_cast<float>(acc);
  }
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  v = pa::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Pass 1: each CTA takes kScanIds ids (4 a thread); for those in the mask
// below n_valid it writes ||x||^2 (L2) to norm[id] and counts the valid
// ones (L2: a norm below INF) into counts[cta].
template <typename T>
__global__ void __launch_bounds__(kThreads) compact_count(const unsigned char* mask,
                                                          const T* x, int n_valid, int d,
                                                          int vec, int l2, float* norm,
                                                          int* counts) {
  __shared__ int red[kThreads / 32];
  const int base = blockIdx.x * kScanIds + 4 * threadIdx.x;
  int c = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int id = base + j;
    if (id < n_valid && mask[id]) {
      if (l2) {
        const float v = row_norm<T>(x + static_cast<size_t>(id) * d, d, vec);
        norm[id] = v;
        c += v < pa::kInf;
      } else {
        c += 1;
      }
    }
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// Pass 2: each CTA adds the counts of the CTAs before it, scans its own
// ids' flags, and writes the valid ids in ascending order with their bias
// (||x||^2 or 0); the last CTA writes the total count.
__global__ void __launch_bounds__(kThreads) compact_scatter(const unsigned char* mask,
                                                            const float* norm, int n_valid,
                                                            int l2, const int* counts,
                                                            int* ids, float* bias,
                                                            int* count) {
  __shared__ int red[kThreads / 32];
  __shared__ int warp_off[kThreads / 32];
  int before = 0;
  for (int i = threadIdx.x; i < static_cast<int>(blockIdx.x); i += kThreads) before += counts[i];
  before = block_sum(before, red);
  const int base = blockIdx.x * kScanIds + 4 * threadIdx.x;
  bool ok[4];
  int c = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int id = base + j;
    ok[j] = id < n_valid && mask[id] && (!l2 || norm[id] < pa::kInf);
    c += ok[j];
  }
  // exclusive scan of c over the CTA: within the warp, then across warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(pa::kFullMask, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      warp_off[w] = run;
      run += red[w];
    }
    if (blockIdx.x == gridDim.x - 1) *count = before + run;
  }
  __syncthreads();
  int at = before + warp_off[warp] + incl - c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (ok[j]) {
      ids[at] = base + j;
      bias[at] = l2 ? norm[base + j] : 0.f;
      ++at;
    }
  }
}

// One warp a row: the sorted (distance, id) lists of the splits that hold
// points, merged into the row's k smallest. Each split's list comes in as
// a descending batch of 32 C (INF past k), replaces the running list's
// elements where smaller, and warp_merge sorts the bitonic result.
template <int C>
__global__ void __launch_bounds__(kThreads) merge_splits_kernel(
    const float* in_d, const int* in_i, const int* count, int B, int S, int k,
    int min_tiles, float* out_d, int* out_i) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int cnt = *count;
  const int tiles = (cnt + kCT - 1) / kCT;
  const int span = masked_split_tiles(cnt, S, min_tiles);
  const int active = (tiles + span - 1) / span;
  float ed[C];
  int ei[C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    ed[r] = pa::kInf;
    ei[r] = INT_MAX;
  }
  for (int s = 0; s < active; ++s) {
    const size_t base = (static_cast<size_t>(b) * S + s) * k;
    float cd[C];
    int ci[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const int j = 32 * C - 1 - (32 * r + lane);
      const float v = j < k ? in_d[base + j] : pa::kInf;
      cd[r] = v < pa::kInf ? v : pa::kInf;
      ci[r] = v < pa::kInf ? in_i[base + j] : INT_MAX;
    }
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (pa::key_less(cd[r], ci[r], ed[r], ei[r])) {
        ed[r] = cd[r];
        ei[r] = ci[r];
      }
    }
    pa::warp_merge<C>(ed, ei, lane);
  }
#pragma unroll
  for (int r = 0; r < C; ++r) {
    const int j = 32 * r + lane;
    if (j < k) {
      const bool ok = ed[r] < pa::kInf;
      out_d[static_cast<size_t>(b) * k + j] = ok ? ed[r] : pa::kInf;
      out_i[static_cast<size_t>(b) * k + j] = ok ? ei[r] : -1;
    }
  }
}

cudaError_t launch_merge(const float* in_d, const int* in_i, const int* count, int B, int S,
                         int k, int min_tiles, float* out_d, int* out_i, cudaStream_t st) {
  const int grid = (B + kThreads / 32 - 1) / (kThreads / 32);
  if (k <= 32) {
    merge_splits_kernel<1><<<grid, kThreads, 0, st>>>(in_d, in_i, count, B, S, k, min_tiles,
                                                      out_d, out_i);
  } else if (k <= 64) {
    merge_splits_kernel<2><<<grid, kThreads, 0, st>>>(in_d, in_i, count, B, S, k, min_tiles,
                                                      out_d, out_i);
  } else if (k <= 128) {
    merge_splits_kernel<4><<<grid, kThreads, 0, st>>>(in_d, in_i, count, B, S, k, min_tiles,
                                                      out_d, out_i);
  } else {
    merge_splits_kernel<8><<<grid, kThreads, 0, st>>>(in_d, in_i, count, B, S, k, min_tiles,
                                                      out_d, out_i);
  }
  return cudaGetLastError();
}

Params make_params(const void* q, const void* x, const void* bias, const void* exclude,
                   void* thr, int B, int n, int d, int k, float scale, int per_split,
                   int q_vec, int x_vec, void* out_d, void* out_i) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.x = x;
  p.bias = static_cast<const float*>(bias);
  p.ids = nullptr;
  p.count = nullptr;
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
  return p;
}

// Reset the splits' shared thresholds (S > 1) and launch the scan.
cudaError_t launch_scan(const Params& p, bool x_int8, bool masked, int splits,
                        cudaStream_t st) {
  const size_t smem = smem_bytes(p.k, x_int8, masked);
  const KernelFn kernel = kernel_for(p.k, x_int8, masked);
  cudaError_t err = pa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (p.thr != nullptr) {  // every row starts with no published entry (~0)
    err = cudaMemsetAsync(p.thr, 0xff, sizeof(unsigned long long) * p.B, st);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.B + kBT - 1) / kBT, splits);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// CTAs of the kernel one SM holds at once at this k, for the wrapper's
// choice of splits.
extern "C" int pa_flat_topk_resident(int k, int x_int8, int masked, int* blocks) {
  const size_t smem = smem_bytes(k, x_int8 != 0, masked != 0);
  const KernelFn kernel = kernel_for(k, x_int8 != 0, masked != 0);
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
  const Params p = make_params(q, x, bias, exclude, thr, B, n, d, k, scale, per_split, q_vec,
                               x_vec, out_d, out_i);
  return static_cast<int>(
      launch_scan(p, x_int8 != 0, false, splits, static_cast<cudaStream_t>(stream)));
}

// Compaction CTAs for n_valid ids, and the masked mode's workspace in
// int32 words: the compacted ids, their bias and the norms (n_valid each,
// rounded up to 4 words so each starts 16-byte aligned), then the per-CTA
// counts and the count.
static int scan_grid(int n_valid) {
  return n_valid > 0 ? (n_valid + kScanIds - 1) / kScanIds : 1;
}

static long long masked_slot(int n_valid) { return (std::max(n_valid, 1) + 3LL) / 4 * 4; }

extern "C" long long pa_flat_topk_masked_scratch(int n_valid) {
  return 3 * masked_slot(n_valid) + scan_grid(n_valid) + 1;
}

// Masked mode: compact the valid ids of `mask` ((n_valid,) bytes read)
// into the workspace `ws` (pa_flat_topk_masked_scratch(n_valid) words),
// scan them in `splits` splits of at least `min_tiles` tiles into
// (B, splits, k) `out_d` / `out_i`, and with splits > 1 merge the splits
// that hold points into (B, k) `fin_d` / `fin_i`. Nothing is read back to
// the host.
extern "C" int pa_flat_topk_masked(const void* q, const void* x, const void* mask,
                                   const void* exclude, void* ws, long long ws_ints, void* thr,
                                   int B, int n_valid, int d, int k, float scale, int x_int8,
                                   int l2, int splits, int min_tiles, int q_vec, int x_vec,
                                   void* out_d, void* out_i, void* fin_d, void* fin_i,
                                   void* stream) {
  if (B == 0) return 0;
  if (n_valid < 0 || ws_ints < pa_flat_topk_masked_scratch(n_valid))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int grid = scan_grid(n_valid);
  const long long na = masked_slot(n_valid);
  int* const ids = static_cast<int*>(ws);
  float* const bias = reinterpret_cast<float*>(ids + na);
  float* const norm = bias + na;
  int* const counts = ids + 3 * na;
  int* const count = counts + grid;
  const auto* m = static_cast<const unsigned char*>(mask);
  const int vec = pa::widest_load(x, d * (x_int8 ? 1 : 4));
  if (x_int8) {
    compact_count<int8_t><<<grid, kThreads, 0, st>>>(m, static_cast<const int8_t*>(x), n_valid,
                                                     d, vec, l2, norm, counts);
  } else {
    compact_count<float><<<grid, kThreads, 0, st>>>(m, static_cast<const float*>(x), n_valid,
                                                    d, vec, l2, norm, counts);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_scatter<<<grid, kThreads, 0, st>>>(m, norm, n_valid, l2, counts, ids, bias, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p = make_params(q, x, bias, exclude, thr, B, n_valid, d, k, scale, min_tiles, q_vec,
                         x_vec, out_d, out_i);
  p.ids = ids;
  p.count = count;
  err = launch_scan(p, x_int8 != 0, true, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(launch_merge(static_cast<const float*>(out_d),
                                       static_cast<const int*>(out_i),
                                       count, B, splits, k, min_tiles,
                                       static_cast<float*>(fin_d), static_cast<int*>(fin_i),
                                       st));
}
