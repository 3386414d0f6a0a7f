// Warp-level pieces of the one-warp-a-query walks: kernel 3 (fusedbeam.cu)
// and kernel 5 (clusterbeam.cu). The query's staging and the scoring of 32
// rows (16-byte chunk loads, the 8-lane reduce-scatter that gives each lane
// its own row's sum), bitonic networks over a warp's registers and over a
// warp's shared memory, and the size of a persistent grid. Keys are
// (distance, pack) pairs compared lexicographically (pa::key_less).
// Everything here is inline: several kernel files include it into one
// library.
//
// The f32 sums have one fixed order, which a plain version can replay
// (ops/distance.py:gathered_lane_order): the 16-byte chunks of a row go to
// 8 sub-lanes (chunk k to sub-lane k % 8); each sub-lane adds its chunks'
// terms in order, one rounded multiply and one rounded add a term (no
// fused multiply-add), from 0; then the 8 partial sums p0..p7 are added as
// ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)).
#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace pa {

// A byte b + 128 placed under the exponent of 2^23 is the float 2^23 + b +
// 128, so one subtraction of kMagic recovers b exactly.
constexpr float kMagic = 8388736.0f;  // 2^23 + 128

// 16 bytes of a row of `nbytes` bytes, starting at byte 16 c, zeros past
// the row. `vec` is the widest load the row's alignment allows (16, 8, 4
// or 1); `nbytes` is a multiple of it.
__device__ __forceinline__ int4 load_chunk(const void* row_, int c, int nbytes, int vec) {
  const int8_t* row = static_cast<const int8_t*>(row_);
  const int base = 16 * c;
  if (vec == 16) return __ldg(reinterpret_cast<const int4*>(row) + c);
  if (vec == 8) {
    const int2* r = reinterpret_cast<const int2*>(row + base);
    const int2 a = __ldg(r);  // a chunk that starts inside the row has 8 bytes
    const int2 b = base + 8 < nbytes ? __ldg(r + 1) : make_int2(0, 0);
    return make_int4(a.x, a.y, b.x, b.y);
  }
  if (vec == 4) {
    const int* r = reinterpret_cast<const int*>(row + base);
    return make_int4(__ldg(r), base + 4 < nbytes ? __ldg(r + 1) : 0,
                     base + 8 < nbytes ? __ldg(r + 2) : 0, base + 12 < nbytes ? __ldg(r + 3) : 0);
  }
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned x = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = base + 4 * k + j;
      if (t < nbytes) x |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(row + t))) << (8 * j);
    }
    w[k] = x;
  }
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
                   static_cast<int>(w[3]));
}

// Four int8 values of word w against four f32 query values, in order.
__device__ __forceinline__ void acc_word(float& acc, int w, float4 q, bool mips) {
  const unsigned x = static_cast<unsigned>(w) ^ 0x80808080u;
  const float v[4] = {__int_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) - kMagic,
                      __int_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) - kMagic,
                      __int_as_float(__byte_perm(x, 0x4B000000u, 0x7442)) - kMagic,
                      __int_as_float(__byte_perm(x, 0x4B000000u, 0x7443)) - kMagic};
  const float qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // MIPS: acc += v q; L2: acc += (v - q)^2
    const float t = mips ? v[i] : v[i] - qs[i];
    acc = __fadd_rn(acc, __fmul_rn(t, mips ? qs[i] : t));
  }
}

// Four f32 values of x against four query values, in order.
__device__ __forceinline__ void acc_f32(float& acc, int4 x, float4 q, bool mips) {
  const float v[4] = {__int_as_float(x.x), __int_as_float(x.y), __int_as_float(x.z),
                      __int_as_float(x.w)};
  const float qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = mips ? v[i] : v[i] - qs[i];
    acc = __fadd_rn(acc, __fmul_rn(t, mips ? qs[i] : t));
  }
}

// The 8 lanes of a group reduce 8 partial sums each so that sub-lane s
// ends with the total of value s: three butterfly stages, each lane keeping
// the half its bit selects and sending the other (4 + 2 + 1 shuffles). The
// tree is the same for every value, so a value's total does not depend on
// which lane ends with it.
template <typename T>
__device__ __forceinline__ T reduce_scatter8(const T (&a)[8], int s) {
  T h[4], r[2];
  bool up = (s & 4) != 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = (up ? a[4 + i] : a[i]) + __shfl_xor_sync(kFullMask, up ? a[i] : a[4 + i], 4);
  up = (s & 2) != 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    r[i] = (up ? h[2 + i] : h[i]) + __shfl_xor_sync(kFullMask, up ? h[i] : h[2 + i], 2);
  up = (s & 1) != 0;
  return (up ? r[1] : r[0]) + __shfl_xor_sync(kFullMask, up ? r[0] : r[1], 1);
}

// ---- the query and the scoring of 32 rows ----

// The warp's query, zero-padded to nch 16-byte chunks of the rows' element
// type T: f32 values and, for int8 rows when every value is an integer in
// [-128, 127], the same values as int8 with their sum of squares.
struct Query {
  const float* qf;
  const int8_t* qi;
  int qq;
  bool int_q;
};

// Stage query qg of d values into the warp's qf (16 / sizeof(T) nch floats)
// and, for int8 rows, qi (as many bytes).
template <typename T>
__device__ __forceinline__ Query stage_query(const float* qg, int d, int nch, float* qf,
                                             int8_t* qi, int lane) {
  constexpr int kPer = 16 / sizeof(T);  // values a chunk
  bool ok = true;
  int qq = 0;
  for (int t = lane; t < kPer * nch; t += 32) {
    const float x = t < d ? qg[t] : 0.f;
    qf[t] = x;
    if constexpr (sizeof(T) == 1) {
      const bool in = x == rintf(x) && x >= -128.f && x <= 127.f;
      const int xi = in ? static_cast<int>(x) : 0;
      qi[t] = static_cast<int8_t>(xi);
      ok &= in;
      qq += xi * xi;
    }
  }
  Query q;
  q.qf = qf;
  q.qi = qi;
  q.int_q = sizeof(T) == 1 && __all_sync(kFullMask, ok);
  q.qq = warp_sum(qq);
  __syncwarp();
  return q;
}

// The distance from the warp's query to 32 rows of T at `base` (row r at
// base + r row_bytes, nch 16-byte chunks, loads of `vec` bytes): lane l
// gives the row index `mine` (< 0: none) and receives its distance
// (unspecified for none), sum (v - q)^2 (L2) or -sum v q (MIPS). Each group
// of 8 lanes reads 8 rows at a time, a chunk a lane (chunks s, s + 8, ...
// of every row to sub-lane s), so a load instruction touches 4 rows'
// 128-byte lines, not 32; all 8 loads of a pass go out before any is used,
// and reduce_scatter8 adds the 8 lanes' sums in the fixed tree. On int8
// rows an integer-valued query sums in exact int32 with dp4a (L2 as sum v^2
// - 2 sum v q, then + sum q^2); any other query sums in f32 in the order
// stated at the top.
//
// score32_by takes the rows from `load(r, k)`, the 16-byte chunk k of row r
// (zeros past the row): score32 reads them from device memory, kernel 1's
// multi-probe mode from a block staged in shared memory. The sums are the
// same either way.
template <typename T, typename Load>
__device__ __forceinline__ float score32_by(const Query& q, Load load, int nch, bool mips,
                                            int mine, int lane) {
  const int s = lane & 7, g = lane & ~7;
  int id[8], ia[8];
  float fa[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    id[v] = __shfl_sync(kFullMask, mine, g + v);
    ia[v] = 0;
    fa[v] = 0.f;
  }
  for (int k = s; k < nch; k += 8) {
    int4 x[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      x[v] = make_int4(0, 0, 0, 0);
      if (id[v] >= 0) x[v] = load(id[v], k);
    }
    if constexpr (sizeof(T) == 1) {
      if (q.int_q) {
        const int4 w = *reinterpret_cast<const int4*>(q.qi + 16 * k);
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int4 y = x[v];
          const int vq =
              __dp4a(y.w, w.w, __dp4a(y.z, w.z, __dp4a(y.y, w.y, __dp4a(y.x, w.x, 0))));
          const int vv =
              __dp4a(y.w, y.w, __dp4a(y.z, y.z, __dp4a(y.y, y.y, __dp4a(y.x, y.x, 0))));
          ia[v] += mips ? vq : vv - 2 * vq;
        }
      } else {
        const float4* qv = reinterpret_cast<const float4*>(q.qf + 16 * k);
        const float4 q0 = qv[0], q1 = qv[1], q2 = qv[2], q3 = qv[3];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          acc_word(fa[v], x[v].x, q0, mips);
          acc_word(fa[v], x[v].y, q1, mips);
          acc_word(fa[v], x[v].z, q2, mips);
          acc_word(fa[v], x[v].w, q3, mips);
        }
      }
    } else {
      const float4 qv = *reinterpret_cast<const float4*>(q.qf + 4 * k);
#pragma unroll
      for (int v = 0; v < 8; ++v) acc_f32(fa[v], x[v], qv, mips);
    }
  }
  if constexpr (sizeof(T) == 1) {
    if (q.int_q) {
      const int t = reduce_scatter8(ia, s);
      return mips ? -__int2float_rn(t) : __int2float_rn(t + q.qq);
    }
  }
  const float t = reduce_scatter8(fa, s);
  return mips ? -t : t;
}

// score32_by on f32 rows for two queries at once: each chunk a lane loads
// serves both, each query's sums in score32's order -> (distance to qa,
// distance to qb) of the lane's row.
template <typename Load>
__device__ __forceinline__ float2 score32x2_by(const float* qa, const float* qb, Load load,
                                               int nch, bool mips, int mine, int lane) {
  const int s = lane & 7, g = lane & ~7;
  int id[8];
  float fa[8], fb[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    id[v] = __shfl_sync(kFullMask, mine, g + v);
    fa[v] = fb[v] = 0.f;
  }
  for (int k = s; k < nch; k += 8) {
    int4 x[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      x[v] = make_int4(0, 0, 0, 0);
      if (id[v] >= 0) x[v] = load(id[v], k);
    }
    const float4 qva = *reinterpret_cast<const float4*>(qa + 4 * k);
    const float4 qvb = *reinterpret_cast<const float4*>(qb + 4 * k);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      acc_f32(fa[v], x[v], qva, mips);
      acc_f32(fb[v], x[v], qvb, mips);
    }
  }
  const float ta = reduce_scatter8(fa, s), tb = reduce_scatter8(fb, s);
  return mips ? make_float2(-ta, -tb) : make_float2(ta, tb);
}

template <typename T>
__device__ __forceinline__ float score32(const Query& q, const char* base, int row_bytes,
                                         int nch, int vec, bool mips, int mine, int lane) {
  return score32_by<T>(
      q,
      [=](int r, int k) {
        return load_chunk(base + static_cast<size_t>(r) * row_bytes, k, row_bytes, vec);
      },
      nch, mips, mine, lane);
}

// ---- bitonic networks over a warp's registers: element i = 32 r + lane ----

__device__ __forceinline__ void cmpx_regs(float& da, int& pa_, float& db, int& pb, bool up) {
  const bool swap = up ? key_less(db, pb, da, pa_) : key_less(da, pa_, db, pb);
  const float td = da;
  const int tp = pa_;
  da = swap ? db : da;
  pa_ = swap ? pb : pa_;
  db = swap ? td : db;
  pb = swap ? tp : pb;
}

// One stage of stride j < 32: exchange with lane ^ j.
__device__ __forceinline__ void cmpx_lanes(float& d, int& p, int j, bool up, int lane) {
  const float od = __shfl_xor_sync(kFullMask, d, j);
  const int op = __shfl_xor_sync(kFullMask, p, j);
  const bool lower = (lane & j) == 0;
  const bool take = lower == up ? key_less(od, op, d, p) : key_less(d, p, od, op);
  d = take ? od : d;
  p = take ? op : p;
}

// log2(32 C) for the networks' C = 1, 2, 4 or 8 registers a lane
template <int C>
__host__ __device__ constexpr int warp_log() {
  static_assert(C == 1 || C == 2 || C == 4 || C == 8, "one, two, four or eight registers a lane");
  return C == 1 ? 5 : C == 2 ? 6 : C == 4 ? 7 : 8;
}

// Sort 32 C (key, pack) pairs descending.
template <int C>
__device__ __forceinline__ void warp_sort_desc(float (&d)[C], int (&p)[C], int lane) {
  constexpr int kLog = warp_log<C>();
#pragma unroll
  for (int lk = 1; lk <= kLog; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
#pragma unroll
      for (int r = 0; r < C; ++r) {
        if (j >= 32) {
          const int r2 = r | (j >> 5);
          if (r2 != r) cmpx_regs(d[r], p[r], d[r2], p[r2], (r & (k >> 5)) != 0);
        } else {
          const int bit = k < 32 ? (lane & k) : (r & (k >> 5));
          cmpx_lanes(d[r], p[r], j, bit != 0, lane);
        }
      }
    }
  }
}

// Sort ascending 32 C pairs that form a bitonic sequence. Strides of 32
// and more (C > 1) pair registers within a lane, the rest lanes.
template <int C>
__device__ __forceinline__ void warp_merge(float (&d)[C], int (&p)[C], int lane) {
  constexpr int kLog = warp_log<C>();
#pragma unroll
  for (int lj = kLog - 1; lj >= 0; --lj) {
    const int j = 1 << lj;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (j >= 32) {
        const int r2 = r | (j >> 5);
        if (r2 != r) cmpx_regs(d[r], p[r], d[r2], p[r2], true);
      } else {
        cmpx_lanes(d[r], p[r], j, true, lane);
      }
    }
  }
}

// ---- the same networks run by one warp over shared memory ----

__device__ __forceinline__ void cmpx_smem(float* d, int* p, int lo, int hi, bool up) {
  const float a = d[lo], b = d[hi];
  const int pa_ = p[lo], pb = p[hi];
  if (up ? key_less(b, pb, a, pa_) : key_less(a, pa_, b, pb)) {
    d[lo] = b;
    d[hi] = a;
    p[lo] = pb;
    p[hi] = pa_;
  }
}

// Sort n (a power of two) pairs, ascending or descending. Callers
// synchronise the warp before; the last stage ends with __syncwarp.
__device__ inline void smem_sort(float* d, int* p, int n, bool desc, int lane) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int lj = __ffs(j) - 1;
      for (int i = lane; i < (n >> 1); i += 32) {
        const int lo = ((i >> lj) << (lj + 1)) | (i & (j - 1));
        cmpx_smem(d, p, lo, lo + j, ((lo & k) == 0) != desc);
      }
      __syncwarp();
    }
  }
}

// Sort ascending n (a power of two) pairs that form a bitonic sequence.
__device__ inline void smem_merge(float* d, int* p, int n, int lane) {
  for (int j = n >> 1; j > 0; j >>= 1) {
    const int lj = __ffs(j) - 1;
    for (int i = lane; i < (n >> 1); i += 32) {
      const int lo = ((i >> lj) << (lj + 1)) | (i & (j - 1));
      cmpx_smem(d, p, lo, lo + j, true);
    }
    __syncwarp();
  }
}

// The next entry of a persistent grid's queue for this warp (>= the queue's
// length when it is empty).
__device__ __forceinline__ int next_in_queue(int* counter, int lane) {
  int k = 0;
  if (lane == 0) k = atomicAdd(counter, 1);
  return __shfl_sync(kFullMask, k, 0);
}

// The CTAs of `kernel` (at its block size and `smem` bytes) that every SM
// together holds at once. The SM count and the occupancy are asked of the
// runtime once per device, kernel and size, not at every launch.
inline cudaError_t resident_ctas(const void* kernel, int threads, size_t smem, long long* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, uintptr_t, size_t>, long long> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, reinterpret_cast<uintptr_t>(kernel), smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it == known.end()) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    it = known.emplace(key, static_cast<long long>(sms) * per_sm).first;
  }
  *out = it->second;
  return cudaSuccess;
}

// The widest load (16, 8, 4 or 1 bytes) that keeps every row of `row_bytes`
// bytes from `base` aligned.
inline int widest_load(const void* base, int row_bytes) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base);
  int vec = 16;
  while (vec > 1 && ((addr % vec) != 0 || row_bytes % vec != 0)) vec /= 2;
  return vec;
}

}  // namespace pa
