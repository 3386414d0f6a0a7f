// Kernel 5: the cluster-beam walk of the ClusterIndex search, one warp a
// query.
//
// Replaces parlayann_tpu/ops/pallas/clusterbeam.py:351 cluster_step
// (kernel body _step_kernel :74) together with the lock-step loop of its
// driver cluster_search_fused (:419). Semantics (the plain version is
// ops/kernels/clusterbeam.py:cluster_walk_plain): seed the cluster beam
// with the S nearest centroids; per expansion read one ext row, bubble-
// insert its m member distances into an (m, M) point pool (strict <), merge
// its Rc adjacent centroids that are valid and not already in the beam
// (hashless dedup against every beam id), empty the lanes >= Lc, and take
// the first unexpanded live lane next, under the cut rule (L2 only: below
// cut x the best beam distance, or fewer than min_probe expansions done)
// and the n_probe budget.
//
// What bounds it on the H100: a query's walk is a chain of n_probe (3..16
// on the main path) dependent expansions, each an ext row of 11 KB (int8)
// or 42 KB (f32) at m = 64, Rc = 16, d = 128, a few hundred FMAs a row and
// a 32-lane merge. At B = 10,000 the f32 walk asks for 6.7 GB of rows out
// of a 98 MB ext array that does not fit the 50 MB L2, so rows that one
// query reads should still be in L1 or L2 for the next.
//
// Design:
//  1. One warp walks one query, with no __syncthreads: CTAs of kWarps
//     independent warps on a persistent grid sized from the occupancy, each
//     warp taking its next query from an atomicAdd counter.
//  2. Scoring (pa::score32 of warp.cuh, shared with kernel 3): groups of 8
//     lanes read 8 rows at a time, a 16-byte read-only load a lane a row
//     (8-, 4- or 1-byte loads where the ext's alignment or d allow no
//     wider), all loads of a pass issued before the first is used, and a
//     butterfly of 7 shuffles leaves each lane its own row's sum: lane j
//     ends a pass of 32 rows holding row j. On the int8 layout a query that
//     is integer-valued in [-128, 127] (the q8-translated queries) is
//     scored with dp4a in exact int32 (L2 as sum v^2 - 2 sum v q + sum q^2);
//     any other query, and every query on the f32 layout, in f32 as
//     sum (v - q)^2 or -sum v q in warp.cuh's fixed order, which the plain
//     version replays. So the kernel equals the plain version bit for bit
//     on both layouts, and a seed and a walked centroid at a near-tie are
//     ordered alike by both.
//  3. Member slot j's M-deep pool list lives in the registers of lane
//     j % 32 (m <= 128: at most 4 slots a lane), the lane that scores
//     member j, so the bubble insert is lane-local.
//  4. The cluster beam (Wc <= 32, one (distance, pack) pair a lane, sorted)
//     and the candidates (Rc <= 32, one a lane) live in registers. A
//     candidate is tested against the beam's finite entries by a shuffle
//     loop; when any survives, the candidates are sorted descending by a
//     shuffle bitonic network, a half cleaner (min of beam i and candidate
//     i) leaves the 32 smallest as a bitonic sequence, and a shuffle
//     bitonic merge sorts them, ordered by (distance, pack). The next
//     expansion is one ballot and __ffs.
//  5. Wider beams (up to 1024 lanes), more than 32 adjacent centroids or
//     more than 128 members run cluster_walk_smem: the same walk with beam,
//     candidates and pool in the warp's shared memory and the same networks
//     run by the warp over it (warp.cuh).

#include "warp.cuh"

namespace {

constexpr int kWarps = 4;         // queries in flight a CTA of cluster_walk_regs
constexpr int kM = 4;             // pool depth (POOL_DEPTH of the wrapper)
constexpr int kMaxRegWc = 32;     // beam lanes cluster_walk_regs holds: one a lane
constexpr int kMaxRegRc = 32;     // adjacent centroids cluster_walk_regs holds
constexpr int kMaxRegM = 128;     // member slots cluster_walk_regs holds: 4 a lane
constexpr int kSent = 0x7fffffff; // pack of every empty entry: id 2^30 - 1 >= C
// Measured on an H100 (PERF.md): one pass of 8 rows' loads at a time (2
// and 4 were slower on f32 rows, 4 by 2x), and 4 CTAs an SM for the int8
// walk (at most 128 registers a thread, 16 warps an SM: 16% faster than the
// compiler's 168 registers and 12 warps at 10,000 queries); the f32 walk
// takes 128 registers uncapped and was slower with a minimum.
template <typename T>
constexpr int kMinCtas = sizeof(T) == 1 ? 4 : 0;

struct Params {
  const float* q;       // (B, d) f32, in the ext's domain
  const void* ext;      // (C_pad, rows, d) int8 or f32
  const float* seed_d;  // (B, S) ascending
  const int* seed_i;    // (B, S)
  int B, d, S, C, m, Rc, Wc, Lc, n_points, n_probe, min_probe, use_cut, mips;
  int Nc;            // candidate lanes of cluster_walk_smem: max(pow2(Rc), 32)
  float cut;
  int row_bytes;     // bytes of one vector row: d x the element size
  int vec;           // widest load the ext's base address and row_bytes keep aligned
  int nch;           // 16-byte chunks a vector row
  size_t ext_bytes;  // bytes of one ext row
  int slice;         // shared-memory bytes a warp
  int* counter;      // (1,) int32, zero at launch: the next query to take
  float* out_pd;     // (B, M * m)
  int* out_pi;       // (B, M * m)
  int* out_nv;       // (B,)
};

// The two ext layouts differ in their id planes: four little-endian byte
// planes (int8) or one plane of ids stored as f32 values.
template <typename T>
struct Layout;

template <>
struct Layout<int8_t> {
  static constexpr int kIdRows = 4;
  __device__ static int id(const char* plane, int d, int j) {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(plane);
    const unsigned u = static_cast<unsigned>(__ldg(b + j)) |
                       (static_cast<unsigned>(__ldg(b + d + j)) << 8) |
                       (static_cast<unsigned>(__ldg(b + 2 * d + j)) << 16) |
                       (static_cast<unsigned>(__ldg(b + 3 * d + j)) << 24);
    return static_cast<int>(u);
  }
};

template <>
struct Layout<float> {
  static constexpr int kIdRows = 1;
  __device__ static int id(const char* plane, int, int j) {
    return static_cast<int>(__ldg(reinterpret_cast<const float*>(plane) + j));
  }
};

// The distances from the warp's query to 32 vector rows at `base` (row r
// at base + r row_bytes): lane l gives the row index `mine` (< 0: none).
template <typename T>
__device__ __forceinline__ float score32(const Params& p, const pa::Query& q, const char* base,
                                         int mine, int lane) {
  return pa::score32<T>(q, base, p.row_bytes, p.nch, p.vec, p.mips, mine, lane);
}

// An ext row's parts.
template <typename T>
struct Row {
  const char* members;  // m vector rows
  const char* mid;      // member id plane(s)
  const char* adj;      // Rc vector rows
  const char* aid;      // adjacent id plane(s)
  __device__ Row(const Params& p, int e) {
    constexpr int kIdRows = Layout<T>::kIdRows;
    members = static_cast<const char*>(p.ext) + static_cast<size_t>(e) * p.ext_bytes;
    mid = members + static_cast<size_t>(p.m) * p.row_bytes;
    adj = mid + static_cast<size_t>(kIdRows) * p.row_bytes;
    aid = adj + static_cast<size_t>(p.Rc) * p.row_bytes;
  }
  // member slot j's id, -1 when it is none of the n_points points
  __device__ int member(const Params& p, int j) const {
    if (j >= p.m) return -1;
    const int id = Layout<T>::id(mid, p.d, j);
    return id >= 0 && id < p.n_points ? id : -1;
  }
  // adjacent centroid r's id, -1 when it is none of the C clusters
  __device__ int adjacent(const Params& p, int r) const {
    if (r >= p.Rc) return -1;
    const int id = Layout<T>::id(aid, p.d, r);
    return id >= 0 && id < p.C ? id : -1;
  }
};

// Bubble (cv, ci) through one slot's M-deep ascending list, depth mm at
// pd[mm * stride] (strict <).
__device__ __forceinline__ void pool_insert(float* pd, int* pi, int stride, float cv, int ci) {
#pragma unroll
  for (int mm = 0; mm < kM; ++mm) {
    const int s = mm * stride;
    const bool w = cv < pd[s];
    const float a = pd[s];
    const int ai = pi[s];
    pd[s] = w ? cv : a;
    pi[s] = w ? ci : ai;
    cv = w ? a : cv;
    ci = w ? ai : ci;
  }
}

__device__ __forceinline__ bool workable(const Params& p, float dist, int pack, float best,
                                         int nv) {
  bool w = (pack & 1) && dist < pa::kInf;
  if (p.use_cut) w = w && (dist < p.cut * best || nv < p.min_probe);
  return w;
}

// ---- the walk with beam, candidates and pool in registers ----

template <typename T, int MP>
__global__ void __launch_bounds__(32 * kWarps, kMinCtas<T>) cluster_walk_regs(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPer = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  unsigned char* slice = smem + (threadIdx.x >> 5) * p.slice;
  float* qf = reinterpret_cast<float*>(slice);
  int8_t* qi = reinterpret_cast<int8_t*>(qf + kPer * p.nch);

  for (int b = pa::next_in_queue(p.counter, lane); b < p.B;
       b = pa::next_in_queue(p.counter, lane)) {
    __syncwarp();
    const pa::Query q =
        pa::stage_query<T>(p.q + static_cast<size_t>(b) * p.d, p.d, p.nch, qf, qi, lane);

    // ---- seed: the live seeds in lanes < min(S, Lc), sorted ----
    float bd = pa::kInf;
    int bp = kSent;
    if (lane < p.S && lane < p.Lc) {
      const float x = p.seed_d[static_cast<size_t>(b) * p.S + lane];
      if (x < pa::kInf) {
        bd = x;
        bp = 2 * p.seed_i[static_cast<size_t>(b) * p.S + lane] + 1;
      }
    }
    {
      float sd[1] = {bd};
      int sp[1] = {bp};
      pa::warp_sort_desc<1>(sd, sp, lane);
      bd = __shfl_sync(pa::kFullMask, sd[0], 31 - lane);
      bp = __shfl_sync(pa::kFullMask, sp[0], 31 - lane);
    }
    int e = __shfl_sync(pa::kFullMask, bd, 0) < pa::kInf ? __shfl_sync(pa::kFullMask, bp, 0) >> 1
                                                          : -1;
    if (e >= 0 && lane == 0) bp -= 1;

    float pd[MP][kM];
    int pi[MP][kM];
#pragma unroll
    for (int c = 0; c < MP; ++c) {
#pragma unroll
      for (int mm = 0; mm < kM; ++mm) {
        pd[c][mm] = pa::kInf;
        pi[c][mm] = -1;
      }
    }

    int nv = 0;
    while (e >= 0) {
      const Row<T> row(p, e);
      int mid[MP];
#pragma unroll
      for (int c = 0; c < MP; ++c) mid[c] = row.member(p, 32 * c + lane);
      const int aid = row.adjacent(p, lane);

      // ---- members -> pool ----
#pragma unroll
      for (int c = 0; c < MP; ++c) {
        if (32 * c >= p.m) break;  // warp-uniform
        const float dist = score32<T>(p, q, row.members, mid[c] >= 0 ? 32 * c + lane : -1, lane);
        if (mid[c] >= 0) pool_insert(pd[c], pi[c], 1, dist, mid[c]);
      }

      // ---- adjacent centroids -> candidates: valid and not in the beam ----
      const float adist = score32<T>(p, q, row.adj, aid >= 0 ? lane : -1, lane);
      bool keep = aid >= 0;
      const int n_fin = __popc(__ballot_sync(pa::kFullMask, bd < pa::kInf));
      for (int l = 0; l < n_fin; ++l)
        keep &= (__shfl_sync(pa::kFullMask, bp, l) >> 1) != aid;
      nv += 1;

      // ---- merge: the 32 smallest of beam and candidates, lanes >= Lc emptied ----
      if (__any_sync(pa::kFullMask, keep)) {
        float cd[1] = {keep ? adist : pa::kInf};
        int cp[1] = {keep ? 2 * aid + 1 : kSent};
        pa::warp_sort_desc<1>(cd, cp, lane);
        float md[1] = {bd};
        int mp[1] = {bp};
        if (pa::key_less(cd[0], cp[0], md[0], mp[0])) {
          md[0] = cd[0];
          mp[0] = cp[0];
        }
        pa::warp_merge<1>(md, mp, lane);
        bd = lane < p.Lc ? md[0] : pa::kInf;
        bp = lane < p.Lc ? mp[0] : kSent;
      }

      // ---- next expansion: the first workable lane ----
      e = -1;
      if (nv < p.n_probe) {
        const float best = __shfl_sync(pa::kFullMask, bd, 0);
        const unsigned mask = __ballot_sync(pa::kFullMask, workable(p, bd, bp, best, nv));
        if (mask != 0) {
          const int first = __ffs(static_cast<int>(mask)) - 1;
          e = __shfl_sync(pa::kFullMask, bp, first) >> 1;
          if (lane == first) bp -= 1;
        }
      }
    }

    float* opd = p.out_pd + static_cast<size_t>(b) * kM * p.m;
    int* opi = p.out_pi + static_cast<size_t>(b) * kM * p.m;
#pragma unroll
    for (int c = 0; c < MP; ++c) {
      const int j = 32 * c + lane;
      if (j < p.m) {
#pragma unroll
        for (int mm = 0; mm < kM; ++mm) {
          opd[mm * p.m + j] = pd[c][mm];
          opi[mm * p.m + j] = pi[c][mm];
        }
      }
    }
    if (lane == 0) p.out_nv[b] = nv;
  }
}

// ---- the walk with beam, candidates and pool in shared memory ----

template <typename T>
__global__ void __launch_bounds__(32) cluster_walk_smem(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPer = 16 / sizeof(T);
  const int lane = threadIdx.x;
  const int Wc = p.Wc, Nc = p.Nc;
  float* qf = reinterpret_cast<float*>(smem);
  int8_t* qi = reinterpret_cast<int8_t*>(qf + kPer * p.nch);
  float* sd = reinterpret_cast<float*>(qi + (sizeof(T) == 1 ? kPer * p.nch : 0));  // beam
  int* sp = reinterpret_cast<int*>(sd + Wc);
  float* cd = reinterpret_cast<float*>(sp + Wc);  // an expansion's candidates
  int* cp = reinterpret_cast<int*>(cd + Nc);
  float* pd = reinterpret_cast<float*>(cp + Nc);  // pool: slot mm * m + j
  int* pi = reinterpret_cast<int*>(pd + kM * p.m);

  for (int b = pa::next_in_queue(p.counter, lane); b < p.B;
       b = pa::next_in_queue(p.counter, lane)) {
    __syncwarp();
    const pa::Query q =
        pa::stage_query<T>(p.q + static_cast<size_t>(b) * p.d, p.d, p.nch, qf, qi, lane);

    for (int i = lane; i < Wc; i += 32) {
      sd[i] = pa::kInf;
      sp[i] = kSent;
      if (i < p.S && i < p.Lc) {
        const float x = p.seed_d[static_cast<size_t>(b) * p.S + i];
        if (x < pa::kInf) {
          sd[i] = x;
          sp[i] = 2 * p.seed_i[static_cast<size_t>(b) * p.S + i] + 1;
        }
      }
    }
    for (int i = lane; i < kM * p.m; i += 32) {
      pd[i] = pa::kInf;
      pi[i] = -1;
    }
    __syncwarp();
    pa::smem_sort(sd, sp, Wc, false, lane);
    int e = sd[0] < pa::kInf ? sp[0] >> 1 : -1;
    __syncwarp();
    if (e >= 0 && lane == 0) sp[0] -= 1;
    __syncwarp();

    int nv = 0;
    while (e >= 0) {
      const Row<T> row(p, e);
      for (int base = 0; base < p.m; base += 32) {
        const int j = base + lane;
        const int id = row.member(p, j);
        const float dist = score32<T>(p, q, row.members, id >= 0 ? j : -1, lane);
        if (id >= 0) pool_insert(pd + j, pi + j, p.m, dist, id);  // lane j % 32 owns slot j
      }
      int n_fin = 0;
      for (int base = 0; base < Wc; base += 32)
        n_fin += __popc(__ballot_sync(pa::kFullMask, base + lane < Wc && sd[base + lane] < pa::kInf));
      bool any = false;
      for (int base = 0; base < Nc; base += 32) {
        const int r = base + lane;
        const int aid = row.adjacent(p, r);
        const float dist = score32<T>(p, q, row.adj, aid >= 0 ? r : -1, lane);
        bool keep = aid >= 0;
        for (int l = 0; keep && l < n_fin; ++l) keep = (sp[l] >> 1) != aid;
        cd[r] = keep ? dist : pa::kInf;
        cp[r] = keep ? 2 * aid + 1 : kSent;
        any |= keep;
      }
      nv += 1;
      if (__any_sync(pa::kFullMask, any)) {
        __syncwarp();
        pa::smem_sort(cd, cp, Nc, true, lane);
        // half cleaner: beam i against the candidate Wc - 1 - i of the
        // ascending order, element i - (Wc - Nc) of the descending one
        for (int i = lane; i < Wc; i += 32) {
          const int j = i - Wc + Nc;
          if (j >= 0 && j < Nc && pa::key_less(cd[j], cp[j], sd[i], sp[i])) {
            sd[i] = cd[j];
            sp[i] = cp[j];
          }
        }
        __syncwarp();
        pa::smem_merge(sd, sp, Wc, lane);
        for (int i = p.Lc + lane; i < Wc; i += 32) {
          sd[i] = pa::kInf;
          sp[i] = kSent;
        }
        __syncwarp();
      }
      e = -1;
      if (nv < p.n_probe) {
        const float best = sd[0];
        for (int base = 0; base < p.Lc; base += 32) {
          const int i = base + lane;
          const bool w = i < p.Lc && workable(p, sd[i], sp[i], best, nv);
          const unsigned mask = __ballot_sync(pa::kFullMask, w);
          if (mask != 0) {
            const int first = base + __ffs(static_cast<int>(mask)) - 1;
            e = sp[first] >> 1;
            __syncwarp();
            if (lane == 0) sp[first] -= 1;
            __syncwarp();
            break;
          }
        }
      }
    }

    __syncwarp();
    float* opd = p.out_pd + static_cast<size_t>(b) * kM * p.m;
    int* opi = p.out_pi + static_cast<size_t>(b) * kM * p.m;
    for (int i = lane; i < kM * p.m; i += 32) {
      opd[i] = pd[i];
      opi[i] = pi[i];
    }
    if (lane == 0) p.out_nv[b] = nv;
  }
}

using WalkFn = void (*)(Params);

template <typename T>
cudaError_t launch(Params& p, cudaStream_t stream) {
  constexpr int kPer = 16 / sizeof(T);
  p.row_bytes = p.d * static_cast<int>(sizeof(T));
  p.vec = pa::widest_load(p.ext, p.row_bytes);
  p.nch = (p.row_bytes + 15) / 16;
  p.ext_bytes = static_cast<size_t>(p.m + p.Rc + 2 * Layout<T>::kIdRows) * p.row_bytes;
  // per warp: the query as f32 (and int8), 16-byte aligned; cluster_walk_smem adds
  // the beam, the candidates and the pool (8 bytes an entry)
  const size_t qbytes = static_cast<size_t>(kPer) * p.nch * (sizeof(T) == 1 ? 5 : 4);
  p.Nc = p.Rc > 32 ? 1 << (32 - __builtin_clz(p.Rc - 1)) : 32;
  WalkFn kernel;
  int threads;
  size_t smem;
  if (p.Wc <= kMaxRegWc && p.Rc <= kMaxRegRc && p.m <= kMaxRegM) {
    kernel = p.m <= 64 ? &cluster_walk_regs<T, 2> : &cluster_walk_regs<T, 4>;
    threads = 32 * kWarps;
    p.slice = static_cast<int>(qbytes);
    smem = static_cast<size_t>(kWarps) * p.slice;
  } else {
    kernel = &cluster_walk_smem<T>;
    threads = 32;
    p.slice = static_cast<int>(qbytes + 8 * (static_cast<size_t>(p.Wc) + p.Nc + kM * p.m));
    smem = p.slice;
  }
  cudaError_t err = pa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  long long resident = 0;
  err = pa::resident_ctas(reinterpret_cast<const void*>(kernel), threads, smem, &resident);
  if (err != cudaSuccess) return err;
  // a persistent grid: every SM full, or one warp a query if fewer
  const long long ctas = (static_cast<long long>(p.B) + threads / 32 - 1) / (threads / 32);
  const int grid = static_cast<int>(ctas < resident ? ctas : resident);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pa_cluster_walk(const void* q, const void* ext, const void* seed_d,
                               const void* seed_i, int B, int d, int S,
                               int C, int m, int Rc, int Wc, int Lc, int M, int n_points,
                               int n_probe, int min_probe, float cut, int use_cut, int mips,
                               int ext_f32, void* counter, void* out_pd, void* out_pi,
                               void* out_nv, void* stream) {
  if (B == 0) return 0;
  if (M != kM || Wc <= 0 || (Wc & (Wc - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.ext = ext;
  p.seed_d = static_cast<const float*>(seed_d);
  p.seed_i = static_cast<const int*>(seed_i);
  p.B = B;
  p.d = d;
  p.S = S;
  p.C = C;
  p.m = m;
  p.Rc = Rc;
  p.Wc = Wc;
  p.Lc = Lc;
  p.n_points = n_points;
  p.n_probe = n_probe;
  p.min_probe = min_probe;
  p.use_cut = use_cut;
  p.mips = mips;
  p.cut = cut;
  p.counter = static_cast<int*>(counter);
  p.out_pd = static_cast<float*>(out_pd);
  p.out_pi = static_cast<int*>(out_pi);
  p.out_nv = static_cast<int*>(out_nv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(ext_f32 ? launch<float>(p, s) : launch<int8_t>(p, s));
}
