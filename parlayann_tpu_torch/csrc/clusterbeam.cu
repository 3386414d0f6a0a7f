// Kernel 5: the cluster-beam walk of the ClusterIndex search.
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
// What bounds it on the H100: latency. An expansion is one dependent read
// of an 11 KB (int8) or 42 KB (f32) ext row at m = 64, Rc = 16, d = 128,
// a few hundred FMAs per row, a 16-lane sort and a 2 Wc-lane merge; a
// query takes n_probe (3..16) of them. The TPU ran all queries in lock-step
// with one launch per expansion, a DMA ring and frozen-row passthrough.
// Here a query's walk never depends on another's, so one CTA of four warps
// runs one query's whole walk in one launch, and the 3.5 KB of shared
// state (query, beam, candidates, merge buffer, pool) lets many CTAs share
// an SM and hide each other's row reads. A warp scores one member or
// centroid row at a time (pa::warp_dist); the warp that scores member slot
// j owns that slot's M-deep pool list, so the bubble insert needs no
// synchronisation. Candidates are sorted by the block-level bitonic network
// and merged with the beam in one bitonic merge, ordered by (distance,
// pack) as in kernel 3. On the int8 layout the query is integer-valued and
// every distance is an exact integer, so the kernel equals the plain
// version bit for bit; on the f32 layout only the summation order differs.

#include "bitonic.cuh"

namespace {

constexpr int kThreads = 128;

struct Params {
  const float* q;       // (B, d) f32, in the ext's domain
  const void* ext;      // (C_pad, rows, d) int8 or f32
  const float* seed_d;  // (B, S) ascending
  const int* seed_i;    // (B, S)
  int d, S, C, m, Rc, Rcp, Wc, Lc, M, n_points, n_probe, min_probe, use_cut;
  float cut;
  float* out_pd;  // (B, M * m)
  int* out_pi;    // (B, M * m)
  int* out_nv;    // (B,)
};

// The two ext layouts differ in their id planes: four little-endian byte
// planes (int8) or one plane of ids stored as f32 values.
template <typename T>
struct Layout;

template <>
struct Layout<int8_t> {
  static constexpr int kIdRows = 4;
  __device__ static int id(const int8_t* plane, int d, int j) {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(plane);
    const unsigned u = static_cast<unsigned>(b[j]) | (static_cast<unsigned>(b[d + j]) << 8) |
                       (static_cast<unsigned>(b[2 * d + j]) << 16) |
                       (static_cast<unsigned>(b[3 * d + j]) << 24);
    return static_cast<int>(u);
  }
};

template <>
struct Layout<float> {
  static constexpr int kIdRows = 1;
  __device__ static int id(const float* plane, int, int j) {
    return static_cast<int>(plane[j]);
  }
};

__device__ __forceinline__ int sentinel(const Params& p, int lane) {
  return (p.C + lane) * 2 + 1;
}

template <bool kMips, typename T>
__global__ void __launch_bounds__(kThreads) cluster_walk_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* q = smem;                                  // d
  float* bd = q + p.d;                              // Wc
  int* bp = reinterpret_cast<int*>(bd + p.Wc);      // Wc
  float* cd = reinterpret_cast<float*>(bp + p.Wc);  // Rcp
  int* cp = reinterpret_cast<int*>(cd + p.Rcp);     // Rcp
  float* md = reinterpret_cast<float*>(cp + p.Rcp); // 2 * Wc
  int* mp = reinterpret_cast<int*>(md + 2 * p.Wc);  // 2 * Wc
  float* pd = reinterpret_cast<float*>(mp + 2 * p.Wc);  // M * m
  int* pi = reinterpret_cast<int*>(pd + p.M * p.m);     // M * m
  __shared__ int s_first;

  constexpr int kIdRows = Layout<T>::kIdRows;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const T* ext = static_cast<const T*>(p.ext);
  const size_t row_stride = static_cast<size_t>(p.m + p.Rc + 2 * kIdRows) * p.d;

  const float* qg = p.q + static_cast<size_t>(b) * p.d;
  for (int t = tid; t < p.d; t += blockDim.x) q[t] = qg[t];
  const float* sdg = p.seed_d + static_cast<size_t>(b) * p.S;
  const int* sig = p.seed_i + static_cast<size_t>(b) * p.S;
  for (int i = tid; i < p.Wc; i += blockDim.x) {
    const bool live = i < p.S && i < p.Lc && sdg[i] < pa::kInf;
    bd[i] = live ? sdg[i] : pa::kInf;
    bp[i] = live ? 2 * sig[i] + 1 : sentinel(p, i);
  }
  for (int i = tid; i < p.M * p.m; i += blockDim.x) {
    pd[i] = pa::kInf;
    pi[i] = -1;
  }
  __syncthreads();
  pa::bitonic_sort(bd, bp, p.Wc);
  int e = bd[0] < pa::kInf ? bp[0] >> 1 : -1;
  __syncthreads();
  if (e >= 0 && tid == 0) bp[0] -= 1;
  __syncthreads();

  int nv = 0;
  const int c_take = min(p.Wc, p.Rcp);
  while (e >= 0) {
    const T* row = ext + static_cast<size_t>(e) * row_stride;
    const T* mid_plane = row + static_cast<size_t>(p.m) * p.d;
    const T* avec = row + static_cast<size_t>(p.m + kIdRows) * p.d;
    const T* aid_plane = row + static_cast<size_t>(p.m + kIdRows + p.Rc) * p.d;
    for (int i = tid; i < p.Rcp; i += blockDim.x) {
      cd[i] = pa::kInf;
      cp[i] = sentinel(p, i);
    }
    __syncthreads();

    // ---- score members (-> pool) and adjacent centroids (-> candidates) ----
    for (int t = warp; t < p.m + p.Rc; t += n_warps) {
      if (t < p.m) {
        const int id = Layout<T>::id(mid_plane, p.d, t);
        if (id < 0 || id >= p.n_points) continue;  // warp-uniform
        const float dist =
            pa::warp_dist<kMips>(q, row + static_cast<size_t>(t) * p.d, p.d, lane);
        if (lane == 0) {  // this warp owns slot t's M-deep list
          float cv = dist;
          int ci = id;
          for (int mm = 0; mm < p.M; ++mm) {
            const int s = mm * p.m + t;
            const float a = pd[s];
            if (cv < a) {
              const int ai = pi[s];
              pd[s] = cv;
              pi[s] = ci;
              cv = a;
              ci = ai;
            }
          }
        }
      } else {
        const int r = t - p.m;
        const int id = Layout<T>::id(aid_plane, p.d, r);
        if (id < 0 || id >= p.C) continue;  // warp-uniform
        const float dist =
            pa::warp_dist<kMips>(q, avec + static_cast<size_t>(r) * p.d, p.d, lane);
        bool dup = false;
        for (int l = lane; l < p.Wc; l += 32) dup |= (bp[l] >> 1) == id;
        dup = __any_sync(pa::kFullMask, dup);
        if (lane == 0 && !dup) {
          cd[r] = dist;
          cp[r] = 2 * id + 1;
        }
      }
    }
    __syncthreads();
    nv += 1;

    // ---- merge: [beam asc | (INF, sentinel) pad | c_take smallest cand desc] ----
    pa::bitonic_sort(cd, cp, p.Rcp);
    for (int i = tid; i < 2 * p.Wc; i += blockDim.x) {
      if (i < p.Wc) {
        md[i] = bd[i];
        mp[i] = bp[i];
      } else if (i < 2 * p.Wc - c_take) {
        md[i] = pa::kInf;
        mp[i] = sentinel(p, i);
      } else {
        const int r = 2 * p.Wc - 1 - i;
        md[i] = cd[r];
        mp[i] = cp[r];
      }
    }
    __syncthreads();
    pa::bitonic_merge(md, mp, 2 * p.Wc);
    for (int i = tid; i < p.Wc; i += blockDim.x) {
      const bool live = i < p.Lc;
      bd[i] = live ? md[i] : pa::kInf;
      bp[i] = live ? mp[i] : sentinel(p, i);
    }
    if (tid == 0) s_first = p.Wc;
    __syncthreads();

    // ---- next expansion: the first workable lane ----
    const float best = bd[0];
    for (int i = tid; i < p.Wc; i += blockDim.x) {
      bool w = (bp[i] & 1) && bd[i] < pa::kInf;
      if (p.use_cut) w = w && (bd[i] < p.cut * best || nv < p.min_probe);
      if (w) atomicMin(&s_first, i);
    }
    __syncthreads();
    const int first = s_first;
    e = (first < p.Wc && nv < p.n_probe) ? bp[first] >> 1 : -1;
    __syncthreads();
    if (e >= 0 && tid == 0) bp[first] -= 1;
    __syncthreads();
  }

  float* opd = p.out_pd + static_cast<size_t>(b) * p.M * p.m;
  int* opi = p.out_pi + static_cast<size_t>(b) * p.M * p.m;
  for (int i = tid; i < p.M * p.m; i += blockDim.x) {
    opd[i] = pd[i];
    opi[i] = pi[i];
  }
  if (tid == 0) p.out_nv[b] = nv;
}

template <bool kMips, typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(p.d) + 2 * p.Wc + 2 * p.Rcp +
                                       4 * p.Wc + 2 * static_cast<size_t>(p.M) * p.m);
  cudaError_t err = pa::allow_smem(cluster_walk_kernel<kMips, T>, smem);
  if (err != cudaSuccess) return err;
  cluster_walk_kernel<kMips, T><<<B, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pa_cluster_walk(const void* q, const void* ext, const void* seed_d,
                               const void* seed_i, int B, int d, int S, int C, int m,
                               int Rc, int Rcp, int Wc, int Lc, int M, int n_points,
                               int n_probe, int min_probe, float cut, int use_cut,
                               int mips, int ext_f32, void* out_pd, void* out_pi,
                               void* out_nv, void* stream) {
  if (B == 0) return 0;
  Params p;
  p.q = static_cast<const float*>(q);
  p.ext = ext;
  p.seed_d = static_cast<const float*>(seed_d);
  p.seed_i = static_cast<const int*>(seed_i);
  p.d = d;
  p.S = S;
  p.C = C;
  p.m = m;
  p.Rc = Rc;
  p.Rcp = Rcp;
  p.Wc = Wc;
  p.Lc = Lc;
  p.M = M;
  p.n_points = n_points;
  p.n_probe = n_probe;
  p.min_probe = min_probe;
  p.use_cut = use_cut;
  p.cut = cut;
  p.out_pd = static_cast<float*>(out_pd);
  p.out_pi = static_cast<int*>(out_pi);
  p.out_nv = static_cast<int*>(out_nv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mips)
    err = ext_f32 ? launch<true, float>(p, B, s) : launch<true, int8_t>(p, B, s);
  else
    err = ext_f32 ? launch<false, float>(p, B, s) : launch<false, int8_t>(p, B, s);
  return static_cast<int>(err);
}
