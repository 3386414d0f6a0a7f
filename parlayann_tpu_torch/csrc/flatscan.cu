// Kernel 4: exact brute-force top-k (flat search).
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
// (MIPS); the kernel selects on b[x] + s * q.x, and the wrapper adds ||q||^2
// back. Scaling by s is exact, so the one rounding of fmaf(s, dot, b)
// equals the plain version's `bias + scale * dot`.
//
// What bounds it on the H100: float32 FMAs. At B = 10K queries, N = 100K
// points and d = 128 the distance tile is 1.3e11 FMAs; the selection that
// follows touches each distance once and inserts a few hundred per query.
// Design: one CTA of 256 threads per tile of 64 queries streams all points
// through shared memory in tiles of 64, 32 dimensions at a time (so any d
// fits), each thread accumulating a 4 x 4 block of the 64 x 64 distance
// tile in registers (rows ty + 16 r, columns tx + 16 c: conflict-free
// shared-memory reads). The tile goes to shared memory, and each warp then
// owns 8 query rows: a lane compares its candidates with the row's current
// k-th entry, a ballot collects those that beat it, and each is inserted
// into the row's sorted (distance, id) list in shared memory, the warp
// shifting the tail. The (B, N) matrix never exists. int8 points are
// widened to f32 in the tile load: on integer-valued queries every product
// and partial sum is an exact integer below 2^24, so the kernel equals the
// plain version bit for bit on the q8 tier. Tensor-core (TF32 / bf16
// wgmma) precision is later work.

#include <climits>

#include "bitonic.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 64;  // queries per CTA
constexpr int kCT = 64;  // points per tile
constexpr int kDK = 32;  // dimensions per shared-memory chunk

struct Params {
  const float* q;      // (B, d) f32
  const void* x;       // (n, d) f32 or int8
  const float* bias;   // (n,) f32, INF where the point is invalid
  const int* exclude;  // (B,) int32 or null
  int B, n, d, k;
  float scale;
  float* out_d;  // (B, k)
  int* out_i;    // (B, k)
};

template <typename T>
__global__ void __launch_bounds__(kThreads) flat_topk_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // kDK x (kBT + 1)
  float* xs = qs + kDK * (kBT + 1);    // kDK x (kCT + 1)
  float* ds = xs + kDK * (kCT + 1);    // kBT x (kCT + 1)
  float* bs = ds + kBT * (kCT + 1);    // kCT
  float* ld = bs + kCT;                // kBT x k sorted distances
  int* li = reinterpret_cast<int*>(ld + kBT * p.k);  // kBT x k ids
  __shared__ int excl[kBT];

  const T* x = static_cast<const T*>(p.x);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * kBT;

  for (int i = tid; i < kBT * p.k; i += kThreads) {
    ld[i] = pa::kInf;
    li[i] = INT_MAX;
  }
  for (int i = tid; i < kBT; i += kThreads)
    excl[i] = (p.exclude != nullptr && b0 + i < p.B) ? p.exclude[b0 + i] : -1;

  for (int p0 = 0; p0 < p.n; p0 += kCT) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int j = tid; j < kCT; j += kThreads)
      bs[j] = p0 + j < p.n ? p.bias[p0 + j] : pa::kInf;

    for (int k0 = 0; k0 < p.d; k0 += kDK) {
      for (int idx = tid; idx < kBT * kDK; idx += kThreads) {
        const int i = idx / kDK, kk = idx % kDK;
        const int b = b0 + i, c = k0 + kk;
        qs[kk * (kBT + 1) + i] =
            (b < p.B && c < p.d) ? p.q[static_cast<size_t>(b) * p.d + c] : 0.f;
      }
      for (int idx = tid; idx < kCT * kDK; idx += kThreads) {
        const int j = idx / kDK, kk = idx % kDK;
        const int pt = p0 + j, c = k0 + kk;
        xs[kk * (kCT + 1) + j] =
            (pt < p.n && c < p.d) ? static_cast<float>(x[static_cast<size_t>(pt) * p.d + c])
                                  : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDK; ++kk) {
        float a[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[kk * (kBT + 1) + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = xs[kk * (kCT + 1) + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], v[c], acc[r][c]);
      }
      __syncthreads();
    }

    // ---- epilogue: biased, masked distances into the shared tile ----
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = ty + 16 * r, col = tx + 16 * c;
        const float bv = bs[col];
        const bool ok = bv < pa::kInf && p0 + col != excl[row];
        ds[row * (kCT + 1) + col] = ok ? fmaf(p.scale, acc[r][c], bv) : pa::kInf;
      }
    }
    __syncthreads();

    // ---- selection: warp w keeps the lists of rows w, w + 8, ... ----
    for (int row = warp; row < kBT; row += kThreads / 32) {
      if (b0 + row >= p.B) continue;  // warp-uniform
      float* rd = ld + row * p.k;
      int* ri = li + row * p.k;
      float td = rd[p.k - 1];
      int ti = ri[p.k - 1];
      for (int h = 0; h < kCT; h += 32) {
        const float cd = ds[row * (kCT + 1) + h + lane];
        const int cid = p0 + h + lane;
        unsigned mask = __ballot_sync(pa::kFullMask,
                                      cd < pa::kInf && pa::key_less(cd, cid, td, ti));
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float vd = __shfl_sync(pa::kFullMask, cd, src);
          const int vi = __shfl_sync(pa::kFullMask, cid, src);
          if (!pa::key_less(vd, vi, td, ti)) continue;  // the k-th entry improved
          int pos = 0;
          for (int j = lane; j < p.k; j += 32) pos += pa::key_less(rd[j], ri[j], vd, vi);
          pos = pa::warp_sum(pos);
          // shift [pos, k - 1) one place up, top chunk first
          for (int base = ((p.k - 1) / 32) * 32; base >= 0; base -= 32) {
            const int j = base + lane;
            const bool w = j > pos && j < p.k;
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
          td = rd[p.k - 1];
          ti = ri[p.k - 1];
        }
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < kBT * p.k; idx += kThreads) {
    const int b = b0 + idx / p.k;
    if (b >= p.B) continue;
    const size_t o = static_cast<size_t>(b) * p.k + idx % p.k;
    const bool ok = ld[idx] < pa::kInf;
    p.out_d[o] = ok ? ld[idx] : pa::kInf;
    p.out_i[o] = ok ? li[idx] : -1;
  }
}

}  // namespace

extern "C" int pa_flat_topk(const void* q, const void* x, const void* bias,
                            const void* exclude, int B, int n, int d, int k, float scale,
                            int x_int8, void* out_d, void* out_i, void* stream) {
  if (B == 0) return 0;
  Params p;
  p.q = static_cast<const float*>(q);
  p.x = x;
  p.bias = static_cast<const float*>(bias);
  p.exclude = static_cast<const int*>(exclude);
  p.B = B;
  p.n = n;
  p.d = d;
  p.k = k;
  p.scale = scale;
  p.out_d = static_cast<float*>(out_d);
  p.out_i = static_cast<int*>(out_i);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kDK) * (kBT + 1) + kDK * (kCT + 1) +
                       kBT * (kCT + 1) + kCT + 2 * static_cast<size_t>(kBT) * k);
  auto kernel = x_int8 ? &flat_topk_kernel<int8_t> : &flat_topk_kernel<float>;
  cudaError_t err = pa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + kBT - 1) / kBT;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
