// Kernel 2: occlusion_rounds (robustPrune's alpha-occlusion).
//
// Replaces parlayann_tpu/ops/pallas/occlude.py:91 occlusion_rounds (kernel
// body _occl_kernel, occlude.py:39). For each row b: C candidates sorted by
// their distance to the point p (INF = invalid) and their int8 or f32
// vectors (the JAX kernel casts any dtype; each of the two has a kernel). R
// rounds; each takes the first live candidate as the star and kills every
// live c with alpha * d(star, c) <= d(p, c). Output: the round in which each
// candidate became the star, else R + C.
//
// What bounds it on the H100: bytes. A row reads its C distances and the d
// bytes of each live candidate and writes 4C; its distances are 2 C d
// integer operations a star, which the int8 tensor cores (1,979 TOPS)
// finish well before the row's bytes arrive at 3.35 TB/s (at B = 2048,
// C = 96, d = 128, about 85 live candidates a row: about 0.007 ms of bytes
// against 0.0007 ms of operations). What keeps a kernel from that bound
// is the chain of R dependent rounds inside each row, so the design makes a
// round a few warp instructions and keeps every row's chain independent:
//  1. One warp owns one row and is its CTA, so nothing waits on another
//     row and no barrier exists. A row whose candidates are all INF (the
//     pad rows of the build's minimum batches) writes R + C and returns at
//     once; a row stages and computes only up to its last live candidate.
//  2. Candidate-candidate distances come from the tensor cores: int8
//     mma.sync.m16n8k32 with s32 accumulators gives exact dot products,
//     L2 is n_i + n_j - 2 dot (the same int32 as sum((a - b)^2), taken
//     modulo 2^32 as that sum is) and MIPS is -dot. Each is rounded to f32
//     once, as the plain version rounds it, and tested as
//     alpha * d(i, c) <= d(p, c) in f32, so the rounds equal the plain
//     version's exactly.
//  3. The tests are made lazily, in strips of 16 candidates: when the star
//     first falls in strip s, the warp computes that strip's 16 rows
//     against every later candidate, two 8-candidate tiles a step (a pair
//     of tiles whose 16 candidates are all dead is skipped), and keeps
//     only the outcome: 16 rows of kill bits, one a candidate, in its
//     shared memory. No C x C matrix exists, and a strip no star falls in
//     is never made. f32 vectors have a second producer of these bits
//     (below) and share everything else.
//  4. A round is then bit arithmetic in registers: lane w holds live word
//     w (ceil(C / 32) words); a ballot and __ffs find the star (every
//     candidate before it is dead), and each lane clears its word's bits
//     that the star's kill row sets. The loop ends when no candidate is
//     live or after R rounds.
//  5. The row's vectors reach shared memory by cp.async in 16-byte copies
//     (8, 4 or plain loads where the array's alignment and d allow no
//     wider), d zero-padded to a multiple of 32. Vector rows are d + 16
//     bytes apart, an odd multiple of 16, so the 8 x 4 lanes of a fragment
//     load and the 8 lanes of a 16-byte norm load fall on distinct banks.
// A row's shared memory is (C rounded to 16) (d rounded to 32, + 16) bytes
// of vectors, 16 x C kill bits and 12 bytes a candidate: 14784 bytes at
// C = 96, d = 128; CTAs of one warp pack an SM's shared memory about as
// densely as CTAs of two or four rows would (each CTA also holds 1 KB the
// card reserves), and a short row frees its share at once. A row that does
// not fit one CTA's 227 KB, or has more than 1024 candidates (32 live
// words), runs the global-memory variant: the same rounds on live words in
// shared memory, each lane computing its candidate's distance to the star
// from the vectors in device memory.
//
// f32 vectors: the strip producer runs on the f32 cores. Lane l takes
// candidate 32 w + l of each live word w from the strip's first word on and
// sums its 16 dot products with the strip's rows over the d values in
// order, one rounded multiply and one rounded add a term (no fused
// multiply-add); the squared norms are summed once a row in the same order.
// L2 is max((n_i - 2 dot) + n_j, 0) and MIPS -dot, as the plain version
// (ops/kernels/occlude.py:pairwise_ordered) computes them in the same
// order, so the rounds are equal bit for bit. The global-memory variant
// computes the same three sums from device memory. An f32 row takes 4x the
// shared memory of an int8 row: 51 KB at C = 96, d = 128 (4 rows an SM).
// What bounds it: the star strips' 2 C d f32 operations a star against the
// 67 TFLOP/s f32 rate, near the row bytes' time at 3.35 TB/s; tensor cores
// (3xTF32, as flatscan.cu) are later work.

#include <atomic>
#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kStrip = 16;         // candidates a strip: the m of one mma
constexpr int kMaxLiveWords = 32;  // one a lane
constexpr int kSmemBlock = 227 * 1024;

// One row's shared workspace (bytes); the host computes it, the kernel
// reads it.
struct Layout {
  int Cv;  // candidate rows stored: C rounded up to 16
  int dp;  // bytes a vector: d values rounded up to 32 bytes, zeros past d
  int vs;  // vector row stride: dp + 16
  int W;   // live words: ceil(C / 32); also the words of a kill row
  int kill_off, dist_off, norm_off, bytes;
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

Layout make_layout(int C, int d, int elem_bytes) {
  Layout L;
  L.Cv = round_up(C, kStrip);
  L.dp = round_up(d * elem_bytes, 32);
  L.vs = L.dp + 16;
  L.W = (C + 31) / 32;
  L.kill_off = L.Cv * L.vs;
  L.dist_off = L.kill_off + kStrip * L.W * 4;
  L.norm_off = L.dist_off + L.W * 32 * 4;
  L.bytes = round_up(L.norm_off + L.Cv * 4, 16);
  return L;
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A B + D on one m16n8k32 int8 fragment (PTX ISA, "Matrix Fragments
// for mma.m16n8k32" with .s8): A row-major 16 x 32, a0 (g, 4t..4t+3), a1
// (g + 8, 4t..), a2 (g, 16 + 4t..), a3 (g + 8, 16 + 4t..); B column-major
// 32 x 8, b0 (4t..4t+3, g), b1 (16 + 4t.., g); C/D c0 (g, 2t), c1 (g,
// 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1); g = lane / 4, t = lane % 4.
// Both operands are candidate-major rows of the staged vectors.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bits 0..3 of x to bits 0, 2, 4, 6.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  return (x & 1u) | ((x & 2u) << 1) | ((x & 4u) << 2) | ((x & 8u) << 3);
}

// Read a row's distances, write R + C to its rounds and make its live words
// (a candidate lives unless its distance is >= INF, as in the plain
// version): lane w keeps word w in `mine` (for w < 32), and `live` (W
// words), `sd` (32 W floats) receive the words and the distances when not
// null. Returns 1 + the last live candidate, 0 if none.
__device__ __forceinline__ int init_row(const float* db, int* rb, float* sd, unsigned* live,
                                        unsigned& mine, int C, int R, int W, int lane) {
  int n_live = 0;
  mine = 0;
  for (int w = 0; w < W; ++w) {
    const int c = 32 * w + lane;
    float x = pa::kInf;
    if (c < C) {
      x = db[c];
      rb[c] = R + C;
    }
    if (sd != nullptr) sd[c] = x;
    const unsigned m = __ballot_sync(pa::kFullMask, !(x >= pa::kInf));
    if (lane == w) mine = m;
    if (live != nullptr && lane == 0) live[w] = m;
    if (m) n_live = 32 * w + 32 - __clz(static_cast<int>(m));
  }
  __syncwarp();
  return n_live;
}

// Strip s of an int8 row: kill bit (i, c) = alpha * d(16 s + i, c) <=
// d(p, c) for the candidates c of every pair of 8-candidate tiles with a
// live one, from int8 mma.sync products. Bits of skipped tiles, of columns
// before the strip and past n_live, and of rows past n_live (never staged)
// are never written or are garbage: they only meet dead candidates, whose
// live bits are already clear.
template <bool kMips>
__device__ __forceinline__ void make_strip_s8(int s, const int8_t* sv, const float* sd,
                                              const int* nrm, unsigned* kill, unsigned live,
                                              float alpha, int n_live, const Layout& L,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  unsigned char* kill_bytes = reinterpret_cast<unsigned char*>(kill);
  const int r0 = s * kStrip;
  const int8_t* a_lo = sv + (r0 + g) * L.vs + 4 * t;
  const int8_t* a_hi = a_lo + 8 * L.vs;
  for (int n0 = r0; n0 < n_live; n0 += 16) {
    const unsigned word = __shfl_sync(pa::kFullMask, live, n0 >> 5);
    if (((word >> (n0 & 31)) & 0xffffu) == 0) continue;
    const int8_t* bp = sv + (n0 + g) * L.vs + 4 * t;
    int acc[2][4] = {};
    for (int k0 = 0; k0 < L.dp; k0 += 32) {
      const uint32_t a[4] = {ld32(a_lo + k0), ld32(a_hi + k0), ld32(a_lo + k0 + 16),
                             ld32(a_hi + k0 + 16)};
      mma_s8(acc[0], a, ld32(bp + k0), ld32(bp + k0 + 16));
      mma_s8(acc[1], a, ld32(bp + 8 * L.vs + k0), ld32(bp + 8 * L.vs + k0 + 16));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 8 * h + 2 * t;
      const float2 dpc = *reinterpret_cast<const float2*>(sd + col);
      unsigned bits[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float dic;
        if (kMips) {
          dic = -static_cast<float>(acc[h][i]);
        } else {
          // unsigned: the int32 wraps exactly as sum((a - b)^2) would
          const unsigned l2 = static_cast<unsigned>(nrm[r0 + g + 8 * (i >> 1)]) +
                              static_cast<unsigned>(nrm[col + (i & 1)]) -
                              2u * static_cast<unsigned>(acc[h][i]);
          dic = static_cast<float>(static_cast<int>(l2));
        }
        bits[i] = __ballot_sync(pa::kFullMask, alpha * dic <= ((i & 1) ? dpc.y : dpc.x));
      }
      if (t == 0) {  // lane 4g + t holds columns 2t, 2t + 1 of rows g, g + 8
        const int at = (n0 >> 3) + h, sh = 4 * g;
        kill_bytes[g * 4 * L.W + at] = static_cast<unsigned char>(
            spread4(bits[0] >> sh) | (spread4(bits[1] >> sh) << 1));
        kill_bytes[(g + 8) * 4 * L.W + at] = static_cast<unsigned char>(
            spread4(bits[2] >> sh) | (spread4(bits[3] >> sh) << 1));
      }
    }
  }
  __syncwarp();
}

// The pair distance of f32 vectors from their dot product and squared
// norms, as the plain version forms it: -dot (MIPS) or max((n_i - 2 dot) +
// n_j, 0) (L2).
template <bool kMips>
__device__ __forceinline__ float pair_f32(float dot, float ni, float nj) {
  if (kMips) return -dot;
  return fmaxf(__fadd_rn(__fsub_rn(ni, __fmul_rn(2.f, dot)), nj), 0.f);
}

// Strip s of an f32 row: the same kill bits from f32 dot products. Lane l
// takes candidate 32 w + l of each live word w from the strip's first word
// and sums its 16 dot products with the strip's rows over the values in
// order (the zeros past d add nothing); a ballot a strip row gives the
// word. The bits of skipped words, columns before the strip and rows past
// n_live are garbage as above, and only meet dead candidates.
template <bool kMips>
__device__ __forceinline__ void make_strip_f32(int s, const char* sv, const float* sd,
                                               const float* nrm, unsigned* kill, unsigned live,
                                               float alpha, int n_live, const Layout& L,
                                               int lane) {
  const int r0 = s * kStrip;
  const int slots = L.dp / 16;
  const int words = (n_live + 31) >> 5;
  for (int w = r0 >> 5; w < words; ++w) {
    if (__shfl_sync(pa::kFullMask, live, w) == 0) continue;
    const int c = 32 * w + lane;
    float acc[kStrip];
#pragma unroll
    for (int i = 0; i < kStrip; ++i) acc[i] = 0.f;
    if (c < n_live) {
      const float4* y = reinterpret_cast<const float4*>(sv + c * L.vs);
      for (int k = 0; k < slots; ++k) {
        const float4 b = y[k];
#pragma unroll
        for (int i = 0; i < kStrip; ++i) {
          const float4 a = reinterpret_cast<const float4*>(sv + (r0 + i) * L.vs)[k];
          acc[i] = __fadd_rn(acc[i], __fmul_rn(a.x, b.x));
          acc[i] = __fadd_rn(acc[i], __fmul_rn(a.y, b.y));
          acc[i] = __fadd_rn(acc[i], __fmul_rn(a.z, b.z));
          acc[i] = __fadd_rn(acc[i], __fmul_rn(a.w, b.w));
        }
      }
    }
    const float dpc = sd[c];
    const float nc = kMips || c >= n_live ? 0.f : nrm[c];
#pragma unroll
    for (int i = 0; i < kStrip; ++i) {
      const float ni = kMips ? 0.f : nrm[r0 + i];
      const bool k = c < n_live && __fmul_rn(alpha, pair_f32<kMips>(acc[i], ni, nc)) <= dpc;
      const unsigned bits = __ballot_sync(pa::kFullMask, k);
      if (lane == 0) kill[i * L.W + w] = bits;
    }
  }
  __syncwarp();
}

template <bool kMips, typename T>
__global__ void __launch_bounds__(32)
occlusion_strip_kernel(const float* __restrict__ dist, const T* __restrict__ vecs,
                       float alpha, int* __restrict__ rounds, int C, int d, int R, int vec,
                       Layout L) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, b = blockIdx.x;
  char* sv = reinterpret_cast<char*>(smem);
  unsigned* kill = reinterpret_cast<unsigned*>(smem + L.kill_off);  // 16 rows of W words
  float* sd = reinterpret_cast<float*>(smem + L.dist_off);
  int* nrm = reinterpret_cast<int*>(smem + L.norm_off);  // int32 (int8) or f32 norms
  float* nrm_f = reinterpret_cast<float*>(nrm);
  int* rb = rounds + static_cast<size_t>(b) * C;

  unsigned live;  // lane w: live word w
  const int n_live =
      init_row(dist + static_cast<size_t>(b) * C, rb, sd, nullptr, live, C, R, L.W, lane);
  if (n_live == 0) return;

  // stage vectors [0, n_live) as 16-byte slots, zeros past d
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const char* vb = reinterpret_cast<const char*>(vecs) + static_cast<size_t>(b) * C * row_bytes;
  const int slots = L.dp / 16;
  for (int i = lane; i < n_live * slots; i += 32) {
    const int c = i / slots, j = i - c * slots;
    pa::stage_slot(sv + c * L.vs + 16 * j, vb + static_cast<size_t>(c) * row_bytes + 16 * j,
                   reinterpret_cast<const char*>(vecs), min(max(row_bytes - 16 * j, 0), 16),
                   vec);
  }
  pa::cp_async_commit();
  pa::cp_async_wait_all();
  __syncwarp();
  if (!kMips) {
    for (int c = lane; c < n_live; c += 32) {
      const int4* row = reinterpret_cast<const int4*>(sv + c * L.vs);
      if constexpr (kF32) {
        float acc = 0.f;
        for (int j = 0; j < slots; ++j) {
          const float4 v = reinterpret_cast<const float4*>(row)[j];
          acc = __fadd_rn(acc, __fmul_rn(v.x, v.x));
          acc = __fadd_rn(acc, __fmul_rn(v.y, v.y));
          acc = __fadd_rn(acc, __fmul_rn(v.z, v.z));
          acc = __fadd_rn(acc, __fmul_rn(v.w, v.w));
        }
        nrm_f[c] = acc;
      } else {
        int acc = 0;
        for (int j = 0; j < slots; ++j) {
          const int4 v = row[j];
          acc = __dp4a(v.x, v.x, acc);
          acc = __dp4a(v.y, v.y, acc);
          acc = __dp4a(v.z, v.z, acc);
          acc = __dp4a(v.w, v.w, acc);
        }
        nrm[c] = acc;
      }
    }
    __syncwarp();
  }

  int made = -1;  // the strip in shared memory
  for (int r = 0; r < R; ++r) {
    const unsigned nz = __ballot_sync(pa::kFullMask, live != 0);
    if (nz == 0) break;
    const int w = __ffs(static_cast<int>(nz)) - 1;  // every word before is dead
    const unsigned lw = __shfl_sync(pa::kFullMask, live, w);
    const int star = 32 * w + __ffs(static_cast<int>(lw)) - 1;
    if (lane == w) live = lw & (lw - 1);
    if (lane == 0) rb[star] = r;
    if (star / kStrip != made) {
      made = star / kStrip;
      if constexpr (kF32)
        make_strip_f32<kMips>(made, sv, sd, nrm_f, kill, live, alpha, n_live, L, lane);
      else
        make_strip_s8<kMips>(made, reinterpret_cast<const int8_t*>(sv), sd, nrm, kill, live,
                             alpha, n_live, L, lane);
    }
    if (lane < L.W) live &= ~kill[(star % kStrip) * L.W + lane];
  }
}

// The same rounds for a row too large for the kernel above: only the live
// words sit in shared memory (W words); each lane computes its
// candidate's distance to the star from device memory (int8: in int32;
// f32: the dot product and both squared norms in the strip producer's
// order) and one ballot a word clears the occluded ones.
template <bool kMips, typename T>
__global__ void __launch_bounds__(32)
occlusion_global_kernel(const float* __restrict__ dist, const T* __restrict__ vecs,
                        float alpha, int* __restrict__ rounds, int C, int d, int R, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, b = blockIdx.x;
  unsigned* live = reinterpret_cast<unsigned*>(smem);
  const float* db = dist + static_cast<size_t>(b) * C;
  int* rb = rounds + static_cast<size_t>(b) * C;
  unsigned unused;
  const int n_live = init_row(db, rb, nullptr, live, unused, C, R, W, lane);
  const T* vb = vecs + static_cast<size_t>(b) * C * d;
  const int n_words = (n_live + 31) >> 5;
  int star = -1;
  for (int r = 0; r < R; ++r) {
    int w = (star + 1) >> 5;  // every candidate before the star is dead
    unsigned lw = 0;
    for (; w < n_words; ++w) {
      lw = live[w];
      if (lw) break;
    }
    if (w >= n_words) break;
    star = 32 * w + __ffs(static_cast<int>(lw)) - 1;
    lw &= lw - 1;
    if (lane == 0) {
      live[w] = lw;
      rb[star] = r;
    }
    __syncwarp();
    const T* x = vb + static_cast<size_t>(star) * d;
    for (int ww = w; ww < n_words; ++ww) {
      const unsigned m = ww == w ? lw : live[ww];
      if (m == 0) continue;
      const int c = 32 * ww + lane;
      bool kill = false;
      if ((m >> lane) & 1u) {
        const T* y = vb + static_cast<size_t>(c) * d;
        if constexpr (std::is_same<T, float>::value) {
          float dot = 0.f, nx = 0.f, ny = 0.f;
          for (int k = 0; k < d; ++k) {
            const float p = x[k], q = y[k];
            dot = __fadd_rn(dot, __fmul_rn(p, q));
            if (!kMips) {
              nx = __fadd_rn(nx, __fmul_rn(p, p));
              ny = __fadd_rn(ny, __fmul_rn(q, q));
            }
          }
          kill = __fmul_rn(alpha, pair_f32<kMips>(dot, nx, ny)) <= db[c];
        } else {
          unsigned acc = 0;
          for (int k = 0; k < d; ++k) {
            const int p = x[k], q = y[k];
            acc += static_cast<unsigned>(kMips ? p * q : (p - q) * (p - q));
          }
          const float dsc = kMips ? -static_cast<float>(static_cast<int>(acc))
                                  : static_cast<float>(static_cast<int>(acc));
          kill = alpha * dsc <= db[c];
        }
      }
      const unsigned k = __ballot_sync(pa::kFullMask, kill);
      if (k && lane == 0) live[ww] = m & ~k;
    }
    __syncwarp();
  }
}

// Let a launch of occlusion_strip_kernel<kMips, T> on the current device
// take `bytes` of dynamic shared memory, with shared memory preferred over
// L1 (the kernel reads each byte once). The attributes persist, so they are
// set only when a launch needs more than any launch before it on that
// device.
template <bool kMips, typename T>
cudaError_t allow_strip_smem(int bytes) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> granted[kMaxDevices];  // bytes allowed so far
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* g = dev < kMaxDevices ? &granted[dev] : nullptr;
  if (g != nullptr && bytes <= g->load()) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mu);
  if (g != nullptr && bytes <= g->load()) return cudaSuccess;
  const auto kernel = &occlusion_strip_kernel<kMips, T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && g != nullptr) g->store(bytes);
  return err;
}

template <bool kMips, typename T>
cudaError_t launch(const float* dist, const T* vecs, float alpha, int* rounds, int B, int C,
                   int d, int R, cudaStream_t st) {
  const Layout L = make_layout(C, d, sizeof(T));
  if (L.W <= kMaxLiveWords && L.bytes <= kSmemBlock) {
    const cudaError_t err = allow_strip_smem<kMips, T>(L.bytes);
    if (err != cudaSuccess) return err;
    // the widest copy that the base address and the row length keep aligned
    const int row_bytes = d * static_cast<int>(sizeof(T));
    const uintptr_t addr = reinterpret_cast<uintptr_t>(vecs);
    int vec = 16;
    while (vec > 1 && ((addr % vec) != 0 || row_bytes % vec != 0)) vec /= 2;
    occlusion_strip_kernel<kMips, T><<<B, 32, L.bytes, st>>>(dist, vecs, alpha, rounds, C, d, R,
                                                             vec, L);
    return cudaGetLastError();
  }
  occlusion_global_kernel<kMips, T><<<B, 32, L.W * sizeof(unsigned), st>>>(
      dist, vecs, alpha, rounds, C, d, R, L.W);
  return cudaGetLastError();
}

template <typename T>
int launch_metric(const void* dist, const void* vecs, float alpha, void* rounds, int B, int C,
                  int d, int R, int mips, void* stream) {
  const auto* df = static_cast<const float*>(dist);
  const auto* v = static_cast<const T*>(vecs);
  auto* ri = static_cast<int*>(rounds);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = mips ? launch<true, T>(df, v, alpha, ri, B, C, d, R, st)
                               : launch<false, T>(df, v, alpha, ri, B, C, d, R, st);
  return static_cast<int>(err);
}

}  // namespace

// f32: the candidate vectors are float32 (else int8).
extern "C" int pa_occlusion_rounds(const void* dist, const void* vecs, float alpha,
                                   void* rounds, int B, int C, int d, int R, int mips, int f32,
                                   void* stream) {
  if (B == 0) return 0;
  return f32 ? launch_metric<float>(dist, vecs, alpha, rounds, B, C, d, R, mips, stream)
             : launch_metric<int8_t>(dist, vecs, alpha, rounds, B, C, d, R, mips, stream);
}
