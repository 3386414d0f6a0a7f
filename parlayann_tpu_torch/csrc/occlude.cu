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
// f32 vectors (redesigned for the card's tensor cores). The strip producer
// is the int8 one's shape on 3xTF32 mma.sync.m16n8k8 (tf32.cuh, the
// split_tf32_rz split): the strip's 16 rows are the mma's m, two
// 8-candidate tiles a step, each candidate dot product kept in three
// accumulators (hi.hi, lo.hi, hi.lo; three independent chains) and taken
// as t = big + (lo1 + lo2). Fragments are 4-byte loads from the staged
// rows: the row stride is d rounded up to 8 floats, + 4, which is 4 times
// an odd number modulo 32 banks, so lanes (g, t) of a fragment load hit
// the 32 banks 4 perm(g) + t once each for every d. An f32 row takes 52 KB
// of shared memory at C = 96, d = 128, so an SM holds only 4 rows; one
// warp a row left each SMSP a single warp, whose dependent loads, splits
// and mma chains it could not hide (0.20 ms at (96, 32) L2 on an NVIDIA
// H100 80GB HBM3 at 700 W, scripts/time_flat_topk.py --kernel occlusion
// --f32; 0.11 ms with four warps). So an f32 row has 4 warps: they stage its vectors and sum its norms
// together, each makes every 4th tile pair of a strip, and all run the
// same rounds on their own copies of the live words (warp 0 writes the
// rounds); a barrier follows each strip, whose kill bits alternate between
// two buffers so a warp still reading the last strip never meets the next.
//
// The plain version (ops/kernels/occlude.py:pairwise_ordered) sums each
// dot product s serially, one rounded multiply and one rounded add a term,
// and decides alpha * pair(s) <= d(p, c) with pair = max((n_i - 2 s) + n_j,
// 0) (L2) or -s (MIPS) and the serially summed squared norms n. The kernel
// decides from t wherever |alpha * pair(t) - d(p, c)| > M, a margin that
// bounds |alpha * pair(t) - alpha * pair(s)|; inside it the lane recomputes
// s serially from the staged rows, so the rounds stay equal to the plain
// version's bit for bit. Only tests the rounds can read are rechecked: the
// star's row and the strip's live rows against live later candidates.
//
// The margin (u = 2^-24; S = sum_k |a_k b_k| of the pair's vectors):
//  - s: recursive summation of rounded products, |s - a.b| <= g_d S with
//    g_d = d u / (1 - d u).
//  - t, the split: hi = a toward zero in TF32, |a - hi| < 2^-10 |a|; lo =
//    a - hi exactly, read by the mma as lo' with |lo - lo'| < 2^-10 |lo|
//    (truncated or rounded), so a = hi + lo' + e, |e| < 2^-20 |a|. The
//    products dropped (lo'_a lo'_b and the e terms) are below 3.01 2^-20
//    |a b|; TF32 products are exact. The tensor core's f32 sum is not
//    documented as IEEE: take each mma (8 products into an accumulator) to
//    lose up to 2^-23 of the largest addend's magnitude on each of its 9
//    addends and 2^-23 of its result, 10 2^-23 of the chain's sum of
//    |terms| an mma, over ceil(d / 8) mma a chain; the three chains'
//    |terms| sum to at most (1 + 2^-8) S. The two f32 adds of t add 2^-23
//    S. Subnormal products and sums that the tensor core flushes add at
//    most 2^-100 in all (d < 2^20).
//  - So |t - s| <= E = c_d S + 2^-100, c_d = 3.01 2^-20 + 2^-23 (1 + 10.04
//    ceil(d / 8)) + g_d, and S <= sqrt(n_i n_j) (1 + 2 g_d) (Cauchy-Schwarz
//    on the exact squared norms, which the serial n underestimate by at most
//    g_d).
//  - L2: the two rounded adds of pair and the rounded alpha multiply each
//    err by u of operands at most 2.02 (n_i + n_j), so |alpha pair(t) -
//    alpha pair(s)| <= alpha (2 E + 12.2 u (n_i + n_j)); MIPS: alpha (E +
//    2.01 u S).
//  - The kernel's M is 4 times that: L2 8 alpha E + 52 alpha u (n_i + n_j),
//    MIPS 4 alpha (E + 3 u S), formed per test as a1 sqrt(n_i) sqrt(n_j) +
//    a2 (n_i + n_j) + a0 (make_margin; the 4x absorbs the rounding of M
//    itself). ops/kernels/occlude.py:occlusion_margin is the same formula,
//    and tests/test_torch_occlude_tf32.py checks it against emulated
//    3xTF32 sums in several orders. A NaN or infinite value falls inside
//    the margin and is rechecked.
// At d = 128 M is about 2.9e-4 of sqrt(n_i n_j) (L2, alpha 1.2): about
// 0.037 on the build's normal rows, whose distances are near 256; 0.04% of
// the L2 tests and 0.09% of the MIPS tests fall inside it there (chip_smoke
// phase 2 prints the share). The global-memory variant keeps the serial
// loop. What bounds it: bytes at (96, 32), the star strips' 3 x 2 C d TF32
// operations (3xTF32) taking about a third of the row bytes' time at 495
// TFLOP/s.

#include <atomic>
#include <cfloat>
#include <cmath>
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

namespace {

constexpr int kStrip = 16;         // candidates a strip: the m of one mma
constexpr int kMaxLiveWords = 32;  // one a lane
constexpr int kSmemBlock = 227 * 1024;
constexpr int kF32Warps = 4;       // warps an f32 row (int8 rows: one)

// One row's shared workspace (bytes); the host computes it, the kernel
// reads it.
struct Layout {
  int Cv;  // candidate rows stored: C rounded up to 16
  int dp;  // bytes a vector: d values rounded up to 32 bytes, zeros past d
  int vs;  // vector row stride: dp + 16
  int W;   // live words: ceil(C / 32); also the words of a kill row
  int kill_off, dist_off, norm_off, rnorm_off, bytes;
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

Layout make_layout(int C, int d, int elem_bytes) {
  Layout L;
  L.Cv = round_up(C, kStrip);
  L.dp = round_up(d * elem_bytes, 32);
  L.vs = L.dp + 16;
  L.W = (C + 31) / 32;
  L.kill_off = L.Cv * L.vs;
  // f32 rows keep two strips of kill bits (their warps make one while
  // others may still read the last)
  L.dist_off = L.kill_off + (elem_bytes == 4 ? 2 : 1) * kStrip * L.W * 4;
  L.norm_off = L.dist_off + L.W * 32 * 4;
  L.rnorm_off = L.norm_off + L.Cv * 4;  // f32: the norms' square roots
  L.bytes = round_up(L.rnorm_off + (elem_bytes == 4 ? L.Cv * 4 : 0), 16);
  return L;
}

// The f32 margin's coefficients (the header's derivation): M = a1
// sqrt(n_i) sqrt(n_j) + a2 (n_i + n_j) + a0.
struct Margin {
  float a1, a2, a0;
};

Margin make_margin(int d, float alpha, bool mips) {
  const double u = std::ldexp(1.0, -24), e_abs = std::ldexp(1.0, -100);
  const double g = d * u / (1.0 - d * u);
  const double c =
      3.01 * std::ldexp(1.0, -20) + std::ldexp(1.0, -23) * (1.0 + 10.04 * ((d + 7) / 8)) + g;
  const double s = 1.0 + 2.0 * g, a = std::fabs(static_cast<double>(alpha));
  if (mips) return {static_cast<float>(4 * a * (c + 3 * u) * s), 0.f,
                    static_cast<float>(4 * a * e_abs)};
  return {static_cast<float>(8 * a * c * s), static_cast<float>(52 * a * u),
          static_cast<float>(8 * a * e_abs)};
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

// Store one 8-candidate tile's kill bits, byte `at` of strip rows g and
// g + 8: bits[i] is the warp's ballot of accumulator i of an m16n8
// fragment (lane 4g + t holds columns 2t, 2t + 1 of rows g, g + 8).
__device__ __forceinline__ void store_tile_bits(unsigned* kill, const unsigned (&bits)[4],
                                                int g, int t, int at, int W) {
  if (t != 0) return;
  unsigned char* kill_bytes = reinterpret_cast<unsigned char*>(kill);
  const int sh = 4 * g;
  kill_bytes[g * 4 * W + at] =
      static_cast<unsigned char>(spread4(bits[0] >> sh) | (spread4(bits[1] >> sh) << 1));
  kill_bytes[(g + 8) * 4 * W + at] =
      static_cast<unsigned char>(spread4(bits[2] >> sh) | (spread4(bits[3] >> sh) << 1));
}

// Read a row's distances, write R + C to its rounds and make its live words
// (a candidate lives unless its distance is >= INF, as in the plain
// version): lane w keeps word w in `mine` (for w < 32), and `rb` (the
// rounds), `live` (W words), `sd` (32 W floats) receive R + C, the words
// and the distances when not null. Returns 1 + the last live candidate, 0
// if none.
__device__ __forceinline__ int init_row(const float* db, int* rb, float* sd, unsigned* live,
                                        unsigned& mine, int C, int R, int W, int lane) {
  int n_live = 0;
  mine = 0;
  for (int w = 0; w < W; ++w) {
    const int c = 32 * w + lane;
    float x = pa::kInf;
    if (c < C) {
      x = db[c];
      if (rb != nullptr) rb[c] = R + C;
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
      store_tile_bits(kill, bits, g, t, (n0 >> 3) + h, L.W);
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

// The serial dot product of two staged f32 rows over kw values (a multiple
// of 4; the zeros past d add nothing): one rounded multiply and one
// rounded add a term, in order, as the plain version sums it.
__device__ __forceinline__ float serial_dot(const float* x, const float* y, int kw) {
  float acc = 0.f;
  for (int j = 0; j < kw; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + j);
    const float4 b = *reinterpret_cast<const float4*>(y + j);
    acc = __fadd_rn(acc, __fmul_rn(a.x, b.x));
    acc = __fadd_rn(acc, __fmul_rn(a.y, b.y));
    acc = __fadd_rn(acc, __fmul_rn(a.z, b.z));
    acc = __fadd_rn(acc, __fmul_rn(a.w, b.w));
  }
  return acc;
}

// Strip s of an f32 row (its star is `star`): the same kill bits from
// 3xTF32 mma.sync products, each test decided from the tensor-core dot t
// outside the margin and from the serial dot inside it (the header). Warp
// `warp` makes every kF32Warps-th pair of tiles. Rows
// g, g + 8 of the m16n8k8 fragment are strip rows, its columns the
// candidates of one 8-candidate tile, and its k the values of the staged
// rows, 8 a step. The bits of skipped tiles, of columns before the strip
// and of rows past n_live are garbage as in the int8 producer; so are
// the bits of dead rows and columns, which are never rechecked. `counts`
// (null: no count) gains the tests the rounds can read and the rechecks.
template <bool kMips>
__device__ __forceinline__ void make_strip_f32(int s, int star, const float* sv, const float* sd,
                                               const float* nrm, const float* rnm,
                                               unsigned* kill, unsigned live, float alpha,
                                               Margin mg, int n_live, const Layout& L,
                                               int lane, int warp, unsigned long long* counts) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = s * kStrip;
  const int vw = L.vs / 4, kw = L.dp / 4;  // floats a staged row; values a dot runs over
  const float* a_lo = sv + (r0 + g) * vw + t;
  const float* a_hi = a_lo + 8 * vw;
  // the rows whose kill bits a round may read: the star and the live rows
  const unsigned need = ((__shfl_sync(pa::kFullMask, live, r0 >> 5) >> (r0 & 31)) & 0xffffu) |
                        (1u << (star - r0));
  const float n_row[2] = {nrm[r0 + g], nrm[r0 + g + 8]};
  const float rn_row[2] = {rnm[r0 + g], rnm[r0 + g + 8]};
  unsigned tests = 0, rechecks = 0;
  for (int n0 = r0 + 16 * warp; n0 < n_live; n0 += 16 * kF32Warps) {
    const unsigned cols = (__shfl_sync(pa::kFullMask, live, n0 >> 5) >> (n0 & 31)) & 0xffffu;
    if (cols == 0) continue;
    const float* bp = sv + (n0 + g) * vw + t;
    float big[2][4] = {}, lo1[2][4] = {}, lo2[2][4] = {};
    for (int k0 = 0; k0 < kw; k0 += 8) {
      uint32_t ah[4], al[4];
      pa::split_tf32_rz(a_lo[k0], ah[0], al[0]);
      pa::split_tf32_rz(a_hi[k0], ah[1], al[1]);
      pa::split_tf32_rz(a_lo[k0 + 4], ah[2], al[2]);
      pa::split_tf32_rz(a_hi[k0 + 4], ah[3], al[3]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* b = bp + 8 * h * vw + k0;
        uint32_t bh0, bl0, bh1, bl1;
        pa::split_tf32_rz(b[0], bh0, bl0);
        pa::split_tf32_rz(b[4], bh1, bl1);
        pa::mma_tf32(lo1[h], al, bh0, bh1);
        pa::mma_tf32(lo2[h], ah, bl0, bl1);
        pa::mma_tf32(big[h], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 8 * h + 2 * t;
      const float2 dpc = *reinterpret_cast<const float2*>(sd + col);
      const float2 n_col = *reinterpret_cast<const float2*>(nrm + col);
      const float2 rn_col = *reinterpret_cast<const float2*>(rnm + col);
      unsigned k_bits = 0, unsure = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = g + 8 * (i >> 1), c = col + (i & 1);
        const float ni = n_row[i >> 1], nj = (i & 1) ? n_col.y : n_col.x;
        const float dp = (i & 1) ? dpc.y : dpc.x;
        const float dot = __fadd_rn(big[h][i], __fadd_rn(lo1[h][i], lo2[h][i]));
        const float v = __fmul_rn(alpha, pair_f32<kMips>(dot, ni, nj));
        float m = fmaf(mg.a1, rn_row[i >> 1] * ((i & 1) ? rn_col.y : rn_col.x), mg.a0);
        if (!kMips) m = fmaf(mg.a2, ni + nj, m);
        const bool rel = ((need >> row) & (cols >> (c - n0)) & 1u) && c > r0 + row;
        tests += rel;
        k_bits |= static_cast<unsigned>(v <= dp) << i;
        if (rel && !(fabsf(v - dp) > m && fabsf(v) <= FLT_MAX)) unsure |= 1u << i;
      }
      rechecks += __popc(unsure);
      while (unsure) {  // inside the margin: the plain version's serial sums
        const int i = __ffs(static_cast<int>(unsure)) - 1;
        unsure &= unsure - 1;
        const int row = r0 + g + 8 * (i >> 1), c = col + (i & 1);
        const float dot = serial_dot(sv + row * vw, sv + c * vw, kw);
        const float v = __fmul_rn(alpha, pair_f32<kMips>(dot, nrm[row], nrm[c]));
        k_bits = (k_bits & ~(1u << i)) | (static_cast<unsigned>(v <= sd[c]) << i);
      }
      unsigned bits[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bits[i] = __ballot_sync(pa::kFullMask, (k_bits >> i) & 1u);
      store_tile_bits(kill, bits, g, t, (n0 >> 3) + h, L.W);
    }
  }
  if (counts != nullptr) {
    tests = __reduce_add_sync(pa::kFullMask, tests);
    rechecks = __reduce_add_sync(pa::kFullMask, rechecks);
    if (lane == 0) {
      atomicAdd(counts, static_cast<unsigned long long>(tests));
      atomicAdd(counts + 1, static_cast<unsigned long long>(rechecks));
    }
  }
  __syncwarp();
}

template <bool kMips, typename T>
__global__ void __launch_bounds__(std::is_same<T, float>::value ? 32 * kF32Warps : 32)
occlusion_strip_kernel(const float* __restrict__ dist, const T* __restrict__ vecs,
                       float alpha, int* __restrict__ rounds, int C, int d, int R, int vec,
                       Layout L, Margin mg, unsigned long long* __restrict__ counts) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kWarps = kF32 ? kF32Warps : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.x;
  char* sv = reinterpret_cast<char*>(smem);
  unsigned* kill = reinterpret_cast<unsigned*>(smem + L.kill_off);  // 16 rows of W words
  float* sd = reinterpret_cast<float*>(smem + L.dist_off);
  int* nrm = reinterpret_cast<int*>(smem + L.norm_off);  // int32 (int8) or f32 norms
  float* nrm_f = reinterpret_cast<float*>(nrm);
  float* rnm = reinterpret_cast<float*>(smem + L.rnorm_off);  // f32: sqrt of the norms
  int* rb = rounds + static_cast<size_t>(b) * C;

  // lane w of every warp: live word w (the warps of an f32 row run the same
  // rounds on their own copies; warp 0 writes the outputs)
  unsigned live;
  const int n_live = init_row(dist + static_cast<size_t>(b) * C, warp == 0 ? rb : nullptr,
                              warp == 0 ? sd : nullptr, nullptr, live, C, R, L.W, lane);
  if (n_live == 0) return;

  // stage vectors [0, n_live) as 16-byte slots, zeros past d
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const char* vb = reinterpret_cast<const char*>(vecs) + static_cast<size_t>(b) * C * row_bytes;
  const int slots = L.dp / 16;
  for (int i = tid; i < n_live * slots; i += 32 * kWarps) {
    const int c = i / slots, j = i - c * slots;
    pa::stage_slot(sv + c * L.vs + 16 * j, vb + static_cast<size_t>(c) * row_bytes + 16 * j,
                   reinterpret_cast<const char*>(vecs), min(max(row_bytes - 16 * j, 0), 16),
                   vec);
  }
  pa::cp_async_commit();
  pa::cp_async_wait_all();
  if constexpr (kF32)
    __syncthreads();
  else
    __syncwarp();
  if constexpr (kF32) {  // both metrics: MIPS reads the norms for the margin only
    for (int c = tid; c < n_live; c += 32 * kWarps) {
      const float* row = reinterpret_cast<const float*>(sv + c * L.vs);
      const float n = serial_dot(row, row, L.dp / 4);
      nrm_f[c] = n;
      rnm[c] = sqrtf(n);
    }
    __syncthreads();
  } else if (!kMips) {
    for (int c = lane; c < n_live; c += 32) {
      const int4* row = reinterpret_cast<const int4*>(sv + c * L.vs);
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
    __syncwarp();
  }

  int made = -1, n_made = 0;  // the strip in shared memory, strips made
  unsigned* krow = kill;      // its kill bits
  for (int r = 0; r < R; ++r) {
    const unsigned nz = __ballot_sync(pa::kFullMask, live != 0);
    if (nz == 0) break;
    const int w = __ffs(static_cast<int>(nz)) - 1;  // every word before is dead
    const unsigned lw = __shfl_sync(pa::kFullMask, live, w);
    const int star = 32 * w + __ffs(static_cast<int>(lw)) - 1;
    if (lane == w) live = lw & (lw - 1);
    if (tid == 0) rb[star] = r;
    if (star / kStrip != made) {
      made = star / kStrip;
      if constexpr (kF32) {
        // a warp may still read the last strip's bits: alternate buffers
        krow = kill + (n_made++ & 1) * kStrip * L.W;
        make_strip_f32<kMips>(made, star, reinterpret_cast<const float*>(sv), sd, nrm_f, rnm,
                              krow, live, alpha, mg, n_live, L, lane, warp, counts);
        __syncthreads();
      } else {
        make_strip_s8<kMips>(made, reinterpret_cast<const int8_t*>(sv), sd, nrm, kill, live,
                             alpha, n_live, L, lane);
      }
    }
    if (lane < L.W) live &= ~krow[(star % kStrip) * L.W + lane];
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
                   int d, int R, unsigned long long* counts, cudaStream_t st) {
  const Layout L = make_layout(C, d, sizeof(T));
  if (L.W <= kMaxLiveWords && L.bytes <= kSmemBlock) {
    const cudaError_t err = allow_strip_smem<kMips, T>(L.bytes);
    if (err != cudaSuccess) return err;
    // the widest copy that the base address and the row length keep aligned
    const int row_bytes = d * static_cast<int>(sizeof(T));
    const uintptr_t addr = reinterpret_cast<uintptr_t>(vecs);
    int vec = 16;
    while (vec > 1 && ((addr % vec) != 0 || row_bytes % vec != 0)) vec /= 2;
    occlusion_strip_kernel<kMips, T><<<B, std::is_same<T, float>::value ? 32 * kF32Warps : 32,
                                       L.bytes, st>>>(
        dist, vecs, alpha, rounds, C, d, R, vec, L, make_margin(d, alpha, kMips), counts);
    return cudaGetLastError();
  }
  occlusion_global_kernel<kMips, T><<<B, 32, L.W * sizeof(unsigned), st>>>(
      dist, vecs, alpha, rounds, C, d, R, L.W);
  return cudaGetLastError();
}

template <typename T>
int launch_metric(const void* dist, const void* vecs, float alpha, void* rounds, int B, int C,
                  int d, int R, int mips, void* counts, void* stream) {
  const auto* df = static_cast<const float*>(dist);
  const auto* v = static_cast<const T*>(vecs);
  auto* ri = static_cast<int*>(rounds);
  auto* cn = static_cast<unsigned long long*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = mips ? launch<true, T>(df, v, alpha, ri, B, C, d, R, cn, st)
                               : launch<false, T>(df, v, alpha, ri, B, C, d, R, cn, st);
  return static_cast<int>(err);
}

}  // namespace

// f32: the candidate vectors are float32 (else int8). counts: null, or two
// uint64 on the device to which an f32 launch of the strip kernel adds the
// tests the rounds can read and the rechecks among them.
extern "C" int pa_occlusion_rounds(const void* dist, const void* vecs, float alpha,
                                   void* rounds, int B, int C, int d, int R, int mips, int f32,
                                   void* counts, void* stream) {
  if (B == 0) return 0;
  return f32 ? launch_metric<float>(dist, vecs, alpha, rounds, B, C, d, R, mips, counts, stream)
             : launch_metric<int8_t>(dist, vecs, alpha, rounds, B, C, d, R, mips, counts,
                                     stream);
}
