// Kernel 3: the fused beam search, one warp a query.
//
// Replaces parlayann_tpu/ops/pallas/fusedbeam.py:627 fused_step (kernel
// body _step_kernel :235 / _step_body :361) together with its driver
// beam_search_fused (:700), at E = 1 with loop dedup. Semantics follow
// search.beam.beam_search_batch at E = 1: seed the beam with the start
// vertices (a start listed twice counts once); then, per step, expand the
// nearest unexpanded beam entry, score its neighbours against the query,
// drop those at or beyond the beam's L-th distance and those already in
// the beam, merge the rest into the beam (distance, then packed
// id*2+unexpanded), and stop when no unexpanded entry lies within
// cut * d_k (L2 with 0 < k < L) or after `limit` expansions.
//
// It also replaces parlayann_tpu/ops/pallas/fusedbeam.py:952
// build_beam_fused, the fused read phase of the Vamana build, as a mode of
// the same walk: given the two visited outputs (Params::vis_ids, vis_dist),
// the lane that owns each selected entry writes (its id, its beam
// distance) to slot nv of the query's row as it clears the entry's bit,
// and the warp pads the row past the walk's nv expansions with (-1, INF).
// The build calls it at k = 0 (no cut) with limit = min(vmax, n_valid).
// The JAX function runs exactly vmax steps and lets stopped rows emit
// (-1, INF): the same rows as stopping at the limit and padding. A search
// passes null pointers, a uniform branch, so the six register-walk
// instantiations stay six.
//
// What bounds it on the H100: the steps, one after another in each warp. A
// query's step reads the expanded vertex's degree and adjacency row, then
// its neighbours' int8 rows, then sorts and merges a few dozen (distance,
// id) pairs before the next vertex is known; at B = 1024, L = 64 that is
// about 64 steps a query. With 12-16 such warps an SM the step's
// instructions, not its round trips, set the pace (measured below). Counted once per input byte, the walk there moves
// about 16.7 MB (73,699 distinct tier rows, the adjacency rows of 47,092
// distinct vertices, queries, starts and outputs: 5.0 us at 3.35 TB/s) and
// does 5.1e8 int8 operations (0.3 us at the 1,979 T/s int8 rate), so the
// card could finish in about 0.005 ms if the chains were not in the way.
// A step's memory round trips are L2 hits (the 12.8 MB int8 tier of 100K x
// 128 sits in the 50 MB L2); what a design can shorten is the work of a
// step and how many chains each SM runs. The build mode's walks are the
// same chains, each exactly min(vmax, converged) steps long (64 at R = 32,
// L = 64): one launch walks a steady batch of 16,000 (100K) or 40,000
// (1M) inserts, where the lock-step read launches kernel 1 once for every
// two of those steps. Its added stores are 8 bytes a visit.
//
// Design:
//  1. One warp walks one query; a CTA holds kWarps independent warps and
//     the walk loop has no __syncthreads, only shuffles, ballots and
//     __syncwarp. The grid is persistent: sized to fill every SM at the
//     occupancy the registers allow, each warp takes its next query from a
//     global counter (atomicAdd), so a long walk never holds a finished
//     warp's slot and the tail of a large batch stays balanced.
//  2. The beam lives in registers: W = max(pow2(L), 32) (distance, pack)
//     pairs, P = W / 32 a lane, element i = 32 r + lane in register r,
//     sorted ascending; lanes >= L hold the (INF, 2 n_valid + 1) sentinel.
//     A copy in the warp's shared memory (rewritten after each merge)
//     serves the beam's L-th distance, d_k and the duplicate test.
//  3. Scoring: lane j ends with neighbour j's distance (CP = max(pow2(R),
//     32) / 32 a lane). Each group of 8 lanes reads 8 rows at a time, one
//     16-byte read-only load a lane a row (8-, 4- or 1-byte loads where
//     the tier's alignment or d allow no wider), so a warp-wide load
//     touches 4 rows' 128-byte lines; all loads of a pass are issued
//     before the first is consumed, and a butterfly of 7 shuffles gives
//     every lane its own row's sum. A query that is integer-valued in
//     [-128, 127] (the q8 tier's translated queries) is scored with dp4a
//     in exact int32 (L2 as sum v^2 - 2 sum v q + sum q^2); any other in
//     f32. Rows that keep 16-byte loads aligned (the q8 tier at d a
//     multiple of 16) load their chunks without load-width tests. Seed and
//     step distances come from the same function (score_row32), so every
//     copy of a vertex's distance is bit-identical:
//     the hashless-dedup invariant. On int8 tiers with integer-valued
//     queries every distance is an exact integer below 2^24 and the kernel
//     equals the plain PyTorch version bit for bit.
//  4. A kept neighbour (valid, below the L-th distance) that is already in
//     the beam has the same distance as its beam copy, so a binary search
//     of the shared copy for (distance, 2 id) finds it: the plain version's
//     "already in the beam" rule. A step that keeps nothing ends there.
//     Otherwise the CP registers of candidates are sorted descending by a
//     shuffle bitonic network, min(beam[i], candidates[i]) (a half
//     cleaner, no shuffle in register-major order) leaves a bitonic
//     sequence holding the W smallest of both, and a shuffle bitonic merge
//     sorts it. Picking the next vertex is one ballot a register, __ffs and
//     a bit flip in the owning lane.
//  5. Registers serve beams up to 128 lanes over graphs of degree up to
//     64, in six instantiations (P = 1, 2, 4 x CP = 1, 2): the main path's
//     beams 10-64 over R = 32, bench.py's R = 64, L = 128 build (W = 128,
//     Nc = 64) and its searches up to L = 128. Four beam registers merge
//     in seven stages, two of them between a lane's own registers. Beams
//     wider than 128 lanes (L > 128, up to 4096) or rows of more than 64
//     neighbours (HCNNG's degree 90) run walk_smem: the same walk with the
//     beam and the candidates in the warp's shared memory and the same
//     networks run by the warp over it (a CTA of one warp). The (distance,
//     pack) order is unique, so both walks give the same bits.
//  6. The register walk does not score a vertex twice. A neighbour the
//     walk has already scored is in the beam, or at or past the beam's
//     L-th distance, which never grows: it cannot be kept, the plain
//     version's keep rule gives the same answer, so its tier row is not
//     read again (dist_cmps still counts it). The warp keeps the ids it
//     has scored in a direct-mapped table in its shared memory (min(32 W,
//     2048) slots, cleared for each query): lossy, a slot holding the
//     last id hashed there, but never wrong, a slot holding a whole id.
//     At the build's shapes 71-77% of step distances are found there.
//     The candidates left are packed to the front of the step's registers
//     (past one register, through the warp's shared memory), and a pass of
//     32 rows with none left is not scored.
// The query's staging, the scoring (pa::score32) and the networks live in
// warp.cuh, shared with kernel 5.
// Measured on an H100 (PERF.md): one lane reading a whole row touched 32
// lines a load instruction, and point 3's groups took 12-14% off at
// L = 64; scoring every query in f32 alone was 1.5-1.7x slower than dp4a
// at L = 64; merging by rank on steps that keep few candidates, and
// capping the 128 registers a thread for occupancy (spills), were both
// slower. In the build mode, as first measured: every walk used 128
// registers a thread, 16 resident warps an SM. Loading the next vertex's
// adjacency row a step ahead (the guess right on 79-95% of steps) was
// 1.5-9% slower, so it is not done; point 6's table took 9-12% off, the
// aligned loads 12-19% more, packing 64 candidates 14% more at R = 64,
// and the 128-register cap 14% more there (the aligned loads had taken
// walk_regs<4,2> to 168 registers, 12 warps). The walk is bound by the
// instructions of its steps, not by their round trips or their bytes.

#include "bitonic.cuh"
#include "warp.cuh"

namespace {

using pa::smem_merge;
using pa::smem_sort;
using pa::warp_merge;
using pa::warp_sort_desc;

constexpr int kWarps = 4;    // queries in flight a CTA of walk_regs
constexpr int kMaxRegP = 4;  // beam registers a lane: W <= 128
constexpr int kMaxRegC = 2;  // candidate registers a lane: pow2(R) <= 64
constexpr int kSmemC = 4;    // candidates a lane scores at once in walk_smem
constexpr int kSeenSlots = 2048;  // the register walk's table of scored ids, at most

struct Params {
  const float* queries;  // (B, d) f32, in the tier's domain
  const int8_t* tier;    // (n_pad, d) int8
  const int* nbrs;       // (n_pad, R) int32
  const int* degs;       // (n_pad,) int32
  const int* starts;     // (B, S) or (S,) int32
  int starts_stride;     // S, or 0 when every query shares one start row
  int B, d, R, S, n_valid, k, L, limit, use_cut, mips;
  int W;      // beam lanes: max(pow2(max(L, 8)), 32)
  int Nc;     // candidate lanes: max(pow2(R), 32)
  int vec;    // widest load the tier's base address and d keep aligned: 16, 8, 4, 1
  int nch;    // 16-byte chunks a row: ceil(d / 16)
  int slice;  // shared-memory bytes a warp
  float cut;
  int* counter;     // (1,) int32, zero at launch: the next query to take
  int* out_ids;     // (B, L), or null: the beam is not written
  float* out_dist;  // (B, L), or null
  int* out_nv;      // (B,)
  int* out_cmps;    // (B,)
  // the build mode: each expansion's (id, beam distance) in expansion
  // order, rows of vstride (-1, INF)-padded; null for a search
  int* vis_ids;     // (B, vstride)
  float* vis_dist;  // (B, vstride)
  int vstride;
  int seen_slots, seen_shift;  // the register walk's table of scored ids: 2^(32 - shift) slots
  // or null: gains the register walk's valid candidates and those it did
  // not score again
  unsigned long long* counts;  // (2,)
};

// Record expansion nv of query b: its id and its beam distance (the build
// mode only; called by the one lane that owns the entry).
__device__ __forceinline__ void record_visit(const Params& p, int b, int nv, int e,
                                             float dist) {
  if (p.vis_ids == nullptr) return;
  const size_t at = static_cast<size_t>(b) * p.vstride + nv;
  p.vis_ids[at] = e;
  p.vis_dist[at] = dist;
}

// Finish query b past its walk: pad its visited row from slot nv with
// (-1, INF) in the build mode, then write nv and the distance count.
__device__ __forceinline__ void finish_query(const Params& p, int b, int nv, int cmps,
                                             int lane) {
  if (p.vis_ids != nullptr) {
    int* vi = p.vis_ids + static_cast<size_t>(b) * p.vstride;
    float* vd = p.vis_dist + static_cast<size_t>(b) * p.vstride;
    for (int i = nv + lane; i < p.vstride; i += 32) {
      vi[i] = -1;
      vd[i] = pa::kInf;
    }
  }
  if (lane == 0) {
    p.out_nv[b] = nv;
    p.out_cmps[b] = cmps;
  }
}

// The distance from the warp's query to 32 tier rows: lane l gives the id
// of its row (< 0: none, INF) and receives its distance. Every distance of
// the kernel comes from here, so equal (query, row) pairs give equal bits.
// Rows that keep 16-byte loads aligned (vec = 16: the q8 tier of d a
// multiple of 16) take their chunks without the load-width tests.
__device__ __forceinline__ float score_row32(const Params& p, const pa::Query& q, int id,
                                             int lane) {
  const char* tier = reinterpret_cast<const char*>(p.tier);
  float dist;
  if (p.vec == 16) {
    const size_t rb = p.d;
    dist = pa::score32_by<int8_t>(
        q,
        [=](int r, int k) {
          return __ldg(reinterpret_cast<const int4*>(tier + static_cast<size_t>(r) * rb) + k);
        },
        p.nch, p.mips, id, lane);
  } else {
    dist = pa::score32<int8_t>(q, tier, p.d, p.nch, p.vec, p.mips, id, lane);
  }
  return id >= 0 ? dist : pa::kInf;
}

// score_row32 over 32 N rows: lane l gives ids[c] of row 32 c + l and
// receives its distance in out[c].
template <int N>
__device__ __forceinline__ void score_rows(const Params& p, const pa::Query& q,
                                           const int (&ids)[N], float (&out)[N], int lane) {
#pragma unroll
  for (int c = 0; c < N; ++c) out[c] = score_row32(p, q, ids[c], lane);
}

// Is (dist, id) in the sorted beam copy (md, mp) of W lanes? Its beam copy
// has the same distance and pack 2 id or 2 id + 1, so it is the first entry
// not below (dist, 2 id).
__device__ __forceinline__ bool in_beam(const float* md, const int* mp, int W, float dist,
                                        int id) {
  const int key = 2 * id;
  int pos = 0;
  for (int step = W >> 1; step > 0; step >>= 1) {
    if (pa::key_less(md[pos + step - 1], mp[pos + step - 1], dist, key)) pos += step;
  }
  return md[pos] == dist && (mp[pos] >> 1) == id;
}

// Seed a beam of W lanes in shared memory (sd, sp) for the warp's query:
// the valid starts, scored 32 at a time by score_rows, sorted, a start
// listed twice dropped (its copy sorts next to it), lanes >= L cleared.
// Returns the starts scored.
__device__ int seed_beam(const Params& p, const pa::Query& q, int b, float* sd, int* sp,
                          int lane) {
  const int W = p.W, sent = 2 * p.n_valid + 1;
  for (int i = lane; i < W; i += 32) {
    sd[i] = pa::kInf;
    sp[i] = sent;
  }
  __syncwarp();
  const int* st = p.starts + static_cast<size_t>(b) * p.starts_stride;
  int scored = 0;
  for (int base = 0; base < p.S; base += 32) {
    const int j = base + lane;
    const int s = j < p.S ? st[j] : -1;
    const int sid[1] = {s >= 0 && s < p.n_valid ? s : -1};
    float dist[1];
    score_rows<1>(p, q, sid, dist, lane);
    if (sid[0] >= 0) {
      sd[j] = dist[0];
      sp[j] = 2 * sid[0] + 1;
    }
    scored += __popc(__ballot_sync(pa::kFullMask, sid[0] >= 0));
  }
  __syncwarp();
  smem_sort(sd, sp, W, false, lane);
  // blocks go from the end, so each lane compares with a predecessor not
  // yet cleared
  bool any_dup = false;
  for (int base = W - 32; base >= 0; base -= 32) {
    const int i = base + lane;
    const bool dup = i > 0 && sd[i] < pa::kInf && sp[i] == sp[i - 1];
    __syncwarp();
    if (dup) {
      sd[i] = pa::kInf;
      sp[i] = sent;
    }
    any_dup |= dup;
    __syncwarp();
  }
  if (__any_sync(pa::kFullMask, any_dup)) smem_sort(sd, sp, W, false, lane);
  for (int i = p.L + lane; i < W; i += 32) {
    sd[i] = pa::kInf;
    sp[i] = sent;
  }
  __syncwarp();
  return scored;
}

// ---- the walk with its beam in registers (W <= 128, pow2(R) <= 64) ----

// The slot of vertex v in a warp's table of 2^(32 - shift) scored ids.
__device__ __forceinline__ int seen_slot(int v, int shift) {
  return static_cast<int>((static_cast<unsigned>(v) * 2654435761u) >> shift);
}

// At most 128 registers a thread, so 4 CTAs (16 warps) fit an SM: the
// widest walk spills a few words rather than drop to 12 warps.
template <int P, int CP>
__global__ void __launch_bounds__(32 * kWarps, 4) walk_regs(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  unsigned char* slice = smem + (threadIdx.x >> 5) * p.slice;
  float* qf = reinterpret_cast<float*>(slice);
  int8_t* qi = reinterpret_cast<int8_t*>(qf + 16 * p.nch);
  float* md = reinterpret_cast<float*>(qi + 16 * p.nch);  // the beam's copy
  int* mp = reinterpret_cast<int*>(md + p.W);
  int* seen = mp + p.W;  // ids the walk has scored, direct-mapped
  int* live = seen + p.seen_slots;  // a step's candidates left to score, packed
  const int sent = 2 * p.n_valid + 1;  // pack of every INF entry
  const unsigned below = (1u << lane) - 1;  // the lanes before this one

  float bd[P];
  int bp[P];
  // rewrite the shared copy of the beam
  auto publish = [&]() {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < P; ++r) {
      md[32 * r + lane] = bd[r];
      mp[32 * r + lane] = bp[r];
    }
    __syncwarp();
  };
  // the nearest workable lane's id, its bit cleared; -1 if none or the
  // visit budget is spent
  auto select = [&](int b, int nv) {
    int e = -1;
    if (nv >= p.limit) return e;
    const float thr = p.use_cut ? fminf(p.cut * md[p.k], pa::kInf) : pa::kInf;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const bool ok = (bp[r] & 1) && bd[r] < pa::kInf && bd[r] < thr && 32 * r + lane < p.L;
      const unsigned m = __ballot_sync(pa::kFullMask, ok);
      if (m != 0 && e < 0) {
        const int src = __ffs(static_cast<int>(m)) - 1;
        e = __shfl_sync(pa::kFullMask, bp[r], src) >> 1;
        if (lane == src) {
          bp[r] -= 1;
          record_visit(p, b, nv, e, bd[r]);
        }
      }
    }
    return e;
  };

  unsigned long long valid = 0, skipped = 0;  // the lane's candidates; those not scored again
  for (int b = pa::next_in_queue(p.counter, lane); b < p.B; b = pa::next_in_queue(p.counter, lane)) {
    __syncwarp();
    for (int i = lane; i < p.seen_slots; i += 32) seen[i] = -1;
    const pa::Query q = pa::stage_query<int8_t>(
        p.queries + static_cast<size_t>(b) * p.d, p.d, p.nch, qf, qi, lane);

    // ---- seed, in the beam's shared copy ----
    int cmps = seed_beam(p, q, b, md, mp, lane);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      bd[r] = md[32 * r + lane];
      bp[r] = mp[32 * r + lane];
    }

    // ---- the walk ----
    int nv = 0;
    for (int e = select(b, 0); e >= 0; e = select(b, nv)) {
      const int deg = __ldg(p.degs + e);
      const int* row = p.nbrs + static_cast<size_t>(e) * p.R;
      int cid[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int j = 32 * c + lane;
        cid[c] = j < p.R ? __ldg(row + j) : -1;
      }
      int n_live = 0;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int j = 32 * c + lane;
        if (!(j < deg && cid[c] >= 0 && cid[c] < p.n_valid)) cid[c] = -1;
        cmps += __popc(__ballot_sync(pa::kFullMask, cid[c] >= 0));
        valid += cid[c] >= 0;
        // a vertex this walk has scored is in the beam or at or past the
        // beam's L-th distance, which never grows: it cannot be kept, so
        // its row is not read again
        if (cid[c] >= 0 && seen[seen_slot(cid[c], p.seen_shift)] == cid[c]) {
          cid[c] = -1;
          skipped += 1;
        }
        const unsigned m = __ballot_sync(pa::kFullMask, cid[c] >= 0);
        if (CP > 1 && cid[c] >= 0) live[n_live + __popc(m & below)] = cid[c];
        n_live += __popc(m);
      }
      // the rest (packed to the front past one register), 32 rows a pass;
      // passes past n_live are skipped
      if (CP > 1) {
        __syncwarp();
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const int i = 32 * c + lane;
          cid[c] = i < n_live ? live[i] : -1;
        }
      }
      float cd[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        cd[c] = 32 * c < n_live ? score_row32(p, q, cid[c], lane) : pa::kInf;
        if (cid[c] >= 0) seen[seen_slot(cid[c], p.seen_shift)] = cid[c];
      }
      __syncwarp();
      nv += 1;
      const float worst = md[p.L - 1];
      bool any = false;
      int cpk[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        bool keep = cid[c] >= 0 && cd[c] < worst;
        if (keep) keep = !in_beam(md, mp, p.W, cd[c], cid[c]);
        any |= keep;
        cpk[c] = keep ? 2 * cid[c] + 1 : sent;
        cd[c] = keep ? cd[c] : pa::kInf;
      }
      if (!__any_sync(pa::kFullMask, any)) continue;
      // ---- merge the kept candidates into the beam ----
      warp_sort_desc<CP>(cd, cpk, lane);
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int c = r - P + CP;  // the candidate element W - 1 - i, reversed
        if (c >= 0 && c < CP) {
          const int cc = c >= 0 && c < CP ? c : 0;
          if (pa::key_less(cd[cc], cpk[cc], bd[r], bp[r])) {
            bd[r] = cd[cc];
            bp[r] = cpk[cc];
          }
        }
      }
      warp_merge<P>(bd, bp, lane);
#pragma unroll
      for (int r = 0; r < P; ++r) {
        if (32 * r + lane >= p.L) {
          bd[r] = pa::kInf;
          bp[r] = sent;
        }
      }
      publish();
    }

    if (p.out_ids != nullptr) {
      int* oi = p.out_ids + static_cast<size_t>(b) * p.L;
      float* od = p.out_dist + static_cast<size_t>(b) * p.L;
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int i = 32 * r + lane;
        if (i < p.L) {
          oi[i] = bd[r] < pa::kInf ? bp[r] >> 1 : -1;
          od[i] = bd[r];
        }
      }
    }
    finish_query(p, b, nv, cmps, lane);
  }
  if (p.counts != nullptr) {
    atomicAdd(p.counts, valid);
    atomicAdd(p.counts + 1, skipped);
  }
}

// ---- the walk with its beam in shared memory (W > 128 or pow2(R) > 64) ----

__global__ void __launch_bounds__(32) walk_smem(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  float* qf = reinterpret_cast<float*>(smem);
  int8_t* qi = reinterpret_cast<int8_t*>(qf + 16 * p.nch);
  float* sd = reinterpret_cast<float*>(qi + 16 * p.nch);  // the beam
  int* sp = reinterpret_cast<int*>(sd + p.W);
  float* cd = reinterpret_cast<float*>(sp + p.W);  // a step's candidates
  int* cp = reinterpret_cast<int*>(cd + p.Nc);
  const int sent = 2 * p.n_valid + 1;
  const int W = p.W;

  auto select = [&](int b, int nv) {
    if (nv >= p.limit) return -1;
    const float thr = p.use_cut ? fminf(p.cut * sd[p.k], pa::kInf) : pa::kInf;
    for (int base = 0; base < p.L; base += 32) {
      const int i = base + lane;
      const bool ok = i < p.L && (sp[i] & 1) && sd[i] < pa::kInf && sd[i] < thr;
      const unsigned m = __ballot_sync(pa::kFullMask, ok);
      if (m != 0) {
        const int first = base + __ffs(static_cast<int>(m)) - 1;
        const int e = sp[first] >> 1;
        __syncwarp();
        if (lane == 0) {
          sp[first] -= 1;
          record_visit(p, b, nv, e, sd[first]);
        }
        __syncwarp();
        return e;
      }
    }
    return -1;
  };

  for (int b = pa::next_in_queue(p.counter, lane); b < p.B; b = pa::next_in_queue(p.counter, lane)) {
    __syncwarp();
    const pa::Query q = pa::stage_query<int8_t>(
        p.queries + static_cast<size_t>(b) * p.d, p.d, p.nch, qf, qi, lane);

    int cmps = seed_beam(p, q, b, sd, sp, lane);

    // ---- the walk ----
    int nv = 0;
    for (int e = select(b, 0); e >= 0; e = select(b, nv)) {
      const int deg = __ldg(p.degs + e);
      const int* row = p.nbrs + static_cast<size_t>(e) * p.R;
      const float worst = sd[p.L - 1];
      bool any = false;
      for (int base = 0; base < p.Nc; base += 32 * kSmemC) {
        int cid[kSmemC];
#pragma unroll
        for (int c = 0; c < kSmemC; ++c) {
          const int j = base + 32 * c + lane;
          cid[c] = j < p.R ? __ldg(row + j) : -1;
        }
#pragma unroll
        for (int c = 0; c < kSmemC; ++c) {
          const int j = base + 32 * c + lane;
          if (!(j < deg && cid[c] >= 0 && cid[c] < p.n_valid)) cid[c] = -1;
          cmps += __popc(__ballot_sync(pa::kFullMask, cid[c] >= 0));
        }
        float dist[kSmemC];
        score_rows<kSmemC>(p, q, cid, dist, lane);
#pragma unroll
        for (int c = 0; c < kSmemC; ++c) {
          const int j = base + 32 * c + lane;
          bool keep = cid[c] >= 0 && dist[c] < worst;
          if (keep) keep = !in_beam(sd, sp, W, dist[c], cid[c]);
          any |= keep;
          if (j < p.Nc) {
            cd[j] = keep ? dist[c] : pa::kInf;
            cp[j] = keep ? 2 * cid[c] + 1 : sent;
          }
        }
      }
      nv += 1;
      if (!__any_sync(pa::kFullMask, any)) continue;
      __syncwarp();
      smem_sort(cd, cp, p.Nc, true, lane);
      // half cleaner: beam i against the candidate W - 1 - i of the
      // ascending order, element i - (W - Nc) of the descending one
      for (int i = lane; i < W; i += 32) {
        const int j = i - W + p.Nc;
        if (j >= 0 && j < p.Nc && pa::key_less(cd[j], cp[j], sd[i], sp[i])) {
          sd[i] = cd[j];
          sp[i] = cp[j];
        }
      }
      __syncwarp();
      smem_merge(sd, sp, W, lane);
      for (int i = p.L + lane; i < W; i += 32) {
        sd[i] = pa::kInf;
        sp[i] = sent;
      }
      __syncwarp();
    }

    if (p.out_ids != nullptr) {
      int* oi = p.out_ids + static_cast<size_t>(b) * p.L;
      float* od = p.out_dist + static_cast<size_t>(b) * p.L;
      for (int i = lane; i < p.L; i += 32) {
        oi[i] = sd[i] < pa::kInf ? sp[i] >> 1 : -1;
        od[i] = sd[i];
      }
    }
    finish_query(p, b, nv, cmps, lane);
  }
}

using WalkFn = void (*)(Params);

WalkFn pick(int P, int CP) {
  if (P == 1) return CP == 1 ? &walk_regs<1, 1> : &walk_regs<1, 2>;
  if (P == 2) return CP == 1 ? &walk_regs<2, 1> : &walk_regs<2, 2>;
  return CP == 1 ? &walk_regs<4, 1> : &walk_regs<4, 2>;
}

// The walk a launch takes, its CTA and its shared memory (sets p.slice and
// the table's size): the register walk for W <= 128 beam lanes and Nc <= 64
// candidate lanes, walk_smem past either. Per warp: the query as f32 and
// int8 (80 bytes a chunk), then the beam (8 bytes a lane) and, in the
// register walk, its table of scored ids (min(32 W, 2048) slots of 4 bytes),
// in walk_smem the candidates.
struct Walk {
  WalkFn kernel;
  int P, CP;  // registers a lane; 0, 0 for walk_smem
  int threads;
  size_t smem;
};

Walk choose(Params& p) {
  const int P = p.W / 32, CP = p.Nc / 32;
  const size_t qbytes = 80 * static_cast<size_t>(p.nch);
  if (P <= kMaxRegP && CP <= kMaxRegC) {
    p.seen_slots = 32 * p.W < kSeenSlots ? 32 * p.W : kSeenSlots;
    p.seen_shift = 32 - (__builtin_ctz(static_cast<unsigned>(p.seen_slots)));
    p.slice = static_cast<int>(qbytes + 8 * static_cast<size_t>(p.W) +
                               4 * static_cast<size_t>(p.seen_slots + p.Nc));
    return Walk{pick(P, CP), P, CP, 32 * kWarps, static_cast<size_t>(kWarps) * p.slice};
  }
  p.slice = static_cast<int>(qbytes + 8 * static_cast<size_t>(p.W + p.Nc));
  return Walk{&walk_smem, 0, 0, 32, static_cast<size_t>(p.slice)};
}

// A test launch of the block-level bitonic sort: one CTA sorts one row of
// W (a power of two) (key, payload) pairs ascending.
__global__ void __launch_bounds__(128) bitonic_rows_kernel(float* keys, int* vals, int W) {
  extern __shared__ __align__(16) float row_key[];
  int* row_val = reinterpret_cast<int*>(row_key + W);
  float* kg = keys + static_cast<size_t>(blockIdx.x) * W;
  int* vg = vals + static_cast<size_t>(blockIdx.x) * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    row_key[i] = kg[i];
    row_val[i] = vg[i];
  }
  __syncthreads();
  pa::bitonic_sort(row_key, row_val, W);
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    kg[i] = row_key[i];
    vg[i] = row_val[i];
  }
}

}  // namespace

extern "C" int pa_fused_beam(const void* queries, const void* tier, const void* nbrs,
                             const void* degs, const void* starts, int starts_stride,
                             int B, int d, int R, int S, int n_valid, int k, int L, int Wb,
                             int Rp, float cut, int limit, int use_cut, int mips,
                             void* counter, void* out_ids, void* out_dist, void* out_nv,
                             void* out_cmps, void* vis_ids, void* vis_dist, int vstride,
                             void* counts, void* stream) {
  if (B == 0) return 0;
  Params p;
  p.queries = static_cast<const float*>(queries);
  p.tier = static_cast<const int8_t*>(tier);
  p.nbrs = static_cast<const int*>(nbrs);
  p.degs = static_cast<const int*>(degs);
  p.starts = static_cast<const int*>(starts);
  p.starts_stride = starts_stride;
  p.B = B;
  p.d = d;
  p.R = R;
  p.S = S;
  p.n_valid = n_valid;
  p.k = k;
  p.L = L;
  p.limit = limit;
  p.use_cut = use_cut;
  p.mips = mips;
  p.W = Wb > 32 ? Wb : 32;
  p.Nc = Rp > 32 ? Rp : 32;
  p.vec = pa::widest_load(tier, d);
  p.nch = (d + 15) / 16;
  p.cut = cut;
  p.counter = static_cast<int*>(counter);
  p.out_ids = static_cast<int*>(out_ids);
  p.out_dist = static_cast<float*>(out_dist);
  p.out_nv = static_cast<int*>(out_nv);
  p.out_cmps = static_cast<int*>(out_cmps);
  p.vis_ids = static_cast<int*>(vis_ids);
  p.vis_dist = static_cast<float*>(vis_dist);
  p.vstride = vstride;
  p.counts = static_cast<unsigned long long*>(counts);

  const Walk w = choose(p);
  cudaError_t err = pa::allow_smem(w.kernel, w.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long resident = 0;
  err = pa::resident_ctas(reinterpret_cast<const void*>(w.kernel), w.threads, w.smem,
                          &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a persistent grid: every SM full, or one warp a query if fewer
  const long long ctas = (static_cast<long long>(B) + w.threads / 32 - 1) / (w.threads / 32);
  const int grid = static_cast<int>(ctas < resident ? ctas : resident);
  w.kernel<<<grid, w.threads, w.smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The walk a launch of kernel 3 over rows of d int8 values, Wb = pow2(L)
// beam lanes and Rp = pow2(R) neighbours takes on the current card ->
// out[0..5] = P and CP (0 and 0: walk_smem), threads a CTA, registers a
// thread, local (spilled) bytes a thread, resident CTAs an SM.
extern "C" int pa_fused_beam_info(int d, int Wb, int Rp, int* out) {
  Params p{};
  p.W = Wb > 32 ? Wb : 32;
  p.Nc = Rp > 32 ? Rp : 32;
  p.nch = (d + 15) / 16;
  const Walk w = choose(p);
  cudaError_t err = pa::allow_smem(w.kernel, w.smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, w.kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, w.kernel, w.threads, w.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = w.P;
  out[1] = w.CP;
  out[2] = w.threads;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = per_sm;
  return 0;
}

extern "C" int pa_bitonic_rows(void* keys, void* vals, int rows, int W, void* stream) {
  if (rows == 0) return 0;
  const size_t smem = (sizeof(float) + sizeof(int)) * static_cast<size_t>(W);
  cudaError_t err = pa::allow_smem(bitonic_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bitonic_rows_kernel<<<rows, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(keys), static_cast<int*>(vals), W);
  return static_cast<int>(cudaGetLastError());
}
