// The demand-grouped BMP sweep over a TiledIndex, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro.kernels.bmp_scan.kernel.bmp_scan_kernel
// (src/repro/kernels/bmp_scan/kernel.py, with _kernel, _rank_desc and
// _sort_by_rank).  For each group g of a launch it runs the whole
// descending-bound sweep of the group's b rows:
//
//   alive = 1; tau = tau0[g]
//   for i = 0 .. n_db-1 while any(alive):
//     alive &= theta*ub_sorted[g,:,i] >= tau - (1e-4*|tau| + 1e-6)
//     blk = order[g,:,i]
//     demand = {blk[r] : alive[r] and not block_scored[g, blk[r]]}
//     score every demanded block's chunk run for all b rows; mark the
//     blocks and their chunks scored
//     each alive row folds the window of blk[r] (-inf outside real, alive
//     docs) into its top-k value heap; tau = max(tau, heap[k_eff-1])
//   steps = number of steps taken
//
// The TPU kernel ran the groups of a bucket one after another on one core
// and kept a group's scores, heap and weights in VMEM.  Here the groups run
// in parallel; scores [G, b, n_pad] and heaps [G, b, k_eff] live in device
// memory, so a group may have any number of rows and the alive mask is an
// operand.  The host (ops.py pick_route) picks one of two routes, and a
// launch of fewer groups than SMs gives each group a cluster of CTAs:
//
// * The small route (b <= 8).  A group's query weights are packed on the
//   host: a bitmap of the terms with a nonzero weight in some row, the rank
//   of each bitmap word and the rows' weights of those terms only (40 terms
//   x 4 B for a topical query), held in shared memory.  A chunk comes into
//   shared memory by three TMA bulk copies; lanes run over its postings,
//   not over rows: each lane reads 4 slots in one 16-byte load and tests
//   their terms against the bitmap, and ballots give a bit a slot.  Then
//   lane s walks slice s of the live slots (scatter_score's warp s) over
//   its set bits only, a register a row.  A group's workers (kPipeWarps
//   warps in each CTA of its cluster) take its steps in turn and score
//   each step ahead of its retire test; see sweep_small.
// * The wide route (b > 8): 32 warps, lanes over rows (tiles of 32 or 128
//   rows), each posting gathering its term's weights for a tile of rows
//   from the term-major qwt, as scatter_score.cu does.  A cluster's CTAs
//   share a step's demanded blocks; rank 0 runs the retire test, the
//   demand set and the folds and writes the step word (go, the blocks)
//   into every rank's shared memory; every rank leaves the loop on the same
//   word, so no cluster barrier is left waiting.
//
// Zero-weight work is skipped, and nothing else.  A demanded chunk whose
// term block holds no nonzero weight of any row is marked in chunk_scored
// but not read; on the small route a posting whose term has weight 0 in
// every row is not summed.  Both add exactly +0 to a finite sum, so the
// scores keep their bits.
//
// The fold order is scatter_score's, so a scored block holds the very bits
// scatter_score gives it, on every route, with any cluster: a chunk's live
// slots (a doc-sorted prefix) are cut into 32 equal slices; each slice sums
// each doc's postings in slot order with fmaf(weight, value, acc) from 0; a
// doc's first part goes into its window row and the parts of later slices
// follow in slice order; chunks follow in run order.  On the small route a
// part that continues a doc begun in a lower lane waits in a carry, and
// the lane holding the doc's first part adds the carries in lane order.  A
// skipped posting or part is +0, so the order of the rest is unchanged.
// Blocks are disjoint windows, so which worker scores a block, and when,
// changes no bit either.
//
// Threshold update, one warp per alive row: the window's values above the
// heap's k-th value are compacted into shared memory and bitonic-sorted
// descending; each lands at its rank in heap ∪ window (heap first on ties),
// and the heap entries below it move down by the count of larger window
// values, written from the tail.  Only values are kept, so the heap holds
// exactly lax.top_k's values and tau is bit-identical.  The retire test
// rounds as the plain version (no contraction to FMA).
//
// Two element types: f32, and bf16, where the value stream and the query
// weights are read as bf16 (half the bytes; a TMA chunk line's values are
// C x 2 bytes, so the small route takes C a multiple of 8 there), widened
// exactly to f32 and summed in the order above; a block's window is
// rounded once to bf16 when it is complete, as it is written to the
// scores (held widened in f32), so the heap and tau see the rounded
// values.  The retire test's relative margin is the caller's (ops.py:
// 1e-4 for f32, a wider one for bf16 that covers the roundings).
//
// What bounds it: the HBM floor is one read of the demanded chunk lines of
// nonzero term blocks, the windows written once, the heaps and the weights.
// A group's steps are sequential (each retire test reads the last fold's
// tau), so a group is a chain of steps: the small route takes the scoring
// off that chain and leaves on it only each step's test, window writes and
// folds.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"
#include "query_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWideWarps = 32;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kBatch = 4;         // wide: slots whose gathers are in flight
constexpr int kStages = 4;        // wide: chunk buffers in the cp.async ring
constexpr int kScanIters = 4;  // small: 128-slot loads a chunk (C <= 512)
constexpr int kPipeWarps = 3;   // small: workers a CTA
constexpr int kPipeStages = 2;  // and each one's ring depth
constexpr int kMaxRows = 8;       // small: the most rows a group has
constexpr int kPipeState = 20;    // small: alive[8], tau[8], stop
constexpr int kMaxSmem = 232448;

// The element arrays (qwt, nz_w, value) are f32 or bf16: the kernels'
// Val template argument says which.
struct Params {
  const void* qwt;              // wide: [G, v_pad, b_pad]
  const unsigned* nz_bits;      // small: [G, n_words]
  const int* nz_rank;           // small: [G, n_words]
  const void* nz_w;             // small: [G, nz_cap, tile]
  const int* tb_nz;             // [G, n_tb]
  const int* order;             // [G, b, n_db]
  const float* ub_sorted;       // [G, b, n_db]
  const float* tau0;            // [G, b]
  const int* block_chunk_start; // [n_db]
  const int* block_chunk_count; // [n_db]
  const int* chunk_term_block;  // [num_chunks]
  const int* local_term;        // [num_chunks, C]
  const int* local_doc;         // [num_chunks, C]
  const void* value;            // [num_chunks, C]
  const unsigned char* alive_doc;  // [num_docs] or null
  float* scores;                // [G, b, n_pad]
  float* heap;                  // [G, b, k_eff]
  int* block_scored;            // [G, n_db]
  int* chunk_scored;            // [G, num_chunks]
  int* steps;                   // [G]
  int b, b_pad;
  long long v_pad;
  int n_db, num_chunks, term_block, doc_block, chunk_size, k_eff;
  float theta, margin_rel;
  long long num_docs, n_pad;
  int n_words, nz_cap, nz_in_smem, n_tb, max_run, cluster;
  float* spec;       // small: [G, spec_workers, tile, doc_block * tile]
  int spec_workers;  // small: workers a group has room for in spec
};

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The retire test, rounded as the plain version: separate f32 multiply,
// add and subtract (no contraction to FMA).
__device__ __forceinline__ bool stays_alive(const Params& p, float ub,
                                            float tau) {
  const float margin = __fadd_rn(__fmul_rn(p.margin_rel, fabsf(tau)), 1e-6f);
  return __fmul_rn(p.theta, ub) >= __fsub_rn(tau, margin);
}

// A complete window's score as the scores keep it: f32 as summed; bf16
// rounded once to the nearest bf16 (ties to even), held widened.
template <class Val>
__device__ __forceinline__ float kept(float x) {
  Val r;
  query_tiles::store(&r, x);
  return query_tiles::widen(r);
}

// The wide route's end of a step's scoring: every CTA of the group has
// written its scores before any reads them.  In a cluster, the barrier's
// release and acquire order shared memory; the fence orders the scores in
// device memory.
__device__ __forceinline__ void step_barrier(int cluster) {
  if (cluster > 1) {
    __threadfence();
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// One warp sorts s[0, n) descending (n a power of two), in place.
__device__ void warp_bitonic_desc(float* s, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const float a = s[i], c = s[j];
        const bool desc = (i & size) == 0;
        if (desc ? (a < c) : (a > c)) {
          s[i] = c;
          s[j] = a;
        }
      }
      __syncwarp();
    }
  }
}

// One warp folds the window of block blk (row r of group g) into the row's
// heap and returns the heap's new k-th value.  wv and wdest are scratch of
// next_pow2(doc_block) words each.  The scores and the heap are read from
// L2: another CTA of the cluster may have written them last.
__device__ float fold_row(const Params& p, int g, int r, int blk, float* wv,
                          int* wdest, int lane) {
  const int D = p.doc_block;
  float* hrow = p.heap + (static_cast<long long>(g) * p.b + r) * p.k_eff;
  const float kth = __ldcg(hrow + p.k_eff - 1);
  const long long base = static_cast<long long>(blk) * D;
  const float* srow =
      p.scores + (static_cast<long long>(g) * p.b + r) * p.n_pad + base;
  int m = 0;
  for (int x0 = 0; x0 < D; x0 += 32) {
    const int x = x0 + lane;
    float v = -CUDART_INF_F;
    if (x < D) {
      const long long doc = base + x;
      if (doc < p.num_docs && (p.alive_doc == nullptr || p.alive_doc[doc])) {
        v = __ldcg(srow + x);
      }
    }
    const bool keep = v > kth;
    const unsigned bal = __ballot_sync(kFull, keep);
    if (keep) wv[m + __popc(bal & lanes_below(lane))] = v;
    m += __popc(bal);
  }
  if (m == 0) return kth;
  const int m2 = next_pow2(m);
  for (int x = m + lane; x < m2; x += 32) wv[x] = -CUDART_INF_F;
  __syncwarp();
  warp_bitonic_desc(wv, m2, lane);
  // Window value j lands after every heap value >= it.
  for (int x = lane; x < m; x += 32) {
    const float v = wv[x];
    int lo = 0, hi = p.k_eff;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldcg(hrow + mid) >= v) lo = mid + 1; else hi = mid;
    }
    wdest[x] = x + lo;
  }
  __syncwarp();
  // Heap values below the largest window value move down by the count of
  // window values above them; from the tail, reads before writes.
  const int first_moved = wdest[0];
  for (int hi_i = p.k_eff; hi_i > first_moved; hi_i -= 32) {
    const int x = hi_i - 32 + lane;
    const bool in = x >= first_moved;
    float v = 0.f;
    int dst = p.k_eff;
    if (in) {
      v = __ldcg(hrow + x);
      int lo = 0, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (wv[mid] > v) lo = mid + 1; else hi = mid;
      }
      dst = x + lo;
    }
    __syncwarp();
    if (in && dst < p.k_eff) hrow[dst] = v;
    __syncwarp();
  }
  for (int x = lane; x < m; x += 32) {
    if (wdest[x] < p.k_eff) hrow[wdest[x]] = wv[x];
  }
  __syncwarp();
  return __ldcg(hrow + p.k_eff - 1);
}

// ---------------------------------------------------------------------------
// The small route: lanes over postings; a group's workers score its steps
// ahead of their retire tests.

// What a chunk scan reads and writes in shared memory.
struct SmallShared {
  float* window;   // a block's [doc][tile] rows
  const unsigned* bits;
  const int* rank;
  const void* w;   // shared or device memory, Val [nz_cap][tile]
  unsigned* mask;  // one bit a slot
  float* carry;    // [32][tile]
  int* carry_doc;  // [32]
};

// Bits 0-7 of x spread to bits 0, 4, .., 28.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// A ring of kDepth chunk buffers [lt | ld | v], each filled by three
// TMA bulk copies that complete on the slot's mbarrier.  Chunk k of the
// warp's stream (counted over every block it scores) uses slot k % kDepth
// in phase (k / kDepth) & 1.  A slot is refilled only after the warp's
// __syncwarp that ends the scan of its last chunk.
template <int kDepth>
struct Ring {
  int* buf;
  uint64_t* bars;
  int C;
  __device__ int* slot(long long k) const {
    return buf + (k % kDepth) * 3 * C;
  }
  __device__ uint32_t bar(long long k) const {
    return hopper::smem_u32(bars + k % kDepth);
  }
  template <class Val>
  __device__ void issue(const Params& p, long long k, int c) const {
    const uint32_t bytes = static_cast<uint32_t>(C) * 4;
    const uint32_t vbytes = static_cast<uint32_t>(C) * sizeof(Val);
    const long long at = static_cast<long long>(c) * C;
    int* dst = slot(k);
    hopper::mbar_arrive_expect_tx(bar(k), 2 * bytes + vbytes);
    hopper::bulk_load(hopper::smem_u32(dst), p.local_term + at, bytes, bar(k));
    hopper::bulk_load(hopper::smem_u32(dst + C), p.local_doc + at, bytes,
                      bar(k));
    hopper::bulk_load(hopper::smem_u32(dst + 2 * C),
                      static_cast<const Val*>(p.value) + at, vbytes, bar(k));
  }
  __device__ void wait(long long k) const {
    hopper::mbar_wait(bar(k), static_cast<int>((k / kDepth) & 1));
  }
};

// Adds one staged chunk's postings of docs [dlo, dhi) to their window rows
// (row d - dlo), in scatter_score's order (see the header).
template <int kTile, class Val>
__device__ void score_chunk(const Params& p, const SmallShared& s,
                            const int* lt, const int* ld, const Val* val,
                            int tb, int dlo, int dhi, int lane) {
  const int C = p.chunk_size, T = p.term_block;
  const long long tbase = static_cast<long long>(tb) * T;
  // Lane l reads slots 128 j + 4 l .. + 3 in one 16-byte load: live[j][k]
  // and nz[j][k] hold, at bit l, whether slot 128 j + 4 l + k is live (a
  // prefix of the chunk) and has a doc in [dlo, dhi) and a term of nonzero
  // weight.
  unsigned nz[kScanIters][4], any = 0;
  int live = 0;
#pragma unroll
  for (int j = 0; j < kScanIters; ++j) {
    const int x = 128 * j + 4 * lane;
    const int xc = min(x, C - 4);  // in bounds; slots past C count for nothing
    const int4 l4 = *reinterpret_cast<const int4*>(lt + xc);
    const int4 d4 = *reinterpret_cast<const int4*>(ld + xc);
    const int ls[4] = {l4.x, l4.y, l4.z, l4.w};
    const int ds[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = x + k < C;
      live += in && ds[k] >= 0;
      bool hit = false;
      if (in && ds[k] >= dlo && ds[k] < dhi && ls[k] >= 0 && ls[k] < T) {
        const long long t = tbase + ls[k];
        hit = (s.bits[t >> 5] >> (t & 31)) & 1u;
      }
      nz[j][k] = __ballot_sync(kFull, hit);
      any |= nz[j][k];
    }
  }
  if (!any) return;  // every posting adds +0
  // Lane r builds the slot-order word of slots 32 r .. 32 r + 31.
  const int n_live = static_cast<int>(__reduce_add_sync(kFull, live));
  unsigned w0 = 0, w1 = 0, w2 = 0, w3 = 0;
#pragma unroll
  for (int j = 0; j < kScanIters; ++j) {
    if (j == lane >> 2) {
      w0 = nz[j][0];
      w1 = nz[j][1];
      w2 = nz[j][2];
      w3 = nz[j][3];
    }
  }
  const int sh = 8 * (lane & 3);
  if (lane < 4 * kScanIters) {
    s.mask[lane] = spread4((w0 >> sh) & 0xffu) |
                   (spread4((w1 >> sh) & 0xffu) << 1) |
                   (spread4((w2 >> sh) & 0xffu) << 2) |
                   (spread4((w3 >> sh) & 0xffu) << 3);
  }
  __syncwarp();
  // Lane s walks slice s (scatter_score's warp s): its bits.
  const int pw = (n_live + 31) >> 5;
  const int lo = min(lane * pw, n_live), hi = min(lane * pw + pw, n_live);
  unsigned mine = 0;
  if (lo < hi) {
    const int at = lo & 31;
    mine = s.mask[lo >> 5] >> at;
    if (at) mine |= s.mask[(lo >> 5) + 1] << (32 - at);
    if (hi - lo < 32) mine &= (1u << (hi - lo)) - 1u;
  }
  const int first_doc = mine ? ld[lo + __ffs(mine) - 1] : -1;
  const int last_doc = mine ? ld[lo + 31 - __clz(mine)] : -1;
  // Docs ascend with the lanes: the nearest lower lane with a part ends on
  // the largest last_doc below.
  int prev = last_doc;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, prev, o);
    if (lane >= o) prev = max(prev, y);
  }
  prev = __shfl_up_sync(kFull, prev, 1);
  if (lane == 0) prev = -1;
  const bool continued = first_doc >= 0 && prev == first_doc;
  const unsigned carried = __ballot_sync(kFull, continued);
  if (continued) s.carry_doc[lane] = first_doc;
  int cur = -1;
  bool first_part = true;
  float acc[kTile];
  auto emit = [&]() {
    if (first_part && continued) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) s.carry[lane * kTile + r] = acc[r];
    } else {
      float* row = s.window + (cur - dlo) * kTile;
#pragma unroll
      for (int r = 0; r < kTile; ++r) row[r] += acc[r];
    }
  };
  for (unsigned m = mine; m; m &= m - 1) {
    const int x = lo + __ffs(m) - 1;
    const int d = ld[x];
    if (d != cur) {
      if (cur >= 0) {
        emit();
        first_part = false;
      }
      cur = d;
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
    }
    const long long t = tbase + lt[x];
    const int word = static_cast<int>(t >> 5);
    const unsigned below = lanes_below(static_cast<int>(t & 31));
    const int slot = s.rank[word] + __popc(s.bits[word] & below);
    const float v = query_tiles::widen(val[x]);
    const Val* w = static_cast<const Val*>(s.w) +
                   static_cast<long long>(slot) * kTile;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      acc[r] = fmaf(query_tiles::widen(w[r]), v, acc[r]);
    }
  }
  if (cur >= 0) emit();
  __syncwarp();
  // The lane holding a doc's first part adds the later lanes' parts of the
  // doc in lane order.  Only lanes whose first part is carried are visited:
  // the first carried lane above with another doc ends the run.
  if (last_doc >= 0 && !(continued && first_doc == last_doc)) {
    float* row = s.window + (last_doc - dlo) * kTile;
    for (unsigned m = carried & ~((2u << lane) - 1u); m; m &= m - 1) {
      const int o = __ffs(m) - 1;
      if (s.carry_doc[o] != last_doc) break;
#pragma unroll
      for (int r = 0; r < kTile; ++r) row[r] += s.carry[o * kTile + r];
    }
  }
  __syncwarp();
}

// Fills s.window with docs [dlo, dhi) of block blk for every row, from the
// block's chunks of a term block with a nonzero weight, in run order.
// `issued` counts the chunks the ring has taken so far.
template <int kTile, int kDepth, class Val>
__device__ void fill_window(const Params& p, const SmallShared& s,
                            const Ring<kDepth>& ring, long long& issued,
                            int* clist, int* ctb, const int* tbnz, int blk,
                            int dlo, int dhi, int lane) {
  const int start = p.block_chunk_start[blk];
  const int cnt = p.block_chunk_count[blk];
  int n = 0;
  for (int c0 = 0; c0 < cnt; c0 += 32) {
    const int c = start + c0 + lane;
    bool keep = false;
    int tb = 0;
    if (c0 + lane < cnt) {
      tb = __ldg(p.chunk_term_block + c);
      keep = tbnz[tb] != 0;
    }
    const unsigned m = __ballot_sync(kFull, keep);
    if (keep) {
      const int at = n + __popc(m & lanes_below(lane));
      clist[at] = c;
      ctb[at] = tb;
    }
    n += __popc(m);
  }
  for (int x = lane; x < (dhi - dlo) * kTile; x += 32) s.window[x] = 0.f;
  __syncwarp();
  const long long k0 = issued;
  if (lane == 0) {
    for (int t = 0; t < min(n, kDepth); ++t) {
      ring.template issue<Val>(p, k0 + t, clist[t]);
    }
  }
  for (int t = 0; t < n; ++t) {
    ring.wait(k0 + t);
    const int* buf = ring.slot(k0 + t);
    score_chunk<kTile>(p, s, buf, buf + p.chunk_size,
                       reinterpret_cast<const Val*>(buf + 2 * p.chunk_size),
                       ctb[t], dlo, dhi, lane);
    __syncwarp();  // every lane is done with the slot
    if (lane == 0 && t + kDepth < n) {
      ring.template issue<Val>(p, k0 + t + kDepth, clist[t + kDepth]);
    }
  }
  issued = k0 + n;
}

// Writes the window of docs [dlo, dhi) of block blk to group g's scores
// (each score kept<Val>); with `mark`, marks every chunk of the block's run
// scored.
template <int kTile, class Val>
__device__ void commit_window(const Params& p, const float* window, int g,
                              int blk, int dlo, int dhi, bool mark,
                              int lane) {
  float* out = p.scores + static_cast<long long>(g) * p.b * p.n_pad +
               static_cast<long long>(blk) * p.doc_block + dlo;
  for (int r = 0; r < p.b; ++r) {
    for (int x = lane; x < dhi - dlo; x += 32) {
      out[static_cast<long long>(r) * p.n_pad + x] =
          kept<Val>(window[x * kTile + r]);
    }
  }
  if (mark) {
    int* cscored = p.chunk_scored + static_cast<long long>(g) * p.num_chunks;
    const int start = p.block_chunk_start[blk];
    const int cnt = p.block_chunk_count[blk];
    for (int x = lane; x < cnt; x += 32) cscored[start + x] = 1;
  }
  __syncwarp();
}

// The small route's sweep.  The workers of a group (kPipeWarps warps in
// each of the cluster's CTAs) take its steps in turn: worker k scores step
// i = k, k + K, .. (K workers) ahead of the step's retire test, then waits
// for the step's token.  Ahead of the test a step scores every alive row's
// rank-i block not yet known to be scored (its speculative candidates):
// whatever the step turns out to demand is one of them.  With the token it
// runs the retire test and the demand set on the group's true state, writes
// the windows of the demanded blocks, marks them and their chunks, folds the
// alive rows' heaps and passes the token on.  Candidates it does not demand
// are dropped, so the outputs are those of the sequential sweep, bit for
// bit.  The group's state (alive, tau, the end of the sweep) lives in rank
// 0's shared memory; the token is an mbarrier per worker, arrived on with
// release and waited on with acquire at cluster scope (the trapping wait).

// Shared memory, in 4-byte words (mirrored by ops.py small_smem_words):
// the packed weights and the group's state, then for each warp its ring
// (also its heap-merge scratch), window, scan mask, carries, chunk list,
// candidates and mbarriers (its ring's and its token's).
struct PipeLayout {
  int bits, rank, tbnz, w, state, warp0, ring, window, mask, carry, clist,
      cand, bars, per_warp, total;
  __host__ __device__ PipeLayout(int tile, int D, int C, int n_words,
                                 int n_tb, int w_words, int max_run) {
    const int ring_words = kPipeStages * 3 * C;
    bits = 0;
    rank = bits + round4(n_words);
    tbnz = rank + round4(n_words);
    w = tbnz + round4(n_tb);
    state = w + round4(w_words);
    warp0 = state + round4(kPipeState);
    ring = 0;  // offsets within a warp's part
    window = ring + round4(ring_words > 2 * next_pow2(D) ? ring_words
                                                         : 2 * next_pow2(D));
    mask = window + round4(D * tile);
    carry = mask + round4(4 * kScanIters + 1);
    clist = carry + round4(32 * tile + 32);
    cand = clist + round4(2 * max_run);
    bars = cand + round4(kMaxRows);
    per_warp = bars + round4(2 * (kPipeStages + 1));
    total = warp0 + kPipeWarps * per_warp;
  }
};

// The packed weights' words in shared memory (0: read from device memory).
template <class Val>
__host__ __device__ inline int weight_words(int nz_in_smem, int nz_cap,
                                            int tile) {
  return nz_in_smem ? (nz_cap * tile * static_cast<int>(sizeof(Val)) + 3) / 4
                    : 0;
}

template <int kTile, class Val>
__global__ void __launch_bounds__(32 * kPipeWarps) sweep_small(Params p) {
  extern __shared__ __align__(16) int smem_small[];
  const int D = p.doc_block, C = p.chunk_size, b = p.b, n_db = p.n_db;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = p.cluster;
  const int g = blockIdx.x / R, rank = blockIdx.x % R;
  const int K = R * kPipeWarps, me = rank * kPipeWarps + warp;
  const PipeLayout lay(kTile, D, C, p.n_words, p.n_tb,
                       weight_words<Val>(p.nz_in_smem, p.nz_cap, kTile),
                       p.max_run);
  int* sm = smem_small;
  unsigned* bits = reinterpret_cast<unsigned*>(sm + lay.bits);
  int* rnk = sm + lay.rank;
  int* tbnz = sm + lay.tbnz;
  Val* w = reinterpret_cast<Val*>(sm + lay.w);
  const Val* gw = static_cast<const Val*>(p.nz_w) +
                  static_cast<long long>(g) * p.nz_cap * kTile;
  for (int x = threadIdx.x; x < p.n_words; x += blockDim.x) {
    bits[x] = p.nz_bits[static_cast<long long>(g) * p.n_words + x];
    rnk[x] = p.nz_rank[static_cast<long long>(g) * p.n_words + x];
  }
  for (int x = threadIdx.x; x < p.n_tb; x += blockDim.x) {
    tbnz[x] = p.tb_nz[static_cast<long long>(g) * p.n_tb + x];
  }
  if (p.nz_in_smem) {
    for (int x = threadIdx.x; x < p.nz_cap * kTile; x += blockDim.x) {
      w[x] = gw[x];
    }
  }
  int* mine = sm + lay.warp0 + warp * lay.per_warp;
  const SmallShared s{reinterpret_cast<float*>(mine + lay.window), bits, rnk,
                      p.nz_in_smem ? w : gw,
                      reinterpret_cast<unsigned*>(mine + lay.mask),
                      reinterpret_cast<float*>(mine + lay.carry),
                      mine + lay.carry + 32 * kTile};
  uint64_t* bars = reinterpret_cast<uint64_t*>(mine + lay.bars);
  const Ring<kPipeStages> ring{mine + lay.ring, bars, C};
  int* clist = mine + lay.clist;
  int* ctb = clist + p.max_run;
  int* cand = mine + lay.cand;
  // Worker wi's token barrier, as an address in its CTA's shared memory.
  auto token = [&](int wi) {
    return hopper::smem_u32(reinterpret_cast<uint64_t*>(
               sm + lay.warp0 + wi * lay.per_warp + lay.bars) + kPipeStages);
  };
  // The group's state, in rank 0's shared memory.
  int* state = sm + lay.state;
  if (R > 1) state = cg::this_cluster().map_shared_rank(state, 0);
  volatile int* s_alive = state;                                  // [8]
  volatile float* s_tau = reinterpret_cast<volatile float*>(state + 8);
  volatile int* s_stop = state + 16;
  if (lane < kPipeStages) hopper::mbar_init(ring.bar(lane), 1);
  if (lane == 0) hopper::mbar_init(token(warp), 1);
  if (rank == 0 && threadIdx.x < kMaxRows) {
    const int r = threadIdx.x;
    s_alive[r] = r < b;
    s_tau[r] = r < b ? p.tau0[static_cast<long long>(g) * b + r] : 0.f;
    if (r == 0) *s_stop = n_db + 1;
  }
  hopper::mbar_fence_init();
  if (R > 1) cg::this_cluster().sync(); else __syncthreads();
  if (me == 0 && lane == 0) hopper::mbar_arrive(token(0));  // step 0 first
  int* bscored = p.block_scored + static_cast<long long>(g) * n_db;
  const int* order = p.order + static_cast<long long>(g) * b * n_db;
  const float* ubs = p.ub_sorted + static_cast<long long>(g) * b * n_db;
  float* spec = p.spec + (static_cast<long long>(g) * p.spec_workers + me) *
                             kTile * D * kTile;
  float* wv = reinterpret_cast<float*>(mine + lay.ring);
  int* wdest = mine + lay.ring + next_pow2(D);
  const bool row = lane < b;
  long long issued = 0;
  for (int i = me, round = 0;; i += K, ++round) {
    // The candidates: alive rows' rank-i blocks not known to be scored,
    // each once, by its first row; each scored into its spec window.
    int nc = 0;
    if (i < n_db && i < *s_stop) {
      const int blk = row ? order[static_cast<long long>(lane) * n_db + i]
                          : -1;
      const bool open = row && s_alive[lane] && !__ldcg(bscored + blk);
      bool first = open;
#pragma unroll
      for (int r2 = 0; r2 < kTile; ++r2) {
        const int ob = __shfl_sync(kFull, blk, r2);
        const bool oo = __shfl_sync(kFull, open, r2);
        if (r2 < lane && oo && ob == blk) first = false;
      }
      const unsigned m = __ballot_sync(kFull, first);
      if (first) cand[__popc(m & lanes_below(lane))] = blk;
      nc = __popc(m);
      __syncwarp();
      for (int j = 0; j < nc; ++j) {
        fill_window<kTile, kPipeStages, Val>(p, s, ring, issued, clist, ctb,
                                             tbnz, cand[j], 0, D, lane);
        float* out = spec + j * D * kTile;
        for (int x = lane; x < D * kTile; x += 32) out[x] = s.window[x];
        __syncwarp();
      }
    }
    hopper::mbar_wait<true>(token(warp), round & 1);
    // Step i's turn.
    int alive = row ? s_alive[lane] : 0;
    const bool done = i >= *s_stop || i >= n_db || !__any_sync(kFull, alive);
    if (done) {
      if (lane == 0 && i < *s_stop) {
        *s_stop = i;
        p.steps[g] = i;
      }
    } else {
      int blk = n_db;
      if (row) {
        const long long at = static_cast<long long>(lane) * n_db + i;
        if (alive) alive = stays_alive(p, ubs[at], s_tau[lane]);
        blk = order[at];
      }
      const bool fresh = row && alive && !__ldcg(bscored + blk);
      bool first = fresh;
#pragma unroll
      for (int r2 = 0; r2 < kTile; ++r2) {
        const int ob = __shfl_sync(kFull, blk, r2);
        const bool of = __shfl_sync(kFull, fresh, r2);
        if (r2 < lane && of && ob == blk) first = false;
      }
      unsigned demand = __ballot_sync(kFull, first);
      __syncwarp();
      if (row) s_alive[lane] = alive;
      // Each demanded block is a candidate: write its window, mark it.
      for (; demand; demand &= demand - 1) {
        const int d = __shfl_sync(kFull, blk, __ffs(demand) - 1);
        int j = 0;
        while (cand[j] != d) ++j;
        if (lane == 0) bscored[d] = 1;
        commit_window<kTile, Val>(p, spec + j * D * kTile, g, d, 0, D, true,
                                  lane);
      }
      const unsigned folds = __ballot_sync(kFull, row && alive);
      for (unsigned f = folds; f; f &= f - 1) {
        const int r = __ffs(f) - 1;
        const int rb = __shfl_sync(kFull, blk, r);
        const float kth = fold_row(p, g, r, rb, wv, wdest, lane);
        if (lane == 0) s_tau[r] = fmaxf(s_tau[r], kth);
        __syncwarp();
      }
      // The merge scratch is ring memory that TMA writes next.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncwarp();
    if (lane == 0) {
      const int next = (me + 1) % K;
      if (next / kPipeWarps == rank) {
        hopper::mbar_arrive(token(next % kPipeWarps));
      } else {
        __threadfence();
        hopper::mbar_arrive_remote(token(next % kPipeWarps),
                                   next / kPipeWarps);
      }
    }
    if (done) break;
  }
  // No CTA leaves while another may still signal its barriers.
  if (R > 1) cg::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// The wide route: 32 warps, lanes over rows.

// Shared memory, in 4-byte words, laid out in this order (mirrored by
// ops.py wide_smem_words).
struct WideLayout {
  int region;   // the score window, or the per-warp heap-merge buffers
  int carry;    // kWideWarps x query_tile
  int carry_doc;
  int bufs;     // kStages x 3 x C
  int s_tb;     // kStages term block ids, kStages skip flags
  int tbnz;
  int rows;     // 8 b + 3 row and step words
  __host__ __device__ WideLayout(int query_tile, int doc_block, int chunk_size,
                                 int b, int n_tb) {
    const int window = doc_block * (query_tile + 1);
    const int merge = kWideWarps * 2 * next_pow2(doc_block);
    region = window > merge ? window : merge;
    carry = kWideWarps * query_tile;
    carry_doc = kWideWarps;
    bufs = kStages * 3 * chunk_size;
    s_tb = 2 * kStages;
    tbnz = n_tb;
    rows = 8 * b + 3;
  }
  __host__ __device__ int words() const {
    return region + carry + carry_doc + bufs + s_tb + tbnz + rows;
  }
};

// Start copying chunk c into the shared buffer [lt | ld | v] at dst and its
// term block id into *tb (the caller commits the copy group).  The values
// go by 4-byte words (bf16: two a word; the launcher takes an even C).
template <class Val>
__device__ __forceinline__ void stage_chunk(int* dst, int* tb, const Params& p,
                                            int c) {
  const long long base = static_cast<long long>(c) * p.chunk_size;
  const int* v = reinterpret_cast<const int*>(
      static_cast<const Val*>(p.value) + base);
  const int v_words = p.chunk_size * static_cast<int>(sizeof(Val)) / 4;
  for (int j = threadIdx.x; j < p.chunk_size; j += kWideThreads) {
    __pipeline_memcpy_async(dst + j, p.local_term + base + j, sizeof(int));
    __pipeline_memcpy_async(dst + p.chunk_size + j, p.local_doc + base + j,
                            sizeof(int));
    if (j < v_words) {
      __pipeline_memcpy_async(dst + 2 * p.chunk_size + j, v + j, sizeof(int));
    }
  }
  if (threadIdx.x == 0) {
    __pipeline_memcpy_async(tb, p.chunk_term_block + c, sizeof(int));
  }
}

// Item t of the rank's stream (tile-major, then its blocks' chunk runs end
// to end): its tile, its block's slot j and its chunk id.
__device__ __forceinline__ void decode(int t, int total, const int* doff,
                                       const int* dstart, int nd, int& tile,
                                       int& j, int& c) {
  tile = t / total;
  const int u = t - tile * total;
  int lo = 0, hi = nd;  // last j with doff[j] <= u
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (doff[mid] <= u) lo = mid; else hi = mid;
  }
  j = lo;
  c = dstart[j] + (u - doff[j]);
}

template <int kQpl, class Val>
__global__ void __launch_bounds__(kWideThreads, 1) sweep_wide(Params p) {
  constexpr int kQueryTile = 32 * kQpl;
  constexpr int kRowStride = kQueryTile + 1;  // odd: conflict-free columns
  extern __shared__ float smem[];
  const WideLayout lay(kQueryTile, p.doc_block, p.chunk_size, p.b, p.n_tb);
  float* region = smem;
  float* window = region;                                  // [D][kRowStride]
  float* carry = region + lay.region;                      // [kWarps][QT]
  int* carry_doc = reinterpret_cast<int*>(carry + lay.carry);
  int* bufs = carry_doc + lay.carry_doc;
  int* s_tb = bufs + lay.bufs;
  int* s_skip = s_tb + kStages;
  int* s_tbnz = s_tb + lay.s_tb;
  int* s_alive = s_tbnz + lay.tbnz;                        // [b]
  float* s_tau = reinterpret_cast<float*>(s_alive + p.b);  // [b]
  int* s_blk = reinterpret_cast<int*>(s_tau + p.b);        // [b]
  int* s_cand = s_blk + p.b;                               // [b]
  int* s_bc = s_cand + p.b;      // go, nd, the demanded blocks [b]
  int* lblk = s_bc + 2 + p.b;    // [b] this rank's blocks
  int* dstart = lblk + p.b;      // [b] their runs
  int* doff = dstart + p.b;      // [b + 1] prefix

  const int R = p.cluster;
  const int g = blockIdx.x / R, rank = blockIdx.x % R;
  const int b = p.b, n_db = p.n_db, D = p.doc_block, C = p.chunk_size;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Val* qwt = static_cast<const Val*>(p.qwt) +
                  static_cast<long long>(g) * p.v_pad * p.b_pad;
  const int* order = p.order + static_cast<long long>(g) * b * n_db;
  const float* ubs = p.ub_sorted + static_cast<long long>(g) * b * n_db;
  float* scores = p.scores + static_cast<long long>(g) * b * p.n_pad;
  int* bscored = p.block_scored + static_cast<long long>(g) * n_db;
  int* cscored = p.chunk_scored + static_cast<long long>(g) * p.num_chunks;

  for (int t = threadIdx.x; t < p.n_tb; t += kWideThreads) {
    s_tbnz[t] = p.tb_nz[static_cast<long long>(g) * p.n_tb + t];
  }
  if (rank == 0) {
    for (int r = threadIdx.x; r < b; r += kWideThreads) {
      s_alive[r] = 1;
      s_tau[r] = p.tau0[static_cast<long long>(g) * b + r];
    }
  }
  __syncthreads();

  int i = 0;
  for (;; ++i) {
    if (rank == 0) {
      int any = 0;
      if (i < n_db) {
        for (int r = threadIdx.x; r < b; r += kWideThreads) any |= s_alive[r];
      }
      const int go = __syncthreads_or(any);
      if (threadIdx.x == 0) {
        s_bc[0] = go;
        s_bc[1] = 0;
      }
      if (go) {
        // Retire, then each alive row's fresh (not yet scored) block.
        for (int r = threadIdx.x; r < b; r += kWideThreads) {
          int a = s_alive[r];
          const long long at = static_cast<long long>(r) * n_db + i;
          if (a) {
            a = stays_alive(p, ubs[at], s_tau[r]);
            s_alive[r] = a;
          }
          const int blk = order[at];
          s_blk[r] = blk;
          // L2 read: the claims below are atomics, which bypass L1.
          s_cand[r] = (a && !__ldcg(&bscored[blk])) ? blk : n_db;
        }
        __syncthreads();
        // Dedup: the first row to claim a block lists it (and marks it).
        for (int r = threadIdx.x; r < b; r += kWideThreads) {
          const int c = s_cand[r];
          if (c < n_db && atomicCAS(&bscored[c], 0, 1) == 0) {
            s_bc[2 + atomicAdd(&s_bc[1], 1)] = c;
          }
        }
      }
      __syncthreads();
      if (R > 1) {
        const int words = 2 + s_bc[1];
        cg::cluster_group cluster = cg::this_cluster();
        for (int x = threadIdx.x; x < (R - 1) * words; x += kWideThreads) {
          const int k = 1 + x / words;
          cluster.map_shared_rank(s_bc, k)[x % words] = s_bc[x % words];
        }
      }
    }
    if (R > 1) cg::this_cluster().sync(); else __syncthreads();
    if (!s_bc[0]) break;
    const int nd = s_bc[1];
    // This rank's blocks: demanded block j goes to rank j mod R.
    const int nl = nd > rank ? (nd - rank + R - 1) / R : 0;
    if (warp == 0) {  // exclusive prefix of the blocks' run lengths
      int base = 0;
      for (int j0 = 0; j0 < nl; j0 += 32) {
        const int j = j0 + lane;
        int cnt = 0;
        if (j < nl) {
          const int blk = s_bc[2 + rank + j * R];
          lblk[j] = blk;
          dstart[j] = p.block_chunk_start[blk];
          cnt = p.block_chunk_count[blk];
        }
        int incl = cnt;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        if (j < nl) doff[j] = base + incl - cnt;
        base += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) doff[nl] = base;
    }
    __syncthreads();
    const int total = doff[nl];

    if (total > 0) {
      for (int t = threadIdx.x; t < total; t += kWideThreads) {
        int tile, j, c;
        decode(t, total, doff, dstart, nl, tile, j, c);
        cscored[c] = 1;
      }
      for (int x = threadIdx.x; x < D * kRowStride; x += kWideThreads) {
        window[x] = 0.f;
      }
      const int n_items = (p.b_pad / kQueryTile) * total;
      // Stage item t unless its chunk's term block has no nonzero weight.
      auto stage = [&](int t) {
        int tile, j, c;
        decode(t, total, doff, dstart, nl, tile, j, c);
        const int slot = t % kStages;
        const bool keep = s_tbnz[__ldg(p.chunk_term_block + c)] != 0;
        if (keep) stage_chunk<Val>(bufs + slot * 3 * C, s_tb + slot, p, c);
        if (threadIdx.x == 0) s_skip[slot] = !keep;
      };
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_items) stage(s);
        __pipeline_commit();
      }
      for (int t = 0; t < n_items; ++t) {
        const int slot = t % kStages;
        __pipeline_wait_prior(kStages - 2);
        __syncthreads();
        const int ahead = t + kStages - 1;
        if (ahead < n_items) stage(ahead);
        __pipeline_commit();
        int tile, j, c;
        decode(t, total, doff, dstart, nl, tile, j, c);
        const int q0 = tile * kQueryTile;
        if (!s_skip[slot]) {
          const Val* qcol = qwt + q0 + lane;
          const long long row0 =
              static_cast<long long>(s_tb[slot]) * p.term_block;
          const int* s_lt = bufs + slot * 3 * C;
          const int* s_ld = s_lt + C;
          const Val* s_v = reinterpret_cast<const Val*>(s_ld + C);

          // The live slots are a prefix of the chunk; split them evenly.
          int n_live = 0;
          for (int hi = C; n_live < hi;) {
            const int mid = (n_live + hi) >> 1;
            if (s_ld[mid] >= 0) n_live = mid + 1; else hi = mid;
          }
          const int per_warp = (n_live + kWideWarps - 1) / kWideWarps;
          const int slice_begin = min(warp * per_warp, n_live);
          const int slice_end = min(slice_begin + per_warp, n_live);
          const int d0 = slice_begin < slice_end ? s_ld[slice_begin] : -1;
          const bool continued = slice_begin > 0 && d0 >= 0 && d0 < D &&
                                 s_ld[slice_begin - 1] == d0;
          if (lane == 0) carry_doc[warp] = -1;
          int cur = -1;
          bool first_run = true;
          float acc[kQpl];
          auto flush = [&]() {
            if (first_run && continued) {
#pragma unroll
              for (int q = 0; q < kQpl; ++q) {
                carry[warp * kQueryTile + lane + 32 * q] = acc[q];
              }
              if (lane == 0) carry_doc[warp] = cur;
            } else {
              float* row = window + cur * kRowStride;
#pragma unroll
              for (int q = 0; q < kQpl; ++q) row[lane + 32 * q] += acc[q];
            }
          };
          for (int p0 = slice_begin; p0 < slice_end; p0 += kBatch) {
            float gw[kBatch][kQpl];
#pragma unroll
            for (int jj = 0; jj < kBatch; ++jj) {
              const int pp = p0 + jj;
              const int lt = pp < slice_end ? s_lt[pp] : 0;
              const Val* q =
                  qcol + (row0 + (lt >= 0 && lt < p.term_block ? lt : 0)) *
                             p.b_pad;
#pragma unroll
              for (int q2 = 0; q2 < kQpl; ++q2) {
                gw[jj][q2] = pp < slice_end
                                 ? query_tiles::widen(__ldg(q + 32 * q2))
                                 : 0.f;
              }
            }
#pragma unroll
            for (int jj = 0; jj < kBatch; ++jj) {
              const int pp = p0 + jj;
              if (pp >= slice_end) break;
              const int d = s_ld[pp];
              const int lt = s_lt[pp];
              if (d < 0 || d >= D) continue;
              if (d != cur) {
                if (cur >= 0) {
                  flush();
                  first_run = false;
                }
                cur = d;
#pragma unroll
                for (int q = 0; q < kQpl; ++q) acc[q] = 0.f;
              }
              const float w = lt >= 0 && lt < p.term_block
                                  ? query_tiles::widen(s_v[pp])
                                  : 0.f;
#pragma unroll
              for (int q = 0; q < kQpl; ++q) {
                acc[q] = fmaf(gw[jj][q], w, acc[q]);
              }
            }
          }
          if (cur >= 0) flush();
          const bool owns_last = cur >= 0 && !(first_run && continued);
          __syncthreads();
          if (owns_last) {
            float* row = window + cur * kRowStride;
            for (int w = warp + 1; w < kWideWarps && carry_doc[w] == cur;
                 ++w) {
#pragma unroll
              for (int q = 0; q < kQpl; ++q) {
                row[lane + 32 * q] += carry[w * kQueryTile + lane + 32 * q];
              }
            }
          }
        }
        const int u = t - tile * total;
        if (u + 1 == doff[j + 1]) {  // the block's last chunk in this tile
          __syncthreads();
          const long long col0 = static_cast<long long>(lblk[j]) * D;
          for (int x = threadIdx.x; x < kQueryTile * D; x += kWideThreads) {
            const int q = x / D;
            const int d = x - q * D;
            if (q0 + q < b) {
              scores[static_cast<long long>(q0 + q) * p.n_pad + col0 + d] =
                  kept<Val>(window[d * kRowStride + q]);
            }
            window[d * kRowStride + q] = 0.f;
          }
        }
      }
      __pipeline_wait_prior(0);
    }
    step_barrier(R);  // the step's scores are written

    if (rank == 0) {
      // Fold each alive row's window into its heap, one warp a row.
      float* wv = region + warp * 2 * next_pow2(D);
      int* wdest = reinterpret_cast<int*>(wv + next_pow2(D));
      for (int r = warp; r < b; r += kWideWarps) {
        if (!s_alive[r]) continue;
        const float kth = fold_row(p, g, r, s_blk[r], wv, wdest, lane);
        if (lane == 0) s_tau[r] = fmaxf(s_tau[r], kth);
        __syncwarp();
      }
      __syncthreads();
    }
  }
  if (rank == 0 && threadIdx.x == 0) p.steps[g] = i;
}

// Launches `kernel` over groups x cluster CTAs.  A cluster the card cannot
// co-schedule is halved until it can (to 1: no cluster); *used receives the
// size launched.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int smem, Params p, int groups,
                   int cluster, int* used, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  int c = cluster;
  if (c > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  for (; c > 1; c >>= 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(groups * c);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess &&
        n > 0) {
      break;
    }
    cudaGetLastError();  // clear the refusal
  }
  if (c <= 1) {
    c = 1;
    cfg.attrs = nullptr;
    cfg.numAttrs = 0;
  }
  cfg.gridDim = dim3(groups * c);
  p.cluster = c;
  *used = c;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class Val>
int launch_route(int route, int tile, int cluster, long long smem,
                 int* cluster_used, const Params& p, int groups,
                 cudaStream_t s) {
  if (cluster < 1 || cluster > 16 || smem > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  const int C = p.chunk_size;
  if (route == 0) {  // small: tile = b rounded up to a power of two <= 8
    // A TMA copy moves a multiple of 16 bytes from a 16-byte boundary.
    if (p.b > tile || (C * static_cast<int>(sizeof(Val))) % 16 != 0 ||
        C > 512) {
      return cudaErrorInvalidValue;
    }
    const PipeLayout lay(tile, p.doc_block, C, p.n_words, p.n_tb,
                         weight_words<Val>(p.nz_in_smem, p.nz_cap, tile),
                         p.max_run);
    if (static_cast<long long>(lay.total) * 4 != smem ||
        p.spec_workers < cluster * kPipeWarps) {
      return cudaErrorInvalidValue;  // ops.py and this file disagree
    }
    const int bytes = static_cast<int>(smem);
    const int threads = 32 * kPipeWarps;
    switch (tile) {
      case 1: return launch(sweep_small<1, Val>, threads, bytes, p, groups,
                            cluster, cluster_used, s);
      case 2: return launch(sweep_small<2, Val>, threads, bytes, p, groups,
                            cluster, cluster_used, s);
      case 4: return launch(sweep_small<4, Val>, threads, bytes, p, groups,
                            cluster, cluster_used, s);
      case 8: return launch(sweep_small<8, Val>, threads, bytes, p, groups,
                            cluster, cluster_used, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route != 1 || p.b_pad % tile != 0 ||
      (C * static_cast<int>(sizeof(Val))) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  const WideLayout lay(tile, p.doc_block, C, p.b, p.n_tb);
  if (static_cast<long long>(lay.words()) * 4 != smem) {
    return cudaErrorInvalidValue;  // ops.py and this file disagree
  }
  const int bytes = static_cast<int>(smem);
  if (tile == 32) {
    return launch(sweep_wide<1, Val>, kWideThreads, bytes, p, groups, cluster,
                  cluster_used, s);
  }
  if (tile == 128) {
    return launch(sweep_wide<4, Val>, kWideThreads, bytes, p, groups, cluster,
                  cluster_used, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16 = 0: qwt, nz_w and value are f32; 1: bf16.  The retire test's
// margin is margin_rel * |tau| + 1e-6.
extern "C" int bmp_scan_launch(
    int route, int tile, int cluster, long long smem, int* cluster_used,
    int bf16, const void* qwt, const unsigned* nz_bits, const int* nz_rank,
    const void* nz_w, const int* tb_nz, const int* order,
    const float* ub_sorted, const float* tau0, const int* block_chunk_start,
    const int* block_chunk_count, const int* chunk_term_block,
    const int* local_term, const int* local_doc, const void* value,
    const unsigned char* alive_doc, float* scores, float* heap,
    int* block_scored, int* chunk_scored, int* steps, int groups, int b,
    int b_pad, long long v_pad, int n_db, int num_chunks, int term_block,
    int doc_block, int chunk_size, int k_eff, float theta, float margin_rel,
    long long num_docs, int n_words, int nz_cap, int nz_in_smem, int n_tb,
    int max_run, float* spec, int spec_workers, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p{qwt, nz_bits, nz_rank, nz_w, tb_nz, order, ub_sorted, tau0,
           block_chunk_start, block_chunk_count, chunk_term_block,
           local_term, local_doc, value, alive_doc, scores, heap,
           block_scored, chunk_scored, steps, b, b_pad, v_pad, n_db,
           num_chunks, term_block, doc_block, chunk_size, k_eff, theta,
           margin_rel, num_docs, static_cast<long long>(n_db) * doc_block,
           n_words, nz_cap, nz_in_smem, n_tb, max_run, 1, spec, spec_workers};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_route<unsigned short>(route, tile, cluster, smem,
                                        cluster_used, p, groups, s);
  }
  return launch_route<float>(route, tile, cluster, smem, cluster_used, p,
                             groups, s);
}

extern "C" const char* bmp_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
