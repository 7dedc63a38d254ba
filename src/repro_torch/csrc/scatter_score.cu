// Term-parallel scatter-add scoring over a TiledIndex, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro.kernels.scatter_score.kernel
// .scatter_score_kernel (src/repro/kernels/scatter_score/kernel.py).
// It computes, for every chunk i and slot j with local_doc[i,j] >= 0 and
// 0 <= local_term[i,j] < term_block,
//
//     out[b, db_i*D + local_doc[i,j]] += QW[b, tb_i*T + local_term[i,j]] * value[i,j]
//
// The TPU kernel walks the chunk stream in order on one core and keeps a
// doc block's [B, D] window in VMEM across that block's chunks (chunk_first
// zeroes it).  CTAs run in no order, so here one CTA owns one (doc block,
// tile of kQueryTile queries) pair: it zeroes its window in shared memory,
// walks the block's chunk run [block_chunk_start[db], +block_chunk_count[db])
// and writes the window once.  No global atomics.  The query tiles of a doc
// block are neighbours in the grid, so they run together and the chunk
// stream comes from HBM about once; L2 serves the other tiles.
//
// The fold order (bmp_scan.cu keeps the same one, so the pruned engines
// give these bits): a chunk's live slots (a prefix sorted by local_doc) are
// cut into 32 equal slices; within a slice each doc's postings are summed
// in slot order with fmaf(weight, value, acc) from +0 (a "part"); a doc's
// parts are added into its window row in slice order; chunks follow in run
// order.
//
// Warps own docs, not slices: warp w owns the window rows of docs
// [w * ceil(D/32), (w + 1) * ceil(D/32)) and walks the whole chunk run on
// its own, reading from each chunk only its docs' slots (a contiguous
// segment, whose bounds the entry finds for every chunk and warp:
// doc_bounds) and cutting them into parts at every change of doc or of
// slice.  It adds each part into its own row as soon as the part ends, so
// no row has two writers, no carry crosses warps and the loop needs no
// barrier: warps drift apart and hide each other's latency.  The order of
// every sum is fixed, so results repeat bit for bit.
//
// The query weights come packed by tile (kernels/query_tiles.py): for a
// sparse tile, a (offset, count) record per term and the term's nonzero
// (query, weight) entries; for a dense tile, the [V, kQueryTile] slab.
// * Sparse route: a warp stages its segment's postings (the term's record
//   in the tile, value, doc and slice) 32 slots at a time, skips the
//   postings whose count is 0, and walks the rest with lanes over the
//   term's entries (query_tiles.cuh): lane i adds entry i's product into the
//   warp's part row in shared memory (a (posting, query) pair of weight 0 is
//   never summed), kGroup postings' entries loaded together.  A part with
//   no posting summed is not added.
// * Dense route: lanes over queries (lane l carries queries l, l+32, l+64,
//   l+96), kBatch slots' weights gathered at once from the slab, a
//   register a query.
// Skipping a zero weight, a zero posting or an all-zero part adds nothing
// where the dense route adds +0 to a finite sum, so both routes give the
// same bits.
//
// Two element types (query_tiles.cuh Types): f32, and bf16, where the
// values, the packed weights and the slab are read as bf16, widened
// exactly, multiplied exactly and summed in f32 in the order above; a
// warp's docs' sums are complete when the run ends, so each score is
// rounded once to bf16 as the window is written, with no atomics.
//
// What bounds it: the HBM floor is one read of the chunk stream and one
// write of the scores (~1.3 ms at serve_1m); the nonzero products are ~9 %
// of postings x B.  A warp's walk is a chain of dependent loads a chunk
// (its slots, records and entries), ~100 chunks long, with the
// instructions of the live postings' walk on it; only 32 warps an SM (the
// [256, 129] f32 window takes 132 KB of shared memory) overlap those
// chains.  The part rows' read-modify-writes and flushes cost little
// beside the walk itself.
#include <cuda_runtime.h>

#include "query_tiles.cuh"

namespace {

constexpr int kQpl = 4;                 // queries per lane, dense route
constexpr int kQueryTile = 32 * kQpl;   // queries per CTA
constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kSlices = 32;             // slices of a chunk's live slots
constexpr int kRowStride = kQueryTile + 1;  // odd: conflict-free column reads
constexpr int kBatch = 4;               // dense route: slots gathered together
constexpr int kGroup = 2;               // sparse route: postings whose entries load together
constexpr unsigned kFull = 0xffffffffu;

// A warp's segment of one chunk: slots [lo, hi) of the live prefix hold
// the warp's docs; slot p lies in slice p / per.
template <class Val>
struct Segment {
  const int* lt;     // the chunk's local terms, docs and values (global)
  const int* ld;
  const Val* v;
  long long row0;    // the chunk's first term: term block x term_block
  int lo, hi, per;
};

// Part keys: doc * kSlices + slice; -1: no part open.
__device__ __forceinline__ int part_key(int doc, int p, int per) {
  return doc * kSlices + p / per;
}

// row[doc] += acc, the doc of part `key`.
__device__ __forceinline__ void add_part(const float* acc, int key,
                                         float* window, int lane) {
  float* row = window + (key / kSlices) * kRowStride;
#pragma unroll
  for (int r = 0; r < kQpl; ++r) row[lane + 32 * r] += acc[r];
}

// Dense route: lanes over the tile's queries, weights from the slab
// [V, kQueryTile] (slab points at this lane's column).  The segment's slots
// are loaded 32 at a time, a slot a lane, and broadcast.
template <class Val>
__device__ void fold_dense(const Segment<Val>& g, const Val* slab,
                           int term_block, int doc_block, float* window,
                           int lane) {
  using query_tiles::widen;
  int cur = -1;
  float acc[kQpl];
  for (int base = g.lo; base < g.hi; base += 32) {
    const int n = min(32, g.hi - base);
    const int p = base + lane;
    int t = 0, key = -1;
    float x = 0.f;
    if (p < g.hi) {
      const int tl = __ldg(g.lt + p);
      const int d = __ldg(g.ld + p);
      if (d >= 0 && d < doc_block) key = part_key(d, p, g.per);
      if (tl >= 0 && tl < term_block) {
        t = tl;
        x = widen(__ldg(g.v + p));
      }
    }
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float w[kBatch][kQpl];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {  // gathers, all in flight
        const Val* q = slab + (g.row0 + __shfl_sync(kFull, t, j0 + j)) * kQueryTile;
#pragma unroll
        for (int r = 0; r < kQpl; ++r) {
          w[j][r] = j0 + j < n ? widen(__ldg(q + 32 * r)) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {  // fold in slot order
        const int kj = __shfl_sync(kFull, key, j0 + j);
        const float xj = __shfl_sync(kFull, x, j0 + j);
        if (j0 + j >= n || kj < 0) continue;
        if (kj != cur) {
          if (cur >= 0) add_part(acc, cur, window, lane);
          cur = kj;
#pragma unroll
          for (int r = 0; r < kQpl; ++r) acc[r] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < kQpl; ++r) acc[r] = fmaf(w[j][r], xj, acc[r]);
      }
    }
  }
  if (cur >= 0) add_part(acc, cur, window, lane);
}

// Sparse route: lanes over each posting's nonzero entries; the running
// part in part_row (shared, zero between parts).
template <class Val, class Entry>
__device__ void fold_sparse(const Segment<Val>& g, const int2* rec_tile,
                            const Entry* __restrict__ entries, int term_block,
                            int doc_block, float* window, float* part_row,
                            int4* s_st, int lane) {
  int cur = -1;
  auto flush = [&]() {
    __syncwarp();
    float acc[kQpl];
#pragma unroll
    for (int r = 0; r < kQpl; ++r) {
      acc[r] = part_row[lane + 32 * r];
      part_row[lane + 32 * r] = 0.f;
    }
    add_part(acc, cur, window, lane);
    __syncwarp();  // the zeroed row is seen by every lane
  };
  for (int base = g.lo; base < g.hi; base += 32) {
    const int p = base + lane;
    int2 rec = make_int2(0, 0);
    float v = 0.f;
    int key = -1;
    if (p < g.hi) {
      const int t = __ldg(g.lt + p);
      const int d = __ldg(g.ld + p);
      v = query_tiles::widen(__ldg(g.v + p));
      if (t >= 0 && t < term_block && d >= 0 && d < doc_block) {
        rec = __ldcg(rec_tile + g.row0 + t);  // bypass L1, which keeps the entries
        key = part_key(d, p, g.per);
      }
    }
    __syncwarp();  // the previous piece's postings are consumed
    s_st[lane] = query_tiles::staged(rec, v, key);
    const unsigned live = __ballot_sync(kFull, rec.y > 0);
    __syncwarp();
    query_tiles::sum_live<kGroup>(
        live, s_st, entries,
        [&](const int4& st) {
          if (st.w != cur) {
            if (cur >= 0) flush();
            cur = st.w;
          }
          return part_row;
        },
        lane);
  }
  if (cur >= 0) flush();
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
scatter_score_kernel(const int2* __restrict__ records,     // [n_tiles, v_pad]
                     const typename query_tiles::Types<kBf16>::Entry*
                         __restrict__ entries,             // sparse tiles: [entries]
                     const typename query_tiles::Types<kBf16>::Val*
                         __restrict__ cw,                  // dense tiles: [n, v_pad, 128]
                     const int* __restrict__ tile_dense,   // [n_tiles]
                     const int* __restrict__ local_term,   // [n_chunks, C]
                     const int* __restrict__ local_doc,    // [n_chunks, C]
                     const typename query_tiles::Types<kBf16>::Val*
                         __restrict__ value,               // [n_chunks, C]
                     const int* __restrict__ chunk_term_block,   // [n_chunks]
                     const int* __restrict__ doc_bounds,   // [n_chunks, kWarps + 1]
                     const int* __restrict__ block_chunk_start,  // [n_db]
                     const int* __restrict__ block_chunk_count,  // [n_db]
                     typename query_tiles::Types<kBf16>::Val*
                         __restrict__ out,                 // [b, n_pad]
                     int b, int n_tiles, int v_pad, int term_block,
                     int doc_block, int chunk_size, long long n_pad) {
  using Val = typename query_tiles::Types<kBf16>::Val;
  extern __shared__ __align__(16) float smem[];
  int4* s_st = reinterpret_cast<int4*>(smem);              // [kWarps][32]
  float* window = reinterpret_cast<float*>(s_st + kWarps * 32);  // [doc_block][kRowStride]
  float* parts = window + doc_block * kRowStride;          // [kWarps][kQueryTile]

  const int tile = blockIdx.x % n_tiles;
  const int db = blockIdx.x / n_tiles;
  const int q0 = tile * kQueryTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool dense = tile_dense[tile] != 0;
  const int2* rec_tile = records + static_cast<long long>(tile) * v_pad;
  // Dense route: the tile's slab starts at its first term's entries.
  const Val* slab = cw + (dense ? rec_tile[0].x : 0) + lane;

  for (int i = threadIdx.x; i < doc_block * kRowStride; i += kThreads) {
    window[i] = 0.f;
  }
  for (int i = threadIdx.x; i < kWarps * kQueryTile; i += kThreads) {
    parts[i] = 0.f;
  }
  __syncthreads();

  const int c_begin = block_chunk_start[db];
  const int c_end = c_begin + block_chunk_count[db];
  // This warp's slots of chunk c: [bounds[w], bounds[w + 1]); the live
  // count: bounds[kWarps].  Loaded a chunk ahead.
  auto bounds_of = [&](int c) {
    const int* b = doc_bounds + static_cast<long long>(c) * (kWarps + 1);
    return c < c_end ? make_int4(__ldg(b + warp), __ldg(b + warp + 1),
                                 __ldg(b + kWarps), __ldg(chunk_term_block + c))
                     : make_int4(0, 0, 0, 0);
  };
  int4 next = bounds_of(c_begin);
  for (int c = c_begin; c < c_end; ++c) {
    const int4 cur = next;  // lo, hi, live count, term block
    next = bounds_of(c + 1);
    if (cur.x == cur.y) continue;
    Segment<Val> g;
    const long long base = static_cast<long long>(c) * chunk_size;
    g.lt = local_term + base;
    g.ld = local_doc + base;
    g.v = value + base;
    g.row0 = static_cast<long long>(cur.w) * term_block;
    g.per = max((cur.z + kSlices - 1) / kSlices, 1);
    g.lo = cur.x;
    g.hi = cur.y;
    if (dense) {
      fold_dense(g, slab, term_block, doc_block, window, lane);
    } else {
      fold_sparse(g, rec_tile, entries, term_block, doc_block, window,
                  parts + warp * kQueryTile, s_st + warp * 32, lane);
    }
  }
  __syncthreads();

  const long long col0 = static_cast<long long>(db) * doc_block;
  for (int i = threadIdx.x; i < kQueryTile * doc_block; i += kThreads) {
    const int q = i / doc_block;
    const int d = i - q * doc_block;
    if (q0 + q < b) {
      query_tiles::store(out + static_cast<long long>(q0 + q) * n_pad + col0 + d,
                         window[d * kRowStride + q]);
    }
  }
}

template <bool kBf16>
int launch(const int* records, const void* entries, const void* cw,
           const int* tile_dense, const int* local_term, const int* local_doc,
           const void* value, const int* chunk_term_block,
           const int* doc_bounds, const int* block_chunk_start,
           const int* block_chunk_count, void* out, int b, int n_tiles,
           int v_pad, int n_db, int term_block, int doc_block, int chunk_size,
           long long n_pad, int device, void* stream) {
  using T = query_tiles::Types<kBf16>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_tiles < 1 || b > n_tiles * kQueryTile) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kWarps) * 32 * sizeof(int4) +
                      static_cast<size_t>(doc_block) * kRowStride * sizeof(float) +
                      static_cast<size_t>(kWarps) * kQueryTile * sizeof(float);
  err = cudaFuncSetAttribute(scatter_score_kernel<kBf16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(n_db) * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  scatter_score_kernel<kBf16><<<static_cast<unsigned>(blocks), kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int2*>(records),
      static_cast<const typename T::Entry*>(entries),
      static_cast<const typename T::Val*>(cw), tile_dense, local_term,
      local_doc, static_cast<const typename T::Val*>(value), chunk_term_block,
      doc_bounds, block_chunk_start, block_chunk_count,
      static_cast<typename T::Val*>(out), b, n_tiles, v_pad, term_block,
      doc_block, chunk_size, n_pad);
  return cudaGetLastError();
}

}  // namespace

// f32: entries int32 [E, 2], cw, value and out f32.
extern "C" int scatter_score_launch(const int* records, const int* entries,
                                    const float* cw, const int* tile_dense,
                                    const int* local_term,
                                    const int* local_doc, const float* value,
                                    const int* chunk_term_block,
                                    const int* doc_bounds,
                                    const int* block_chunk_start,
                                    const int* block_chunk_count, float* out,
                                    int b, int n_tiles, int v_pad, int n_db,
                                    int term_block, int doc_block,
                                    int chunk_size, long long n_pad,
                                    int device, void* stream) {
  return launch<false>(records, entries, cw, tile_dense, local_term,
                       local_doc, value, chunk_term_block, doc_bounds,
                       block_chunk_start, block_chunk_count, out, b, n_tiles,
                       v_pad, n_db, term_block, doc_block, chunk_size, n_pad,
                       device, stream);
}

// bf16: entries int32 [E] (query | weight's bf16 bits << 16), cw, value
// and out bf16.
extern "C" int scatter_score_bf16_launch(
    const int* records, const int* entries, const void* cw,
    const int* tile_dense, const int* local_term, const int* local_doc,
    const void* value, const int* chunk_term_block, const int* doc_bounds,
    const int* block_chunk_start, const int* block_chunk_count, void* out,
    int b, int n_tiles, int v_pad, int n_db, int term_block, int doc_block,
    int chunk_size, long long n_pad, int device, void* stream) {
  return launch<true>(records, entries, cw, tile_dense, local_term,
                      local_doc, value, chunk_term_block, doc_bounds,
                      block_chunk_start, block_chunk_count, out, b, n_tiles,
                      v_pad, n_db, term_block, doc_block, chunk_size, n_pad,
                      device, stream);
}

extern "C" const char* scatter_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
