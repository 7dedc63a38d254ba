// Doc-parallel ELL gather scoring, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro.kernels.ell_gather.kernel
// .ell_gather_kernel (src/repro/kernels/ell_gather/kernel.py).  It computes
//
//     out[b, n] = sum_k values[n, k] * QW[b, terms[n, k]]
//
// where a term id outside [0, vocab) — the index pads with vocab_size —
// contributes nothing.  The TPU kernel keeps QW^T resident in VMEM and
// walks (doc block, K chunk) grid steps in order, accumulating into the
// output window.  Here one CTA owns kDocTile docs x kQueryTile queries and
// loops over all K slots itself, so no window is shared and no atomics are
// needed.  The query tiles of a doc tile are neighbours in the grid, so
// they run together and each doc's ELL row comes from HBM about once a
// launch; L2 serves the other tiles.  Each warp scores kDocsPerWarp docs,
// one after another, reading a doc's slots 32 at a time (one coalesced load
// of terms and of values) and skipping a batch with no live slot; each
// (doc, query) sum runs over the slots in slot order, from +0.  The tile of
// scores goes through shared memory so that the [B, N] output is written
// in coalesced rows.
//
// The query weights come packed by tile (kernels/query_tiles.py): for a
// sparse tile, a (offset, count) record per term and the term's nonzero
// (query, weight) entries; for a dense tile, the [V, kQueryTile] slab.
// * Sparse route: each lane loads its slot's record; the slots whose count
//   is 0 are skipped (a ballot); the rest are walked in slot order with
//   lanes over the term's entries, lane i adding entry i's product into the
//   doc's row of the shared tile (a pair of weight 0 is never summed).  The
//   entries of kGroup slots are loaded together (query_tiles.cuh), and the
//   next batch's slots while this one is summed.
// * Dense route: lanes over queries (lane l carries queries l, l+32, l+64,
//   l+96), each slot broadcast to the lanes, a register a query.
// Skipped work adds nothing where the dense route adds +0 to a finite sum,
// so both routes give the same bits.
//
// Two element types (query_tiles.cuh Types): f32, and bf16, where the
// values, the packed weights and the slab are read as bf16 (half the
// bytes), widened exactly to f32, multiplied exactly (a product of two
// bf16 fits in f32) and summed in f32 as the f32 route sums them; each
// score is rounded once to bf16 as it is written.  So the bf16 route's
// scores are the f32 route's on the bf16-rounded inputs, rounded once.
//
// What bounds it: the HBM floor is one read of the ELL stream and one
// write of the scores (~1.3 ms at serve_1m); the nonzero products are ~9 %
// of postings x B.  The sparse route reads a record (8 B, through L2) a
// slot and ~19 entries a live slot, where a dense gather reads kQueryTile
// weights (512 B) a slot.  What holds it back is the live slots' walk:
// ~20 instructions and ~10 shared-memory wavefronts a live slot (the row's
// read-modify-write meets bank conflicts), one slot after another a warp.
#include <cuda_runtime.h>

#include "query_tiles.cuh"

namespace {

constexpr int kQpl = 4;                 // queries per lane, dense route
constexpr int kQueryTile = 32 * kQpl;   // queries per CTA
constexpr int kRowStride = kQueryTile + 1;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDocsPerWarp = 4;
constexpr int kDocTile = kWarps * kDocsPerWarp;
constexpr int kGroup = 4;  // sparse route: postings whose entries load together
constexpr unsigned kFull = 0xffffffffu;

// Dense route: one doc's scores for the tile into row (slab points at this
// lane's column of the tile's [V, kQueryTile] slab).
template <class Val>
__device__ void doc_dense(const int* trow, const Val* vrow, int k,
                          int vocab, const Val* slab, float* row,
                          int lane) {
  float acc[kQpl];
#pragma unroll
  for (int r = 0; r < kQpl; ++r) acc[r] = 0.f;
  for (int s = 0; s < k; s += 32) {
    int t = -1;
    float v = 0.f;
    if (s + lane < k) {
      t = trow[s + lane];
      v = query_tiles::widen(vrow[s + lane]);
    }
    const bool live = t >= 0 && t < vocab;
    if (__ballot_sync(kFull, live) == 0u) continue;
    const int t_safe = live ? t : 0;
    const float w = live ? v : 0.f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int tj = __shfl_sync(kFull, t_safe, j);
      const float wj = __shfl_sync(kFull, w, j);
      const Val* q = slab + static_cast<long long>(tj) * kQueryTile;
#pragma unroll
      for (int r = 0; r < kQpl; ++r) {
        acc[r] = fmaf(query_tiles::widen(__ldg(q + 32 * r)), wj, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kQpl; ++r) row[lane + 32 * r] = acc[r];
}

// Sparse route: one doc's scores for the tile, summed in row (shared).
// The next batch's terms and values are loaded while this one is summed.
template <class Val, class Entry>
__device__ void doc_sparse(const int* trow, const Val* vrow, int k,
                           int vocab, const int2* rec_tile,
                           const Entry* __restrict__ entries, float* row,
                           int4* s_st, int lane) {
  using query_tiles::widen;
#pragma unroll
  for (int r = 0; r < kQpl; ++r) row[lane + 32 * r] = 0.f;
  int t_next = lane < k ? __ldcg(trow + lane) : -1;
  float v_next = lane < k ? widen(__ldcg(vrow + lane)) : 0.f;
  for (int s = 0; s < k; s += 32) {
    const int t = t_next;
    const float v = v_next;
    const bool more = s + 32 + lane < k;
    t_next = more ? __ldcg(trow + s + 32 + lane) : -1;
    v_next = more ? widen(__ldcg(vrow + s + 32 + lane)) : 0.f;
    // Records bypass L1, which keeps the tile's entries.
    const int2 rec = t >= 0 && t < vocab ? __ldcg(rec_tile + t) : make_int2(0, 0);
    __syncwarp();  // the previous batch's postings are consumed
    s_st[lane] = query_tiles::staged(rec, v, -1);
    const unsigned live = __ballot_sync(kFull, rec.y > 0);
    __syncwarp();
    query_tiles::sum_live<kGroup>(live, s_st, entries,
                                  [&](const int4&) { return row; }, lane);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
ell_gather_kernel(const int2* __restrict__ records,   // [n_tiles, vocab]
                  const typename query_tiles::Types<kBf16>::Entry* __restrict__
                      entries,                        // sparse tiles: [entries]
                  const typename query_tiles::Types<kBf16>::Val* __restrict__
                      cw,                             // dense tiles: [n, vocab, 128]
                  const int* __restrict__ tile_dense, // [n_tiles]
                  const int* __restrict__ terms,      // [n_pad, k]
                  const typename query_tiles::Types<kBf16>::Val* __restrict__
                      values,                         // [n_pad, k]
                  typename query_tiles::Types<kBf16>::Val* __restrict__
                      out,                            // [b, n_pad]
                  int b, int n_tiles, int vocab, long long n_pad, int k) {
  using Val = typename query_tiles::Types<kBf16>::Val;
  __shared__ float tile_s[kDocTile][kRowStride];
  __shared__ int4 s_st[kWarps][32];
  const int tile = blockIdx.x % n_tiles;
  const long long n0 = static_cast<long long>(blockIdx.x / n_tiles) * kDocTile;
  const int q0 = tile * kQueryTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool dense = tile_dense[tile] != 0;
  const int2* rec_tile = records + static_cast<long long>(tile) * vocab;
  // Dense route: the tile's slab starts at its first term's entries.
  const Val* slab = cw + (dense ? rec_tile[0].x : 0) + lane;

  for (int r = 0; r < kDocsPerWarp; ++r) {
    const int dl = warp * kDocsPerWarp + r;
    const long long n = n0 + dl;
    float* row = tile_s[dl];
    if (n >= n_pad) continue;
    const int* trow = terms + n * k;
    const Val* vrow = values + n * k;
    if (dense) {
      doc_dense(trow, vrow, k, vocab, slab, row, lane);
    } else {
      doc_sparse(trow, vrow, k, vocab, rec_tile, entries, row, s_st[warp],
                 lane);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kQueryTile * kDocTile; i += kThreads) {
    const int q = i / kDocTile;
    const int d = i % kDocTile;
    if (q0 + q < b && n0 + d < n_pad) {
      query_tiles::store(out + static_cast<long long>(q0 + q) * n_pad + n0 + d,
                         tile_s[d][q]);
    }
  }
}

template <bool kBf16>
int launch(const int* records, const void* entries, const void* cw,
           const int* tile_dense, const int* terms, const void* values,
           void* out, int b, int n_tiles, int vocab, long long n_pad, int k,
           int device, void* stream) {
  using T = query_tiles::Types<kBf16>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_tiles < 1 || b > n_tiles * kQueryTile) return cudaErrorInvalidValue;
  const long long blocks = (n_pad + kDocTile - 1) / kDocTile * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ell_gather_kernel<kBf16><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int2*>(records),
      static_cast<const typename T::Entry*>(entries),
      static_cast<const typename T::Val*>(cw), tile_dense, terms,
      static_cast<const typename T::Val*>(values),
      static_cast<typename T::Val*>(out), b, n_tiles, vocab, n_pad, k);
  return cudaGetLastError();
}

}  // namespace

// f32: entries int32 [E, 2], cw, values and out f32.
extern "C" int ell_gather_launch(const int* records, const int* entries,
                                 const float* cw, const int* tile_dense,
                                 const int* terms, const float* values,
                                 float* out, int b, int n_tiles, int vocab,
                                 long long n_pad, int k, int device,
                                 void* stream) {
  return launch<false>(records, entries, cw, tile_dense, terms, values, out,
                       b, n_tiles, vocab, n_pad, k, device, stream);
}

// bf16: entries int32 [E] (query | weight's bf16 bits << 16), cw, values
// and out bf16.
extern "C" int ell_gather_bf16_launch(const int* records, const int* entries,
                                      const void* cw, const int* tile_dense,
                                      const int* terms, const void* values,
                                      void* out, int b, int n_tiles,
                                      int vocab, long long n_pad, int k,
                                      int device, void* stream) {
  return launch<true>(records, entries, cw, tile_dense, terms, values, out,
                      b, n_tiles, vocab, n_pad, k, device, stream);
}

extern "C" const char* ell_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
