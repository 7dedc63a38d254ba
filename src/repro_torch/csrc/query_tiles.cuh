// The sparse route shared by scatter_score.cu and ell_gather.cu: a warp
// sums a batch of up to 32 postings against a query tile packed by
// kernels/query_tiles.py: a (offset, count) record per term, then the
// term's nonzero (query, weight) entries.  Also the two routes' element
// types: f32, and bf16 (index values, query weights and scores held as
// bf16 bits; every product and sum in f32, each score rounded once).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace query_tiles {

// An f32 or bf16 element widened to f32 (exact).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(unsigned short x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

// A score stored: as it is (f32), or rounded once to the nearest bf16,
// ties to even (bf16).
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(unsigned short* dst, float x) {
  *dst = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// A packed weight: f32 tiles hold (query, weight's f32 bits) pairs; bf16
// tiles one word, the query in bits 0-15 and the weight's bf16 bits in
// bits 16-31.
__device__ __forceinline__ int entry_query(int2 e) { return e.x; }
__device__ __forceinline__ float entry_weight(int2 e) {
  return __int_as_float(e.y);
}
__device__ __forceinline__ int entry_query(unsigned e) {
  return static_cast<int>(e & 0xffffu);
}
__device__ __forceinline__ float entry_weight(unsigned e) {
  return __uint_as_float(e & 0xffff0000u);
}

// The element types of a route: index values, dense slabs and scores
// (Val), packed sparse weights (Entry).
template <bool kBf16>
struct Types {
  using Val = float;
  using Entry = int2;
};
template <>
struct Types<true> {
  using Val = unsigned short;
  using Entry = unsigned;
};

// A posting staged in shared memory: its term's record in the tile, its
// value's bits and a tag of the caller's (scatter_score: the part's key).
__device__ __forceinline__ int4 staged(int2 rec, float v, int tag) {
  return make_int4(rec.x, rec.y, __float_as_int(v), tag);
}

// Sum the postings of a batch whose bits are set in `live` (each with a
// nonzero count), in slot order.  For each in turn, `open(st)` (st: the
// staged posting) returns the shared row its products go into (it may
// first finish the previous part); lane i adds entry i's product into
// row[query].  The entries of kGroup postings are loaded together before
// any is summed, so one round trip serves the group.  Every lane of the
// warp calls this; a __syncwarp separates two postings' sums, so each
// (row, query) sum is one chain in slot order.
template <int kGroup, class Entry, class Open>
__device__ __forceinline__ void sum_live(unsigned live, const int4* s_st,
                                         const Entry* __restrict__ entries,
                                         Open open, int lane) {
  while (live) {
    int js[kGroup];
    Entry e[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      js[u] = live ? __ffs(live) - 1 : -1;
      live &= live - 1u;
      e[u] = Entry{};
      if (js[u] >= 0) {
        const int4 st = s_st[js[u]];
        if (lane < st.y) e[u] = __ldg(entries + st.x + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (js[u] < 0) break;
      const int4 st = s_st[js[u]];
      float* row = open(st);
      const float v = __int_as_float(st.z);
      if (lane < st.y) {
        const int j = entry_query(e[u]);
        row[j] = fmaf(entry_weight(e[u]), v, row[j]);
      }
      for (int i = lane + 32; i < st.y; i += 32) {  // terms of > 32 queries
        const Entry ei = __ldg(entries + st.x + i);
        const int j = entry_query(ei);
        row[j] = fmaf(entry_weight(ei), v, row[j]);
      }
      __syncwarp();
    }
  }
}

}  // namespace query_tiles
