// The sparse route shared by scatter_score.cu and ell_gather.cu: a warp
// sums a batch of up to 32 postings against a query tile packed by
// kernels/query_tiles.py: a (offset, count) record per term, then the
// term's nonzero (query, weight) entries.
#pragma once

#include <cuda_runtime.h>

namespace query_tiles {

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
template <int kGroup, class Open>
__device__ __forceinline__ void sum_live(unsigned live, const int4* s_st,
                                         const int2* __restrict__ entries,
                                         Open open, int lane) {
  while (live) {
    int js[kGroup];
    int2 e[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      js[u] = live ? __ffs(live) - 1 : -1;
      live &= live - 1u;
      e[u] = make_int2(0, 0);
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
      if (lane < st.y) row[e[u].x] = fmaf(__int_as_float(e[u].y), v, row[e[u].x]);
      for (int i = lane + 32; i < st.y; i += 32) {  // terms of > 32 queries
        const int2 ei = __ldg(entries + st.x + i);
        row[ei.x] = fmaf(__int_as_float(ei.y), v, row[ei.x]);
      }
      __syncwarp();
    }
  }
}

}  // namespace query_tiles
