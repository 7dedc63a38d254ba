// The demand-grouped BMP sweep over a TiledIndex, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro.kernels.bmp_scan.kernel.bmp_scan_kernel
// (src/repro/kernels/bmp_scan/kernel.py, with _kernel, _rank_desc and
// _sort_by_rank).  For each group g of a launch (one CTA each) it runs the
// whole descending-bound sweep of the group's b rows:
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
// The TPU kernel ran the groups of a bucket one after another on one core,
// kept a group's scores, heap and query weights in VMEM (hence its 128-row
// cap), merged the heap by an [m, m] rank comparison and fetched only the
// demanded chunk lines by DMA.  Here the groups run in parallel, one CTA
// (32 warps) each; scores [G, b, n_pad] and heap [G, b, k_eff] live in
// device memory (the group's working set stays in L2), so a group may have
// any number of rows and the alive mask is an operand.
//
// Scoring a demanded block is scatter_score.cu's algorithm: per tile of
// kQueryTile rows, a [doc_block, kQueryTile] window in shared memory, the
// block's chunk run copied into a ring of kStages shared buffers with
// cp.async (kStages - 1 chunks ahead, across block and tile boundaries:
// the step's chunk runs are walked as one stream), each chunk's live slots
// split evenly over the warps, each doc's postings summed in slot order
// (a sum that crosses a slice goes through a carry row to the segment's
// head warp), the window written once.  Blocks are disjoint windows, so
// the order in which a step's blocks are scored changes no bit, and the
// scores of a block are the same bits scatter_score gives.  Only demanded
// chunk lines leave device memory.
//
// Threshold update, one warp per alive row: the window's values above the
// heap's k-th value (the only ones that can change the heap's values) are
// compacted into shared memory and bitonic-sorted descending; each lands
// at its rank in heap ∪ window (a binary search in the heap, heap first on
// ties), and the heap entries below it move down by the count of larger
// window values, written from the tail so nothing is overwritten before it
// is read.  Only values are kept, so the heap holds exactly lax.top_k's
// values and tau is bit-identical.  The retire test rounds as the plain
// version (separate f32 multiply, add and subtract: no contraction to FMA).
//
// What bounds it: a group's chunk walk runs on one SM, one chunk after
// another, with every posting gathering its term's weights for a tile of
// rows (as scatter_score, far above the HBM floor of one read of the
// demanded chunk lines), plus one pass over the retire test, the demand
// set and the heap merges per rank step.  Groups in parallel fill the
// card only when a launch holds many of them.  Splitting a group's blocks
// over a cluster of CTAs is later work.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 4;   // slots whose gathers are in flight together
constexpr int kStages = 4;  // chunk buffers in the cp.async ring

struct Params {
  const float* qwt;             // [G, v_pad, b_pad]
  const int* order;             // [G, b, n_db]
  const float* ub_sorted;       // [G, b, n_db]
  const float* tau0;            // [G, b]
  const int* block_chunk_start; // [n_db]
  const int* block_chunk_count; // [n_db]
  const int* chunk_term_block;  // [num_chunks]
  const int* local_term;        // [num_chunks, C]
  const int* local_doc;         // [num_chunks, C]
  const float* value;           // [num_chunks, C]
  const unsigned char* alive_doc;  // [num_docs] or null
  float* scores;                // [G, b, n_pad]
  float* heap;                  // [G, b, k_eff]
  int* block_scored;            // [G, n_db]
  int* chunk_scored;            // [G, num_chunks]
  int* steps;                   // [G]
  int b, b_pad;
  long long v_pad;
  int n_db, num_chunks, term_block, doc_block, chunk_size, k_eff;
  float theta;
  long long num_docs, n_pad;
};

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Shared memory, in 4-byte words, laid out in this order.
struct Layout {
  int region;   // the score window, or the per-warp heap-merge buffers
  int carry;    // kWarps x kQueryTile
  int carry_doc;
  int bufs;     // kStages x 3 x C
  int s_tb;
  int rows;     // 7 x b + 2 row and demand-set words
  __host__ __device__ Layout(int query_tile, int doc_block, int chunk_size,
                             int b) {
    const int window = doc_block * (query_tile + 1);
    const int merge = kWarps * 2 * next_pow2(doc_block);
    region = window > merge ? window : merge;
    carry = kWarps * query_tile;
    carry_doc = kWarps;
    bufs = kStages * 3 * chunk_size;
    s_tb = kStages;
    rows = 7 * b + 2;
  }
  __host__ __device__ size_t words() const {
    return static_cast<size_t>(region) + carry + carry_doc + bufs + s_tb + rows;
  }
};

// Start copying chunk c into the shared buffer [lt | ld | v] at dst and its
// term block id into *tb (the caller commits the copy group).
__device__ __forceinline__ void stage_chunk(int* dst, int* tb, const Params& p,
                                            int c) {
  const long long base = static_cast<long long>(c) * p.chunk_size;
  for (int j = threadIdx.x; j < p.chunk_size; j += kThreads) {
    __pipeline_memcpy_async(dst + j, p.local_term + base + j, sizeof(int));
    __pipeline_memcpy_async(dst + p.chunk_size + j, p.local_doc + base + j,
                            sizeof(int));
    __pipeline_memcpy_async(dst + 2 * p.chunk_size + j, p.value + base + j,
                            sizeof(float));
  }
  if (threadIdx.x == 0) {
    __pipeline_memcpy_async(tb, p.chunk_term_block + c, sizeof(int));
  }
}

// Item t of the step's stream (tile-major, then the demanded blocks' chunk
// runs end to end): its tile, its block's slot j and its chunk id.
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

template <int kQpl>
__global__ void __launch_bounds__(kThreads, 1) bmp_scan_kernel(Params p) {
  constexpr int kQueryTile = 32 * kQpl;
  constexpr int kRowStride = kQueryTile + 1;  // odd: conflict-free columns
  extern __shared__ float smem[];
  const Layout lay(kQueryTile, p.doc_block, p.chunk_size, p.b);
  float* region = smem;
  float* window = region;                                  // [D][kRowStride]
  float* carry = region + lay.region;                      // [kWarps][QT]
  int* carry_doc = reinterpret_cast<int*>(carry + lay.carry);
  int* bufs = carry_doc + lay.carry_doc;
  int* s_tb = bufs + lay.bufs;
  int* s_alive = s_tb + lay.s_tb;                          // [b]
  float* s_tau = reinterpret_cast<float*>(s_alive + p.b);  // [b]
  int* s_blk = reinterpret_cast<int*>(s_tau + p.b);        // [b]
  int* s_cand = s_blk + p.b;                               // [b]
  int* dlist = s_cand + p.b;                               // [b] demanded blocks
  int* dstart = dlist + p.b;                               // [b] their runs
  int* doff = dstart + p.b;                                // [b + 1] prefix
  int* s_nd = doff + p.b + 1;

  const int g = blockIdx.x;
  const int b = p.b, n_db = p.n_db, D = p.doc_block, C = p.chunk_size;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qwt = p.qwt + static_cast<long long>(g) * p.v_pad * p.b_pad;
  const int* order = p.order + static_cast<long long>(g) * b * n_db;
  const float* ubs = p.ub_sorted + static_cast<long long>(g) * b * n_db;
  float* scores = p.scores + static_cast<long long>(g) * b * p.n_pad;
  float* heap = p.heap + static_cast<long long>(g) * b * p.k_eff;
  int* bscored = p.block_scored + static_cast<long long>(g) * n_db;
  int* cscored = p.chunk_scored + static_cast<long long>(g) * p.num_chunks;

  for (int r = threadIdx.x; r < b; r += kThreads) {
    s_alive[r] = 1;
    s_tau[r] = p.tau0[static_cast<long long>(g) * b + r];
  }
  __syncthreads();

  int i = 0;
  for (; i < n_db; ++i) {
    int any = 0;
    for (int r = threadIdx.x; r < b; r += kThreads) any |= s_alive[r];
    if (!__syncthreads_or(any)) break;

    // Retire, then each alive row's fresh (not yet scored) block.
    if (threadIdx.x == 0) *s_nd = 0;
    for (int r = threadIdx.x; r < b; r += kThreads) {
      int a = s_alive[r];
      const long long at = static_cast<long long>(r) * n_db + i;
      if (a) {
        const float tau = s_tau[r];
        const float margin = __fadd_rn(__fmul_rn(1e-4f, fabsf(tau)), 1e-6f);
        a = __fmul_rn(p.theta, ubs[at]) >= __fsub_rn(tau, margin);
        s_alive[r] = a;
      }
      const int blk = order[at];
      s_blk[r] = blk;
      // L2 read: the claims below are atomics, which bypass this SM's L1.
      s_cand[r] = (a && !__ldcg(&bscored[blk])) ? blk : n_db;
    }
    __syncthreads();
    // Dedup: the first row to claim a block lists it (and marks it scored).
    for (int r = threadIdx.x; r < b; r += kThreads) {
      const int c = s_cand[r];
      if (c < n_db && atomicCAS(&bscored[c], 0, 1) == 0) {
        dlist[atomicAdd(s_nd, 1)] = c;
      }
    }
    __syncthreads();
    const int nd = *s_nd;
    if (warp == 0) {  // exclusive prefix of the demanded blocks' run lengths
      int base = 0;
      for (int j0 = 0; j0 < nd; j0 += 32) {
        const int j = j0 + lane;
        const int cnt = j < nd ? p.block_chunk_count[dlist[j]] : 0;
        if (j < nd) dstart[j] = p.block_chunk_start[dlist[j]];
        int incl = cnt;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        if (j < nd) doff[j] = base + incl - cnt;
        base += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) doff[nd] = base;
    }
    __syncthreads();
    const int total = doff[nd];

    if (total > 0) {
      for (int t = threadIdx.x; t < total; t += kThreads) {
        int tile, j, c;
        decode(t, total, doff, dstart, nd, tile, j, c);
        cscored[c] = 1;
      }
      for (int x = threadIdx.x; x < D * kRowStride; x += kThreads) window[x] = 0.f;
      const int n_items = (p.b_pad / kQueryTile) * total;
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_items) {
          int tile, j, c;
          decode(s, total, doff, dstart, nd, tile, j, c);
          stage_chunk(bufs + s * 3 * C, s_tb + s, p, c);
        }
        __pipeline_commit();
      }
      for (int t = 0; t < n_items; ++t) {
        const int slot = t % kStages;
        __pipeline_wait_prior(kStages - 2);
        __syncthreads();
        const int ahead = t + kStages - 1;
        if (ahead < n_items) {
          int tile, j, c;
          decode(ahead, total, doff, dstart, nd, tile, j, c);
          stage_chunk(bufs + (ahead % kStages) * 3 * C, s_tb + ahead % kStages,
                      p, c);
        }
        __pipeline_commit();
        int tile, j, c;
        decode(t, total, doff, dstart, nd, tile, j, c);
        const int q0 = tile * kQueryTile;
        const float* qcol = qwt + q0 + lane;
        const long long row0 = static_cast<long long>(s_tb[slot]) * p.term_block;
        const int* s_lt = bufs + slot * 3 * C;
        const int* s_ld = s_lt + C;
        const float* s_v = reinterpret_cast<const float*>(s_ld + C);

        // The live slots are a prefix of the chunk; split them evenly.
        int n_live = 0;
        for (int hi = C; n_live < hi;) {
          const int mid = (n_live + hi) >> 1;
          if (s_ld[mid] >= 0) n_live = mid + 1; else hi = mid;
        }
        const int per_warp = (n_live + kWarps - 1) / kWarps;
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
            for (int q = 0; q < kQpl; ++q) carry[warp * kQueryTile + lane + 32 * q] = acc[q];
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
            const float* q = qcol + (row0 + (lt >= 0 && lt < p.term_block ? lt : 0)) * p.b_pad;
#pragma unroll
            for (int q2 = 0; q2 < kQpl; ++q2) gw[jj][q2] = pp < slice_end ? __ldg(q + 32 * q2) : 0.f;
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
            const float w = lt >= 0 && lt < p.term_block ? s_v[pp] : 0.f;
#pragma unroll
            for (int q = 0; q < kQpl; ++q) acc[q] = fmaf(gw[jj][q], w, acc[q]);
          }
        }
        if (cur >= 0) flush();
        const bool owns_last = cur >= 0 && !(first_run && continued);
        __syncthreads();
        if (owns_last) {
          float* row = window + cur * kRowStride;
          for (int w = warp + 1; w < kWarps && carry_doc[w] == cur; ++w) {
#pragma unroll
            for (int q = 0; q < kQpl; ++q) row[lane + 32 * q] += carry[w * kQueryTile + lane + 32 * q];
          }
        }
        const int u = t - tile * total;
        if (u + 1 == doff[j + 1]) {  // the block's last chunk in this tile
          __syncthreads();
          const long long col0 = static_cast<long long>(dlist[j]) * D;
          for (int x = threadIdx.x; x < kQueryTile * D; x += kThreads) {
            const int q = x / D;
            const int d = x - q * D;
            if (q0 + q < b) {
              scores[static_cast<long long>(q0 + q) * p.n_pad + col0 + d] =
                  window[d * kRowStride + q];
            }
            window[d * kRowStride + q] = 0.f;
          }
        }
      }
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // the step's scores are written

    // Fold each alive row's window into its heap, one warp a row.
    float* wv = region + warp * 2 * next_pow2(D);
    int* wdest = reinterpret_cast<int*>(wv + next_pow2(D));
    for (int r = warp; r < b; r += kWarps) {
      if (!s_alive[r]) continue;
      float* hrow = heap + static_cast<long long>(r) * p.k_eff;
      const float kth = hrow[p.k_eff - 1];
      const long long base = static_cast<long long>(s_blk[r]) * D;
      const float* srow = scores + static_cast<long long>(r) * p.n_pad + base;
      int m = 0;
      for (int x0 = 0; x0 < D; x0 += 32) {
        const int x = x0 + lane;
        float v = -CUDART_INF_F;
        if (x < D) {
          const long long doc = base + x;
          if (doc < p.num_docs && (p.alive_doc == nullptr || p.alive_doc[doc])) {
            v = srow[x];
          }
        }
        const bool keep = v > kth;
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        if (keep) wv[m + __popc(bal & ((1u << lane) - 1u))] = v;
        m += __popc(bal);
      }
      if (m == 0) continue;
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
          if (hrow[mid] >= v) lo = mid + 1; else hi = mid;
        }
        wdest[x] = x + lo;
      }
      __syncwarp();
      // Heap values below the largest window value move down by the count
      // of window values above them; from the tail, reads before writes.
      const int first_moved = wdest[0];
      for (int hi_i = p.k_eff; hi_i > first_moved; hi_i -= 32) {
        const int x = hi_i - 32 + lane;
        const bool in = x >= first_moved;
        float v = 0.f;
        int dst = p.k_eff;
        if (in) {
          v = hrow[x];
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
      if (lane == 0) s_tau[r] = fmaxf(s_tau[r], hrow[p.k_eff - 1]);
      __syncwarp();
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) p.steps[g] = i;
}

template <int kQpl>
cudaError_t launch(const Params& p, int groups, cudaStream_t stream) {
  const Layout lay(32 * kQpl, p.doc_block, p.chunk_size, p.b);
  const size_t smem = lay.words() * 4;
  cudaError_t err = cudaFuncSetAttribute(
      bmp_scan_kernel<kQpl>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bmp_scan_kernel<kQpl><<<groups, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bmp_scan_launch(
    const float* qwt, const int* order, const float* ub_sorted,
    const float* tau0, const int* block_chunk_start,
    const int* block_chunk_count, const int* chunk_term_block,
    const int* local_term, const int* local_doc, const float* value,
    const unsigned char* alive_doc, float* scores, float* heap,
    int* block_scored, int* chunk_scored, int* steps, int groups, int b,
    int b_pad, long long v_pad, int n_db, int num_chunks, int term_block,
    int doc_block, int chunk_size, int k_eff, float theta, long long num_docs,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p{qwt, order, ub_sorted, tau0, block_chunk_start, block_chunk_count,
           chunk_term_block, local_term, local_doc, value, alive_doc, scores,
           heap, block_scored, chunk_scored, steps, b, b_pad, v_pad, n_db,
           num_chunks, term_block, doc_block, chunk_size, k_eff, theta,
           num_docs, static_cast<long long>(n_db) * doc_block};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 32) {
    if (b_pad % 32 != 0) return cudaErrorInvalidValue;
    return launch<1>(p, groups, s);
  }
  if (b_pad % 128 != 0) return cudaErrorInvalidValue;
  return launch<4>(p, groups, s);
}

extern "C" const char* bmp_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
