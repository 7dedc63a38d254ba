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
// and writes the window once.  No global atomics.
//
// Within a chunk the live postings come first, in ascending local_doc order,
// and the padding (local_doc = -1) after them (the index builder's stable
// sort keeps doc-major order), so each doc's postings form one contiguous
// segment.  The chunk's live slots are split into kWarps equal slices, one
// per warp.  A warp gathers kBatch slots' query weights at once (lane l
// carries queries l, l+32, l+64 and l+96 of the tile), then folds them in
// slot order, one running sum per doc.  A sum whose segment began in the
// slice goes straight into the doc's window row; a sum that continues a
// segment begun in an earlier slice is left in the warp's carry row, and
// after a barrier the warp that holds the segment's head adds the carries
// that follow it, in slice order.  Every row has one writer at a time and
// the order of every sum is fixed, so results repeat bit for bit.  Even
// slices keep every warp busy whether a chunk holds a few long segments
// (the hottest term block has about 60 postings a doc) or is partly empty.
//
// What bounds it: each posting gathers its term's kQueryTile query weights
// (four coalesced 128-byte reads from the term-major QW^T), so the kernel
// moves postings x B x 4 bytes through L2 — about as many bytes as it does
// multiply-adds — against an HBM floor of one read of the chunk stream and
// one write of the scores.  A doc block's ~100 chunks are walked one after
// another, so each chunk's fixed cost (two barriers, the fold) is on the
// critical path; 128 queries a CTA spread it over twice the work of 64, at
// one CTA (32 warps) per SM, since the [256, 129] f32 window takes 132 KB of
// shared memory.  Chunks (and their term block ids) are copied into a ring
// of kStages shared buffers with cp.async, kStages - 1 chunks ahead of the
// one being scored.  Staging hot term blocks of QW^T in shared memory, to
// cut the gather traffic itself, is later work.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQpl = 4;                 // queries per lane
constexpr int kQueryTile = 32 * kQpl;   // queries per CTA
constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kRowStride = kQueryTile + 1;  // odd: conflict-free column reads
constexpr int kBatch = 4;               // slots whose gathers are in flight together
constexpr int kStages = 4;              // chunk buffers in the cp.async ring

// Start copying chunk c into the shared buffer [lt | ld | v] at dst and
// its term block id into *tb (the caller commits the copy group).
__device__ __forceinline__ void stage_chunk(int* dst, int* tb,
                                            const int* local_term,
                                            const int* local_doc,
                                            const float* value,
                                            const int* chunk_term_block, int c,
                                            int chunk_size) {
  const long long base = static_cast<long long>(c) * chunk_size;
  for (int j = threadIdx.x; j < chunk_size; j += kThreads) {
    __pipeline_memcpy_async(dst + j, local_term + base + j, sizeof(int));
    __pipeline_memcpy_async(dst + chunk_size + j, local_doc + base + j, sizeof(int));
    __pipeline_memcpy_async(dst + 2 * chunk_size + j, value + base + j, sizeof(float));
  }
  if (threadIdx.x == 0) {
    __pipeline_memcpy_async(tb, chunk_term_block + c, sizeof(int));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
scatter_score_kernel(const float* __restrict__ qwt,          // [V_pad, b_pad]
                     const int* __restrict__ local_term,     // [n_chunks, C]
                     const int* __restrict__ local_doc,      // [n_chunks, C]
                     const float* __restrict__ value,        // [n_chunks, C]
                     const int* __restrict__ chunk_term_block,   // [n_chunks]
                     const int* __restrict__ block_chunk_start,  // [n_db]
                     const int* __restrict__ block_chunk_count,  // [n_db]
                     float* __restrict__ out,                // [b, n_pad]
                     int b, int b_pad, int term_block, int doc_block,
                     int chunk_size, long long n_pad) {
  extern __shared__ float smem[];
  float* window = smem;                               // [doc_block][kRowStride]
  float* carry = window + doc_block * kRowStride;     // [kWarps][kQueryTile]
  int* carry_doc = reinterpret_cast<int*>(carry + kWarps * kQueryTile);  // [kWarps]
  int* bufs = carry_doc + kWarps;                     // kStages x [3][C]
  int* s_tb = bufs + kStages * 3 * chunk_size;        // kStages

  const int db = blockIdx.x;
  const int q0 = blockIdx.y * kQueryTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < doc_block * kRowStride; i += kThreads) {
    window[i] = 0.f;
  }

  const int c_begin = block_chunk_start[db];
  const int c_end = c_begin + block_chunk_count[db];
  const float* qcol = qwt + q0 + lane;

  // One copy group per chunk, committed even when empty, so that
  // "all but the newest kStages - 2 groups have landed" means "chunk c has".
  for (int s = 0; s < kStages - 1; ++s) {
    if (c_begin + s < c_end) {
      stage_chunk(bufs + s * 3 * chunk_size, s_tb + s, local_term, local_doc,
                  value, chunk_term_block, c_begin + s, chunk_size);
    }
    __pipeline_commit();
  }
  for (int c = c_begin; c < c_end; ++c) {
    const int slot = (c - c_begin) % kStages;
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of chunk c landed
    __syncthreads();  // everyone's have; chunk c-1 is consumed
    const int ahead = c + kStages - 1;
    if (ahead < c_end) {
      const int s = (ahead - c_begin) % kStages;
      stage_chunk(bufs + s * 3 * chunk_size, s_tb + s, local_term, local_doc,
                  value, chunk_term_block, ahead, chunk_size);
    }
    __pipeline_commit();
    const long long row0 = static_cast<long long>(s_tb[slot]) * term_block;
    const int* s_lt = bufs + slot * 3 * chunk_size;
    const int* s_ld = s_lt + chunk_size;
    const float* s_v = reinterpret_cast<const float*>(s_ld + chunk_size);

    // The live slots are a prefix of the chunk; split them evenly.
    int n_live = 0;
    for (int hi = chunk_size; n_live < hi;) {
      const int mid = (n_live + hi) >> 1;
      if (s_ld[mid] >= 0) n_live = mid + 1; else hi = mid;
    }
    const int per_warp = (n_live + kWarps - 1) / kWarps;
    const int slice_begin = min(warp * per_warp, n_live);
    const int slice_end = min(slice_begin + per_warp, n_live);

    // Pass 1: this warp's slice.  `continued`: the slice's first run
    // continues a segment begun before the slice; its sum goes to the
    // warp's carry row, every other run's to its doc's window row.
    const int d0 = slice_begin < slice_end ? s_ld[slice_begin] : -1;
    const bool continued = slice_begin > 0 && d0 >= 0 && d0 < doc_block &&
                           s_ld[slice_begin - 1] == d0;
    if (lane == 0) carry_doc[warp] = -1;
    int cur = -1;
    bool first_run = true;  // cur is the slice's first run
    float acc[kQpl];
    auto flush = [&]() {
      if (first_run && continued) {
#pragma unroll
        for (int r = 0; r < kQpl; ++r) carry[warp * kQueryTile + lane + 32 * r] = acc[r];
        if (lane == 0) carry_doc[warp] = cur;
      } else {
        float* row = window + cur * kRowStride;
#pragma unroll
        for (int r = 0; r < kQpl; ++r) row[lane + 32 * r] += acc[r];
      }
    };
    for (int p0 = slice_begin; p0 < slice_end; p0 += kBatch) {
      float g[kBatch][kQpl];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {  // gathers, all in flight
        const int p = p0 + j;
        const int t = p < slice_end ? s_lt[p] : 0;
        const float* q = qcol + (row0 + (t >= 0 && t < term_block ? t : 0)) * b_pad;
#pragma unroll
        for (int r = 0; r < kQpl; ++r) g[j][r] = p < slice_end ? __ldg(q + 32 * r) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {  // fold in slot order
        const int p = p0 + j;
        if (p >= slice_end) break;
        const int d = s_ld[p];
        const int t = s_lt[p];
        if (d < 0 || d >= doc_block) continue;
        if (d != cur) {
          if (cur >= 0) {
            flush();
            first_run = false;
          }
          cur = d;
#pragma unroll
          for (int r = 0; r < kQpl; ++r) acc[r] = 0.f;
        }
        const float w = t >= 0 && t < term_block ? s_v[p] : 0.f;
#pragma unroll
        for (int r = 0; r < kQpl; ++r) acc[r] = fmaf(g[j][r], w, acc[r]);
      }
    }
    if (cur >= 0) flush();
    const bool owns_last = cur >= 0 && !(first_run && continued);
    __syncthreads();
    // Pass 2: the warp holding a segment's head adds the carries of the
    // slices the segment runs on into, in slice order.
    if (owns_last) {
      float* row = window + cur * kRowStride;
      for (int w = warp + 1; w < kWarps && carry_doc[w] == cur; ++w) {
#pragma unroll
        for (int r = 0; r < kQpl; ++r) row[lane + 32 * r] += carry[w * kQueryTile + lane + 32 * r];
      }
    }
  }
  __syncthreads();

  const long long col0 = static_cast<long long>(db) * doc_block;
  for (int i = threadIdx.x; i < kQueryTile * doc_block; i += kThreads) {
    const int q = i / doc_block;
    const int d = i - q * doc_block;
    if (q0 + q < b) {
      out[static_cast<long long>(q0 + q) * n_pad + col0 + d] =
          window[d * kRowStride + q];
    }
  }
}

}  // namespace

extern "C" int scatter_score_launch(const float* qwt, const int* local_term,
                                    const int* local_doc, const float* value,
                                    const int* chunk_term_block,
                                    const int* block_chunk_start,
                                    const int* block_chunk_count, float* out,
                                    int b, int b_pad, int n_db, int term_block,
                                    int doc_block, int chunk_size,
                                    long long n_pad, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b_pad % kQueryTile != 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(doc_block) * kRowStride * sizeof(float) +
                      static_cast<size_t>(kWarps) * (kQueryTile + 1) * sizeof(float) +
                      (static_cast<size_t>(chunk_size) * 3 + 1) * kStages * sizeof(int);
  err = cudaFuncSetAttribute(scatter_score_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_db, b_pad / kQueryTile);
  scatter_score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      qwt, local_term, local_doc, value, chunk_term_block, block_chunk_start,
      block_chunk_count, out, b, b_pad, term_block, doc_block, chunk_size, n_pad);
  return cudaGetLastError();
}

extern "C" const char* scatter_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
