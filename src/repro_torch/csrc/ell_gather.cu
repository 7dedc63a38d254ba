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
// needed.  Each warp scores kDocsPerWarp docs: it reads a doc's slots 32 at
// a time (one coalesced load of terms and of values), skips a batch that
// holds no live slot, and broadcasts each slot to the lanes, which carry
// queries l and l+32 of the tile and sum the slots in order.  The tile of
// scores goes through shared memory so that the [B, N] output is written in
// coalesced rows.
//
// What bounds it: every (doc, slot) gathers a term's row of QW^T, so the
// kernel moves postings x B x 4 bytes through L2.  At B = 500 QW^T is 61 MB,
// more than the 50 MB L2, so gathers also reach HBM; the kernel is far from
// its HBM floor (one read of the ELL stream, one write of the scores).
// Padding slots in a batch that also holds live slots are gathered with
// weight 0 (a fixed-trip inner loop keeps several gathers in flight);
// batches of padding only are skipped.
#include <cuda_runtime.h>

namespace {

constexpr int kQueryTile = 64;  // queries per CTA (2 per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDocsPerWarp = 4;
constexpr int kDocTile = kWarps * kDocsPerWarp;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
ell_gather_kernel(const float* __restrict__ qwt,    // [vocab, b_pad]
                  const int* __restrict__ terms,    // [n_pad, k]
                  const float* __restrict__ values, // [n_pad, k]
                  float* __restrict__ out,          // [b, n_pad]
                  int b, int b_pad, int vocab, long long n_pad, int k) {
  __shared__ float tile[kDocTile][kQueryTile + 1];
  const long long n0 = static_cast<long long>(blockIdx.x) * kDocTile;
  const int q0 = blockIdx.y * kQueryTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qcol = qwt + q0 + lane;

  for (int r = 0; r < kDocsPerWarp; ++r) {
    const int dl = warp * kDocsPerWarp + r;
    const long long n = n0 + dl;
    float acc0 = 0.f, acc1 = 0.f;
    if (n < n_pad) {
      const int* trow = terms + n * k;
      const float* vrow = values + n * k;
      for (int s = 0; s < k; s += 32) {
        int t = -1;
        float v = 0.f;
        if (s + lane < k) {
          t = trow[s + lane];
          v = vrow[s + lane];
        }
        const bool live = t >= 0 && t < vocab;
        if (__ballot_sync(kFull, live) == 0u) continue;
        const int t_safe = live ? t : 0;
        const float w = live ? v : 0.f;
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          const int tj = __shfl_sync(kFull, t_safe, j);
          const float wj = __shfl_sync(kFull, w, j);
          const float* q = qcol + static_cast<long long>(tj) * b_pad;
          acc0 = fmaf(__ldg(q), wj, acc0);
          acc1 = fmaf(__ldg(q + 32), wj, acc1);
        }
      }
    }
    tile[dl][lane] = acc0;
    tile[dl][lane + 32] = acc1;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kQueryTile * kDocTile; i += kThreads) {
    const int q = i / kDocTile;
    const int d = i % kDocTile;
    if (q0 + q < b && n0 + d < n_pad) {
      out[static_cast<long long>(q0 + q) * n_pad + n0 + d] = tile[d][q];
    }
  }
}

}  // namespace

extern "C" int ell_gather_launch(const float* qwt, const int* terms,
                                 const float* values, float* out, int b,
                                 int b_pad, int vocab, long long n_pad, int k,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b_pad % kQueryTile != 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((n_pad + kDocTile - 1) / kDocTile),
                  b_pad / kQueryTile);
  ell_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      qwt, terms, values, out, b, b_pad, vocab, n_pad, k);
  return cudaGetLastError();
}

extern "C" const char* ell_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
