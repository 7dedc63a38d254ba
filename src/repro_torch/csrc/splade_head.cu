// Fused SPLADE-max encoding head, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro.kernels.splade_head.kernel
// .splade_head_kernel (src/repro/kernels/splade_head/kernel.py:46).  It
// computes
//
//     out[b, v] = max_t mask[b, t] * log1p(relu(h[b, t, :] . W[:, v] + bias[v]))
//
// over the T tokens of each of the B inputs, without writing the [B, T, V]
// logits anywhere.  The TPU kernel walks a (batch, vocab block, token chunk)
// grid whose last axis runs in order on one core, carrying the running max
// in the output window.  Here one CTA owns one input b and kVocTile vocab
// columns: it loops over the input's tokens kTokTile at a time, runs the
// [kTokTile, d] x [d, kVocTile] product for each, applies the epilogue
// (+ bias, relu, log1pf, x mask) and folds the tile's rows into a running
// column max held in registers.  After the last token tile the CTA's eight
// row groups are max-reduced through shared memory and out[b, tile] is
// written once: no atomics.  The max is exact and order-free, so only the
// d-long dot products are summed in another order than the plain version's.
// Tokens past T and columns past V are masked here, so nothing is padded.
//
// The product is a plain SIMT SGEMM: 256 threads, each accumulating an 8 x 8
// block (rows ty*4+{0..3} and 32+ty*4+{0..3}, columns tx*4+{0..3} and
// 128+tx*4+{0..3}, so that every shared-memory read is a broadcast or a
// conflict-free float4), K staged through shared memory kK at a time in a
// ring of kStages buffers filled with cp.async kStages - 1 stages ahead
// (4-byte copies, zero-filled past the edges; h is stored transposed), one
// barrier a stage.  Registers are capped at 128 so that two CTAs share an
// SM and cover each other's barriers (the first version, 16 deep in two
// buffers at one CTA an SM and 195 registers, was slower: PERF.md).  W is
// read through its strides: the tied head embed.T ([d, V] with stride
// (1, d)) and a contiguous [d, V] both work, each with its own coalesced
// copy pattern.  CTAs are rastered in groups of
// kGroup vocab tiles x all B inputs, so the CTAs resident together share a
// few W tiles in L2 and W is read from HBM about once.
//
// What bounds it: 2 x (valid tokens) x d V f32 operations.  A token of mask
// 0 adds an exact 0 to a max of non-negative terms, so the function needs
// no product for it; chip_smoke.py counts the valid tokens of its run.  With
// every token valid, B = 500 queries x T = 64 tokens, d = 768, V = 30,522
// is 1.50e12 operations, 22.4 ms at the 67 TFLOP/s of f32 outside the
// tensor cores, against ~0.08 ms for the bytes (h 98 MB, W 94 MB, out 61
// MB): it is bound by operations.  This kernel still runs the product for
// every token row below T, masked or not, so on padded queries it does
// more work than the bound counts: skipping or compacting masked rows is
// one lever, a wgmma (TF32 or bf16) route another, which is a precision
// question, since the reference is f32.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTokTile = 64;           // token rows per product tile
constexpr int kVocTile = 256;          // vocab columns per CTA
constexpr int kK = 8;                  // depth of one shared-memory stage
constexpr int kStages = 4;             // stages in the cp.async ring
constexpr int kTokPad = kTokTile + 4;  // row strides stay 16-byte multiples
constexpr int kVocPad = kVocTile + 4;
constexpr int kGroup = 8;              // vocab tiles per raster group

__device__ __forceinline__ int tile_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 32 + ty * 4 + (i - 4);
}

__device__ __forceinline__ int tile_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : 128 + tx * 4 + (j - 4);
}

// Start copying h[t0 : t0+kTokTile, k0 : k0+kK] of one input into hs
// (transposed, [kK][kTokPad]) and W[k0 : k0+kK, v0 : v0+kVocTile] into ws
// ([kK][kVocPad]); zeros past T, d and V.  The caller commits the group.
template <bool kWKMajor>
__device__ __forceinline__ void stage(float (*hs)[kTokPad],
                                      float (*ws)[kVocPad],
                                      const float* hq, const float* w,
                                      int t0, int k0, int v0, int t_len,
                                      int d, int vocab, long long sw_d,
                                      long long sw_v) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kTokTile * kK / kThreads; ++r) {
    const int e = tid + r * kThreads;
    const int kk = e % kK;
    const int i = e / kK;
    const int t = t0 + i;
    const int k = k0 + kk;
    const bool in = t < t_len && k < d;
    const float* src = in ? hq + static_cast<long long>(t) * d + k : hq;
    __pipeline_memcpy_async(&hs[kk][i], src, sizeof(float),
                            in ? 0 : sizeof(float));
  }
#pragma unroll
  for (int r = 0; r < kVocTile * kK / kThreads; ++r) {
    const int e = tid + r * kThreads;
    // K-major W (stride 1 along d): neighbouring threads read neighbouring
    // k of one column; otherwise neighbouring columns of one k.
    const int kk = kWKMajor ? e % kK : e / kVocTile;
    const int j = kWKMajor ? e / kK : e % kVocTile;
    const int k = k0 + kk;
    const int v = v0 + j;
    const bool in = k < d && v < vocab;
    const float* src = in ? w + k * sw_d + v * sw_v : w;
    __pipeline_memcpy_async(&ws[kk][j], src, sizeof(float),
                            in ? 0 : sizeof(float));
  }
}

template <bool kWKMajor>
__global__ void __launch_bounds__(kThreads, 2)
splade_head_kernel(const float* __restrict__ h,     // [bsz, t_len, d]
                   const float* __restrict__ mask,  // [bsz, t_len]
                   const float* __restrict__ w,     // [d, vocab], strided
                   const float* __restrict__ bias,  // [vocab]
                   float* __restrict__ out,         // [bsz, vocab]
                   int bsz, int t_len, int d, int vocab, long long sw_d,
                   long long sw_v) {
  __shared__ __align__(16) float hs[kStages][kK][kTokPad];
  __shared__ __align__(16) float ws[kStages][kK][kVocPad];

  // Raster: groups of kGroup vocab tiles; within a group, input-major.
  const int v_tiles = (vocab + kVocTile - 1) / kVocTile;
  const long long per_group = static_cast<long long>(kGroup) * bsz;
  const int group = static_cast<int>(blockIdx.x / per_group);
  const int within = static_cast<int>(blockIdx.x % per_group);
  const int width = min(kGroup, v_tiles - group * kGroup);
  const int q = within / width;
  const int v0 = (group * kGroup + within % width) * kVocTile;

  const int tx = threadIdx.x & 31;  // column group
  const int ty = threadIdx.x >> 5;  // row group (one per warp)
  const float* hq = h + static_cast<long long>(q) * t_len * d;
  const float* mq = mask + static_cast<long long>(q) * t_len;

  float bcol[8], colmax[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int v = v0 + tile_col(tx, j);
    bcol[j] = v < vocab ? bias[v] : 0.f;
    colmax[j] = -INFINITY;
  }
  const int k_tiles = (d + kK - 1) / kK;

  for (int t0 = 0; t0 < t_len; t0 += kTokTile) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();  // the previous token tile's last stages are read
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < k_tiles) {
        stage<kWKMajor>(hs[s], ws[s], hq, w, t0, s * kK, v0, t_len, d, vocab,
                        sw_d, sw_v);
      }
      __pipeline_commit();
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int cur = kt % kStages;
      __pipeline_wait_prior(kStages - 2);
      __syncthreads();  // stage kt landed; stage kt - 1's slot is free
      const int nk = kt + kStages - 1;
      if (nk < k_tiles) {
        stage<kWKMajor>(hs[nk % kStages], ws[nk % kStages], hq, w, t0,
                        nk * kK, v0, t_len, d, vocab, sw_d, sw_v);
      }
      // One group per stage, committed even when empty, so that "all but
      // the newest kStages - 2 groups have landed" means "stage kt has".
      __pipeline_commit();
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&hs[cur][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&hs[cur][kk][32 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[cur][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ws[cur][kk][128 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + tile_row(ty, i);
      if (t < t_len) {
        const float m = mq[t];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float act = log1pf(fmaxf(acc[i][j] + bcol[j], 0.f)) * m;
          colmax[j] = fmaxf(colmax[j], act);
        }
      }
    }
  }

  // The eight row groups' maxima, reduced through ws once every thread is
  // done reading it.
  __syncthreads();
  float* red = &ws[0][0][0];  // [8][kVocTile]
#pragma unroll
  for (int j = 0; j < 8; ++j) red[ty * kVocTile + tile_col(tx, j)] = colmax[j];
  __syncthreads();
  const int v = v0 + static_cast<int>(threadIdx.x);
  if (v < vocab) {
    float m = red[threadIdx.x];
#pragma unroll
    for (int r = 1; r < kThreads / 32; ++r) {
      m = fmaxf(m, red[r * kVocTile + threadIdx.x]);
    }
    out[static_cast<long long>(q) * vocab + v] = m;
  }
}

}  // namespace

extern "C" int splade_head_launch(const float* h, const float* mask,
                                  const float* w, const float* bias,
                                  float* out, int bsz, int t_len, int d,
                                  int vocab, long long sw_d, long long sw_v,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bsz <= 0 || t_len <= 0 || d <= 0 || vocab <= 0) {
    return cudaErrorInvalidValue;
  }
  const long long v_tiles = (vocab + kVocTile - 1) / kVocTile;
  const dim3 grid(static_cast<unsigned>(v_tiles * bsz));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sw_d == 1) {
    splade_head_kernel<true><<<grid, kThreads, 0, s>>>(
        h, mask, w, bias, out, bsz, t_len, d, vocab, sw_d, sw_v);
  } else {
    splade_head_kernel<false><<<grid, kThreads, 0, s>>>(
        h, mask, w, bias, out, bsz, t_len, d, vocab, sw_d, sw_v);
  }
  return cudaGetLastError();
}

extern "C" const char* splade_head_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
