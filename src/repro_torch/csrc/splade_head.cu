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
// in the output window.  Here one CTA owns kG = 2 inputs and kVocTile = 128
// vocab columns, and writes out[b, tile] of both once: no atomics.
//
// What bounds it: the product, 2 x (valid tokens) x d V operations in f32.
// A token of mask 0 adds an exact 0 (0 x a finite value) to the max, so it
// needs no product: on the encode path (B = 500, T = 64, 17,233 valid rows,
// d = 768, V = 30,522) that is 8.08e11 operations, 12.058 ms at the 67
// TFLOP/s of f32 outside the tensor cores, against ~0.2 GB of h, W and out
// (0.07 ms at 3.35 TB/s).  Kept exact to f32 on the tensor cores (3xTF32,
// below) it is 3 x 8.08e11 = 2.42e12 operations, 4.896 ms at the 495
// TFLOP/s of TF32: that is the least time the card could take.  mma.sync
// reaches about 320 TFLOP/s of TF32 on an H100 (PERF.md), and each CTA
// streams its W tile from L2 once for its kG inputs.
//
// The design:
// * Masked rows are skipped.  At its start each CTA compacts the token rows
//   of its inputs with mask != 0 into one index list in shared memory (one
//   warp, a ballot per 32 tokens, so the list keeps order), and runs the
//   product over those rows only, in chunks of up to 64 kG rows, padded to
//   a multiple of 8 with zero rows that the epilogue skips.  Each input's
//   running max starts at 0 where it has a masked row (its exact
//   contribution) and at -inf where it has none; the max is exact and
//   independent of order.
// * The product runs on the tensor cores in 3xTF32:
//   mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  Each f32 operand x is split
//   in registers into x_big = tf32(x) and x_small = tf32(x - x_big) (the
//   difference is exact in f32; hopper.cuh), and each product is summed in
//   f32 as a_small b_big + a_big b_small + a_big b_big: about 2^-21 of each
//   product's magnitude is lost, against 2^-24 for f32 (a single TF32 pass
//   keeps about 3 decimal digits).  The tensor cores round their f32 sums
//   toward zero, a bias that 3 x d / 8 = 288 mmas into one accumulator
//   would pile up to several times the f32 error, so each stage's 12 mmas
//   sum into a partial from 0, added to the running sum in f32 (1.26e-6 of
//   max |plain| on the encode path, PERF.md).
//   mma.sync and not wgmma: the split has to exist in the operands' storage
//   for wgmma (a TF32 wgmma reads the top 19 bits of each f32 word in shared
//   memory), and TF32 wgmma takes both operands K-major, which a contiguous
//   W is not; mma.sync takes both from registers, where the split costs a
//   few instructions and either W layout works.
// * The product is computed transposed, logits^T [vocab x tokens] = W^T h^T,
//   so the valid rows fill n8 tiles (padding to 8, not 16).  256 threads, 8
//   warps side by side over the 128 vocab rows (one m16 tile each: A = W^T,
//   split once, as no other warp reads it), each warp over every token row
//   of the chunk (B = h^T, each warp splitting the fragments it reads).  The
//   chunk's count of n8 tiles is a template parameter (1 .. 8 kG), so no
//   tile is guarded.  h and W are staged through shared memory kK = 32 deep
//   in a ring of kStages buffers filled with cp.async kStages - 1 stages
//   ahead (16-byte copies where h, W and their strides allow it, else a
//   4-byte fallback that runs every tile), zero past d, V and the valid
//   rows; the row pitches (+4 floats, +8 for W [k][v]) make every fragment
//   read conflict-free.  W is read through its strides: the tied head
//   embed.T ([d, V] with stride (1, d), staged [v][k]) and a contiguous
//   [d, V] (staged [k][v]).  254 registers a thread: one CTA an SM.
// * The epilogue (+ bias, relu, log1pf, x mask, running max of each input)
//   folds each chunk in, reduced across the 4 lanes of a quad at the end.
//   CTAs are rastered in groups of kGroup vocab tiles x all inputs, so the
//   CTAs resident together share a few W tiles in L2 and W is read from HBM
//   about once.
//
// Measured (chip_smoke.py phase 4, NVIDIA H100 80GB HBM3 at 700 W, the
// encode path's inputs, PERF.md section 6): the first version (PR 13, a
// SIMT SGEMM over every row below T, 256-column tiles of one input) 55.225
// ms, its retune 49.359 ms; this design 23.780 ms (4.9x its bound; the f32
// torch.matmul of the product alone 29.621 ms).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kG = 2;                 // inputs a CTA serves
constexpr int kVocTile = kWarps * 16; // vocab rows per CTA, one m16 a warp
constexpr int kRows = 64 * kG;        // token rows per product chunk
constexpr int kK = 32;                // depth of one shared-memory stage
constexpr int kStages = 3;            // stages in the cp.async ring
constexpr int kHPitch = kK + 4;       // h: [kRows][kHPitch]
constexpr int kWPitchV = kVocTile + 8;  // contiguous W: [kK][kWPitchV]
constexpr int kWPitchK = kK + 4;        // embed.T W: [kVocTile][kWPitchK]
constexpr int kHStage = kRows * kHPitch;
constexpr int kWStage = kVocTile * kWPitchK > kK * kWPitchV
                            ? kVocTile * kWPitchK : kK * kWPitchV;
constexpr int kGroup = 8;             // vocab tiles per raster group

// Start copying the h rows named by idx[0 : kRows] (global rows b T + t;
// zeros past n_rows), columns [k0, k0 + kK), and W[k0 : k0+kK, v0 :
// v0+kVocTile] into one stage; zeros past d and V.  kVec: 16-byte copies
// (every row start 16-byte aligned, d and the vector dimension of W
// multiples of 4).  The caller commits the group.
template <bool kWKMajor, bool kVec>
__device__ __forceinline__ void stage(float* hs, float* ws,
                                      const float* __restrict__ h,
                                      const int* idx, int n_rows,
                                      const float* __restrict__ w, int k0,
                                      int v0, int d, int vocab, long long sw_d,
                                      long long sw_v) {
  const int tid = static_cast<int>(threadIdx.x);
  constexpr int kW = kVec ? 4 : 1;  // floats a copy
  constexpr int kBytes = kW * 4;
#pragma unroll
  for (int r = 0; r < kRows * kK / kW / kThreads; ++r) {
    const int e = tid + r * kThreads;
    const int row = e / (kK / kW);
    const int c = (e % (kK / kW)) * kW;
    const bool in = row < n_rows && k0 + c < d;
    const float* src =
        in ? h + static_cast<long long>(idx[row]) * d + k0 + c : h;
    __pipeline_memcpy_async(hs + row * kHPitch + c, src, kBytes,
                            in ? 0 : kBytes);
  }
#pragma unroll
  for (int r = 0; r < kVocTile * kK / kW / kThreads; ++r) {
    const int e = tid + r * kThreads;
    if constexpr (kWKMajor) {  // neighbouring threads along d of a column
      const int col = e / (kK / kW);
      const int c = (e % (kK / kW)) * kW;
      const int k = k0 + c, v = v0 + col;
      const bool in = k < d && v < vocab;
      const float* src = in ? w + k + v * sw_v : w;
      __pipeline_memcpy_async(ws + col * kWPitchK + c, src, kBytes,
                              in ? 0 : kBytes);
    } else {  // neighbouring threads along V of a row of W (stride sw_v)
      const int kk = e / (kVocTile / kW);
      const int c = (e % (kVocTile / kW)) * kW;
      const int k = k0 + kk, v = v0 + c;
      const bool in = k < d && v < vocab;
      const float* src = in ? w + k * sw_d + v * sw_v : w;
      __pipeline_memcpy_async(ws + kk * kWPitchV + c, src, kBytes,
                              in ? 0 : kBytes);
    }
  }
}

// One chunk of up to kRows valid token rows, NT n8 tiles of them, against
// the CTA's vocab tile, folded into the running max of this thread's vocab
// rows for the input each row belongs to.  Warp w owns vocab rows 16 w ..
// 16 w + 15; accumulator e of n8 tile nt holds vocab row g + 8 (e >> 1)
// and token row 8 nt + 2 t4 + (e & 1) (g = lane / 4, t4 = lane % 4).
template <bool kWKMajor, bool kVec, int NT>
__device__ __forceinline__ void chunk(
    float* hs, float* ws, const float* __restrict__ h, const int* idx,
    const float* mval, int n_rows, int q0, int t_len,
    const float* __restrict__ w, int v0, int d, int vocab, long long sw_d,
    long long sw_v, const float (&brow)[2], float (&rowmax)[kG][2]) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wrow = static_cast<int>(threadIdx.x) / 32 * 16;
  const int k_tiles = (d + kK - 1) / kK;
  float acc[NT][4], part[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  __syncthreads();  // the previous chunk's last stages are read
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) {
      stage<kWKMajor, kVec>(hs + s * kHStage, ws + s * kWStage, h, idx,
                            n_rows, w, s * kK, v0, d, vocab, sw_d, sw_v);
    }
    __pipeline_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt % kStages;
    const float* hc = hs + cur * kHStage;
    const float* wc = ws + cur * kWStage;
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();  // stage kt landed; stage kt - 1's slot is free
    const int nk = kt + kStages - 1;
    if (nk < k_tiles) {
      const int ns = nk % kStages;
      stage<kWKMajor, kVec>(hs + ns * kHStage, ws + ns * kWStage, h, idx,
                            n_rows, w, nk * kK, v0, d, vocab, sw_d, sw_v);
    }
    // One group per stage, committed even when empty, so that "all but
    // the newest kStages - 2 groups have landed" means "stage kt has".
    __pipeline_commit();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
    }
#pragma unroll
    for (int k8 = 0; k8 < kK; k8 += 8) {
      // A: W^T (vocab row g + 8 (i & 1), k t4 + 4 (i >> 1)).
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wrow + g + 8 * (i & 1);
        const int k = k8 + t4 + 4 * (i >> 1);
        split_tf32(kWKMajor ? wc[m * kWPitchK + k] : wc[k * kWPitchV + m],
                   a_big[i], a_small[i]);
      }
      // B: h^T (k t4 + 4 i, token row g of tile nt).
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b_big[2], b_small[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          split_tf32(hc[(nt * 8 + g) * kHPitch + k8 + t4 + 4 * i], b_big[i],
                     b_small[i]);
        }
        mma_tf32(part[nt], a_small, b_big);
        mma_tf32(part[nt], a_big, b_small);
        mma_tf32(part[nt], a_big, b_big);
      }
    }
    // The stage's products, summed apart from 0, join the running sum in
    // f32 (round to nearest): the tensor cores' own rounding sees
    // stage-sized magnitudes only.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = nt * 8 + 2 * t4 + (e & 1);
      if (row < n_rows) {
        const float act =
            log1pf(fmaxf(acc[nt][e] + brow[e >> 1], 0.f)) * mval[row];
        const int j = idx[row] / t_len - q0;
#pragma unroll
        for (int jj = 0; jj < kG; ++jj) {
          if (j == jj) rowmax[jj][e >> 1] = fmaxf(rowmax[jj][e >> 1], act);
        }
      }
    }
  }
}

// chunk<NT> for the chunk's count nt of n8 tiles (1 .. kRows / 8).
template <bool kWKMajor, bool kVec, int NT = 1>
__device__ __forceinline__ void chunk_of(
    int nt, float* hs, float* ws, const float* __restrict__ h,
    const int* idx, const float* mval, int n_rows, int q0, int t_len,
    const float* __restrict__ w, int v0, int d, int vocab, long long sw_d,
    long long sw_v, const float (&brow)[2], float (&rowmax)[kG][2]) {
  if constexpr (NT <= kRows / 8) {
    if (nt == NT) {
      chunk<kWKMajor, kVec, NT>(hs, ws, h, idx, mval, n_rows, q0, t_len, w,
                                v0, d, vocab, sw_d, sw_v, brow, rowmax);
    } else {
      chunk_of<kWKMajor, kVec, NT + 1>(nt, hs, ws, h, idx, mval, n_rows, q0,
                                       t_len, w, v0, d, vocab, sw_d, sw_v,
                                       brow, rowmax);
    }
  }
}

template <bool kWKMajor, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
splade_head_kernel(const float* __restrict__ h,     // [bsz, t_len, d]
                   const float* __restrict__ mask,  // [bsz, t_len]
                   const float* __restrict__ w,     // [d, vocab], strided
                   const float* __restrict__ bias,  // [vocab]
                   float* __restrict__ out,         // [bsz, vocab]
                   int bsz, int t_len, int d, int vocab, long long sw_d,
                   long long sw_v) {
  extern __shared__ float4 smem4[];
  const int t_pad = (kG * t_len + 3) & ~3;
  int* idx = reinterpret_cast<int*>(smem4);  // valid rows, b T + t
  float* mval = reinterpret_cast<float*>(idx + t_pad);  // their masks
  float* hs = mval + t_pad;                             // [kStages][kHStage]
  float* ws = hs + kStages * kHStage;                   // [kStages][kWStage]
  __shared__ int n_valid_s, masked_s[kG];

  // Raster: groups of kGroup vocab tiles; within a group, input-major.
  const int v_tiles = (vocab + kVocTile - 1) / kVocTile;
  const int n_sets = (bsz + kG - 1) / kG;
  const long long per_group = static_cast<long long>(kGroup) * n_sets;
  const int group = static_cast<int>(blockIdx.x / per_group);
  const int within = static_cast<int>(blockIdx.x % per_group);
  const int width = min(kGroup, v_tiles - group * kGroup);
  const int q0 = (within / width) * kG;  // the CTA's first input
  const int v0 = (group * kGroup + within % width) * kVocTile;
  const int nq = min(kG, bsz - q0);      // its inputs

  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wrow = static_cast<int>(threadIdx.x) / 32 * 16;

  // The valid tokens of the CTA's inputs, in order, as one list.
  if (threadIdx.x < 32) {
    const float* m0 = mask + static_cast<long long>(q0) * t_len;
    int n = 0;
    bool masked[kG] = {};
    for (int t0 = 0; t0 < nq * t_len; t0 += 32) {
      const int t = t0 + lane;
      const float mv = t < nq * t_len ? m0[t] : 0.f;
      const bool keep = mv != 0.f;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int pos = n + __popc(ballot & ((1u << lane) - 1u));
        idx[pos] = q0 * t_len + t;
        mval[pos] = mv;
      }
      n += __popc(ballot);
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        masked[j] |= __any_sync(0xffffffffu, !keep && t >= j * t_len &&
                                                 t < (j + 1) * t_len &&
                                                 j < nq);
      }
    }
    if (lane == 0) {
      n_valid_s = n;
#pragma unroll
      for (int j = 0; j < kG; ++j) masked_s[j] = masked[j];
    }
  }
  __syncthreads();
  const int n_valid = n_valid_s;

  // This thread's vocab rows: v0 + wrow + g + 8 i.  Each input's running
  // max starts at 0 where it has a masked token (its exact term).
  float brow[2], rowmax[kG][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = v0 + wrow + g + 8 * i;
    brow[i] = v < vocab ? bias[v] : 0.f;
#pragma unroll
    for (int j = 0; j < kG; ++j) rowmax[j][i] = masked_s[j] ? 0.f : -INFINITY;
  }

  for (int row0 = 0; row0 < n_valid; row0 += kRows) {
    const int n_rows = min(kRows, n_valid - row0);
    if constexpr (kVec) {
      chunk_of<kWKMajor, kVec>((n_rows + 7) / 8, hs, ws, h, idx + row0,
                               mval + row0, n_rows, q0, t_len, w, v0, d,
                               vocab, sw_d, sw_v, brow, rowmax);
    } else {  // the 4-byte-copy fallback: one body, every tile
      chunk<kWKMajor, kVec, kRows / 8>(hs, ws, h, idx + row0, mval + row0,
                                       n_rows, q0, t_len, w, v0, d, vocab,
                                       sw_d, sw_v, brow, rowmax);
    }
  }

  // Across the 4 lanes of a quad (the same vocab rows, other tokens).
#pragma unroll
  for (int j = 0; j < kG; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = rowmax[j][i];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const int v = v0 + wrow + g + 8 * i;
      if (t4 == 0 && j < nq && v < vocab) {
        out[static_cast<long long>(q0 + j) * vocab + v] = x;
      }
    }
  }
}

template <bool kWKMajor, bool kVec>
cudaError_t launch(const float* h, const float* mask, const float* w,
                   const float* bias, float* out, int bsz, int t_len, int d,
                   int vocab, long long sw_d, long long sw_v,
                   cudaStream_t stream) {
  const int t_pad = (kG * t_len + 3) & ~3;
  const size_t smem =
      (2 * static_cast<size_t>(t_pad) + kStages * (kHStage + kWStage)) *
      sizeof(float);
  auto kern = splade_head_kernel<kWKMajor, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long v_tiles = (vocab + kVocTile - 1) / kVocTile;
  const long long n_sets = (bsz + kG - 1) / kG;
  const dim3 grid(static_cast<unsigned>(v_tiles * n_sets));
  kern<<<grid, kThreads, smem, stream>>>(h, mask, w, bias, out, bsz, t_len, d,
                                         vocab, sw_d, sw_v);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool k_major = sw_d == 1;
  // 16-byte copies: h rows (d floats apart) and W's runs of 4 floats along
  // its unit-stride dimension start 16-byte aligned and stay in bounds.
  const bool vec = aligned16(h) && aligned16(w) && d % 4 == 0 &&
                   (k_major ? sw_v % 4 == 0
                            : sw_d % 4 == 0 && vocab % 4 == 0 && sw_v == 1);
  if (k_major) {
    return vec ? launch<true, true>(h, mask, w, bias, out, bsz, t_len, d,
                                    vocab, sw_d, sw_v, s)
               : launch<true, false>(h, mask, w, bias, out, bsz, t_len, d,
                                     vocab, sw_d, sw_v, s);
  }
  return vec ? launch<false, true>(h, mask, w, bias, out, bsz, t_len, d,
                                   vocab, sw_d, sw_v, s)
             : launch<false, false>(h, mask, w, bias, out, bsz, t_len, d,
                                    vocab, sw_d, sw_v, s);
}

extern "C" const char* splade_head_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
