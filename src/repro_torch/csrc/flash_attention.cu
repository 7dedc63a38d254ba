// Flash-attention forward (causal / windowed GQA, online softmax), for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro.kernels.flash_attention.kernel
// .flash_attention_kernel (src/repro/kernels/flash_attention/kernel.py:110).
// It computes, for every batch b, query head h and query position i,
//
//     out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h', :] / sqrt(Dh)) v[b, j, h', :]
//
// over the keys j with j <= i (when causal) and i - j < window (when a
// window is given), h' = h / (Hq / Hkv) the kv head of h's group; a row
// with no visible key gives 0, and the softmax sum is clamped at 1e-20.
// Positions count from 0 in q and in k/v, as in the Pallas kernel.  The
// layout is the JAX wrapper's, q [B, Sq, Hq, Dh] and k/v [B, Skv, Hkv, Dh],
// read through their strides; the output is written [B, Sq, Hq, Dh]
// directly; the ragged S edges are masked here, so nothing is padded.
//
// The TPU kernel walks a (batch x head, q block, kv block) grid whose last
// axis runs in order on one core, carrying (m, l, acc) in VMEM scratch, and
// skips a fully masked kv block with pl.when.  Here that axis is a loop
// inside the CTA over the kv tiles its rows can see, from the window's lower
// edge to the causal diagonal, so a hidden tile costs nothing; the heaviest
// (last) query tiles are launched first, so the causal tail is short.  No
// atomics and a fixed order: both routes are deterministic.
//
// What bounds it: the causal product is 4 B Hq Dh x (visible query-key
// pairs) operations (q k^T and p v).  At the LM prefill's [1, 32768, 14,
// 64] bf16 that is 1.924e12 a layer, 1.946 ms at the 989 TFLOP/s of bf16
// on the tensor cores, against ~134 MB of q, k, v and o (0.04 ms at 3.35
// TB/s): it is bound by operations.
//
// Two routes, chosen by dtype, neither falling back to the other:
//
// * bf16 (the LM prefill): a warp-specialised wgmma kernel in the shape of
//   FlashAttention-3.  One CTA of 384 threads owns one (batch x query head,
//   128-row query tile).  Warpgroup 0 is the producer: one thread issues TMA
//   loads (4-D tensor maps over (Dh, H, S, B), 128-byte swizzle, completion
//   on mbarriers) of the q tile once and of the k and v tiles (128 keys at
//   Dh 64, 64 keys at Dh 128, where the accumulator takes 64 registers) into
//   a ring of two stages.  Warpgroups 1 and 2 are consumers of 64 query rows
//   each: s = q k^T by wgmma m64nNk16 (bf16 -> f32, both operands from
//   shared memory, K-major), the online softmax in registers on the wgmma
//   accumulator layout (each row's max and sum across the 4 lanes of a quad),
//   then o += p v by wgmma with p from registers (the accumulator layout
//   is the A-fragment layout) and v from shared memory read MN-major with
//   the transpose bit.  The two consumers interleave on the tensor cores.
//   TMA fills keys past Skv with zeros, which would give logit 0, so they
//   are masked to -inf with the causal and window masks (only on the tiles
//   that need it).
//
//   Precision, decided here: q k^T of bf16 inputs is exact per product with
//   an f32 sum, as the Pallas kernel's (after astype(f32)); logits, p, m, l
//   and the accumulator are f32, as in chunked_attention and
//   flash_attention_ref.  The Pallas kernel rounds p once to bf16 before
//   p v (kernel.py:83); this kernel does not: p is split in registers into
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi), and two wgmmas add p_hi v and
//   p_lo v into the same f32 accumulator, so p v keeps about 2^-16 of p's
//   relative precision (v is exact in bf16).  That costs 1.5x the counted
//   operations (the bound above counts them once).  The logits go through
//   exp2 of a pre-scaled value, p = exp2(s log2(e)/sqrt(Dh) - m
//   log2(e)/sqrt(Dh)), one fma and one ex2.approx.ftz as in FlashAttention
//   kernels (about 2 ulp; a p below 2^-126 of the row's largest flushes to
//   0), instead of expf(s/sqrt(Dh) - m); each pair of p rounds to bf16 with
//   one cvt.rn.bf16x2.  The output is rounded once to bf16 (nearest even)
//   after the IEEE division by l.
//
// * f32 (the f32 prefill check): PR 14's SIMT kernel as it was.  One CTA of
//   256 threads owns one (batch x query head, 64-row query tile), keeps its
//   q rows in shared memory and walks kv tiles of 64 keys, fetched one tile
//   ahead into registers (16-byte loads) and stored to shared memory; thread
//   (ty, tx) of a 16 x 16 layout holds the scores of rows ty*4+{0..3} and
//   keys tx+16*{0..3}; p goes through shared memory into p v.  expf and
//   IEEE division.  It runs on the f32 SIMT units (67 TFLOP/s at most).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, [1, 32768, 14,
// 64] bf16, PERF.md section 6): the first version (PR 14), the SIMT design
// widening bf16 to f32, 65.410 ms a launch; the wgmma route 7.078 ms (3.6x
// its bound; scaled_dot_product_attention 4.072 ms); the f32 route 65.440.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: the SIMT route.

namespace simt {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // query rows per CTA, keys per kv tile
constexpr int kPPitch = kTile + 4;  // row pitch of p in shared memory

template <int kDh>
constexpr int kPitch = kDh + 4;  // row pitch of q, k, v in shared memory

// One tile of kTile rows x kDh floats of one head, fetched as 16-byte
// vectors: kLoads a thread, thread tid taking vectors tid + i*kThreads.
template <int kDh>
struct Tile {
  static constexpr int kPerRow = kDh / 4;
  static constexpr int kLoads = kTile * kPerRow / kThreads;
  float4 raw[kLoads];

  // Rows row0 .. row0+kTile-1 of the head at `base` (row stride `rs`
  // elements); rows >= n are zeros.
  __device__ __forceinline__ void fetch(const float* __restrict__ base,
                                        long long rs, int row0, int n) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = static_cast<int>(threadIdx.x) + i * kThreads;
      const int r = row0 + idx / kPerRow;
      const int c = (idx % kPerRow) * 4;
      raw[i] = r < n ? __ldg(reinterpret_cast<const float4*>(
                           base + static_cast<long long>(r) * rs + c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // Into dst [kTile][kPitch<kDh>].
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = static_cast<int>(threadIdx.x) + i * kThreads;
      *reinterpret_cast<float4*>(dst + (idx / kPerRow) * kPitch<kDh> +
                                 (idx % kPerRow) * 4) = raw[i];
    }
  }
};

__device__ __forceinline__ float max16(float x) {  // over the 16 tx lanes
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Grid: (B * Hq, query tiles), the heaviest (last) query tiles first.
template <int kDh>
__global__ void __launch_bounds__(kThreads, kDh == 64 ? 2 : 1)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int sq, int skv, int hq, int hkv, long long qsb,
                    long long qss, long long qsh, long long ksb, long long kss,
                    long long ksh, long long vsb, long long vss, long long vsh,
                    int causal, int has_window, long long window, float scale) {
  constexpr int P = kPitch<kDh>;
  constexpr int kGroups = kDh / 64;  // accumulator column groups of 64
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][P]
  float* ks = qs + kTile * P;                   // [kTile][P], then p
  float* vs = ks + kTile * P;                   // [kTile][P]
  float* ps = ks;                               // [kTile][kPPitch]

  const int tid = static_cast<int>(threadIdx.x);
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = static_cast<int>(blockIdx.x);
  const int bi = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = (static_cast<int>(gridDim.y) - 1 -
                  static_cast<int>(blockIdx.y)) * kTile;
  const float* qb = q + bi * qsb + h * qsh;
  const float* kb = k + bi * ksb + kvh * ksh;
  const float* vb = v + bi * vsb + kvh * vsh;

  // The kv tiles some row of this query tile can see.
  const int k_end = causal ? min(skv, q0 + kTile) : skv;
  long long k_begin = 0;
  if (has_window) k_begin = max(0LL, static_cast<long long>(q0) - window + 1);
  const int t_begin = static_cast<int>(min(k_begin, static_cast<long long>(skv)) / kTile);
  const int t_end = (k_end + kTile - 1) / kTile;

  {
    Tile<kDh> qt;
    qt.fetch(qb, qss, q0, sq);
    qt.store(qs);
  }
  Tile<kDh> kt, vt;
  if (t_begin < t_end) {
    kt.fetch(kb, kss, t_begin * kTile, skv);
    vt.fetch(vb, vss, t_begin * kTile, skv);
  }

  float m[4], l[4], acc[4][kGroups][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's p and v are consumed
    kt.store(ks);
    vt.store(vs);
    __syncthreads();
    if (t + 1 < t_end) {  // in flight during this tile's arithmetic
      kt.fetch(kb, kss, k0 + kTile, skv);
      vt.fetch(vb, vss, k0 + kTile, skv);
    }

    // s = q k^T for rows ty*4+i, keys tx+16*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < kDh; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&qs[(ty * 4 + i) * P + d]);
        b[i] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * i) * P + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
      }
    }
    __syncthreads();  // every thread is done with k: p goes over it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool vis[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        vis[j] = kp < skv && (!causal || qp >= kp) &&
                 (!has_window || static_cast<long long>(qp) - kp < window);
        s[i][j] = vis[j] ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_safe) : 0.f;
        ps[(ty * 4 + i) * kPPitch + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = fmaf(l[i], corr, psum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= corr;
      }
    }
    __syncthreads();  // p is complete

    // acc += p v for rows ty*4+i, columns g*64 + tx*4 + c.
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&ps[(ty * 4 + i) * kPPitch + j]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(
              &vs[(j + jj) * P + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pij = jj == 0 ? a[i].x : jj == 1 ? a[i].y
                            : jj == 2 ? a[i].z : a[i].w;
            acc[i][g][0] = fmaf(pij, w.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(pij, w.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(pij, w.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(pij, w.w, acc[i][g][3]);
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-20), rows past Sq not written.
  const long long orow = static_cast<long long>(hq) * kDh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(sum16(l[i]), 1e-20f);
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    float* o = out + (static_cast<long long>(bi) * sq + r) * orow +
               static_cast<long long>(h) * kDh;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      *reinterpret_cast<float4*>(o + g * 64 + tx * 4) =
          make_float4(acc[i][g][0] / denom, acc[i][g][1] / denom,
                      acc[i][g][2] / denom, acc[i][g][3] / denom);
    }
  }
}

template <int kDh>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int sq, int skv, int hq, int hkv,
                   const long long* st, int causal, int has_window,
                   long long window, cudaStream_t stream) {
  constexpr size_t smem = 3 * kTile * kPitch<kDh> * sizeof(float);
  static_assert(kTile * kPPitch <= kTile * kPitch<kDh>, "p must fit over k");
  auto kern = flash_attention_f32<kDh>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int q_tiles = (sq + kTile - 1) / kTile;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(hq),
                  static_cast<unsigned>(q_tiles));
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kDh)));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv, hq,
      hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: the wgmma route.

namespace wg {

using namespace hopper;

constexpr int kM = 128;       // query rows per CTA: two consumers of 64
constexpr int kStages = 2;    // k/v ring
constexpr int kThreads = 384; // producer warpgroup + two consumers
constexpr int kConsumers = 256;

// Keys per kv tile: 128 at Dh 64; 64 at Dh 128, where o takes 64 registers
// a thread and s another 64 at 128 keys.
template <int kDh>
constexpr int kN = kDh == 64 ? 128 : 64;

// Shared memory, byte offsets from a 1024-aligned base.  A tile of R rows x
// Dh bf16 is Dh / 64 boxes of R rows x 128 bytes, one after the other, as
// TMA writes them with the 128-byte swizzle.
template <int kDh>
struct Layout {
  static constexpr int kBoxes = kDh / 64;
  static constexpr int kQBytes = kM * kDh * 2;
  static constexpr int kKVBytes = kN<kDh> * kDh * 2;  // one k or v tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;                     // + stage * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;     // + stage * kKVBytes
  static constexpr int kBars = kV + kStages * kKVBytes;  // q, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;  // one cvt for the pair, to nearest even; lo in bits 0-15
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float r;  // ex2.approx: ~2 ulp; results below 2^-126 flush to 0
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// s = q k^T over Dh: Dh / 16 wgmmas, A = this warpgroup's 64 q rows, B = the
// kv tile's keys, both K-major in 128-byte-swizzled boxes of 64 columns.
template <int kDh>
__device__ __forceinline__ void qk(float (&s)[kN<kDh> / 2], uint32_t q_addr,
                                   uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const uint32_t qa = q_addr + (kk / 4) * kM * 128 + (kk % 4) * 32;
    const uint32_t ka = k_addr + (kk / 4) * kN<kDh> * 128 + (kk % 4) * 32;
    if constexpr (kN<kDh> == 128) {
      wgmma_ss_n128(s, desc_k_major(qa), desc_k_major(ka), kk > 0);
    } else {
      wgmma_ss_n64(s, desc_k_major(qa), desc_k_major(ka), kk > 0);
    }
  }
}

// o += p v for one k16 step: A = p's fragment, B = 16 rows of v from
// `v_addr`, MN-major, its 64-column boxes kN * 128 bytes apart.
template <int kDh>
__device__ __forceinline__ void pv(float (&o)[kDh / 2], const uint32_t (&a)[4],
                                   uint32_t v_addr) {
  const uint64_t db = desc_sw128(v_addr, kN<kDh> * 128);
  if constexpr (kDh == 64) {
    wgmma_rs_n64_tb(o, a, db, 1);
  } else {
    wgmma_rs_n128_tb(o, a, db, 1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Grid: (B * Hq, query tiles), the heaviest (last) query tiles first.
// scale_log2 = log2(e) / sqrt(Dh).
template <int kDh>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     uint16_t* __restrict__ out, int sq, int skv, int hq,
                     int hkv, int causal, int has_window, long long window,
                     float scale_log2) {
  using L = Layout<kDh>;
  constexpr int N = kN<kDh>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_smem = base + L::kQ;
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 * stage

  const int tid = static_cast<int>(threadIdx.x);
  const int bh = static_cast<int>(blockIdx.x);
  const int bi = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = (static_cast<int>(gridDim.y) - 1 -
                  static_cast<int>(blockIdx.y)) * kM;

  // The kv tiles some row of this query tile can see.
  const int k_end = causal ? min(skv, q0 + kM) : skv;
  long long k_begin = 0;
  if (has_window) k_begin = max(0LL, static_cast<long long>(q0) - window + 1);
  const int t_begin =
      static_cast<int>(min(k_begin, static_cast<long long>(skv)) / N);
  const int t_end = (k_end + N - 1) / N;

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer: one thread issues every load
    if (tid == 0) {
      mbar_arrive_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(q_smem + c * kM * 128, &tq, bar_q, c * 64, h, q0, bi);
      }
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % kStages;
        if (i >= kStages) mbar_wait(bar_empty + 8 * s, (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kKVBytes);
        const uint32_t ks = base + L::kK + s * L::kKVBytes;
        const uint32_t vs = base + L::kV + s * L::kKVBytes;
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(ks + c * N * 128, &tk, bar_full + 8 * s, c * 64, kvh,
                      t * N, bi);
          tma_load_4d(vs + c * N * 128, &tv, bar_full + 8 * s, c * 64, kvh,
                      t * N, bi);
        }
      }
    }
    return;
  }

  // A consumer: 64 query rows r_lo .. r_lo + 63; this thread holds rows
  // row0 and row0 + 8 (the wgmma accumulator layout: warp w of the
  // warpgroup owns rows 16w .. 16w + 15, lane l rows l/4 and l/4 + 8 of
  // them, and columns 8j + 2(l%4) + {0, 1} of every n8 block j).
  const int wgi = tid / 128 - 1;
  const int lt = tid % 128;
  const int lane = lt % 32;
  const int r_lo = q0 + wgi * 64;
  const int r_hi = r_lo + 63;
  const int row0 = r_lo + (lt / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t q_wg = q_smem + wgi * 64 * 128;

  float o[kDh / 2];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, s = i % kStages;
    const int k0 = t * N, k_last = k0 + N - 1;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
    // Uniform over the warpgroup: every key of the tile is hidden from
    // every row (skip), or some key from some row (mask).
    const bool hidden =
        (causal && k0 > r_hi) ||
        (has_window &&
         static_cast<long long>(r_lo) - min(k_last, skv - 1) >= window);
    const bool edge = k0 + N > skv || (causal && k_last > r_lo) ||
                      (has_window && static_cast<long long>(r_hi) - k0 >= window);
    if (!hidden) {
      float sc[N / 2];
      wgmma_fence();
      qk<kDh>(sc, q_wg, base + L::kK + s * L::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < N / 2; ++e) {
        const int r = (e >> 1) & 1;
        if (edge) {
          const int kp = k0 + 8 * (e >> 2) + cq + (e & 1);
          const int qp = row0 + 8 * r;
          const bool vis =
              kp < skv && (!causal || qp >= kp) &&
              (!has_window || static_cast<long long>(qp) - kp < window);
          if (!vis) sc[e] = -INFINITY;
        }
        mx[r] = fmaxf(mx[r], sc[e]);
      }
      float corr[2], neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = m[r] == -INFINITY ? 0.f
                                    : exp2_ftz((m[r] - m_safe) * scale_log2);
        neg[r] = -m_safe * scale_log2;
        m[r] = m_new;
      }

      // p in the A-fragment layout of each k16 step kk: register a of
      // step kk holds row (a & 1) and n8 block 2kk + (a >> 1), the same
      // (row, column) pairs as accumulator entries 8kk + 2a, 8kk + 2a + 1.
      uint32_t ph[N / 16][4], pl[N / 16][4];
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = a & 1;
          const float p0 = exp2_ftz(fmaf(sc[8 * kk + 2 * a], scale_log2, neg[r]));
          const float p1 =
              exp2_ftz(fmaf(sc[8 * kk + 2 * a + 1], scale_log2, neg[r]));
          ls[r] += p0 + p1;
          const uint32_t hi = pack_bf16(p0, p1);
          ph[kk][a] = hi;
          pl[kk][a] = pack_bf16(p0 - bf16_lo(hi), p1 - bf16_hi(hi));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], ls[r]);
#pragma unroll
      for (int e = 0; e < kDh / 2; ++e) o[e] *= corr[(e >> 1) & 1];

      fence_regs(o);
      wgmma_fence();
      const uint32_t vs = base + L::kV + s * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        pv<kDh>(o, ph[kk], vs + kk * 16 * 128);
        pv<kDh>(o, pl[kk], vs + kk * 16 * 128);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    mbar_arrive(bar_empty + 8 * s);
  }

  // out = o / max(l, 1e-20) in bf16; rows past Sq not written.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), 1e-20f);
    const int qp = row0 + 8 * r;
    if (qp >= sq) continue;
    uint16_t* orow = out + (static_cast<long long>(bi) * sq + qp) *
                               static_cast<long long>(hq) * kDh +
                     static_cast<long long>(h) * kDh;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + cq) =
          pack_bf16(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// that the library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The 4-D map (Dh, H, S, B) of one bf16 operand, box (64, 1, rows, 1),
// 128-byte swizzle, zeros outside.  Strides in elements (batch, seq,
// head); a dimension of extent 1 gets the stride it would have if packed
// (its coordinate is always 0).
bool encode(CUtensorMap* map, const void* ptr, int b, int s, int h, int dh,
            long long sb, long long ss, long long sh, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  if (h == 1) sh = dh;
  if (s == 1) ss = sh * h;
  if (b == 1) sb = ss * s;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kDh>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int sq, int skv, int hq, int hkv,
                   const long long* st, int causal, int has_window,
                   long long window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // skv = 0 has no tile to load; the maps only need to be valid.
  const int skv_map = skv > 0 ? skv : 1;
  if (!encode(&tq, q, b, sq, hq, kDh, st[0], st[1], st[2], kM) ||
      !encode(&tk, k, b, skv_map, hkv, kDh, st[3], st[4], st[5], kN<kDh>) ||
      !encode(&tv, v, b, skv_map, hkv, kDh, st[6], st[7], st[8], kN<kDh>)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Layout<kDh>::kBytes;
  auto kern = flash_attention_bf16<kDh>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (sq + kM - 1) / kM;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(hq),
                  static_cast<unsigned>(q_tiles));
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(kDh)));
  kern<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(out), sq, skv, hq, hkv, causal,
      has_window, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype 0: float32 (the SIMT route), 1: bfloat16 (the wgmma route).
// Strides in elements: (batch, seq, head) of q, then k, then v.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int b,
    int sq, int skv, int hq, int hkv, int dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int has_window,
    long long window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || sq <= 0 || skv < 0 || hq <= 0 || hkv <= 0 || hq % hkv) {
    return cudaErrorInvalidValue;
  }
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh == 64) {
    return simt::launch<64>(q, k, v, out, b, sq, skv, hq, hkv, st, causal,
                            has_window, window, s);
  }
  if (dtype == 0 && dh == 128) {
    return simt::launch<128>(q, k, v, out, b, sq, skv, hq, hkv, st, causal,
                             has_window, window, s);
  }
  if (dtype == 1 && dh == 64) {
    return wg::launch<64>(q, k, v, out, b, sq, skv, hq, hkv, st, causal,
                          has_window, window, s);
  }
  if (dtype == 1 && dh == 128) {
    return wg::launch<128>(q, k, v, out, b, sq, skv, hq, hkv, st, causal,
                           has_window, window, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
