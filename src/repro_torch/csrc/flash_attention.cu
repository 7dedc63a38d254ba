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
// Positions count from 0 in q and in k/v, as in the Pallas kernel.
//
// The TPU kernel walks a (batch x head, q block, kv block) grid whose last
// axis runs in order on one core, carrying (m, l, acc) in VMEM scratch from
// one kv block to the next, and skips a fully masked kv block with pl.when.
// Here that axis is a loop inside the CTA.  One CTA of 256 threads owns one
// (batch x query head, 64-row query tile): it keeps the tile's q rows in
// shared memory (widened to f32), and walks the kv tiles of 64 keys that its
// rows can see, from the window's lower edge to the causal diagonal, so a
// hidden tile costs nothing.  Each kv tile is fetched into registers one
// tile ahead (16-byte loads, coalesced along Dh) and widened to f32 into
// shared memory.  Thread (ty, tx) of a 16 x 16 layout holds the scores of
// rows ty*4+{0..3} and keys tx+16*{0..3}, and the accumulator of rows
// ty*4+{0..3} and columns {0, 64}+tx*4+{0..3}; the running max and sum of
// its four rows live in registers (each sum is a partial over the thread's
// keys, added across the 16 threads of the row at the end: every partial is
// rescaled by the same factors).  Row maxima go through warp shuffles over
// those 16 threads; p goes through shared memory (over the tile's K, no
// longer needed) into the P V product.  No atomics and a fixed order: the
// kernel is deterministic.
//
// Precision, decided here: logits, p and the accumulator are f32, and bf16
// inputs are widened to f32 on load, as the model's chunked attention
// (repro.models.layers.chunked_attention) and flash_attention_ref compute.
// The Pallas kernel instead rounds p to v's dtype before the P V product;
// for f32 inputs the three are the same function.  The output is rounded
// once to q's dtype (round to nearest even), like the plain version's
// .to(q.dtype).  expf and IEEE division, not their fast forms.
//
// The layout is the JAX wrapper's, q [B, Sq, Hq, Dh] and k/v [B, Skv, Hkv,
// Dh], read through their strides (rows contiguous in Dh, 16-byte aligned);
// the output is written [B, Sq, Hq, Dh] directly, so none of the wrapper's
// head-major copies is made.  The ragged S edges are masked here (zero
// fill, key positions >= Skv hidden, rows >= Sq not written), so nothing
// is padded and S need not be a multiple of the tile.
//
// What bounds it: the causal product is 4 B Hq Dh S(S+1)/2 operations
// (q k^T and p v, two each per multiply-add), against the bytes of the q,
// k, v and o streams.  At the LM prefill's B = 1, S = 32,768, Hq = 14,
// Dh = 64 that is 1.924e12 operations a layer, 1.95 ms at the 989 TFLOP/s
// of bf16 on the tensor cores (46.7 ms for 24 layers), against ~134 MB of
// q, k, v and o, 0.04 ms at 3.35 TB/s: it is bound by operations.  This
// first kernel does the arithmetic on the f32 SIMT units (67 TFLOP/s at
// most, 28.7 ms a layer), with two shared-memory loads per 16 multiply-
// adds; wgmma over bf16 tiles (with p kept in f32 or rounded, a precision
// question), TMA and a producer warp are the levers for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // query rows per CTA, keys per kv tile
constexpr int kPPitch = kTile + 4;  // row pitch of p in shared memory

template <int kDh>
constexpr int kPitch = kDh + 4;  // row pitch of q, k, v in shared memory

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {  // nearest even
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// One tile of kTile rows x kDh values of one head, fetched as 16-byte
// vectors: kLoads a thread, thread tid taking vectors tid + i*kThreads.
template <typename T, int kDh>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);  // values per vector
  static constexpr int kPerRow = kDh / kVec;
  static constexpr int kLoads = kTile * kPerRow / kThreads;
  uint4 raw[kLoads];

  // Rows row0 .. row0+kTile-1 of the head at `base` (row stride `rs`
  // elements); rows >= n are zeros.
  __device__ __forceinline__ void fetch(const T* __restrict__ base,
                                        long long rs, int row0, int n) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = static_cast<int>(threadIdx.x) + i * kThreads;
      const int r = row0 + idx / kPerRow;
      const int c = (idx % kPerRow) * kVec;
      raw[i] = r < n ? __ldg(reinterpret_cast<const uint4*>(
                           base + static_cast<long long>(r) * rs + c))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Widen to f32 into dst [kTile][kPitch<kDh>].
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = static_cast<int>(threadIdx.x) + i * kThreads;
      float* row = dst + (idx / kPerRow) * kPitch<kDh> + (idx % kPerRow) * kVec;
      const uint4 w = raw[i];
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(row) =
            make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                        __uint_as_float(w.z), __uint_as_float(w.w));
      } else {
        *reinterpret_cast<float4*>(row) =
            make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
        *reinterpret_cast<float4*>(row + 4) =
            make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
      }
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

// T: float or bf16 bits (uint16_t).  Grid: (B * Hq, query tiles), the
// heaviest (last) query tiles first so that the causal tail is short.
template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads, kDh == 64 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int skv, int hq, int hkv, long long qsb, long long qss,
                       long long qsh, long long ksb, long long kss,
                       long long ksh, long long vsb, long long vss,
                       long long vsh, int causal, int has_window,
                       long long window, float scale) {
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
  const T* qb = q + bi * qsb + h * qsh;
  const T* kb = k + bi * ksb + kvh * ksh;
  const T* vb = v + bi * vsb + kvh * vsh;

  // The kv tiles some row of this query tile can see.
  const int k_end = causal ? min(skv, q0 + kTile) : skv;
  long long k_begin = 0;
  if (has_window) k_begin = max(0LL, static_cast<long long>(q0) - window + 1);
  const int t_begin = static_cast<int>(min(k_begin, static_cast<long long>(skv)) / kTile);
  const int t_end = (k_end + kTile - 1) / kTile;

  {
    Tile<T, kDh> qt;
    qt.fetch(qb, qss, q0, sq);
    qt.store(qs);
  }
  Tile<T, kDh> kt, vt;
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
    T* o = out + (static_cast<long long>(bi) * sq + r) * orow +
           static_cast<long long>(h) * kDh;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float x0 = acc[i][g][0] / denom, x1 = acc[i][g][1] / denom;
      const float x2 = acc[i][g][2] / denom, x3 = acc[i][g][3] / denom;
      T* dst = o + g * 64 + tx * 4;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(x0, x1, x2, x3);
      } else {
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(bf16_bits(x0) | (bf16_bits(x1) << 16),
                       bf16_bits(x2) | (bf16_bits(x3) << 16));
      }
    }
  }
}

template <typename T, int kDh>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int sq, int skv, int hq, int hkv,
                   const long long* st, int causal, int has_window,
                   long long window, cudaStream_t stream) {
  constexpr size_t smem = 3 * kTile * kPitch<kDh> * sizeof(float);
  static_assert(kTile * kPPitch <= kTile * kPitch<kDh>, "p must fit over k");
  auto kern = flash_attention_kernel<T, kDh>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int q_tiles = (sq + kTile - 1) / kTile;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(hq),
                  static_cast<unsigned>(q_tiles));
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kDh)));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, hq, hkv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  Strides in elements: (batch, seq, head)
// of q, then k, then v.
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
    return launch<float, 64>(q, k, v, out, b, sq, skv, hq, hkv, st, causal,
                             has_window, window, s);
  }
  if (dtype == 0 && dh == 128) {
    return launch<float, 128>(q, k, v, out, b, sq, skv, hq, hkv, st, causal,
                              has_window, window, s);
  }
  if (dtype == 1 && dh == 64) {
    return launch<uint16_t, 64>(q, k, v, out, b, sq, skv, hq, hkv, st,
                                causal, has_window, window, s);
  }
  if (dtype == 1 && dh == 128) {
    return launch<uint16_t, 128>(q, k, v, out, b, sq, skv, hq, hkv, st,
                                 causal, has_window, window, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
