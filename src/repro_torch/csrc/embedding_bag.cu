// Weighted bag lookup-reduce (EmbeddingBag, mode sum), for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro.kernels.embedding_bag.kernel
// .embedding_bag_kernel (src/repro/kernels/embedding_bag/kernel.py:58).  It
// computes
//
//     out[n, :] = sum_l w[n, l] * table[ids[n, l], :]
//
// where an id of -1 (padding), or any id outside [0, V), adds 0, as in the
// Pallas kernel (its tile test drops an id at or past V).  w is all ones
// when no weights are given.
//
// The TPU kernel turns the gather into dense work for its matrix unit: it
// streams the whole table through VMEM once per batch block, vocab tile by
// vocab tile, and multiplies a one-hot [bags, tile] matrix by each tile.
// Hopper gathers rows directly.
//
// The fold: each output element is fmaf(live ? w : 0, live ? x : 0, acc)
// over l in ascending order from acc = +0, in one thread, no atomics.  An
// unweighted bag is then bit for bit the sequential f32 sum of its live
// rows, results repeat bit for bit, and every route gives the same bits.
//
// What bounds it: bytes.  A call must read N * L * 4 B of ids (and as many
// of weights), each distinct row it names once (D * 4 B) and write
// N * D * 4 B, over 3.35 TB/s.  The card moves rows in 32-byte sectors (a
// 40-byte row spans two whatever its offset, a 72-byte one three), and a
// random row of a large field is a miss to device memory; the rows of a
// profile's smallest fields stay in L1, the next ones in L2.
//
// A lane group per bag.  D / VEC neighbouring threads take one bag, each
// holding VEC consecutive columns of it: VEC = 4 when D % 4 == 0 and the
// table is 16-byte aligned, 2 when D is even and it is 8-byte aligned,
// else 1 (the entry picks it, ops.pick_route).  Groups follow each other
// across the warps, so no lane idles.  Each lane reads the bag's ids (and
// weights) IVEC = 2 at a time where L is even and they are 8-byte aligned,
// else 1 (4 at a time was slower wherever VEC > 1, PERF.md);
// the group's lanes ask for the same words in one request, which L1 serves
// once.  The rows of kChunk ids are issued before the first add, so
// eight row loads are in flight a lane.  At serve_bulk (262,144 x 39 bags
// of 8, D = 10) this beat the designs it was measured against (PERF.md):
// handing the ids to the lanes by shuffle from a group's first lanes
// (groups then align to warps and idle lanes, and the registers it takes
// cost occupancy); serving small fields from shared memory (L1 already
// holds the smallest; a staged CTA waits on its ids, and its outputs are
// 40-byte pieces written apart from their neighbours, partial sectors);
// walking the bags field by field (the same partial sectors).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;  // ids whose rows are in flight together

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (N == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

// Ids, weights and the output are read or written once: streamed
// (evict-first), leaving L1 and L2 to the rows.
template <int N>
__device__ __forceinline__ void load_weights(const float* p, float* x) {
  if constexpr (N == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = __ldcs(p);
  }
}

template <int N>
__device__ __forceinline__ void load_ids(const int* p, int* x) {
  if constexpr (N == 2) {
    const int2 t = __ldcs(reinterpret_cast<const int2*>(p));
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = __ldcs(p);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (N == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(x[0], x[1], x[2], x[3]));
  } else if constexpr (N == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
    __stcs(p, x[0]);
  }
}

template <int VEC, int IVEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const int* __restrict__ ids,        // [n, l]
                     const float* __restrict__ weights,  // [n, l] or null
                     const float* __restrict__ table,    // [v, d]
                     float* __restrict__ out,            // [n, d]
                     long long n, int l, long long v, int d) {
  const int cols = d / VEC;  // lanes a group
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * cols) return;
  const long long bag = t / cols;
  const int c = static_cast<int>(t - bag * cols);
  const int* bag_ids = ids + bag * l;
  const float* bag_w = weights != nullptr ? weights + bag * l : nullptr;
  const float* col = table + c * VEC;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < l; j0 += kChunk) {
    int id[kChunk];
    float w[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; u += IVEC) {
      if (j0 + u < l) {  // L % IVEC == 0: a load is whole or absent
        load_ids<IVEC>(bag_ids + j0 + u, id + u);
        if (bag_w != nullptr) load_weights<IVEC>(bag_w + j0 + u, w + u);
      } else {
#pragma unroll
        for (int e = 0; e < IVEC; ++e) id[u + e] = -1;
      }
    }
    float x[kChunk][VEC];
    unsigned live = 0;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const bool ok = id[u] >= 0 && id[u] < v;
      live |= static_cast<unsigned>(ok) << u;
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[u][e] = 0.f;
      if (ok) load_vec<VEC>(col + static_cast<long long>(id[u]) * d, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (j0 + u >= l) break;
      const float wu =
          (live >> u) & 1u ? (bag_w != nullptr ? w[u] : 1.f) : 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wu, x[u][e], acc[e]);
    }
  }
  store_vec<VEC>(out + bag * d + c * VEC, acc);
}

template <int VEC, int IVEC>
int launch(const int* ids, const float* weights, const float* table,
           float* out, long long n, int l, long long v, int d,
           cudaStream_t stream) {
  const long long blocks = (n * (d / VEC) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  embedding_bag_kernel<VEC, IVEC>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          ids, weights, table, out, n, l, v, d);
  return cudaGetLastError();
}

}  // namespace

// vec, ivec: the route (ops.pick_route): the floats a lane loads of a row,
// and the ids (and weights) it loads at once.
extern "C" int embedding_bag_launch(const int* ids, const float* weights,
                                    const float* table, float* out,
                                    long long n, int l, long long v, int d,
                                    int vec, int ivec, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 0 || l < 0 || v < 0 || d < 0 || vec < 1 || ivec < 1 ||
      d % vec != 0 || l % ivec != 0)
    return cudaErrorInvalidValue;
  if (n == 0 || d == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EB_LAUNCH(V, I)                                                 \
  if (vec == V && ivec == I)                                            \
    return launch<V, I>(ids, weights, table, out, n, l, v, d, s);
  EB_LAUNCH(4, 2) EB_LAUNCH(4, 1)
  EB_LAUNCH(2, 2) EB_LAUNCH(2, 1)
  EB_LAUNCH(1, 2) EB_LAUNCH(1, 1)
#undef EB_LAUNCH
  return cudaErrorInvalidValue;
}

extern "C" const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
