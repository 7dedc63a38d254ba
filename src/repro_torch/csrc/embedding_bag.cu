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
// At V = 16.6M rows that is 32,416 tiles per block.  Hopper gathers rows
// directly: one thread owns one output element (n, d), reads its bag's ids
// and weights in ascending l (the D threads of a bag read the same words,
// which L1 serves once), and sums w * table[id, d] in f32 with fma.  No
// atomics and a fixed order, so results are bitwise equal from run to run.
// Neighbouring threads hold neighbouring columns of a row and neighbouring
// outputs, so a row's D floats are one contiguous read and out is written
// in coalesced lines.  Rows are D * 4 bytes (40 B at D = 10, 72 B at
// D = 18), not 16-byte aligned, so every load is a scalar.  Row offsets
// are 64-bit (id * D).  The table loads are predicated rather than
// branched around, so the unrolled l loop keeps several gathers in flight.
//
// What bounds it: bytes.  A call must read N * L * 4 B of ids (and as many
// of weights, when given), each distinct row it names once (D * 4 B) and
// write N * D * 4 B, over 3.35 TB/s.  A row named again is needed once:
// the rows of a profile's small fields (most of Criteo-39's 39) stay in
// the 50 MB L2, so repeats of them cost no device-memory traffic, while
// each id into a large field is a random read of a 40-byte row that spans
// two 32-byte sectors.  The design keeps each row one contiguous read and
// several gathers in flight, and stages nothing in shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const int* __restrict__ ids,        // [n, l]
                     const float* __restrict__ weights,  // [n, l] or null
                     const float* __restrict__ table,    // [v, d]
                     float* __restrict__ out,            // [n, d]
                     long long n, int l, long long v, int d) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n * d) return;
  const long long bag = i / d;
  const int col = static_cast<int>(i - bag * d);
  const int* bag_ids = ids + bag * l;
  const float* bag_w = weights != nullptr ? weights + bag * l : nullptr;
  float acc = 0.f;
#pragma unroll 4
  for (int j = 0; j < l; ++j) {
    const int id = __ldg(bag_ids + j);
    const bool live = id >= 0 && id < v;
    const float w = bag_w != nullptr ? __ldg(bag_w + j) : 1.f;
    const float x =
        live ? __ldg(table + static_cast<long long>(id) * d + col) : 0.f;
    acc = fmaf(live ? w : 0.f, x, acc);
  }
  out[i] = acc;
}

}  // namespace

extern "C" int embedding_bag_launch(const int* ids, const float* weights,
                                    const float* table, float* out,
                                    long long n, int l, long long v, int d,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 0 || l < 0 || v < 0 || d < 0) return cudaErrorInvalidValue;
  const long long total = n * d;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  embedding_bag_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ids, weights, table, out, n, l, v, d);
  return cudaGetLastError();
}

extern "C" const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
