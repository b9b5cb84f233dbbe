// Scatter stage of the sort insert pipeline: out[k / m, k % m] += w for
// every (key, weight) triple with key in [0, rows * m); other keys (the
// compaction's sentinels and its int32-max tail) are dropped.
//
// Replaces: src/repro/kernels/ddsketch_scatter.py, _scatter_kernel (the
// Pallas TPU kernel behind ddsketch_scatter_pallas).  Contract: the plain
// version repro_torch.kernels.ref.scatter_histogram_ref.
//
// What bounds it on an H100: memory.  Each triple is 8 bytes read and one
// 4-byte add; the (rows, m) output is cleared and written once (64 MiB at
// rows = 2K = 8192, m = 2048), which dominates once the keys are compacted.
//
// What the design does about it: the TPU kernel kept the output resident
// in VMEM (a row ceiling) and matched every triple tile against every
// bucket tile with one-hot matmuls.  Here one thread per triple
// (grid-stride) makes one global atomicAdd, so there is no row ceiling and
// the work is O(U).  The keys compact_triples emits are unique, so each
// bucket takes at most one add and the result equals the plain version bit
// for bit; the add stays atomic so duplicate keys still accumulate, as the
// contract requires.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8192;

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ keys, const float* __restrict__ weights, long long n,
               long long total, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const long long k = keys[i];
    if (k >= 0 && k < total) atomicAdd(out + k, weights[i]);
  }
}

}  // namespace

// keys (U,) int32, weights (U,) float32, out (rows, m) float32.
extern "C" int ddsketch_scatter(const int* keys, const float* weights, long long n, int rows,
                                int m, float* out, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const long long total = static_cast<long long>(rows) * m;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * size_t(total), stream);
  if (err != cudaSuccess) return err;
  if (n > 0 && total > 0) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
    scatter_kernel<<<blocks, kThreads, 0, stream>>>(keys, weights, n, total, out);
  }
  return cudaGetLastError();
}
