// Per-segment histogram: out[seg, bucket(x)] += w for every finite lane
// with x > min_indexable and seg in [0, K), each keyed at its own collapse
// level; (N,) lanes -> (K, m) counts.
//
// Replaces: src/repro/kernels/ddsketch_seg_hist.py, _seg_hist_kernel (the
// Pallas TPU kernel behind segment_histogram_pallas).  Contract: the plain
// version repro_torch.kernels.ref.segment_histogram_ref.
//
// What bounds it on an H100: memory.  Per lane it reads up to 16 bytes
// (value, segment id, weight, level) and does a few dozen float/int
// operations; the (K, m) output is cleared and written once (32 MiB at
// K = 4096, m = 2048).  Hot buckets serialise their atomics in L2.
//
// What the design does about it: the TPU kernel binned with one-hot
// matmuls on the MXU, streaming every lane through every (row tile, bucket
// tile) of the output, so its work grew with K * m * N.  Here one thread
// per lane (grid-stride) computes the key with the shared bucket_key.cuh
// code and makes one global atomicAdd, so the work is O(N) and the output
// is touched only where lanes land; the wrapper's memset clears it at
// memory rate.  Integer weights below 2^24 sum exactly in any order, so
// the result equals the plain version bit for bit; fractional weights
// differ in the atomic order only.
#include "bucket_key.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8192;

__global__ void __launch_bounds__(kThreads)
seg_hist_kernel(const float* __restrict__ values, const int* __restrict__ ids,
                const float* __restrict__ weights, const int* __restrict__ levels,
                long long n, int k, int m, int offset, int mapping, float multiplier,
                float min_indexable, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float x = values[i];
    const int s = ids[i];
    if (!(isfinite(x) && x > min_indexable && s >= 0 && s < k)) continue;
    const int lev = levels != nullptr ? repro::clamp_level(levels[i]) : 0;
    const int idx = repro::bucket_of(repro::level_key(x, mapping, multiplier, lev), offset, m);
    atomicAdd(out + static_cast<long long>(s) * m + idx, weights != nullptr ? weights[i] : 1.0f);
  }
}

}  // namespace

// out (K, m) float32; weights and levels may be null (all 1 / all 0).
extern "C" int ddsketch_seg_hist(const float* values, const int* ids, const float* weights,
                                 const int* levels, long long n, int k, int m, int offset,
                                 int mapping, float multiplier, float min_indexable, float* out,
                                 void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * size_t(k) * size_t(m), stream);
  if (err != cudaSuccess) return err;
  if (n > 0 && k > 0) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
    seg_hist_kernel<<<blocks, kThreads, 0, stream>>>(values, ids, weights, levels, n, k, m,
                                                     offset, mapping, multiplier, min_indexable,
                                                     out);
  }
  return cudaGetLastError();
}
