// Single-sketch histogram: out[bucket(x)] += w for every finite lane with
// x > min_indexable, each keyed at its own collapse level; (N,) lanes ->
// (m,) counts.
//
// Replaces: src/repro/kernels/ddsketch_hist.py, _hist_kernel (the Pallas
// TPU kernel behind histogram_pallas).  Contract: the plain version
// repro_torch.kernels.ref.histogram_ref.
//
// What bounds it on an H100: memory, N * 12 bytes (value, weight, level)
// read plus m * 4 written, once the atomics are off the critical path.
// Every lane lands in one row of m bins (8 KiB at m = 2048), so global
// atomics from 2^20 lanes would all queue on the same few L2 lines.
//
// What the design does about it: the TPU kernel contracted value tiles
// against one-hot bucket tiles on the MXU.  Here each block keeps a
// private copy of the row in shared memory, bins its grid-stride share of
// the lanes there with shared-memory atomics (keys from the shared
// bucket_key.cuh code), then adds each non-zero bin to the output with
// one global atomicAdd, so the global traffic is at most blocks * m
// atomics whatever N is.  Integer weights below 2^24 sum exactly in any
// order, so the result equals the plain version bit for bit; fractional
// weights differ in the atomic order only.
#include "bucket_key.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kLanesPerBlock = 16 * kThreads;  // amortises the block's flush
constexpr int kMaxBlocks = 264;                // two blocks per SM on 132 SMs

__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ values, const float* __restrict__ weights,
            const int* __restrict__ levels, long long n, int m, int offset, int mapping,
            float multiplier, float min_indexable, float* __restrict__ out) {
  extern __shared__ float bins[];
  for (int j = threadIdx.x; j < m; j += kThreads) bins[j] = 0.0f;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float x = values[i];
    if (!(isfinite(x) && x > min_indexable)) continue;
    const int lev = levels != nullptr ? repro::clamp_level(levels[i]) : 0;
    const int idx = repro::bucket_of(repro::level_key(x, mapping, multiplier, lev), offset, m);
    atomicAdd(bins + idx, weights != nullptr ? weights[i] : 1.0f);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float v = bins[j];
    if (v != 0.0f) atomicAdd(out + j, v);
  }
}

}  // namespace

// out (m,) float32; weights and levels may be null (all 1 / all 0).
extern "C" int ddsketch_hist(const float* values, const float* weights, const int* levels,
                             long long n, int m, int offset, int mapping, float multiplier,
                             float min_indexable, float* out, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * size_t(m), stream);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaGetLastError();
  const size_t smem = sizeof(float) * static_cast<size_t>(m);
  err = repro::allow_smem(hist_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long want = (n + kLanesPerBlock - 1) / kLanesPerBlock;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  hist_kernel<<<blocks, kThreads, smem, stream>>>(values, weights, levels, n, m, offset, mapping,
                                                  multiplier, min_indexable, out);
  return cudaGetLastError();
}
