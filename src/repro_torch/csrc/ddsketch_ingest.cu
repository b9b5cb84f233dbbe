// Fused bank ingest: bucketize every lane, bin it into the combined
// (2K, m) pos/neg histogram, and fold it into six per-row statistics
// (zero / overflow / underflow weight, sum of w*x, min x, max x over lanes
// with w > 0) in one pass over the lanes.
//
// Replaces: src/repro/kernels/ddsketch_ingest.py, _ingest_kernel (the
// Pallas TPU kernel behind ddsketch_ingest_pallas).  Contract: the plain
// version repro_torch.kernels.ref.fused_ingest_ref.
//
// What bounds it on an H100: memory.  Per lane it reads 16 bytes (value,
// id, weight, level) and does a few dozen float/int operations, far below
// the card's 67 TFLOP/s float32 rate; the (2K, m) float32 output must also
// be written once (64 MiB at K = 4096, m = 2048), which is the larger
// share at the serving shapes.  Contention on hot buckets (one key's lanes
// landing in the same few buckets) serialises the global atomics in L2.
//
// What the design does about it: the TPU kernel kept all 2K rows resident
// in VMEM and binned with one-hot matmuls on the MXU (the TPU has no fast
// scatter).  Here each thread bins its lane with one global atomicAdd, so
// there is no resident-row ceiling and the output is touched only where
// lanes land; the output is cleared by one cudaMemsetAsync at memory rate.
// The six statistics go through a segmented warp reduction over runs of
// equal row id (record_batches lays each key's lanes out contiguously, so
// a warp usually holds one or two runs) and one atomic per run.  Extrema
// use integer atomics on the float bits (atomicMin/atomicMax on the sign-
// split bit patterns), which order -0.0 below +0.0; callers compare them
// numerically.
//
// Bit-exactness: the bucket key comes from bucket_key.cuh, shared with the
// histogram kernels (no contracted FMAs, the same logf as torch.log).
// Histograms and counters are exact for integer-valued weights; summ and
// fractional weights depend on the atomic order.
#include "bucket_key.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8192;

// Float min / max through integer atomics on the float's own storage:
// non-negative floats order like signed ints, negative ones in reverse
// like unsigned ints.
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (!signbit(v)) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (!signbit(v)) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
  }
}

__global__ void init_stats_kernel(float* sums, float* vmin, float* vmax, int k) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < k; r += gridDim.x * blockDim.x) {
    sums[r] = 0.0f;
    sums[k + r] = 0.0f;
    sums[2 * k + r] = 0.0f;
    sums[3 * k + r] = 0.0f;
    vmin[r] = INFINITY;
    vmax[r] = -INFINITY;
  }
}

__global__ void __launch_bounds__(kThreads)
ingest_kernel(const float* __restrict__ values, const int* __restrict__ ids,
              const float* __restrict__ weights, const int* __restrict__ levels,
              long long n, int k, int m, int offset, int mapping, float multiplier,
              float min_indexable, float* __restrict__ hist, float* __restrict__ sums,
              float* __restrict__ vmin, float* __restrict__ vmax) {
  const int lane = threadIdx.x & 31;
  const int top_key = offset + m - 1;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // the loop bound is uniform over the block, so every lane of a warp
  // reaches the shuffles below; lanes past n act as invalid lanes
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    int row = -1;
    float z = 0.0f, ov = 0.0f, un = 0.0f, sx = 0.0f;
    float mn = INFINITY, mx = -INFINITY;
    if (i < n) {
      const float x = values[i];
      const int s = ids[i];
      if (isfinite(x) && s >= 0 && s < k) {
        row = s;
        const float w = weights != nullptr ? weights[i] : 1.0f;
        const bool is_pos = x > min_indexable;
        const bool is_neg = x < -min_indexable;
        if (is_pos || is_neg) {
          const int lev = levels != nullptr ? repro::clamp_level(levels[i]) : 0;
          const int k_lev = repro::level_key(fabsf(x), mapping, multiplier, lev);
          if (k_lev > top_key) ov = w;
          if (k_lev < offset) un = w;
          const int idx = repro::bucket_of(k_lev, offset, m);
          const long long r = row + (is_neg ? k : 0);
          atomicAdd(hist + r * m + idx, w);
        } else {
          z = w;
        }
        sx = __fmul_rn(w, x);
        if (w > 0.0f) {
          mn = x;
          mx = x;
        }
      }
    }
    // segmented inclusive reduction over runs of equal row within the warp
    const int prev = __shfl_up_sync(repro::kFullMask, row, 1);
    const unsigned heads = __ballot_sync(repro::kFullMask, lane == 0 || prev != row);
    const unsigned upto = lane == 31 ? repro::kFullMask : ((2u << lane) - 1u);
    const int start = 31 - __clz(heads & upto);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float z2 = __shfl_up_sync(repro::kFullMask, z, d);
      const float ov2 = __shfl_up_sync(repro::kFullMask, ov, d);
      const float un2 = __shfl_up_sync(repro::kFullMask, un, d);
      const float sx2 = __shfl_up_sync(repro::kFullMask, sx, d);
      const float mn2 = __shfl_up_sync(repro::kFullMask, mn, d);
      const float mx2 = __shfl_up_sync(repro::kFullMask, mx, d);
      if (lane - d >= start) {
        z += z2;
        ov += ov2;
        un += un2;
        sx += sx2;
        mn = fminf(mn, mn2);
        mx = fmaxf(mx, mx2);
      }
    }
    const int next = __shfl_down_sync(repro::kFullMask, row, 1);
    if (row >= 0 && (lane == 31 || next != row)) {  // last lane of its run
      if (z != 0.0f) atomicAdd(sums + row, z);
      if (ov != 0.0f) atomicAdd(sums + k + row, ov);
      if (un != 0.0f) atomicAdd(sums + 2 * k + row, un);
      if (sx != 0.0f) atomicAdd(sums + 3 * k + row, sx);
      if (mn != INFINITY) atomic_min_f32(vmin + row, mn);
      if (mx != -INFINITY) atomic_max_f32(vmax + row, mx);
    }
  }
}

}  // namespace

// hist (2K, m) and sums (4, K) = zero / overflow / underflow / summ rows,
// vmin / vmax (K,); weights and levels may be null (all 1 / all 0).
extern "C" int ddsketch_ingest(const float* values, const int* ids, const float* weights,
                               const int* levels, long long n, int k, int m, int offset,
                               int mapping, float multiplier, float min_indexable, float* hist,
                               float* sums, float* vmin, float* vmax, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(float) * 2 * size_t(k) * size_t(m), stream);
  if (err != cudaSuccess) return err;
  if (k > 0) {
    const int blocks = k < 256 * 1024 ? (k + 255) / 256 : 1024;
    init_stats_kernel<<<blocks, 256, 0, stream>>>(sums, vmin, vmax, k);
  }
  if (n > 0 && k > 0) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
    ingest_kernel<<<blocks, kThreads, 0, stream>>>(values, ids, weights, levels, n, k, m, offset,
                                                   mapping, multiplier, min_indexable, hist,
                                                   sums, vmin, vmax);
  }
  return cudaGetLastError();
}
