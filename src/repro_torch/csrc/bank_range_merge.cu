// Fused slice-range merge of a window query: fold every slice row
// counts[d, r] by deltas[d, r] uniform-collapse levels and sum the slice
// axis, (D, R, m) -> (R, m).  A delta-level fold sends bucket i (key
// offset + i) to ceil((offset + i) / 2^delta) - offset; a negative delta
// marks a dead slice, which contributes nothing whatever its counts hold.
//
// Replaces: src/repro/kernels/bank_range_merge.py, _range_merge_kernel (the
// Pallas TPU kernel behind bank_range_merge_pallas).  Contract: the plain
// version repro_torch.kernels.ref.bank_range_merge_ref.
//
// What bounds it on an H100: memory.  Every live count is read once and
// every output written once, (live slices + 1) * R * m * 4 bytes (about
// 0.9 GB at D = 13, R = 8192, m = 2048), with one add per count read.
//
// What the design does about it: the TPU kernel built one one-hot (m, TB)
// fold matrix per level from iotas and contracted each slice row against
// all six on the MXU, visiting the slice axis as a sequential grid
// dimension.  Here it is a gather with no atomics and no matrices: one
// thread per output bucket (r, b) walks the slices in the fixed order
// d = 0..D-1.  A slice row at delta 0 adds counts[d, r, b]; at delta > 0
// the sources of b are the contiguous keys (t-1) 2^delta + 1 .. t 2^delta
// with t = b + offset, at most 64 buckets, clipped to [0, m).  The source
// runs of one row partition its buckets, so each count is read once; a
// warp covers 32 neighbouring buckets of one row, so the delta-0 reads and
// the writes coalesce and the per-row delta is a broadcast.  Every sum of
// integer-valued float32 counts below 2^24 is exact, so the result equals
// the plain version bit for bit; fractional counts differ in summation
// order only.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;
constexpr int kMaxDelta = 6;  // MAX_COLLAPSE_LEVEL

__global__ void __launch_bounds__(kThreads)
range_merge_kernel(const float* __restrict__ counts, const int* __restrict__ deltas,
                   float* __restrict__ out, int num_slices, int rows, int m, int offset) {
  const long long total = static_cast<long long>(rows) * m;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long o = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; o < total;
       o += stride) {
    const int r = static_cast<int>(o / m);
    const int b = static_cast<int>(o - static_cast<long long>(r) * m);
    const int t = b + offset;  // destination key
    float acc = 0.0f;
    for (int d = 0; d < num_slices; ++d) {
      const int delta = min(deltas[static_cast<long long>(d) * rows + r], kMaxDelta);
      if (delta < 0) continue;  // dead slice
      const float* row = counts + (static_cast<long long>(d) * rows + r) * m;
      if (delta == 0) {
        acc += row[b];
        continue;
      }
      // source keys (t-1) 2^delta + 1 .. t 2^delta, as bucket indices
      const int span = 1 << delta;
      const int lo = max((t - 1) * span + 1 - offset, 0);
      const int hi = min(t * span - offset, m - 1);
      for (int i = lo; i <= hi; ++i) acc += row[i];
    }
    out[o] = acc;
  }
}

}  // namespace

// counts (D, R, m) float32, deltas (D, R) int32 (negative = dead slice),
// out (R, m) float32.
extern "C" int bank_range_merge(const float* counts, const int* deltas, float* out,
                                int num_slices, int rows, int m, int offset,
                                void* stream_handle) {
  const long long total = static_cast<long long>(rows) * m;
  if (total <= 0) return cudaSuccess;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  range_merge_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream_handle)>>>(
      counts, deltas, out, num_slices, rows, m, offset);
  return cudaGetLastError();
}
