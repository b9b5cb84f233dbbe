// Fused bank ingest, in place: bucketize every lane, add its weight into the
// bank's pos / neg (K, m) histograms, and fold it into the bank's six per-
// row statistics (zero / overflow / underflow weight, sum of w*x, min x,
// max x over lanes with w > 0), in one pass over the lanes.  The delta form
// (a fresh histogram and fresh stats) is the same kernel run on outputs the
// caller zeroed (+inf / -inf for the extrema).
//
// Replaces: src/repro/kernels/ddsketch_ingest.py, _ingest_kernel (the
// Pallas TPU kernel behind ddsketch_ingest_pallas).  Contract: the plain
// version repro_torch.kernels.ref.fused_ingest_ref, followed by the bank's
// adds for the in-place form.
//
// What bounds it on an H100: memory.  Per lane it reads 12 bytes (value,
// id, level; 16 with a weight) and does a few dozen float/int operations,
// far below the card's 67 TFLOP/s float32 rate; each distinct histogram
// sector the lanes touch is read and written once (about 248k sectors for
// 2^20 Pareto lanes over K = 4096 rows), and the K-row stat leaves once.
// Contention on hot buckets (one key's lanes landing in the same few
// buckets) serialises atomics in L2.
//
// What the design does about it: the TPU kernel kept all 2K rows resident
// in VMEM and binned with one-hot matmuls on the MXU (the TPU has no fast
// scatter).  Here the lanes add straight into the bank, so no histogram is
// cleared and no second pass adds it in.  A persistent grid (the SM count
// times the resident blocks per SM) walks the lanes in chunks of 1024;
// each thread loads four consecutive lanes 16 bytes at a time (a masked
// scalar tail) and handles them in four steps, so in each step a warp
// holds 32 lanes in stream order.  record_batches lays a key's lanes out
// contiguously and Zipf-popular keys fill whole chunks, whose Pareto
// latencies crowd into a few buckets of one row: so the row of a chunk's
// first lane is privatised in shared memory.  Its lanes add into a
// shared (2, m) histogram and its run stats into six shared cells; after
// the chunk, the first lane of each touched bin takes the bin's total
// (atomicExch, which also clears it) and makes the one global atomicAdd,
// and one thread folds the six stats into the bank.  Lanes of other rows
// group with the lanes of their warp step that share their (sign, row,
// bucket) address (__match_any_sync); the group's lowest lane sums the
// group's weights in lane order and makes the one atomicAdd.  The six
// statistics go through a segmented warp reduction over runs of equal row
// id and one atomic per run (into shared memory for the private row).
// Extrema use integer atomics on the float bits (atomicMin/atomicMax on
// the sign-split bit patterns), which order -0.0 below +0.0; callers
// compare them numerically.
//
// Bit-exactness: the bucket key comes from bucket_key.cuh, shared with the
// histogram kernels (no contracted FMAs, the same logf as torch.log).
// Histograms and counters are exact for integer-valued weights; summ and
// fractional weights depend on the atomic order.
#include "bucket_key.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerThread = 4;

struct Outputs {
  float* pos;  // (K, m)
  float* neg;  // (K, m)
  float* zero;
  float* overflow;
  float* underflow;
  float* summ;
  float* vmin;
  float* vmax;  // each (K,)
};

// Float min / max through integer atomics on the float's own storage (a
// global or shared address): non-negative floats order like signed ints,
// negative ones in reverse like unsigned ints.
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

// The six row stats of a run, added into one row's cells.
__device__ __forceinline__ void add_stats(float* zero, float* over, float* under, float* summ,
                                          float* vmin, float* vmax, float z, float ov, float un,
                                          float sx, float mn, float mx) {
  if (z != 0.0f) atomicAdd(zero, z);
  if (ov != 0.0f) atomicAdd(over, ov);
  if (un != 0.0f) atomicAdd(under, un);
  if (sx != 0.0f) atomicAdd(summ, sx);
  if (mn != INFINITY) atomic_min_f32(vmin, mn);
  if (mx != -INFINITY) atomic_max_f32(vmax, mx);
}

// Key: the (sign, row, bucket) address type, int while 2 K m < 2^31.
template <typename Key>
__global__ void __launch_bounds__(kThreads)
ingest_kernel(const float* __restrict__ values, const int* __restrict__ ids,
              const float* __restrict__ weights, const int* __restrict__ levels, long long n,
              int k, int m, int offset, int mapping, float multiplier, float min_indexable,
              int vec, Outputs o) {
  extern __shared__ float s_hist[];  // (2, m) of the private row, then its six stats
  float* s_stats = s_hist + 2 * m;
  __shared__ int s_row;
  const int lane = threadIdx.x & 31;
  const int top_key = offset + m - 1;
  const Key km = static_cast<Key>(k) * m;
  const long long per_block = static_cast<long long>(kThreads) * kLanesPerThread;
  const long long stride = static_cast<long long>(gridDim.x) * per_block;
  for (int i = threadIdx.x; i < 2 * m; i += kThreads) s_hist[i] = 0.0f;
  if (threadIdx.x == 0) {
    s_stats[0] = s_stats[1] = s_stats[2] = s_stats[3] = 0.0f;
    s_stats[4] = INFINITY;
    s_stats[5] = -INFINITY;
  }
  // the loop bound is uniform over the block, so every thread reaches the
  // barriers and every lane of a warp the warp intrinsics below; lanes past
  // n act as invalid lanes
  for (long long base = blockIdx.x * per_block; base < n; base += stride) {
    const long long first = base + static_cast<long long>(threadIdx.x) * kLanesPerThread;
    float xs[kLanesPerThread], ws[kLanesPerThread];
    int ss[kLanesPerThread], ls[kLanesPerThread];
    if (vec && first + kLanesPerThread <= n) {
      const float4 x4 = *reinterpret_cast<const float4*>(values + first);
      const int4 s4 = *reinterpret_cast<const int4*>(ids + first);
      xs[0] = x4.x, xs[1] = x4.y, xs[2] = x4.z, xs[3] = x4.w;
      ss[0] = s4.x, ss[1] = s4.y, ss[2] = s4.z, ss[3] = s4.w;
      if (weights != nullptr) {
        const float4 w4 = *reinterpret_cast<const float4*>(weights + first);
        ws[0] = w4.x, ws[1] = w4.y, ws[2] = w4.z, ws[3] = w4.w;
      } else {
        ws[0] = ws[1] = ws[2] = ws[3] = 1.0f;
      }
      if (levels != nullptr) {
        const int4 l4 = *reinterpret_cast<const int4*>(levels + first);
        ls[0] = l4.x, ls[1] = l4.y, ls[2] = l4.z, ls[3] = l4.w;
      } else {
        ls[0] = ls[1] = ls[2] = ls[3] = 0;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kLanesPerThread; ++q) {
        const long long i = first + q;
        const bool in = i < n;
        xs[q] = in ? values[i] : NAN;
        ss[q] = in ? ids[i] : -1;
        ws[q] = in && weights != nullptr ? weights[i] : 1.0f;
        ls[q] = in && levels != nullptr ? levels[i] : 0;
      }
    }
    // the chunk's private row: the row of its first lane, if that is valid
    if (threadIdx.x == 0) s_row = isfinite(xs[0]) && ss[0] >= 0 && ss[0] < k ? ss[0] : -1;
    __syncthreads();
    const int prow = s_row;
    int bins[kLanesPerThread];  // shared bins this thread's private lanes touched
#pragma unroll
    for (int q = 0; q < kLanesPerThread; ++q) {
      const float x = xs[q];
      const float w = ws[q];
      int row = -1;
      Key bucket = -1;  // (sign, row, bucket) as an index into pos ++ neg
      bins[q] = -1;
      float z = 0.0f, ov = 0.0f, un = 0.0f, sx = 0.0f;
      float mn = INFINITY, mx = -INFINITY;
      if (isfinite(x) && ss[q] >= 0 && ss[q] < k) {
        row = ss[q];
        const bool is_pos = x > min_indexable;
        const bool is_neg = x < -min_indexable;
        if (is_pos || is_neg) {
          const int k_lev =
              repro::level_key(fabsf(x), mapping, multiplier, repro::clamp_level(ls[q]));
          if (k_lev > top_key) ov = w;
          if (k_lev < offset) un = w;
          const int b = repro::bucket_of(k_lev, offset, m);
          if (row == prow) {
            bins[q] = (is_neg ? m : 0) + b;
            atomicAdd(s_hist + bins[q], w);
          } else {
            bucket = (is_neg ? km : 0) + static_cast<Key>(row) * m + b;
          }
        } else {
          z = w;
        }
        sx = __fmul_rn(w, x);
        if (w > 0.0f) {
          mn = x;
          mx = x;
        }
      }
      // other rows: one atomic per distinct address in the warp step, from
      // the group's lowest lane, over the group's weights in lane order
      const unsigned peers = __match_any_sync(repro::kFullMask, bucket);
      if (bucket >= 0) {
        float total = 0.0f;
        for (unsigned rest = peers; rest != 0u; rest &= rest - 1u)
          total += __shfl_sync(peers, w, __ffs(rest) - 1);
        if (lane == __ffs(peers) - 1)
          atomicAdd(bucket < km ? o.pos + bucket : o.neg + (bucket - km), total);
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
        if (row == prow) {
          add_stats(s_stats, s_stats + 1, s_stats + 2, s_stats + 3, s_stats + 4, s_stats + 5, z,
                    ov, un, sx, mn, mx);
        } else {
          add_stats(o.zero + row, o.overflow + row, o.underflow + row, o.summ + row,
                    o.vmin + row, o.vmax + row, z, ov, un, sx, mn, mx);
        }
      }
    }
    __syncthreads();
    // flush the private row: the first lane to reach a bin takes its total
    // and clears it; the shared histogram is all zeros again afterwards
    const long long prow_off = static_cast<long long>(prow) * m;
#pragma unroll
    for (int q = 0; q < kLanesPerThread; ++q) {
      if (bins[q] >= 0) {
        const float total = atomicExch(s_hist + bins[q], 0.0f);
        if (total != 0.0f) {
          float* dst = bins[q] < m ? o.pos + prow_off + bins[q] : o.neg + prow_off + (bins[q] - m);
          atomicAdd(dst, total);
        }
      }
    }
    if (threadIdx.x == 0 && prow >= 0) {
      add_stats(o.zero + prow, o.overflow + prow, o.underflow + prow, o.summ + prow,
                o.vmin + prow, o.vmax + prow, s_stats[0], s_stats[1], s_stats[2], s_stats[3],
                s_stats[4], s_stats[5]);
      s_stats[0] = s_stats[1] = s_stats[2] = s_stats[3] = 0.0f;
      s_stats[4] = INFINITY;
      s_stats[5] = -INFINITY;
    }
    __syncthreads();
  }
}

template <typename Key>
int launch(const float* values, const int* ids, const float* weights, const int* levels,
           long long n, int k, int m, int offset, int mapping, float multiplier,
           float min_indexable, int vec, const Outputs& o, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(m) + 6);
  cudaError_t err = repro::allow_smem(ingest_kernel<Key>, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ingest_kernel<Key>, kThreads,
                                                        smem);
  if (err != cudaSuccess) return err;
  const long long per_block = static_cast<long long>(kThreads) * kLanesPerThread;
  const long long want = (n + per_block - 1) / per_block;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(want < resident ? want : resident);
  ingest_kernel<Key><<<blocks, kThreads, smem, stream>>>(
      values, ids, weights, levels, n, k, m, offset, mapping, multiplier, min_indexable, vec, o);
  return cudaGetLastError();
}

}  // namespace

// Adds n lanes into pos / neg ((K, m) float32 each) and the (K,) float32
// stat leaves zero, overflow, underflow, summ, vmin, vmax.  weights and
// levels may be null (all 1 / all 0); vec says that every lane pointer is
// 16-byte aligned.
extern "C" int ddsketch_ingest(const float* values, const int* ids, const float* weights,
                               const int* levels, long long n, int k, int m, int offset,
                               int mapping, float multiplier, float min_indexable, int vec,
                               float* pos, float* neg, float* zero, float* overflow,
                               float* underflow, float* summ, float* vmin, float* vmax,
                               void* stream_handle) {
  if (n <= 0 || k <= 0) return cudaSuccess;
  const Outputs o{pos, neg, zero, overflow, underflow, summ, vmin, vmax};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (2LL * k * m < (1LL << 31))
    return launch<int>(values, ids, weights, levels, n, k, m, offset, mapping, multiplier,
                       min_indexable, vec, o, stream);
  return launch<long long>(values, ids, weights, levels, n, k, m, offset, mapping, multiplier,
                           min_indexable, vec, o, stream);
}
