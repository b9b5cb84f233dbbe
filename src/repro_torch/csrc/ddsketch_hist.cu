// Single-sketch histogram: out[bucket(x)] = sum of w over every finite lane
// with x > min_indexable, each keyed at its own collapse level; (N,) lanes
// -> (m,) counts.
//
// Replaces: src/repro/kernels/ddsketch_hist.py, _hist_kernel (the Pallas
// TPU kernel behind histogram_pallas).  Contract: the plain version
// repro_torch.kernels.ref.histogram_ref.
//
// What bounds it on an H100: memory, the lanes (value, level, weight: up to
// N * 12 bytes) read once and m * 4 bytes written.  Every lane lands in one
// row of m bins (8 KiB at m = 2048), and Pareto latencies or lanes at a high
// collapse level crowd a few dozen of them, so atomics on shared addresses
// are the hazard, and a grid too small to keep the lane loads in flight.
//
// What the design does about it:
// - A grid of up to two CTAs per SM (from the occupancy API, never more
//   than the lanes need) with grid-stride 16-byte loads of values, levels
//   and weights; a scalar pass takes the head before the first 16-byte
//   boundary and the tail (or every lane, when the three lane pointers do
//   not share their misalignment).
// - Each warp step groups its lanes by bucket with __match_any_sync; the
//   group's lowest lane adds the group's count (or its weights, summed in
//   lane order) with one shared atomic.  The CTA keeps one private copy of
//   the row per four warps, so hot bins do not serialise the whole CTA.
// - No global atomics and no memset: each CTA sums its copies in copy order
//   and writes its row with plain coalesced stores into a (grid, m) float32
//   scratch.  A second launch on the same stream sums the partial rows: one
//   CTA per 32 columns, its threads each adding a contiguous run of rows
//   (eight loads in flight), the runs then added in run order, and stores
//   the row into out.  It is a programmatic dependent launch: each binning
//   CTA signals once its row is stored, so the summing grid is scheduled
//   while the last binning CTAs finish, and it waits (griddepcontrol.wait)
//   until the binning grid has completed and its stores are visible.  The
//   stream orders the two launches, so no CTA waits on another CTA of its
//   own grid and neither grid needs co-residency.
// Integer weights below 2^24 (and no weights) sum exactly in any order, so
// the result equals the plain version bit for bit; fractional weights
// differ in the order of the sums only (shared atomics, then partial rows).
#include "bucket_key.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCopies = 4;      // one private row per four warps
constexpr int kBlocksPerSm = 2;
constexpr int kCols = 32;          // columns of one summing CTA
constexpr int kRuns = kThreads / kCols;  // runs of rows it adds apart
constexpr int kBatch = 8;          // partial-row loads in flight per summing thread
constexpr size_t kMaxSmem = 227 * 1024;

struct Lanes {
  const float* values;
  const float* weights;  // null: every lane weighs 1
  const int* levels;     // null: every lane at level 0
  long long n;
  long long head;  // scalar lanes before the 16-byte body
  long long nvec;  // 16-byte vectors of the body
};

struct Key {
  int m, offset, mapping;
  float multiplier, min_indexable;
};

// Warp-collective: every lane of the warp calls it once per step.
__device__ __forceinline__ void bin_lane(bool ok, float x, float w, int lev, const Key& key,
                                         bool weighted, float* copy) {
  int b = -1;
  if (ok && isfinite(x) && x > key.min_indexable)
    b = repro::bucket_of(
        repro::level_key(x, key.mapping, key.multiplier, repro::clamp_level(lev)), key.offset,
        key.m);
  const unsigned peers = __match_any_sync(repro::kFullMask, b);
  if (b >= 0) {
    float total = static_cast<float>(__popc(peers));
    if (weighted) {
      total = 0.0f;
      for (unsigned rest = peers; rest != 0u; rest &= rest - 1u)
        total += __shfl_sync(peers, w, __ffs(rest) - 1);
    }
    if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(copy + b, total);
  }
}

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

__device__ __forceinline__ int part(const int4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

__global__ void __launch_bounds__(kThreads)
bin_kernel(Lanes ln, Key key, int copies, float* __restrict__ partials) {
  extern __shared__ float bins[];  // copies * m
  const int m = key.m;
  for (int j = threadIdx.x; j < copies * m; j += kThreads) bins[j] = 0.0f;
  __syncthreads();
  const bool weighted = ln.weights != nullptr;
  float* copy = bins + ((threadIdx.x >> 5) / (kWarps / copies)) * m;
  const int lane = threadIdx.x & 31;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long warp0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x - lane;
  const float4* xv = reinterpret_cast<const float4*>(ln.values + ln.head);
  const float4* wv = reinterpret_cast<const float4*>(ln.weights + ln.head);
  const int4* lv = reinterpret_cast<const int4*>(ln.levels + ln.head);
  // the body: a warp-uniform grid-stride loop over 16-byte lane vectors
  for (long long v0 = warp0; v0 < ln.nvec; v0 += threads) {
    const long long v = v0 + lane;
    const bool ok = v < ln.nvec;
    const float4 x = ok ? xv[v] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 w = ok && weighted ? wv[v] : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    const int4 l = ok && ln.levels != nullptr ? lv[v] : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bin_lane(ok, part(x, c), part(w, c), part(l, c), key, weighted, copy);
  }
  // the head and the tail, one lane a thread
  const long long extra = ln.n - 4 * ln.nvec;
  for (long long e0 = warp0; e0 < extra; e0 += threads) {
    const long long e = e0 + lane;
    const bool ok = e < extra;
    const long long i = e < ln.head ? e : e + 4 * ln.nvec;
    bin_lane(ok, ok ? ln.values[i] : 0.0f, ok && weighted ? ln.weights[i] : 1.0f,
             ok && ln.levels != nullptr ? ln.levels[i] : 0, key, weighted, copy);
  }
  __syncthreads();
  float* row = partials + static_cast<long long>(blockIdx.x) * m;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    float s = bins[j];
    for (int c = 1; c < copies; ++c) s += bins[c * m + j];
    row[j] = s;
  }
  // the summing launch may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// out[c] = the sum of partials[b, c] over b < rows: CTA x takes columns
// [32x, 32x + 32); thread (run, c) adds run `run` of the rows in order, and
// the runs are added in run order.
__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const float* __restrict__ partials, int rows, int m, float* __restrict__ out) {
  __shared__ float run_sums[kRuns * kCols];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the binning grid is done
  const int c = blockIdx.x * kCols + threadIdx.x % kCols;
  const int run = threadIdx.x / kCols;
  const int rows_per = (rows + kRuns - 1) / kRuns;
  const int b0 = run * rows_per;
  const int len = max(0, min(rows - b0, rows_per));
  float s = 0.0f;
  if (c < m) {
    const float* src = partials + static_cast<long long>(b0) * m + c;
    for (int b = 0; b < len; b += kBatch) {  // kBatch independent loads, then the adds in order
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = b + u < len ? __ldcg(src + static_cast<long long>(b + u) * m) : 0.0f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s += v[u];
    }
  }
  run_sums[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < kCols && c < m) {
    for (int r = 1; r < kRuns; ++r) s += run_sums[r * kCols + threadIdx.x];
    out[c] = s;
  }
}

}  // namespace

// Bins (N,) lanes into per-CTA partial rows: partials is a (max_blocks, m)
// float32 scratch, of which the launch writes rows [0, *rows) in full.
// weights and levels may be null (all 1 / all 0).
extern "C" int ddsketch_hist_bin(const float* values, const float* weights, const int* levels,
                                 long long n, int m, int offset, int mapping, float multiplier,
                                 float min_indexable, float* partials, int max_blocks, int* rows,
                                 void* stream_handle) {
  if (n < 0 || m <= 0 || max_blocks <= 0) return cudaErrorInvalidValue;
  int copies = kMaxCopies;
  while (copies > 1 && sizeof(float) * copies * static_cast<size_t>(m) > kMaxSmem - 1024)
    copies /= 2;
  const size_t smem = sizeof(float) * copies * static_cast<size_t>(m);
  if (smem > kMaxSmem - 1024) return cudaErrorInvalidValue;
  cudaError_t err = repro::allow_smem(bin_kernel, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bin_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  // the 16-byte body starts where values reach a 16-byte boundary; weights
  // and levels must reach theirs at the same lane, else every lane is scalar
  const auto mis = [](const void* p) { return reinterpret_cast<unsigned long long>(p) & 15u; };
  long long head = static_cast<long long>((16u - mis(values)) & 15u) / 4;
  if (head > n) head = n;
  const bool co_aligned = (weights == nullptr || mis(weights + head) == 0) &&
                          (levels == nullptr || mis(levels + head) == 0);
  if (!co_aligned) head = n;
  const long long nvec = (n - head) / 4;
  const long long steps = n - 3 * nvec;  // vectors plus scalar lanes: one a thread
  const long long want = (steps + kThreads - 1) / kThreads;
  long long blocks = static_cast<long long>(sms) * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  if (blocks > want) blocks = want;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  const Lanes ln{values, weights, levels, n, head, nvec};
  const Key key{m, offset, mapping, multiplier, min_indexable};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  bin_kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(ln, key, copies, partials);
  *rows = static_cast<int>(blocks);
  return cudaGetLastError();
}

// out (m,) float32 = the column sums of the (rows, m) partial rows, as a
// programmatic dependent launch after the binning launch on the stream.
extern "C" int ddsketch_hist_sum(const float* partials, int rows, int m, float* out,
                                 void* stream_handle) {
  if (rows <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + kCols - 1) / kCols);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sum_rows_kernel, partials, rows, m, out);
}
