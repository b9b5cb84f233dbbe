// Fused bank query (DDSketch Algorithm 2 over every row and every q):
// per row, the (2m+1) line (neg reversed, zero, pos), its cumulative counts
// cum and its total n; per q, rank = q * max(n - 1, 0), idx = #{cum <= rank}
// clipped to [0, 2m], the estimate -table[L, m-1-idx] / 0 / table[L,
// idx-m-1] at the row's level L, clamped to [vmin, vmax]; q <= 0 answers
// vmin, q >= 1 vmax, an empty row NaN.
//
// Replaces: src/repro/kernels/bank_quantiles.py, _bankq_kernel (the Pallas
// TPU kernel behind bank_quantiles_pallas, whose body is
// ref._bank_quantiles_math).  Contract: the plain version
// repro_torch.kernels.ref.bank_quantiles_ref.
//
// What bounds it on an H100: memory.  The query must read both (K, m) count
// stores once (64 MiB at K = 4096, m = 2048); one scan of the line and one
// binary search per q are far below the card's rate.
//
// What the design does about it: a persistent grid (sized from the
// occupancy API) whose CTAs walk rows blockIdx.x, + gridDim.x, ...  Each
// thread holds its share of the next row's counts in registers (16-byte
// loads of both runs, or 4-byte loads when rows are not 16-byte aligned:
// an odd num_buckets, an offset view; a separate instantiation the launcher
// picks), started as soon as the current row is in shared memory, so they
// are in flight while the CTA scans and searches the current row.  (Staging
// rows by cp.async.bulk or 16-byte cp.async into a shared ring measured
// slower on the card than these plain loads.)  The registers cover 2048
// counts of each run; counts past that are read when the row is written.
// neg is loaded in its natural order and written reversed; counts of
// either dtype are converted to float32 as they are written.
//
// The line lies in shared memory as neg reversed at [0, m), zero at m,
// three zero pads at m+1..m+3 and pos at [m+4, 2m+4), so that both runs'
// 16-byte writes land on 16-byte boundaries.  One block scan (each thread
// a contiguous chunk of odd length, against bank conflicts; warp shuffles,
// then a cross-warp pass) turns it into inclusive cumulative counts in
// place; n is the scan's last element.  After one barrier thread qi
// answers q qi (looping for Q > 256) by an upper-bound binary search: the
// first index a whose cum exceeds rank.  The pads repeat cum[m], so a is
// never m+1..m+3, and a - 3 past them is the line index.  Bank counts are
// non-negative, so cum does not decrease and that index is exactly
// #{cum <= rank}, the JAX kernel's compare-and-count, with no per-q block
// reduction; the (K, Q) answers are stored coalesced per row.  For
// integer-valued counts below 2^24 every sum is exact, so the answers
// equal the plain version bit for bit; fractional counts may round
// differently in n and cum, and a rank at a bucket boundary may then pick
// the neighbour.
#include "common.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kHeld = 8;                    // counts of each run a thread holds
constexpr int kHeldRun = kHeld * kThreads;  // counts of each run held in registers
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T>
__device__ __forceinline__ float count_of(unsigned word) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(word);  // float32 counts
  } else {
    return static_cast<float>(static_cast<int>(word));  // int32 counts
  }
}

// One row as the registers hold it: raw count words of both runs and the
// row's zero count, extrema and level.
struct Row {
  unsigned neg[kHeld], pos[kHeld];
  unsigned zero, vmin, vmax, level;
};

// Start the loads of row r.  kVec: thread t holds counts [4t, 4t+4) and
// [1024 + 4t, 1024 + 4t + 4) of each run (16-byte loads); else counts
// t + 256 u, u < 8.  Either way a warp's loads are coalesced.
template <bool kVec>
__device__ __forceinline__ void load_row(const unsigned* pos, const unsigned* neg,
                                         const unsigned* zero, const unsigned* vmin,
                                         const unsigned* vmax, const unsigned* level, int r,
                                         int m, Row& g) {
  const unsigned* nrow = neg + static_cast<long long>(r) * m;
  const unsigned* prow = pos + static_cast<long long>(r) * m;
  const int held = min(m, kHeldRun);
  if constexpr (kVec) {
#pragma unroll
    for (int u = 0; u < kHeld / 4; ++u) {
      const int v = threadIdx.x + u * kThreads;
      if (4 * v < held) {
        const uint4 a = __ldcs(reinterpret_cast<const uint4*>(nrow) + v);
        const uint4 b = __ldcs(reinterpret_cast<const uint4*>(prow) + v);
        g.neg[4 * u] = a.x, g.neg[4 * u + 1] = a.y, g.neg[4 * u + 2] = a.z, g.neg[4 * u + 3] = a.w;
        g.pos[4 * u] = b.x, g.pos[4 * u + 1] = b.y, g.pos[4 * u + 2] = b.z, g.pos[4 * u + 3] = b.w;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kHeld; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < held) {
        g.neg[u] = __ldcs(nrow + i);
        g.pos[u] = __ldcs(prow + i);
      }
    }
  }
  g.zero = zero[r];
  g.vmin = vmin[r];
  g.vmax = vmax[r];
  g.level = level[r];
}

// Write row r (held in g) into the line as float32; counts past the
// registers' share are read here.
template <typename T, bool kVec>
__device__ __forceinline__ void write_row(const Row& g, const unsigned* pos, const unsigned* neg,
                                          int r, int m, float* line) {
  const int held = min(m, kHeldRun);
  if constexpr (kVec) {
#pragma unroll
    for (int u = 0; u < kHeld / 4; ++u) {
      const int v = threadIdx.x + u * kThreads;
      if (4 * v < held) {
        const unsigned* a = g.neg + 4 * u;
        const unsigned* b = g.pos + 4 * u;
        // neg counts 4v..4v+3 sit at m-1-4v .. m-4-4v, so reversed
        *reinterpret_cast<float4*>(line + m - 4 - 4 * v) =
            make_float4(count_of<T>(a[3]), count_of<T>(a[2]), count_of<T>(a[1]),
                        count_of<T>(a[0]));
        *reinterpret_cast<float4*>(line + m + 4 + 4 * v) =
            make_float4(count_of<T>(b[0]), count_of<T>(b[1]), count_of<T>(b[2]),
                        count_of<T>(b[3]));
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kHeld; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < held) {
        line[m - 1 - i] = count_of<T>(g.neg[u]);
        line[m + 4 + i] = count_of<T>(g.pos[u]);
      }
    }
  }
  for (int i = kHeldRun + threadIdx.x; i < m; i += kThreads) {
    line[m - 1 - i] = count_of<T>(neg[static_cast<long long>(r) * m + i]);
    line[m + 4 + i] = count_of<T>(pos[static_cast<long long>(r) * m + i]);
  }
  if (threadIdx.x < 4) line[m + threadIdx.x] = threadIdx.x == 0 ? count_of<T>(g.zero) : 0.0f;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
bank_quantiles_kernel(const unsigned* __restrict__ pos, const unsigned* __restrict__ neg,
                      const unsigned* __restrict__ zero, const unsigned* __restrict__ vmin,
                      const unsigned* __restrict__ vmax, const unsigned* __restrict__ level,
                      const float* __restrict__ qs, int nq, const float* __restrict__ table,
                      int num_levels, int k, int m, float* __restrict__ out) {
  extern __shared__ __align__(16) float line[];  // 2m + 4
  __shared__ float scratch[kThreads / 32];
  const int len = 2 * m + 4;
  // an odd chunk length keeps the strided shared reads and writes of the
  // scan free of bank conflicts
  const int chunk = ((len + kThreads - 1) / kThreads) | 1;
  const int lo = min(static_cast<int>(threadIdx.x) * chunk, len);
  const int hi = min(lo + chunk, len);
  const float q_own = threadIdx.x < nq ? qs[threadIdx.x] : 0.0f;

  Row g;
  if (static_cast<int>(blockIdx.x) < k)
    load_row<kVec>(pos, neg, zero, vmin, vmax, level, blockIdx.x, m, g);
  for (int r = blockIdx.x; r < k; r += gridDim.x) {
    __syncthreads();  // the last row's searches are done with the line
    write_row<T, kVec>(g, pos, neg, r, m, line);
    const float lo_v = __uint_as_float(g.vmin), hi_v = __uint_as_float(g.vmax);
    const int lev = min(max(static_cast<int>(g.level), 0), num_levels - 1);
    __syncthreads();
    // the next row's loads fly while this row is scanned and searched
    if (r + static_cast<int>(gridDim.x) < k)
      load_row<kVec>(pos, neg, zero, vmin, vmax, level, r + gridDim.x, m, g);
    float part = 0.0f;
    for (int j = lo; j < hi; ++j) part += line[j];
    float run = repro::block_exclusive_scan(part, scratch);
    for (int j = lo; j < hi; ++j) {
      run += line[j];
      line[j] = run;
    }
    __syncthreads();  // cum is complete
    const float n = line[len - 1];
    const float nm1 = fmaxf(n - 1.0f, 0.0f);
    const float* vals = table + static_cast<long long>(lev) * m;
    for (int qi = threadIdx.x; qi < nq; qi += kThreads) {
      const float q = qi == threadIdx.x ? q_own : qs[qi];
      const float rank = __fmul_rn(q, nm1);
      int a = 0, b = len;  // upper bound of rank in line[0, 2m + 4)
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (line[mid] <= rank) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      const int idx = min(a > m ? a - 3 : a, 2 * m);
      float est = idx == m ? 0.0f : (idx < m ? -vals[m - 1 - idx] : vals[idx - m - 1]);
      est = fminf(fmaxf(est, lo_v), hi_v);  // exact-extrema clamp
      if (q <= 0.0f) {
        est = lo_v;
      } else if (q >= 1.0f) {
        est = hi_v;
      }
      out[static_cast<long long>(r) * nq + qi] = n > 0.0f ? est : NAN;
    }
  }
}

template <typename T, bool kVec>
int launch(const T* pos, const T* neg, const T* zero, const float* vmin, const float* vmax,
           const int* level, const float* qs, int nq, const float* table, int num_levels, int k,
           int m, float* out, void* stream_handle) {
  const auto kernel = bank_quantiles_kernel<T, kVec>;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(m) + 4);
  if (smem > kMaxSmem - 1024) return cudaErrorInvalidValue;
  cudaError_t err = repro::allow_smem(kernel, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(k < resident ? k : resident);
  const auto words = [](const void* p) { return static_cast<const unsigned*>(p); };
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream_handle)>>>(
      words(pos), words(neg), words(zero), words(vmin), words(vmax), words(level), qs, nq, table,
      num_levels, k, m, out);
  return cudaGetLastError();
}

// Rows take 16-byte loads when every row of both runs starts on a 16-byte
// boundary, else 4-byte loads.
template <typename T>
int dispatch(const T* pos, const T* neg, const T* zero, const float* vmin, const float* vmax,
             const int* level, const float* qs, int nq, const float* table, int num_levels, int k,
             int m, float* out, void* stream) {
  if (k <= 0 || nq <= 0) return cudaSuccess;
  if (m <= 0) return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  if (m % 4 == 0 && aligned(pos) && aligned(neg))
    return launch<T, true>(pos, neg, zero, vmin, vmax, level, qs, nq, table, num_levels, k, m,
                           out, stream);
  return launch<T, false>(pos, neg, zero, vmin, vmax, level, qs, nq, table, num_levels, k, m,
                          out, stream);
}

}  // namespace

// pos / neg (K, m), zero (K,) of one counts dtype; vmin / vmax (K,) float32,
// level (K,) int32, qs (Q,) float32, table (num_levels, m) float32; out (K, Q).
// Rows need only the counts' own 4-byte alignment.
extern "C" int bank_quantiles_f32(const float* pos, const float* neg, const float* zero,
                                  const float* vmin, const float* vmax, const int* level,
                                  const float* qs, int nq, const float* table, int num_levels,
                                  int k, int m, float* out, void* stream) {
  return dispatch<float>(pos, neg, zero, vmin, vmax, level, qs, nq, table, num_levels, k, m, out,
                         stream);
}

extern "C" int bank_quantiles_i32(const int* pos, const int* neg, const int* zero,
                                  const float* vmin, const float* vmax, const int* level,
                                  const float* qs, int nq, const float* table, int num_levels,
                                  int k, int m, float* out, void* stream) {
  return dispatch<int>(pos, neg, zero, vmin, vmax, level, qs, nq, table, num_levels, k, m, out,
                       stream);
}
