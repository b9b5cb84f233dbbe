// Fused bank query (DDSketch Algorithm 2 over every row and every q):
// per row, the (2m+1) line (neg reversed, zero, pos), its total n and its
// cumulative counts; per q, rank = q * max(n - 1, 0), idx = #{cum <= rank}
// clipped to [0, 2m], the estimate -table[L, m-1-idx] / 0 / table[L,
// idx-m-1] at the row's level L, clamped to [vmin, vmax]; q <= 0 answers
// vmin, q >= 1 vmax, an empty row NaN.
//
// Replaces: src/repro/kernels/bank_quantiles.py, _bankq_kernel (the Pallas
// TPU kernel behind bank_quantiles_pallas).  Contract: the plain version
// repro_torch.kernels.ref.bank_quantiles_ref.
//
// What bounds it on an H100: memory.  The query must read both (K, m)
// count stores once (64 MiB at K = 4096, m = 2048); the scan and the Q
// rank counts are about (2 + Q) operations per line element, well below
// the card's float32 rate.
//
// What the design does about it: the TPU kernel materialised a row tile's
// line, cumsum and a one-hot value select in VMEM.  Here one block owns a
// row: it reads the row once into shared memory (16 KiB at m = 2048), takes
// n by a block reduction and the cumulative counts by a block scan in
// place (each thread scans a contiguous chunk, the chunk totals are
// scanned across warps with shuffles), then answers every q off that one
// scan with a block-wide count of cum <= rank and a single table read.
// Counts of either dtype are read as float32.  For integer-valued counts
// below 2^24 every sum is exact, so the answers equal the plain version
// bit for bit; fractional counts may round differently in n and cum.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 65535;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bank_quantiles_kernel(const T* __restrict__ pos, const T* __restrict__ neg,
                      const T* __restrict__ zero, const float* __restrict__ vmin,
                      const float* __restrict__ vmax, const int* __restrict__ level,
                      const float* __restrict__ qs, int nq, const float* __restrict__ table,
                      int num_levels, int k, int m, float* __restrict__ out) {
  extern __shared__ float line[];  // 2m + 1 floats
  __shared__ float fscratch[kWarps + 1];
  __shared__ int iscratch[kWarps + 1];
  const int len = 2 * m + 1;
  const int per = (len + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < len ? lo + per : len;
  for (int r = blockIdx.x; r < k; r += gridDim.x) {
    const T* prow = pos + static_cast<long long>(r) * m;
    const T* nrow = neg + static_cast<long long>(r) * m;
    float part = 0.0f;
    for (int j = threadIdx.x; j < len; j += kThreads) {
      float v;
      if (j < m) {
        v = static_cast<float>(nrow[m - 1 - j]);
      } else if (j == m) {
        v = static_cast<float>(zero[r]);
      } else {
        v = static_cast<float>(prow[j - m - 1]);
      }
      line[j] = v;
      part += v;
    }
    const float n = repro::block_sum(part, fscratch);  // syncs: line is complete
    // inclusive scan of the line in place, one contiguous chunk per thread
    float run = 0.0f;
    for (int j = lo; j < hi; ++j) run += line[j];
    run = repro::block_exclusive_scan(run, fscratch);
    for (int j = lo; j < hi; ++j) {
      run += line[j];
      line[j] = run;
    }
    __syncthreads();
    const float nm1 = fmaxf(n - 1.0f, 0.0f);
    const float lo_v = vmin[r];
    const float hi_v = vmax[r];
    int lev = level[r];
    lev = lev < 0 ? 0 : (lev > num_levels - 1 ? num_levels - 1 : lev);
    const float* vals = table + static_cast<long long>(lev) * m;
    for (int qi = 0; qi < nq; ++qi) {
      const float q = qs[qi];
      const float rank = __fmul_rn(q, nm1);
      int cnt = 0;
      for (int j = threadIdx.x; j < len; j += kThreads) cnt += line[j] <= rank ? 1 : 0;
      int idx = repro::block_sum(cnt, iscratch);
      idx = idx < 0 ? 0 : (idx > 2 * m ? 2 * m : idx);
      if (threadIdx.x == 0) {
        float est = idx < m ? -vals[m - 1 - idx] : (idx == m ? 0.0f : vals[idx - m - 1]);
        est = fminf(fmaxf(est, lo_v), hi_v);  // exact-extrema clamp
        if (q <= 0.0f) {
          est = lo_v;
        } else if (q >= 1.0f) {
          est = hi_v;
        }
        out[static_cast<long long>(r) * nq + qi] = n > 0.0f ? est : NAN;
      }
    }
    __syncthreads();  // line is rewritten for the next row
  }
}

template <typename T>
int launch(const T* pos, const T* neg, const T* zero, const float* vmin, const float* vmax,
           const int* level, const float* qs, int nq, const float* table, int num_levels, int k,
           int m, float* out, void* stream_handle) {
  if (k <= 0 || nq <= 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(m) + 1);
  cudaError_t err = repro::allow_smem(bank_quantiles_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = k < kMaxBlocks ? k : kMaxBlocks;
  bank_quantiles_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream_handle)>>>(
      pos, neg, zero, vmin, vmax, level, qs, nq, table, num_levels, k, m, out);
  return cudaGetLastError();
}

}  // namespace

// pos / neg (K, m), zero (K,) of one counts dtype; vmin / vmax (K,) float32,
// level (K,) int32, qs (Q,) float32, table (num_levels, m) float32; out (K, Q).
extern "C" int bank_quantiles_f32(const float* pos, const float* neg, const float* zero,
                                  const float* vmin, const float* vmax, const int* level,
                                  const float* qs, int nq, const float* table, int num_levels,
                                  int k, int m, float* out, void* stream) {
  return launch<float>(pos, neg, zero, vmin, vmax, level, qs, nq, table, num_levels, k, m, out,
                       stream);
}

extern "C" int bank_quantiles_i32(const int* pos, const int* neg, const int* zero,
                                  const float* vmin, const float* vmax, const int* level,
                                  const float* qs, int nq, const float* table, int num_levels,
                                  int k, int m, float* out, void* stream) {
  return launch<int>(pos, neg, zero, vmin, vmax, level, qs, nq, table, num_levels, k, m, out,
                     stream);
}
