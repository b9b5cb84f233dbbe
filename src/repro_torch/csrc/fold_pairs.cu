// One uniform-collapse fold (UDDSketch): bucket pairs with keys (2j-1, 2j)
// merge into key j on every selected row of a (K, m) count array,
// out[r, ceil((offset+i)/2) - offset] += counts[r, i].
//
// Replaces: src/repro/kernels/fold_pairs.py, _fold_kernel (the Pallas TPU
// kernel behind fold_pairs_pallas).  Contract: the plain version
// repro_torch.kernels.ref.fold_pairs_ref, plus sketch_bank.collapse's row
// mask: unselected rows keep their counts.
//
// What bounds it on an H100: memory.  A full fold reads and writes every
// count once (2 * 4 bytes per bucket) and does one add per bucket.
//
// What the design does about it: the TPU kernel built a one-hot (m, TB)
// fold matrix and contracted each row block against it on the MXU.  Here
// it is a gather with no atomics: one block per row stages the row in
// shared memory (m * 4 bytes, 8 KiB at m = 2048), then each thread writes
// destination j as the sum of its at most two sources
// i in {2(j+offset)-offset-1, 2(j+offset)-offset} within [0, m).  Staging
// the row lets the fold run in place (out == counts), and a row the mask
// does not select costs its block one byte read, so the reactive collapse
// after every ingest moves only the rows that fire.  Every destination sums
// at most two sources in a fixed order, (0 + a) + b, so float32 and int32
// results are exact and equal to the plain version bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_rows_kernel(const T* in, T* out, const uint8_t* rows, int k, int m, int offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* line = reinterpret_cast<T*>(smem_raw);
  for (int r = blockIdx.x; r < k; r += gridDim.x) {
    const T* src = in + static_cast<long long>(r) * m;
    T* dst = out + static_cast<long long>(r) * m;
    if (rows != nullptr && rows[r] == 0) {  // uniform over the block
      if (in != out) {
        for (int j = threadIdx.x; j < m; j += kThreads) dst[j] = src[j];
      }
      continue;
    }
    for (int j = threadIdx.x; j < m; j += kThreads) line[j] = src[j];
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const int i = 2 * (j + offset) - offset - 1;
      T acc = T(0);
      if (i >= 0 && i < m) acc += line[i];
      if (i + 1 >= 0 && i + 1 < m) acc += line[i + 1];
      dst[j] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* in, T* out, const uint8_t* rows, int k, int m, int offset,
           void* stream_handle) {
  if (k <= 0) return cudaSuccess;
  const size_t smem = sizeof(T) * static_cast<size_t>(m);
  cudaError_t err = repro::allow_smem(fold_rows_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = k < kMaxBlocks ? k : kMaxBlocks;
  fold_rows_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream_handle)>>>(
      in, out, rows, k, m, offset);
  return cudaGetLastError();
}

}  // namespace

// counts and out are (K, m) and may be the same array; rows is a (K,) byte
// mask or null (fold every row).
extern "C" int fold_pairs_f32(const float* counts, float* out, const uint8_t* rows, int k, int m,
                              int offset, void* stream) {
  return launch<float>(counts, out, rows, k, m, offset, stream);
}

extern "C" int fold_pairs_i32(const int* counts, int* out, const uint8_t* rows, int k, int m,
                              int offset, void* stream) {
  return launch<int>(counts, out, rows, k, m, offset, stream);
}
