// Shared pieces of the repro_torch kernels: block reductions and the C
// error-string entry point every kernel library exports.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum of `v` over the block; every thread gets the total.  `scratch` holds
// at least (blockDim.x / 32 + 1) values and is free again on return.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    V t = lane < warps ? scratch[lane] : V(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFullMask, t, o);
    if (lane == 0) scratch[warps] = t;
  }
  __syncthreads();
  const V total = scratch[warps];
  __syncthreads();
  return total;
}

// Exclusive prefix sum of `v` in thread order over the block.  `scratch`
// holds at least blockDim.x / 32 values and is free again on return.
__device__ __forceinline__ float block_exclusive_scan(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float t = __shfl_up_sync(kFullMask, inc, d);
    if (lane >= d) inc += t;
  }
  float exc = __shfl_up_sync(kFullMask, inc, 1);
  if (lane == 0) exc = 0.0f;
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    float t = lane < warps ? scratch[lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(kFullMask, t, d);
      if (lane >= d) t += u;
    }
    if (lane < warps) scratch[lane] = t;  // inclusive prefix of warp totals
  }
  __syncthreads();
  const float base = warp > 0 ? scratch[warp - 1] : 0.0f;
  __syncthreads();
  return base + exc;
}

// Raise the dynamic shared-memory ceiling of `kernel` when `bytes` needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
