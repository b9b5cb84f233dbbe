// The bucket key of one value, shared by every binning kernel (fused
// ingest, segment histogram, single-row histogram), so their keys cannot
// drift apart.  Contract: repro_torch.kernels.ref.raw_keys / shift_key.
//
// The key is ceil(approx_log(|x|) * multiplier) with every product and sum
// of the interpolated mappings and the multiply by the float32 multiplier
// written as __fmul_rn / __fadd_rn, so nvcc cannot contract them into FMAs
// and move boundary lanes to the next bucket.  The "log" mapping calls
// logf, the same function torch.log runs on the card.
#pragma once

#include <math.h>

namespace repro {

// Mapping-specific monotone log: 0 = natural log, 1 = linear interpolation
// of the exponent bits, 2 = cubic interpolation.
__device__ __forceinline__ float approx_log(float x, int mapping) {
  if (mapping == 0) return logf(x);
  const int bits = __float_as_int(x);
  const int e = ((bits >> 23) & 0xFF) - 127;
  const float f = __fmul_rn(static_cast<float>(bits & 0x7FFFFF), 1.1920928955078125e-07f);
  if (mapping == 1) return __fadd_rn(static_cast<float>(e), f);
  // ((A f + B) f + C) f with the float32 roundings of 6/35, -3/5, 10/7
  const float a = static_cast<float>(6.0 / 35.0);
  const float b = static_cast<float>(-3.0 / 5.0);
  const float c = static_cast<float>(10.0 / 7.0);
  float p = __fadd_rn(__fmul_rn(a, f), b);
  p = __fadd_rn(__fmul_rn(p, f), c);
  p = __fmul_rn(p, f);
  return __fadd_rn(static_cast<float>(e), p);
}

// A per-lane collapse level as the shift takes it: shifts past 31 fill with
// the sign, as XLA's arithmetic shift does.
__device__ __forceinline__ int clamp_level(int level) { return min(max(level, 0), 31); }

// The collapse-level key of a positive magnitude: ceil(key0 / 2^level), with
// key0 = ceil(approx_log(mag) * multiplier).  `level` is already clamped.
__device__ __forceinline__ int level_key(float mag, int mapping, float multiplier, int level) {
  const float key = ceilf(__fmul_rn(approx_log(mag, mapping), multiplier));
  return -((-static_cast<int>(key)) >> level);
}

// Bucket index of a level key, clamped into [0, m).
__device__ __forceinline__ int bucket_of(int key, int offset, int m) {
  return min(max(key - offset, 0), m - 1);
}

}  // namespace repro
