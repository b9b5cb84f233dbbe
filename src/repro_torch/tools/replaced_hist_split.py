"""Time the single-row histogram's replaced design phase by phase.

    python3 src/repro_torch/tools/replaced_hist_split.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
The port's first single-row histogram kernel (one block-private row in
shared memory per 8192 lanes, a global ``atomicAdd`` per non-zero bin per
block, a ``cudaMemsetAsync`` of the output before) was redesigned into
``csrc/ddsketch_hist.cu``.  This one-off measurement builds that design from
the source below, checks that it counts what the current kernel counts,
and times its memset, its binning, its binning with the flush, and all of
it apart, the way ``chip_smoke.py`` times kernels, on 2^20 of
``chip_smoke.ingest_lanes``' lanes (levels 0-6, no weights).  It prints the
card's name and power limit, then one JSON object of times in ms.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

REPLACED_HIST_SOURCE = r"""
#include "bucket_key.cuh"
#include "common.cuh"

namespace {
constexpr int kThreads = 512;
constexpr int kLanesPerBlock = 16 * kThreads;
constexpr int kMaxBlocks = 264;

__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ values, const int* __restrict__ levels, long long n, int m,
            int offset, int mapping, float multiplier, float min_indexable, int flush,
            float* __restrict__ out) {
  extern __shared__ float bins[];
  for (int j = threadIdx.x; j < m; j += kThreads) bins[j] = 0.0f;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float x = values[i];
    if (!(isfinite(x) && x > min_indexable)) continue;
    const int lev = repro::clamp_level(levels[i]);
    atomicAdd(bins + repro::bucket_of(repro::level_key(x, mapping, multiplier, lev), offset, m),
              1.0f);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float v = bins[j];
    if (flush && v != 0.0f) atomicAdd(out + j, v);
  }
}
}  // namespace

// mode 1: the memset alone; 2: the binning alone; 3: binning and flush; 4: all
extern "C" int replaced_hist(const float* values, const int* levels, long long n, int m,
                             int offset, int mapping, float multiplier, float min_indexable,
                             int mode, float* out, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (mode == 1 || mode == 4) {
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * size_t(m), stream);
    if (err != cudaSuccess || mode == 1) return err;
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(m);
  cudaError_t err = repro::allow_smem(hist_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long want = (n + kLanesPerBlock - 1) / kLanesPerBlock;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  hist_kernel<<<blocks, kThreads, smem, stream>>>(values, levels, n, m, offset, mapping,
                                                  multiplier, min_indexable, mode != 2, out);
  return cudaGetLastError();
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ddsketch_hist import histogram_cuda
    from repro_torch.kernels.ref import _MAPPING_CODES, BucketSpec, f32

    if not torch.cuda.is_available():
        print("replaced_hist_split: no CUDA device", file=sys.stderr)
        return 2
    spec = BucketSpec()
    x, _, lev, _ = cs.ingest_lanes(np.random.default_rng(cs.SEED), cs.TICK_LANES, cs.K)
    xt, lt = torch.from_numpy(x).to("cuda"), torch.from_numpy(lev).to("cuda")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "replaced_hist.cu"
    lib_path = _build.BUILD_DIR / "replaced_hist.so"
    src.write_text(REPLACED_HIST_SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib_path), str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).replaced_hist
    P, I32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, ctypes.c_longlong, I32, I32, I32, ctypes.c_float, ctypes.c_float, I32,
                   P, P]
    m = spec.num_buckets
    out = torch.empty(m, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(mode):
        err = fn(xt.data_ptr(), lt.data_ptr(), xt.numel(), m, spec.offset,
                 _MAPPING_CODES[spec.mapping], f32(spec.multiplier), f32(spec.min_indexable),
                 mode, out.data_ptr(), stream)
        cs.check(err == 0, f"replaced histogram: CUDA error {err}")

    run(4)
    cs.check(torch.equal(out, histogram_cuda(xt, None, lt, spec=spec)),
             "the replaced histogram counts other buckets than the kernel")
    times = {name: cs.time_ms(torch, lambda mode=mode: run(mode))
             for name, mode in (("memset", 1), ("bin", 2), ("bin_flush", 3), ("all", 4))}
    times["current_kernel"] = cs.time_ms(torch, lambda: histogram_cuda(xt, None, lt, spec=spec))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps({"replaced_design_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
