"""Single-sketch histogram on the card: ``csrc/ddsketch_hist.cu`` and its
plain version.

``histogram_cuda`` launches the hand-written CUDA kernel that replaces the
JAX package's Pallas ``_hist_kernel``: ``(N,)`` lanes with per-lane
collapse levels bin into one ``(m,)`` row, through a per-block histogram
in shared memory.  ``histogram_ref`` (re-exported from ``ref``) is the
plain PyTorch version; the ``ops.ddsketch_histogram`` front door takes it
only for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I32, I64, P
from repro_torch.kernels.ref import _MAPPING_CODES, BucketSpec, f32, histogram_ref

__all__ = ["histogram_cuda", "histogram_ref"]

NAME = "ddsketch_hist"
_SIGNATURES = {"ddsketch_hist": (P, P, P, I64, I32, I32, I32, F32, F32, P, P)}
_MAX_SMEM = 227 * 1024  # dynamic shared memory one Hopper block may use


def histogram_cuda(
    values: torch.Tensor,
    weights: torch.Tensor | None,
    levels: torch.Tensor | None,
    *,
    spec: BucketSpec,
) -> torch.Tensor:
    """``(m,)`` float32 counts from one launch over contiguous ``(N,)`` CUDA
    ``values`` (float32); ``weights`` (float32) and ``levels`` (int32) are
    the same or None for all-ones / all-zeros."""
    if values.device.type != "cuda":
        raise ValueError(f"histogram_cuda needs CUDA tensors, got {values.device}")
    dev, n, m = values.device, values.numel(), spec.num_buckets
    if 4 * m > _MAX_SMEM:
        raise ValueError(f"a row of {m} buckets does not fit one block's shared memory")
    vp = _build.lane_ptr(values, torch.float32, "values", n, dev)
    wp = None if weights is None else _build.lane_ptr(weights, torch.float32, "weights", n, dev)
    lp = None if levels is None else _build.lane_ptr(levels, torch.int32, "levels", n, dev)
    out = torch.empty(m, dtype=torch.float32, device=dev)
    lib = _build.load(NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.ddsketch_hist(
            vp, wp, lp, n, m, spec.offset, _MAPPING_CODES[spec.mapping],
            f32(spec.multiplier), f32(spec.min_indexable), out.data_ptr(),
            _build.stream_of(values),
        )
    _build.check(lib, err, NAME)
    _build.count_launch(NAME)
    return out
