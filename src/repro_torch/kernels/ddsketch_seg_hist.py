"""Per-segment histogram on the card: ``csrc/ddsketch_seg_hist.cu`` and its
plain version.

``segment_histogram_cuda`` launches the hand-written CUDA kernel that
replaces the JAX package's Pallas ``_seg_hist_kernel``: ``(N,)`` lanes with
segment ids and per-lane collapse levels bin into ``(K, m)`` counts.
``segment_histogram_ref`` (re-exported from ``ref``) is the plain PyTorch
version; the ``ops.segment_histogram`` front door takes it only for
tensors that lie on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I32, I64, P
from repro_torch.kernels.ref import _MAPPING_CODES, BucketSpec, f32, segment_histogram_ref

__all__ = ["segment_histogram_cuda", "segment_histogram_ref"]

NAME = "ddsketch_seg_hist"
_SIGNATURES = {
    "ddsketch_seg_hist": (P, P, P, P, I64, I32, I32, I32, I32, F32, F32, P, P),
}


def segment_histogram_cuda(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    weights: torch.Tensor | None,
    levels: torch.Tensor | None,
    *,
    num_segments: int,
    spec: BucketSpec,
) -> torch.Tensor:
    """``(K, m)`` float32 counts from one launch.

    ``values`` float32 and ``segment_ids`` int32 are contiguous ``(N,)``
    CUDA tensors; ``weights`` (float32) and ``levels`` (int32 per-lane
    collapse levels) are the same or None for all-ones / all-zeros.
    """
    if values.device.type != "cuda":
        raise ValueError(f"segment_histogram_cuda needs CUDA tensors, got {values.device}")
    dev, n = values.device, values.numel()
    k, m = int(num_segments), spec.num_buckets
    vp = _build.lane_ptr(values, torch.float32, "values", n, dev)
    sp = _build.lane_ptr(segment_ids, torch.int32, "segment_ids", n, dev)
    wp = None if weights is None else _build.lane_ptr(weights, torch.float32, "weights", n, dev)
    lp = None if levels is None else _build.lane_ptr(levels, torch.int32, "levels", n, dev)
    out = torch.empty((k, m), dtype=torch.float32, device=dev)
    lib = _build.load(NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.ddsketch_seg_hist(
            vp, sp, wp, lp, n, k, m, spec.offset, _MAPPING_CODES[spec.mapping],
            f32(spec.multiplier), f32(spec.min_indexable), out.data_ptr(),
            _build.stream_of(values),
        )
    _build.check(lib, err, NAME)
    _build.count_launch(NAME)
    return out
