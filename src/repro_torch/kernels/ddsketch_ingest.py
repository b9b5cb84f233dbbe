"""Fused bank ingest on the card: ``csrc/ddsketch_ingest.cu`` and its
plain version.

``ddsketch_ingest_cuda`` launches the hand-written CUDA kernel that
replaces the JAX package's Pallas ``_ingest_kernel``: one pass over the
lanes yields the combined ``(2K, m)`` pos/neg histogram and the six per-row
``IngestStats``.  ``fused_ingest_ref`` (re-exported from ``ref``) is the
plain PyTorch version; the ``ops.fused_ingest`` front door takes it only
for tensors that lie on the CPU.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty`` (the C entry point clears them on the stream),
launches on PyTorch's current stream without synchronising, raises when
the launch reports a CUDA error, and counts the launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I32, I64, P
from repro_torch.kernels.ref import (
    _MAPPING_CODES,
    BucketSpec,
    IngestStats,
    f32,
    fused_ingest_ref,
)

__all__ = ["ddsketch_ingest_cuda", "fused_ingest_ref"]

NAME = "ddsketch_ingest"
_SIGNATURES = {
    "ddsketch_ingest": (
        P, P, P, P, I64, I32, I32, I32, I32, F32, F32, P, P, P, P, P,
    ),
}


def ddsketch_ingest_cuda(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    weights: torch.Tensor | None,
    levels: torch.Tensor | None,
    *,
    num_segments: int,
    spec: BucketSpec,
) -> tuple[torch.Tensor, IngestStats]:
    """``(hist (2K, m), IngestStats)`` from one kernel launch.

    ``values`` float32 and ``segment_ids`` int32 are contiguous ``(N,)``
    CUDA tensors; ``weights`` (float32) and ``levels`` (int32 per-lane
    collapse levels) are the same or None for all-ones / all-zeros.
    """
    if values.device.type != "cuda":
        raise ValueError(f"ddsketch_ingest_cuda needs CUDA tensors, got {values.device}")
    dev = values.device
    n = values.numel()
    k, m = int(num_segments), spec.num_buckets
    vp = _build.lane_ptr(values, torch.float32, "values", n, dev)
    sp = _build.lane_ptr(segment_ids, torch.int32, "segment_ids", n, dev)
    wp = None if weights is None else _build.lane_ptr(weights, torch.float32, "weights", n, dev)
    lp = None if levels is None else _build.lane_ptr(levels, torch.int32, "levels", n, dev)
    hist = torch.empty((2 * k, m), dtype=torch.float32, device=dev)
    sums = torch.empty((4, k), dtype=torch.float32, device=dev)
    vmin = torch.empty(k, dtype=torch.float32, device=dev)
    vmax = torch.empty(k, dtype=torch.float32, device=dev)
    lib = _build.load(NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.ddsketch_ingest(
            vp, sp, wp, lp, n, k, m, spec.offset, _MAPPING_CODES[spec.mapping],
            f32(spec.multiplier), f32(spec.min_indexable),
            hist.data_ptr(), sums.data_ptr(), vmin.data_ptr(), vmax.data_ptr(),
            _build.stream_of(values),
        )
    _build.check(lib, err, NAME)
    _build.count_launch(NAME)
    stats = IngestStats(
        zero=sums[0], overflow=sums[1], underflow=sums[2], summ=sums[3],
        vmin=vmin, vmax=vmax,
    )
    return hist, stats
