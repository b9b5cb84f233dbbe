"""Fused bank ingest on the card: ``csrc/ddsketch_ingest.cu`` and its
plain version.

The hand-written CUDA kernel replaces the JAX package's Pallas
``_ingest_kernel``: one pass over the lanes adds each lane into the
``(K, m)`` pos / neg histograms and the six per-row ``IngestStats`` it is
given.  Two wrappers launch it:

* ``ddsketch_ingest_into_cuda`` -- in place, straight into a float32
  bank's leaves (what ``sketch_bank.add_impl`` runs);
* ``ddsketch_ingest_cuda`` -- the delta form, ``(hist (2K, m),
  IngestStats)``: the same kernel on freshly zeroed outputs (+inf / -inf
  for the extrema).

``fused_ingest_ref`` (re-exported from ``ref``) is the plain PyTorch
version of the delta form; the ``ops`` front doors take it only for
tensors that lie on the CPU.  The wrappers check device, dtype, shape and
contiguity, launch on PyTorch's current stream without synchronising,
raise when the launch reports a CUDA error, and count the launch.
"""

from __future__ import annotations

import math

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

__all__ = ["ddsketch_ingest_cuda", "ddsketch_ingest_into_cuda", "fused_ingest_ref"]

NAME = "ddsketch_ingest"
_SIGNATURES = {
    "ddsketch_ingest": (
        P, P, P, P, I64, I32, I32, I32, I32, F32, F32, I32, P, P, P, P, P, P, P, P, P,
    ),
}


def ddsketch_ingest_into_cuda(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    weights: torch.Tensor | None,
    levels: torch.Tensor | None,
    *,
    pos: torch.Tensor,
    neg: torch.Tensor,
    stats: IngestStats,
    spec: BucketSpec,
) -> None:
    """Add the lanes into ``pos`` / ``neg`` (contiguous float32 ``(K, m)``)
    and the six ``(K,)`` float32 ``stats`` leaves, in place, in one launch.

    ``values`` float32 and ``segment_ids`` int32 are contiguous ``(N,)``
    CUDA tensors; ``weights`` (float32) and ``levels`` (int32 per-lane
    collapse levels) are the same or None for all-ones / all-zeros.
    """
    if values.device.type != "cuda":
        raise ValueError(f"ddsketch_ingest_into_cuda needs CUDA tensors, got {values.device}")
    dev = values.device
    n = values.numel()
    k, m = pos.shape[0], spec.num_buckets
    lanes = [
        _build.lane_ptr(values, torch.float32, "values", n, dev),
        _build.lane_ptr(segment_ids, torch.int32, "segment_ids", n, dev),
        None if weights is None else _build.lane_ptr(weights, torch.float32, "weights", n, dev),
        None if levels is None else _build.lane_ptr(levels, torch.int32, "levels", n, dev),
    ]
    for name, t, shape in (("pos", pos, (k, m)), ("neg", neg, (k, m)),
                           *((f, leaf, (k,)) for f, leaf in zip(stats._fields, stats))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    vec = all(p is None or p % 16 == 0 for p in lanes)
    lib = _build.load(NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.ddsketch_ingest(
            *lanes, n, k, m, spec.offset, _MAPPING_CODES[spec.mapping],
            f32(spec.multiplier), f32(spec.min_indexable), int(vec),
            pos.data_ptr(), neg.data_ptr(), *(leaf.data_ptr() for leaf in stats),
            _build.stream_of(values),
        )
    _build.check(lib, err, NAME)
    _build.count_launch(NAME)


def ddsketch_ingest_cuda(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    weights: torch.Tensor | None,
    levels: torch.Tensor | None,
    *,
    num_segments: int,
    spec: BucketSpec,
) -> tuple[torch.Tensor, IngestStats]:
    """``(hist (2K, m), IngestStats)`` from one launch of the in-place
    kernel on freshly zeroed outputs (lanes as ``ddsketch_ingest_into_cuda``
    takes them)."""
    if values.device.type != "cuda":
        raise ValueError(f"ddsketch_ingest_cuda needs CUDA tensors, got {values.device}")
    dev = values.device
    k, m = int(num_segments), spec.num_buckets
    hist = torch.zeros((2 * k, m), dtype=torch.float32, device=dev)
    sums = torch.zeros((4, k), dtype=torch.float32, device=dev)
    stats = IngestStats(
        zero=sums[0], overflow=sums[1], underflow=sums[2], summ=sums[3],
        vmin=torch.full((k,), math.inf, dtype=torch.float32, device=dev),
        vmax=torch.full((k,), -math.inf, dtype=torch.float32, device=dev),
    )
    ddsketch_ingest_into_cuda(values, segment_ids, weights, levels, pos=hist[:k], neg=hist[k:],
                              stats=stats, spec=spec)
    return hist, stats
