"""Single-sketch histogram on the card: ``csrc/ddsketch_hist.cu`` and its
plain version.

``histogram_cuda`` launches the hand-written CUDA kernels that replace the
JAX package's Pallas ``_hist_kernel``: ``bin_rows`` bins ``(N,)`` lanes
with per-lane collapse levels into one partial ``(m,)`` row per CTA,
through warp-merged shared atomics into per-CTA copies of the row, and
``sum_rows`` adds the partial rows in a second launch on the same stream.
``histogram_ref`` (re-exported from ``ref``) is the plain PyTorch version;
the ``ops.ddsketch_histogram`` front door takes it only for tensors that
lie on the CPU.

Scratch: the ``(2 * SMs, m)`` float32 partial rows come from PyTorch's
caching allocator on every call (the first launch writes the rows it
uses in full, so they need no clearing).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I32, I64, P
from repro_torch.kernels.ref import _MAPPING_CODES, BucketSpec, f32, histogram_ref

__all__ = ["bin_rows", "histogram_cuda", "histogram_ref", "sum_rows"]

NAME = "ddsketch_hist"
_SIGNATURES = {
    "ddsketch_hist_bin": (P, P, P, I64, I32, I32, I32, F32, F32, P, I32, P, P),
    "ddsketch_hist_sum": (P, I32, I32, P, P),
}
_MAX_SMEM = 227 * 1024 - 1024  # dynamic shared memory one Hopper block may use


def bin_rows(
    values: torch.Tensor,
    weights: torch.Tensor | None,
    levels: torch.Tensor | None,
    *,
    spec: BucketSpec,
) -> torch.Tensor:
    """The first launch: ``(rows, m)`` float32 partial rows, one per CTA,
    whose column sums are the histogram.  ``values`` (float32) is a
    contiguous ``(N,)`` CUDA tensor; ``weights`` (float32) and ``levels``
    (int32) are the same or None for all-ones / all-zeros.  Any start
    alignment works."""
    if values.device.type != "cuda":
        raise ValueError(f"histogram_cuda needs CUDA tensors, got {values.device}")
    dev, n, m = values.device, values.numel(), spec.num_buckets
    if 4 * m > _MAX_SMEM:
        raise ValueError(f"a row of {m} buckets does not fit one block's shared memory")
    vp = _build.lane_ptr(values, torch.float32, "values", n, dev)
    wp = None if weights is None else _build.lane_ptr(weights, torch.float32, "weights", n, dev)
    lp = None if levels is None else _build.lane_ptr(levels, torch.int32, "levels", n, dev)
    # the grid is at most two CTAs per SM (kBlocksPerSm), one partial row each
    cap = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    partials = torch.empty((cap, m), dtype=torch.float32, device=dev)
    rows = ctypes.c_int(0)
    lib = _build.load(NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.ddsketch_hist_bin(
            vp, wp, lp, n, m, spec.offset, _MAPPING_CODES[spec.mapping],
            f32(spec.multiplier), f32(spec.min_indexable), partials.data_ptr(), cap,
            ctypes.addressof(rows), _build.stream_of(values),
        )
    _build.check(lib, err, NAME)
    return partials[: rows.value]


def sum_rows(partials: torch.Tensor) -> torch.Tensor:
    """The second launch: the ``(m,)`` float32 column sums of contiguous
    ``(rows, m)`` partial rows, the rows added in order."""
    rows, m = partials.shape
    out = torch.empty(m, dtype=torch.float32, device=partials.device)
    lib = _build.load(NAME, _SIGNATURES)
    with torch.cuda.device(partials.device):
        err = lib.ddsketch_hist_sum(partials.data_ptr(), rows, m, out.data_ptr(),
                                    _build.stream_of(partials))
    _build.check(lib, err, NAME)
    return out


def histogram_cuda(
    values: torch.Tensor,
    weights: torch.Tensor | None,
    levels: torch.Tensor | None,
    *,
    spec: BucketSpec,
) -> torch.Tensor:
    """``(m,)`` float32 counts of ``(N,)`` CUDA lanes (see ``bin_rows``):
    the partial rows, then their sum, in two launches on the lanes'
    stream."""
    out = sum_rows(bin_rows(values, weights, levels, spec=spec))
    _build.count_launch(NAME)
    return out
