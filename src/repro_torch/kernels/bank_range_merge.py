"""Fused slice-range merge on the card: ``csrc/bank_range_merge.cu`` and its
plain version.

``bank_range_merge_cuda`` launches the hand-written CUDA kernel that
replaces the JAX package's Pallas ``_range_merge_kernel``: every slice row
of a ``(D, R, m)`` block folds by its per-row delta and the slice axis
sums into ``(R, m)``, with a negative delta marking a dead slice.
``bank_range_merge_ref`` (re-exported from ``ref``) is the plain PyTorch
version; the ``ops.bank_range_merge`` front door takes it only for tensors
that lie on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, P
from repro_torch.kernels.ref import BucketSpec, bank_range_merge_ref, fold_destination_range

__all__ = ["bank_range_merge_cuda", "bank_range_merge_ref"]

NAME = "bank_range_merge"
_SIGNATURES = {"bank_range_merge": (P, P, P, I32, I32, I32, I32, P)}


def bank_range_merge_cuda(
    counts: torch.Tensor, deltas: torch.Tensor, *, spec: BucketSpec
) -> torch.Tensor:
    """``(R, m)`` float32 from one launch over contiguous CUDA ``counts``
    (``(D, R, m)`` float32) and ``deltas`` (``(D, R)`` int32, at most
    ``MAX_COLLAPSE_LEVEL``; negative = dead slice)."""
    fold_destination_range(spec)
    if counts.device.type != "cuda":
        raise ValueError(f"bank_range_merge_cuda needs CUDA tensors, got {counts.device}")
    m = spec.num_buckets
    if counts.dtype != torch.float32 or counts.dim() != 3 or counts.shape[2] != m:
        raise ValueError(f"counts must be a float32 (D, R, {m}) tensor, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    d, r, _ = counts.shape
    if (
        deltas.dtype != torch.int32
        or tuple(deltas.shape) != (d, r)
        or deltas.device != counts.device
    ):
        raise ValueError(f"deltas must be an int32 ({d}, {r}) tensor on {counts.device}")
    if not (counts.is_contiguous() and deltas.is_contiguous()):
        raise ValueError("counts and deltas must be contiguous")
    out = torch.empty((r, m), dtype=torch.float32, device=counts.device)
    lib = _build.load(NAME, _SIGNATURES)
    with torch.cuda.device(counts.device):
        err = lib.bank_range_merge(
            counts.data_ptr(), deltas.data_ptr(), out.data_ptr(), d, r, m, spec.offset,
            _build.stream_of(counts),
        )
    _build.check(lib, err, NAME)
    _build.count_launch(NAME)
    return out
