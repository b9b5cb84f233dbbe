"""Uniform-collapse fold on the card: ``csrc/fold_pairs.cu`` and its plain
version.

``fold_pairs_cuda`` launches the hand-written CUDA kernel that replaces the
JAX package's Pallas ``_fold_kernel``, with ``sketch_bank.collapse``'s row
mask fused in (unselected rows keep their counts) and an optional in-place
output.  ``fold_pairs_ref`` (re-exported from ``ref``) is the plain
PyTorch version; the ``ops.fold_pairs`` front door takes it only for
tensors that lie on the CPU.

The kernel is templated on float32 and int32 counts, both exact (every
destination sums at most two sources), so integer banks fold on the card
too; other dtypes raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, P
from repro_torch.kernels.ref import BucketSpec, fold_destination_range, fold_pairs_ref

__all__ = ["fold_pairs_cuda", "fold_pairs_ref"]

NAME = "fold_pairs"
_SIGNATURES = {
    "fold_pairs_f32": (P, P, P, I32, I32, I32, P),
    "fold_pairs_i32": (P, P, P, I32, I32, I32, P),
}
_ENTRY = {torch.float32: "fold_pairs_f32", torch.int32: "fold_pairs_i32"}
_MAX_SMEM = 227 * 1024  # dynamic shared memory one Hopper block may use


def fold_pairs_cuda(
    counts: torch.Tensor,
    *,
    spec: BucketSpec,
    rows: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fold the selected rows of contiguous ``(K, m)`` CUDA ``counts``.

    ``rows`` is a ``(K,)`` bool mask (None folds every row); ``out`` may be
    ``counts`` itself for an in-place fold, or None for a fresh tensor.
    """
    fold_destination_range(spec)
    if counts.device.type != "cuda":
        raise ValueError(f"fold_pairs_cuda needs CUDA tensors, got {counts.device}")
    if counts.dtype not in _ENTRY:
        raise TypeError(f"fold_pairs takes float32 or int32 counts, got {counts.dtype}")
    k, m = counts.shape
    if m != spec.num_buckets or not counts.is_contiguous():
        raise ValueError(f"counts must be a contiguous (K, {spec.num_buckets}) tensor")
    if m * counts.element_size() > _MAX_SMEM:
        raise ValueError(f"a row of {m} buckets does not fit one block's shared memory")
    if out is None:
        out = torch.empty_like(counts)
    elif (
        out.shape != counts.shape
        or out.dtype != counts.dtype
        or out.device != counts.device
        or not out.is_contiguous()
    ):
        raise ValueError("out must match counts in shape, dtype, device and layout")
    rp = None
    if rows is not None:
        if rows.dtype != torch.bool or rows.shape != (k,) or rows.device != counts.device:
            raise ValueError(f"rows must be a ({k},) bool tensor on {counts.device}")
        rp = rows.contiguous().data_ptr()
    lib = _build.load(NAME, _SIGNATURES)
    with torch.cuda.device(counts.device):
        err = getattr(lib, _ENTRY[counts.dtype])(
            counts.data_ptr(), out.data_ptr(), rp, k, m, spec.offset,
            _build.stream_of(counts),
        )
    _build.check(lib, err, NAME)
    _build.count_launch(NAME)
    return out
