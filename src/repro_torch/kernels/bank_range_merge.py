"""Fused slice-range merge on the card: ``csrc/bank_range_merge.cu`` and its
plain version.

The hand-written CUDA kernel replaces the JAX package's Pallas
``_range_merge_kernel``: every slice row folds by its per-row delta and the
slice axis sums, with a negative delta marking a dead slice that is never
read.  It reads each slice row where it lies, so it has two wrappers:

* ``bank_range_merge_nodes_cuda`` -- the window query's form: D slab nodes
  picked by index out of the slab's ``pos`` and ``neg`` stores, plus the
  live bank's, both stores in one launch, float32 or int32 counts;
* ``bank_range_merge_cuda`` -- the stacked form over one ``(D, R, m)``
  block, read as D nodes with no live slice.

``bank_range_merge_ref`` (re-exported from ``ref``) is the plain PyTorch
version over the stacked block; the ``ops`` front doors take it only for
tensors that lie on the CPU.  Both wrappers count one launch of
``bank_range_merge``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, P
from repro_torch.kernels.ref import BucketSpec, bank_range_merge_ref, fold_destination_range

__all__ = ["bank_range_merge_cuda", "bank_range_merge_nodes_cuda", "bank_range_merge_ref"]

NAME = "bank_range_merge"
_SIGNATURES = {
    "bank_range_merge": (P, P, P, P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32, P),
}
_COUNTS = (torch.float32, torch.int32)
_MAX_BUCKETS = 16384  # two staged rows and the accumulator fit in shared memory


def _check_spec(spec: BucketSpec) -> int:
    fold_destination_range(spec)  # raises on folds that escape the bucket array
    m = spec.num_buckets
    if m > _MAX_BUCKETS:
        raise ValueError(f"bank_range_merge takes at most {_MAX_BUCKETS} buckets, got {m}")
    return m


def _check_deltas(deltas: torch.Tensor, shape: tuple, device) -> None:
    if deltas.dtype != torch.int32 or tuple(deltas.shape) != shape or deltas.device != device:
        raise ValueError(f"deltas must be an int32 {shape} tensor on {device}")
    if not deltas.is_contiguous():
        raise ValueError("deltas must be contiguous")


def _launch(stores, lives, outs, nodes, deltas, *, num_nodes, rows, spec, counts_int, ref):
    lib = _build.load(NAME, _SIGNATURES)
    ptr = [None if t is None else t.data_ptr() for t in (*stores, *lives)]
    # 16-byte row copies need every slice row on a 16-byte boundary
    vec = spec.num_buckets % 4 == 0 and all(p is None or p % 16 == 0 for p in ptr)
    with torch.cuda.device(ref.device):
        err = lib.bank_range_merge(
            *ptr, outs[0].data_ptr(), outs[-1].data_ptr(),
            None if nodes is None else nodes.data_ptr(), deltas.data_ptr(),
            len(outs), num_nodes, int(lives[0] is not None), rows, spec.num_buckets,
            spec.offset, int(counts_int), int(vec), _build.stream_of(ref),
        )
    _build.check(lib, err, NAME)
    _build.count_launch(NAME)


def bank_range_merge_cuda(
    counts: torch.Tensor, deltas: torch.Tensor, *, spec: BucketSpec
) -> torch.Tensor:
    """``(R, m)`` float32 from one launch over contiguous CUDA ``counts``
    (``(D, R, m)`` float32) and ``deltas`` (``(D, R)`` int32, at most
    ``MAX_COLLAPSE_LEVEL``; negative = dead slice)."""
    m = _check_spec(spec)
    if counts.device.type != "cuda":
        raise ValueError(f"bank_range_merge_cuda needs CUDA tensors, got {counts.device}")
    if counts.dtype != torch.float32 or counts.dim() != 3 or counts.shape[2] != m:
        raise ValueError(f"counts must be a float32 (D, R, {m}) tensor, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    d, r, _ = counts.shape
    _check_deltas(deltas, (d, r), counts.device)
    out = torch.empty((r, m), dtype=torch.float32, device=counts.device)
    _launch((counts, None), (None, None), (out,), None, deltas, num_nodes=d, rows=r,
            spec=spec, counts_int=False, ref=counts)
    return out


def bank_range_merge_nodes_cuda(
    slab_pos: torch.Tensor,
    slab_neg: torch.Tensor,
    nodes: torch.Tensor,
    bank_pos: torch.Tensor,
    bank_neg: torch.Tensor,
    deltas: torch.Tensor,
    *,
    spec: BucketSpec,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pos, neg)``, each ``(K, m)`` float32, from one launch.

    ``slab_pos`` / ``slab_neg`` are the slab's contiguous ``(nodes, K, m)``
    stores and ``bank_pos`` / ``bank_neg`` the live bank's ``(K, m)``, all
    of one counts dtype (float32 or int32); ``nodes`` is ``(D,)`` int32;
    ``deltas`` is ``(D + 1, K)`` int32, row D for the live bank, with -1
    for a dead slice (padding node or gated-off live bank).
    """
    m = _check_spec(spec)
    dev = slab_pos.device
    if dev.type != "cuda":
        raise ValueError(f"bank_range_merge_nodes_cuda needs CUDA tensors, got {dev}")
    cd = slab_pos.dtype
    if cd not in _COUNTS:
        raise TypeError(f"slab counts must be float32 or int32, got {cd}")
    if slab_pos.dim() != 3 or slab_pos.shape[2] != m:
        raise ValueError(f"slab stores must be (nodes, K, {m}), got {tuple(slab_pos.shape)}")
    k = slab_pos.shape[1]
    for name, t, shape in (("slab_neg", slab_neg, tuple(slab_pos.shape)),
                           ("bank_pos", bank_pos, (k, m)), ("bank_neg", bank_neg, (k, m))):
        if t.dtype != cd or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be a {cd} {shape} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for t in (slab_pos, slab_neg, bank_pos, bank_neg):
        if not t.is_contiguous():
            raise ValueError("slab and bank stores must be contiguous")
    if nodes.dtype != torch.int32 or nodes.dim() != 1 or nodes.device != dev:
        raise ValueError(f"nodes must be an int32 (D,) tensor on {dev}")
    d = nodes.numel()
    _check_deltas(deltas, (d + 1, k), dev)
    out = torch.empty((2, k, m), dtype=torch.float32, device=dev)
    _launch((slab_pos, slab_neg), (bank_pos, bank_neg), (out[0], out[1]), nodes.contiguous(),
            deltas, num_nodes=d, rows=k, spec=spec, counts_int=cd == torch.int32, ref=slab_pos)
    return out[0], out[1]
