"""Fused bank query on the card: ``csrc/bank_quantiles.cu`` and its plain
version.

``bank_quantiles_cuda`` launches the hand-written CUDA kernel that
replaces the JAX package's Pallas ``_bankq_kernel``: a persistent grid
whose blocks hold the next row's counts in registers while they scan the
current row's ``(2m+1)`` line once in shared memory and answer every q by
a binary search over the cumulative counts.  ``bank_quantiles_ref`` (re-exported from
``ref``) is the plain PyTorch version; the ``ops.bank_quantiles`` front
door takes it only for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, P
from repro_torch.kernels.ref import bank_quantiles_ref

__all__ = ["bank_quantiles_cuda", "bank_quantiles_ref"]

NAME = "bank_quantiles"
_SIGNATURES = {
    "bank_quantiles_f32": (P, P, P, P, P, P, P, I32, P, I32, I32, I32, P, P),
    "bank_quantiles_i32": (P, P, P, P, P, P, P, I32, P, I32, I32, I32, P, P),
}
_ENTRY = {torch.float32: "bank_quantiles_f32", torch.int32: "bank_quantiles_i32"}
_MAX_SMEM = 227 * 1024 - 1024  # dynamic shared memory left beside the scratch


def _check(t: torch.Tensor, shape: tuple, dtype: torch.dtype, what: str, device) -> int:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{what} must be a {dtype} {shape} tensor on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return t.data_ptr()


def bank_quantiles_cuda(
    pos: torch.Tensor,
    neg: torch.Tensor,
    zero: torch.Tensor,
    vmin: torch.Tensor,
    vmax: torch.Tensor,
    level: torch.Tensor,
    qs: torch.Tensor,
    table: torch.Tensor,
) -> torch.Tensor:
    """Per-row quantiles ``(K, Q)`` from one kernel launch.

    ``pos`` / ``neg`` ``(K, m)`` and ``zero`` ``(K,)`` share one counts
    dtype (float32 or int32); ``vmin`` / ``vmax`` float32 and ``level``
    int32 are ``(K,)``; ``qs`` float32 ``(Q,)``; ``table`` float32
    ``(levels, m)``.  All contiguous and on one CUDA device; rows need no
    alignment beyond their counts' own (an odd ``m`` or an offset view
    takes the kernel's 4-byte loads instead of its 16-byte ones).
    """
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"bank_quantiles_cuda needs CUDA tensors, got {dev}")
    if pos.dtype not in _ENTRY:
        raise TypeError(f"bank_quantiles takes float32 or int32 counts, got {pos.dtype}")
    k, m = pos.shape
    if 4 * (2 * m + 4) > _MAX_SMEM:  # the line and its three pads, as the kernel sizes it
        raise ValueError(f"a line of {2 * m + 1} buckets does not fit one block's shared memory")
    nq = qs.numel()
    ptrs = (
        _check(pos, (k, m), pos.dtype, "pos", dev),
        _check(neg, (k, m), pos.dtype, "neg", dev),
        _check(zero, (k,), pos.dtype, "zero", dev),
        _check(vmin, (k,), torch.float32, "vmin", dev),
        _check(vmax, (k,), torch.float32, "vmax", dev),
        _check(level, (k,), torch.int32, "level", dev),
        _check(qs, (nq,), torch.float32, "qs", dev),
    )
    tp = _check(table, (table.shape[0], m), torch.float32, "table", dev)
    out = torch.empty((k, nq), dtype=torch.float32, device=dev)
    lib = _build.load(NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        err = getattr(lib, _ENTRY[pos.dtype])(
            *ptrs[:6], ptrs[6], nq, tp, table.shape[0], k, m, out.data_ptr(),
            _build.stream_of(pos),
        )
    _build.check(lib, err, NAME)
    _build.count_launch(NAME)
    return out
