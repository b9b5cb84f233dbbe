"""Triple scatter on the card: ``csrc/ddsketch_scatter.cu`` and its plain
version.

``scatter_cuda`` launches the hand-written CUDA kernel that replaces the
JAX package's Pallas ``_scatter_kernel``: every (key, weight) triple with a
key in ``[0, rows * m)`` adds its weight to ``out[key // m, key % m]``.
``scatter_histogram_ref`` (re-exported from ``ref``) is the plain PyTorch
version; the ``ops.ddsketch_scatter`` front door takes it only for tensors
that lie on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, I64, P
from repro_torch.kernels.ref import scatter_histogram_ref

__all__ = ["scatter_cuda", "scatter_histogram_ref"]

NAME = "ddsketch_scatter"
_SIGNATURES = {"ddsketch_scatter": (P, P, I64, I32, I32, P, P)}


def scatter_cuda(
    keys: torch.Tensor, weights: torch.Tensor, *, num_rows: int, num_buckets: int
) -> torch.Tensor:
    """``(num_rows, num_buckets)`` float32 from one launch over contiguous
    ``(U,)`` CUDA ``keys`` (int32) and ``weights`` (float32)."""
    if keys.device.type != "cuda":
        raise ValueError(f"scatter_cuda needs CUDA tensors, got {keys.device}")
    dev, n = keys.device, keys.numel()
    rows, m = int(num_rows), int(num_buckets)
    if rows * m >= 2**31:
        raise ValueError(f"{rows} x {m} buckets overflow int32 keys")
    kp = _build.lane_ptr(keys, torch.int32, "keys", n, dev)
    wp = _build.lane_ptr(weights, torch.float32, "weights", n, dev)
    out = torch.empty((rows, m), dtype=torch.float32, device=dev)
    lib = _build.load(NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.ddsketch_scatter(kp, wp, n, rows, m, out.data_ptr(), _build.stream_of(keys))
    _build.check(lib, err, NAME)
    _build.count_launch(NAME)
    return out
