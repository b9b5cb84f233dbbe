"""Per-spec constant caches and shared geometry helpers.

The fused bank query selects bucket-value estimates from the
``(MAX_COLLAPSE_LEVEL + 1, m)`` per-level table.  The table depends only on
the ``BucketSpec``; it is built once per spec with the same exact float64
host math as the JAX package (so the two tables are bit-identical) and
uploaded once per (spec, device).

Shape-specialised call paths round the streamed batch axis and the bank
row axis up to powers of two, so arbitrary batch sizes map onto O(log N)
geometries.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.kernels.ref import MAX_COLLAPSE_LEVEL, BucketSpec

__all__ = [
    "bucket_value_table",
    "device_value_table",
    "next_pow2",
    "padded_row_count",
]

_MIN_ROWS = 4  # smallest padded bank row count


def next_pow2(n: int, minimum: int) -> int:
    """Next power-of-two >= ``n`` (floored at ``minimum``)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def padded_row_count(n: int, minimum: int = _MIN_ROWS) -> int:
    """The physical row count a bank of ``n`` logical rows rounds to."""
    return next_pow2(max(int(n), 1), minimum)


@lru_cache(maxsize=None)
def bucket_value_table(spec: BucketSpec) -> np.ndarray:
    """(MAX_COLLAPSE_LEVEL + 1, m) relative-error midpoint estimates.

    Row L gives the estimate for bucket i at collapse level L
    (``KeyMapping.value_at_level``, the host quantile path's float64
    math), clipped into the float32 finite range.
    """
    from repro_torch.core.mapping import make_mapping

    m = make_mapping(spec.mapping, spec.relative_accuracy)
    keys = np.arange(spec.offset, spec.offset + spec.num_buckets)
    table = np.empty((MAX_COLLAPSE_LEVEL + 1, spec.num_buckets), np.float64)
    for lev in range(MAX_COLLAPSE_LEVEL + 1):
        for i, k in enumerate(keys):
            table[lev, i] = m.value_at_level(int(k), lev)
    f32 = np.finfo(np.float32)
    return np.clip(table, float(f32.tiny), float(f32.max))


@lru_cache(maxsize=None)
def _device_table(spec: BucketSpec, device: str) -> torch.Tensor:
    host = bucket_value_table(spec).astype(np.float32)
    return torch.from_numpy(host).to(device)


def device_value_table(spec: BucketSpec, device) -> torch.Tensor:
    """The per-level table as a float32 tensor on ``device``, cached per
    (spec, device): one upload per pair per process."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _device_table(spec, str(dev))
