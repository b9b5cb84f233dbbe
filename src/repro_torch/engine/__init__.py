"""SketchEngine tier: the bank's call paths between core and kernels.

kernels -> engine -> core -> telemetry -> launch: the engine owns the
in-place ingest with its reactive collapse, the queries, and the per-spec
constant caches.
"""

from repro_torch.engine.tables import (
    bucket_value_table,
    device_value_table,
    next_pow2,
    padded_row_count,
)
from repro_torch.engine.engine import SketchEngine, make_engine, resolve_device

__all__ = [
    "SketchEngine",
    "make_engine",
    "resolve_device",
    "bucket_value_table",
    "device_value_table",
    "next_pow2",
    "padded_row_count",
]
