"""SketchEngine tier: the bank's call paths between core and kernels.

kernels -> engine -> core -> telemetry -> launch: the engine owns the
in-place ingest with its reactive collapse, the queries, the window-ring
slab and its range queries (``WindowRing``), and the per-spec constant
caches.
"""

from repro_torch.engine.tables import (
    bucket_value_table,
    device_value_table,
    next_pow2,
    padded_row_count,
)
from repro_torch.engine.engine import (
    SketchEngine,
    make_engine,
    resolve_device,
    window_merge_bank,
)
from repro_torch.engine.ring import WindowRing

__all__ = [
    "SketchEngine",
    "WindowRing",
    "window_merge_bank",
    "make_engine",
    "resolve_device",
    "bucket_value_table",
    "device_value_table",
    "next_pow2",
    "padded_row_count",
]
