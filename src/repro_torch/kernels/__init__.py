"""DDSketch bank kernels for the card, each beside its plain PyTorch version.

* ``ddsketch_ingest``   -- fused ingest: bucketize, bin and the six per-row
  stats in one pass, in place into a float32 bank or as a fresh delta
  (``csrc/ddsketch_ingest.cu``);
* ``fold_pairs``        -- uniform-collapse fold, row mask fused, in place
  (``csrc/fold_pairs.cu``);
* ``bank_quantiles``    -- fused Algorithm 2 over every row and q
  (``csrc/bank_quantiles.cu``);
* ``bank_range_merge``  -- a window query's fold-and-sum over the slice
  axis, reading slab nodes by index or a stacked block
  (``csrc/bank_range_merge.cu``);
* ``ddsketch_seg_hist`` -- per-segment histogram of the matmul insert
  pipeline (``csrc/ddsketch_seg_hist.cu``);
* ``ddsketch_hist``     -- single-row histogram of one sketch
  (``csrc/ddsketch_hist.cu``);
* ``ddsketch_scatter``  -- triple scatter of the sort insert pipeline
  (``csrc/ddsketch_scatter.cu``);
* ``ref``               -- the plain versions and the bucket geometry;
* ``ops``               -- front doors: the tensors' device picks the kernel
  (CUDA) or the plain version (CPU).
"""

from repro_torch.kernels.ops import (  # noqa: F401
    BucketSpec,
    IngestStats,
    bank_histograms,
    bank_quantiles,
    bank_range_merge,
    bank_range_merge_nodes,
    ddsketch_histogram,
    ddsketch_scatter,
    dispatch_stats,
    fold_pairs,
    fused_ingest,
    fused_ingest_into,
    insert_method,
    reset_dispatch_stats,
    segment_histogram,
)
from repro_torch.kernels.ref import (  # noqa: F401
    MAX_COLLAPSE_LEVEL,
    bank_quantiles_ref,
    bank_range_merge_ref,
    compact_triples,
    composite_keys,
    fold_pairs_ref,
    fused_ingest_ref,
    histogram_ref,
    scatter_histogram_ref,
    segment_histogram_ref,
)
