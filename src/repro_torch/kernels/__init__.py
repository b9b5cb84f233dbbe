"""DDSketch bank kernels for the card, each beside its plain PyTorch version.

* ``ddsketch_ingest`` -- fused ingest: bucketize, bin and the six per-row
  stats in one pass (``csrc/ddsketch_ingest.cu``);
* ``fold_pairs``      -- uniform-collapse fold, row mask fused, in place
  (``csrc/fold_pairs.cu``);
* ``bank_quantiles``  -- fused Algorithm 2 over every row and q
  (``csrc/bank_quantiles.cu``);
* ``ref``             -- the plain versions and the bucket geometry;
* ``ops``             -- front doors: the tensors' device picks the kernel
  (CUDA) or the plain version (CPU).
"""

from repro_torch.kernels.ops import (  # noqa: F401
    BucketSpec,
    IngestStats,
    bank_quantiles,
    dispatch_stats,
    fold_pairs,
    fused_ingest,
    reset_dispatch_stats,
)
from repro_torch.kernels.ref import (  # noqa: F401
    MAX_COLLAPSE_LEVEL,
    bank_quantiles_ref,
    fold_pairs_ref,
    fused_ingest_ref,
)
