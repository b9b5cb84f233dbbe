"""Row-level sketch helpers the bank needs (counterpart of ``jax_sketch``).

Only what ``sketch_bank`` uses is ported in this slice: the counts-dtype
rule, the effective guarantee of a collapse level, the level-0 keys, the
minimal collapse level a key needs, and the fold.  The single-sketch
``DeviceSketch`` API comes with the alternative insert pipelines
(``ROADMAP.md`` queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import MAX_COLLAPSE_LEVEL, BucketSpec, raw_keys, shift_key

__all__ = ["effective_alpha"]

_COUNTS_DTYPES = (torch.float32, torch.int32)


def _counts_dtype(counts_dtype) -> torch.dtype:
    """Validate a requested counter dtype: float32 or int32.

    float32 counts are exact to 2^24 per row; int32 raises that ceiling for
    integer weights.  int64 is refused, as the JAX package refuses it
    without x64, because the fold and query kernels take float32 and int32
    only.  ``summ`` and the extrema stay float32 either way.
    """
    if isinstance(counts_dtype, torch.dtype):
        dt = counts_dtype
    else:
        dt = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32}.get(
            np.dtype(counts_dtype)
        )
    if dt not in _COUNTS_DTYPES:
        raise ValueError(
            f"counts_dtype={counts_dtype} is not supported: use float32 or int32"
        )
    return dt


def effective_alpha(spec: BucketSpec, level: int) -> float:
    """Guarantee after ``level`` uniform collapses: gamma_eff = gamma**(2**L),
    alpha_L = (g - 1)/(g + 1)."""
    g = spec.gamma ** (1 << int(level))
    return (g - 1.0) / (g + 1.0)


def _raw_keys(x: torch.Tensor, valid: torch.Tensor, spec: BucketSpec) -> torch.Tensor:
    """Level-0 int32 keys of |x| for valid pos/neg lanes (0 elsewhere)."""
    return raw_keys(torch.where(valid, x.abs(), 1.0), spec)


def _needed_levels(k0: torch.Tensor, spec: BucketSpec) -> torch.Tensor:
    """Per-value minimal collapse level whose shifted key fits the array
    (0 where no level fits: those values clamp and count as over/underflow)."""
    top = spec.offset + spec.num_buckets - 1
    levels = torch.arange(MAX_COLLAPSE_LEVEL + 1, dtype=torch.int32, device=k0.device)
    shifted = shift_key(k0[:, None], levels[None, :])
    fits = (shifted >= spec.offset) & (shifted <= top)
    first = torch.argmax(fits.to(torch.int8), dim=1).to(torch.int32)
    return torch.where(fits.any(dim=1), first, 0)


def _fold(counts: torch.Tensor, spec: BucketSpec, rows=None, out=None) -> torch.Tensor:
    """One fold of the selected rows through the front door: the kernel on
    the card, the plain version on the CPU.  The kernel is exact for both
    counts dtypes, so integer banks need no exclusion from it."""
    return ops.fold_pairs(counts, spec=spec, rows=rows, out=out)
