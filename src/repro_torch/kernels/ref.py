"""Plain PyTorch oracles for the DDSketch bank kernels of the serving path.

Torch twins of the JAX package's ``kernels/ref.py`` for the three kernels
this package ports (fused ingest, pair fold, bank quantiles) plus the
geometry they share.  They define the semantics the CUDA kernels in
``repro_torch/csrc`` must match, run the CPU path (a wrapper takes them
only for tensors that lie on the CPU), and are what ``chip_smoke.py``
holds each kernel against on the card.

Float32 bucket math follows the reference op for op: the cubic
coefficients are their float32 roundings and the key multiplier is cast
to float32 before the multiply, so ``linear`` and ``cubic`` keys are
bit-identical to the JAX package and ``log`` keys differ only where two
``logf`` implementations differ by an ulp at a bucket boundary.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "BucketSpec",
    "IngestStats",
    "MAX_COLLAPSE_LEVEL",
    "approx_log2",
    "shift_key",
    "bucket_index",
    "fused_ingest_ref",
    "bank_quantiles_ref",
    "fold_destination_range",
    "fold_pairs_ref",
]

# Hard ceiling on the uniform-collapse level (UDDSketch, Epicoco et al.
# 2020); at the default geometry level 3 already indexes every float32
# normal, so 6 leaves headroom while the per-level value table stays small.
MAX_COLLAPSE_LEVEL = 6


@dataclass(frozen=True)
class BucketSpec:
    """Static bank geometry: keys ``[offset, offset + num_buckets)``.

    Keys below collapse into bucket 0, keys above clamp into the top bucket
    and are counted as overflow / underflow by the ingest.
    """

    relative_accuracy: float = 0.01
    num_buckets: int = 2048
    offset: int = -1024  # key of bucket 0
    mapping: str = "log"  # "log" | "linear" | "cubic"

    @property
    def gamma(self) -> float:
        return (1.0 + self.relative_accuracy) / (1.0 - self.relative_accuracy)

    @property
    def multiplier(self) -> float:
        """key = ceil(_log(x) * multiplier); _log is log2-based for the
        interpolated mappings and natural-log based for "log"."""
        if self.mapping in ("log", "linear"):
            return 1.0 / math.log(self.gamma)
        if self.mapping == "cubic":
            from repro_torch.core.mapping import _CUBIC_CORR

            return _CUBIC_CORR / math.log2(self.gamma)
        raise ValueError(f"unknown mapping {self.mapping}")

    @property
    def min_indexable(self) -> float:
        # float32-safe: stay inside the normal range (kernels bit-cast f32)
        return 1e-37

    def key_bounds(self) -> tuple[int, int]:
        return self.offset, self.offset + self.num_buckets - 1


def f32(x: float) -> float:
    """The float32 rounding of a Python float, as a Python float.

    Multiplying a float32 tensor by it is exactly the float32 product the
    JAX package computes with its weakly typed scalars.
    """
    return float(np.float32(x))


# float32 roundings of the cubic interpolation coefficients (the JAX
# package multiplies float32 lanes by these Python floats, which it rounds
# to float32 first)
_CUBIC_A = f32(6.0 / 35.0)
_CUBIC_B = f32(-3.0 / 5.0)
_CUBIC_C = f32(10.0 / 7.0)
_MAPPING_CODES = {"log": 0, "linear": 1, "cubic": 2}


def approx_log2(x: torch.Tensor, mapping: str) -> torch.Tensor:
    """Mapping-specific monotone log approximation (float32 semantics).

    "log": natural log (converted by the multiplier).  "linear" / "cubic":
    exponent bits plus mantissa interpolation, the paper's costless log2
    read off the binary representation.
    """
    x = x.to(torch.float32)
    if mapping == "log":
        return torch.log(x)
    bits = x.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    f = (bits & 0x7FFFFF).to(torch.float32) * (2.0**-23)
    if mapping == "linear":
        return e.to(torch.float32) + f
    poly = ((_CUBIC_A * f + _CUBIC_B) * f + _CUBIC_C) * f
    return e.to(torch.float32) + poly


def shift_key(key: torch.Tensor, levels) -> torch.Tensor:
    """Level-0 key -> collapse-level key: ceil(key / 2**level), exact int32.

    The arithmetic right shift floors for either sign, so the ceil is two
    negations.
    """
    return -((-key) >> levels)


def raw_keys(mag: torch.Tensor, spec: BucketSpec) -> torch.Tensor:
    """Level-0 int32 keys of positive magnitudes: ceil(log(x) * f32(mult))."""
    key = torch.ceil(approx_log2(mag, spec.mapping) * f32(spec.multiplier))
    return key.to(torch.int32)


def bucket_index(
    x: torch.Tensor, spec: BucketSpec, levels: torch.Tensor | None = None
) -> torch.Tensor:
    """Clamped bucket index for positive values (callers pre-mask others)."""
    k = raw_keys(x, spec)
    if levels is not None:
        k = shift_key(k, levels)
    return torch.clamp(k - spec.offset, 0, spec.num_buckets - 1)


class IngestStats(NamedTuple):
    """Per-row auxiliary statistics of one ingest batch, each ``(K,)``.

    Rows untouched by the batch report 0 for the counters and ``+inf`` /
    ``-inf`` for ``vmin`` / ``vmax``, the identities of the bank's folds.
    """

    zero: torch.Tensor  # weight of |x| <= min_indexable lanes
    overflow: torch.Tensor  # weight of lanes whose shifted key clamps high
    underflow: torch.Tensor  # weight of lanes whose shifted key clamps low
    summ: torch.Tensor  # sum of w * x over valid lanes
    vmin: torch.Tensor  # min x over contributing (w > 0) lanes
    vmax: torch.Tensor  # max x over contributing (w > 0) lanes


def _lanes(values, segment_ids, weights, levels):
    """Flatten and type one batch: float32 x / w, int32 ids / levels."""
    x = values.reshape(-1).to(torch.float32)
    dev = x.device
    s = (
        torch.zeros(x.shape, dtype=torch.int32, device=dev)
        if segment_ids is None
        else segment_ids.reshape(-1).to(torch.int32)
    )
    w = (
        torch.ones_like(x)
        if weights is None
        else weights.reshape(-1).to(torch.float32)
    )
    lev = (
        torch.zeros(x.shape, dtype=torch.int32, device=dev)
        if levels is None
        else levels.reshape(-1).to(torch.int32)
    )
    if not x.numel() == s.numel() == w.numel() == lev.numel():
        raise ValueError(
            f"values ({x.numel()}), segment_ids ({s.numel()}), weights "
            f"({w.numel()}) and levels ({lev.numel()}) must have the same size"
        )
    return x, s, w, lev


def fused_ingest_ref(
    values: torch.Tensor,
    segment_ids: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    levels: torch.Tensor | None = None,
    *,
    num_segments: int,
    spec: BucketSpec,
) -> tuple[torch.Tensor, IngestStats]:
    """Plain fused ingest: ``(hist (2K, m), IngestStats)`` in one pass.

    Positives land in rows ``[0, K)``, negatives (keyed on ``|x|``) in rows
    ``[K, 2K)``; non-finite lanes and out-of-range ids contribute nothing.
    Overflow / underflow are lanes whose level-shifted key escapes
    ``[offset, offset + m - 1]``.  Counters are exact for integer weights;
    ``summ`` and fractional-weight buckets depend on accumulation order.
    """
    m = spec.num_buckets
    k = num_segments
    x, s, w, lev = _lanes(values, segment_ids, weights, levels)
    mi = f32(spec.min_indexable)
    valid = torch.isfinite(x) & (s >= 0) & (s < k)
    w = torch.where(valid, w, 0.0)
    sc = torch.clamp(s, 0, max(k - 1, 0)).to(torch.int64)
    is_pos = valid & (x > mi)
    is_neg = valid & (x < -mi)
    is_zero = valid & ~is_pos & ~is_neg
    binned = is_pos | is_neg

    # one elementwise key pass feeds the histogram AND the clamp accounting
    mag = torch.where(binned, x.abs(), 1.0)
    k_lev = shift_key(raw_keys(mag, spec), lev)
    idx = torch.clamp(k_lev - spec.offset, 0, m - 1)
    over = binned & (k_lev > spec.offset + m - 1)
    under = binned & (k_lev < spec.offset)

    flat = sc * m + idx + torch.where(is_neg, k * m, 0)
    hist = torch.zeros(2 * k * m, dtype=torch.float32, device=x.device)
    hist.index_add_(0, flat[binned], w[binned])

    wx = w * torch.where(valid, x, 0.0)
    cols = torch.stack([w * is_zero, w * over, w * under, wx], dim=1)
    sums = torch.zeros((k, 4), dtype=torch.float32, device=x.device)
    sums.index_add_(0, sc, cols)
    contributes = valid & (w > 0)
    vmin = torch.full((k,), math.inf, dtype=torch.float32, device=x.device)
    vmax = torch.full((k,), -math.inf, dtype=torch.float32, device=x.device)
    vmin.scatter_reduce_(0, sc[contributes], x[contributes], "amin")
    vmax.scatter_reduce_(0, sc[contributes], x[contributes], "amax")
    stats = IngestStats(
        zero=sums[:, 0].contiguous(),
        overflow=sums[:, 1].contiguous(),
        underflow=sums[:, 2].contiguous(),
        summ=sums[:, 3].contiguous(),
        vmin=vmin,
        vmax=vmax,
    )
    return hist.view(2 * k, m), stats


def bank_quantiles_ref(
    pos: torch.Tensor,
    neg: torch.Tensor,
    zero: torch.Tensor,
    vmin: torch.Tensor,
    vmax: torch.Tensor,
    level: torch.Tensor,
    qs: torch.Tensor,
    table: torch.Tensor,
) -> torch.Tensor:
    """Plain fused Algorithm 2: per-row quantiles ``(K, len(qs))``.

    Each row's ``(2m+1)`` line (neg reversed, zero, pos) and its cumsum
    answer every q: ``rank = q * max(n - 1, 0)``, the estimate is the value
    of the first line bucket whose cumulative count exceeds the rank, read
    from the row's level in the per-level ``table``, then clamped to the
    exact extrema; ``q <= 0`` / ``q >= 1`` answer vmin / vmax and empty rows
    NaN.  Counts of any dtype are cast to float32 for the rank math.
    """
    k, m = pos.shape
    num_levels = table.shape[0]
    qf = torch.as_tensor(qs, dtype=torch.float32, device=pos.device).reshape(1, -1)
    line = torch.cat(
        [
            neg.to(torch.float32).flip(1),
            zero.to(torch.float32).reshape(-1, 1),
            pos.to(torch.float32),
        ],
        dim=1,
    )
    n = line.sum(dim=1, keepdim=True)
    cum = line.cumsum(dim=1)
    rank = qf * torch.clamp(n - 1.0, min=0.0)  # (K, Q)
    idx = torch.searchsorted(cum, rank.contiguous(), right=True)
    idx = torch.clamp(idx, 0, 2 * m)
    lrow = torch.clamp(level.to(torch.int64), 0, num_levels - 1).reshape(-1, 1) * m
    tflat = table.to(torch.float32).reshape(-1)
    vneg = -tflat[lrow + torch.clamp(m - 1 - idx, 0, m - 1)]
    vpos = tflat[lrow + torch.clamp(idx - m - 1, 0, m - 1)]
    est = torch.where(idx < m, vneg, torch.where(idx == m, 0.0, vpos))
    lo = vmin.to(torch.float32).reshape(-1, 1)
    hi = vmax.to(torch.float32).reshape(-1, 1)
    est = torch.minimum(torch.maximum(est, lo), hi)  # exact-extrema clamp
    est = torch.where(qf <= 0.0, lo, torch.where(qf >= 1.0, hi, est))
    return torch.where(n > 0, est, math.nan)


def fold_destination_range(spec: BucketSpec) -> tuple[int, int]:
    """(lowest, highest) destination index of one uniform-collapse fold.

    Bucket i holds key ``offset + i``; the fold sends key k to ceil(k/2).
    Raises if any destination falls outside [0, m).
    """
    lo = (spec.offset + 1) // 2 - spec.offset
    hi = (spec.offset + spec.num_buckets) // 2 - spec.offset
    if lo < 0 or hi > spec.num_buckets - 1:
        raise ValueError(
            f"fold_pairs destinations [{lo}, {hi}] escape the bucket array "
            f"[0, {spec.num_buckets - 1}] for offset={spec.offset}; uniform "
            "collapse needs offset <= 0 <= offset + num_buckets - 1"
        )
    return lo, hi


def fold_pairs_ref(counts: torch.Tensor, *, spec: BucketSpec) -> torch.Tensor:
    """One uniform-collapse step over the bucket axis of ``(..., m)`` counts.

    ``out[..., ceil((offset+i)/2) - offset] += counts[..., i]``; every
    destination receives at most two sources, so the result is exact for
    float32 and int32 counts alike.
    """
    fold_destination_range(spec)
    m = spec.num_buckets
    keys = torch.arange(m, dtype=torch.int64, device=counts.device) + spec.offset
    dst = ((keys + 1) >> 1) - spec.offset  # ceil(k/2) - offset, in [0, m)
    flat = counts.reshape(-1, m)
    out = torch.zeros_like(flat).index_add_(1, dst, flat)
    return out.reshape(counts.shape)
