"""Plain PyTorch oracles for the DDSketch bank kernels of the serving path.

Torch twins of the JAX package's ``kernels/ref.py`` for the seven kernels
this package ports (fused ingest, pair fold, bank quantiles, slice-range
merge, segment histogram, single-row histogram, triple scatter), the sort
pipeline's compaction front end and the geometry they share.  They define the semantics the CUDA kernels in
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
    "multi_fold_destinations",
    "bank_range_merge_ref",
    "histogram_ref",
    "segment_histogram_ref",
    "composite_keys",
    "compact_triples",
    "scatter_histogram_ref",
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


# --------------------------------------------------------------------- #
# fused slice-range merge: fold every slice row to its per-row target
# level and reduce the slice axis (the window query)
# --------------------------------------------------------------------- #
def multi_fold_destinations(spec: BucketSpec, delta: int) -> np.ndarray:
    """Static ``(m,)`` destination indices of a ``delta``-level fold.

    ``shift_key`` nests (ceil(ceil(k/2)/2) == ceil(k/4)), so folding
    ``delta`` levels at once sends bucket i (key ``offset + i``) straight to
    ``ceil((offset + i) / 2**delta) - offset``, the same as iterating
    ``fold_pairs_ref`` ``delta`` times.  Raises if a destination escapes
    ``[0, m)``.
    """
    keys = np.arange(spec.num_buckets, dtype=np.int64) + spec.offset
    dst = -((-keys) >> delta) - spec.offset  # ceil(k / 2**delta) - offset
    if dst.min() < 0 or dst.max() > spec.num_buckets - 1:
        raise ValueError(
            f"multi-level fold (delta={delta}) destinations "
            f"[{dst.min()}, {dst.max()}] escape [0, {spec.num_buckets - 1}] "
            f"for offset={spec.offset}"
        )
    return dst.astype(np.int32)


def bank_range_merge_ref(
    counts: torch.Tensor,
    deltas: torch.Tensor,
    *,
    spec: BucketSpec,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain fused range merge: ``counts (D, R, m), deltas (D, R) -> (R, m)``.

    Row r of the output is the per-bucket sum of the D slice rows
    ``counts[d, r]`` after folding each one ``deltas[d, r]`` collapse levels
    (Algorithm 4 over the slice axis with the level reconciliation applied
    per (slice, row)).  Deltas are clipped to ``[0, MAX_COLLAPSE_LEVEL]``;
    ``valid`` is an optional ``(D,)`` 0/1 slice mask, and a dead slice
    contributes nothing whatever its counts hold.

    One formulation serves the reference's steady and reconciliation
    branches alike: the slice rows are grouped by delta (a masked sum over
    the slice axis per group), then each group is folded once with
    ``index_add_`` into the ``multi_fold_destinations`` indices.  Exact for
    integer-valued counts in any order, so it equals the reference and the
    kernel bit for bit there; fractional counts differ in summation order.
    """
    fold_destination_range(spec)
    if counts.dim() != 3 or counts.shape[2] != spec.num_buckets:
        raise ValueError(f"counts must be (D, R, {spec.num_buckets}), got {tuple(counts.shape)}")
    if tuple(deltas.shape) != tuple(counts.shape[:2]):
        raise ValueError(f"deltas must be {tuple(counts.shape[:2])}, got {tuple(deltas.shape)}")
    c = counts.to(torch.float32)
    d = torch.clamp(deltas.to(torch.int32), 0, MAX_COLLAPSE_LEVEL)
    if valid is not None:
        v = valid.to(device=c.device, dtype=torch.float32).reshape(-1, 1)
        d = torch.where(v > 0, d, -1)  # sentinel: matches no level
    out = torch.zeros(c.shape[1:], dtype=torch.float32, device=c.device)
    for delta in range(MAX_COLLAPSE_LEVEL + 1):
        sel = d == delta  # (D, R)
        grouped = torch.where(sel[:, :, None], c, 0.0).sum(0)
        if delta == 0:
            out += grouped
        else:
            dst = torch.from_numpy(multi_fold_destinations(spec, delta)).to(c.device)
            out.index_add_(1, dst.to(torch.int64), grouped)
    return out


# --------------------------------------------------------------------- #
# the matmul and sort insert pipelines
# --------------------------------------------------------------------- #
def histogram_ref(
    values: torch.Tensor,
    weights: torch.Tensor | None = None,
    levels: torch.Tensor | None = None,
    *,
    spec: BucketSpec,
) -> torch.Tensor:
    """Plain single-sketch histogram: ``(m,)`` bucket counts of the positive
    finite entries of ``values``, each keyed at its per-value collapse level
    (``levels`` None = level 0).  Other entries contribute nothing."""
    x = values.reshape(-1).to(torch.float32)
    w = torch.ones_like(x) if weights is None else weights.reshape(-1).to(torch.float32)
    lev = None if levels is None else levels.reshape(-1).to(torch.int32)
    mask = torch.isfinite(x) & (x > f32(spec.min_indexable))
    idx = bucket_index(torch.where(mask, x, 1.0), spec, lev)
    out = torch.zeros(spec.num_buckets, dtype=torch.float32, device=x.device)
    return out.index_add_(0, idx.to(torch.int64), torch.where(mask, w, 0.0))


def segment_histogram_ref(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    weights: torch.Tensor | None = None,
    levels: torch.Tensor | None = None,
    *,
    num_segments: int,
    spec: BucketSpec,
) -> torch.Tensor:
    """Plain per-segment histogram, ``(num_segments, m)``: row k is
    ``histogram_ref(values[segment_ids == k])``.  Entries whose segment id
    falls outside ``[0, num_segments)`` contribute nothing; ``levels`` are
    per-value collapse levels."""
    k, m = int(num_segments), spec.num_buckets
    x = values.reshape(-1).to(torch.float32)
    s = segment_ids.reshape(-1).to(torch.int32)
    w = torch.ones_like(x) if weights is None else weights.reshape(-1).to(torch.float32)
    lev = None if levels is None else levels.reshape(-1).to(torch.int32)
    mask = torch.isfinite(x) & (x > f32(spec.min_indexable)) & (s >= 0) & (s < k)
    idx = bucket_index(torch.where(mask, x, 1.0), spec, lev)
    flat = torch.clamp(s, 0, max(k - 1, 0)).to(torch.int64) * m + idx
    out = torch.zeros(k * m, dtype=torch.float32, device=x.device)
    out.index_add_(0, flat, torch.where(mask, w, 0.0))
    return out.view(k, m)


def composite_keys(
    values: torch.Tensor,
    segment_ids: torch.Tensor | None,
    levels: torch.Tensor | None,
    *,
    num_segments: int,
    spec: BucketSpec,
) -> torch.Tensor:
    """Flat int32 ``sign_base + seg * m + bucket`` keys covering both sign
    stores of the combined ``(2K, m)`` layout.

    Positives key into rows ``[0, K)``, negatives (keyed on ``|x|``) into
    rows ``[K, 2K)``; lanes that contribute nothing (non-finite,
    ``|x| <= min_indexable``, out-of-range segment id) get the sentinel
    ``2*K*m``, which every consumer drops.  Raises when ``2*K*m + 1`` does
    not fit int32.
    """
    k, m = int(num_segments), spec.num_buckets
    sentinel = 2 * k * m
    if sentinel + 1 > np.iinfo(np.int32).max:
        raise ValueError(
            f"2 * num_segments * num_buckets + 1 = {sentinel + 1} overflows "
            "int32 composite keys; shard the bank or shrink the geometry"
        )
    x = values.reshape(-1).to(torch.float32)
    s = (
        torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        if segment_ids is None
        else segment_ids.reshape(-1).to(torch.int32)
    )
    lev = None if levels is None else levels.reshape(-1).to(torch.int32)
    mi = f32(spec.min_indexable)
    finite = torch.isfinite(x)
    is_pos = finite & (x > mi)
    is_neg = finite & (x < -mi)
    valid = (is_pos | is_neg) & (s >= 0) & (s < k)
    idx = bucket_index(torch.where(valid, x.abs(), 1.0), spec, lev)
    key = torch.clamp(s, 0, max(k - 1, 0)) * m + idx + torch.where(is_neg, k * m, 0)
    return torch.where(valid, key, sentinel).to(torch.int32)


def compact_triples(
    values: torch.Tensor,
    segment_ids: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    levels: torch.Tensor | None = None,
    *,
    num_segments: int,
    spec: BucketSpec,
    payload_sort: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort + reduce: N lanes -> U <= min(N, 2*K*m + 1) unique triples.

    Returns ``(keys, weights)`` of length N with the runs packed to the
    front: lanes ``0..U-1`` hold each distinct composite key (see
    ``composite_keys``) once, in ascending order, with the run's total
    weight; the invalid lanes collapse into one sentinel run.  Trailing
    lanes hold int32-max keys and weight 0.  Callers may slice the result
    to ``min(N, 2*K*m + 1)`` lanes without reading U.

    Plain torch on both devices (the reference runs it as XLA outside any
    kernel): one ``torch.sort`` of the keys, run starts, a ``cumsum`` for
    the run index, then a segmented sum and min.  The reference's two
    formulations (keys with a lane-index permutation, or ``payload_sort``
    moving the weights with the keys) are one here, because ``torch.sort``
    returns the permutation; the flag is accepted for the reference's
    signature.  The sort is unstable, so fractional weights on duplicate
    keys may sum in another order (last-ulp differences); integer weights
    are exact.
    """
    del payload_sort  # both formulations are the same sort here
    key = composite_keys(values, segment_ids, levels, num_segments=num_segments, spec=spec)
    n = key.numel()
    if n == 0:
        return key, torch.zeros(0, dtype=torch.float32, device=key.device)
    sk, perm = torch.sort(key)
    sw = (
        torch.ones(n, dtype=torch.float32, device=key.device)
        if weights is None
        else weights.reshape(-1).to(torch.float32)[perm]
    )
    starts = torch.ones(n, dtype=torch.int32, device=key.device)
    starts[1:] = (sk[1:] != sk[:-1]).to(torch.int32)
    rid = (torch.cumsum(starts, 0) - 1).to(torch.int64)  # run index 0..U-1
    run_w = torch.zeros(n, dtype=torch.float32, device=key.device).index_add_(0, rid, sw)
    run_k = torch.full((n,), np.iinfo(np.int32).max, dtype=torch.int32, device=key.device)
    run_k.scatter_reduce_(0, rid, sk, "amin")
    return run_k, run_w


def scatter_histogram_ref(
    keys: torch.Tensor, weights: torch.Tensor, *, num_rows: int, num_buckets: int
) -> torch.Tensor:
    """Plain scatter stage: ``out[k // m, k % m] += w`` per triple, into
    ``(num_rows, num_buckets)``.  Keys outside ``[0, num_rows * m)`` (the
    compaction's sentinels) contribute nothing; duplicate keys accumulate.
    With unique keys every bucket takes at most one add, so any correct
    implementation matches this bit for bit."""
    total = int(num_rows) * int(num_buckets)
    k = keys.reshape(-1).to(torch.int64)
    w = weights.reshape(-1).to(torch.float32)
    valid = (k >= 0) & (k < total)
    out = torch.zeros(total + 1, dtype=torch.float32, device=k.device)
    out.index_add_(0, torch.where(valid, k, total), torch.where(valid, w, 0.0))
    return out[:total].view(int(num_rows), int(num_buckets))
