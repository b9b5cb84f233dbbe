"""Device-tier single DDSketch (counterpart of the JAX package's ``jax_sketch``).

A ``DeviceSketch`` is one row of a bank: two ``(m,)`` bucket arrays and
seven 0-d counters, in the JAX package's field order.  The bucket range
is fixed by the ``BucketSpec``; the resolution is dynamic through the
uniform-collapse ``level`` (UDDSketch), capped at ``MAX_COLLAPSE_LEVEL``.

State is updated **in place**: ``add``, ``collapse``, ``collapse_to``,
``auto_collapse`` and ``merge`` (its left operand) write into the
sketch's own tensors and return it, the port's form of the JAX package's
functional updates.  The sketch's device picks the implementation of
every kernel it reaches: ``add`` goes through ``ops.bank_histograms``
with one row (two single-row histogram launches for ``"matmul"``, the
sort pipeline's scatter for ``"sort"``), the folds through the pair-fold
kernel and the queries through the fused bank query with K = 1, which
computes the reference's single-sketch Algorithm 2 exactly.

This module also keeps the row-level helpers the bank shares: the
counts-dtype rule, the effective guarantee of a collapse level, the
level-0 keys, the minimal level a key needs and the fold.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.ddsketch import DDSketch
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    MAX_COLLAPSE_LEVEL,
    BucketSpec,
    f32,
    raw_keys,
    shift_key,
)

__all__ = [
    "DeviceSketch",
    "empty",
    "add",
    "merge",
    "allreduce",
    "collapse",
    "collapse_to",
    "auto_collapse",
    "quantile",
    "quantiles",
    "to_host",
    "from_host",
    "bucket_values",
    "effective_alpha",
]

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


class DeviceSketch(NamedTuple):
    """One DDSketch as tensors: the nine fields of the JAX package's
    ``DeviceSketch``, in the same order (counts float32 or int32)."""

    pos: torch.Tensor  # (m,) bucket counts for positive values
    neg: torch.Tensor  # (m,) bucket counts for negative values (keys of |x|)
    zero: torch.Tensor  # () count of |x| <= min_indexable
    overflow: torch.Tensor  # () count of |x| clamped into the top bucket
    underflow: torch.Tensor  # () count of |x| clamped into bucket 0
    summ: torch.Tensor  # () running sum, float32
    vmin: torch.Tensor  # () exact running min, float32
    vmax: torch.Tensor  # () exact running max, float32
    level: torch.Tensor  # () int32 uniform-collapse level

    @property
    def count(self):
        return self.pos.sum() + self.neg.sum() + self.zero


def empty(spec: BucketSpec, counts_dtype=torch.float32, *, device) -> DeviceSketch:
    """A fresh sketch on ``device``; ``counts_dtype`` is float32 or int32."""
    m = spec.num_buckets
    cd = _counts_dtype(counts_dtype)
    f = dict(dtype=torch.float32, device=device)
    return DeviceSketch(
        pos=torch.zeros(m, dtype=cd, device=device),
        neg=torch.zeros(m, dtype=cd, device=device),
        zero=torch.zeros((), dtype=cd, device=device),
        overflow=torch.zeros((), dtype=cd, device=device),
        underflow=torch.zeros((), dtype=cd, device=device),
        summ=torch.zeros((), **f),
        vmin=torch.full((), math.inf, **f),
        vmax=torch.full((), -math.inf, **f),
        level=torch.zeros((), dtype=torch.int32, device=device),
    )


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


# --------------------------------------------------------------------- #
# insert (in place)
# --------------------------------------------------------------------- #
def add(
    sketch: DeviceSketch,
    values,
    weights=None,
    *,
    spec: BucketSpec,
    auto_collapse: bool = False,
    method: str | None = None,
) -> DeviceSketch:
    """Vectorized Algorithm 1 over a batch of values, in place.

    Non-finite entries are ignored; positive / negative / near-zero routing
    follows the host sketch.  With ``auto_collapse=True`` the sketch first
    collapses to the smallest level at which every batch value is
    indexable (one host read of that level), so nothing clamps; without
    it, out-of-range keys clamp into the edge buckets and are tallied in
    ``overflow`` / ``underflow``.  ``method`` pins the insert pipeline
    (``"matmul"`` / ``"sort"`` / ``"fused"``; None: ``ops.insert_method``,
    which picks matmul below 2^14 values and sort above).
    """
    dev = sketch.pos.device
    x = torch.as_tensor(values).reshape(-1).to(dev, torch.float32)
    raw_w = (
        None if weights is None else torch.as_tensor(weights).reshape(-1).to(dev, torch.float32)
    )
    w = torch.ones_like(x) if raw_w is None else raw_w
    finite = torch.isfinite(x)
    w = torch.where(finite, w, 0.0)
    mi = f32(spec.min_indexable)
    is_pos = finite & (x > mi)
    is_neg = finite & (x < -mi)
    binned = is_pos | is_neg
    is_zero = finite & ~binned

    k0 = _raw_keys(x, binned, spec)
    if auto_collapse and x.numel():
        needed = torch.where(binned, _needed_levels(k0, spec), 0).max()
        collapse_to(sketch, torch.maximum(sketch.level, needed), spec=spec)
    lev = sketch.level
    shifts = lev.expand(x.shape)
    pos_h, neg_h = ops.bank_histograms(
        x, None, raw_w, shifts, num_segments=1, spec=spec, method=method
    )

    # clamp accounting: shifted keys that escape [offset, offset + m - 1]
    k_lev = shift_key(k0, lev)
    over = binned & (k_lev > spec.offset + spec.num_buckets - 1)
    under = binned & (k_lev < spec.offset)
    contributes = finite & (w > 0)

    cd = sketch.pos.dtype
    sketch.pos.add_(pos_h[0].to(cd))
    sketch.neg.add_(neg_h[0].to(cd))
    sketch.zero.add_((w * is_zero).sum().to(cd))
    sketch.overflow.add_((w * over).sum().to(cd))
    sketch.underflow.add_((w * under).sum().to(cd))
    sketch.summ.add_((w * torch.where(finite, x, 0.0)).sum())
    if x.numel():
        torch.minimum(sketch.vmin, torch.where(contributes, x, math.inf).min(), out=sketch.vmin)
        torch.maximum(sketch.vmax, torch.where(contributes, x, -math.inf).max(), out=sketch.vmax)
    return sketch


# --------------------------------------------------------------------- #
# uniform collapse (UDDSketch), in place
# --------------------------------------------------------------------- #
def collapse(sketch: DeviceSketch, *, spec: BucketSpec) -> DeviceSketch:
    """One uniform-collapse step: fold pos/neg bucket pairs, level += 1.
    Count / sum / min / max are preserved exactly; unconditional (callers
    gate on ``MAX_COLLAPSE_LEVEL``)."""
    _fold(sketch.pos, spec, out=sketch.pos)
    _fold(sketch.neg, spec, out=sketch.neg)
    sketch.level.add_(1)
    return sketch


def collapse_to(sketch: DeviceSketch, target, *, spec: BucketSpec) -> DeviceSketch:
    """Fold until ``level >= target`` (clamped to ``MAX_COLLAPSE_LEVEL``);
    one host read of the number of steps."""
    target = torch.clamp(
        torch.as_tensor(target, dtype=torch.int32, device=sketch.level.device),
        0,
        MAX_COLLAPSE_LEVEL,
    )
    for _ in range(max(int(target - sketch.level), 0)):
        collapse(sketch, spec=spec)
    return sketch


def auto_collapse(
    sketch: DeviceSketch, *, spec: BucketSpec, threshold: float = 0.0
) -> DeviceSketch:
    """Reactive collapse: fold once when ``overflow + underflow`` exceeds
    ``threshold`` (level cap permitting) and reset the clamp counters.
    No host read: the fire flag rides the fold kernel's row mask."""
    fire = (sketch.overflow + sketch.underflow).to(torch.float32) > f32(threshold)
    fire = (fire & (sketch.level < MAX_COLLAPSE_LEVEL)).reshape(1)
    _fold(sketch.pos[None], spec, rows=fire, out=sketch.pos[None])
    _fold(sketch.neg[None], spec, rows=fire, out=sketch.neg[None])
    sketch.level.add_(fire[0].to(torch.int32))
    sketch.overflow.masked_fill_(fire[0], 0)
    sketch.underflow.masked_fill_(fire[0], 0)
    return sketch


def merge(a: DeviceSketch, b: DeviceSketch, *, spec: BucketSpec) -> DeviceSketch:
    """Algorithm 4 with mixed resolutions, into ``a`` in place: the finer
    operand collapses to the coarser level first (``b`` on a copy, so it
    is left as it was), then the buckets sum."""
    target = torch.maximum(a.level, b.level)
    collapse_to(a, target, spec=spec)
    b = collapse_to(DeviceSketch(*(t.clone() for t in b)), target, spec=spec)
    for dst, src in zip(a[:6], b[:6]):
        dst.add_(src.to(dst.dtype))
    torch.minimum(a.vmin, b.vmin, out=a.vmin)
    torch.maximum(a.vmax, b.vmax, out=a.vmax)
    return a


def allreduce(sketch: DeviceSketch, axis_name, *, spec: BucketSpec) -> DeviceSketch:
    """Cross-device Algorithm 4 belongs to the sharding slice."""
    raise NotImplementedError(
        "DeviceSketch.allreduce comes with multi-GPU sharding, which is not "
        "ported yet (ROADMAP.md queue 1 item 10)"
    )


# --------------------------------------------------------------------- #
# queries
# --------------------------------------------------------------------- #
def quantiles(sketch: DeviceSketch, qs, *, spec: BucketSpec) -> torch.Tensor:
    """Algorithm 2 for every q, shape ``(len(qs),)``: the fused bank query
    with K = 1 (the reference's single-sketch line search, the same
    arithmetic); NaN when the sketch is empty."""
    return ops.bank_quantiles(
        sketch.pos[None],
        sketch.neg[None],
        sketch.zero.reshape(1),
        sketch.vmin.reshape(1),
        sketch.vmax.reshape(1),
        sketch.level.reshape(1),
        qs,
        spec=spec,
    )[0]


def quantile(sketch: DeviceSketch, q, *, spec: BucketSpec) -> torch.Tensor:
    """One quantile, a 0-d tensor."""
    return quantiles(sketch, [float(q)], spec=spec)[0]


def bucket_values(spec: BucketSpec) -> np.ndarray:
    """Level-0 per-bucket estimates (row 0 of the per-level value table)."""
    from repro_torch.engine.tables import bucket_value_table  # no cycle

    return bucket_value_table(spec)[0]


# --------------------------------------------------------------------- #
# host <-> device
# --------------------------------------------------------------------- #
def to_host(sketch: DeviceSketch, spec: BucketSpec) -> DDSketch:
    """Flush the sketch into the exact, unbounded host sketch (lossless for
    integer-weight counts below 2^24).  The level transfers as the host
    ``collapse_level``; overflow / underflow do not transfer."""
    level = int(sketch.level)
    host = DDSketch(
        relative_accuracy=spec.relative_accuracy,
        max_bins=None,
        mapping=spec.mapping,
        store="dense",
        collapse_level=level,
    )
    pos = sketch.pos.detach().cpu().numpy()
    neg = sketch.neg.detach().cpu().numpy()
    for i in np.flatnonzero(pos):
        host.store.add(spec.offset + int(i), int(round(float(pos[i]))))
    for i in np.flatnonzero(neg):
        host.negative_store.add(spec.offset + int(i), int(round(float(neg[i]))))
    host.zero_count = int(round(float(sketch.zero)))
    vmin, vmax = float(sketch.vmin), float(sketch.vmax)
    host.min = vmin if math.isfinite(vmin) else math.inf
    host.max = vmax if math.isfinite(vmax) else -math.inf
    host.sum = float(sketch.summ)
    return host


def from_host(
    host: DDSketch, spec: BucketSpec, counts_dtype=torch.float32, *, device
) -> DeviceSketch:
    """Load a host sketch into device geometry (keys clamp into range).

    The host's ``collapse_level`` becomes the device level; a host sketch
    beyond ``MAX_COLLAPSE_LEVEL`` raises, since its keys cannot be
    represented.  Overflow / underflow restart at zero.
    """
    if int(host.collapse_level) > MAX_COLLAPSE_LEVEL:
        raise ValueError(
            f"host sketch is at collapse level {host.collapse_level}, beyond "
            f"the device cap MAX_COLLAPSE_LEVEL={MAX_COLLAPSE_LEVEL}; its "
            "level-keys cannot be represented in device geometry"
        )
    cd = _counts_dtype(counts_dtype)
    m = spec.num_buckets
    pos = np.zeros(m, np.float64)
    neg = np.zeros(m, np.float64)
    for key, cnt in host.store.items_ascending():
        pos[np.clip(key - spec.offset, 0, m - 1)] += cnt
    for key, cnt in host.negative_store.items_ascending():
        neg[np.clip(key - spec.offset, 0, m - 1)] += cnt
    sk = empty(spec, cd, device=device)
    sk.pos.copy_(torch.from_numpy(pos).to(cd))
    sk.neg.copy_(torch.from_numpy(neg).to(cd))
    sk.zero.fill_(host.zero_count)
    sk.summ.fill_(float(np.float32(host.sum)))
    if host.count:
        sk.vmin.fill_(float(np.float32(host.min)))
        sk.vmax.fill_(float(np.float32(host.max)))
    sk.level.fill_(int(host.collapse_level))
    return sk
