"""SketchBank: K independent DDSketches as stacked ``(K, m)`` tensors.

The multi-tenant bank of the serving path: one fixed-geometry sketch per
metric key, so inserting a stream of ``(value, sketch_id)`` pairs is one
segmented histogram (the fused ingest kernel, or the matmul / sort insert
pipelines when pinned), ``merge`` is a per-bucket sum after the rows align
their collapse levels, and ``quantiles_impl`` answers every row and every
q in one fused query.  Each row carries its own uniform-collapse ``level``
(UDDSketch).

State is updated **in place**: ``add_impl``, ``collapse``, ``collapse_to``,
``auto_collapse``, ``merge`` (its left operand) and ``set_row`` write into
the bank's own tensors and return the bank.  This is the port's form of
the JAX engine's buffer donation; callers that need the old state clone it
first.
The bank's device picks the implementation of every kernel it reaches (the
hand-written CUDA kernel on the card, the plain version on the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import torch_sketch
from repro_torch.core.ddsketch import DDSketch
from repro_torch.core.torch_sketch import DeviceSketch
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MAX_COLLAPSE_LEVEL, BucketSpec, f32, shift_key

__all__ = [
    "SketchBank",
    "empty",
    "add_impl",
    "quantiles_impl",
    "merge",
    "collapse",
    "collapse_to",
    "auto_collapse",
    "row",
    "set_row",
    "to_host",
    "from_host",
    "to_numpy",
    "from_numpy",
]


class SketchBank(NamedTuple):
    """K stacked DDSketch states (leading axis = sketch id); the nine
    fields of the JAX package's ``SketchBank``, in the same order."""

    pos: torch.Tensor  # (K, m) bucket counts for positive values
    neg: torch.Tensor  # (K, m) bucket counts for negative values (keys of |x|)
    zero: torch.Tensor  # (K,) counts of |x| <= min_indexable
    overflow: torch.Tensor  # (K,) counts of |x| clamped into the top bucket
    underflow: torch.Tensor  # (K,) counts of |x| clamped into bucket 0
    summ: torch.Tensor  # (K,) running sums, float32
    vmin: torch.Tensor  # (K,) exact running mins, float32
    vmax: torch.Tensor  # (K,) exact running maxs, float32
    level: torch.Tensor  # (K,) int32 per-row uniform-collapse levels

    @property
    def num_sketches(self) -> int:
        return self.pos.shape[0]

    @property
    def counts(self):
        """Per-sketch total counts, shape (K,) (tensors or numpy leaves)."""
        return self.pos.sum(1) + self.neg.sum(1) + self.zero


def empty(
    spec: BucketSpec, num_sketches: int, counts_dtype=torch.float32, *, device
) -> SketchBank:
    """Fresh bank on ``device``; ``counts_dtype`` is float32 or int32."""
    k, m = int(num_sketches), spec.num_buckets
    cd = torch_sketch._counts_dtype(counts_dtype)
    f = dict(dtype=torch.float32, device=device)
    return SketchBank(
        pos=torch.zeros((k, m), dtype=cd, device=device),
        neg=torch.zeros((k, m), dtype=cd, device=device),
        zero=torch.zeros(k, dtype=cd, device=device),
        overflow=torch.zeros(k, dtype=cd, device=device),
        underflow=torch.zeros(k, dtype=cd, device=device),
        summ=torch.zeros(k, **f),
        vmin=torch.full((k,), math.inf, **f),
        vmax=torch.full((k,), -math.inf, **f),
        level=torch.zeros(k, dtype=torch.int32, device=device),
    )


def _check_method(method) -> None:
    if method not in (None, "fused", "matmul", "sort"):
        raise ValueError(f"method must be None, 'fused', 'matmul' or 'sort', got {method!r}")


def add_impl(
    bank: SketchBank,
    values: torch.Tensor,
    sketch_ids: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    spec: BucketSpec,
    auto_collapse: bool = False,
    method: str | None = None,
) -> SketchBank:
    """Vectorized Algorithm 1 over ``(value, sketch_id)`` pairs, in place.

    Non-finite values and out-of-range ids are ignored; each value is keyed
    at its row's collapse level.  With ``auto_collapse=True`` every touched
    row first collapses to the smallest level at which all of its batch
    values are indexable, so nothing clamps.

    ``method`` picks the insert pipeline.  None and ``"fused"`` take the
    fused ingest kernel (histograms and the six row stats in one launch):
    a float32 bank takes its in-place form (``ops.fused_ingest_into``),
    which adds every lane straight into the bank's leaves; an int32 bank
    takes the delta form and adds the delta cast to int32, as the
    reference does.
    ``"matmul"`` (two segment-histogram launches) and ``"sort"`` (the
    compaction and the scatter launch) go through ``ops.bank_histograms``
    and then one pass for the row stats (``index_add_`` and
    ``scatter_reduce_``).  The JAX package's off-TPU auto rule
    (``picked_insert_method``) was tuned on XLA CPU, not on the card, so
    ``method=None`` stays on the fused kernel here.  All pipelines give the
    same histograms and counters for integer weights; ``summ`` differs in
    summation order.
    """
    _check_method(method)
    k = bank.num_sketches
    dev = bank.pos.device
    x = torch.as_tensor(values).reshape(-1).to(dev, torch.float32)
    s = torch.as_tensor(sketch_ids).reshape(-1).to(dev, torch.int32)
    raw_w = (
        None
        if weights is None
        else torch.as_tensor(weights).reshape(-1).to(dev, torch.float32)
    )
    sc = torch.clamp(s, 0, max(k - 1, 0)).to(torch.int64)
    fused = method in (None, "fused")
    if auto_collapse or not fused:  # the level-0 keys of the valid pos/neg lanes
        mi = f32(spec.min_indexable)
        valid = torch.isfinite(x) & (s >= 0) & (s < k)
        binned = valid & ((x > mi) | (x < -mi))
        k0 = torch_sketch._raw_keys(x, binned, spec)
    if auto_collapse:
        needed = torch.where(binned, torch_sketch._needed_levels(k0, spec), 0)
        per_row = torch.zeros(k, dtype=torch.int32, device=dev)
        per_row.scatter_reduce_(0, sc, needed.to(torch.int32), "amax")
        collapse_to(bank, torch.maximum(bank.level, per_row), spec=spec)
    shifts = bank.level[sc]  # per-value levels for the kernels

    leaves = ops.IngestStats(*bank[2:8])
    if fused and bank.pos.dtype == torch.float32:  # straight into the bank's leaves
        ops.fused_ingest_into(bank.pos, bank.neg, leaves, x, s, raw_w, shifts, spec=spec)
        return bank
    if fused:
        pos_h, neg_h, delta = ops.fused_ingest(x, s, raw_w, shifts, num_segments=k, spec=spec)
    else:
        pos_h, neg_h = ops.bank_histograms(
            x, s, raw_w, shifts, num_segments=k, spec=spec, method=method
        )
        # the row stats: clamp accounting of the level-shifted keys, the
        # zero counter, the sum and the extrema of lanes with w > 0
        w = torch.where(valid, torch.ones_like(x) if raw_w is None else raw_w, 0.0)
        k_lev = shift_key(k0, shifts)
        over = binned & (k_lev > spec.offset + spec.num_buckets - 1)
        under = binned & (k_lev < spec.offset)
        is_zero = valid & ~binned
        cols = torch.stack([w * is_zero, w * over, w * under, w * torch.where(valid, x, 0.0)], 1)
        stats = torch.zeros((k, 4), dtype=torch.float32, device=dev).index_add_(0, sc, cols).T
        contributes = valid & (w > 0)
        vmin = torch.full((k,), math.inf, dtype=torch.float32, device=dev)
        vmax = torch.full((k,), -math.inf, dtype=torch.float32, device=dev)
        vmin.scatter_reduce_(0, sc, torch.where(contributes, x, math.inf), "amin")
        vmax.scatter_reduce_(0, sc, torch.where(contributes, x, -math.inf), "amax")
        delta = ops.IngestStats(*stats, vmin, vmax)
    ops.add_delta(bank.pos, bank.neg, leaves, pos_h, neg_h, delta)
    return bank


# --------------------------------------------------------------------- #
# per-row uniform collapse (UDDSketch lifted over the bank axis)
# --------------------------------------------------------------------- #
def collapse(
    bank: SketchBank, rows: torch.Tensor | None = None, *, spec: BucketSpec
) -> SketchBank:
    """One uniform-collapse step on the selected rows (all if None), in
    place: selected rows fold their pos/neg bucket pairs and bump their
    level; count / sum / min / max are preserved exactly."""
    if rows is None:
        rows = torch.ones(bank.num_sketches, dtype=torch.bool, device=bank.pos.device)
    rows = torch.as_tensor(rows, device=bank.pos.device).to(torch.bool)
    torch_sketch._fold(bank.pos, spec, rows=rows, out=bank.pos)
    torch_sketch._fold(bank.neg, spec, rows=rows, out=bank.neg)
    bank.level.add_(rows.to(torch.int32))
    return bank


def collapse_to(bank: SketchBank, target, *, spec: BucketSpec) -> SketchBank:
    """Fold each row until its level reaches ``target`` (scalar or (K,)),
    clamped to ``MAX_COLLAPSE_LEVEL``, in place.

    A loop bounded by ``MAX_COLLAPSE_LEVEL`` with one host sync (the
    number of steps the furthest row needs); each step folds only the rows
    still below their target.
    """
    dev = bank.level.device
    target = torch.clamp(
        torch.as_tensor(target, dtype=torch.int32, device=dev), 0, MAX_COLLAPSE_LEVEL
    ).expand(bank.level.shape)
    steps = int(torch.clamp(target - bank.level, min=0).max()) if bank.num_sketches else 0
    for _ in range(steps):
        collapse(bank, bank.level < target, spec=spec)
    return bank


def auto_collapse(
    bank: SketchBank, *, spec: BucketSpec, threshold: float = 0.0
) -> SketchBank:
    """Reactive collapse, in place: fold rows whose clamped mass exceeds
    ``threshold`` (level cap permitting) and reset their clamp counters."""
    clamped = (bank.overflow + bank.underflow).to(torch.float32)
    fire = (clamped > threshold) & (bank.level < MAX_COLLAPSE_LEVEL)
    collapse(bank, fire, spec=spec)
    bank.overflow.masked_fill_(fire, 0)
    bank.underflow.masked_fill_(fire, 0)
    return bank


def merge(a: SketchBank, b: SketchBank, *, spec: BucketSpec) -> SketchBank:
    """Algorithm 4 over all K rows, into ``a`` in place.

    Each row pair aligns to the coarser of the two levels (the finer row
    collapses first), then sums per bucket.  ``b`` is left as it was (it is
    aligned on a copy)."""
    target = torch.maximum(a.level, b.level)
    collapse_to(a, target, spec=spec)
    b = collapse_to(SketchBank(*(t.clone() for t in b)), target, spec=spec)
    for dst, src in zip(a[:6], b[:6]):
        dst.add_(src.to(dst.dtype))
    torch.minimum(a.vmin, b.vmin, out=a.vmin)
    torch.maximum(a.vmax, b.vmax, out=a.vmax)
    return a


# --------------------------------------------------------------------- #
# queries: Algorithm 2 fused over all K rows and all qs at once
# --------------------------------------------------------------------- #
def quantiles_impl(bank: SketchBank, qs, *, spec: BucketSpec) -> torch.Tensor:
    """Per-row quantile estimates ``(K, len(qs))`` from one fused query;
    all-empty rows answer NaN."""
    return ops.bank_quantiles(
        bank.pos, bank.neg, bank.zero, bank.vmin, bank.vmax, bank.level, qs, spec=spec
    )


# --------------------------------------------------------------------- #
# row access
# --------------------------------------------------------------------- #
def row(bank: SketchBank, k: int) -> DeviceSketch:
    """Row ``k`` as a standalone ``DeviceSketch`` of copies: a view would be
    overwritten by the bank's next in-place tick."""
    return DeviceSketch(*(field[k].clone() for field in bank))


def set_row(bank: SketchBank, k: int, sketch: DeviceSketch) -> SketchBank:
    """Replace row ``k`` with a ``DeviceSketch``'s state, in place."""
    for bf, sf in zip(bank, sketch):
        bf[k].copy_(sf)
    return bank


# --------------------------------------------------------------------- #
# host <-> device moves
# --------------------------------------------------------------------- #
def _host(x) -> np.ndarray:
    """A host copy (never a view: the bank is updated in place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def to_numpy(state):
    """The nine leaves of a bank, a slab or a ``DeviceSketch`` as numpy
    arrays, in field order and in the same NamedTuple (one copy each)."""
    return type(state)(*(_host(t) for t in state))


def from_numpy(leaves: Sequence, *, device):
    """A bank, a slab or a single sketch on ``device`` from nine leaves in
    the JAX package's field order (``jax.tree.map(np.asarray, state)`` gives
    them).  ``(m,)`` bucket leaves make a ``DeviceSketch``, ``(K, m)`` a
    ``SketchBank`` and ``(nodes, K, m)`` a slab (a ``SketchBank`` with a
    leading node axis on every leaf).  Counts keep their dtype, which must
    be float32 or int32; ``summ`` / ``vmin`` / ``vmax`` are float32 and
    ``level`` int32.  The state owns copies, so its in-place updates never
    reach ``leaves``."""
    leaves = [np.asarray(x) for x in leaves]
    if len(leaves) != len(SketchBank._fields):
        raise ValueError(f"expected {len(SketchBank._fields)} leaves, got {len(leaves)}")
    if leaves[0].ndim not in (1, 2, 3):
        raise ValueError(f"bucket leaves must be (m,), (K, m) or (nodes, K, m), "
                         f"got {leaves[0].shape}")
    cd = torch_sketch._counts_dtype(leaves[0].dtype)
    dtypes = [cd] * 5 + [torch.float32] * 3 + [torch.int32]
    kind = DeviceSketch if leaves[0].ndim == 1 else SketchBank
    return kind(*(torch.tensor(x, dtype=dt, device=device) for x, dt in zip(leaves, dtypes)))


def to_host(bank: SketchBank, spec: BucketSpec, k: int) -> DDSketch:
    """Flush row ``k`` into the exact, unbounded host sketch (lossless for
    integer-weight counts below 2^24).  The row's collapse level transfers
    as the host ``collapse_level``; overflow / underflow do not transfer.
    Leaves may be tensors on any device or numpy arrays."""
    level = int(_host(bank.level[k]))
    host = DDSketch(
        relative_accuracy=spec.relative_accuracy,
        max_bins=None,
        mapping=spec.mapping,
        store="dense",
        collapse_level=level,
    )
    pos = _host(bank.pos[k])
    neg = _host(bank.neg[k])
    for i in np.flatnonzero(pos):
        host.store.add(spec.offset + int(i), int(round(float(pos[i]))))
    for i in np.flatnonzero(neg):
        host.negative_store.add(spec.offset + int(i), int(round(float(neg[i]))))
    host.zero_count = int(round(float(_host(bank.zero[k]))))
    vmin, vmax = float(_host(bank.vmin[k])), float(_host(bank.vmax[k]))
    host.min = vmin if math.isfinite(vmin) else math.inf
    host.max = vmax if math.isfinite(vmax) else -math.inf
    host.sum = float(_host(bank.summ[k]))
    return host


def from_host(
    hosts: Sequence[DDSketch], spec: BucketSpec, counts_dtype=torch.float32, *, device
) -> SketchBank:
    """Stack host sketches into a bank on ``device``, one per row (keys
    clamp into range); overflow / underflow restart at zero and per-row
    levels come from each host's ``collapse_level``."""
    cd = torch_sketch._counts_dtype(counts_dtype)
    k, m = len(hosts), spec.num_buckets
    pos = np.zeros((k, m), np.float64)
    neg = np.zeros((k, m), np.float64)
    zero = np.zeros(k, np.float64)
    summ = np.zeros(k, np.float32)
    vmin = np.full(k, np.inf, np.float32)
    vmax = np.full(k, -np.inf, np.float32)
    level = np.zeros(k, np.int32)
    for r, h in enumerate(hosts):
        if int(h.collapse_level) > MAX_COLLAPSE_LEVEL:
            raise ValueError(
                f"host sketch is at collapse level {h.collapse_level}, beyond "
                f"the device cap MAX_COLLAPSE_LEVEL={MAX_COLLAPSE_LEVEL}"
            )
        level[r] = int(h.collapse_level)
        for key, cnt in h.store.items_ascending():
            pos[r, np.clip(key - spec.offset, 0, m - 1)] += cnt
        for key, cnt in h.negative_store.items_ascending():
            neg[r, np.clip(key - spec.offset, 0, m - 1)] += cnt
        zero[r] = h.zero_count
        summ[r] = float(h.sum)
        if h.count:
            vmin[r], vmax[r] = h.min, h.max
    counts_np = np.float32 if cd == torch.float32 else np.int32
    return from_numpy(
        [
            pos.astype(counts_np),
            neg.astype(counts_np),
            zero.astype(counts_np),
            np.zeros(k, counts_np),
            np.zeros(k, counts_np),
            summ,
            vmin,
            vmax,
            level,
        ],
        device=device,
    )
