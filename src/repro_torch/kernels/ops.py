"""Front doors of the port's kernels: ``fused_ingest`` and
``fused_ingest_into``, ``fold_pairs``, ``bank_quantiles``,
``bank_range_merge`` and ``bank_range_merge_nodes``, ``segment_histogram``,
``ddsketch_histogram`` and ``ddsketch_scatter``, plus the insert-pipeline
router ``bank_histograms`` and its rule ``insert_method``.

The device of the tensors decides the implementation; there is no
``force=`` pin and no fallback.  A CUDA tensor always launches the
hand-written kernel (``ddsketch_ingest_cuda`` / ``_into_cuda``,
``fold_pairs_cuda``, ``bank_quantiles_cuda``, ``bank_range_merge_cuda`` /
``_nodes_cuda``, ``segment_histogram_cuda``, ``histogram_cuda``,
``scatter_cuda``) and a failed build or launch raises; a CPU tensor takes
the plain PyTorch version from ``ref``.  Each front door does the JAX
package's input glue (flatten, cast, default weights / levels) before
handing contiguous tensors to the kernel wrapper.

``dispatch_stats()`` reports one launch counter per kernel, bumped by the
wrappers where they launch and nowhere else; ``reset_dispatch_stats()``
zeroes them.  The JAX package's TPU size heuristics and resident-row
ceiling are VMEM artefacts and have no counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bank_quantiles import bank_quantiles_cuda
from repro_torch.kernels.bank_range_merge import (
    bank_range_merge_cuda,
    bank_range_merge_nodes_cuda,
)
from repro_torch.kernels.ddsketch_hist import histogram_cuda
from repro_torch.kernels.ddsketch_ingest import ddsketch_ingest_cuda, ddsketch_ingest_into_cuda
from repro_torch.kernels.ddsketch_scatter import scatter_cuda
from repro_torch.kernels.ddsketch_seg_hist import segment_histogram_cuda
from repro_torch.kernels.fold_pairs import fold_pairs_cuda
from repro_torch.kernels.ref import (
    MAX_COLLAPSE_LEVEL,
    BucketSpec,
    IngestStats,
    bank_quantiles_ref,
    bank_range_merge_ref,
    compact_triples,
    f32,
    fold_pairs_ref,
    fused_ingest_ref,
    histogram_ref,
    scatter_histogram_ref,
    segment_histogram_ref,
)

__all__ = [
    "BucketSpec",
    "IngestStats",
    "add_delta",
    "bank_histograms",
    "bank_quantiles",
    "bank_range_merge",
    "bank_range_merge_nodes",
    "ddsketch_histogram",
    "ddsketch_scatter",
    "dispatch_stats",
    "fold_pairs",
    "fused_ingest",
    "fused_ingest_into",
    "insert_method",
    "reset_dispatch_stats",
    "segment_histogram",
]

_METHOD_VALUES = (None, "matmul", "sort", "fused")


def dispatch_stats() -> dict:
    """Kernel launch counters since the last reset (a copy)."""
    return {"launches": dict(_build.LAUNCHES)}


def reset_dispatch_stats() -> None:
    _build.reset_launches()


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"tensors must lie on a CUDA device or the CPU, got {t.device}")
    return False


def _lanes(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    """A flat contiguous lane tensor of ``dtype`` (None stays None)."""
    return None if t is None else t.reshape(-1).to(dtype).contiguous()


def fused_ingest(
    values: torch.Tensor,
    segment_ids: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    levels: torch.Tensor | None = None,
    *,
    num_segments: int,
    spec: BucketSpec,
) -> tuple[torch.Tensor, torch.Tensor, IngestStats]:
    """The fused single-dispatch ingest: ``(pos, neg, IngestStats)``.

    Both ``(K, m)`` sign stores and the six per-row stats from one kernel
    launch (CUDA) or one plain pass (CPU).  Histograms and counters are
    exact for integer-valued weights; ``summ`` depends on accumulation
    order (atomics on the card).
    """
    k = int(num_segments)
    if not _on_cuda(values):
        both, stats = fused_ingest_ref(
            values, segment_ids, weights, levels, num_segments=k, spec=spec
        )
        return both[:k], both[k:], stats
    x = _lanes(values, torch.float32)
    if segment_ids is None:
        if k != 1:
            raise ValueError("segment_ids may be omitted only for a single-row bank")
        s = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    else:
        s = _lanes(segment_ids, torch.int32)
    both, stats = ddsketch_ingest_cuda(
        x, s, _lanes(weights, torch.float32), _lanes(levels, torch.int32),
        num_segments=k, spec=spec,
    )
    return both[:k], both[k:], stats


def fused_ingest_into(
    pos: torch.Tensor,
    neg: torch.Tensor,
    stats: IngestStats,
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    weights: torch.Tensor | None = None,
    levels: torch.Tensor | None = None,
    *,
    spec: BucketSpec,
) -> None:
    """The fused ingest, in place: the lanes add into ``pos`` / ``neg``
    (``(K, m)``) and fold into the six ``(K,)`` ``stats`` leaves (counters
    and ``summ`` add, extrema take the min / max).

    On the card one kernel launch writes float32 leaves directly, with no
    delta histogram.  On the CPU the plain version is ``fused_ingest_ref``
    followed by the adds, each cast to its leaf's dtype.
    """
    k = pos.shape[0]
    if _on_cuda(values):
        ddsketch_ingest_into_cuda(
            _lanes(values, torch.float32), _lanes(segment_ids, torch.int32),
            _lanes(weights, torch.float32), _lanes(levels, torch.int32),
            pos=pos, neg=neg, stats=stats, spec=spec,
        )
        return
    both, delta = fused_ingest_ref(values, segment_ids, weights, levels, num_segments=k, spec=spec)
    add_delta(pos, neg, stats, both[:k], both[k:], delta)


def add_delta(
    pos: torch.Tensor,
    neg: torch.Tensor,
    stats: IngestStats,
    pos_delta: torch.Tensor,
    neg_delta: torch.Tensor,
    delta: IngestStats,
) -> None:
    """Fold a delta (two ``(K, m)`` histograms and their ``IngestStats``)
    into a bank's leaves in place: counters and ``summ`` add, each cast to
    its leaf's dtype; extrema take the min / max."""
    pos.add_(pos_delta.to(pos.dtype))
    neg.add_(neg_delta.to(neg.dtype))
    for leaf, d in zip(stats[:4], delta[:4]):
        leaf.add_(d.to(leaf.dtype))
    torch.minimum(stats.vmin, delta.vmin, out=stats.vmin)
    torch.maximum(stats.vmax, delta.vmax, out=stats.vmax)


def fold_pairs(
    counts: torch.Tensor,
    *,
    spec: BucketSpec,
    rows: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One uniform-collapse fold of ``counts`` (``(K, m)`` or ``(m,)``).

    Bucket pairs with keys (2j-1, 2j) merge into key j on every row that
    the optional ``(K,)`` bool ``rows`` mask selects; other rows keep their
    counts.  ``out`` may be ``counts`` itself (fold in place).  Exact for
    float32 and int32 counts.
    """
    m = spec.num_buckets
    flat = counts.reshape(-1, m)
    if out is not None and out.shape != counts.shape:
        raise ValueError(f"out {tuple(out.shape)} vs counts {tuple(counts.shape)}")
    if _on_cuda(counts):
        res = fold_pairs_cuda(
            flat.contiguous(),
            spec=spec,
            rows=None if rows is None else rows.reshape(-1).to(torch.bool),
            out=None if out is None else out.reshape(-1, m),
        )
        return res.reshape(counts.shape)
    folded = fold_pairs_ref(flat, spec=spec)
    if rows is not None:
        folded = torch.where(rows.reshape(-1, 1).to(torch.bool), folded, flat)
    if out is None:
        return folded.reshape(counts.shape)
    return out.copy_(folded.reshape(counts.shape))


def bank_quantiles(
    pos: torch.Tensor,
    neg: torch.Tensor,
    zero: torch.Tensor,
    vmin: torch.Tensor,
    vmax: torch.Tensor,
    level: torch.Tensor,
    qs,
    *,
    spec: BucketSpec,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused Algorithm 2 over all K rows and all qs: ``(K, len(qs))``.

    Per-row collapse levels select the row's line from the per-level value
    table (``table=None`` takes the cached per-(spec, device) copy).
    Counts of any dtype are read as float32 for the rank math; empty rows
    answer NaN.
    """
    dev = pos.device
    if table is None:
        from repro_torch.engine.tables import device_value_table  # no cycle

        table = device_value_table(spec, dev)
    qf = torch.as_tensor(qs, dtype=torch.float32).reshape(-1).to(dev)
    if not _on_cuda(pos):
        return bank_quantiles_ref(pos, neg, zero, vmin, vmax, level, qf, table)
    cd = pos.dtype if pos.dtype in (torch.float32, torch.int32) else torch.float32
    return bank_quantiles_cuda(
        pos.to(cd).contiguous(),
        neg.to(cd).contiguous(),
        zero.to(cd).reshape(-1).contiguous(),
        vmin.to(torch.float32).reshape(-1).contiguous(),
        vmax.to(torch.float32).reshape(-1).contiguous(),
        level.to(torch.int32).reshape(-1).contiguous(),
        qf.contiguous(),
        table.to(torch.float32).contiguous(),
    )


def bank_range_merge(
    counts: torch.Tensor,
    deltas: torch.Tensor,
    *,
    spec: BucketSpec,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused slice-range merge: ``counts (D, R, m), deltas (D, R) -> (R, m)``.

    Folds every slice row ``counts[d, r]`` by ``deltas[d, r]`` collapse
    levels and sums the slice axis, so a whole window merge is one launch.
    Deltas are clipped to ``[0, MAX_COLLAPSE_LEVEL]``; ``valid`` is an
    optional ``(D,)`` 0/1 slice mask, and a dead slice gets the sentinel
    delta -1, so it contributes nothing without its counts being zeroed.
    Exact for integer-valued counts.
    """
    if not _on_cuda(counts):
        return bank_range_merge_ref(counts, deltas, spec=spec, valid=valid)
    d = torch.clamp(deltas.to(torch.int32), 0, MAX_COLLAPSE_LEVEL)
    if valid is not None:
        v = valid.to(device=counts.device, dtype=torch.float32).reshape(-1, 1)
        d = torch.where(v > 0, d, -1)
    return bank_range_merge_cuda(
        counts.to(torch.float32).contiguous(), d.contiguous(), spec=spec
    )


def bank_range_merge_nodes(
    slab_pos: torch.Tensor,
    slab_neg: torch.Tensor,
    nodes: torch.Tensor,
    valid: torch.Tensor,
    bank_pos: torch.Tensor,
    bank_neg: torch.Tensor,
    live: torch.Tensor,
    deltas: torch.Tensor,
    *,
    spec: BucketSpec,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A window query's range merge, read where the slices lie: ``(pos,
    neg)``, each ``(K, m)`` float32.

    The slices are the ``(D,)`` ``nodes`` of the slab's ``(nodes, K, m)``
    stores, then the live bank; ``deltas`` is ``(D + 1, K)`` (row D for the
    live bank), clipped to ``[0, MAX_COLLAPSE_LEVEL]``.  ``valid`` (the
    ``(D,)`` 0/1 node mask; padding entries point at node 0) and the 0-d
    ``live`` gate mark dead slices, which contribute nothing and are never
    read.  On the card both stores ride one kernel launch that reads the
    slab in place; on the CPU the plain version stacks the slices into a
    ``(D + 1, 2K, m)`` block and runs ``bank_range_merge`` over it.  Exact
    for integer-valued counts.
    """
    k = bank_pos.shape[0]
    mask = torch.cat([valid.to(torch.float32).reshape(-1), live.to(torch.float32).reshape(1)])
    if not _on_cuda(slab_pos):
        f32_ = torch.float32
        counts = torch.cat([
            torch.cat([slab.index_select(0, nodes).to(f32_), bank.to(f32_)[None]])
            for slab, bank in ((slab_pos, bank_pos), (slab_neg, bank_neg))
        ], dim=1)
        merged = bank_range_merge(counts, torch.cat([deltas, deltas], dim=1), spec=spec,
                                  valid=mask)
        return merged[:k], merged[k:]
    d = torch.clamp(deltas.to(torch.int32), 0, MAX_COLLAPSE_LEVEL)
    d = torch.where(mask.to(d.device)[:, None] > 0, d, -1)
    return bank_range_merge_nodes_cuda(
        slab_pos, slab_neg, nodes.to(torch.int32), bank_pos, bank_neg, d.contiguous(), spec=spec
    )


def insert_method(n: int, full_ingest: bool = False) -> str:
    """Pick ``"matmul"``, ``"sort"`` or ``"fused"`` for an insert of ``n``
    values.

    The JAX package's off-TPU size rule, kept so both packages make the
    same choices: batches below 2^14 lanes take matmul (the two segment
    histograms), larger ones the fused ingest when the caller wants the
    stats too (``full_ingest``) and the sort pipeline otherwise.  The rule
    was tuned on XLA CPU, not on the card.  ``method=`` pins the pipeline
    at every entry point that reads this rule.
    """
    if n < (1 << 14):
        return "matmul"
    return "fused" if full_ingest else "sort"


def ddsketch_histogram(
    values: torch.Tensor,
    weights: torch.Tensor | None = None,
    levels: torch.Tensor | None = None,
    *,
    spec: BucketSpec,
) -> torch.Tensor:
    """Bucket counts ``(m,)`` of the positive finite entries of ``values``;
    ``levels`` holds per-value collapse levels (None = level 0)."""
    if not _on_cuda(values):
        return histogram_ref(values, weights, levels, spec=spec)
    return histogram_cuda(
        _lanes(values, torch.float32),
        _lanes(weights, torch.float32),
        _lanes(levels, torch.int32),
        spec=spec,
    )


def segment_histogram(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    weights: torch.Tensor | None = None,
    levels: torch.Tensor | None = None,
    *,
    num_segments: int,
    spec: BucketSpec,
) -> torch.Tensor:
    """Per-segment bucket counts ``(num_segments, m)`` in one launch for
    the whole bank; ``levels`` holds per-value collapse levels."""
    if not _on_cuda(values):
        return segment_histogram_ref(
            values, segment_ids, weights, levels, num_segments=num_segments, spec=spec
        )
    return segment_histogram_cuda(
        _lanes(values, torch.float32),
        _lanes(segment_ids, torch.int32),
        _lanes(weights, torch.float32),
        _lanes(levels, torch.int32),
        num_segments=num_segments,
        spec=spec,
    )


def ddsketch_scatter(
    keys: torch.Tensor, weights: torch.Tensor, *, num_rows: int, num_buckets: int
) -> torch.Tensor:
    """Accumulate composite-key triples into ``(num_rows, num_buckets)``;
    keys outside ``[0, num_rows * num_buckets)`` contribute nothing.
    Bit-exact for the unique keys ``compact_triples`` emits."""
    if not _on_cuda(keys):
        return scatter_histogram_ref(keys, weights, num_rows=num_rows, num_buckets=num_buckets)
    return scatter_cuda(
        _lanes(keys, torch.int32),
        _lanes(weights, torch.float32),
        num_rows=num_rows,
        num_buckets=num_buckets,
    )


def bank_histograms(
    values: torch.Tensor,
    segment_ids: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    levels: torch.Tensor | None = None,
    *,
    num_segments: int,
    spec: BucketSpec,
    method: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both sign stores of a bank insert: ``(pos, neg)``, each ``(K, m)``.

    ``method`` picks the pipeline (None: ``insert_method``): ``"matmul"``
    masks each sign and runs the segment histogram twice (the single-row
    histogram when ``segment_ids`` is None, which needs ``num_segments ==
    1``); ``"sort"`` runs the sort-reduce-scatter pipeline over one
    composite-key stream into the stacked ``(2K, m)`` layout;
    ``"fused"`` runs the fused ingest and drops its stats.

    The sort pipeline is the same on both devices: ``compact_triples``
    (plain torch) packs U <= min(N, 2Km + 1) unique triples to the front, a
    static slice to that bound needs no sync, and ``ddsketch_scatter`` adds
    them (the kernel on the card, ``scatter_histogram_ref`` on the CPU).
    All pipelines give the same counts: bit for bit for integer weights;
    fractional weights may differ in the last ulps where the order of
    accumulation differs.
    """
    if method not in _METHOD_VALUES:
        raise ValueError(f"method must be one of {_METHOD_VALUES}, got {method!r}")
    if segment_ids is None and num_segments != 1:
        raise ValueError(
            "segment_ids may be omitted only for a single-row bank "
            f"(num_segments=1), got num_segments={num_segments}"
        )
    k, m = int(num_segments), spec.num_buckets
    n = values.numel()
    if method is None:
        method = insert_method(n)
    if method == "fused":
        pos, neg, _ = fused_ingest(
            values, segment_ids, weights, levels, num_segments=k, spec=spec
        )
        return pos, neg
    if method == "matmul":
        x = values.reshape(-1).to(torch.float32)
        mi = f32(spec.min_indexable)
        pos_vals = torch.where(x > mi, x, -1.0)
        neg_vals = torch.where(x < -mi, -x, -1.0)
        if segment_ids is None:
            pos = ddsketch_histogram(pos_vals, weights, levels, spec=spec)[None]
            neg = ddsketch_histogram(neg_vals, weights, levels, spec=spec)[None]
        else:
            kw = dict(num_segments=k, spec=spec)
            pos = segment_histogram(pos_vals, segment_ids, weights, levels, **kw)
            neg = segment_histogram(neg_vals, segment_ids, weights, levels, **kw)
        return pos, neg
    keys, wts = compact_triples(
        values, segment_ids, weights, levels, num_segments=k, spec=spec
    )
    cap = min(n, 2 * k * m + 1)
    both = ddsketch_scatter(keys[:cap], wts[:cap], num_rows=2 * k, num_buckets=m)
    return both[:k], both[k:]
