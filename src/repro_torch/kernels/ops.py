"""Front doors of the serving path's kernels: ``fused_ingest``,
``fold_pairs`` and ``bank_quantiles``.

The device of the tensors decides the implementation; there is no
``force=`` pin and no fallback.  A CUDA tensor always launches the
hand-written kernel (``ddsketch_ingest_cuda``, ``fold_pairs_cuda``,
``bank_quantiles_cuda``) and a failed build or launch raises; a CPU tensor
takes the plain PyTorch version from ``ref``.  Each front door does the
JAX package's input glue (flatten, cast, default weights / levels) before
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
from repro_torch.kernels.ddsketch_ingest import ddsketch_ingest_cuda
from repro_torch.kernels.fold_pairs import fold_pairs_cuda
from repro_torch.kernels.ref import (
    BucketSpec,
    IngestStats,
    bank_quantiles_ref,
    fold_pairs_ref,
    fused_ingest_ref,
)

__all__ = [
    "BucketSpec",
    "IngestStats",
    "bank_quantiles",
    "dispatch_stats",
    "fold_pairs",
    "fused_ingest",
    "reset_dispatch_stats",
]


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
    x = values.reshape(-1).to(torch.float32).contiguous()
    if segment_ids is None:
        if k != 1:
            raise ValueError("segment_ids may be omitted only for a single-row bank")
        s = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    else:
        s = segment_ids.reshape(-1).to(torch.int32).contiguous()
    w = None if weights is None else weights.reshape(-1).to(torch.float32).contiguous()
    lev = None if levels is None else levels.reshape(-1).to(torch.int32).contiguous()
    both, stats = ddsketch_ingest_cuda(x, s, w, lev, num_segments=k, spec=spec)
    return both[:k], both[k:], stats


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
