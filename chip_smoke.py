#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card.  The
script builds the port's seven CUDA kernels from ``src/repro_torch/csrc``
(one ``nvcc`` per source, started together), then:

2. holds each kernel against its plain PyTorch version on the card at its
   path's shapes: the serving shapes (K = 4096 rows, m = 2048 buckets,
   ticks of 2^20 lanes, Q = 8) over the three mappings, levels 0-6 and
   weights none / integer / fractional, with NaN, +-inf, +-0, out-of-range
   ids and padding lanes, in its delta form and in place into a non-empty
   bank; the bank query also at Q = 1 and 300, on float32 and int32 banks,
   rows read through an offset view, a num_buckets = 1001 bank (rows at
   every misalignment), num_buckets = 64 and 4096 banks (rows narrower and
   wider than the kernel's registers hold) and the K = 1 rollup shape; the
   single-row histogram also on a misaligned ``x[1:]`` view (with and
   without its levels offset alike), N = 2^20 - 3, N = 5, every lane in one
   bucket, every lane at level 6, rows of 64 and 1 buckets, and
   back-to-back launches on one stream; the
   range merge at D + 1 = 13 slices of 2K = 8192 rows with deltas 0-6 and
   two dead slices, stacked and read by node index out of a float32 and an
   int32 slab with the live gate on and off; the scatter on the compacted
   triples of 2^20 lanes, and on duplicate keys;
4. times each kernel, its plain version and the one PyTorch call that
   computes the same function where there is one, with CUDA events around
   single calls on a card kept busy by an L2-evicting fill, and states each
   kernel's bound from the bytes it must move; the in-place ingest and the
   node-indexed range merge are timed beside the compositions they
   replaced, the bank query also at the windowed query's Q = 6 and beside
   a ``torch.sum`` of the same bytes, and the single-row histogram's two
   launches (binning into partial rows, their sum) also apart (before the
   paths below, whose serving tick runs under ``torch.profiler``);
3. drives each path of the port once at full width through the entry
   points a user calls, with the kernel launch counters zeroed just before
   and read just after; every kernel of the path must have launched:

   a. serving: a ``KeyedWindow`` of capacity 4095 behind an
      ``IngestGateway`` and a ``QuantileHTTPServer`` on an ephemeral
      localhost port, ``POST /ingest`` batches, ticks of 2^20 lanes, then
      ``GET /live``, ``/rollup``, an ``If-None-Match`` re-poll (304),
      ``/stats`` and ``/quantiles``;
   b. windowed serving: the same window with a ring of 64 one-minute slices
      (an hour), 72 slices of 2^16-lane ticks so the ring wraps, a few keys'
      levels rising mid-ring, a ``GET`` between seals, then
      ``/quantiles?window=5m``, ``/rollup?window=1h``, ``/rollup?slices=64``,
      ``/quantiles?slices=1``, malformed windows (400) and a second gateway
      whose slice clock seals on its own; the final snapshot's windowed
      tables held bit for bit against a sequential merge fold of the
      covered nodes, and one windowed query and rollup profiled, each
      allocating far less than the (D + 1, 2K, m) block the merge once
      gathered;
   c. insert pipelines: ``add_impl(method="matmul" | "sort")`` on a K = 4096
      bank with 2^20 lanes, and a ``DeviceSketch`` taking 2^20 and 4096
      values (the auto rule picks sort, then matmul);

   and checks the answers: the relative-error guarantee per row against
   numpy's exact quantiles, the pinned pipelines equal to the fused one,
   and, under the ``linear`` mapping, HTTP bodies and sketch quantiles
   equal to the same session run on the CPU.

It prints the card's name and power limit, then a ``{"kernels": [...]}``
line (each kernel's ``launches`` summed over the three paths, beside
``launches_by_path``), and last ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the exit code is non-zero; with no CUDA device it exits 2 and prints no
result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from urllib.request import Request, urlopen

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

CAPACITY = 4095  # key rows; one more row is the overflow sink
K = CAPACITY + 1
M = 2048
TICK_LANES = 1 << 20
QS8 = (0.0, 0.01, 0.25, 0.5, 0.75, 0.95, 0.99, 1.0)
ALPHA_QS = (0.01, 0.25, 0.5, 0.75, 0.95, 0.99)
U = 2.0**-24  # float32 unit roundoff
SEED = 0
DEVICE = "cuda"  # the card; the checks below hold its kernels to the plain versions
# windowed serving: a one-hour window of one-minute slices
NUM_SLICES = 64
SLICE_SECONDS = 60.0
SLICES_DRIVEN = 72  # so the ring wraps
SLICE_LANES = 1 << 16
RM_SLICES = 2 * 6 + 1  # 2 log2(64) node cover + the live bank

# Published peaks of the card (NVIDIA data sheets), by name.
PEAK_F32_OPS = 67e12  # float32 outside the tensor cores, H100 SXM


def mem_bandwidth(name: str) -> float:
    """Device-memory rate in bytes/s for the card's name."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM (HBM3)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------- #
# phase 1: each kernel against its plain version on the card
# --------------------------------------------------------------------- #
def ingest_lanes(rng, n: int, k: int):
    """One tick of lanes with every hazard in it: NaN, +-inf, +-0, values
    past both ends of the bucket range, out-of-range ids, mixed levels and
    a tail of inert padding lanes (NaN / id -1 / weight 0)."""
    x = (rng.pareto(1.0, n) + 1.0).astype(np.float32)
    x[rng.random(n) < 0.05] *= -1.0
    x[rng.random(n) < 0.01] = 0.0
    x[rng.random(n) < 0.001] = -0.0
    special = np.array(
        [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1e-38, -1e-38, 3e-10, 1e12],
        np.float32,
    )
    x[: special.size] = special
    # one key's lanes lie together, as record_batches lays them out
    s = np.sort(rng.integers(0, k, n)).astype(np.int32)
    s[rng.random(n) < 0.001] = -3
    s[rng.random(n) < 0.001] = k + 5
    lev = rng.integers(0, 7, n).astype(np.int32)
    pad = n // 64
    x[-pad:] = np.nan
    s[-pad:] = -1
    return x, s, lev, pad


def check_ingest(torch, ops, ref, BucketSpec, rng) -> dict:
    dev = torch.device(DEVICE)
    n, out = TICK_LANES, {"max_abs_err": 0.0, "log_moved_lanes": 0}
    for mapping in ("log", "linear", "cubic"):
        spec = BucketSpec(mapping=mapping)
        x, s, lev, pad = ingest_lanes(rng, n, K)
        wint = rng.integers(0, 4, n).astype(np.float32)
        wfrac = rng.random(n).astype(np.float32)
        wint[-pad:] = 0.0
        wfrac[-pad:] = 0.0
        xt, st_, lt = (torch.from_numpy(a).to(dev) for a in (x, s, lev))
        counts_hist, counts = None, None
        for wkind, w in (("none", None), ("int", wint), ("frac", wfrac)):
            wt = None if w is None else torch.from_numpy(w).to(dev)
            pk, nk, sk = ops.fused_ingest(xt, st_, wt, lt, num_segments=K, spec=spec)
            hp, sp = ref.fused_ingest_ref(xt, st_, wt, lt, num_segments=K, spec=spec)
            hk = torch.cat([pk, nk])
            if wkind == "none":
                counts_hist, counts = hp, sp  # lane counts per bucket / row
            # summ: atomics add in another order; both sums of a row's
            # n lanes lie within (n - 1) u sum|w x| of the exact sum
            valid = torch.isfinite(xt) & (st_ >= 0) & (st_ < K)
            rows = st_.clamp(0, K - 1).long()[valid]
            wv = torch.ones_like(xt) if wt is None else wt
            absum = torch.zeros(K, device=dev).index_add_(0, rows, (wv * xt).abs()[valid])
            nrow = torch.zeros(K, device=dev).index_add_(0, rows, torch.ones_like(xt)[valid])
            check(
                bool(((sk.summ - sp.summ).abs() <= 2 * nrow * U * absum).all()),
                f"ingest {mapping}/{wkind}: summ beyond 2 n u sum|wx|",
            )
            check(bool((sk.vmin == sp.vmin).all()), f"ingest {mapping}/{wkind}: vmin")
            check(bool((sk.vmax == sp.vmax).all()), f"ingest {mapping}/{wkind}: vmax")
            pairs = (
                (hk, hp, counts_hist),
                (sk.zero, sp.zero, counts.zero),
                (sk.overflow, sp.overflow, counts.overflow),
                (sk.underflow, sp.underflow, counts.underflow),
            )
            for got, want, cnt in pairs:
                diff = (got - want).abs()
                if wkind == "frac":
                    # fractional weights round in atomic order: each bucket
                    # lies within 2 c u sum(w) of the plain sum of c lanes
                    check(
                        bool((diff <= 2 * cnt * U * want.abs()).all()),
                        f"ingest {mapping}/frac: a bucket beyond 2 c u sum(w)",
                    )
                elif mapping == "log" and got is hk:
                    # two logf builds may differ by an ulp at a bucket
                    # boundary: allow 1e-5 of the lanes to move one bucket
                    moved = float(diff.sum()) / 2
                    out["log_moved_lanes"] = max(out["log_moved_lanes"], moved)
                    check(moved <= 1e-5 * n * 3, f"ingest log: {moved} lanes moved")
                else:
                    err = float(diff.max())
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                    check(err == 0.0, f"ingest {mapping}/{wkind}: not bit-exact ({err})")
    return out


def check_ingest_into(torch, ops, ref, BucketSpec, rng) -> dict:
    """The in-place ingest into a non-empty bank against the plain delta
    followed by the adds (``add_impl``'s composition before the in-place
    kernel): histograms and counters bit-exact for integer weights, ``summ``
    within 2 (n + 1) u (sum|w x| + |summ0|) per row, extrema numerically
    equal; fractional weights within 2 (c + 1) u of each bucket."""
    dev = torch.device(DEVICE)
    n, out = TICK_LANES, {"max_abs_err": 0.0, "log_moved_lanes": 0.0}
    for mapping in ("log", "linear", "cubic"):
        spec = BucketSpec(mapping=mapping)
        x, s, lev, pad = ingest_lanes(rng, n, K)
        wint = rng.integers(0, 4, n).astype(np.float32)
        wfrac = rng.random(n).astype(np.float32)
        wint[-pad:] = 0.0
        wfrac[-pad:] = 0.0
        xt, st_, lt = (torch.from_numpy(a).to(dev) for a in (x, s, lev))
        # a bank that has been ingesting for a while
        bank0 = [torch.from_numpy(a).to(dev) for a in (
            rng.integers(0, 50, (K, M)).astype(np.float32),
            rng.integers(0, 5, (K, M)).astype(np.float32),
            *(rng.integers(0, 20, K).astype(np.float32) for _ in range(3)),
            rng.normal(0.0, 100.0, K).astype(np.float32),
            np.where(rng.random(K) < 0.5, 1.5, -3.0).astype(np.float32),
            np.where(rng.random(K) < 0.5, 2.5, 1e6).astype(np.float32),
        )]
        cnt = None
        for wkind, w in (("none", None), ("int", wint), ("frac", wfrac)):
            wt = None if w is None else torch.from_numpy(w).to(dev)
            got = [t.clone() for t in bank0]
            ops.fused_ingest_into(got[0], got[1], ops.IngestStats(*got[2:]), xt, st_, wt, lt,
                                  spec=spec)
            hp, sp = ref.fused_ingest_ref(xt, st_, wt, lt, num_segments=K, spec=spec)
            if wkind == "none":
                cnt = [hp[:K], hp[K:], sp.zero, sp.overflow, sp.underflow]  # lanes per cell
            want = [bank0[0] + hp[:K], bank0[1] + hp[K:],
                    *(b + d for b, d in zip(bank0[2:6], sp[:4])),
                    torch.minimum(bank0[6], sp.vmin), torch.maximum(bank0[7], sp.vmax)]
            valid = torch.isfinite(xt) & (st_ >= 0) & (st_ < K)
            rows = st_.clamp(0, K - 1).long()[valid]
            wv = torch.ones_like(xt) if wt is None else wt
            absum = torch.zeros(K, device=dev).index_add_(0, rows, (wv * xt).abs()[valid])
            nrow = torch.zeros(K, device=dev).index_add_(0, rows, torch.ones_like(xt)[valid])
            check(bool(((got[5] - want[5]).abs()
                        <= 2 * (nrow + 1) * U * (absum + bank0[5].abs())).all()),
                  f"ingest_into {mapping}/{wkind}: summ beyond 2 (n + 1) u sum|wx|")
            check(bool((got[6] == want[6]).all()), f"ingest_into {mapping}/{wkind}: vmin")
            check(bool((got[7] == want[7]).all()), f"ingest_into {mapping}/{wkind}: vmax")
            for j in range(5):
                diff = (got[j] - want[j]).abs()
                if wkind == "frac":
                    check(bool((diff <= 2 * (cnt[j] + 1) * U * want[j].abs()).all()),
                          f"ingest_into {mapping}/frac: a cell beyond 2 (c + 1) u")
                elif mapping == "log" and j < 2:
                    # two logf builds may move a boundary lane one bucket
                    moved = float(diff.sum()) / 2
                    out["log_moved_lanes"] = max(out["log_moved_lanes"], moved)
                    check(moved <= 1e-5 * n * 3, f"ingest_into log: {moved} lanes moved")
                else:
                    err = float(diff.max())
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                    check(err == 0.0, f"ingest_into {mapping}/{wkind}: not bit-exact ({err})")
    return out


def check_fold(torch, ops, ref, BucketSpec, rng) -> dict:
    dev = torch.device(DEVICE)
    spec = BucketSpec()
    err = 0.0
    for dt in (torch.float32, torch.int32):
        c = torch.from_numpy(rng.integers(0, 1000, (K, M)).astype(np.float32)).to(dev).to(dt)
        for frac in (1.0, 0.5, 0.001):
            rows = torch.from_numpy(rng.random(K) < frac).to(dev)
            want = torch.where(rows[:, None], ref.fold_pairs_ref(c, spec=spec), c)
            got = ops.fold_pairs(c, spec=spec, rows=rows)
            inplace = c.clone()
            ops.fold_pairs(inplace, spec=spec, rows=rows, out=inplace)
            for g in (got, inplace):
                e = float((g.double() - want.double()).abs().max())
                err = max(err, e)
                check(torch.equal(g, want), f"fold {dt} rows={frac}: not bit-exact")
    return {"max_abs_err": err}


def quantile_bank(torch, rng, dt, m: int = M):
    """A (K, m) bank at mixed levels with integer counts, empty rows and
    rows holding only zeros, plus the extrema the counts came from."""
    dev = torch.device(DEVICE)
    pos = rng.poisson(rng.gamma(0.3, 2.0, (K, 1)), (K, m)).astype(np.float32)
    neg = rng.poisson(0.05, (K, m)).astype(np.float32)
    zero = rng.poisson(1.0, K).astype(np.float32)
    pos[:16] = 0
    neg[:16] = 0
    zero[:8] = 0  # rows 0..7 empty, 8..15 zeros only
    vmin = np.where(neg.any(1), -2e9, np.where(zero > 0, 0.0, 1e-3)).astype(np.float32)
    vmax = np.where(pos.any(1), 2e9, 0.0).astype(np.float32)
    level = rng.integers(0, 7, K).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (pos, neg, zero, vmin, vmax, level)]
    t[0], t[1], t[2] = (a.to(dt) for a in t[:3])
    return t


def offset_view(torch, t):
    """``t``'s values in a buffer one element past a 16-byte boundary: the
    same contiguous shape, every row misaligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:].copy_(t.reshape(-1))
    return flat[1:].view(t.shape)


def rollup_args(torch, args):
    """The K = 1 query ``SketchEngine._rollup`` hands the kernel: the
    bank's column sums, total zero count, extrema and top level."""
    pos, neg, zero, vmin, vmax, level = args
    return (pos.sum(0, keepdim=True), neg.sum(0, keepdim=True), zero.sum().reshape(1),
            vmin.min().reshape(1), vmax.max().reshape(1), level.max().reshape(1))


def check_quantiles(torch, ops, ref, BucketSpec, device_value_table, rng) -> dict:
    """Bit for bit against the plain version on integer counts: float32 and
    int32 banks at Q = 8, 1 and 300 (past one block's threads); rows read
    through an offset view (none 16-byte aligned); a BucketSpec(num_buckets=
    1001) bank, whose rows start at every misalignment; num_buckets = 64 and
    4096 banks, narrower and wider than the rows the kernel holds in
    registers; the K = 1 rollup shape.  Fractional counts: at most 0.1% of
    the answers differ."""
    dev = torch.device(DEVICE)
    spec = BucketSpec()
    widths = (BucketSpec(num_buckets=1001, offset=-500), BucketSpec(num_buckets=64, offset=-32),
              BucketSpec(num_buckets=4096, offset=-2048))
    qsets = (torch.tensor(QS8, device=dev), torch.tensor([0.99], device=dev),
             torch.linspace(0.0, 1.0, 300, device=dev))
    out = {"max_abs_err": 0.0, "exact_cases": 0}

    def exact(args, sp, what):
        table = device_value_table(sp, dev)
        for qs in qsets:
            got = ops.bank_quantiles(*args, qs, spec=sp, table=table)
            want = ref.bank_quantiles_ref(*args, qs, table)
            same = (got == want) | (got.isnan() & want.isnan())
            check(bool(same.all()), f"bank_quantiles {what} Q={qs.numel()}: not bit-exact")
            both = ~want.isnan()
            if bool(both.any()):
                out["max_abs_err"] = max(out["max_abs_err"],
                                         float((got[both] - want[both]).abs().max()))
            out["exact_cases"] += 1

    for dt in (torch.float32, torch.int32):
        args = quantile_bank(torch, rng, dt)
        exact(args, spec, f"{dt}")
        exact([offset_view(torch, a) for a in args[:3]] + args[3:], spec, f"{dt} offset view")
        exact(rollup_args(torch, args), spec, f"{dt} K=1 rollup")
        for sp in widths:
            exact(quantile_bank(torch, rng, dt, m=sp.num_buckets), sp, f"{dt} m={sp.num_buckets}")
    # fractional counts: the block scan reassociates n and the cumulative
    # counts, so a rank at a bucket boundary may pick the neighbour bucket;
    # allow 0.1% of the (row, q) answers to differ
    table = device_value_table(spec, dev)
    pos, neg, zero, vmin, vmax, level = quantile_bank(torch, rng, torch.float32)
    scale = torch.rand(pos.shape, device=dev)
    args = (pos * scale, neg * scale, zero * 0.37, vmin, vmax, level)
    got = ops.bank_quantiles(*args, qsets[0], spec=spec, table=table)
    want = ref.bank_quantiles_ref(*args, qsets[0], table)
    differ = int((~((got == want) | (got.isnan() & want.isnan()))).sum())
    check(differ <= 1e-3 * got.numel(), f"bank_quantiles fractional: {differ} answers differ")
    out["fractional_differing"] = differ
    return out


def range_merge_inputs(torch):
    """The window query's merge block at full width: (13, 2K, m) integer
    counts, per-(slice, row) deltas of which ~60% are 0 and the rest 1-6,
    and a slice mask with two dead slices (their counts stay, as a
    padding node's do)."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = (RM_SLICES, 2 * K, M)
    counts = torch.randint(0, 1000, shape, generator=g, device=dev).to(torch.float32)
    deltas = torch.randint(1, 7, shape[:2], generator=g, device=dev, dtype=torch.int32)
    steady = torch.rand(shape[:2], generator=g, device=dev) < 0.6
    deltas = torch.where(steady, 0, deltas).to(torch.int32)
    valid = torch.ones(RM_SLICES, device=dev)
    valid[[3, 9]] = 0.0
    return counts, deltas, valid


def check_range_merge(torch, ops, ref, BucketSpec) -> dict:
    spec = BucketSpec()
    counts, deltas, valid = range_merge_inputs(torch)
    for d in (deltas, torch.zeros_like(deltas)):  # mixed, then the steady case
        got = ops.bank_range_merge(counts, d, spec=spec, valid=valid)
        want = ref.bank_range_merge_ref(counts, d, spec=spec, valid=valid)
        check(torch.equal(got, want), "bank_range_merge: not bit-exact on integer counts")
    # fractional counts sum in another order: each bucket of at most
    # n = live slices * 2^6 terms lies within 2 n u of the plain sum
    frac = counts * torch.rand(counts.shape, device=counts.device)
    got = ops.bank_range_merge(frac, deltas, spec=spec, valid=valid)
    want = ref.bank_range_merge_ref(frac, deltas, spec=spec, valid=valid)
    n = int(valid.sum()) * 2**6
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    check(rel <= 2 * n * U, f"bank_range_merge fractional: relative error {rel} > 2 n u")
    return {"max_abs_err": 0.0, "fractional_max_rel_err": rel}


def range_merge_slab(torch, dtype):
    """A window query's inputs at full width, as the ring hands them over:
    a slab of RM_SLICES nodes per store, a live bank, a cover of
    RM_SLICES - 1 entries whose last two are padding (node 0, valid 0),
    and (RM_SLICES, K) deltas of which ~60% are 0 and the rest 1-6."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    slab = [torch.randint(0, 1000, (RM_SLICES, K, M), generator=g, device=dev).to(dtype)
            for _ in range(2)]
    bank = [torch.randint(0, 1000, (K, M), generator=g, device=dev).to(dtype) for _ in range(2)]
    nodes = torch.tensor([5, 1, 7, 12, 3, 0, 9, 11, 2, 4, 0, 0], device=dev)
    valid = torch.ones(RM_SLICES - 1, device=dev)
    valid[-2:] = 0.0
    deltas = torch.randint(1, 7, (RM_SLICES, K), generator=g, device=dev, dtype=torch.int32)
    steady = torch.rand((RM_SLICES, K), generator=g, device=dev) < 0.6
    deltas = torch.where(steady, 0, deltas).to(torch.int32)
    return slab, bank, nodes, valid, deltas


def stacked_merge_block(torch, slab, bank, nodes):
    """The (D + 1, 2K, m) float32 block that the gather before this design
    built: the covered nodes of each store, then the live bank."""
    return torch.cat([torch.cat([s.index_select(0, nodes).float(), b.float()[None]])
                      for s, b in zip(slab, bank)], dim=1)


def check_range_merge_nodes(torch, ops, ref, BucketSpec) -> dict:
    """The node-indexed merge over a float32 and an int32 slab, with dead
    padding nodes and the live gate on and off, bit for bit against the
    stack-then-plain composition; fractional counts within 2 n u."""
    spec = BucketSpec()
    dev = torch.device(DEVICE)
    out = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.int32):
        slab, bank, nodes, valid, deltas = range_merge_slab(torch, dtype)
        block = stacked_merge_block(torch, slab, bank, nodes)
        for live in (1.0, 0.0):
            gate = torch.tensor(live, device=dev)
            mask = torch.cat([valid, gate[None]])
            pos, neg = ops.bank_range_merge_nodes(*slab, nodes, valid, *bank, gate, deltas,
                                                  spec=spec)
            want = ref.bank_range_merge_ref(block, torch.cat([deltas, deltas], 1), spec=spec,
                                            valid=mask)
            check(torch.equal(torch.cat([pos, neg]), want),
                  f"bank_range_merge_nodes {dtype} live={live}: not bit-exact")
        if dtype == torch.float32:
            frac = [t * torch.rand(t.shape, device=dev) for t in (*slab, *bank)]
            gate = torch.tensor(1.0, device=dev)
            pos, neg = ops.bank_range_merge_nodes(*frac[:2], nodes, valid, *frac[2:], gate,
                                                  deltas, spec=spec)
            want = ref.bank_range_merge_ref(
                stacked_merge_block(torch, frac[:2], frac[2:], nodes),
                torch.cat([deltas, deltas], 1), spec=spec, valid=torch.cat([valid, gate[None]]))
            got = torch.cat([pos, neg])
            n = (int(valid.sum()) + 1) * 2**6
            rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
            check(rel <= 2 * n * U, f"bank_range_merge_nodes fractional: {rel} > 2 n u")
            out["fractional_max_rel_err"] = rel
            del frac
        del slab, bank, block
        torch.cuda.empty_cache()
    return out


def check_histograms(torch, ops, ref, BucketSpec, rng) -> dict:
    """The segment and single-row histograms on the ingest check's lanes."""
    dev = torch.device(DEVICE)
    n = TICK_LANES
    out = {name: {"max_abs_err": 0.0, "log_moved_lanes": 0.0}
           for name in ("ddsketch_seg_hist", "ddsketch_hist")}
    for mapping in ("log", "linear", "cubic"):
        spec = BucketSpec(mapping=mapping)
        x, s, lev, pad = ingest_lanes(rng, n, K)
        wint = rng.integers(0, 4, n).astype(np.float32)
        wfrac = rng.random(n).astype(np.float32)
        xt, st_, lt = (torch.from_numpy(a).to(dev) for a in (x, s, lev))
        lane_counts = {}
        for wkind, w in (("none", None), ("int", wint), ("frac", wfrac)):
            wt = None if w is None else torch.from_numpy(w).to(dev)
            pairs = {
                "ddsketch_seg_hist": (
                    ops.segment_histogram(xt, st_, wt, lt, num_segments=K, spec=spec),
                    ref.segment_histogram_ref(xt, st_, wt, lt, num_segments=K, spec=spec),
                ),
                "ddsketch_hist": (
                    ops.ddsketch_histogram(xt, wt, lt, spec=spec),
                    ref.histogram_ref(xt, wt, lt, spec=spec),
                ),
            }
            for name, (got, want) in pairs.items():
                if wkind == "none":
                    lane_counts[name] = want
                diff = (got - want).abs()
                if wkind == "frac":
                    # atomic order: each bucket within 2 c u sum(w) of c lanes
                    check(bool((diff <= 2 * lane_counts[name] * U * want.abs()).all()),
                          f"{name} {mapping}/frac: a bucket beyond 2 c u sum(w)")
                elif mapping == "log":
                    # two logf builds may move a boundary lane one bucket
                    moved = float(diff.sum()) / 2
                    out[name]["log_moved_lanes"] = max(out[name]["log_moved_lanes"], moved)
                    check(moved <= 1e-5 * n * 3, f"{name} log: {moved} lanes moved")
                else:
                    err = float(diff.max())
                    out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
                    check(err == 0.0, f"{name} {mapping}/{wkind}: not bit-exact ({err})")
    out["ddsketch_hist"]["edge_cases"] = check_hist_edges(torch, ops, ref, BucketSpec, rng)
    return out


def hist_edge_cases(torch, rng):
    """The single-row histogram's edge inputs, as (what, values, weights,
    levels): a misaligned ``x[1:]`` view with its levels and weights (the
    kernel's head path), one whose levels start elsewhere (every lane
    scalar), N = 2^20 - 3, N = 5, every lane in one bucket, every lane at
    collapse level 6."""
    dev = torch.device(DEVICE)
    n = TICK_LANES
    x, _, lev, _ = ingest_lanes(rng, n, K)
    xt, lt = torch.from_numpy(x).to(dev), torch.from_numpy(lev).to(dev)
    wt = torch.from_numpy(rng.integers(0, 4, n).astype(np.float32)).to(dev)
    pareto = torch.from_numpy((rng.pareto(1.0, n) + 1.0).astype(np.float32)).to(dev)
    return (
        ("x[1:]", xt[1:], wt[1:], lt[1:]),
        ("x[1:], levels[:-1]", xt[1:], None, lt[:-1]),
        ("N = 2^20 - 3", xt[: n - 3], wt[: n - 3], lt[: n - 3]),
        ("N = 5", xt[100:105], wt[100:105], lt[100:105]),
        ("one bucket", torch.full((n,), 1.5, device=dev), wt, None),
        ("level 6", pareto, None, torch.full((n,), 6, dtype=torch.int32, device=dev)),
    )


def check_hist_edges(torch, ops, ref, BucketSpec, rng) -> dict:
    """Each edge case under ``linear`` (bit-exact) and ``log`` (at most
    1e-5 of the lanes move one bucket), at m = 2048 and on rows of 64 and 1
    buckets, then launches back to back on one stream with no synchronise
    between them: each must count its own lanes only."""
    out = {"cases": 0, "log_moved_lanes": 0.0}
    cases = hist_edge_cases(torch, rng)
    for mapping, widths in (("linear", ((2048, -1024), (64, -32), (1, 0))),
                            ("log", ((2048, -1024), (64, -32)))):
        for m, offset in widths:
            spec = BucketSpec(mapping=mapping, num_buckets=m, offset=offset)
            for what, x, w, lev in cases:
                got = ops.ddsketch_histogram(x, w, lev, spec=spec)
                want = ref.histogram_ref(x, w, lev, spec=spec)
                diff = (got - want).abs()
                if mapping == "linear":
                    check(torch.equal(got, want), f"ddsketch_hist m={m} {what}: not bit-exact")
                else:
                    moved = float(diff.sum()) / 2
                    out["log_moved_lanes"] = max(out["log_moved_lanes"], moved)
                    check(moved <= 1e-5 * x.numel() * 3,
                          f"ddsketch_hist log m={m} {what}: {moved} moved")
                out["cases"] += 1
    spec = BucketSpec(mapping="linear")
    pairs = [(ops.ddsketch_histogram(x, w, lev, spec=spec), (x, w, lev))
             for _, x, w, lev in (cases[0], cases[2], cases[0])]
    for got, (x, w, lev) in pairs:
        check(torch.equal(got, ref.histogram_ref(x, w, lev, spec=spec)),
              "ddsketch_hist back to back: a launch after another differs")
    out["back_to_back_launches"] = len(pairs)
    return out


def check_scatter(torch, ops, ref, BucketSpec, rng) -> dict:
    """The scatter on the compaction of 2^20 lanes into 2K rows, then on
    keys with duplicates (which must still accumulate)."""
    dev = torch.device(DEVICE)
    spec = BucketSpec()
    x, s, lev, _ = ingest_lanes(rng, TICK_LANES, K)
    w = rng.integers(0, 4, TICK_LANES).astype(np.float32)
    xt, st_, lt, wt = (torch.from_numpy(a).to(dev) for a in (x, s, lev, w))
    keys, wts = ref.compact_triples(xt, st_, wt, lt, num_segments=K, spec=spec)
    cap = min(TICK_LANES, 2 * K * M + 1)
    dup = torch.from_numpy(rng.integers(-3, 2 * K * M + 3, TICK_LANES).astype(np.int32)).to(dev)
    dup[: TICK_LANES // 4] = 12345  # a quarter of the lanes on one key
    for kk, ww in ((keys[:cap], wts[:cap]), (dup, wt)):
        got = ops.ddsketch_scatter(kk, ww, num_rows=2 * K, num_buckets=M)
        want = ref.scatter_histogram_ref(kk, ww, num_rows=2 * K, num_buckets=M)
        check(torch.equal(got, want), "ddsketch_scatter: not bit-exact")
    return {"max_abs_err": 0.0, "unique_triples": int((keys < 2 * K * M).sum())}


# --------------------------------------------------------------------- #
# phase 2: the main path, through the entry points a user calls
# --------------------------------------------------------------------- #
def zipf_probs(n: int, s: float = 1.1) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return p / p.sum()


def latencies(rng, n: int) -> np.ndarray:
    """Pareto(1)+1 latencies with ~5% negative deltas and ~1% zeros."""
    v = (rng.pareto(1.0, n) + 1.0).astype(np.float32)
    v[rng.random(n) < 0.05] *= -1.0
    v[rng.random(n) < 0.01] = 0.0
    return v


def device_share(torch, prof, wall_s: float) -> dict:
    """The device's busy time in one profiled tick (kernels, copies and
    fills on the card, summed) against the tick's wall time, with the
    heaviest device activities by name."""
    from torch.autograd import DeviceType

    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_s": wall_s,
        "device_busy_s": busy_s,
        "busy_share": busy_s / wall_s,
        "top_us": {name[:70]: us for name, us in top},
        "index_select_us": sum(us for name, us in by_name.items() if "ndexSelect" in name),
    }


def http(url: str, body=None, etag=None):
    req = Request(url, data=None if body is None else json.dumps(body).encode())
    if etag is not None:
        req.add_header("If-None-Match", etag)
    with urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers.get("ETag"), resp.read()


def serve_session(device: str, mapping: str, ticks: int, posts: int):
    """One scripted serving session; returns its HTTP bodies, the window
    and every ingested (row, value, weight) for the exactness checks.

    The gateway drains on this thread after every POST, so the ingest
    ticks (and so the reactive collapses) fall at the same points on
    every device and the session is reproducible.  The direct ingest
    ticks and the first ``/live`` and ``/rollup`` reads are timed on the
    host clock, each ending in a device synchronise; on the card the last
    tick runs under ``torch.profiler`` instead.
    """
    import torch

    from repro_torch.kernels.ref import BucketSpec
    from repro_torch.launch.http_api import QuantileHTTPServer, TelemetryFacade
    from repro_torch.launch.ingest_gateway import IngestGateway
    from repro_torch.telemetry.keyed import KeyedAggregator, KeyedWindow

    rng = np.random.default_rng(SEED)
    spec = BucketSpec(mapping=mapping)
    window = KeyedWindow(spec, CAPACITY, device=device)
    agg = KeyedAggregator(spec)
    gateway = IngestGateway(window, max_queue_values=1 << 20, start=False)
    keys = [f"/svc/{i:04d}/latency" for i in range(CAPACITY)]
    probs = zipf_probs(CAPACITY)
    outlier = keys[7]
    log_rows, log_vals, log_wts = [], [], []
    bodies, clock = {}, {"tick_s": []}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    with QuantileHTTPServer(TelemetryFacade(window, agg), gateway=gateway) as server:
        for i in range(posts):
            key = keys[int(rng.choice(CAPACITY, p=probs))]
            vals = latencies(rng, 2000)
            if i == posts // 2:
                key, vals[:4] = outlier, [1.5e12, 3e12, -2e12, 7e12]
            body = {"key": key, "values": vals.tolist()}
            if i == 1:
                body["weights"] = rng.integers(1, 4, vals.size).astype(np.float32).tolist()
            code, _, raw = http(server.url + "/ingest", body)
            check(code == 200 and json.loads(raw)["status"] == "accepted", "POST /ingest")
            gateway.flush()
            log_rows.append(np.full(vals.size, window.key_to_row[key], np.int32))
            log_vals.append(vals)
            log_wts.append(np.asarray(body.get("weights", np.ones(vals.size)), np.float32))
        for i in range(ticks):
            per_key = rng.multinomial(TICK_LANES, probs)
            batches = [(keys[j], latencies(rng, c), None) for j, c in enumerate(per_key) if c]
            if i == 1:
                batches.append((outlier, np.array([2e12, 9e12], np.float32), None))
            # the last tick on the card runs under the profiler, for the
            # device's busy share of a tick; the others time it bare
            profiled = device == "cuda" and i == ticks - 1
            with torch.profiler.profile() if profiled else contextlib.nullcontext() as prof:
                sync()
                start = time.perf_counter()
                window.record_batches(batches)
                sync()
                wall = time.perf_counter() - start
            if profiled:
                clock["profiled_tick"] = device_share(torch, prof, wall)
            else:
                clock["tick_s"].append(wall)
            for key, vals, _ in batches:
                log_rows.append(np.full(vals.size, window.key_to_row[key], np.int32))
                log_vals.append(vals)
                log_wts.append(np.ones(vals.size, np.float32))
        start = time.perf_counter()
        code, etag, raw = http(server.url + "/live")
        clock["live_s"] = time.perf_counter() - start
        check(code == 200 and etag is not None, "GET /live")
        bodies["live"] = raw
        start = time.perf_counter()
        code, _, raw = http(server.url + "/rollup?q=0.5,0.95,0.99")
        clock["rollup_s"] = time.perf_counter() - start
        check(code == 200, "GET /rollup")
        bodies["rollup"] = raw
        try:
            http(server.url + "/live", etag=etag)
            raise AssertionError("If-None-Match re-poll of /live did not answer 304")
        except Exception as e:  # urllib raises HTTPError for a 304
            check(getattr(e, "code", None) == 304, f"If-None-Match re-poll: {e}")
        code, _, raw = http(server.url + "/stats")
        stats = json.loads(raw)
        check(code == 200 and stats["gateway"]["drain_errors"] == 0, "GET /stats")
        check(stats["server"].get("http_304") == 1, "/stats counts the 304")
        bodies["stats"] = stats
        snap_bank = window.snapshot().bank
        events = list(window.events)
        agg.flush(window)
        code, _, raw = http(server.url + f"/quantiles?endpoint={keys[0]}&q=0.5,0.99")
        check(code == 200 and len(json.loads(raw)["quantiles"]) == 2, "GET /quantiles")
        bodies["quantiles"] = raw
    seconds = time.perf_counter() - t0
    rows = np.concatenate(log_rows)
    return {
        "bodies": bodies,
        "window": window,
        "bank": snap_bank,
        "events": events,
        "rows": rows,
        "values": np.concatenate(log_vals),
        "weights": np.concatenate(log_wts),
        "seconds": seconds,
        "clock": clock,
        "lanes": int(rows.size),
    }


def alpha_rows(est, lev, rows, vals, skip, effective_alpha, spec) -> tuple[int, float]:
    """|est - exact| <= alpha(level) |exact| for every row of ``est`` but
    those in ``skip``, against the exact value at the sketch's own float32
    rank of the finite ``vals`` logged for that row; (rows checked, worst
    relative error)."""
    keep = np.isfinite(vals)
    rows, vals = rows[keep], vals[keep]
    order = np.lexsort((vals, rows))
    rows, vals = rows[order], vals[order]
    starts = np.searchsorted(rows, np.arange(K))
    ends = np.searchsorted(rows, np.arange(K), side="right")
    checked, worst = 0, 0.0
    for r in range(K):
        n = ends[r] - starts[r]
        if n == 0 or r in skip:
            continue
        a = effective_alpha(spec, int(lev[r]))
        for j, q in enumerate(ALPHA_QS):
            rank = np.float32(q) * np.float32(n - 1)
            exact = float(vals[starts[r] + int(np.floor(rank))])
            err = abs(float(est[r, j]) - exact)
            bound = a * 1.01 * abs(exact)
            check(err <= bound, f"row {r} q={q}: |{est[r, j]} - {exact}| > {bound}")
            worst = max(worst, err / abs(exact) if exact else 0.0)
        checked += 1
    return checked, worst


def check_alpha(torch, session, effective_alpha, BucketSpec) -> dict:
    """The guarantee per row of the serving session's bank, for rows that
    clamped nothing."""
    spec = BucketSpec()
    window, bank = session["window"], session["bank"]
    est = window.engine.host_rows(window.engine.quantiles(bank, ALPHA_QS))
    lev = window.engine.host_rows(bank.level)
    clamped = {int(window.key_to_row.get(e.key, 0)) for e in session["events"]}
    ovf = window.engine.host_rows(bank.overflow + bank.underflow)
    skip = clamped | {int(r) for r in np.flatnonzero(ovf > 0)}
    reps = session["weights"].astype(np.int64)
    rows = np.repeat(session["rows"], reps)
    vals = np.repeat(session["values"], reps)
    checked, worst = alpha_rows(est, lev, rows, vals, skip, effective_alpha, spec)
    check(checked > 0.9 * len(window.key_to_row), f"alpha check covered {checked} rows")
    return {"rows_checked": int(checked), "worst_rel_err": worst, "clamped_rows": len(clamped)}


WINDOW_READS = (
    "/quantiles?endpoint={key}&window=5m&q=0.5,0.9,0.99",
    "/rollup?window=1h&q=0.01,0.5,0.99,1",
    "/rollup?slices=64",
    "/quantiles?endpoint={key}&slices=1",
)
WINDOW_BAD = (
    "/quantiles?endpoint={key}&window=zzz",
    "/quantiles?endpoint={key}&window=2h",
    "/quantiles?endpoint={key}&slices=0",
    "/quantiles?endpoint={key}&slices=65",
    "/quantiles?endpoint={key}&window=5m&slices=5",
    "/rollup?window=-1m",
)


def window_session(device: str, mapping: str, *, slices: int, lanes: int, outliers,
                   poll: bool):
    """One scripted windowed-serving session over a ring of NUM_SLICES
    one-minute slices; returns its HTTP bodies, host-clock readings, the
    windowed estimates for the guarantee check and every ingested
    (slice, row, value).

    Each slice is one ``record_batches`` tick of ``lanes`` Zipf-keyed
    Pareto latencies, then (``poll``) a windowed ``GET`` that builds the
    snapshot, then ``advance_slice``; the last slice stays live.  With
    ``poll`` the session also reads the windowed estimates of the last 5,
    60 and 64 slices off its final snapshot.  In the
    ``outliers`` slices three keys also get values above 1e12, so their
    levels rise mid-ring and the long windows mix levels.
    """
    import torch

    from repro_torch.kernels.ref import BucketSpec
    from repro_torch.launch.http_api import QuantileHTTPServer, TelemetryFacade
    from repro_torch.launch.ingest_gateway import IngestGateway
    from repro_torch.telemetry.keyed import KeyedAggregator, KeyedWindow

    rng = np.random.default_rng(SEED + 1)
    spec = BucketSpec(mapping=mapping)
    window = KeyedWindow(spec, CAPACITY, num_slices=NUM_SLICES, slice_seconds=SLICE_SECONDS,
                         device=device)
    gateway = IngestGateway(window, start=False)
    keys = [f"/svc/{i:04d}/latency" for i in range(CAPACITY)]
    probs = zipf_probs(CAPACITY)
    hot = [keys[7], keys[CAPACITY // 13], keys[CAPACITY // 2]]
    log_slice, log_rows, log_vals = [], [], []
    bodies, clock = {}, {"advance_slice_s": []}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    with QuantileHTTPServer(TelemetryFacade(window, KeyedAggregator(spec)),
                            gateway=gateway) as server:
        for i in range(slices):
            per_key = rng.multinomial(lanes, probs)
            batches = [(keys[j], latencies(rng, c), None) for j, c in enumerate(per_key) if c]
            if i in outliers:
                batches += [(key, np.array([1.5e12, 4e12], np.float32), None) for key in hot]
            window.record_batches(batches)
            for key, vals, _ in batches:
                log_slice.append(np.full(vals.size, i, np.int32))
                log_rows.append(np.full(vals.size, window.key_to_row[key], np.int32))
                log_vals.append(vals)
            if poll:
                code, _, _ = http(server.url + f"/quantiles?endpoint={keys[0]}&window=5m")
                check(code == 200, "GET /quantiles?window=5m between seals")
            if i < slices - 1:
                sync()
                start = time.perf_counter()
                window.advance_slice()
                sync()
                clock["advance_slice_s"].append(time.perf_counter() - start)
        for j, path in enumerate(WINDOW_READS):
            start = time.perf_counter()
            code, _, raw = http(server.url + path.format(key=keys[0]))
            if j == 1:
                clock["first_rollup_1h_s"] = time.perf_counter() - start
            check(code == 200, f"GET {path}")
            bodies[path] = raw
        for path in WINDOW_BAD:
            try:
                http(server.url + path.format(key=keys[0]))
                raise AssertionError(f"GET {path} did not answer 400")
            except Exception as e:  # urllib raises HTTPError for a 400
                check(getattr(e, "code", None) == 400, f"GET {path}: {e}")
                check("error" in json.loads(e.read()), f"GET {path}: no JSON error body")
        code, _, raw = http(server.url + "/stats")
        stats = json.loads(raw)
        check(stats["engine"]["ring"]["sealed"] == slices - 1, "/stats ring block")
        bodies["stats_ring"] = stats["engine"]["ring"]
        est = {}
        if poll:
            snap = window.snapshot()
            est = {w: snap.windowed_row_quantiles(ALPHA_QS, slices=w) for w in (5, 60, 64)}
            est["rollup_60"] = np.asarray(snap.windowed_rollup(ALPHA_QS, slices=60))
    seconds = time.perf_counter() - t0
    return {
        "bodies": bodies,
        "window": window,
        "est": est,
        "levels": window.engine.host_rows(window.bank.level),
        "events": list(window.events),
        "slice": np.concatenate(log_slice),
        "rows": np.concatenate(log_rows),
        "values": np.concatenate(log_vals),
        "seconds": seconds,
        "clock": clock,
        "slices": slices,
    }


def check_window_alpha(session, effective_alpha, BucketSpec) -> dict:
    """The guarantee of the windowed estimates over the last 5, 60 and 64
    slices, per row for rows that clamped nothing, and for the 60-slice
    rollup of every row (at the bank's top level)."""
    spec = BucketSpec()
    window, last = session["window"], session["slices"] - 1
    clamped = {int(window.key_to_row[e.key]) for e in session["events"]}
    out = {"clamped_rows": len(clamped)}
    for w in (5, 60, 64):
        inside = session["slice"] > last - w
        checked, worst = alpha_rows(session["est"][w], session["levels"], session["rows"][inside],
                                    session["values"][inside], clamped, effective_alpha, spec)
        check(checked > 0.9 * (len(window.key_to_row) - len(clamped)),
              f"window {w}: alpha check covered {checked} rows")
        out[f"slices_{w}"] = {"rows_checked": checked, "worst_rel_err": worst}
    inside = session["slice"] > last - 60
    vals = np.sort(session["values"][inside][np.isfinite(session["values"][inside])])
    a = effective_alpha(spec, int(session["levels"].max()))
    for j, q in enumerate(ALPHA_QS):
        exact = float(vals[int(np.floor(np.float32(q) * np.float32(vals.size - 1)))])
        est = float(session["est"]["rollup_60"][j])
        check(abs(est - exact) <= a * 1.01 * abs(exact), f"rollup q={q}: {est} vs {exact}")
    out["rollup_60_lanes"] = int(vals.size)
    return out


def check_window_fold(torch, sbank, window) -> dict:
    """The windowed tables of the wrapped ring's final snapshot, bit for bit
    (integer counts), against folding the covered slab nodes and then the
    live bank one by one with ``sketch_bank.merge`` on the card."""
    snap = window.snapshot()
    check(snap.sealed > NUM_SLICES, "the ring never wrapped")
    out = {"sealed": snap.sealed}
    for w in (5, 60, 64):
        nodes, valid = window.ring.query_args_at(snap.sealed, w)
        cover = [int(n) for n, v in zip(nodes, valid) if v > 0]
        acc = sbank.SketchBank(*(leaf[cover[0]].clone() for leaf in snap.slab))
        for node in [*cover[1:], None]:
            b = snap.bank if node is None else sbank.SketchBank(*(leaf[node] for leaf in snap.slab))
            sbank.merge(acc, b, spec=window.spec)
        want = window.engine.host_rows(window.engine.quantiles(acc, ALPHA_QS))
        got = snap.windowed_row_quantiles(ALPHA_QS, slices=w)
        check(np.array_equal(got, want, equal_nan=True),
              f"window {w}: windowed table differs from the sequential merge fold")
        out[f"slices_{w}_nodes"] = len(cover)
    return out


def profile_window_query(torch, window) -> dict:
    """One windowed per-row query and one windowed rollup off the final
    snapshot, each under ``torch.profiler``: the device's busy share and
    the heaviest device activities."""
    snap = window.snapshot()
    # the (D + 1, 2K, m) float32 block the merge no longer gathers
    block = (window.ring.max_range_nodes + 1) * 2 * K * M * 4
    out = {}
    for name, fn in (("query_64", lambda: snap.windowed_row_quantiles(ALPHA_QS, slices=64)),
                     ("rollup_60", lambda: snap.windowed_rollup(ALPHA_QS, slices=60))):
        fn()  # warm: the value table and allocator
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile() as prof:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        out[name] = device_share(torch, prof, wall)
        peak = torch.cuda.max_memory_allocated() - before
        out[name]["peak_alloc_bytes"] = peak
        check(peak < block / 2, f"window {name}: {peak} bytes allocated, the block is {block}")
        # a trace that lost the merge kernel's record understates the busy share
        out[name]["range_merge_traced"] = any("range_merge" in n for n in out[name]["top_us"])
    return out


def slice_clock(window) -> dict:
    """A second gateway on the window, with a 0.2 s slice clock: its drain
    thread seals slices on its own."""
    from repro_torch.launch.ingest_gateway import IngestGateway

    before = window.ring.sealed
    gateway = IngestGateway(window, slice_interval_s=0.2)
    gateway.submit("/svc/0000/latency", latencies(np.random.default_rng(SEED), 1000).tolist())
    time.sleep(1.0)
    gateway.stop()
    stats = gateway.stats()
    check(stats["drain_errors"] == 0, f"slice-clock gateway: {stats['drain_errors']} errors")
    check(window.ring.sealed > before, "the slice clock sealed nothing")
    return {"sealed_before": before, "sealed_after": window.ring.sealed,
            "slice_advances": stats["slice_advances"]}


def insert_inputs(torch, device: str):
    """2^20 lanes over K = 4096 rows (the ingest check's hazards), integer
    weights, per-row start levels 0-6, and Pareto values for the single
    sketch: all from the seed, on ``device``."""
    rng = np.random.default_rng(SEED + 2)
    x, s, _, _ = ingest_lanes(rng, TICK_LANES, K)
    w = rng.integers(0, 4, TICK_LANES).astype(np.float32)
    levels = rng.integers(0, 7, K).astype(np.int32)
    sketch_vals = (rng.pareto(1.0, TICK_LANES) + 1.0).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, s, w, levels, sketch_vals)]


def insert_banks(sbank, spec, inputs, methods):
    """One K = 4096 bank per method: start levels, then an unweighted and
    a weighted ``add_impl`` of the 2^20 lanes."""
    x, s, w, levels, _ = inputs
    out = {}
    for method in methods:
        bank = sbank.empty(spec, K, device=x.device)
        sbank.collapse_to(bank, levels, spec=spec)
        for weights in (None, w):
            sbank.add_impl(bank, x, s, weights, spec=spec, method=method)
        out[method] = bank
    return out


def insert_sketches(tsk, spec, inputs):
    """Two ``DeviceSketch``es through the auto rule: 2^20 values (sort) and
    the first 4096 (matmul); their quantiles at QS8."""
    vals = inputs[4]
    out = {}
    for n in (TICK_LANES, 4096):
        sk = tsk.add(tsk.empty(spec, device=vals.device), vals[:n], spec=spec)
        out[n] = (sk, tsk.quantiles(sk, QS8, spec=spec))
    return out


def check_insert(torch, banks, fused, inputs) -> dict:
    """Each pinned pipeline's bank equals the fused one leaf for leaf:
    bit-exact but ``summ``, held to 2 n u sum|w x| per row (its lanes sum
    in another order), and the extrema compared numerically."""
    x, s, w, _, _ = inputs
    valid = torch.isfinite(x) & (s >= 0) & (s < K)
    rows = s.clamp(0, K - 1).long()[valid]
    absum = torch.zeros(K, device=x.device).index_add_(0, rows, ((1 + w) * x).abs()[valid])
    nrow = torch.zeros(K, device=x.device).index_add_(0, rows, torch.ones_like(x)[valid])
    worst = 0.0
    for method, bank in banks.items():
        for name, got, want in zip(bank._fields, bank, fused):
            if name == "summ":
                diff = (got - want).abs()
                check(bool((diff <= 2 * (nrow + 1) * U * absum).all()),
                      f"{method}: summ beyond 2 n u sum|wx|")
                worst = max(worst, float(diff.max()))
            else:
                check(bool((got == want).all()), f"{method}: {name} differs from the fused bank")
    return {"max_abs_err": 0.0, "summ_max_abs_diff": worst}


def check_sketch_alpha(sketches, inputs, effective_alpha, spec) -> dict:
    vals = inputs[4].cpu().numpy()
    out = {}
    for n, (sk, q) in sketches.items():
        s = np.sort(vals[:n])
        a = effective_alpha(spec, int(sk.level))
        worst = 0.0
        for j, qq in enumerate(QS8[1:-1], start=1):
            exact = float(s[int(np.floor(np.float32(qq) * np.float32(n - 1)))])
            err = abs(float(q[j]) - exact)
            check(err <= a * 1.01 * abs(exact), f"DeviceSketch n={n} q={qq}: {float(q[j])}")
            worst = max(worst, err / abs(exact))
        check(float(q[0]) == float(s[0]) and float(q[-1]) == float(s[-1]), "sketch extrema")
        out[n] = worst
    return out


# --------------------------------------------------------------------- #
# phase 3: times on the card
# --------------------------------------------------------------------- #
_FLUSH = []  # a buffer larger than the L2 cache, made on first use


def time_ms(torch, fn, reps: int = 30, warmup: int = 5, flush: bool = True) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after warm-up.

    Before each timed call a 512 MiB fill evicts the 50 MB L2 cache (a
    tick or query finds its inputs cold) and keeps the card busy while the
    host enqueues the call, so the events time the card's work and not
    the host's launch overhead, which back-to-back launches of a short
    kernel would add (``flush=False`` times them back to back, as this
    script did before)."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(512 << 20, dtype=torch.uint8, device=DEVICE))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush:
            _FLUSH[0].fill_(1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound_ms(nbytes: float, nops: float, bw: float):
    tb, to = nbytes / bw * 1e3, nops / PEAK_F32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ingest_times(torch, ref, wrappers, spec, bw, xt, st_, lt) -> dict:
    """The in-place ingest (``add_impl``'s fused path) into a float32 bank,
    beside the composition it replaced (the delta form, then the bank's
    eight adds), the delta form alone and the plain version (the plain
    delta, then the adds)."""
    dev = xt.device
    into, delta = wrappers["ddsketch_ingest"], wrappers["ddsketch_ingest_delta"]
    bank = [torch.zeros((K, M), device=dev) for _ in range(2)]
    bank += [torch.zeros(K, device=dev) for _ in range(4)]
    bank += [torch.full((K,), math.inf, device=dev), torch.full((K,), -math.inf, device=dev)]
    from repro_torch.kernels.ref import IngestStats

    stats = IngestStats(*bank[2:])

    def add_delta(hist, st):
        bank[0].add_(hist[:K])
        bank[1].add_(hist[K:])
        for leaf, d in zip(bank[2:6], st[:4]):
            leaf.add_(d)
        torch.minimum(bank[6], st.vmin, out=bank[6])
        torch.maximum(bank[7], st.vmax, out=bank[7])

    def call():
        into(xt, st_, None, lt, pos=bank[0], neg=bank[1], stats=stats, spec=spec)

    t_k = time_ms(torch, call)
    t_b = time_ms(torch, call, flush=False)
    t_d = time_ms(torch, lambda: delta(xt, st_, None, lt, num_segments=K, spec=spec))
    t_o = time_ms(torch, lambda: add_delta(*delta(xt, st_, None, lt, num_segments=K, spec=spec)))
    t_p = time_ms(torch, lambda: add_delta(*ref.fused_ingest_ref(xt, st_, None, lt,
                                                                 num_segments=K, spec=spec)))
    # bound: the lanes (x, ids, levels) read once, each distinct 32-byte
    # histogram sector the lanes touch read and written once, the six
    # stat leaves read and written once
    hist, _ = ref.fused_ingest_ref(xt, st_, None, lt, num_segments=K, spec=spec)
    sectors = int((hist.reshape(-1, 8) != 0).any(1).sum())
    nbytes = 12 * TICK_LANES + 2 * 32 * sectors + 2 * 6 * K * 4
    b, by = bound_ms(nbytes, 32 * TICK_LANES, bw)  # ~32 operations per lane
    return dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=None,
                ms_delta_form=t_d, ms_old_composition=t_o, ms_back_to_back=t_b, sectors=sectors,
                old_composition="the delta form (fresh zeroed outputs), then the bank's adds")


def range_merge_times(torch, ref, wrappers, spec, bw) -> dict:
    """The node-indexed range merge over a slab (the window query's form)
    beside the composition it replaced (the gather into a (D + 1, 2K, m)
    block, then the stacked merge), the stacked merge alone, the every-
    delta-0 case and ``einsum`` on that case."""
    dev = torch.device(DEVICE)
    slab, bank, nodes, valid, deltas = range_merge_slab(torch, torch.float32)
    gate = torch.tensor(1.0, device=dev)
    mask = torch.cat([valid, gate[None]])
    n32 = nodes.to(torch.int32)
    rm, stacked = wrappers["bank_range_merge"], wrappers["bank_range_merge_stacked"]

    def kernel_deltas(d):  # as ops hands them over: dead slices at -1
        return torch.where(mask[:, None] > 0, d, -1).to(torch.int32).contiguous()

    kd, k0 = kernel_deltas(deltas), kernel_deltas(torch.zeros_like(deltas))
    kd2 = torch.cat([kd, kd], 1).contiguous()
    block = stacked_merge_block(torch, slab, bank, nodes)
    d_slices = RM_SLICES - 1

    def old_composition():  # the gather into a block, then the stacked kernel
        counts = torch.empty((RM_SLICES, 2 * K, M), dtype=torch.float32, device=dev)
        for rows, node_leaf, bank_leaf in ((slice(0, K), slab[0], bank[0]),
                                           (slice(K, 2 * K), slab[1], bank[1])):
            torch.index_select(node_leaf, 0, nodes, out=counts[:d_slices, rows])
            counts[d_slices, rows] = bank_leaf
        return stacked(counts, kd2, spec=spec)

    t_k = time_ms(torch, lambda: rm(*slab, n32, *bank, kd, spec=spec))
    t_k0 = time_ms(torch, lambda: rm(*slab, n32, *bank, k0, spec=spec))
    t_s = time_ms(torch, lambda: stacked(block, kd2, spec=spec))
    t_o = time_ms(torch, old_composition)
    t_p = time_ms(torch, lambda: ref.bank_range_merge_ref(
        stacked_merge_block(torch, slab, bank, nodes), torch.cat([deltas, deltas], 1),
        spec=spec, valid=mask))
    t_l = time_ms(torch, lambda: torch.einsum("d,drm->rm", mask, block))
    # a streaming yardstick: the same bytes (the live slices read, one row
    # block written) through torch.sum over a contiguous block
    live_block = block[mask > 0].contiguous()
    t_sum = time_ms(torch, lambda: live_block.sum(0))
    del live_block
    live = int(mask.sum())  # dead slices need not be read
    rows = 2 * K
    b, by = bound_ms((live + 1) * rows * M * 4 + RM_SLICES * K * 4, live * rows * M, bw)
    return dict(
        ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=t_l,
        library_covers="every delta 0 (einsum over the stacked block's slice axis); "
                       "ms_every_delta_0 is the kernel on that case",
        ms_every_delta_0=t_k0, ms_stacked=t_s, ms_old_composition=t_o, ms_stream_sum=t_sum,
        old_composition="index_select of the covered nodes and a copy of the live bank into "
                        "a (D + 1, 2K, m) block, then the stacked merge",
    )


def timings(torch, ref, wrappers, BucketSpec, device_value_table, bw, rng) -> dict:
    dev = torch.device(DEVICE)
    spec = BucketSpec()
    out = {}
    x, s, lev, _ = ingest_lanes(rng, TICK_LANES, K)
    xt, st_, lt = (torch.from_numpy(a).to(dev) for a in (x, s, lev))
    out["ddsketch_ingest"] = ingest_times(torch, ref, wrappers, spec, bw, xt, st_, lt)
    # the serving tick's own lanes: Zipf(1.1) keys over 4095 rows, level 0
    zrng = np.random.default_rng(SEED + 4)
    zrows = np.repeat(np.arange(CAPACITY, dtype=np.int32), zrng.multinomial(TICK_LANES,
                                                                            zipf_probs(CAPACITY)))
    zt = [torch.from_numpy(a).to(dev) for a in (latencies(zrng, TICK_LANES), zrows)]
    zl = torch.zeros(TICK_LANES, dtype=torch.int32, device=dev)
    zipf = ingest_times(torch, ref, wrappers, spec, bw, zt[0], zt[1], zl)
    out["ddsketch_ingest"]["zipf_serving_lanes"] = {
        key: zipf[key] for key in ("ms", "bound_ms", "ms_delta_form", "ms_old_composition",
                                   "ms_back_to_back", "sectors")}
    del zt, zl

    c = torch.from_numpy(rng.integers(0, 1000, (K, M)).astype(np.float32)).to(dev)
    rows = torch.ones(K, dtype=torch.bool, device=dev)
    fold = wrappers["fold_pairs"]
    keys = torch.arange(M, device=dev) + spec.offset
    dst = ((keys + 1) >> 1) - spec.offset
    t_k = time_ms(torch, lambda: fold(c, spec=spec, rows=rows))
    t_p = time_ms(torch, lambda: torch.where(rows[:, None], ref.fold_pairs_ref(c, spec=spec), c))
    t_l = time_ms(torch, lambda: torch.zeros_like(c).index_add_(1, dst, c))
    b, by = bound_ms(2 * K * M * 4 + K, K * M, bw)  # read + write every count
    out["fold_pairs"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=t_l)

    args = quantile_bank(torch, rng, torch.float32)
    qs = torch.tensor(QS8, device=dev)
    table = device_value_table(spec, dev)
    bq = wrappers["bank_quantiles"]
    t_k = time_ms(torch, lambda: bq(*args, qs, table))
    t_p = time_ms(torch, lambda: ref.bank_quantiles_ref(*args, qs, table))

    def quantiles_bound(nq):  # the counts, row scalars and table read; (K, Q) written
        nbytes = 2 * K * M * 4 + 4 * K * 4 + table.numel() * 4 + nq * 4 + K * nq * 4
        return bound_ms(nbytes, K * (2 * (2 * M + 1) + 12 * nq), bw)  # scan + searches

    b, by = quantiles_bound(len(QS8))
    # the windowed query's own Q (ALPHA_QS), as the profiled 64-slice query runs it
    qw = torch.tensor(ALPHA_QS, device=dev)
    window_q = {"q": len(ALPHA_QS), "ms": time_ms(torch, lambda: bq(*args, qw, table)),
                "bound_ms": quantiles_bound(len(ALPHA_QS))[0]}
    # a streaming yardstick: the same 64 MiB of counts through one torch.sum
    counts = torch.stack([args[0], args[1]])
    t_sum = time_ms(torch, lambda: counts.sum())
    del counts
    out["bank_quantiles"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=None,
                                 window_query=window_q, ms_stream_sum=t_sum)

    out["bank_range_merge"] = range_merge_times(torch, ref, wrappers, spec, bw)

    x, s, lev, _ = ingest_lanes(rng, TICK_LANES, K)
    xt, st_, lt = (torch.from_numpy(a).to(dev) for a in (x, s, lev))
    seg, hist = wrappers["ddsketch_seg_hist"], wrappers["ddsketch_hist"]
    t_k = time_ms(torch, lambda: seg(xt, st_, None, lt, num_segments=K, spec=spec))
    t_p = time_ms(torch, lambda: ref.segment_histogram_ref(xt, st_, None, lt, num_segments=K,
                                                           spec=spec))
    b, by = bound_ms(12 * TICK_LANES + K * M * 4, 32 * TICK_LANES, bw)  # x, ids, levels; hist
    out["ddsketch_seg_hist"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by,
                                    library_ms=None)
    t_k = time_ms(torch, lambda: hist(xt, None, lt, spec=spec))
    t_p = time_ms(torch, lambda: ref.histogram_ref(xt, None, lt, spec=spec))
    b, by = bound_ms(8 * TICK_LANES + M * 4, 32 * TICK_LANES, bw)  # x, levels; one row
    # its two launches apart: the lanes binned into per-CTA partial rows,
    # then the rows summed
    partials = wrappers["ddsketch_hist_bin"](xt, None, lt, spec=spec)
    phases = {"bin": time_ms(torch, lambda: wrappers["ddsketch_hist_bin"](xt, None, lt,
                                                                         spec=spec)),
              "sum": time_ms(torch, lambda: wrappers["ddsketch_hist_sum"](partials)),
              "partial_rows": partials.shape[0], "all": t_k}
    out["ddsketch_hist"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=None,
                                ms_by_phase=phases)

    keys, wts = ref.compact_triples(xt, st_, None, lt, num_segments=K, spec=spec)
    cap = min(TICK_LANES, 2 * K * M + 1)
    kk, ww = keys[:cap].contiguous(), wts[:cap].contiguous()
    live_keys = kk < 2 * K * M
    kin, win = kk[live_keys].long(), ww[live_keys]
    scat = wrappers["ddsketch_scatter"]
    t_k = time_ms(torch, lambda: scat(kk, ww, num_rows=2 * K, num_buckets=M))
    t_p = time_ms(torch, lambda: ref.scatter_histogram_ref(kk, ww, num_rows=2 * K,
                                                           num_buckets=M))
    t_l = time_ms(torch, lambda: torch.bincount(kin, win, minlength=2 * K * M))
    u = int(kin.numel())  # the triples this run's data holds
    b, by = bound_ms(8 * u + 2 * K * M * 4, u, bw)
    out["ddsketch_scatter"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by,
                                   library_ms=t_l, triples=u)
    return out


# --------------------------------------------------------------------- #
def max_abs_err(err: dict) -> float:
    """The largest ``max_abs_err`` of a kernel's checks (one dict, or one
    per form)."""
    if "max_abs_err" in err:
        return err["max_abs_err"]
    return max(max_abs_err(e) for e in err.values() if isinstance(e, dict))


REPLACES = {
    "ddsketch_ingest": "src/repro/kernels/ddsketch_ingest.py:59",
    "fold_pairs": "src/repro/kernels/fold_pairs.py:40",
    "bank_quantiles": "src/repro/kernels/bank_quantiles.py:37",
    "bank_range_merge": "src/repro/kernels/bank_range_merge.py:52",
    "ddsketch_seg_hist": "src/repro/kernels/ddsketch_seg_hist.py:47",
    "ddsketch_hist": "src/repro/kernels/ddsketch_hist.py:42",
    "ddsketch_scatter": "src/repro/kernels/ddsketch_scatter.py:53",
}
# the kernels each path must have launched
PATH_KERNELS = {
    "serving": ("ddsketch_ingest", "fold_pairs", "bank_quantiles"),
    "window": ("ddsketch_ingest", "fold_pairs", "bank_quantiles", "bank_range_merge"),
    "insert": ("ddsketch_seg_hist", "ddsketch_hist", "ddsketch_scatter", "fold_pairs",
               "bank_quantiles"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from repro_torch.core import sketch_bank as sbank
    from repro_torch.core import torch_sketch as tsk
    from repro_torch.core.torch_sketch import effective_alpha
    from repro_torch.engine.tables import device_value_table
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.bank_quantiles import bank_quantiles_cuda
    from repro_torch.kernels.bank_range_merge import (
        bank_range_merge_cuda,
        bank_range_merge_nodes_cuda,
    )
    from repro_torch.kernels.ddsketch_hist import bin_rows, histogram_cuda, sum_rows
    from repro_torch.kernels.ddsketch_ingest import ddsketch_ingest_cuda, ddsketch_ingest_into_cuda
    from repro_torch.kernels.ddsketch_scatter import scatter_cuda
    from repro_torch.kernels.ddsketch_seg_hist import segment_histogram_cuda
    from repro_torch.kernels.fold_pairs import fold_pairs_cuda
    from repro_torch.kernels.ref import BucketSpec

    wrappers = {
        # the forms the main paths launch: in place, and node-indexed
        "ddsketch_ingest": ddsketch_ingest_into_cuda,
        "fold_pairs": fold_pairs_cuda,
        "bank_quantiles": bank_quantiles_cuda,
        "bank_range_merge": bank_range_merge_nodes_cuda,
        # the delta and stacked forms, timed beside them
        "ddsketch_ingest_delta": ddsketch_ingest_cuda,
        "bank_range_merge_stacked": bank_range_merge_cuda,
        "ddsketch_seg_hist": segment_histogram_cuda,
        "ddsketch_hist": histogram_cuda,
        "ddsketch_hist_bin": bin_rows,  # its two launches, timed apart
        "ddsketch_hist_sum": sum_rows,
        "ddsketch_scatter": scatter_cuda,
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw = mem_bandwidth(name)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"memory rate taken as {bw / 1e12} TB/s")
    t_run = time.perf_counter()

    t = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t:.2f} s (nvcc, one process per source)")

    # phase 2: every kernel against its plain version
    rng = np.random.default_rng(SEED)
    t = time.perf_counter()
    errs = {
        "ddsketch_ingest": {"delta_form": check_ingest(torch, ops, ref, BucketSpec, rng),
                            "in_place": check_ingest_into(torch, ops, ref, BucketSpec, rng)},
        "fold_pairs": check_fold(torch, ops, ref, BucketSpec, rng),
        "bank_quantiles": check_quantiles(torch, ops, ref, BucketSpec, device_value_table, rng),
        "bank_range_merge": {"stacked": check_range_merge(torch, ops, ref, BucketSpec),
                             "nodes": check_range_merge_nodes(torch, ops, ref, BucketSpec)},
        **check_histograms(torch, ops, ref, BucketSpec, rng),
        "ddsketch_scatter": check_scatter(torch, ops, ref, BucketSpec, rng),
    }
    log(f"kernels vs plain versions: {json.dumps(errs)} ({time.perf_counter() - t:.1f} s)")

    # phase 4, run first: the serving path's last tick runs under the profiler
    times = timings(torch, ref, wrappers, BucketSpec, device_value_table, bw, rng)
    log(f"kernel times (ms): {json.dumps(times)}")
    torch.cuda.empty_cache()

    launches = {}

    def drive(path, fn):
        """Run one path with the launch counters zeroed just before and
        read just after; every kernel of the path must have launched."""
        ops.reset_dispatch_stats()
        out = fn()
        torch.cuda.synchronize()
        launches[path] = ops.dispatch_stats()["launches"]
        for kname in PATH_KERNELS[path]:
            check(launches[path][kname] > 0, f"the {path} path never launched {kname}")
        log(f"{path} path launches: {launches[path]}")
        return out

    # phase 3a: serving
    main_run = drive("serving", lambda: serve_session("cuda", "log", ticks=4, posts=24))
    log(f"serving path: {main_run['lanes']} lanes, {main_run['seconds']:.2f} s, "
        f"collapse events {len(main_run['events'])}")
    check(len(main_run["events"]) > 0, "the outlier key never fired a reactive collapse")
    alpha = check_alpha(torch, main_run, effective_alpha, BucketSpec)
    log(f"relative-error guarantee: {json.dumps(alpha)}")
    log(f"host clock (s): {json.dumps(main_run['clock'])}")
    stats = main_run["bodies"]["stats"]
    log(f"/stats engine: {json.dumps(stats['engine'])}")
    del main_run

    lin_gpu = serve_session("cuda", "linear", ticks=2, posts=8)
    lin_cpu = serve_session("cpu", "linear", ticks=2, posts=8)
    for path in ("live", "rollup"):
        check(lin_gpu["bodies"][path] == lin_cpu["bodies"][path],
              f"linear /{path} body differs between the card and the CPU")
    log(f"linear session: /live ({len(lin_gpu['bodies']['live'])} bytes) and /rollup bodies "
        f"equal on card and CPU ({lin_gpu['seconds']:.2f} s card, {lin_cpu['seconds']:.2f} s CPU)")
    del lin_gpu, lin_cpu

    # phase 3b: windowed serving
    win = drive("window", lambda: window_session(
        "cuda", "log", slices=SLICES_DRIVEN, lanes=SLICE_LANES, outliers=range(20, 31),
        poll=True))
    check(len(win["events"]) > 0, "no key's level rose mid-ring")
    walpha = check_window_alpha(win, effective_alpha, BucketSpec)
    adv = win["clock"]["advance_slice_s"]
    log(f"window path: {win['values'].size} lanes over {win['slices']} slices, "
        f"{win['seconds']:.2f} s, collapse events {len(win['events'])}, "
        f"ring {json.dumps(win['bodies']['stats_ring'])}")
    log(f"window guarantee: {json.dumps(walpha)}")
    log(f"window fold: {json.dumps(check_window_fold(torch, sbank, win['window']))}")
    log(f"window query profile: {json.dumps(profile_window_query(torch, win['window']))}")
    log(f"window host clock (s): advance_slice median {statistics.median(adv)}, "
        f"max {max(adv)}, first /rollup?window=1h {win['clock']['first_rollup_1h_s']}")
    log(f"slice clock: {json.dumps(slice_clock(win['window']))}")
    del win
    torch.cuda.empty_cache()
    wl_gpu, wl_cpu = (
        window_session(dev, "linear", slices=12, lanes=1 << 14, outliers=range(3, 6),
                       poll=False)
        for dev in ("cuda", "cpu")
    )
    for path in (*WINDOW_READS, "stats_ring"):
        check(wl_gpu["bodies"][path] == wl_cpu["bodies"][path],
              f"linear windowed {path} differs between the card and the CPU")
    log(f"linear window session: {len(WINDOW_READS)} windowed bodies equal on card and CPU "
        f"({wl_gpu['seconds']:.2f} s card, {wl_cpu['seconds']:.2f} s CPU)")
    del wl_gpu, wl_cpu
    torch.cuda.empty_cache()

    # phase 3c: the insert pipelines and the single sketch
    spec = BucketSpec()
    inputs = insert_inputs(torch, DEVICE)
    fused = insert_banks(sbank, spec, inputs, ("fused",))["fused"]

    def insert_path():
        return (insert_banks(sbank, spec, inputs, ("matmul", "sort")),
                insert_sketches(tsk, spec, inputs))

    banks, sketches = drive("insert", insert_path)
    ins = check_insert(torch, banks, fused, inputs)
    sk_alpha = check_sketch_alpha(sketches, inputs, effective_alpha, spec)
    lin = BucketSpec(mapping="linear")
    q_gpu = insert_sketches(tsk, lin, inputs)
    q_cpu = insert_sketches(tsk, lin, insert_inputs(torch, "cpu"))
    for n in q_gpu:
        check(torch.equal(q_gpu[n][1].cpu(), q_cpu[n][1]),
              f"linear DeviceSketch n={n}: quantiles differ between the card and the CPU")
    log(f"insert path: matmul and sort banks equal the fused bank ({json.dumps(ins)}); "
        f"DeviceSketch worst relative error {json.dumps(sk_alpha)}; linear sketch quantiles "
        "equal on card and CPU")

    kernels = []
    for kname in _build.KERNELS:
        by_path = {path: counts[kname] for path, counts in launches.items()}
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}.cu",
            "replaces": REPLACES[kname],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_abs_err(errs[kname]),
            **times[kname],
        })
    for row in kernels:
        check(all(math.isfinite(row[k]) for k in ("ms", "plain_ms", "bound_ms")), "timings")
    log(f"whole run: {time.perf_counter() - t_run:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
