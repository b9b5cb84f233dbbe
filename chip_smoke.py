#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card.  The
script builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, started together), then:

1. holds each kernel against its plain PyTorch version on the card, at the
   serving shapes (K = 4096 rows, m = 2048 buckets, ticks of 2^20 lanes,
   Q = 8), over the three mappings, levels 0-6 and weights none / integer
   / fractional, with NaN, +-inf, +-0, out-of-range ids and padding lanes;
2. drives the main path once at full width: a ``KeyedWindow`` of capacity
   4095 on the card behind an ``IngestGateway`` and a ``QuantileHTTPServer``
   on an ephemeral localhost port, a few ``POST /ingest`` batches, direct
   ``record_batches`` ticks of 2^20 lanes, then ``GET /live``, ``/rollup``,
   an ``If-None-Match`` re-poll that must get 304, ``/stats`` and, after an
   aggregator flush, ``/quantiles``.  The kernel launch counters are zeroed
   just before and read just after, and every kernel must have launched;
3. checks the answers: the relative-error guarantee per row against
   numpy's exact quantiles, and, under the ``linear`` mapping, ``/live``
   and ``/rollup`` bodies equal to the same session run on the CPU;
4. times each kernel, its plain version and the one PyTorch call that
   computes the same function where there is one, with CUDA events (before
   the main path, whose last ingest tick runs under ``torch.profiler``),
   and states each kernel's bound from the bytes it must move.

It prints the card's name and power limit, then a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``.  Any failed check raises,
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


def quantile_bank(torch, rng, dt):
    """A (K, m) bank at mixed levels with integer counts, empty rows and
    rows holding only zeros, plus the extrema the counts came from."""
    dev = torch.device(DEVICE)
    pos = rng.poisson(rng.gamma(0.3, 2.0, (K, 1)), (K, M)).astype(np.float32)
    neg = rng.poisson(0.05, (K, M)).astype(np.float32)
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


def check_quantiles(torch, ops, ref, BucketSpec, device_value_table, rng) -> dict:
    dev = torch.device(DEVICE)
    spec = BucketSpec()
    table = device_value_table(spec, dev)
    qs = torch.tensor(QS8, device=dev)
    err = 0.0
    for dt in (torch.float32, torch.int32):
        args = quantile_bank(torch, rng, dt)
        got = ops.bank_quantiles(*args, qs, spec=spec, table=table)
        want = ref.bank_quantiles_ref(*args, qs, table)
        same = (got == want) | (got.isnan() & want.isnan())
        check(bool(same.all()), f"bank_quantiles {dt}: not bit-exact")
        both = ~want.isnan()
        err = max(err, float((got[both] - want[both]).abs().max()))
    # fractional counts: the block scan reassociates n and the cumulative
    # counts, so a rank at a bucket boundary may pick the neighbour bucket;
    # allow 0.1% of the (row, q) answers to differ
    pos, neg, zero, vmin, vmax, level = quantile_bank(torch, rng, torch.float32)
    scale = torch.rand(pos.shape, device=dev)
    args = (pos * scale, neg * scale, zero * 0.37, vmin, vmax, level)
    got = ops.bank_quantiles(*args, qs, spec=spec, table=table)
    want = ref.bank_quantiles_ref(*args, qs, table)
    differ = int((~((got == want) | (got.isnan() & want.isnan()))).sum())
    check(differ <= 1e-3 * got.numel(), f"bank_quantiles fractional: {differ} answers differ")
    return {"max_abs_err": err, "fractional_differing": differ}


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


def check_alpha(torch, session, effective_alpha, BucketSpec) -> dict:
    """|est - exact| <= alpha(level) |exact| per row, for rows that clamped
    nothing, against the exact value at the sketch's own float32 rank."""
    spec = BucketSpec()
    window, bank = session["window"], session["bank"]
    est = window.engine.host_rows(window.engine.quantiles(bank, ALPHA_QS))
    lev = window.engine.host_rows(bank.level)
    clamped = {int(window.key_to_row.get(e.key, 0)) for e in session["events"]}
    ovf = window.engine.host_rows(bank.overflow + bank.underflow)
    rows, vals, wts = session["rows"], session["values"], session["weights"]
    keep = np.isfinite(vals)
    rows, vals = rows[keep], vals[keep]
    reps = wts[keep].astype(np.int64)
    rows, vals = np.repeat(rows, reps), np.repeat(vals, reps)
    order = np.lexsort((vals, rows))
    rows, vals = rows[order], vals[order]
    starts = np.searchsorted(rows, np.arange(K))
    ends = np.searchsorted(rows, np.arange(K), side="right")
    checked = worst = 0.0
    for r in range(K):
        n = ends[r] - starts[r]
        if n == 0 or r in clamped or ovf[r] > 0:
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
    check(checked > 0.9 * len(window.key_to_row), f"alpha check covered {checked} rows")
    return {"rows_checked": int(checked), "worst_rel_err": worst, "clamped_rows": len(clamped)}


# --------------------------------------------------------------------- #
# phase 3: times on the card
# --------------------------------------------------------------------- #
def time_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
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


def timings(torch, ref, wrappers, BucketSpec, device_value_table, bw, rng) -> dict:
    dev = torch.device(DEVICE)
    spec = BucketSpec()
    out = {}
    x, s, lev, _ = ingest_lanes(rng, TICK_LANES, K)
    xt, st_, lt = (torch.from_numpy(a).to(dev) for a in (x, s, lev))
    ingest = wrappers["ddsketch_ingest"]
    t_k = time_ms(torch, lambda: ingest(xt, st_, None, lt, num_segments=K, spec=spec))
    t_p = time_ms(torch, lambda: ref.fused_ingest_ref(xt, st_, None, lt, num_segments=K, spec=spec))
    nbytes = 12 * TICK_LANES + 2 * K * M * 4 + 6 * K * 4  # x, ids, levels in; hist, stats out
    b, by = bound_ms(nbytes, 32 * TICK_LANES, bw)  # ~32 operations per lane
    out["ddsketch_ingest"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=None)

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
    nq = len(QS8)
    nbytes = 2 * K * M * 4 + 4 * K * 4 + table.numel() * 4 + nq * 4 + K * nq * 4
    b, by = bound_ms(nbytes, (2 + nq) * K * (2 * M + 1), bw)  # scan + Q rank counts
    out["bank_quantiles"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=None)
    return out


# --------------------------------------------------------------------- #
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from repro_torch.core.torch_sketch import effective_alpha
    from repro_torch.engine.tables import device_value_table
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.bank_quantiles import bank_quantiles_cuda
    from repro_torch.kernels.ddsketch_ingest import ddsketch_ingest_cuda
    from repro_torch.kernels.fold_pairs import fold_pairs_cuda
    from repro_torch.kernels.ref import BucketSpec

    wrappers = {"ddsketch_ingest": ddsketch_ingest_cuda, "fold_pairs": fold_pairs_cuda,
                "bank_quantiles": bank_quantiles_cuda}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw = mem_bandwidth(name)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"memory rate taken as {bw / 1e12} TB/s")

    t = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t:.2f} s (nvcc, one process per source)")

    rng = np.random.default_rng(SEED)
    t = time.perf_counter()
    errs = {
        "ddsketch_ingest": check_ingest(torch, ops, ref, BucketSpec, rng),
        "fold_pairs": check_fold(torch, ops, ref, BucketSpec, rng),
        "bank_quantiles": check_quantiles(torch, ops, ref, BucketSpec, device_value_table, rng),
    }
    log(f"kernels vs plain versions: {json.dumps(errs)} ({time.perf_counter() - t:.1f} s)")

    # timed before the main path, whose last tick runs under the profiler
    times = timings(torch, ref, wrappers, BucketSpec, device_value_table, bw, rng)
    log(f"kernel times (ms): {json.dumps(times)}")

    ops.reset_dispatch_stats()
    main_run = serve_session("cuda", "log", ticks=4, posts=24)
    torch.cuda.synchronize()
    launches = ops.dispatch_stats()["launches"]
    log(f"main path: {main_run['lanes']} lanes, {main_run['seconds']:.2f} s, "
        f"launches {launches}, collapse events {len(main_run['events'])}")
    for kname, count in launches.items():
        check(count > 0, f"main path never launched {kname}")
    check(len(main_run["events"]) > 0, "the outlier key never fired a reactive collapse")
    alpha = check_alpha(torch, main_run, effective_alpha, BucketSpec)
    log(f"relative-error guarantee: {json.dumps(alpha)}")
    log(f"host clock (s): {json.dumps(main_run['clock'])}")
    stats = main_run["bodies"]["stats"]
    log(f"/stats engine: {json.dumps(stats['engine'])}")

    lin_gpu = serve_session("cuda", "linear", ticks=2, posts=8)
    lin_cpu = serve_session("cpu", "linear", ticks=2, posts=8)
    for path in ("live", "rollup"):
        check(lin_gpu["bodies"][path] == lin_cpu["bodies"][path],
              f"linear /{path} body differs between the card and the CPU")
    log(f"linear session: /live ({len(lin_gpu['bodies']['live'])} bytes) and /rollup bodies "
        f"equal on card and CPU ({lin_gpu['seconds']:.2f} s card, {lin_cpu['seconds']:.2f} s CPU)")

    replaces = {
        "ddsketch_ingest": "src/repro/kernels/ddsketch_ingest.py:59",
        "fold_pairs": "src/repro/kernels/fold_pairs.py:40",
        "bank_quantiles": "src/repro/kernels/bank_quantiles.py:37",
    }
    kernels = []
    for kname in _build.KERNELS:
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}.cu",
            "replaces": replaces[kname],
            "launches": launches[kname],
            "max_abs_err": errs[kname]["max_abs_err"],
            **times[kname],
        })
    for row in kernels:
        check(all(math.isfinite(row[k]) for k in ("ms", "plain_ms", "bound_ms")), "timings")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
