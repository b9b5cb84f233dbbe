"""The port's kernel front doors against the JAX package's Pallas kernels.

On the CPU the front doors (``repro_torch.kernels.ops``) take the plain
versions because the tensors lie on the CPU; the JAX side runs its Pallas
kernels in interpret mode.  Tolerances as in ``test_torch_ref.py``:
bit-exact histograms, counters, folds and quantiles for integer weights
under ``linear`` / ``cubic``; ``summ`` within 2 n u sum|w x| per row.

The hand-written CUDA kernels themselves run only on a card: the test
marked ``gpu`` holds them against the plain versions there and skips
elsewhere (``python3 chip_smoke.py`` checks them at the serving shapes).
The JAX package comes in through a fixture, so this file also collects on
a machine with a card and no JAX (``python -m pytest -m gpu`` there).
"""

import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.engine.tables import device_value_table
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ref import BucketSpec as TSpec

U = 2.0**-24


@pytest.fixture
def jx():
    """The JAX side: ``jnp``, the Pallas front doors and their spec."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops
    from repro.kernels.ref import BucketSpec

    return SimpleNamespace(jnp=jnp, ops=ops, Spec=BucketSpec)


def _lanes(rng, n, k):
    x = (rng.pareto(1.0, n) + 1.0).astype(np.float32)
    x *= np.where(rng.random(n) < 0.3, -1.0, 1.0).astype(np.float32)
    x[:6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e12]
    s = np.sort(rng.integers(-1, k + 1, n)).astype(np.int32)
    lev = rng.integers(0, 7, n).astype(np.int32)
    return x, s, lev


@pytest.mark.parametrize("mapping", ["linear", "cubic"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fused_ingest_front_door_matches_pallas_interpret(mapping, weighted, rng, jx):
    jnp = jx.jnp
    k, n = 16, 2048
    js = jx.Spec(num_buckets=512, offset=-256, mapping=mapping)
    ts = TSpec(num_buckets=512, offset=-256, mapping=mapping)
    x, s, lev = _lanes(rng, n, k)
    w = rng.integers(0, 4, n).astype(np.float32) if weighted else None
    jp, jn, jst = jx.ops.fused_ingest(
        jnp.asarray(x), jnp.asarray(s), None if w is None else jnp.asarray(w),
        jnp.asarray(lev), num_segments=k, spec=js, force="interpret",
    )
    tp, tn, tst = tops.fused_ingest(
        torch.from_numpy(x), torch.from_numpy(s), None if w is None else torch.from_numpy(w),
        torch.from_numpy(lev), num_segments=k, spec=ts,
    )
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for f in ("zero", "overflow", "underflow", "vmin", "vmax"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))
    valid = np.isfinite(x) & (s >= 0) & (s < k)
    wv = np.ones(n, np.float32) if w is None else w
    absum = np.bincount(s[valid], np.abs(wv * x)[valid].astype(np.float64), minlength=k)
    nrow = np.bincount(s[valid], minlength=k)
    assert np.all(np.abs(tst.summ.numpy() - np.asarray(jst.summ)) <= 2 * nrow * U * absum)


def test_fold_pairs_front_door_matches_pallas_interpret(rng, jx):
    js, ts = jx.Spec(num_buckets=512, offset=-256), TSpec(num_buckets=512, offset=-256)
    c = rng.integers(0, 1000, (16, 512)).astype(np.float32)
    want = np.asarray(jx.ops.fold_pairs(jx.jnp.asarray(c), spec=js, force="interpret"))
    np.testing.assert_array_equal(tops.fold_pairs(torch.from_numpy(c), spec=ts).numpy(), want)
    # the fused row mask: unselected rows keep their counts; out= folds in place
    rows = torch.from_numpy(rng.random(16) < 0.5)
    t = torch.from_numpy(c.copy())
    tops.fold_pairs(t, spec=ts, rows=rows, out=t)
    np.testing.assert_array_equal(t.numpy(), np.where(rows.numpy()[:, None], want, c))


def _bank_quantiles_case(jx, rng, *, mapping, num_buckets, qs):
    """One bank (an empty row, mixed levels) through the port's front door
    and the JAX Pallas kernel in interpret mode: the two answers."""
    jnp = jx.jnp
    offset = -(num_buckets // 2)
    js = jx.Spec(num_buckets=num_buckets, offset=offset, mapping=mapping)
    ts = TSpec(num_buckets=num_buckets, offset=offset, mapping=mapping)
    k = 16
    pos = rng.poisson(2.0, (k, num_buckets)).astype(np.float32)
    neg = rng.poisson(0.3, (k, num_buckets)).astype(np.float32)
    zero = rng.poisson(3.0, k).astype(np.float32)
    pos[0] = neg[0] = zero[0] = 0
    vmin = np.full(k, -5e4, np.float32)
    vmax = np.full(k, 5e4, np.float32)
    level = rng.integers(0, 7, k).astype(np.int32)
    args = (pos, neg, zero, vmin, vmax, level)
    want = np.asarray(
        jx.ops.bank_quantiles(*map(jnp.asarray, args), jnp.asarray(qs, jnp.float32),
                            spec=js, force="interpret")
    )
    got = tops.bank_quantiles(*map(torch.from_numpy, args), qs, spec=ts).numpy()
    return got, want


@pytest.mark.parametrize("mapping", ["log", "linear", "cubic"])
def test_bank_quantiles_front_door_matches_pallas_interpret(mapping, rng, jx):
    qs = [0.0, 0.05, 0.5, 0.95, 0.99, 1.0]
    got, want = _bank_quantiles_case(jx, rng, mapping=mapping, num_buckets=512, qs=qs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nq", [1, 8, 33])
@pytest.mark.parametrize("num_buckets", [512, 1001])
def test_bank_quantiles_q_counts_and_odd_buckets_match_pallas_interpret(nq, num_buckets, rng,
                                                                          jx):
    """Q = 1, 8 and 33 (more than one warp of answers), and an odd
    num_buckets, whose rows the card kernel reads unaligned."""
    qs = np.linspace(0.0, 1.0, nq, dtype=np.float32) if nq > 1 else [0.99]
    got, want = _bank_quantiles_case(jx, rng, mapping="linear", num_buckets=num_buckets, qs=qs)
    assert got.shape == (16, nq)
    np.testing.assert_array_equal(got, want)


def _upper_bound(cum: np.ndarray, rank: np.ndarray) -> np.ndarray:
    """The card kernel's search, row by row and q by q: the first index
    whose cum exceeds rank (``a``, ``b`` and ``mid`` as in
    ``csrc/bank_quantiles.cu``)."""
    a = np.zeros(rank.shape, np.int64)
    b = np.full(rank.shape, cum.shape[1], np.int64)
    rows = np.arange(cum.shape[0])[:, None]
    while np.any(a < b):
        live = a < b
        mid = (a + b) >> 1
        go_right = cum[rows, np.minimum(mid, cum.shape[1] - 1)] <= rank
        a = np.where(live & go_right, mid + 1, a)
        b = np.where(live & ~go_right, mid, b)
    return a


def test_binary_search_equals_compare_and_count_on_nonnegative_rows(rng):
    """The premise of the card kernel's search: on non-negative fractional
    lines (with empty runs, so cum has plateaus, and ranks that land on a
    cum value exactly), the JAX kernel's #{cum <= rank} equals
    torch.searchsorted(cum, rank, right=True) and the kernel's upper-bound
    binary search for every q."""
    k, width = 64, 2 * 512 + 1
    line = rng.random((k, width)).astype(np.float32) * (rng.random((k, width)) < 0.3)
    line[0] = 0.0  # an empty row
    line[1, :100] = 0.0
    cum = torch.from_numpy(line).cumsum(dim=1)
    n = cum[:, -1:]
    qs = torch.from_numpy(np.concatenate([np.linspace(0.0, 1.0, 41), [0.01, 0.99]])
                          .astype(np.float32))
    rank = qs[None, :] * torch.clamp(n - 1.0, min=0.0)
    rank[2:10, :8] = cum[2:10, rng.integers(0, width, 8)]  # ties with cum
    count = (cum[:, None, :] <= rank[:, :, None]).sum(dim=-1)
    assert torch.equal(count, torch.searchsorted(cum, rank.contiguous(), right=True))
    np.testing.assert_array_equal(_upper_bound(cum.numpy(), rank.numpy()), count.numpy())


def test_dispatch_stats_count_launches_only():
    tops.reset_dispatch_stats()
    ts = TSpec(num_buckets=512, offset=-256)
    tops.fold_pairs(torch.zeros(2, 512), spec=ts)  # CPU: the plain version
    tops.bank_range_merge(torch.zeros(2, 2, 512), torch.zeros(2, 2, dtype=torch.int32), spec=ts)
    tops.segment_histogram(torch.ones(4), torch.zeros(4, dtype=torch.int32), num_segments=1,
                           spec=ts)
    tops.ddsketch_histogram(torch.ones(4), spec=ts)
    tops.ddsketch_scatter(torch.zeros(4, dtype=torch.int32), torch.ones(4), num_rows=1,
                          num_buckets=512)
    leaves = [torch.zeros(1, 512), torch.zeros(1, 512),
              *(torch.zeros(1) for _ in range(4)), torch.full((1,), np.inf),
              torch.full((1,), -np.inf)]
    tops.fused_ingest_into(leaves[0], leaves[1], tops.IngestStats(*leaves[2:]), torch.ones(4),
                           torch.zeros(4, dtype=torch.int32), spec=ts)
    tops.bank_range_merge_nodes(torch.zeros(2, 1, 512), torch.zeros(2, 1, 512),
                                torch.tensor([1, 0]), torch.tensor([1.0, 0.0]),
                                torch.zeros(1, 512), torch.zeros(1, 512), torch.tensor(1.0),
                                torch.zeros(3, 1, dtype=torch.int32), spec=ts)
    stats = tops.dispatch_stats()
    assert stats == {"launches": {
        "ddsketch_ingest": 0, "fold_pairs": 0, "bank_quantiles": 0, "bank_range_merge": 0,
        "ddsketch_seg_hist": 0, "ddsketch_hist": 0, "ddsketch_scatter": 0,
    }}


def test_kernel_modules_import_without_nvcc_or_triton():
    code = (
        "import sys\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ddsketch_ingest\n"
        "import repro_torch.kernels.fold_pairs, repro_torch.kernels.bank_quantiles\n"
        "import repro_torch.kernels.bank_range_merge, repro_torch.kernels.ddsketch_seg_hist\n"
        "import repro_torch.kernels.ddsketch_hist, repro_torch.kernels.ddsketch_scatter\n"
        "from repro_torch.kernels import _build\n"
        "assert 'triton' not in sys.modules\n"
        "assert not _build._libs, 'a kernel was built at import'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never falls back."""
    from repro_torch.kernels.bank_quantiles import bank_quantiles_cuda
    from repro_torch.kernels.ddsketch_ingest import ddsketch_ingest_cuda
    from repro_torch.kernels.fold_pairs import fold_pairs_cuda

    ts = TSpec(num_buckets=512, offset=-256)
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        ddsketch_ingest_cuda(x, x.int(), None, None, num_segments=1, spec=ts)
    with pytest.raises(ValueError):
        fold_pairs_cuda(torch.zeros(2, 512), spec=ts)
    c = torch.zeros(2, 512)
    with pytest.raises(ValueError):
        bank_quantiles_cuda(c, c, torch.zeros(2), x[:2], x[:2], torch.zeros(2, dtype=torch.int32),
                            x[:1], torch.zeros(7, 512))
    from repro_torch.kernels.bank_range_merge import bank_range_merge_cuda
    from repro_torch.kernels.ddsketch_hist import histogram_cuda
    from repro_torch.kernels.ddsketch_scatter import scatter_cuda
    from repro_torch.kernels.ddsketch_seg_hist import segment_histogram_cuda

    with pytest.raises(ValueError):
        bank_range_merge_cuda(torch.zeros(2, 2, 512), torch.zeros(2, 2, dtype=torch.int32),
                              spec=ts)
    from repro_torch.kernels.bank_range_merge import bank_range_merge_nodes_cuda
    from repro_torch.kernels.ddsketch_ingest import ddsketch_ingest_into_cuda

    with pytest.raises(ValueError):
        bank_range_merge_nodes_cuda(torch.zeros(2, 1, 512), torch.zeros(2, 1, 512),
                                    torch.zeros(1, dtype=torch.int32), torch.zeros(1, 512),
                                    torch.zeros(1, 512), torch.zeros(2, 1, dtype=torch.int32),
                                    spec=ts)
    with pytest.raises(ValueError):
        ddsketch_ingest_into_cuda(x, x.int(), None, None, pos=torch.zeros(1, 512),
                                  neg=torch.zeros(1, 512),
                                  stats=tref.IngestStats(*(torch.zeros(1) for _ in range(6))),
                                  spec=ts)
    with pytest.raises(ValueError):
        segment_histogram_cuda(x, x.int(), None, None, num_segments=1, spec=ts)
    with pytest.raises(ValueError):
        histogram_cuda(x, None, None, spec=ts)
    with pytest.raises(ValueError):
        scatter_cuda(x.int(), x, num_rows=1, num_buckets=512)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    dev = torch.device("cuda")
    ts = TSpec()
    k, n = 64, 1 << 16
    x, s, lev = _lanes(rng, n, k)
    xt, st_, lt = (torch.from_numpy(a).to(dev) for a in (x, s, lev))
    tops.reset_dispatch_stats()
    p, q, st = tops.fused_ingest(xt, st_, None, lt, num_segments=k, spec=ts)
    hp, sp = tref.fused_ingest_ref(xt, st_, None, lt, num_segments=k, spec=ts)
    assert torch.equal(torch.cat([p, q]), hp)
    for f in ("zero", "overflow", "underflow", "vmin", "vmax"):
        assert bool((getattr(st, f) == getattr(sp, f)).all())
    folded = tops.fold_pairs(hp, spec=ts)
    assert torch.equal(folded, tref.fold_pairs_ref(hp, spec=ts))
    lv = torch.from_numpy(rng.integers(0, 7, k).astype(np.int32)).to(dev)
    qs = torch.tensor([0.0, 0.5, 0.99, 1.0], device=dev)
    table = device_value_table(ts, dev)
    got = tops.bank_quantiles(p, q, sp.zero, sp.vmin, sp.vmax, lv, qs, spec=ts, table=table)
    want = tref.bank_quantiles_ref(p, q, sp.zero, sp.vmin, sp.vmax, lv, qs, table)
    assert bool(((got == want) | (got.isnan() & want.isnan())).all())
    launches = tops.dispatch_stats()["launches"]
    assert all(launches[name] > 0 for name in ("ddsketch_ingest", "fold_pairs", "bank_quantiles"))


@pytest.mark.gpu
def test_cuda_window_and_insert_kernels_match_plain_versions(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    dev = torch.device("cuda")
    ts = TSpec()
    k, n = 64, 1 << 16
    tops.reset_dispatch_stats()
    counts = torch.from_numpy(rng.integers(0, 100, (5, 2 * k, ts.num_buckets))
                              .astype(np.float32)).to(dev)
    deltas = torch.from_numpy(rng.integers(0, 7, (5, 2 * k)).astype(np.int32)).to(dev)
    valid = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0], device=dev)
    got = tops.bank_range_merge(counts, deltas, spec=ts, valid=valid)
    assert torch.equal(got, tref.bank_range_merge_ref(counts, deltas, spec=ts, valid=valid))
    x, s, lev = _lanes(rng, n, k)
    xt, st_, lt = (torch.from_numpy(a).to(dev) for a in (x, s, lev))
    w = torch.from_numpy(rng.integers(0, 4, n).astype(np.float32)).to(dev)
    got = tops.segment_histogram(xt, st_, w, lt, num_segments=k, spec=ts)
    assert torch.equal(got, tref.segment_histogram_ref(xt, st_, w, lt, num_segments=k, spec=ts))
    got = tops.ddsketch_histogram(xt, w, lt, spec=ts)
    assert torch.equal(got, tref.histogram_ref(xt, w, lt, spec=ts))
    keys, wts = tref.compact_triples(xt, st_, w, lt, num_segments=k, spec=ts)
    got = tops.ddsketch_scatter(keys, wts, num_rows=2 * k, num_buckets=ts.num_buckets)
    want = tref.scatter_histogram_ref(keys, wts, num_rows=2 * k, num_buckets=ts.num_buckets)
    assert torch.equal(got, want)
    for method in ("matmul", "sort"):
        got = tops.bank_histograms(xt, st_, w, lt, num_segments=k, spec=ts, method=method)
        want = tops.bank_histograms(xt, st_, w, lt, num_segments=k, spec=ts, method="fused")
        assert all(torch.equal(g, f) for g, f in zip(got, want))
    launches = tops.dispatch_stats()["launches"]
    for name in ("bank_range_merge", "ddsketch_seg_hist", "ddsketch_hist", "ddsketch_scatter"):
        assert launches[name] > 0, name


@pytest.mark.gpu
def test_cuda_in_place_ingest_and_node_merge_match_plain_versions(rng):
    """The in-place ingest into a non-empty bank against the plain delta
    plus the adds, and the node-indexed merge over float32 and int32 slabs
    against the stack-then-plain composition; one window query launches the
    merge once and allocates nothing of the (D + 1, 2K, m) block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    from repro_torch.core import sketch_bank as tsb
    from repro_torch.engine import SketchEngine, WindowRing

    dev = torch.device("cuda")
    ts = TSpec()
    k, n, m = 64, 1 << 16, ts.num_buckets
    x, s, lev = _lanes(rng, n, k)
    xt, st_, lt = (torch.from_numpy(a).to(dev) for a in (x, s, lev))
    w = torch.from_numpy(rng.integers(0, 4, n).astype(np.float32)).to(dev)
    bank0 = [torch.from_numpy(rng.integers(0, 9, (k, m)).astype(np.float32)).to(dev)
             for _ in range(2)]
    bank0 += [torch.from_numpy(rng.integers(0, 9, k).astype(np.float32)).to(dev)
              for _ in range(4)]
    bank0 += [torch.full((k,), 0.5, device=dev), torch.full((k,), 2.0, device=dev)]
    for wt in (None, w):
        got = [t.clone() for t in bank0]
        tops.fused_ingest_into(got[0], got[1], tops.IngestStats(*got[2:]), xt, st_, wt, lt,
                               spec=ts)
        hp, sp = tref.fused_ingest_ref(xt, st_, wt, lt, num_segments=k, spec=ts)
        want = [bank0[0] + hp[:k], bank0[1] + hp[k:],
                *(b + d for b, d in zip(bank0[2:5], sp[:3]))]
        assert all(torch.equal(g, v) for g, v in zip(got[:5], want))
        assert torch.equal(got[6], torch.minimum(bank0[6], sp.vmin))
        assert torch.equal(got[7], torch.maximum(bank0[7], sp.vmax))
    for dtype in (torch.float32, torch.int32):
        slab = [torch.from_numpy(rng.integers(0, 100, (7, k, m))).to(dev, dtype)
                for _ in range(2)]
        live = [torch.from_numpy(rng.integers(0, 100, (k, m))).to(dev, dtype) for _ in range(2)]
        nodes = torch.tensor([4, 2, 6, 0], device=dev)
        valid = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)
        deltas = torch.from_numpy(rng.integers(0, 7, (5, k)).astype(np.int32)).to(dev)
        for gate in (1.0, 0.0):
            g = torch.tensor(gate, device=dev)
            pos, neg = tops.bank_range_merge_nodes(*slab, nodes, valid, *live, g, deltas, spec=ts)
            block = torch.cat([torch.cat([sl.index_select(0, nodes).float(), lv.float()[None]])
                               for sl, lv in zip(slab, live)], dim=1)
            want = tref.bank_range_merge_ref(block, torch.cat([deltas, deltas], 1), spec=ts,
                                             valid=torch.cat([valid, g[None]]))
            assert torch.equal(torch.cat([pos, neg]), want)
    eng = SketchEngine(ts, k, device="cuda")
    ring = WindowRing(eng, 16)
    for _ in range(19):
        b = eng.new_bank()
        tsb.add_impl(b, xt[:4096], st_[:4096], spec=ts)
        ring.seal(b)
    live_bank = eng.new_bank()
    ring.quantiles(live_bank, [0.5], window_slices=16)  # warm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tops.reset_dispatch_stats()
    ring.quantiles(live_bank, [0.5, 0.99], window_slices=16)
    torch.cuda.synchronize()
    assert tops.dispatch_stats()["launches"]["bank_range_merge"] == 1
    block_bytes = (ring.max_range_nodes + 1) * 2 * k * m * 4
    assert torch.cuda.max_memory_allocated() - before < block_bytes / 2


@pytest.mark.gpu
def test_cuda_quantiles_and_histogram_edges_match_plain_versions(rng):
    """The bank query on rows that are not 16-byte aligned (an odd
    num_buckets, an offset view), on rows narrower and wider than the
    kernel's registers hold (m = 64, 3001, 4096), at Q = 300 and at the K = 1
    rollup shape; the single-row histogram on a misaligned view, with its
    levels offset alike and otherwise, at N not a multiple of 4 and at
    N = 5, at m = 64 and m = 1, and twice back to back on one stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    dev = torch.device("cuda")
    k = 64
    for ts in (TSpec(num_buckets=1001, offset=-500), TSpec(), TSpec(num_buckets=64, offset=-32),
               TSpec(num_buckets=3001, offset=-1500), TSpec(num_buckets=4096, offset=-2048)):
        m = ts.num_buckets
        pos = torch.from_numpy(rng.poisson(2.0, (k, m)).astype(np.float32)).to(dev)
        neg = torch.from_numpy(rng.poisson(0.3, (k, m)).astype(np.float32)).to(dev)
        flat = torch.empty(k * m + 1, device=dev)
        flat[1:].copy_(pos.reshape(-1))
        shifted = flat[1:].view(k, m)  # every row one count past a 16-byte boundary
        zero = torch.from_numpy(rng.poisson(3.0, k).astype(np.float32)).to(dev)
        vmin, vmax = torch.full((k,), -5e4, device=dev), torch.full((k,), 5e4, device=dev)
        lv = torch.from_numpy(rng.integers(0, 7, k).astype(np.int32)).to(dev)
        table = device_value_table(ts, dev)
        for qs in (torch.tensor([0.5], device=dev), torch.linspace(0.0, 1.0, 300, device=dev)):
            for args in ((pos, neg, zero, vmin, vmax, lv), (shifted, neg, zero, vmin, vmax, lv),
                         (pos.sum(0, keepdim=True), neg.sum(0, keepdim=True),
                          zero.sum().reshape(1), vmin[:1], vmax[:1], lv.max().reshape(1))):
                got = tops.bank_quantiles(*args, qs, spec=ts, table=table)
                want = tref.bank_quantiles_ref(*args, qs, table)
                assert bool(((got == want) | (got.isnan() & want.isnan())).all())
    ts = TSpec(mapping="linear")
    n = (1 << 16) + 3
    x, _, lev = _lanes(rng, n, k)
    xt, lt = torch.from_numpy(x).to(dev), torch.from_numpy(lev).to(dev)
    w = torch.from_numpy(rng.integers(0, 4, n).astype(np.float32)).to(dev)
    cases = [(xt[1:], w[1:], lt[1:]), (xt[1:], None, lt[:-1]), (xt, w, lt), (xt[7:12], None, None)]
    narrow = (TSpec(num_buckets=64, offset=-32, mapping="linear"),
              TSpec(num_buckets=1, offset=0, mapping="linear"))
    for sp in (ts, *narrow):
        for xs, ws, ls in cases:
            assert torch.equal(tops.ddsketch_histogram(xs, ws, ls, spec=sp),
                               tref.histogram_ref(xs, ws, ls, spec=sp))
    first, second = (tops.ddsketch_histogram(xt, w, lt, spec=ts) for _ in range(2))
    want = tref.histogram_ref(xt, w, lt, spec=ts)
    assert torch.equal(first, want) and torch.equal(second, want)
