"""The port's matmul and sort insert pipelines against the JAX package's,
on the CPU.

The same numpy lanes (NaN, +-inf, +-0, values below ``min_indexable``,
out-of-range ids, per-lane levels 0-6) go through the plain versions, the
four kernel front doors (JAX side in Pallas interpret mode), the
``insert_method`` rule and ``add_impl(method="matmul" | "sort")`` on a
mid-stream bank of mixed levels.  Histograms, counters, extrema and
composite keys are bit-exact for integer weights.  Tolerances, each with
its reason:

* ``summ`` within 2 n u sum|w x| per row (u = 2^-24): its lanes sum in
  another order on every tier (hazard I2);
* ``compact_triples`` with fractional weights: each run total within
  2 c u sum(w) of the reference's, c lanes in the run, because the
  unstable sort orders equal keys arbitrarily (hazard I1).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sketch_bank as jsb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ref import BucketSpec as JSpec
from repro_torch.core import sketch_bank as tsb
from repro_torch.core.torch_sketch import DeviceSketch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ref import BucketSpec as TSpec

U = 2.0**-24
K, M, N = 8, 512, 2048
MAPPINGS = ["log", "linear", "cubic"]


def _specs(mapping="linear"):
    return (JSpec(num_buckets=M, offset=-256, mapping=mapping),
            TSpec(num_buckets=M, offset=-256, mapping=mapping))


def _lanes(rng, n=N, k=K):
    x = (rng.pareto(1.0, n) + 1.0).astype(np.float32)
    x *= np.where(rng.random(n) < 0.3, -1.0, 1.0).astype(np.float32)
    x[:9] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-38, -1e-38, 1e15, -1e-12]
    s = rng.integers(-1, k + 1, n).astype(np.int32)
    lev = rng.integers(0, 7, n).astype(np.int32)
    return x, s, lev


def _weights(rng, kind, n=N):
    if kind == "none":
        return None
    w = rng.integers(0, 4, n).astype(np.float32)
    return w * np.float32(0.37) if kind == "frac" else w


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mapping", MAPPINGS)
@pytest.mark.parametrize("weights", ["none", "int"])
def test_histogram_refs_match_jax(mapping, weights, rng):
    js, ts = _specs(mapping)
    x, s, lev = _lanes(rng)
    w = _weights(rng, weights)
    np.testing.assert_array_equal(
        tref.histogram_ref(_t(x), _t(w), _t(lev), spec=ts).numpy(),
        np.asarray(jref.histogram_ref(_j(x), _j(w), _j(lev), spec=js)),
    )
    np.testing.assert_array_equal(
        tref.segment_histogram_ref(_t(x), _t(s), _t(w), _t(lev), num_segments=K,
                                   spec=ts).numpy(),
        np.asarray(jref.segment_histogram_ref(_j(x), _j(s), _j(w), _j(lev), num_segments=K,
                                              spec=js)),
    )


@pytest.mark.parametrize("mapping", MAPPINGS)
def test_composite_keys_match_jax_and_guard_int32(mapping, rng):
    js, ts = _specs(mapping)
    x, s, lev = _lanes(rng)
    for ids, levels, k in ((s, lev, K), (None, None, 1), (s, None, K)):
        got = tref.composite_keys(_t(x), _t(ids), _t(levels), num_segments=k, spec=ts)
        want = jref.composite_keys(_j(x), _j(ids), _j(levels), num_segments=k, spec=js)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    big = (2**31 - 1) // (2 * M) + 1  # 2 K m + 1 no longer fits int32
    with pytest.raises(ValueError, match="int32"):
        tref.composite_keys(_t(x), _t(s), None, num_segments=big, spec=ts)
    with pytest.raises(ValueError, match="int32"):
        jref.composite_keys(_j(x), _j(s), None, num_segments=big, spec=js)


@pytest.mark.parametrize("weights", ["none", "int", "frac"])
@pytest.mark.parametrize("payload_sort", [False, True])
def test_compact_triples_match_jax(weights, payload_sort, rng):
    js, ts = _specs()
    x, s, lev = _lanes(rng)
    w = _weights(rng, weights)
    gk, gw = tref.compact_triples(_t(x), _t(s), _t(w), _t(lev), num_segments=K, spec=ts,
                                  payload_sort=payload_sort)
    jk_, jw_ = jref.compact_triples(_j(x), _j(s), _j(w), _j(lev), num_segments=K, spec=js,
                                    payload_sort=payload_sort)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk_))
    jw_ = np.asarray(jw_)
    if weights == "frac":
        keys = tref.composite_keys(_t(x), _t(s), _t(lev), num_segments=K, spec=ts).numpy()
        per_run = np.bincount(np.searchsorted(np.asarray(jk_), keys), minlength=N)
        bound = 2 * per_run * U * np.abs(jw_)
        assert np.all(np.abs(gw.numpy() - jw_) <= bound)
    else:
        np.testing.assert_array_equal(gw.numpy(), jw_)
    u = int((gk.numpy() != np.iinfo(np.int32).max).sum())
    assert u < N and np.all(gw.numpy()[u:] == 0)  # runs packed to the front


def test_compact_triples_empty_batch():
    js, ts = _specs()
    gk, gw = tref.compact_triples(torch.zeros(0), torch.zeros(0, dtype=torch.int32),
                                  num_segments=K, spec=ts)
    jk_, jw_ = jref.compact_triples(jnp.zeros(0), jnp.zeros(0, jnp.int32), num_segments=K,
                                    spec=js)
    assert gk.shape == gw.shape == np.asarray(jk_).shape == np.asarray(jw_).shape == (0,)
    assert gk.dtype == torch.int32 and gw.dtype == torch.float32


def test_scatter_ref_matches_jax_with_duplicates_and_sentinels(rng):
    rows = 2 * K
    keys = rng.integers(-5, rows * M + 5, 3000).astype(np.int32)
    keys[:40] = 17  # duplicate keys accumulate
    keys[40:45] = np.iinfo(np.int32).max
    w = rng.integers(1, 5, 3000).astype(np.float32)
    np.testing.assert_array_equal(
        tref.scatter_histogram_ref(_t(keys), _t(w), num_rows=rows, num_buckets=M).numpy(),
        np.asarray(jref.scatter_histogram_ref(_j(keys), _j(w), num_rows=rows, num_buckets=M)),
    )


# --------------------------------------------------------------------- #
# the front doors against the JAX Pallas kernels in interpret mode
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mapping", ["linear", "cubic"])
def test_histogram_front_doors_match_pallas_interpret(mapping, rng):
    js, ts = _specs(mapping)
    x, s, lev = _lanes(rng)
    w = _weights(rng, "int")
    x = np.abs(x)
    np.testing.assert_array_equal(
        tops.segment_histogram(_t(x), _t(s), _t(w), _t(lev), num_segments=K, spec=ts).numpy(),
        np.asarray(jops.segment_histogram(_j(x), _j(s), _j(w), _j(lev), num_segments=K,
                                          spec=js, force="interpret")),
    )
    np.testing.assert_array_equal(
        tops.ddsketch_histogram(_t(x), None, _t(lev), spec=ts).numpy(),
        np.asarray(jops.ddsketch_histogram(_j(x), None, _j(lev), spec=js, force="interpret")),
    )


def _crowded_lanes(rng, case):
    """Lanes that crowd the single-row histogram's bins: every lane at
    collapse level 6 (a dozen buckets), or every lane in one bucket."""
    if case == "level6":
        x = (rng.pareto(1.0, N) + 1.0).astype(np.float32)
        return x, np.full(N, 6, np.int32)
    return np.full(N, 1.5, np.float32), np.zeros(N, np.int32)


@pytest.mark.parametrize("mapping", ["linear", "cubic"])
@pytest.mark.parametrize("case", ["level6", "one_bucket"])
@pytest.mark.parametrize("weights", ["none", "int"])
def test_single_row_histogram_crowded_lanes_match_pallas_interpret(mapping, case, weights, rng):
    js, ts = _specs(mapping)
    x, lev = _crowded_lanes(rng, case)
    w = _weights(rng, weights)
    got = tops.ddsketch_histogram(_t(x), _t(w), _t(lev), spec=ts).numpy()
    want = np.asarray(jops.ddsketch_histogram(_j(x), _j(w), _j(lev), spec=js, force="interpret"))
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) <= (1 if case == "one_bucket" else 16)


def test_scatter_front_door_matches_pallas_interpret(rng):
    js, ts = _specs()
    x, s, lev = _lanes(rng)
    keys, wts = jref.compact_triples(_j(x), _j(s), None, _j(lev), num_segments=K, spec=js)
    cap = min(N, 2 * K * M + 1)
    want = jops.ddsketch_scatter(keys[:cap], wts[:cap], num_rows=2 * K, num_buckets=M,
                                 force="interpret")
    got = tops.ddsketch_scatter(_t(np.asarray(keys)[:cap]), _t(np.asarray(wts)[:cap]),
                                num_rows=2 * K, num_buckets=M)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["matmul", "sort"])
@pytest.mark.parametrize("single", [False, True])
def test_bank_histograms_match_pallas_interpret(method, single, rng):
    js, ts = _specs()
    x, s, lev = _lanes(rng)
    w = _weights(rng, "int")
    ids, k = (None, 1) if single else (s, K)
    want = jops.bank_histograms(_j(x), _j(ids), _j(w), _j(lev), num_segments=k, spec=js,
                                method=method, force="interpret")
    got = tops.bank_histograms(_t(x), _t(ids), _t(w), _t(lev), num_segments=k, spec=ts,
                               method=method)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    fused = tops.bank_histograms(_t(x), _t(ids), _t(w), _t(lev), num_segments=k, spec=ts,
                                 method="fused")
    for g, f in zip(got, fused):
        np.testing.assert_array_equal(g.numpy(), f.numpy())
    with pytest.raises(ValueError):
        tops.bank_histograms(_t(x), None, num_segments=2, spec=ts)


def test_insert_method_makes_jax_choices(monkeypatch):
    monkeypatch.delenv("REPRO_INSERT_METHOD", raising=False)
    cases = [(n, k, m, unit, full) for n in (0, 100, (1 << 14) - 1, 1 << 14, 1 << 20)
             for k in (1, 4096) for m in (512, 2048) for unit in (True, False)
             for full in (False, True)]
    for n, k, m, unit, full in cases:
        assert tops.insert_method(n, full_ingest=full) == jops.insert_method(
            n, k, m, unit, on_tpu=False, full_ingest=full)


# --------------------------------------------------------------------- #
# add_impl over the full bank state
# --------------------------------------------------------------------- #
def _mid_stream(rng, dtype):
    pos = rng.poisson(rng.gamma(0.5, 2.0, (K, 1)), (K, M)).astype(dtype)
    neg = rng.poisson(0.1, (K, M)).astype(dtype)
    zero = rng.poisson(2.0, K).astype(dtype)
    over = rng.integers(0, 2, K).astype(dtype)
    under = np.zeros(K, dtype)
    summ = rng.normal(0, 100, K).astype(np.float32)
    vmin = np.where(neg.any(1), -50.0, 0.5).astype(np.float32)
    vmax = np.full(K, 500.0, np.float32)
    level = rng.integers(0, 7, K).astype(np.int32)
    return [pos, neg, zero, over, under, summ, vmin, vmax, level]


@pytest.mark.parametrize("method", ["matmul", "sort"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("auto_collapse", [False, True])
def test_add_impl_matches_jax_on_the_full_bank(method, dtype, auto_collapse, rng):
    js, ts = _specs()
    leaves = _mid_stream(rng, dtype)
    leaves[-1][:2] = 0  # level-0 rows, where the 1e15 lanes clamp
    jb = jsb.SketchBank(*(jnp.asarray(a) for a in leaves))
    tb = tsb.from_numpy(leaves, device="cpu")
    x, s, _ = _lanes(rng)
    w = _weights(rng, "int")
    for weights in (None, w):
        jb = jsb.add(jb, _j(x), _j(s), _j(weights), spec=js, method=method,
                     auto_collapse=auto_collapse)
        out = tsb.add_impl(tb, _t(x), _t(s), _t(weights), spec=ts, method=method,
                           auto_collapse=auto_collapse)
        assert out is tb
    valid = np.isfinite(x) & (s >= 0) & (s < K)
    absum = np.bincount(s[valid], (np.abs(x) * (1 + w))[valid].astype(np.float64), minlength=K)
    nrow = np.bincount(s[valid], minlength=K)
    for name, g, j in zip(tsb.SketchBank._fields, tsb.to_numpy(tb), jb):
        j = np.asarray(j)
        if name == "summ":
            assert np.all(np.abs(g - j) <= 2 * (nrow + 1) * U * (absum + np.abs(leaves[5]))), name
        elif name in ("vmin", "vmax"):
            assert np.all(g == j), name  # numerically: -0.0 == +0.0
        else:
            np.testing.assert_array_equal(g, j, err_msg=name)


def test_row_and_set_row(rng):
    js, ts = _specs()
    leaves = _mid_stream(rng, np.float32)
    jb = jsb.SketchBank(*(jnp.asarray(a) for a in leaves))
    tb = tsb.from_numpy(leaves, device="cpu")
    r = tsb.row(tb, 3)
    assert isinstance(r, DeviceSketch)
    for g, j in zip(r, jsb.row(jb, 3)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    tsb.add_impl(tb, torch.ones(4), torch.full((4,), 3, dtype=torch.int32), spec=ts)
    assert float(r.zero) == leaves[2][3]  # a copy: the next tick leaves it alone
    jb = jsb.set_row(jb, 5, jsb.row(jb, 3))
    assert tsb.set_row(tb, 5, r) is tb
    for name, g, j in zip(tsb.SketchBank._fields, tsb.to_numpy(tb), jb):
        # every row but row 3, which took the tick, and row 5 is row 3's copy
        np.testing.assert_array_equal(np.delete(g, 3, 0), np.delete(np.asarray(j), 3, 0),
                                      err_msg=name)
