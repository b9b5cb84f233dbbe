"""The port's SketchBank against the JAX package's, on the CPU.

Both packages start from the same mid-stream bank (mixed collapse levels
0-6, carried across with ``from_numpy``), take the same numpy batches and
must agree leaf for leaf: bit-exact for integer weights and counts, with
``summ`` within 2 n u sum|w x| per row (its accumulation order differs on
every tier; u = 2^-24).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sketch_bank as jsb
from repro.kernels.ref import BucketSpec as JSpec
from repro_torch.core import sketch_bank as tsb
from repro_torch.kernels.ref import BucketSpec as TSpec

U = 2.0**-24
K, M = 12, 512
DTYPES = [np.float32, np.int32]


def _specs(mapping="linear"):
    return (
        JSpec(num_buckets=M, offset=-256, mapping=mapping),
        TSpec(num_buckets=M, offset=-256, mapping=mapping),
    )


def _mid_stream(rng, dtype):
    """Nine leaves of a bank that has been ingesting for a while."""
    pos = rng.poisson(rng.gamma(0.5, 2.0, (K, 1)), (K, M)).astype(dtype)
    neg = rng.poisson(0.1, (K, M)).astype(dtype)
    zero = rng.poisson(2.0, K).astype(dtype)
    over = rng.integers(0, 2, K).astype(dtype)
    under = np.zeros(K, dtype)
    summ = rng.normal(0, 100, K).astype(np.float32)
    vmin = np.where(neg.any(1), -50.0, 0.5).astype(np.float32)
    vmax = np.full(K, 500.0, np.float32)
    level = rng.integers(0, 7, K).astype(np.int32)
    level[0] = 0
    return [pos, neg, zero, over, under, summ, vmin, vmax, level]


def _pair(leaves):
    jb = jsb.SketchBank(*(jnp.asarray(x) for x in leaves))
    tb = tsb.from_numpy(leaves, device="cpu")
    return jb, tb


def _batch(rng, n, weighted):
    x = (rng.pareto(1.0, n) + 1.0).astype(np.float32)
    x *= np.where(rng.random(n) < 0.2, -1.0, 1.0).astype(np.float32)
    x[:5] = [np.nan, 0.0, -0.0, 1e15, 1e-12]  # 1e15 / 1e-12 clamp at level 0
    s = np.sort(rng.integers(-1, K + 1, n)).astype(np.int32)
    w = rng.integers(1, 4, n).astype(np.float32) if weighted else None
    return x, s, w


def _assert_same(tb, jb, summ_bound=None):
    got = tsb.to_numpy(tb)
    for name, g, j in zip(tsb.SketchBank._fields, got, jb):
        j = np.asarray(j)
        assert g.dtype == j.dtype, name
        if name == "summ" and summ_bound is not None:
            assert np.all(np.abs(g - j) <= summ_bound), name
        else:
            np.testing.assert_array_equal(g, j, err_msg=name)


def _summ_bound(tb_before, x, s, w):
    valid = np.isfinite(x) & (s >= 0) & (s < K)
    wv = np.ones_like(x) if w is None else w
    absum = np.bincount(s[valid], np.abs(wv * x)[valid].astype(np.float64), minlength=K)
    nrow = np.bincount(s[valid], minlength=K) + 1
    return 2 * nrow * U * (absum + np.abs(tsb.to_numpy(tb_before).summ))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("auto_collapse", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_add_impl_matches_jax(dtype, auto_collapse, weighted, rng):
    js, ts = _specs()
    leaves = _mid_stream(rng, dtype)
    jb, tb = _pair(leaves)
    x, s, w = _batch(rng, 3000, weighted)
    bound = _summ_bound(tb, x, s, w)
    jb = jsb.add(jb, jnp.asarray(x), jnp.asarray(s), None if w is None else jnp.asarray(w),
                 spec=js, method="fused", auto_collapse=auto_collapse)
    out = tsb.add_impl(tb, torch.from_numpy(x), torch.from_numpy(s),
                       None if w is None else torch.from_numpy(w), spec=ts,
                       auto_collapse=auto_collapse)
    assert out is tb  # updated in place
    _assert_same(tb, jb, bound)
    if auto_collapse:
        assert (np.asarray(jb.level) > leaves[-1]).any()


def _spy_ingest(monkeypatch):
    """Count calls of the fused ingest's delta and in-place front doors."""
    from repro_torch.kernels import ops as tops

    calls = {"fused_ingest": 0, "fused_ingest_into": 0}
    for name in calls:
        real = getattr(tops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tops, name, spy)
    return calls


@pytest.mark.parametrize("auto_collapse", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_add_impl_float32_bank_ingests_in_place(auto_collapse, weighted, rng, monkeypatch):
    """A float32 bank that has been ingesting takes the in-place front door
    (no delta histogram) and still equals the JAX package's bank."""
    js, ts = _specs()
    leaves = _mid_stream(rng, np.float32)
    jb, tb = _pair(leaves)
    x, s, w = _batch(rng, 3000, weighted)
    bound = _summ_bound(tb, x, s, w)
    calls = _spy_ingest(monkeypatch)
    jb = jsb.add(jb, jnp.asarray(x), jnp.asarray(s), None if w is None else jnp.asarray(w),
                 spec=js, method="fused", auto_collapse=auto_collapse)
    tsb.add_impl(tb, torch.from_numpy(x), torch.from_numpy(s),
                 None if w is None else torch.from_numpy(w), spec=ts,
                 auto_collapse=auto_collapse)
    assert calls == {"fused_ingest": 0, "fused_ingest_into": 1}
    _assert_same(tb, jb, bound)


def test_add_impl_int32_bank_keeps_the_delta_path(rng, monkeypatch):
    """An int32 bank adds the fused ingest's float delta cast to int32, as
    the reference does, so it stays on the delta front door."""
    js, ts = _specs()
    jb, tb = _pair(_mid_stream(rng, np.int32))
    x, s, w = _batch(rng, 3000, True)
    bound = _summ_bound(tb, x, s, w)
    calls = _spy_ingest(monkeypatch)
    jb = jsb.add(jb, jnp.asarray(x), jnp.asarray(s), jnp.asarray(w), spec=js, method="fused")
    tsb.add_impl(tb, torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(w), spec=ts)
    assert calls == {"fused_ingest": 1, "fused_ingest_into": 0}
    assert tb.pos.dtype == torch.int32
    _assert_same(tb, jb, bound)


@pytest.mark.parametrize("mapping", ["log", "cubic"])
def test_add_impl_other_mappings(mapping, rng):
    js, ts = _specs(mapping)
    jb, tb = _pair(_mid_stream(rng, np.float32))
    x, s, _ = _batch(rng, 3000, False)
    bound = _summ_bound(tb, x, s, None)
    jb = jsb.add(jb, jnp.asarray(x), jnp.asarray(s), spec=js, method="fused")
    tsb.add_impl(tb, torch.from_numpy(x), torch.from_numpy(s), spec=ts)
    _assert_same(tb, jb, bound)


@pytest.mark.parametrize("dtype", DTYPES)
def test_collapse_paths_match_jax(dtype, rng):
    js, ts = _specs()
    leaves = _mid_stream(rng, dtype)
    rows = rng.random(K) < 0.5
    jb, tb = _pair(leaves)
    _assert_same(tsb.collapse(tb, torch.from_numpy(rows), spec=ts),
                 jsb.collapse(jb, jnp.asarray(rows), spec=js))
    target = rng.integers(0, 7, K).astype(np.int32)
    jb, tb = _pair(leaves)
    _assert_same(tsb.collapse_to(tb, torch.from_numpy(target), spec=ts),
                 jsb.collapse_to(jb, jnp.asarray(target), spec=js))
    jb, tb = _pair(leaves)
    _assert_same(tsb.collapse_to(tb, 6, spec=ts), jsb.collapse_to(jb, 6, spec=js))
    jb, tb = _pair(leaves)
    _assert_same(tsb.auto_collapse(tb, spec=ts, threshold=0.5),
                 jsb.auto_collapse(jb, spec=js, threshold=0.5))


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_mixed_levels_matches_jax(dtype, rng):
    js, ts = _specs()
    a, b = _mid_stream(rng, dtype), _mid_stream(rng, dtype)
    ja, ta = _pair(a)
    jb, tb = _pair(b)
    want = jsb.merge(ja, jb, spec=js)
    b_before = tsb.to_numpy(tb)
    got = tsb.merge(ta, tb, spec=ts)
    assert got is ta
    _assert_same(ta, want)
    for g, w in zip(tsb.to_numpy(tb), b_before):  # the right operand is untouched
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantiles_impl_matches_jax(dtype, rng):
    js, ts = _specs()
    leaves = _mid_stream(rng, dtype)
    leaves[0][1] = leaves[1][1] = leaves[2][1] = 0  # an empty row
    jb, tb = _pair(leaves)
    qs = [0.0, 0.01, 0.5, 0.9, 0.99, 1.0]
    want = np.asarray(jsb.quantiles(jb, jnp.asarray(qs, jnp.float32), spec=js))
    got = tsb.quantiles_impl(tb, qs, spec=ts).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[1]).all()


def test_to_host_and_from_host_match_jax(rng):
    js, ts = _specs()
    leaves = _mid_stream(rng, np.float32)
    jb, tb = _pair(leaves)
    hosts = []
    for r in range(K):
        jh, th = jsb.to_host(jb, js, r), tsb.to_host(tb, ts, r)
        assert list(th.store.items_ascending()) == list(jh.store.items_ascending())
        assert list(th.negative_store.items_ascending()) == list(
            jh.negative_store.items_ascending()
        )
        assert (th.zero_count, th.min, th.max, th.sum, th.collapse_level) == (
            jh.zero_count, jh.min, jh.max, jh.sum, jh.collapse_level
        )
        assert th.quantiles([0.1, 0.5, 0.99]) == jh.quantiles([0.1, 0.5, 0.99])
        hosts.append(th)
    for dtype in (np.float32, np.int32):
        want = jsb.from_host(hosts, js, counts_dtype=dtype)
        got = tsb.from_host(hosts, ts, counts_dtype=dtype, device="cpu")
        _assert_same(got, want)


def test_from_numpy_round_trip_and_refusals(rng):
    leaves = _mid_stream(rng, np.int32)
    tb = tsb.from_numpy(leaves, device="cpu")
    assert tb.pos.dtype == torch.int32 and tb.level.dtype == torch.int32
    for g, w in zip(tsb.to_numpy(tb), leaves):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tsb.from_numpy(leaves[:8], device="cpu")
    with pytest.raises(ValueError):
        tsb.from_numpy([leaves[0].astype(np.int64)] + leaves[1:], device="cpu")
    with pytest.raises(ValueError):
        tsb.empty(TSpec(), 4, counts_dtype=torch.int64, device="cpu")


def test_unported_insert_pipelines_raise():
    """The matmul and sort pipelines are ported: each gives the fused
    pipeline's bank on the same lanes; an unknown method still raises."""
    ts = TSpec(num_buckets=M, offset=-256)
    x = torch.tensor([1.0, -2.0, 0.0, float("nan"), 1e15])
    s = torch.tensor([0, 1, 1, 0, 0], dtype=torch.int32)
    want = tsb.add_impl(tsb.empty(ts, 2, device="cpu"), x, s, spec=ts, method="fused")
    for method in ("matmul", "sort"):
        got = tsb.add_impl(tsb.empty(ts, 2, device="cpu"), x, s, spec=ts, method=method)
        for g, w in zip(tsb.to_numpy(got), tsb.to_numpy(want)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="method"):
        tsb.add_impl(tsb.empty(ts, 2, device="cpu"), x, s, spec=ts, method="scan")
