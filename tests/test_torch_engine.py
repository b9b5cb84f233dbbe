"""The port's SketchEngine against the JAX package's, on the CPU.

Same numpy batches into both engines: the reactive ingest's
``(fired, clamped)`` outputs, every bank leaf, the per-row and rollup
quantiles, reset, snapshot and the call-path counters must agree, with
``summ`` held to 2 n u sum|w x| (u = 2^-24) over the lanes it has summed.
The port updates its bank in place, so the tensors a bank starts with are
the tensors it keeps (the counterpart of the JAX engine's donation).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sketch_bank as jsb
from repro.engine import SketchEngine as JEngine
from repro.kernels.ref import BucketSpec as JSpec
from repro_torch.core import sketch_bank as tsb
from repro_torch.engine import SketchEngine as TEngine
from repro_torch.engine import make_engine
from repro_torch.kernels.ref import BucketSpec as TSpec

U = 2.0**-24
K, M = 16, 512
QS = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0]


def _engines(dtype=np.float32, mapping="linear"):
    js = JSpec(num_buckets=M, offset=-256, mapping=mapping)
    ts = TSpec(num_buckets=M, offset=-256, mapping=mapping)
    return JEngine(js, K, counts_dtype=dtype), TEngine(ts, K, counts_dtype=dtype, device="cpu")


def _tick(rng, n, outliers=False):
    x = (rng.pareto(1.0, n) + 1.0).astype(np.float32)
    x *= np.where(rng.random(n) < 0.1, -1.0, 1.0).astype(np.float32)
    if outliers:
        x[:3] = [1e14, 5e-13, -2e15]
    s = np.sort(rng.integers(-1, K, n)).astype(np.int32)
    return x, s


def _same(tb, jb, summ_bound=None):
    for name, g, j in zip(tsb.SketchBank._fields, tsb.to_numpy(tb), jb):
        j = np.asarray(j)
        if name == "summ":
            assert np.all(np.abs(g - j) <= summ_bound), name
        else:
            np.testing.assert_array_equal(g, j, err_msg=name)


class _SummBound:
    """Running 2 n u sum|w x| bound per row for the summ leaf."""

    def __init__(self):
        self.absum = np.zeros(K)
        self.n = np.zeros(K)

    def add(self, x, s, w=None):
        valid = np.isfinite(x) & (s >= 0) & (s < K)
        wv = np.ones_like(x) if w is None else w
        self.absum += np.bincount(s[valid], np.abs(wv * x)[valid].astype(np.float64), minlength=K)
        self.n += np.bincount(s[valid], minlength=K)
        return 2 * (self.n + 1) * U * self.absum


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_reactive_ingest_matches_jax(dtype, rng):
    je, te = _engines(dtype)
    jb, tb = je.new_bank(), te.new_bank()
    bound = _SummBound()
    fired_any = False
    for t, n in enumerate((1000, 37, 2048, 513)):
        x, s = _tick(rng, n, outliers=t in (0, 2))
        w = rng.integers(1, 3, n).astype(np.float32) if t == 3 else None
        b = bound.add(x, s, w)
        jb, jf, jc = je.ingest(jb, x, s, w, threshold=0.0)
        out, tf, tc = te.ingest(tb, x, s, w, threshold=0.0)
        assert out is tb
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        fired_any |= bool(tf.any())
        _same(tb, jb, b)
    assert fired_any
    np.testing.assert_array_equal(
        te.quantiles(tb, QS).numpy(), np.asarray(je.quantiles(jb, QS))
    )
    np.testing.assert_array_equal(
        te.rollup_quantiles(tb, QS).numpy(), np.asarray(je.rollup_quantiles(jb, QS))
    )
    np.testing.assert_array_equal(te.quantile(tb, 0.5).numpy(), np.asarray(je.quantile(jb, 0.5)))


def test_ingest_without_threshold_and_auto_collapse(rng):
    je, te = _engines()
    jb, tb = je.new_bank(), te.new_bank()
    bound = _SummBound()
    x, s = _tick(rng, 700, outliers=True)
    b = bound.add(x, s)
    jb = je.add(jb, x, s, auto_collapse=True)
    assert te.add(tb, x, s, auto_collapse=True) is tb
    _same(tb, jb, b)
    assert int(tb.level.max()) > 0
    _, f, c = te.ingest(tb, x[:10], s[:10])
    assert f is None and c is None


@pytest.mark.parametrize("mapping", ["log", "cubic"])
def test_rollup_over_mixed_levels_matches_jax(mapping, rng):
    je, te = _engines(mapping=mapping)
    jb, tb = je.new_bank(), te.new_bank()
    target = rng.integers(0, 7, K).astype(np.int32)
    jb, tb = je.collapse_to(jb, target), te.collapse_to(tb, target)
    x, s = _tick(rng, 3000)
    jb, _, _ = je.ingest(jb, x, s, threshold=0.0)
    te.ingest(tb, x, s, threshold=0.0)
    np.testing.assert_array_equal(tb.level.numpy(), np.asarray(jb.level))
    levels_before = tb.level.clone()
    np.testing.assert_array_equal(
        te.rollup_quantiles(tb, QS).numpy(), np.asarray(je.rollup_quantiles(jb, QS))
    )
    assert torch.equal(tb.level, levels_before)  # the rollup leaves the bank alone
    np.testing.assert_array_equal(te.quantiles(tb, QS).numpy(), np.asarray(je.quantiles(jb, QS)))


def test_reset_keeps_or_replaces_levels(rng):
    je, te = _engines()
    jb, tb = je.new_bank(), te.new_bank()
    x, s = _tick(rng, 500, outliers=True)
    jb, _, _ = je.ingest(jb, x, s, threshold=0.0)
    te.ingest(tb, x, s, threshold=0.0)
    jb, tb = je.reset(jb), te.reset(tb)
    _same(tb, jb, 0.0)
    assert int(tb.level.max()) > 0  # levels survive a reset
    lv = rng.integers(0, 3, K).astype(np.int32)
    jb, tb = je.reset(jb, lv), te.reset(tb, lv)
    _same(tb, jb, 0.0)


def test_snapshot_is_a_copy(rng):
    _, te = _engines()
    tb = te.new_bank()
    x, s = _tick(rng, 400)
    te.ingest(tb, x, s, threshold=0.0)
    snap = te.snapshot(tb)
    before = tsb.to_numpy(snap)
    te.ingest(tb, *_tick(rng, 400), threshold=0.0)
    te.reset(tb)
    for g, w in zip(tsb.to_numpy(snap), before):
        np.testing.assert_array_equal(g, w)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(snap, tb))


def test_bank_tensors_are_reused_in_place(rng):
    """Mirror of the JAX engine's donation check: every state-changing path
    writes into the tensors the bank started with."""
    _, te = _engines()
    tb = te.new_bank()
    ptrs = [t.data_ptr() for t in tb]
    for _ in range(3):
        tb, _, _ = te.ingest(tb, *_tick(rng, 300, outliers=True), threshold=0.0)
    tb = te.collapse_to(tb, 3)
    tb = te.auto_collapse(tb, threshold=0.0)
    tb = te.merge(tb, te.new_bank())
    tb = te.reset(tb)
    assert [t.data_ptr() for t in tb] == ptrs


def test_merge_and_collapse_to_match_jax(rng):
    je, te = _engines(np.int32)
    ja, ta = je.new_bank(), te.new_bank()
    jb, tb = je.new_bank(), te.new_bank()
    xa, sa = _tick(rng, 800, outliers=True)
    xb, sb = _tick(rng, 600)
    ja, _, _ = je.ingest(ja, xa, sa, threshold=0.0)
    te.ingest(ta, xa, sa, threshold=0.0)
    jb = je.collapse_to(je.add(jb, xb, sb), 2)
    te.collapse_to(te.add(tb, xb, sb), 2)
    bound = _SummBound()
    bound.add(xa, sa)
    b = bound.add(xb, sb)
    jm = je.merge(ja, jb)  # donates ja
    _same(te.merge(ta, tb), jm, b)
    _same(te.auto_collapse(ta, 0.0), je.auto_collapse(jm, 0.0), b)


def test_call_path_counters_and_tick_hooks_match_jax(rng):
    je, te = _engines()
    seen = []
    te.tick_hooks.append(seen.append)
    jb, tb = je.new_bank(), te.new_bank()
    for n in (100, 100, 3000, 33):
        x, s = _tick(rng, n)
        jb, _, _ = je.ingest(jb, x, s, threshold=0.0)
        te.ingest(tb, x, s, threshold=0.0)
    for eng, b in ((je, jb), (te, tb)):
        eng.quantiles(b, QS)
        eng.quantiles(b, QS)
        eng.snapshot(b)
    je.reset(jb)
    te.reset(tb)
    assert te.cache_info() == je.cache_info()
    assert seen == ["ingest"] * 4


def test_unported_options_raise_and_default_device_is_the_card(monkeypatch):
    ts = TSpec(num_buckets=M, offset=-256)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_engine(ts, 8, num_shards=2, device="cpu")
    for method in ("matmul", "sort"):  # ported: the pinned insert pipelines
        assert TEngine(ts, 8, method=method, device="cpu").method == method
    with pytest.raises(ValueError, match="method"):
        TEngine(ts, 8, method="scan", device="cpu")
    assert make_engine(ts, 8, num_shards=1, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(ts, 8)
    want = jsb.empty(JSpec(num_buckets=M, offset=-256), 2, counts_dtype=jnp.int32)
    for g, w in zip(tsb.to_numpy(tsb.empty(ts, 2, torch.int32, device="cpu")), want):
        np.testing.assert_array_equal(g, np.asarray(w))
