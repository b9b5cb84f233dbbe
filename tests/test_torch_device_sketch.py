"""The port's single ``DeviceSketch`` against ``repro.core.jax_sketch``, on
the CPU.

The same numpy batches go into both packages' sketches through ``add``
(both insert pipelines, with and without ``auto_collapse``), then
``collapse_to``, ``auto_collapse``, ``merge``, the quantiles and the host
round trip.  Every leaf is bit-exact for integer weights except ``summ``,
which is held to 2 n u sum|w x| (u = 2^-24: the two packages sum the lanes
in another order).  The port's sketch updates in place, so the tensors it
starts with are the tensors it keeps.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import jax_sketch as jsk
from repro.core.oracle import exact_quantile, relative_error
from repro.kernels.ref import BucketSpec as JSpec
from repro_torch.core import sketch_bank as tsb
from repro_torch.core import torch_sketch as tsk
from repro_torch.kernels.ref import BucketSpec as TSpec

U = 2.0**-24
QS = (0.0, 0.01, 0.25, 0.5, 0.75, 0.95, 0.99, 1.0)


def _specs(mapping="linear", **geom):
    geom = geom or dict(num_buckets=512, offset=-256)
    return JSpec(mapping=mapping, **geom), TSpec(mapping=mapping, **geom)


def _batch(rng, n, outliers=False):
    x = (rng.pareto(1.0, n) + 1.0).astype(np.float32)
    x *= np.where(rng.random(n) < 0.2, -1.0, 1.0).astype(np.float32)
    x[:4] = [np.nan, 0.0, -0.0, np.inf]
    if outliers:
        x[4:6] = [1e15, -2e-12]  # clamp at level 0
    return x


def _same(ts_, js_, summ_bound):
    for name, g, j in zip(tsk.DeviceSketch._fields, ts_, js_):
        g, j = g.numpy(), np.asarray(j)
        if name == "summ":
            assert abs(float(g) - float(j)) <= summ_bound, name
        else:
            np.testing.assert_array_equal(g, j, err_msg=name)


def _summ_bound(*batches):
    total = sum(float(np.abs(np.where(np.isfinite(x), x, 0) * w).sum()) for x, w in batches)
    n = sum(x.size for x, _ in batches)
    return 2 * n * U * total


@pytest.mark.parametrize("method", ["matmul", "sort"])
@pytest.mark.parametrize("auto_collapse", [False, True])
@pytest.mark.parametrize("mapping", ["linear", "cubic"])
def test_add_matches_jax(method, auto_collapse, mapping, rng):
    js, ts = _specs(mapping)
    jsk_, tsk_ = jsk.empty(js), tsk.empty(ts, device="cpu")
    ptrs = [t.data_ptr() for t in tsk_]
    seen = []
    for i, n in enumerate((700, 33, 1500)):
        x = _batch(rng, n, outliers=i != 1)
        w = rng.integers(1, 4, n).astype(np.float32) if i == 2 else None
        seen.append((x, np.ones(n, np.float32) if w is None else w))
        jsk_ = jsk.add(jsk_, jnp.asarray(x), None if w is None else jnp.asarray(w), spec=js,
                       method=method, auto_collapse=auto_collapse)
        out = tsk.add(tsk_, torch.from_numpy(x), None if w is None else torch.from_numpy(w),
                      spec=ts, method=method, auto_collapse=auto_collapse)
        assert out is tsk_
        _same(tsk_, jsk_, _summ_bound(*seen))
    assert [t.data_ptr() for t in tsk_] == ptrs  # in place
    assert (int(tsk_.level) > 0) == auto_collapse
    assert (float(tsk_.overflow) > 0) != auto_collapse
    np.testing.assert_array_equal(
        tsk.quantiles(tsk_, QS, spec=ts).numpy(),
        np.asarray(jsk.quantiles(jsk_, jnp.asarray(QS, jnp.float32), spec=js)),
    )
    assert float(tsk.quantile(tsk_, 0.5, spec=ts)) == float(jsk.quantile(jsk_, 0.5, spec=js))


def test_method_none_takes_the_jax_pipelines(monkeypatch, rng):
    """The auto rule picks matmul below 2^14 values and sort above, as the
    JAX package's off-TPU rule does: two histogram launches or one scatter."""
    from repro_torch.kernels import ops as tops

    js, ts = _specs()
    picked = []
    real = tops.bank_histograms
    monkeypatch.setattr(tops, "bank_histograms", lambda *a, **kw: picked.append(
        tops.insert_method(a[0].numel())) or real(*a, **kw))
    for n in (4096, 1 << 14):
        x = _batch(rng, n)
        tsk_ = tsk.add(tsk.empty(ts, device="cpu"), torch.from_numpy(x), spec=ts)
        jsk_ = jsk.add(jsk.empty(js), jnp.asarray(x), spec=js)
        _same(tsk_, jsk_, _summ_bound((x, np.ones(n, np.float32))))
    assert picked == ["matmul", "sort"]


def test_collapse_auto_collapse_and_merge_match_jax(rng):
    js, ts = _specs()
    x, y = _batch(rng, 900, outliers=True), _batch(rng, 600)
    ones_x, ones_y = np.ones(x.size, np.float32), np.ones(y.size, np.float32)
    ja = jsk.add(jsk.empty(js), jnp.asarray(x), spec=js)
    jb = jsk.collapse_to(jsk.add(jsk.empty(js), jnp.asarray(y), spec=js), 2, spec=js)
    ta = tsk.add(tsk.empty(ts, device="cpu"), torch.from_numpy(x), spec=ts)
    tb = tsk.collapse_to(tsk.add(tsk.empty(ts, device="cpu"), torch.from_numpy(y), spec=ts), 2,
                         spec=ts)
    _same(tb, jb, _summ_bound((y, ones_y)))
    b_before = [t.clone() for t in tb]
    jm = jsk.merge(ja, jb, spec=js)
    assert tsk.merge(ta, tb, spec=ts) is ta
    bound = _summ_bound((x, ones_x), (y, ones_y))
    _same(ta, jm, bound)
    _same(tb, b_before, 0.0)  # the right operand is aligned on a copy
    for _ in range(2):  # fires (clamped mass), then the counters are reset
        jm = jsk.auto_collapse(jm, spec=js)
        tsk.auto_collapse(ta, spec=ts)
        _same(ta, jm, bound)
    assert int(ta.level) == 3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsk.allreduce(ta, "keys", spec=ts)


def test_host_round_trip_and_bucket_values_match_jax(rng):
    js, ts = _specs()
    x = _batch(rng, 800)
    jsk_ = jsk.collapse_to(jsk.add(jsk.empty(js), jnp.asarray(x), spec=js), 1, spec=js)
    tsk_ = tsk.collapse_to(tsk.add(tsk.empty(ts, device="cpu"), torch.from_numpy(x), spec=ts),
                           1, spec=ts)
    jh, th = jsk.to_host(jsk_, js), tsk.to_host(tsk_, ts)
    assert list(th.store.items_ascending()) == list(jh.store.items_ascending())
    assert list(th.negative_store.items_ascending()) == list(jh.negative_store.items_ascending())
    assert (th.zero_count, th.min, th.max, th.collapse_level) == (
        jh.zero_count, jh.min, jh.max, jh.collapse_level)
    for dtype in (np.float32, np.int32):
        back_t = tsk.from_host(th, ts, counts_dtype=dtype, device="cpu")
        back_j = jsk.from_host(jh, js, counts_dtype=dtype)
        _same(back_t, back_j, 0.0)
    np.testing.assert_array_equal(tsk.bucket_values(ts), jsk.bucket_values(js))
    # leaves carry across both ways: a single sketch from nine (m,)/() leaves
    leaves = [np.asarray(v) for v in jsk_]
    back = tsb.from_numpy(leaves, device="cpu")
    assert isinstance(back, tsk.DeviceSketch)
    for g, w in zip(tsb.to_numpy(back), leaves):
        np.testing.assert_array_equal(g, w)
    th.collapse_level = 7  # beyond MAX_COLLAPSE_LEVEL: its keys cannot be held
    with pytest.raises(ValueError, match="MAX_COLLAPSE_LEVEL"):
        tsk.from_host(th, ts, device="cpu")


def test_empty_sketch_answers_nan():
    js, ts = _specs()
    got = tsk.quantiles(tsk.empty(ts, device="cpu"), QS, spec=ts).numpy()
    assert np.isnan(got).all()
    assert np.isnan(np.asarray(jsk.quantiles(jsk.empty(js), jnp.asarray(QS), spec=js))).all()
    ts0 = tsk.empty(ts, device="cpu")
    tsk.add(ts0, torch.zeros(0), spec=ts)
    assert math.isinf(float(ts0.vmin)) and float(ts0.count) == 0


def test_alpha_guarantee(rng):
    """The check of ``test_jax_sketch.py``: the paper's geometry, 5000
    Pareto values, every q within alpha (plus float32 slack)."""
    _, ts = _specs(mapping="log", num_buckets=2048, offset=-1024)
    data = (rng.pareto(1.0, 5000) + 1.0).astype(np.float32)
    for method in ("matmul", "sort"):
        sk = tsk.add(tsk.empty(ts, device="cpu"), torch.from_numpy(data), spec=ts, method=method)
        s = np.sort(data)
        for q in QS[1:]:
            est = float(tsk.quantile(sk, q, spec=ts))
            assert relative_error(est, exact_quantile(s, q)) <= 0.0101
