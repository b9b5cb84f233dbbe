"""The port's keyed windows against ``repro.telemetry.keyed``, on the CPU.

The same scripted stream of ``record`` / ``record_batches`` calls, resets
and aggregator flushes goes into both packages; the key -> row map, the
overflow key, eviction, the ``CollapseEvent`` log, the version stamps, the
bank leaves and every quantile answer must agree (``summ`` to its
accumulation-order bound; the rest bit-exact under ``linear``).
"""

import numpy as np
import pytest

from repro.kernels.ref import BucketSpec as JSpec
from repro.telemetry import keyed as jk
from repro_torch.kernels.ref import BucketSpec as TSpec
from repro_torch.telemetry import keyed as tk

QS = [0.1, 0.5, 0.9, 0.99]
KEYS = [f"/v1/ep{i}" for i in range(9)]


def _windows(capacity=6, **kw):
    js = JSpec(num_buckets=512, offset=-256, mapping="linear")
    ts = TSpec(num_buckets=512, offset=-256, mapping="linear")
    return jk.KeyedWindow(js, capacity, **kw), tk.KeyedWindow(ts, capacity, device="cpu", **kw)


def _stream(rng, windows, steps=6):
    """Feed both windows the same calls; key 3 sends clamping outliers."""
    for t in range(steps):
        n = int(rng.integers(50, 300))
        keys = [KEYS[i] for i in rng.integers(0, len(KEYS), n)]
        vals = (rng.pareto(1.0, n) + 1.0).astype(np.float32)
        vals[rng.random(n) < 0.05] *= -1.0
        batches = [
            (KEYS[3], np.array([1e12, 2e-12, 5.0], np.float32), None),
            (KEYS[int(rng.integers(0, 9))], (rng.pareto(1.0, 40) + 1).astype(np.float32),
             rng.integers(1, 3, 40).astype(np.float32) if t % 2 else None),
            (KEYS[0], np.zeros(0, np.float32), None),
        ]
        for w in windows:
            if t % 2 == 0:
                w.record(keys, vals)
                w.record(KEYS[5], vals[:10])
            assert w.record_batches(batches) == 43


def _assert_windows_equal(jw, tw):
    assert tw.key_to_row == jw.key_to_row
    assert tw.version == jw.version
    assert tw.keys() == jw.keys()
    assert tw.levels() == jw.levels()
    assert tw.alphas() == jw.alphas()
    jb = jw.engine.host_bank(jw.bank)
    tb = tw.engine.host_bank(tw.bank)
    for name, g, j in zip(tb._fields, tb, jb):
        if name == "summ":
            np.testing.assert_allclose(g, j, rtol=1e-5, atol=1e-3)
        else:
            np.testing.assert_array_equal(g, np.asarray(j), err_msg=name)
    got, want = tw.all_quantiles(QS), jw.all_quantiles(QS)  # NaN for empty rows
    assert list(got) == list(want)
    np.testing.assert_array_equal(list(got.values()), list(want.values()))
    np.testing.assert_array_equal(tw.rollup_quantiles(QS), jw.rollup_quantiles(QS))
    assert tw.total_mass() == jw.total_mass()
    for key in tw.keys():
        np.testing.assert_array_equal(tw.quantiles(key, QS), jw.quantiles(key, QS))


def test_record_paths_overflow_key_and_events_match_jax(rng):
    jw, tw = _windows(capacity=6)
    _stream(rng, (jw, tw))
    assert tk.OVERFLOW_KEY == jk.OVERFLOW_KEY
    assert len(tw.key_to_row) == 7  # six keys plus the overflow sink
    assert float(tw.engine.host_bank(tw.bank).counts[0]) > 0  # surplus keys landed in row 0
    _assert_windows_equal(jw, tw)
    tev, jev = list(tw.events), list(jw.events)
    assert [tuple(e) for e in tev] == [tuple(e) for e in jev]
    assert tev  # the outliers clamped and fired reactive collapses
    with pytest.raises(KeyError):
        tw.quantiles("/never/seen", QS)


def test_eviction_and_reset_match_jax(rng):
    jw, tw = _windows(capacity=5, evict_after=1)
    _stream(rng, (jw, tw), steps=4)
    for w in (jw, tw):
        w.reset()
        w.record(KEYS[3], np.array([1.0, 2.0], np.float32))
        w.reset()
        w.reset()  # everything but KEYS[3] has idled past evict_after
    assert tw._free == jw._free
    _assert_windows_equal(jw, tw)
    for w in (jw, tw):
        w.record(KEYS[8], np.array([7.0], np.float32))  # reuses a freed row at level 0
    _assert_windows_equal(jw, tw)
    assert tw.drain_events() == jw.drain_events()
    assert tw.drain_events() == []


def test_aggregator_flush_matches_jax(rng):
    jw, tw = _windows(capacity=8)
    ja, ta = jk.KeyedAggregator(jw.spec), tk.KeyedAggregator(tw.spec)
    for _ in range(3):
        _stream(rng, (jw, tw), steps=2)
        ja.flush(jw)
        ta.flush(tw)
    assert ta.keys() == ja.keys() and ta.windows_flushed == ja.windows_flushed == 3
    for key in ta.keys():
        assert ta.quantiles(key, QS) == ja.quantiles(key, QS)
        assert [tuple(e) for e in ta.events_for(key)] == [tuple(e) for e in ja.events_for(key)]
    assert ta.alphas() == ja.alphas()
    _assert_windows_equal(jw, tw)


def test_snapshot_versions_and_publish_match_jax(rng):
    jw, tw = _windows()
    for w in (jw, tw):
        assert w.publish() == 0  # no reader yet: nothing is copied
    _stream(rng, (jw, tw), steps=2)
    snap = tw.snapshot()
    assert snap is tw.snapshot() and snap.version == tw.version
    jw.snapshot()
    for w in (jw, tw):
        w.record(KEYS[1], np.array([3.0], np.float32))
        w.publish()
    assert tw.snapshot() is not snap and snap.version < tw.version
    assert tw.engine_stats() == jw.engine_stats()


def test_parse_duration_matches_jax():
    for text in ("250ms", "30s", "5m", "1h30m", "90", "1m30.5s", "2e1s"):
        assert tk.parse_duration(text) == jk.parse_duration(text)
    for bad in ("", "zzz", "0s", "-3s", "5x30s"):
        with pytest.raises(ValueError):
            tk.parse_duration(bad)
        with pytest.raises(ValueError):
            jk.parse_duration(bad)


def test_unported_window_options_raise():
    ts = TSpec(num_buckets=512, offset=-256)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.KeyedWindow(ts, 4, num_shards=2, device="cpu")
    ringed = tk.KeyedWindow(ts, 4, num_slices=8, slice_seconds=60.0, device="cpu")
    assert ringed.ring.num_slices == 8 and ringed.resolve_window(window="5m") == 5
    w = tk.KeyedWindow(ts, 4, device="cpu")
    assert w.ring is None
    with pytest.raises(ValueError, match="slice ring"):
        w.resolve_window(window="5m")
    with pytest.raises(ValueError):
        tk.KeyedWindow(ts, 0, device="cpu")
