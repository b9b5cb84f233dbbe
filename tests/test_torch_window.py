"""The port's windowed serving path against the JAX package's, on the CPU.

Both packages seal the same slice banks (built by the JAX package, carried
across with ``from_numpy``) into their rings; slab leaves, node covers,
window quantiles and rollups, ``KeyedWindow`` turnover and validation, the
HTTP ``?window=`` / ``?slices=`` bodies and the gateway's slice clock must
agree.  The JAX side runs as its own tests run it (``force="ref"`` /
``"interpret"`` kernels, ``use_kernel=False`` engines); the port side runs
its plain versions because its tensors lie on the CPU.

Tolerances: integer-valued counts are bit-exact everywhere.  Fractional
counts (hazard W1) sum in another order than the reference's steady
branch, which adds the live bank first: each merged bucket of n terms is
held to 2 n u times its value (u = 2^-24, both sums within (n - 1) u of
the exact one), and the quantiles to the rtol 1e-6 the reference's own
fractional window test uses.
"""

import json
import math
from urllib.error import HTTPError
from urllib.request import urlopen

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sketch_bank as jsb
from repro.engine import WindowRing as JRing
from repro.engine.engine import shared_engine
from repro.engine.engine import window_merge_bank as j_window_merge_bank
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ref import BucketSpec as JSpec
from repro.telemetry import keyed as jk
from repro_torch.core import sketch_bank as tsb
from repro_torch.engine import SketchEngine as TEngine
from repro_torch.engine import WindowRing as TRing
from repro_torch.engine import window_merge_bank as t_window_merge_bank
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ref import BucketSpec as TSpec
from repro_torch.telemetry import keyed as tk

U = 2.0**-24
QS = [0.0, 0.25, 0.5, 0.95, 0.99, 1.0]
MAPPINGS = ["log", "linear", "cubic"]
SMALL = dict(num_buckets=128, offset=-64)  # the reference's SMALL range-merge geometry
GEOM = dict(num_buckets=512, offset=-256)


def _specs(mapping="linear", geom=GEOM):
    return JSpec(mapping=mapping, **geom), TSpec(mapping=mapping, **geom)


def _stream(rng, n, k, weights):
    x = (10.0 ** rng.uniform(-1.5, 1.5, n)).astype(np.float32)
    x *= np.where(rng.random(n) < 0.3, -1.0, 1.0).astype(np.float32)
    x[rng.random(n) < 0.02] = 0.0
    s = rng.integers(0, k, n).astype(np.int32)
    w = None
    if weights != "none":
        w = rng.integers(1, 5, n).astype(np.float32)
        if weights == "frac":
            w *= np.float32(0.37)
    return x, s, w


def _slice_bank(js, k, rng, *, levels=None, weights="none", n=200):
    """One slice bank built by the JAX package: optional per-row
    pre-collapse, then a stream."""
    bank = jsb.empty(js, k)
    if levels is not None:
        bank = jsb.collapse_to(bank, jnp.asarray(levels, jnp.int32), spec=js)
    x, s, w = _stream(rng, n, k, weights)
    return jsb.add(bank, jnp.asarray(x), jnp.asarray(s),
                   None if w is None else jnp.asarray(w), spec=js)


def _leaves(bank):
    return [np.asarray(x) for x in bank]


def _rings(js, ts, k, s_ring):
    # the JAX engines are shared per geometry, so their executables compile once
    je, te = shared_engine(js, k), TEngine(ts, k, device="cpu")
    return je, te, JRing(je, s_ring), TRing(te, s_ring)


def _seal_both(jring, tring, bank):
    jring.seal(bank)
    tring.seal(tsb.from_numpy(_leaves(bank), device="cpu"))


def _same_answers(got: dict, want: dict):
    assert list(got) == list(want)
    np.testing.assert_array_equal(list(got.values()), list(want.values()))


def _slab_equal(tring, jring):
    for name, g, w in zip(tsb.SketchBank._fields, tsb.to_numpy(tring.slab), jring.slab):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


# --------------------------------------------------------------------- #
# the plain range merge and its front door
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("delta", range(7))
def test_multi_fold_destinations_match_jax(delta):
    for geom in (SMALL, GEOM, dict(num_buckets=256, offset=0)):
        js, ts = _specs(geom=geom)
        np.testing.assert_array_equal(
            tref.multi_fold_destinations(ts, delta), jref.multi_fold_destinations(js, delta)
        )


@pytest.mark.parametrize("force", ["ref", "interpret"])
@pytest.mark.parametrize("dead", [False, True])
def test_range_merge_matches_jax(force, dead, rng):
    """Integer counts, mixed deltas (some above the clip), optional dead
    slices holding stale counts: bit-exact against both JAX tiers."""
    js, ts = _specs(geom=SMALL)
    counts = rng.integers(0, 1000, (5, 6, 128)).astype(np.float32)
    deltas = rng.integers(0, 9, (5, 6)).astype(np.int32)
    valid = np.array([1, 0, 1, 1, 0], np.float32) if dead else None
    want = jops.bank_range_merge(
        jnp.asarray(counts), jnp.asarray(deltas), spec=js, row_tile=4, bucket_tile=64,
        force=force, valid=None if valid is None else jnp.asarray(valid),
    )
    tv = None if valid is None else torch.from_numpy(valid)
    got = tops.bank_range_merge(torch.from_numpy(counts), torch.from_numpy(deltas), spec=ts,
                                valid=tv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tref.bank_range_merge_ref(torch.from_numpy(counts), torch.from_numpy(deltas), spec=ts,
                                  valid=tv).numpy(),
        np.asarray(want),
    )


@pytest.mark.parametrize("steady", [True, False])
def test_range_merge_ref_both_branches_and_fractional(steady, rng):
    """The reference's steady branch (every live delta 0) and its
    reconciliation branch give what the one plain formulation gives; with
    fractional counts each bucket of n terms is within 2 n u of it."""
    js, ts = _specs()
    d_slices = 4
    ints = rng.integers(0, 50, (d_slices, 3, 512)).astype(np.float32)
    deltas = np.zeros((d_slices, 3), np.int32) if steady else rng.integers(0, 7, (d_slices, 3))
    deltas = deltas.astype(np.int32)
    valid = np.array([1, 1, 0, 1], np.float32)
    for counts, exact in ((ints, True), (ints * np.float32(0.37), False)):
        want = np.asarray(jref.bank_range_merge_ref(
            jnp.asarray(counts), jnp.asarray(deltas), spec=js, valid=jnp.asarray(valid)))
        got = tops.bank_range_merge(torch.from_numpy(counts), torch.from_numpy(deltas), spec=ts,
                                    valid=torch.from_numpy(valid)).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            n = d_slices * 2 ** int(deltas.max())  # most terms one bucket sums
            assert np.all(np.abs(got - want) <= 2 * n * U * np.abs(want))


def test_range_merge_rejects_bad_shapes():
    _, ts = _specs(geom=SMALL)
    with pytest.raises(ValueError):
        tref.bank_range_merge_ref(torch.zeros(2, 3, 128), torch.zeros(3, 2, dtype=torch.int32),
                                  spec=ts)
    with pytest.raises(ValueError):
        tref.bank_range_merge_ref(torch.zeros(2, 3, 64), torch.zeros(2, 3, dtype=torch.int32),
                                  spec=ts)


def _node_merge_inputs(rng, dtype, counts, k=5, s_nodes=7, m=512):
    """A slab of ``s_nodes`` nodes and a live bank at mixed per-row levels,
    as numpy leaves, and a cover of 5 entries whose last two are padding
    (node 0, valid 0): integer counts, or the same times 0.37."""
    def leaves(lead):
        pos = rng.integers(0, 40, (*lead, k, m)).astype(np.float32)
        neg = rng.integers(0, 5, (*lead, k, m)).astype(np.float32)
        if counts == "frac":
            pos, neg = pos * np.float32(0.37), neg * np.float32(0.37)
        small = [rng.integers(0, 9, (*lead, k)).astype(np.float32) for _ in range(3)]
        return [pos.astype(dtype), neg.astype(dtype), *(x.astype(dtype) for x in small),
                rng.normal(0, 50, (*lead, k)).astype(np.float32),
                rng.uniform(-5, 0, (*lead, k)).astype(np.float32),
                rng.uniform(1, 9, (*lead, k)).astype(np.float32),
                rng.integers(0, 4, (*lead, k)).astype(np.int32)]

    nodes = np.array([3, 6, 1, 0, 0], np.int32)
    valid = np.array([1, 1, 1, 0, 0], np.float32)
    return leaves((s_nodes,)), leaves(()), nodes, valid


@pytest.mark.parametrize("dtype,counts", [(np.float32, "int"), (np.float32, "frac"),
                                          (np.int32, "int")])
@pytest.mark.parametrize("mapping", ["linear", "log"])
@pytest.mark.parametrize("live", [1.0, 0.0])
def test_range_merge_nodes_front_door_matches_jax(dtype, counts, mapping, live, rng):
    """The node-indexed merge (slab nodes and the live bank read where they
    lie) against the JAX package's ``window_merge_bank`` and its plain
    ``bank_range_merge_ref`` over the stacked block: float32 and int32
    slabs, dead padding nodes, the live gate on and off; integer counts
    bit-exact, fractional ones within 2 n u of each bucket."""
    js, ts = _specs(mapping)
    slab_l, bank_l, nodes, valid = _node_merge_inputs(rng, dtype, counts)
    jslab = jsb.SketchBank(*(jnp.asarray(x) for x in slab_l))
    jbank = jsb.SketchBank(*(jnp.asarray(x) for x in bank_l))
    tslab = tsb.from_numpy(slab_l, device="cpu")
    tbank = tsb.from_numpy(bank_l, device="cpu")
    tn, tv = torch.from_numpy(nodes.astype(np.int64)), torch.from_numpy(valid)
    want = j_window_merge_bank(jslab, jbank, jnp.asarray(nodes), jnp.asarray(valid),
                               jnp.float32(live), spec=js)
    lvl = np.concatenate([slab_l[8][nodes], bank_l[8][None]])
    mask = np.concatenate([valid, [live]]).astype(np.float32)
    deltas = np.where(mask[:, None] > 0, lvl, 0).max(0)[None] - lvl
    pos, neg = tops.bank_range_merge_nodes(
        tslab.pos, tslab.neg, tn, tv, tbank.pos, tbank.neg, torch.tensor(live),
        torch.from_numpy(deltas.astype(np.int32)), spec=ts)
    block = np.concatenate([np.concatenate([slab_l[j][nodes].astype(np.float32),
                                            bank_l[j].astype(np.float32)[None]])
                            for j in (0, 1)], axis=1)
    plain = np.asarray(jref.bank_range_merge_ref(
        jnp.asarray(block), jnp.asarray(np.concatenate([deltas, deltas], 1)), spec=js,
        valid=jnp.asarray(mask)))
    got = torch.cat([pos, neg]).numpy()
    merged = t_window_merge_bank(tslab, tbank, tn, tv, torch.tensor(live), spec=ts)
    if counts == "int":
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, np.concatenate([want.pos, want.neg]))
        for name, g, j in zip(tsb.SketchBank._fields, tsb.to_numpy(merged), want):
            if name == "summ":  # fractional sums of D + 1 terms, in another order
                bound = 2 * (len(nodes) + 1) * U * np.abs(
                    np.concatenate([slab_l[5][nodes], bank_l[5][None]])).sum(0)
                assert np.all(np.abs(g - np.asarray(j)) <= bound)
            else:
                np.testing.assert_array_equal(g, np.asarray(j), err_msg=name)
    else:
        n = (len(nodes) + 1) * 2**6  # most terms one bucket sums
        for ref_ in (plain, np.concatenate([want.pos, want.neg])):
            assert np.all(np.abs(got - ref_) <= 2 * n * U * np.abs(ref_))
        np.testing.assert_array_equal(merged.level.numpy(), np.asarray(want.level))


def test_window_query_reads_the_slab_in_place(monkeypatch):
    """One window query is one node-indexed merge, handed the slab's own
    stores and the live bank's: apart from that front door (whose plain
    CPU version stacks), nothing in the query builds a tensor of the
    (D, K, m) gather or the (D + 1, 2K, m) block."""
    from torch.utils._python_dispatch import TorchDispatchMode

    js, ts = _specs(geom=SMALL)
    k, s_ring = 4, 16
    te = TEngine(ts, k, device="cpu")
    tring = TRing(te, s_ring)
    rng = np.random.default_rng(7)
    for _ in range(s_ring + 3):
        tring.seal(tsb.from_numpy(_leaves(_slice_bank(js, k, rng, n=30)), device="cpu"))
    live = tsb.from_numpy(_leaves(_slice_bank(js, k, rng, n=30)), device="cpu")
    d = tring.max_range_nodes
    m = ts.num_buckets
    calls, inside, shapes = [], [False], []
    real = tops.bank_range_merge_nodes

    def spy(slab_pos, slab_neg, nodes, valid, bank_pos, bank_neg, *a, **kw):
        calls.append((slab_pos, slab_neg, bank_pos, bank_neg))
        inside[0] = True
        try:
            return real(slab_pos, slab_neg, nodes, valid, bank_pos, bank_neg, *a, **kw)
        finally:
            inside[0] = False

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not inside[0]:
                for t in out if isinstance(out, (tuple, list)) else (out,):
                    if isinstance(t, torch.Tensor):
                        shapes.append(tuple(t.shape))
            return out

    monkeypatch.setattr(tops, "bank_range_merge_nodes", spy)
    with Shapes():
        tring.quantiles(live, QS, window_slices=s_ring)
    assert len(calls) == 1
    assert calls[0] == (tring.slab.pos, tring.slab.neg, live.pos, live.neg)
    assert shapes, "the dispatch mode saw no operations"
    assert all(math.prod(sh) < d * k * m for sh in shapes), max(shapes, key=math.prod)


# --------------------------------------------------------------------- #
# the ring: bookkeeping and window queries against the reference ring
# --------------------------------------------------------------------- #
def test_ring_bookkeeping_matches_jax():
    js, ts = _specs(geom=SMALL)
    s_ring = 8
    je, te, jring, tring = _rings(js, ts, 2, s_ring)
    for bad in (3, 1):
        with pytest.raises(ValueError):
            TRing(te, bad)
    with pytest.raises(ValueError):
        tring.range_nodes(0, 1)  # nothing sealed yet
    for _ in range(2 * s_ring + 3):  # deep wraparound
        _seal_both(jring, tring, jsb.empty(js, 2))
        for lo in range(max(0, tring.sealed - s_ring), tring.sealed + 1):
            assert tring.range_nodes(lo, tring.sealed) == jring.range_nodes(lo, jring.sealed)
        for w in range(1, s_ring + 1):
            for sealed in (tring.sealed, max(tring.sealed - 2, 0)):
                tn, tv = tring.query_args_at(sealed, w)
                jn, jv = jring.query_args_at(sealed, w)
                np.testing.assert_array_equal(tn, jn)
                np.testing.assert_array_equal(tv, jv)
        assert tring.stats() == jring.stats()
    for bad in (0, s_ring + 1):
        with pytest.raises(ValueError):
            tring.query_args(bad)


@pytest.mark.parametrize("mapping", MAPPINGS)
@pytest.mark.parametrize("weights", ["none", "int", "frac"])
def test_window_query_and_rollup_match_jax(mapping, weights, rng):
    """Mixed per-row levels across slices, through wraparound (11 seals on
    S = 8): slab leaves after every seal, then every window size."""
    js, ts = _specs(mapping)
    k, s_ring = 5, 8
    je, te, jring, tring = _rings(js, ts, k, s_ring)
    for t in range(11):
        levels = rng.integers(0, 4, k) if t % 3 == 1 else None
        _seal_both(jring, tring, _slice_bank(js, k, rng, levels=levels, weights=weights))
        _slab_equal(tring, jring)
    live_j = _slice_bank(js, k, rng, levels=np.arange(k) % 2, weights=weights)
    live_t = tsb.from_numpy(_leaves(live_j), device="cpu")
    for w in (1, 3, 5, 8):
        got = tring.quantiles(live_t, QS, window_slices=w).numpy()
        want = np.asarray(jring.quantiles(live_j, QS, window_slices=w))
        got_r = tring.rollup(live_t, QS, window_slices=w).numpy()
        want_r = np.asarray(jring.rollup(live_j, QS, window_slices=w))
        if weights == "frac":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            np.testing.assert_allclose(got_r, want_r, rtol=1e-6, atol=0)
            nodes, valid = tring.query_args(w)
            jm = j_window_merge_bank(jring.slab, live_j, jnp.asarray(nodes), jnp.asarray(valid),
                                     jnp.float32(1.0), spec=js)
            tm = t_window_merge_bank(tring.slab, live_t, torch.from_numpy(nodes.astype(np.int64)),
                                     torch.from_numpy(valid), torch.tensor(1.0), spec=ts)
            n = (len(nodes) + 1) * 2**6
            for g, j in ((tm.pos, jm.pos), (tm.neg, jm.neg)):
                j = np.asarray(j)
                assert np.all(np.abs(g.numpy() - j) <= 2 * n * U * j), f"window={w}"
            np.testing.assert_array_equal(tm.level.numpy(), np.asarray(jm.level))
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"window={w}")
            np.testing.assert_array_equal(got_r, want_r, err_msg=f"rollup window={w}")
    # the queries read slab and live bank without changing them
    _slab_equal(tring, jring)
    for g, j in zip(tsb.to_numpy(live_t), live_j):
        np.testing.assert_array_equal(g, np.asarray(j))


def test_int32_slab_window_matches_jax(rng):
    """An int32-counts slab takes the converting gather of
    ``window_merge_bank``; its answers equal the reference's float32 ring."""
    js, ts = _specs("cubic")
    k, s_ring = 4, 8
    je, _, jring, _ = _rings(js, ts, k, s_ring)
    tring = TRing(TEngine(ts, k, counts_dtype=torch.int32, device="cpu"), s_ring)
    assert tring.slab.pos.dtype == torch.int32
    for t in range(10):
        levels = rng.integers(0, 4, k) if t % 3 == 1 else None
        _seal_both(jring, tring, _slice_bank(js, k, rng, levels=levels, weights="int"))
    live_j = _slice_bank(js, k, rng, weights="int")
    live_t = tsb.from_numpy(_leaves(live_j), device="cpu")
    for w in (2, 5, 8):
        np.testing.assert_array_equal(tring.quantiles(live_t, QS, window_slices=w).numpy(),
                                      np.asarray(jring.quantiles(live_j, QS, window_slices=w)))
        np.testing.assert_array_equal(tring.rollup(live_t, QS, window_slices=w).numpy(),
                                      np.asarray(jring.rollup(live_j, QS, window_slices=w)))


def test_empty_slices_and_rows_are_nan():
    js, ts = _specs()
    je, te, jring, tring = _rings(js, ts, 3, 4)
    empty_t, empty_j = te.new_bank(), je.new_bank()
    assert np.isnan(tring.quantiles(empty_t, QS, window_slices=4).numpy()).all()
    assert np.isnan(tring.rollup(empty_t, QS, window_slices=4).numpy()).all()
    one_row = jsb.add(jsb.empty(js, 3), jnp.asarray([1.0, 2.0, 3.0], jnp.float32),
                      jnp.zeros(3, jnp.int32), spec=js)
    _seal_both(jring, tring, one_row)
    _seal_both(jring, tring, jsb.empty(js, 3))  # an entirely empty sealed slice
    got = tring.quantiles(empty_t, QS, window_slices=4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jring.quantiles(empty_j, QS, window_slices=4)))
    assert not np.isnan(got[0]).any() and np.isnan(got[1:]).all()
    np.testing.assert_array_equal(
        got, tring.quantiles(empty_t, QS, window_slices=4, include_live=False).numpy()
    )


def test_dead_slice_with_stale_counts_contributes_nothing(rng):
    """W4: padding entries point at node 0, which holds data; their delta
    is the -1 sentinel, so the window sees only its own slices."""
    js, ts = _specs()
    k = 3
    je, te, jring, tring = _rings(js, ts, k, 8)
    banks = [_slice_bank(js, k, rng) for _ in range(3)]
    for b in banks:
        _seal_both(jring, tring, b)
    nodes, valid = tring.query_args(2)  # one sealed slice (slice 2) + live
    assert 0 in nodes[valid == 0] and valid.sum() == 1
    live_t = te.new_bank()
    got = tring.quantiles(live_t, QS, window_slices=2).numpy()
    want = te.quantiles(tsb.from_numpy(_leaves(banks[2]), device="cpu"), QS).numpy()
    np.testing.assert_array_equal(got, want)


def test_one_range_merge_per_query_and_one_key_per_window_size(monkeypatch):
    """A 64-slice window is one ``ops.bank_range_merge`` call (counted with
    a spy: CPU runs bump no launch counter), and a second window size
    reuses the same (path, geometry) key."""
    js, ts = _specs(geom=SMALL)
    te = TEngine(ts, 4, device="cpu")
    tring = TRing(te, 64)
    rng = np.random.default_rng(5)
    for _ in range(64):
        tring.seal(tsb.from_numpy(_leaves(_slice_bank(js, 4, rng, n=20)), device="cpu"))
    live = tsb.from_numpy(_leaves(_slice_bank(js, 4, rng, n=20)), device="cpu")
    calls = []
    real = tops.bank_range_merge
    monkeypatch.setattr(tops, "bank_range_merge", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    before = te.cache_info()
    tring.quantiles(live, QS, window_slices=64)
    assert len(calls) == 1
    assert te.cache_info()["misses"] == before["misses"] + 1
    mid = te.cache_info()
    tring.quantiles(live, QS, window_slices=7)
    tring.rollup(live, QS, window_slices=7)
    assert len(calls) == 3
    after = te.cache_info()
    assert after["misses"] == mid["misses"] + 1  # the rollup's own key
    assert after["hits"] == mid["hits"] + 1


# --------------------------------------------------------------------- #
# KeyedWindow: turnover, validation, windowed reads, snapshots
# --------------------------------------------------------------------- #
def _keyed_pair(**kw):
    js, ts = _specs()
    return jk.KeyedWindow(js, 4, **kw), tk.KeyedWindow(ts, 4, device="cpu", **kw)


def test_slice_turnover_keeps_levels_and_windowed_reads_match():
    jw, tw = _keyed_pair(num_slices=4, slice_seconds=60.0)
    rng = np.random.default_rng(9)
    for t in range(6):
        vals = (rng.pareto(1.0, 120) + 1.0).astype(np.float32)
        if t == 2:
            vals[:2] = [1e30, 1e-30]  # clamps: the key's level rises mid-ring
        keys = [f"k{i}" for i in rng.integers(0, 3, 120)]
        for w in (jw, tw):
            w.record(keys, vals)
            if t == 2:
                lvl = dict(w.levels())
            assert w.advance_slice() == (1 if t % 2 else 0) + (1 if t % 4 == 3 else 0)
            if t == 2:
                assert w.levels() == lvl and max(lvl.values()) > 0  # levels survive
    for w in (jw, tw):
        w.record(["k1"] * 3, np.asarray([4.0, 5.0, 6.0], np.float32))
    for kw in ({"slices": 1}, {"slices": 3}, {"slices": "4"}, {"window": "2m"},
               {"window": "90s"}):
        _same_answers(tw.windowed_all_quantiles(QS, **kw), jw.windowed_all_quantiles(QS, **kw))
        np.testing.assert_array_equal(tw.windowed_rollup(QS, **kw), jw.windowed_rollup(QS, **kw))
        np.testing.assert_array_equal(tw.windowed_quantiles("k1", QS, **kw),
                                      jw.windowed_quantiles("k1", QS, **kw))
    assert tw.ring_stats() == jw.ring_stats()
    assert tw.engine_stats() == jw.engine_stats()
    with pytest.raises(KeyError):
        tw.windowed_quantiles("nope", [0.5], slices=2)


def test_resolve_window_raises_like_jax():
    jw, tw = _keyed_pair(num_slices=8, slice_seconds=60.0)
    for kw in ({"slices": "3"}, {"window": "5m"}, {"window": "90s"}, {"window": "7m30s"}):
        assert tw.resolve_window(**kw) == jw.resolve_window(**kw)
    bad = ({}, {"window": "5m", "slices": 2}, {"window": "zzz"}, {"slices": "many"},
           {"slices": 0}, {"slices": 9}, {"window": "9h"}, {"window": "-1m"})
    for kw in bad:
        with pytest.raises(ValueError) as te_:
            tw.resolve_window(**kw)
        with pytest.raises(ValueError) as je_:
            jw.resolve_window(**kw)
        assert str(te_.value) == str(je_.value), kw
    jn, tn = _keyed_pair(num_slices=8)
    for w in (jn, tn):
        with pytest.raises(ValueError, match="slice_seconds"):
            w.resolve_window(window="5m")
    jr, tr = _keyed_pair()
    for w in (jr, tr):
        with pytest.raises(ValueError, match="slice ring"):
            w.resolve_window(slices=2)
        with pytest.raises(ValueError, match="slice ring"):
            w.advance_slice()


def test_snapshot_across_a_seal_keeps_its_answers():
    """W2: the snapshot holds slab and bank copies, shared per seal count
    (``slab_snapshot_builds`` as in the reference); seals and ingest write
    the live slab in place, and an old snapshot still answers as before."""
    jw, tw = _keyed_pair(num_slices=4)
    for w in (jw, tw):
        w.record(["a"] * 4, np.asarray([1.0, 2.0, 3.0, 4.0], np.float32))
        w.advance_slice()
        w.record(["a"] * 2, np.asarray([10.0, 20.0], np.float32))
    snap = tw.snapshot()
    jw.snapshot()
    before = snap.windowed_quantiles("a", QS, slices=2)
    for w in (jw, tw):
        w.record(["a"], np.asarray([30.0], np.float32))
        w.snapshot()  # same seal count: the slab copy is reused
        w.advance_slice()
        w.record(["a"] * 3, np.asarray([1e3, 2e3, 3e3], np.float32))
        w.advance_slice()
        w.snapshot()
    assert tw.engine_stats()["read_path"] == jw.engine_stats()["read_path"]
    assert tw.engine_stats()["read_path"]["slab_snapshot_builds"] == 2
    np.testing.assert_array_equal(snap.windowed_quantiles("a", QS, slices=2), before)
    assert snap.slab is not tw.ring.slab
    np.testing.assert_array_equal(tw.windowed_quantiles("a", QS, slices=2),
                                  jw.windowed_quantiles("a", QS, slices=2))


# --------------------------------------------------------------------- #
# HTTP and the gateway's slice clock
# --------------------------------------------------------------------- #
def _get(url):
    try:
        with urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except HTTPError as e:
        return e.code, e.read()


def _http_session(pkg):
    """One scripted windowed session; returns every body it read."""
    if pkg == "jax":
        from repro.launch import http_api as http
        from repro.launch.ingest_gateway import IngestGateway
        keyed, spec = jk, JSpec(mapping="linear", **GEOM)
        win = keyed.KeyedWindow(spec, 6, num_slices=4, slice_seconds=60.0)
    else:
        from repro_torch.launch import http_api as http
        from repro_torch.launch.ingest_gateway import IngestGateway
        keyed, spec = tk, TSpec(mapping="linear", **GEOM)
        win = keyed.KeyedWindow(spec, 6, num_slices=4, slice_seconds=60.0, device="cpu")
    rng = np.random.default_rng(4)
    gateway = IngestGateway(win, start=False)
    out = {}
    with http.QuantileHTTPServer(http.TelemetryFacade(win, keyed.KeyedAggregator(spec)),
                                 gateway=gateway) as srv:
        for t in range(6):
            for i in range(3):
                vals = (rng.pareto(1.0, 50) + 1.0).astype(np.float32)
                if t == 3 and i == 0:
                    vals[:2] = [3e9, 8e9]  # clamps: a reactive collapse fires
                gateway.submit(f"/api/{i}", vals.tolist())
            gateway.flush()
            out[f"slices{t}"] = _get(srv.url + "/quantiles?endpoint=/api/0&slices=3&q=0.5,0.9")
            win.advance_slice()
        for path in (
            "/quantiles?endpoint=/api/1&window=2m&q=0.5,0.99",
            "/quantiles?endpoint=/api/2&slices=4",
            "/quantiles?endpoint=/api/0&slices=1",  # empty live slice: null
            "/rollup?window=4m&q=0,0.5,1",
            "/rollup?slices=2",
            "/quantiles?endpoint=/api/0&window=zzz",
            "/quantiles?endpoint=/api/0&window=1m&slices=2",
            "/quantiles?endpoint=/api/0&slices=0",
            "/quantiles?endpoint=/api/0&slices=99",
            "/rollup?window=9h",
            "/quantiles?endpoint=ghost&slices=2",
        ):
            out[path] = _get(srv.url + path)
        stats = json.loads(_get(srv.url + "/stats")[1])
        out["stats"] = (stats["engine"], stats["query_planner"])
    return out


def test_http_windowed_bodies_match_jax():
    want, got = _http_session("jax"), _http_session("torch")
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
    assert json.loads(want["/quantiles?endpoint=/api/0&slices=1"][1])["quantiles"] == [
        None, None, None]
    assert want["/rollup?window=9h"][0] == 400
    assert want["/quantiles?endpoint=ghost&slices=2"][0] == 404
    assert got["stats"][0]["ring"]["sealed"] == 6


def test_gateway_slice_clock_advances_the_ring():
    from repro_torch.launch.ingest_gateway import IngestGateway

    _, ts = _specs()
    win = tk.KeyedWindow(ts, 4, num_slices=4, device="cpu")
    gw = IngestGateway(win, start=False, slice_interval_s=30.0)
    gw.submit("ep", [1.0, 2.0, 3.0])
    gw.flush()
    assert gw.stats()["slice_advances"] == 0 and win.ring.sealed == 0  # flush never seals
    gw._next_slice_t -= 30.0
    assert gw._maybe_advance_slice() == 1
    assert win.ring.sealed == 1 and gw.stats()["slice_advances"] == 1
    assert win.windowed_quantiles("ep", [0.5], slices=2)[0] == pytest.approx(2.0, rel=0.02)
    gw.stop()
    with pytest.raises(ValueError):
        IngestGateway(tk.KeyedWindow(ts, 4, device="cpu"), start=False, slice_interval_s=1.0)
    with pytest.raises(ValueError):
        IngestGateway(win, start=False, slice_interval_s=0.0)
