"""The port's plain oracles against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels.ref`` and
``repro_torch.kernels.ref``.  Tolerances, and why:

* bucket keys: bit-exact for ``linear`` and ``cubic`` (the same float32
  bit and polynomial arithmetic); ``log`` runs two ``logf`` builds, which
  may differ by an ulp, so at most 1e-5 of the lanes may move one bucket;
* histograms and counters: bit-exact for integer weights (exact float32
  sums); fractional weights may round in another order, so each bucket of
  c lanes stays within 2 c u sum(w) (u = 2^-24);
* ``summ``: order-dependent on every tier, so within 2 n u sum|w x| per
  row of n lanes;
* extrema compare numerically: -0.0 and +0.0 are equal;
* folds and the per-level value table: bit-exact; quantiles: bit-exact for
  integer counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import tables as jtables
from repro.kernels import ref as jref
from repro_torch.engine import tables as ttables
from repro_torch.kernels import ref as tref

U = 2.0**-24
MAPPINGS = ["log", "linear", "cubic"]


def _specs(mapping):
    return (
        jref.BucketSpec(num_buckets=512, offset=-256, mapping=mapping),
        tref.BucketSpec(num_buckets=512, offset=-256, mapping=mapping),
    )


def _lanes(rng, n, k):
    """Pareto latencies of both signs with every hazard: NaN, +-inf, +-0,
    values past both ends of the range, out-of-range ids, levels 0-6."""
    x = (rng.pareto(1.0, n) + 1.0).astype(np.float32)
    x *= np.where(rng.random(n) < 0.3, -1.0, 1.0).astype(np.float32)
    x[rng.random(n) < 0.05] = 0.0
    specials = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1e-38, 3e-10, 1e12]
    x[: len(specials)] = specials
    s = np.sort(rng.integers(-1, k + 1, n)).astype(np.int32)
    lev = rng.integers(0, 7, n).astype(np.int32)
    return x, s, lev


def _weights(rng, kind, n):
    if kind == "none":
        return None
    if kind == "int":
        return rng.integers(0, 4, n).astype(np.float32)
    return rng.random(n).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_bucket_keys_linear_cubic_bitexact_log_within_rule(rng):
    # log-uniform magnitudes over the whole float32 normal range
    x = np.exp(rng.uniform(-80, 80, 200_000)).astype(np.float32)
    lev = rng.integers(0, 7, x.size).astype(np.int32)
    for mapping in MAPPINGS:
        js, ts = _specs(mapping)
        want = np.asarray(jref.bucket_index(jnp.asarray(x), js, jnp.asarray(lev)))
        got = tref.bucket_index(_t(x), ts, _t(lev)).numpy()
        if mapping == "log":
            diff = np.abs(got.astype(np.int64) - want)
            assert diff.max() <= 1 and (diff > 0).sum() <= 1e-5 * x.size
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mapping", MAPPINGS)
@pytest.mark.parametrize("wkind", ["none", "int", "frac"])
def test_fused_ingest_ref_matches_jax(mapping, wkind, rng):
    k, n = 12, 4096
    js, ts = _specs(mapping)
    x, s, lev = _lanes(rng, n, k)
    w = _weights(rng, wkind, n)
    jh, jst = jref.fused_ingest_ref(
        _j(x), _j(s), _j(w), _j(lev), num_segments=k, spec=js
    )
    th, tst = tref.fused_ingest_ref(_t(x), _t(s), _t(w), _t(lev), num_segments=k, spec=ts)
    counts, cst = tref.fused_ingest_ref(_t(x), _t(s), None, _t(lev), num_segments=k, spec=ts)
    pairs = [(th, jh, counts)] + [
        (getattr(tst, f), getattr(jst, f), getattr(cst, f))
        for f in ("zero", "overflow", "underflow")
    ]
    for got, want, cnt in pairs:
        got, want, cnt = got.numpy(), np.asarray(want), cnt.numpy()
        if wkind == "frac":
            assert np.all(np.abs(got - want) <= 2 * cnt * U * np.abs(want))
        else:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tst.vmin.numpy(), np.asarray(jst.vmin))
    np.testing.assert_array_equal(tst.vmax.numpy(), np.asarray(jst.vmax))
    valid = np.isfinite(x) & (s >= 0) & (s < k)
    wv = np.ones(n, np.float32) if w is None else w
    rows = s[valid]
    absum = np.bincount(rows, np.abs(wv * x)[valid].astype(np.float64), minlength=k)
    nrow = np.bincount(rows, minlength=k)
    assert np.all(np.abs(tst.summ.numpy() - np.asarray(jst.summ)) <= 2 * nrow * U * absum)


def test_fused_ingest_ref_inert_padding_and_signed_zero_extrema():
    _, ts = _specs("linear")
    x = torch.tensor([-0.0, 0.0, float("nan"), 5.0], dtype=torch.float32)
    s = torch.tensor([0, 1, -1, -1], dtype=torch.int32)
    w = torch.tensor([1.0, 1.0, 0.0, 0.0])
    h, st = tref.fused_ingest_ref(x, s, w, None, num_segments=2, spec=ts)
    assert float(h.sum()) == 0.0
    np.testing.assert_array_equal(st.zero.numpy(), [1.0, 1.0])
    # -0.0 and +0.0 compare equal: the extrema contract is numeric
    assert float(st.vmin[0]) == 0.0 and float(st.vmax[1]) == 0.0


@pytest.mark.parametrize("offset", [-256, -100, -511])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_fold_pairs_ref_matches_jax(offset, dtype, rng):
    js = jref.BucketSpec(num_buckets=512, offset=offset)
    ts = tref.BucketSpec(num_buckets=512, offset=offset)
    c = rng.integers(0, 1 << 20, (9, 512)).astype(dtype)
    want = np.asarray(jref.fold_pairs_ref(jnp.asarray(c), spec=js))
    got = tref.fold_pairs_ref(_t(c), spec=ts).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_fold_destination_range_rejects_escaping_geometry():
    with pytest.raises(ValueError):
        tref.fold_destination_range(tref.BucketSpec(num_buckets=512, offset=10))


def _query_inputs(rng, k, m, dtype, fractional=False):
    pos = rng.poisson(rng.gamma(0.5, 3.0, (k, 1)), (k, m)).astype(np.float32)
    neg = rng.poisson(0.2, (k, m)).astype(np.float32)
    zero = rng.poisson(2.0, k).astype(np.float32)
    pos[:2] = neg[:2] = 0
    zero[:1] = 0  # row 0 empty, row 1 zeros only
    if fractional:
        pos *= rng.random((k, m)).astype(np.float32)
        neg *= rng.random((k, m)).astype(np.float32)
    vmin = np.where(neg.any(1), -1e6, 0.0).astype(np.float32)
    vmax = np.where(pos.any(1), 1e6, 0.0).astype(np.float32)
    level = rng.integers(0, 7, k).astype(np.int32)
    return [pos.astype(dtype), neg.astype(dtype), zero.astype(dtype), vmin, vmax, level]


@pytest.mark.parametrize("mapping", MAPPINGS)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_bank_quantiles_ref_matches_jax(mapping, dtype, rng):
    js, ts = _specs(mapping)
    args = _query_inputs(rng, 16, 512, dtype)
    qs = np.array([0.0, 0.01, 0.25, 0.5, 0.75, 0.95, 0.99, 1.0], np.float32)
    jt = jtables.device_value_table(js)
    want = np.asarray(jref.bank_quantiles_ref(*map(jnp.asarray, args), jnp.asarray(qs), jt))
    got = tref.bank_quantiles_ref(*map(_t, args), _t(qs), ttables.device_value_table(ts, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[0]).all() and (want[1, 1:-1] == 0).all()


def test_bank_quantiles_ref_fractional_counts_within_rule(rng):
    """Fractional counts: n and the cumulative counts are summed in
    another order, so a rank at a bucket boundary may pick the neighbour
    bucket; at most 1% of the answers may differ."""
    js, ts = _specs("log")
    args = _query_inputs(rng, 64, 512, np.float32, fractional=True)
    qs = np.linspace(0.0, 1.0, 17, dtype=np.float32)
    jt = jtables.device_value_table(js)
    want = np.asarray(jref.bank_quantiles_ref(*map(jnp.asarray, args), jnp.asarray(qs), jt))
    got = tref.bank_quantiles_ref(
        *map(_t, args), _t(qs), ttables.device_value_table(ts, "cpu")
    ).numpy()
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert (~same).sum() <= 0.01 * same.size


@pytest.mark.parametrize("mapping", MAPPINGS)
def test_bucket_value_table_bit_identical(mapping):
    js, ts = _specs(mapping)
    want = jtables.bucket_value_table(js)
    got = ttables.bucket_value_table(ts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ttables.device_value_table(ts, "cpu").numpy(), np.asarray(jtables.device_value_table(js))
    )


def test_spec_geometry_matches_jax():
    for mapping in MAPPINGS:
        js, ts = _specs(mapping)
        assert (ts.gamma, ts.multiplier, ts.min_indexable, ts.key_bounds()) == (
            js.gamma, js.multiplier, js.min_indexable, js.key_bounds()
        )
    assert tref.MAX_COLLAPSE_LEVEL == jref.MAX_COLLAPSE_LEVEL
    assert ttables.next_pow2(33, 32) == jtables.next_pow2(33, 32) == 64
    assert ttables.padded_row_count(5) == jtables.padded_row_count(5) == 8
