"""One scripted HTTP session against each package's server, on the CPU.

``POST /ingest`` batches go through each package's ``IngestGateway`` (drained
on the test's thread after every POST, so both packages ingest the same
ticks), then ``GET /live``, ``/rollup``, ``/quantiles``, ``/report`` and
``/stats``, with ETag / 304 re-polls.  Under the ``linear`` mapping the
bodies must be identical; ``/stats`` must have the same keys and the same
counts (its drain rate and latency quantiles are wall-clock readings).
"""

import json
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

from repro.kernels.ref import BucketSpec as JSpec
from repro.launch import http_api as jhttp
from repro.launch.ingest_gateway import IngestGateway as JGateway
from repro.telemetry import keyed as jk
from repro_torch.kernels.ref import BucketSpec as TSpec
from repro_torch.launch import http_api as thttp
from repro_torch.launch.ingest_gateway import IngestGateway as TGateway
from repro_torch.telemetry import keyed as tk

CLOCK_FIELDS = ("drain_rate_values_per_s", "latency_s")


def _call(url, body=None, headers=None):
    req = Request(url, data=None if body is None else json.dumps(body).encode())
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers.get("ETag"), resp.read()
    except HTTPError as e:
        return e.code, e.headers.get("ETag"), e.read()


def _session(pkg, seed=3):
    if pkg == "jax":
        spec = JSpec(num_buckets=512, offset=-256, mapping="linear")
        window, agg = jk.KeyedWindow(spec, 12), jk.KeyedAggregator(spec)
        gateway, http = JGateway(window, start=False), jhttp
    else:
        spec = TSpec(num_buckets=512, offset=-256, mapping="linear")
        window = tk.KeyedWindow(spec, 12, device="cpu")
        agg = tk.KeyedAggregator(spec)
        gateway, http = TGateway(window, start=False), thttp
    rng = np.random.default_rng(seed)
    out = {}
    facade = http.TelemetryFacade(window, agg)
    with http.QuantileHTTPServer(facade, gateway=gateway) as server:
        url = server.url
        for i in range(10):
            key = f"/api/{int(rng.zipf(1.5)) % 8}"
            vals = (rng.pareto(1.0, 200) + 1.0).astype(np.float32)
            vals[rng.random(200) < 0.05] *= -1
            body = {"key": key, "values": vals.tolist()}
            if i == 4:
                body["values"][:2] = [3e9, 8e9]  # clamps: a reactive collapse fires
            if i == 6:
                body["weights"] = rng.integers(1, 4, 200).tolist()
            code, _, raw = _call(url + "/ingest", body)
            assert code == 200, raw
            out[f"post{i}"] = json.loads(raw)
            gateway.flush()
        out["bad_post"] = _call(url + "/ingest", {"key": "", "values": [1.0]})[::2]
        for path in ("/live", "/live?q=0.5,0.999", "/rollup", "/rollup?q=0,0.25,1"):
            code, etag, raw = _call(url + path)
            assert code == 200 and etag is not None
            out[path] = raw
            out[path + " 304"] = _call(url + path, headers={"If-None-Match": etag})[::2]
        out["window"] = _call(url + "/rollup?window=5m")[0]
        out["slices"] = _call(url + "/quantiles?endpoint=/api/1&slices=2")[0]
        agg.flush(window)
        for path in ("/quantiles?endpoint=/api/1&q=0.5,0.99", "/report", "/quantiles?endpoint=nope"):
            code, _, raw = _call(url + path)
            out[path] = (code, raw)
        stats = json.loads(_call(url + "/stats")[2])
    for field in CLOCK_FIELDS:
        stats["gateway"].pop(field)
    out["stats"] = stats
    return out


def test_scripted_session_bodies_match_jax():
    want, got = _session("jax"), _session("torch")
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
    assert want["/live 304"] == (304, b"")
    assert want["window"] == want["slices"] == 400
    assert want["/quantiles?endpoint=nope"][0] == 404
    report = json.loads(want["/report"][1])
    assert any(rep["collapse_events"] for rep in report.values())


def test_auth_rate_limit_and_ingest_without_gateway():
    spec = TSpec(num_buckets=512, offset=-256)
    window = tk.KeyedWindow(spec, 4, device="cpu")
    window.record("/a", np.array([1.0, 2.0], np.float32))
    facade = thttp.TelemetryFacade(window, tk.KeyedAggregator(spec))
    with thttp.QuantileHTTPServer(facade, auth_token="s3cret") as server:
        assert _call(server.url + "/healthz")[0] == 200
        assert _call(server.url + "/live")[0] == 401
        code, _, raw = _call(server.url + "/live", headers={"Authorization": "Bearer s3cret"})
        assert code == 200 and list(json.loads(raw)["endpoints"]) == ["/a"]
        assert _call(server.url + "/ingest", {"key": "/a", "values": [1]},
                     {"Authorization": "Bearer s3cret"})[0] == 404
    with thttp.QuantileHTTPServer(facade, rate_limit=0.0, rate_burst=1) as server:
        assert _call(server.url + "/live")[0] == 200
        code, _, _ = _call(server.url + "/live")
        assert code == 429


@pytest.mark.parametrize("q", ["7", "abc", "-0.5"])
def test_bad_query_params_answer_400(q):
    spec = TSpec(num_buckets=512, offset=-256)
    window = tk.KeyedWindow(spec, 4, device="cpu")
    facade = thttp.TelemetryFacade(window, tk.KeyedAggregator(spec))
    with thttp.QuantileHTTPServer(facade) as server:
        assert _call(server.url + f"/rollup?q={q}")[0] == 400
