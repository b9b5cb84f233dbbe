"""Thin stdlib HTTP/JSON surface over the quantile queries.

The paper's running example is a latency-quantile *service*; this makes
the in-process answers of a ``KeyedWindow`` / ``KeyedAggregator`` pair
reachable over HTTP with nothing beyond the standard library:

  GET /healthz                             -> {"ok": true}
  GET /quantiles?endpoint=/v1/ep0&q=0.5,0.95,0.99
                                           -> rollup quantiles for one key
  GET /quantiles?endpoint=/v1/ep0&window=5m
      (or &slices=4)                       -> time-windowed quantiles over
                                              the window's slice ring (one
                                              range-merge launch);
                                              unparseable durations or
                                              windows wider than the ring
                                              are a 400 JSON error
  GET /live?q=0.5,0.95,0.99                -> current-window quantiles for
                                              every live endpoint (one
                                              fused bank query)
  GET /rollup?q=0.5,0.95,0.99              -> the fleet view: quantiles of
                                              the union of every endpoint's
                                              current window; ``window=``
                                              / ``slices=`` select the ring
                                              window instead of the live
                                              bank
  GET /report                              -> per-endpoint quantiles +
                                              effective alpha + collapse
                                              transition events

``serve_http`` duck-types: any object with those query methods works
(``TelemetryFacade`` wraps a window + aggregator pair).

Hardening (both off by default, production wants both on):

* ``auth_token`` — requests must carry ``Authorization: Bearer <token>``
  or are refused with 401 (constant-time comparison);
* ``rate_limit`` / ``rate_burst`` — a process-wide token bucket
  (``rate_limit`` requests/s sustained, ``rate_burst`` peak); excess
  requests are refused with 429 + Retry-After.

``/healthz`` is exempt from both: liveness probes must not need secrets
and must not evict real traffic from the bucket.

Write path (``gateway=`` an ``launch.ingest_gateway.IngestGateway``):

  POST /ingest   {"key": str, "values": [..], "weights"?: [..],
                  "deadline_ms"?: float}
                 -> 200 admission receipt {status, queued, shed,
                    queue_depth}; 429 + Retry-After when the gateway queue
                    is full (reject policy); 400 on malformed payloads;
                    413 past ``max_body_bytes``
  GET  /stats    -> {"server": per-server counters (write_errors,
                    requests, faults fired), "engine": executable-cache
                    hit/miss counts + ring occupancy (when the telemetry
                    source exposes ``engine_stats``), "gateway":
                    queue/shed/latency counters} — the operator's
                    overload dashboard

Robustness: ``_reply`` swallows per-connection write failures (a peer
closing mid-response) and counts them in the server stats.  ``faults=``
takes any object with ``take(name)`` (the fault injector, not ported yet)
and arms connection chaos: ``drop_conn`` (hard-close before any response)
and ``half_close`` (headers + half the body, then close).
"""

from __future__ import annotations

import hmac
import json
import math
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from repro_torch.launch.ingest_gateway import GatewayOverloaded
from repro_torch.launch.query_planner import QueryPlanner
from repro_torch.telemetry.keyed import OVERFLOW_KEY

__all__ = [
    "TelemetryFacade",
    "TokenBucket",
    "ServerStats",
    "QuantileHTTPServer",
    "serve_http",
]

_DEFAULT_QS = (0.5, 0.95, 0.99)


class ServerStats:
    """Thread-safe counter dict for the handler pool (one per server)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def incr(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def get(self, key: str) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)


class TelemetryFacade:
    """The serve-layer query methods over a window + aggregator pair.

    Carries a ``QueryPlanner`` (when the window supports snapshots) so the
    HTTP tier coalesces and caches reads; ``planner=None`` falls back to
    direct calls.
    """

    def __init__(self, window, aggregator, *, planner=None):
        self.window = window
        self.aggregator = aggregator
        self.planner = (
            planner if planner is not None else QueryPlanner.for_window(window)
        )

    def endpoint_quantiles(self, endpoint: str, qs=_DEFAULT_QS) -> list[float]:
        return self.aggregator.quantiles(endpoint, list(qs))

    def live_endpoint_quantiles(self, qs=_DEFAULT_QS) -> dict:
        return self.window.all_quantiles(list(qs))

    def rollup_quantiles(self, qs=_DEFAULT_QS) -> list[float]:
        """Current-window fleet view (union of every key's row)."""
        return self.window.rollup_quantiles(list(qs))

    def endpoint_report(self, qs=_DEFAULT_QS) -> dict:
        return {
            ep: {
                "quantiles": self.aggregator.quantiles(ep, list(qs)),
                "alpha": self.aggregator.totals[ep].effective_alpha,
                "collapse_events": [
                    e._asdict() for e in self.aggregator.events_for(ep)
                ],
            }
            for ep in sorted(self.aggregator.keys())
        }

    def windowed_quantiles(
        self, endpoint: str, qs=_DEFAULT_QS, *, window=None, slices=None
    ) -> list[float]:
        """Ring-windowed quantiles for one key (one range-merge launch)."""
        return self.window.windowed_quantiles(
            endpoint, list(qs), window=window, slices=slices
        )

    def windowed_rollup(self, qs=_DEFAULT_QS, *, window=None, slices=None) -> list[float]:
        """Ring-windowed fleet view (union of every key over the window)."""
        return self.window.windowed_rollup(list(qs), window=window, slices=slices)

    def engine_stats(self) -> dict:
        """Call-path, ring and read-path counters for the /stats payload."""
        return self.window.engine_stats()


class TokenBucket:
    """Process-wide token-bucket rate limiter (thread-safe).

    Refills at ``rate`` tokens/s up to ``burst``; each admitted request
    spends one token.  One bucket guards the whole server (the handler
    pool is one process), so the limit holds across connections.
    """

    def __init__(self, rate: float, burst: float):
        if rate < 0 or burst < 1:
            raise ValueError("rate must be >= 0 and burst >= 1")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t_last) * self.rate
            )
            self._t_last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def retry_after_s(self) -> float:
        """Seconds until one token exists (advisory Retry-After value)."""
        with self._lock:
            if self._tokens >= 1.0:
                return 0.0
            if self.rate <= 0:
                return 60.0
            return max(0.0, (1.0 - self._tokens) / self.rate)


def _retry_after_headers(seconds: float) -> dict:
    """429 backoff headers.  RFC 9110 Retry-After takes integer
    delta-seconds only (proxies and generic clients misparse fractions),
    so the standard header is ceiled; ``X-Retry-After-Ms`` carries the
    sub-second advisory for clients that understand it (``IngestClient``).
    """
    seconds = max(0.0, float(seconds))
    return {
        "Retry-After": str(math.ceil(seconds)),
        "X-Retry-After-Ms": str(math.ceil(seconds * 1e3)),
    }


def _parse_qs_param(query: dict) -> list[float]:
    raw = query.get("q", [None])[0]
    if raw is None:
        return list(_DEFAULT_QS)
    qs = [float(tok) for tok in raw.split(",") if tok]
    if not qs or any(not 0.0 <= q <= 1.0 for q in qs):
        raise ValueError(f"q must be comma-separated values in [0, 1], got {raw!r}")
    return qs


def _parse_window_params(query: dict) -> tuple[str | None, str | None]:
    """Extract the optional ``window=`` / ``slices=`` pair (raw strings).

    Mutual exclusion is checked here; parsing (duration suffixes, slice
    counts, ring bounds) happens in the telemetry tier, so the HTTP layer
    and in-process callers share one validator, whose ``ValueError`` maps
    to a 400 JSON body like every other malformed parameter.
    """
    window = query.get("window", [None])[0]
    slices = query.get("slices", [None])[0]
    if window is not None and slices is not None:
        raise ValueError("give either 'window' or 'slices', not both")
    return window, slices


def _nan_to_null(vals) -> list:
    """JSON-safe quantile list: NaN (an empty window) becomes null, not the
    non-standard ``NaN`` token strict parsers reject."""
    out = []
    for v in vals:
        f = float(v)
        out.append(None if math.isnan(f) else f)
    return out


def _make_handler(
    telemetry,
    auth_token: str | None,
    bucket: TokenBucket | None,
    stats: ServerStats,
    gateway=None,
    faults=None,
    max_body_bytes: int = 8 << 20,
):
    # coalesced + version-cached read path when the telemetry source
    # carries a QueryPlanner (TelemetryFacade); None falls back
    # to direct duck-typed calls
    planner = getattr(telemetry, "planner", None)
    # read endpoints whose answers are fully determined by (URL, version):
    # eligible for the ETag / If-None-Match -> 304 fast path
    versioned_paths = ("/quantiles", "/live", "/rollup", "/report")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet: tests/servers manage logging
            pass

        def _not_modified(self, etag: str) -> bool:
            """304 fast path: the client's ``If-None-Match`` matches the
            live version, so its cached entity is current — reply headers
            only (304 MUST NOT carry a body), zero planner/device work."""
            inm = self.headers.get("If-None-Match")
            if inm is None or inm.strip() != etag:
                return False
            stats.incr("http_304")
            try:
                self.send_response(304)
                self.send_header("ETag", etag)
                self.end_headers()
            except (BrokenPipeError, ConnectionResetError, OSError):
                stats.incr("write_errors")
                self.close_connection = True
            return True

        def _reply(self, code: int, payload: dict, headers: dict | None = None) -> None:
            try:
                body = json.dumps(payload).encode()
                if faults is not None and faults.take("half_close") is not None:
                    # chaos: truncate mid-body, then vanish — clients must
                    # treat it as a connection error and retry
                    stats.incr("faults_half_close")
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body[: max(1, len(body) // 2)])
                    self.wfile.flush()
                    self._abort_connection()
                    return
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError, OSError):
                # the peer hung up mid-response: their problem, not a
                # traceback — count it and drop this connection quietly
                stats.incr("write_errors")
                self.close_connection = True

        def _abort_connection(self) -> None:
            """Hard-close the socket (RST-ish): the chaos 'vanished peer'."""
            self.close_connection = True
            try:
                self.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

        def _chaos_drop(self) -> bool:
            """True when the drop_conn fault consumed this request whole."""
            if faults is not None and faults.take("drop_conn") is not None:
                stats.incr("faults_dropped_conn")
                self._abort_connection()
                return True
            return False

        def _gate(self) -> bool:
            """Rate limit + auth; replies and returns False on refusal.

            The bucket is spent *before* the token check so failed-auth
            floods (token brute-forcing) are throttled like any other
            traffic instead of bypassing the limiter.
            """
            if bucket is not None and not bucket.try_acquire():
                self._reply(
                    429,
                    {"error": "rate limit exceeded"},
                    _retry_after_headers(bucket.retry_after_s()),
                )
                return False
            if auth_token is not None:
                header = self.headers.get("Authorization", "")
                expect = f"Bearer {auth_token}"
                # compare as bytes: compare_digest refuses non-ASCII str,
                # and http.server decodes headers as latin-1
                if not hmac.compare_digest(
                    header.encode("latin-1", "replace"), expect.encode()
                ):
                    self._reply(
                        401,
                        {"error": "missing or invalid bearer token"},
                        {"WWW-Authenticate": 'Bearer realm="quantiles"'},
                    )
                    return False
            return True

        def do_GET(self) -> None:  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            query = parse_qs(url.query)
            stats.incr("requests")
            if self._chaos_drop():
                return
            try:
                if url.path == "/healthz":  # liveness: no auth, no bucket
                    self._reply(200, {"ok": True})
                    return
                if not self._gate():
                    return
                etag = None
                if planner is not None and url.path in versioned_paths:
                    # an If-None-Match re-poll at the live version answers
                    # before any parsing or planner work: 304, no body
                    etag = planner.etag()
                    if self._not_modified(etag):
                        return
                if url.path == "/stats":
                    payload = {"server": stats.snapshot()}
                    engine_fn = getattr(telemetry, "engine_stats", None)
                    if engine_fn is not None:
                        # executable-cache hit rates + ring occupancy: the
                        # "is the window tier recompiling?" dashboard
                        payload["engine"] = engine_fn()
                    if planner is not None:
                        # coalescer + result-cache counters: the read-path
                        # "are polls hitting the cache?" dashboard
                        payload["query_planner"] = planner.stats()
                    if gateway is not None:
                        payload["gateway"] = gateway.stats()
                        # pre-first-tick quantiles are NaN, which json.dumps
                        # would emit as the non-standard token NaN (invalid
                        # JSON to strict parsers) — map them to null
                        payload["gateway"]["latency_s"] = [
                            None if math.isnan(v) else v
                            for v in gateway.latency_quantiles()
                        ]
                    self._reply(200, payload)
                elif url.path == "/quantiles":
                    endpoint = query.get("endpoint", [None])[0]
                    if endpoint is None:
                        raise ValueError("missing required parameter 'endpoint'")
                    qs = _parse_qs_param(query)
                    window, slices = _parse_window_params(query)
                    if window is not None or slices is not None:
                        payload = {
                            "endpoint": endpoint,
                            "qs": qs,
                            "window": window,
                            "slices": slices,
                        }
                        if planner is not None:
                            w = planner.resolve_window(window=window, slices=slices)
                            v, table, rows = planner.quantile_rows(qs, w)
                            rid = rows.get(endpoint)
                            if rid is None:
                                raise KeyError(endpoint)
                            payload["quantiles"] = _nan_to_null(table[rid])
                            self._reply(200, payload, {"ETag": f'"{v}"'})
                            return
                        fn = getattr(telemetry, "windowed_quantiles", None)
                        if fn is None:
                            raise ValueError(
                                "windowed queries not supported by this "
                                "telemetry source"
                            )
                        vals = fn(endpoint, qs, window=window, slices=slices)
                        payload["quantiles"] = _nan_to_null(vals)
                        self._reply(200, payload)
                        return
                    if planner is not None:
                        v, vals = planner.cached(
                            ("endpoint_quantiles", endpoint, tuple(qs)),
                            lambda: list(telemetry.endpoint_quantiles(endpoint, qs)),
                        )
                        self._reply(
                            200,
                            {"endpoint": endpoint, "qs": qs, "quantiles": vals},
                            {"ETag": f'"{v}"'},
                        )
                        return
                    vals = telemetry.endpoint_quantiles(endpoint, qs)
                    self._reply(
                        200,
                        {"endpoint": endpoint, "qs": qs, "quantiles": list(vals)},
                    )
                elif url.path == "/live":
                    qs = _parse_qs_param(query)
                    if planner is not None:
                        v, table, rows = planner.quantile_rows(qs)
                        endpoints = {
                            k: [float(x) for x in table[rid]]
                            for k, rid in rows.items()
                            if k != OVERFLOW_KEY
                        }
                        self._reply(
                            200,
                            {"qs": qs, "endpoints": endpoints},
                            {"ETag": f'"{v}"'},
                        )
                        return
                    self._reply(
                        200,
                        {"qs": qs, "endpoints": telemetry.live_endpoint_quantiles(qs)},
                    )
                elif url.path == "/rollup":
                    qs = _parse_qs_param(query)
                    window, slices = _parse_window_params(query)
                    if window is not None or slices is not None:
                        payload = {"qs": qs, "window": window, "slices": slices}
                        if planner is not None:
                            w = planner.resolve_window(window=window, slices=slices)
                            v, vals = planner.rollup(qs, w)
                            payload["quantiles"] = _nan_to_null(vals)
                            self._reply(200, payload, {"ETag": f'"{v}"'})
                            return
                        wfn = getattr(telemetry, "windowed_rollup", None)
                        if wfn is None:
                            raise ValueError(
                                "windowed queries not supported by this "
                                "telemetry source"
                            )
                        vals = wfn(qs, window=window, slices=slices)
                        payload["quantiles"] = _nan_to_null(vals)
                        self._reply(200, payload)
                        return
                    if planner is not None:
                        v, vals = planner.rollup(qs)
                        self._reply(
                            200,
                            {"qs": qs, "quantiles": list(vals)},
                            {"ETag": f'"{v}"'},
                        )
                        return
                    fn = getattr(telemetry, "rollup_quantiles", None)
                    if fn is None:  # duck-typed source without a fleet view
                        self._reply(404, {"error": "rollup not supported"})
                        return
                    self._reply(200, {"qs": qs, "quantiles": list(fn(qs))})
                elif url.path == "/report":
                    qs = _parse_qs_param(query)
                    if planner is not None:
                        v, payload = planner.cached(
                            ("report", tuple(qs)),
                            lambda: telemetry.endpoint_report(qs),
                        )
                        self._reply(200, payload, {"ETag": f'"{v}"'})
                        return
                    self._reply(200, telemetry.endpoint_report(qs))
                else:
                    self._reply(404, {"error": f"unknown path {url.path!r}"})
            except KeyError as e:
                self._reply(404, {"error": f"unknown endpoint {e.args[0]!r}"})
            except ValueError as e:
                self._reply(400, {"error": str(e)})

        def do_POST(self) -> None:  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            stats.incr("requests")
            if self._chaos_drop():
                return
            try:
                if url.path != "/ingest":
                    self._reply(404, {"error": f"unknown path {url.path!r}"})
                    return
                if not self._gate():
                    return
                if gateway is None:
                    self._reply(404, {"error": "ingest not enabled on this server"})
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    length = -1
                if length <= 0:
                    self._reply(400, {"error": "missing or invalid Content-Length"})
                    return
                if length > max_body_bytes:
                    stats.incr("oversized_bodies")
                    self._reply(
                        413,
                        {"error": f"body {length} bytes > limit {max_body_bytes}"},
                    )
                    return
                raw = self.rfile.read(length)
                if len(raw) < length:  # peer died mid-upload: no reply path
                    stats.incr("truncated_bodies")
                    self.close_connection = True
                    return
                try:
                    payload = json.loads(raw)
                except json.JSONDecodeError as e:
                    raise ValueError(f"invalid JSON body: {e}") from e
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                key = payload.get("key")
                values = payload.get("values")
                if not isinstance(key, str) or not key:
                    raise ValueError("'key' must be a non-empty string")
                if not isinstance(values, list):
                    raise ValueError("'values' must be a list of numbers")
                weights = payload.get("weights")
                if weights is not None and not isinstance(weights, list):
                    raise ValueError("'weights' must be a list of numbers")
                deadline_ms = payload.get("deadline_ms")
                if deadline_ms is not None and (
                    isinstance(deadline_ms, bool)
                    or not isinstance(deadline_ms, (int, float))
                ):
                    raise ValueError("'deadline_ms' must be a number")
                try:
                    receipt = gateway.submit(
                        key,
                        values,
                        weights=weights,
                        deadline_s=(
                            None if deadline_ms is None else float(deadline_ms) / 1e3
                        ),
                    )
                except GatewayOverloaded as e:
                    stats.incr("ingest_429")
                    self._reply(
                        429,
                        {"error": "ingest queue full", "queue_depth": e.depth},
                        _retry_after_headers(e.retry_after_s),
                    )
                    return
                stats.incr("ingest_accepted")
                self._reply(200, receipt)
            except (ValueError, TypeError) as e:
                # TypeError covers malformed payload *types* that survive
                # the isinstance checks (e.g. dicts inside values/weights
                # blowing up np.asarray) — still the client's bug: 400
                self._reply(400, {"error": str(e)})
            except RuntimeError as e:  # gateway stopped: refuse, don't crash
                stats.incr("ingest_unavailable")
                self._reply(503, {"error": str(e)}, {"Retry-After": "1"})

    return Handler


class QuantileHTTPServer:
    """ThreadingHTTPServer wrapper with a background serve thread.

    ``port=0`` binds an ephemeral port (see ``.port`` after construction).
    ``auth_token`` requires ``Authorization: Bearer <token>`` on every
    query; ``rate_limit`` (requests/s, with ``rate_burst`` peak — default
    2x the rate) token-buckets the whole server.  ``gateway`` (an
    ``IngestGateway``) enables the ``POST /ingest`` write path; ``faults``
    arms connection chaos for the degradation tests.  Use as a context
    manager or call ``shutdown()`` explicitly.
    """

    def __init__(
        self,
        telemetry,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        auth_token: str | None = None,
        rate_limit: float | None = None,
        rate_burst: float | None = None,
        gateway=None,
        faults=None,
        max_body_bytes: int = 8 << 20,
    ):
        bucket = None
        if rate_limit is not None:
            burst = rate_burst if rate_burst is not None else max(1.0, 2 * rate_limit)
            bucket = TokenBucket(rate_limit, burst)
        self.bucket = bucket
        self.gateway = gateway
        self.stats = ServerStats()
        # socketserver's default listen backlog (5) resets concurrent
        # connects under bursty fleets; raise it before the bind below.
        server_cls = type(
            "IngestHTTPServer", (ThreadingHTTPServer,), {"request_queue_size": 128}
        )
        self.httpd = server_cls(
            (host, port),
            _make_handler(
                telemetry,
                auth_token,
                bucket,
                self.stats,
                gateway=gateway,
                faults=faults,
                max_body_bytes=max_body_bytes,
            ),
        )
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "QuantileHTTPServer":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)
        if self.gateway is not None:
            self.gateway.stop()  # drain what was admitted before exit

    def __enter__(self) -> "QuantileHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()


def serve_http(
    telemetry,
    host: str = "127.0.0.1",
    port: int = 8787,
    *,
    auth_token: str | None = None,
    rate_limit: float | None = None,
    rate_burst: float | None = None,
    gateway=None,
) -> None:
    """Blocking entry point: serve ``telemetry``'s quantile queries forever."""
    server = QuantileHTTPServer(
        telemetry,
        host,
        port,
        auth_token=auth_token,
        rate_limit=rate_limit,
        rate_burst=rate_burst,
        gateway=gateway,
    )
    print(f"[http] serving latency quantiles on {server.url}")
    server.start()
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.shutdown()
