"""Write-path ingest gateway: bounded coalescing queue + backpressure.

The paper's deployment accepts millions of points per second from many
agents; the device engine wants the opposite shape — few, large, batched
``ingest`` calls (each one donated executable dispatch).  The gateway is
the adapter, hardened for the day traffic exceeds what the engine absorbs:

* **coalescing** — client batches land in a bounded host-side queue; a
  drain tick concatenates *everything* queued into ONE
  ``KeyedWindow.record_batches`` call (one donated engine executable per
  tick — the engine's pow-2 batch padding bounds executable count no
  matter how ragged the arrivals);
* **backpressure** — the queue is bounded in *values*; past the bound the
  shed policy decides:
    - ``"reject"``  — refuse the batch (``GatewayOverloaded`` -> HTTP 429
      + Retry-After derived from the measured drain rate);
    - ``"sample"``  — degrade to stride sampling: keep every k-th value
      weighted ``n/kept`` so the *mass* of the batch is preserved exactly
      (full mergeability makes the weighted survivors merge like anything
      else) and record the dropped count as **shed mass** so operators see
      exactly what was dropped;
* **deadlines** — each batch carries an ingest deadline (per-request
  override or the gateway default); batches still queued past it are
  dropped at drain time and accounted as expired shed mass — a slow
  engine degrades to bounded staleness, not an unbounded backlog;
* **slice clock** (``slice_interval_s``) — when the window keeps a bank
  ring (``KeyedWindow(num_slices=...)``), the drain thread seals the live
  bank into the ring once per interval on a monotonic clock (after the
  tick's ingest, so a slice never misses values admitted inside its
  interval); ``flush()`` never advances the clock;
* **observability** — ``stats()`` snapshots the counters (accepted /
  ingested / shed / rejected / expired / depth / ticks) and the gateway
  dogfoods its own paper: ingest-to-queryable latency per batch goes into
  a host ``DDSketch`` (``latency_quantiles``).

Fault injection (``launch.faults``) hooks two points deterministically:
``queue_stall`` sleeps the drain loop (backs the queue up so the 429/shed
paths fire on demand) and ``slow_engine`` rides the engine's tick hooks.
The drain thread never dies: an engine error during a tick is counted
(``drain_errors``), the failing tick's batches are dropped as shed mass,
and the loop keeps serving — partial failure, defined response.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.ddsketch import DDSketch

__all__ = ["GatewayOverloaded", "IngestGateway"]

# relative-error guarantee for the gateway's self-instrumented
# ingest-to-queryable latency sketch (paper alpha, host DDSketch)
_LATENCY_ALPHA = 0.01


class GatewayOverloaded(RuntimeError):
    """Queue full under the reject policy; carries the advisory backoff."""

    def __init__(self, retry_after_s: float, depth: int):
        super().__init__(
            f"ingest queue full ({depth} values); retry in {retry_after_s:.3f}s"
        )
        self.retry_after_s = float(retry_after_s)
        self.depth = int(depth)


@dataclass
class _Batch:
    key: str
    values: np.ndarray
    weights: np.ndarray | None
    t_enqueue: float
    deadline: float | None  # absolute monotonic time; None = no deadline
    shed: int = 0  # values stride-sampled away at admission
    t_queryable: float = field(default=0.0)


class IngestGateway:
    """Bounded coalescing queue draining into one engine ingest per tick.

    ``window`` is any sink with ``record_batches``/``total_mass``
    (``telemetry.KeyedWindow``).  ``max_queue_values`` bounds queued value
    lanes (the memory bound under overload); ``tick_interval_s`` is the
    drain cadence; ``shed_policy`` is ``"reject"`` or ``"sample"`` (stride
    ``sample_stride`` at admission once the queue is past
    ``sample_watermark`` of the bound); ``deadline_s`` is the default
    ingest deadline.  ``start=False`` leaves the drain thread off — tests
    and benches then drive ``flush()`` by hand.
    """

    def __init__(
        self,
        window,
        *,
        max_queue_values: int = 1 << 16,
        tick_interval_s: float = 0.01,
        shed_policy: str = "reject",
        sample_stride: int = 8,
        sample_watermark: float = 0.5,
        deadline_s: float | None = None,
        slice_interval_s: float | None = None,
        faults=None,
        start: bool = True,
    ):
        if shed_policy not in ("reject", "sample"):
            raise ValueError(f"shed_policy must be 'reject'|'sample', got {shed_policy!r}")
        if max_queue_values < 1 or sample_stride < 2 or not 0 < sample_watermark <= 1:
            raise ValueError("bad gateway config")
        self.window = window
        self.max_queue_values = int(max_queue_values)
        self.tick_interval_s = float(tick_interval_s)
        self.shed_policy = shed_policy
        self.sample_stride = int(sample_stride)
        self.sample_watermark = float(sample_watermark)
        self.deadline_s = deadline_s
        if slice_interval_s is not None:
            if float(slice_interval_s) <= 0:
                raise ValueError("slice_interval_s must be positive")
            if getattr(window, "ring", None) is None:
                raise ValueError(
                    "slice_interval_s needs a window with a slice ring "
                    "(KeyedWindow(num_slices=...))"
                )
        self.slice_interval_s = (
            None if slice_interval_s is None else float(slice_interval_s)
        )
        self._next_slice_t = (
            None
            if self.slice_interval_s is None
            else time.monotonic() + self.slice_interval_s
        )
        self.faults = faults
        if faults is not None:
            hooks = getattr(getattr(window, "engine", None), "tick_hooks", None)
            if hooks is not None:
                hooks.append(faults.engine_hook())

        self._q: deque[_Batch] = deque()
        self._depth = 0  # queued value lanes
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._drain_lock = threading.Lock()  # one drain at a time (thread|flush)
        self._stopped = False
        self._stats = {
            "accepted_values": 0,
            "ingested_values": 0,
            "shed_mass": 0,  # sampled-away + expired + error-dropped values
            "sampled_batches": 0,
            "rejected_batches": 0,
            "expired_batches": 0,
            "ticks": 0,
            "slice_advances": 0,
            "engine_calls": 0,
            "drain_errors": 0,
            "stalls": 0,
            "max_queue_depth": 0,
        }
        # ingest-to-queryable seconds, measured on ourselves with the very
        # sketch this service exists to serve
        self._latency = DDSketch(_LATENCY_ALPHA)
        # EWMA of drained values/s; seeds Retry-After before the first tick
        self._drain_rate = float(max_queue_values) / max(tick_interval_s, 1e-3)
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(target=self._drain_loop, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ #
    # admission (any HTTP handler thread)
    # ------------------------------------------------------------------ #
    def submit(
        self,
        key: str,
        values,
        weights=None,
        deadline_s: float | None = None,
    ) -> dict:
        """Queue one client batch; returns an admission receipt dict.

        Raises ``GatewayOverloaded`` when the queue is full under the
        reject policy.  Under the sample policy a deep queue degrades the
        batch to weighted stride samples (receipt ``shed`` > 0); a
        *completely* full queue drops the batch whole — still a defined
        response (receipt ``status: "shed"``), never an exception, because
        degrade mode prefers availability.
        """
        if not isinstance(key, str) or not key:
            raise ValueError("key must be a non-empty string")
        v = np.asarray(values, np.float32).reshape(-1)
        w = None if weights is None else np.asarray(weights, np.float32).reshape(-1)
        if w is not None and w.shape != v.shape:
            raise ValueError(f"weights {w.shape} vs values {v.shape}")
        budget = deadline_s if deadline_s is not None else self.deadline_s
        deadline = None if budget is None else time.monotonic() + float(budget)
        shed = 0
        with self._lock:
            # under the lock: stop() sets _stopped under this same lock, so
            # nothing can enqueue after the final drain — keeping the
            # ingested + shed == submitted accounting invariant exact
            if self._stopped:
                raise RuntimeError("gateway is stopped")
            if v.size == 0:
                return {
                    "status": "accepted",
                    "queued": 0,
                    "shed": 0,
                    "queue_depth": self._depth,
                }
            room = self.max_queue_values - self._depth
            if v.size > room:
                if self.shed_policy == "reject":
                    self._stats["rejected_batches"] += 1
                    raise GatewayOverloaded(self._retry_after_locked(), self._depth)
                if room == 0:
                    self._stats["shed_mass"] += int(v.size)
                    return {
                        "status": "shed",
                        "queued": 0,
                        "shed": int(v.size),
                        "queue_depth": self._depth,
                    }
            deep = self._depth + v.size > self.sample_watermark * self.max_queue_values
            if self.shed_policy == "sample" and deep:
                stride = max(self.sample_stride, -(-v.size // max(room, 1)))
                kept = v[::stride]
                # mass-preserving: survivors carry the dropped lanes' weight
                scale = (
                    float(v.size) / kept.size
                    if w is None
                    else float(w.sum()) / max(float(w[::stride].sum()), 1e-30)
                )
                w = (np.ones(kept.size, np.float32) if w is None else w[::stride]) * np.float32(scale)
                shed = int(v.size - kept.size)
                v = kept
                self._stats["sampled_batches"] += 1
                self._stats["shed_mass"] += shed
            self._q.append(_Batch(key, v, w, time.monotonic(), deadline, shed))
            self._depth += v.size
            self._stats["accepted_values"] += int(v.size)
            self._stats["max_queue_depth"] = max(self._stats["max_queue_depth"], self._depth)
            depth = self._depth
            self._wake.notify()
        return {"status": "accepted", "queued": int(v.size), "shed": shed, "queue_depth": depth}

    def _retry_after_locked(self) -> float:
        """Advisory backoff: time for the measured drain rate to clear the
        queue (bounded to [one tick, 5s])."""
        est = self._depth / max(self._drain_rate, 1.0)
        return float(min(max(est, self.tick_interval_s), 5.0))

    def retry_after_s(self) -> float:
        with self._lock:
            return self._retry_after_locked()

    def depth(self) -> int:
        with self._lock:
            return self._depth

    # ------------------------------------------------------------------ #
    # drain (background thread, or flush() on the caller's thread)
    # ------------------------------------------------------------------ #
    def _drain_loop(self) -> None:
        while True:
            with self._wake:
                if self._stopped and not self._q:
                    return
                if not self._q:
                    self._wake.wait(timeout=self.tick_interval_s)
                    if self._stopped and not self._q:
                        return
            if self.faults is not None:
                stall = self.faults.take("queue_stall")
                if stall:
                    with self._lock:
                        self._stats["stalls"] += 1
                    time.sleep(stall)
            self._drain_once()
            # slice clock rides the drain tick: drained values land in the
            # live bank *before* it can be sealed into the ring, so a slice
            # never misses ingest that was admitted inside its interval
            self._maybe_advance_slice()
            time.sleep(self.tick_interval_s)

    def _drain_once(self) -> int:
        """One tick: grab everything queued, drop expired, ingest the rest
        in ONE engine call.  Returns lanes ingested; never raises."""
        with self._drain_lock:
            with self._lock:
                if not self._q:
                    return 0
                batches = list(self._q)
                self._q.clear()
                self._depth = 0
                self._stats["ticks"] += 1
            now = time.monotonic()
            live: list[_Batch] = []
            for b in batches:
                if b.deadline is not None and now > b.deadline:
                    with self._lock:
                        self._stats["expired_batches"] += 1
                        self._stats["shed_mass"] += int(b.values.size)
                else:
                    live.append(b)
            if not live:
                return 0
            t0 = time.monotonic()
            try:
                n = self.window.record_batches(
                    [(b.key, b.values, b.weights) for b in live]
                )
            except Exception:
                # partial failure stays partial: count it, shed this tick's
                # batches, keep the drain thread alive for the next one
                with self._lock:
                    self._stats["drain_errors"] += 1
                    self._stats["shed_mass"] += int(sum(b.values.size for b in live))
                return 0
            done = time.monotonic()
            for b in live:
                self._latency.add(done - b.t_enqueue)
            with self._lock:
                self._stats["engine_calls"] += 1
                self._stats["ingested_values"] += int(n)
                drained_s = max(done - t0, 1e-6)
                rate = n / drained_s
                self._drain_rate = 0.8 * self._drain_rate + 0.2 * rate
            # RCU publish: refresh the window's read snapshot once per tick
            # (a no-op until the first reader exists), so poll storms hit
            # the version cache instead of racing the donation cycle
            self._publish()
            return int(n)

    def _publish(self) -> None:
        pub = getattr(self.window, "publish", None)
        if pub is not None:
            pub()

    def _maybe_advance_slice(self) -> int:
        """Seal the window's live bank into its ring once per elapsed
        ``slice_interval_s`` (monotonic clock, catch-up on stalls).

        Runs only on the drain thread's cadence — ``flush()`` deliberately
        does NOT advance, so tests and shutdown drains never move the
        slice clock under the caller.
        """
        if self.slice_interval_s is None:
            return 0
        advanced = 0
        now = time.monotonic()
        while now >= self._next_slice_t:
            try:
                self.window.advance_slice()
            except Exception:
                # same contract as a failing drain tick: count it, resync
                # the clock, keep the thread alive
                with self._lock:
                    self._stats["drain_errors"] += 1
                self._next_slice_t = now + self.slice_interval_s
                break
            advanced += 1
            self._next_slice_t += self.slice_interval_s
        if advanced:
            with self._lock:
                self._stats["slice_advances"] += advanced
            self._publish()  # seals bump the version: re-publish for readers
        return advanced

    # ------------------------------------------------------------------ #
    def flush(self, timeout_s: float = 10.0) -> None:
        """Drain synchronously until the queue is empty (tests/benches/
        shutdown); runs ticks on the caller's thread."""
        deadline = time.monotonic() + timeout_s
        while True:
            self._drain_once()
            with self._lock:
                if not self._q:
                    return
            if time.monotonic() > deadline:
                raise TimeoutError(f"gateway queue not drained in {timeout_s}s")

    def stop(self, flush: bool = True) -> None:
        """Stop admissions, optionally drain what's queued, join the thread."""
        with self._wake:
            self._stopped = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if flush:
            self.flush()
        elif self.depth():
            with self._lock:
                self._stats["shed_mass"] += self._depth
                self._q.clear()
                self._depth = 0

    def __enter__(self) -> "IngestGateway":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Counter snapshot + live depth (thread-safe copy)."""
        with self._lock:
            out = dict(self._stats)
            out["queue_depth"] = self._depth
            out["drain_rate_values_per_s"] = round(self._drain_rate, 1)
        return out

    def latency_quantiles(self, qs=(0.5, 0.95, 0.99)) -> list[float]:
        """Ingest-to-queryable latency quantiles (seconds), sketched by the
        gateway itself — NaN-free only once at least one tick completed."""
        if self._latency.count == 0:
            return [float("nan")] * len(qs)
        return self._latency.quantiles(list(qs))

    def reset_latency(self) -> None:
        """Drop accumulated latency samples (e.g. after a warm-up phase,
        so compile-time outliers don't pollute steady-state quantiles)."""
        with self._lock:
            self._latency = DDSketch(_LATENCY_ALPHA)
