"""Read-path query planner: coalesced fused queries + a versioned cache.

The write path coalesces (the ingest gateway folds every queued client
batch into one engine ingest per tick).  This is its mirror for reads,
between the HTTP handler pool and the ``KeyedWindow`` snapshot tier:

* **coalescing** -- concurrent ``/live``, ``/rollup`` and ``?window=``
  requests landing within a short tick fold into ONE fused query per
  (kind, window) group over the union of requested qs, and each request's
  answer is
  scattered back out of the shared result table.  Sound because the fused
  query computes every q independently off the same per-row cumulative
  counts, so the union query is bit-exact against per-request queries on
  the same snapshot.  The first uncached request leads: it sleeps one
  ``coalesce_window_s`` to let concurrent pollers pile in, then runs
  groups until the pending list drains.
* **versioned result cache** -- an LRU keyed on
  ``(kind, window, qs, version)``.  Sketch state changes only at ingest
  ticks, slice seals and resets, and ``KeyedWindow.version`` bumps at
  exactly those, so a hit at the live version is current.  A version bump changes every key; stale entries
  age out of the LRU.
* **ETag handoff** -- ``version`` doubles as the HTTP ``ETag``; the HTTP
  tier answers ``If-None-Match`` re-polls with 304 before any planner work.

The union-qs axis is padded (duplicating the last q) to a power of two,
so the kernels see O(log Q) query shapes.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.engine.tables import next_pow2

__all__ = ["QueryPlanner", "QueryResultCache"]


class QueryResultCache:
    """Thread-safe LRU of version-stamped query results."""

    def __init__(self, max_entries: int = 512):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
            self.misses += 1
            return None

    def put(self, key: tuple, value) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0,
            }


@dataclass
class _Pending:
    """One in-flight read waiting on the coalescer."""

    kind: str  # "rows" -> (K, Q) table; "rollup" -> (Q,) values
    wslices: int | None  # resolved slice count; None = live bank
    qs: tuple  # the request's quantile fractions
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: BaseException | None = None


class QueryPlanner:
    """Coalesce concurrent reads into shared fused queries over one
    snapshot, with a version-keyed result cache in front.

    ``window`` is a ``telemetry.KeyedWindow`` (anything exposing
    ``snapshot()`` / ``version`` / ``resolve_window``).  All public methods
    are safe to call from any number of HTTP handler threads.
    """

    def __init__(
        self,
        window,
        *,
        coalesce_window_s: float = 0.002,
        cache_entries: int = 512,
    ):
        self.window = window
        self.coalesce_window_s = float(coalesce_window_s)
        self.cache = QueryResultCache(cache_entries)
        self._lock = threading.Lock()
        self._pending: list[_Pending] = []
        self._leading = False
        self._stats = {
            "requests": 0,
            "coalesced": 0,  # requests answered by another request's query
            "dispatches": 0,  # fused queries actually issued
            "leader_rounds": 0,
        }

    @classmethod
    def for_window(cls, window, **kwargs) -> "QueryPlanner | None":
        """A planner when the source supports snapshots, else None (the
        HTTP tier then falls back to direct duck-typed calls)."""
        if hasattr(window, "snapshot") and hasattr(window, "version"):
            return cls(window, **kwargs)
        return None

    # ------------------------------------------------------------------ #
    @property
    def version(self) -> int:
        """The live state version (the ETag the HTTP tier hands out)."""
        return self.window.version

    def etag(self) -> str:
        return f'"{self.window.version}"'

    def resolve_window(self, window=None, slices=None) -> int | None:
        """Raw HTTP ``window=`` / ``slices=`` params -> slice count (None
        when neither is given); ``ValueError`` (the 400 path) on bad input
        or a window without a slice ring."""
        if window is None and slices is None:
            return None
        return int(self.window.resolve_window(window=window, slices=slices))

    # ------------------------------------------------------------------ #
    # the read shapes
    # ------------------------------------------------------------------ #
    def quantile_rows(self, qs, wslices: int | None = None):
        """Per-row quantiles: ``(version, (K, len(qs)) table, key_to_row)``.

        Backs ``/live`` (all rows) and keyed ``/quantiles?window=`` (the
        caller indexes its row).  Coalesced and cached.
        """
        return self._submit("rows", wslices, tuple(float(q) for q in qs))

    def rollup(self, qs, wslices: int | None = None):
        """Fleet-view quantiles: ``(version, [len(qs) floats])``."""
        return self._submit("rollup", wslices, tuple(float(q) for q in qs))

    def cached(self, key: tuple, compute: Callable[[], Any]):
        """Version-memoize an arbitrary host-tier read -> (version, value).

        For the aggregator-backed answers (``/quantiles``, ``/report``):
        their inputs change only through ``flush`` -> ``window.reset()``,
        which bumps the window version.  The value is cached only if the
        version did not move during ``compute``.
        """
        v = self.window.version
        self._bump("requests")
        hit = self.cache.get(("aux", key, v))
        if hit is not None:
            return v, hit
        value = compute()
        if self.window.version == v:
            self.cache.put(("aux", key, v), value)
        return v, value

    # ------------------------------------------------------------------ #
    def _bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._stats[name] += n

    def _submit(self, kind: str, wslices: int | None, qs: tuple):
        self._bump("requests")
        hit = self.cache.get(((kind, wslices, qs), self.window.version))
        if hit is not None:
            return hit
        req = _Pending(kind, wslices, qs)
        with self._lock:
            self._pending.append(req)
            lead = not self._leading
            if lead:
                self._leading = True
        if lead:
            self._lead()
        else:
            self._bump("coalesced")
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _lead(self) -> None:
        """Leader loop: sleep one coalesce tick, then run grouped queries
        until the pending list drains.  Always releases leadership and
        never leaves a follower hanging."""
        batch: list[_Pending] = []
        try:
            if self.coalesce_window_s > 0:
                time.sleep(self.coalesce_window_s)
            while True:
                with self._lock:
                    batch, self._pending = self._pending, []
                    if not batch:
                        self._leading = False
                        return
                    self._stats["leader_rounds"] += 1
                self._execute(batch)
                batch = []
        except BaseException as e:
            # _execute confines errors per group, so this only fires on
            # planner bugs: still, release everything
            with self._lock:
                dangling = batch + self._pending
                self._pending = []
                self._leading = False
            for r in dangling:
                if not r.event.is_set():
                    r.error = e
                    r.event.set()
            raise

    def _execute(self, batch: list[_Pending]) -> None:
        """One coalescer round: group -> one fused query per group ->
        scatter per-request answers -> fill the cache -> wake waiters."""
        snap = self.window.snapshot()
        groups: dict[tuple, list[_Pending]] = {}
        for r in batch:
            groups.setdefault((r.kind, r.wslices), []).append(r)
        self._bump("dispatches", len(groups))
        for (kind, w), reqs in groups.items():
            union = sorted({q for r in reqs for q in r.qs})
            padded = union + [union[-1]] * (next_pow2(len(union), 1) - len(union))
            try:
                if kind == "rows":
                    table = (
                        snap.row_quantiles(padded)
                        if w is None
                        else snap.windowed_row_quantiles(padded, slices=w)
                    )
                else:
                    vals = (
                        snap.rollup_quantiles(padded)
                        if w is None
                        else snap.windowed_rollup(padded, slices=w)
                    )
            except BaseException as e:
                for r in reqs:
                    r.error = e
                    r.event.set()
                continue
            col = {q: i for i, q in enumerate(padded)}
            for r in reqs:
                idx = [col[q] for q in r.qs]
                if kind == "rows":
                    r.result = (snap.version, table[:, idx], snap.key_to_row)
                else:
                    r.result = (snap.version, [vals[i] for i in idx])
                # fill under the executed snapshot's version: if the writer
                # bumped mid-round the entry is simply never hit
                self.cache.put(((r.kind, w, r.qs), snap.version), r.result)
                r.event.set()

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
        out["cache"] = self.cache.stats()
        out["version"] = self.window.version
        return out
