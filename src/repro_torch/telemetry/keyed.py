"""Keyed telemetry: per-metric-key windows backed by one SketchBank.

The multi-tenant setting of the paper (one sketch per endpoint / customer /
host) joined with an agent -> aggregator pipeline:

* on the device, a window is a ``SketchBank`` driven through the engine:
  every ``record`` is one in-place ingest with the reactive collapse fused
  behind it, so the hot loop allocates no new bank;
* on the host, ``KeyedAggregator`` keeps one exact, unbounded ``DDSketch``
  per key and merges flushed windows in (Algorithm 4, mixed collapse
  levels included), so any-horizon rollups per key stay exact-after-merge.

Key -> row assignment is a host-side dict.  Rows are recycled: a key idle
for ``evict_after`` or more consecutive whole windows is evicted at the
next reset and its row returns to a free pool.  If the pool runs dry
mid-window, surplus keys collapse into the reserved ``OVERFLOW_KEY`` row.

Resolution adapts per row (UDDSketch uniform collapse): after each
``record`` the window folds rows whose clamped mass exceeded
``collapse_threshold``, and the per-row levels survive window resets.
Every transition is recorded as a ``CollapseEvent``.

With ``num_slices`` the window keeps a sliding-window ring
(``engine.WindowRing``): ``advance_slice`` seals the live bank as the next
time slice and recycles it in place, and ``windowed_*`` answer quantiles
over the last N slices (``slices=``) or a duration (``window=`` over
``slice_seconds``).  Row sharding (``num_shards > 1``) is not ported yet
(``ROADMAP.md`` queue 1 item 10).
"""

from __future__ import annotations

import re
import threading
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sketch_bank as sbank
from repro_torch.core.sketch_bank import SketchBank
from repro_torch.core.ddsketch import DDSketch
from repro_torch.core.torch_sketch import effective_alpha
from repro_torch.engine import WindowRing, make_engine
from repro_torch.kernels.ref import BucketSpec

__all__ = [
    "OVERFLOW_KEY",
    "BankSnapshot",
    "CollapseEvent",
    "KeyedWindow",
    "KeyedAggregator",
    "parse_duration",
]

OVERFLOW_KEY = "__other__"

_DURATION_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}
# one duration token: a (float) magnitude + optional unit suffix
_DURATION_TOKEN = re.compile(r"([+-]?[0-9.]+(?:e[+-]?[0-9]+)?)(ms|h|m|s)?")


def parse_duration(text) -> float:
    """``"250ms" | "30s" | "5m" | "1h30m" | "90"`` -> seconds.

    Compound forms concatenate tokens; a bare number is seconds.  Raises
    ``ValueError`` naming the offending token on anything unparseable,
    negative or zero.
    """
    s = str(text).strip().lower()
    if not s:
        raise ValueError("empty duration: use e.g. 250ms, 30s, 5m, 1h30m")
    secs = 0.0
    pos = 0
    while pos < len(s):
        m = _DURATION_TOKEN.match(s, pos)
        if m is None:
            raise ValueError(
                f"unparseable duration {text!r} at {s[pos:]!r}: "
                "use e.g. 250ms, 30s, 5m, 1h30m"
            )
        num, unit = m.group(1), m.group(2)
        try:
            mag = float(num)
        except ValueError:
            raise ValueError(
                f"unparseable duration {text!r}: bad magnitude {num!r}"
            ) from None
        if unit is None and m.end() < len(s):
            # a unit-less token may only be the whole string ("90" = 90 s)
            raise ValueError(
                f"unparseable duration {text!r}: token {num!r} has no unit "
                f"(before {s[m.end():]!r})"
            )
        if mag < 0:
            raise ValueError(
                f"duration must be positive, got token {m.group(0)!r} in {text!r}"
            )
        secs += mag * _DURATION_UNITS[unit or "s"]
        pos = m.end()
    if not secs > 0:
        raise ValueError(f"duration must be positive, got {text!r}")
    return secs


class CollapseEvent(NamedTuple):
    """One auto-collapse transition: why a key's guarantee degraded."""

    key: str
    old_level: int
    new_level: int
    window: int  # window index the transition happened in
    clamped_mass: float  # mass that had clamped when the fold fired


class BankSnapshot:
    """An immutable, version-stamped read view of a ``KeyedWindow``.

    Holds a copy of the bank (and of the ring slab, when the window has
    one) in fresh tensors (``SketchEngine.snapshot``), which later in-place
    ingest, seal and reset never touch, plus a copy of the key -> row map
    taken at the same instant.  Queries here take no lock.

    The copies are enqueued on the current stream, the stream the in-place
    ingest runs on, so they see the state as of the snapshot.  If ingest
    ever moves to a side stream, the snapshot needs an event between the
    two.  ``version`` stamps the window state the view reflects (one bump
    per ingest tick, slice seal or reset), so it doubles as the
    result-cache key and the HTTP ``ETag``.
    """

    __slots__ = (
        "version",
        "spec",
        "engine",
        "bank",
        "key_to_row",
        "ring",
        "sealed",
        "slab",
        "window",
    )

    def __init__(self, *, version, window, bank, key_to_row, sealed, slab):
        self.version = version
        self.window = window
        self.spec = window.spec
        self.engine = window.engine
        self.bank = bank
        self.key_to_row = key_to_row
        self.ring = window.ring
        self.sealed = sealed  # ring seal count at capture (None: no ring)
        self.slab = slab  # slab copy at ``sealed`` (shared between snaps)

    def row_quantiles(self, qs) -> np.ndarray:
        """Raw per-row quantiles ``(K, len(qs))``, the coalescer's unit."""
        return self.engine.host_rows(self.engine.quantiles(self.bank, qs))

    def windowed_row_quantiles(self, qs, *, window=None, slices=None) -> np.ndarray:
        """Raw per-row windowed quantiles ``(K, len(qs))``.

        The node cover comes from ``query_args_at`` at the captured seal
        count: layout math, valid however far the live ring has advanced.
        """
        w = self.window.resolve_window(window=window, slices=slices)
        nodes, valid = self.ring.query_args_at(self.sealed, w)
        return self.engine.host_rows(
            self.engine.window_query(self.slab, self.bank, nodes, valid, True, qs)
        )

    def quantiles(self, key: str, qs) -> list[float]:
        rid = self.key_to_row.get(key)
        if rid is None:
            raise KeyError(f"no values recorded for key {key!r}")
        return [float(v) for v in self.row_quantiles(qs)[rid]]

    def all_quantiles(self, qs) -> dict[str, list[float]]:
        out = self.row_quantiles(qs)
        return {
            k: [float(v) for v in out[rid]]
            for k, rid in self.key_to_row.items()
            if k != OVERFLOW_KEY
        }

    def rollup_quantiles(self, qs) -> list[float]:
        out = self.engine.host_rows(self.engine.rollup_quantiles(self.bank, qs))
        return [float(v) for v in out]

    def windowed_quantiles(self, key: str, qs, *, window=None, slices=None):
        rid = self.key_to_row.get(key)
        if rid is None:
            raise KeyError(f"no values recorded for key {key!r}")
        out = self.windowed_row_quantiles(qs, window=window, slices=slices)
        return [float(v) for v in out[rid]]

    def windowed_all_quantiles(self, qs, *, window=None, slices=None):
        out = self.windowed_row_quantiles(qs, window=window, slices=slices)
        return {
            k: [float(v) for v in out[rid]]
            for k, rid in self.key_to_row.items()
            if k != OVERFLOW_KEY
        }

    def windowed_rollup(self, qs, *, window=None, slices=None) -> list[float]:
        w = self.window.resolve_window(window=window, slices=slices)
        nodes, valid = self.ring.query_args_at(self.sealed, w)
        out = self.engine.host_rows(
            self.engine.window_rollup(self.slab, self.bank, nodes, valid, True, qs)
        )
        return [float(v) for v in out]

    def total_mass(self) -> float:
        return float(np.sum(self.engine.host_rows(self.bank.counts)))

    def levels(self) -> dict[str, int]:
        lv = self.engine.host_rows(self.bank.level)
        return {k: int(lv[r]) for k, r in self.key_to_row.items()}


class KeyedWindow:
    """One flush interval of per-key sketches (a SketchBank + key map).

    ``capacity`` counts usable key rows; row 0 is reserved for
    ``OVERFLOW_KEY``.  ``collapse_threshold`` (float mass; None disables)
    controls the post-record collapse: the default 0.0 folds a row as soon
    as any mass clamps.  ``evict_after`` is the idle-window count at which
    a key's row is reclaimed.  ``num_slices`` (a power of two) adds a
    sliding-window ring of that many sealed slices, ``slice_seconds`` the
    slice length that ``window=`` durations divide by.  ``method`` pins
    the insert pipeline (``"matmul"`` / ``"sort"``; None the fused
    kernel).  ``device`` defaults to the card and raises when there is
    none.

    Thread safety: every bank mutation goes through ``self.lock`` (an
    RLock).  Readers run against the version-stamped ``BankSnapshot``
    published by ``snapshot()`` and take the lock only to rebuild it when
    the version moved.  ``KeyedAggregator.flush`` holds the lock across its
    read-then-reset.
    """

    def __init__(
        self,
        spec: BucketSpec,
        capacity: int,
        *,
        collapse_threshold: float | None = 0.0,
        evict_after: int = 1,
        method: str | None = None,
        counts_dtype=torch.float32,
        num_shards: int | None = None,
        track_collapse_events: bool = True,
        max_events: int = 1024,
        num_slices: int | None = None,
        slice_seconds: float | None = None,
        device="cuda",
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if evict_after < 1:
            raise ValueError("evict_after must be >= 1")
        self.spec = spec
        self.capacity = capacity
        # reentrant: KeyedAggregator.flush holds it while calling reset()
        self.lock = threading.RLock()
        self.collapse_threshold = collapse_threshold
        self.evict_after = evict_after
        self.method = method
        self.engine = make_engine(
            spec,
            capacity + 1,
            num_shards=num_shards,
            counts_dtype=counts_dtype,
            method=method,
            device=device,
        )
        self.counts_dtype = self.engine.counts_dtype
        self.bank = self.engine.new_bank()
        self.key_to_row: dict[str, int] = {OVERFLOW_KEY: 0}
        self._free = list(range(capacity, 0, -1))  # pop() hands out 1, 2, ...
        self._last_seen: dict[str, int] = {}
        self._window = 0
        self.track_collapse_events = track_collapse_events
        self._events: deque[CollapseEvent] = deque(maxlen=max_events)
        # (fired, clamped, window) device outputs awaiting host transfer:
        # reading them lazily keeps record() free of host syncs
        self._pending: list[tuple] = []
        # host mirror of per-row levels: reactive folds bump exactly one
        # level per fire, so events never need an extra device read
        self._levels = np.zeros(self.engine.num_sketches, np.int64)
        # optional sliding-window ring: the live bank is the head slice,
        # advance_slice() seals it and recycles the bank in place
        self.ring = None if num_slices is None else WindowRing(self.engine, num_slices)
        self.slice_seconds = None if slice_seconds is None else float(slice_seconds)
        # read path: monotone state version (one bump per ingest tick /
        # slice seal / reset) + the published snapshot readers run against
        self._version = 0
        self._snap: BankSnapshot | None = None
        self._slab_snap: tuple[int, SketchBank] | None = None  # (sealed, copy)
        self._snap_builds = 0
        self._slab_builds = 0

    # ------------------------------------------------------------------ #
    def row_id(self, key: str) -> int:
        """Row for ``key``, allocating from the free pool on first sight
        (overflow row if the pool is dry)."""
        rid = self.key_to_row.get(key)
        if rid is None:
            if not self._free:
                return 0  # bank full: collapse into the OVERFLOW_KEY row
            rid = self._free.pop()
            self.key_to_row[key] = rid
        if key != OVERFLOW_KEY:
            self._last_seen[key] = self._window
        return rid

    def record(self, keys, values, weights=None) -> None:
        """Insert ``(key, value)`` pairs in one engine ingest.

        ``keys`` is either a sequence of strings (one per value) or a single
        string applied to every value.  Rows whose inserts clamped more
        than ``collapse_threshold`` mass fold once, and each fold is logged
        as a ``CollapseEvent``.
        """
        values = np.asarray(values, np.float32).reshape(-1)
        with self.lock:
            if isinstance(keys, str):
                ids = np.full(values.shape, self.row_id(keys), np.int32)
            else:
                ids = np.fromiter(
                    (self.row_id(k) for k in keys), np.int32, count=len(values)
                )
            self._ingest(values, ids, weights)

    def record_batches(self, batches) -> int:
        """Coalesce ``[(key, values, weights-or-None), ...]`` into ONE
        engine ingest, the queue -> window routing the ingest gateway
        drains through.

        Each batch's key resolves to a row once, the per-batch arrays
        concatenate into one mixed ``(values, ids)`` stream (so each key's
        lanes lie together), and batches without weights get implicit 1s
        only when some other batch carries weights.  Returns the number of
        value lanes ingested.
        """
        vs: list[np.ndarray] = []
        ids: list[np.ndarray] = []
        ws: list[np.ndarray] = []
        any_weighted = any(w is not None for _, _, w in batches)
        with self.lock:
            for key, values, weights in batches:
                v = np.asarray(values, np.float32).reshape(-1)
                if v.size == 0:
                    continue
                vs.append(v)
                ids.append(np.full(v.size, self.row_id(key), np.int32))
                if any_weighted:
                    ws.append(
                        np.ones(v.size, np.float32)
                        if weights is None
                        else np.asarray(weights, np.float32).reshape(-1)
                    )
            if not vs:
                return 0
            self._ingest(
                np.concatenate(vs),
                np.concatenate(ids),
                np.concatenate(ws) if any_weighted else None,
            )
        return int(sum(v.size for v in vs))

    def _ingest(self, values: np.ndarray, ids: np.ndarray, weights) -> None:
        self.bank, fired, clamped = self.engine.ingest(
            self.bank,
            values,
            ids,
            weights,
            threshold=self.collapse_threshold,
        )
        if fired is not None and self.track_collapse_events:
            # no host sync here: the (K,) outputs park on the device until
            # events are read (or the window resets)
            self._pending.append((fired, clamped, self._window))
            if len(self._pending) >= 256:  # bound the parked tensors
                self._materialize_events()
        # last: version N must mean "the bank state after N state changes"
        self._version += 1

    def _materialize_events(self) -> None:
        """Read parked (fired, clamped) outputs and log the transitions.

        Rows only change hands at ``reset`` (which materializes first), so
        the current row -> key map is the map that held at record time.
        """
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        row_key = {r: k for k, r in self.key_to_row.items()}
        for fired, clamped, window in pending:
            f = self.engine.host_rows(fired)
            if not f.any():
                continue
            cm = self.engine.host_rows(clamped)
            for r in np.flatnonzero(f):
                old = int(self._levels[r])
                self._levels[r] = old + 1
                self._events.append(
                    CollapseEvent(
                        key=row_key.get(int(r), OVERFLOW_KEY),
                        old_level=old,
                        new_level=old + 1,
                        window=window,
                        clamped_mass=float(cm[r]),
                    )
                )

    @property
    def events(self) -> "deque[CollapseEvent]":
        """Collapse-transition log (materializes any parked outputs)."""
        with self.lock:
            self._materialize_events()
        return self._events

    # ------------------------------------------------------------------ #
    # snapshot publication (the lock-free read path)
    # ------------------------------------------------------------------ #
    @property
    def version(self) -> int:
        """Monotone state version: bumps once per ingest tick (the reactive
        collapse rides the same tick) and reset, the only events at which
        any query answer can change."""
        return self._version

    def _publish_locked(self) -> BankSnapshot:
        snap = self._snap
        if snap is not None and snap.version == self._version:
            return snap
        slab = sealed = None
        if self.ring is not None:
            sealed = self.ring.sealed
            cached = self._slab_snap
            if cached is None or cached[0] != sealed:
                # the slab changes only on seal, so one copy per seal count
                # serves every bank snapshot taken in between; a copy, never
                # the live slab, which seal_slice / merge_node write in place
                cached = (sealed, self.engine.snapshot(self.ring.slab))
                self._slab_builds += 1
                self._slab_snap = cached
            slab = cached[1]
        snap = BankSnapshot(
            version=self._version,
            window=self,
            bank=self.engine.snapshot(self.bank),
            key_to_row=dict(self.key_to_row),
            sealed=sealed,
            slab=slab,
        )
        self._snap_builds += 1
        self._snap = snap
        return snap

    def snapshot(self) -> BankSnapshot:
        """The current read view, rebuilt under the lock only when the
        version moved since the last build."""
        snap = self._snap
        if snap is not None and snap.version == self._version:
            return snap
        with self.lock:
            return self._publish_locked()

    def publish(self) -> int:
        """Refresh the published snapshot; returns the live version.

        The gateway drain loop calls this once per tick.  A no-op until a
        reader has taken a snapshot, so a pure-write workload pays no copy.
        """
        if self._snap is not None:
            with self.lock:
                self._publish_locked()
        return self._version

    # ------------------------------------------------------------------ #
    def quantiles(self, key: str, qs) -> list[float]:
        """Window-local per-key quantiles off the published snapshot."""
        return self.snapshot().quantiles(key, qs)

    def all_quantiles(self, qs) -> dict[str, list[float]]:
        """Window-local quantiles for every live key from one fused query."""
        return self.snapshot().all_quantiles(qs)

    def rollup_quantiles(self, qs) -> list[float]:
        """Quantiles of the union of every row in the window (all keys plus
        the overflow sink); NaN when the window is empty."""
        return self.snapshot().rollup_quantiles(qs)

    def total_mass(self) -> float:
        """Total ingested mass across every row (incl. the overflow sink)."""
        return self.snapshot().total_mass()

    def keys(self) -> list[str]:
        return [k for k in self.key_to_row if k != OVERFLOW_KEY]

    def levels(self) -> dict[str, int]:
        """Per-key uniform-collapse level (0 = full resolution)."""
        return self.snapshot().levels()

    def alphas(self) -> dict[str, float]:
        """Per-key effective relative-error guarantee at the live level."""
        return {k: effective_alpha(self.spec, lv) for k, lv in self.levels().items()}

    def drain_events(self) -> list[CollapseEvent]:
        """Hand off (and clear) the collapse-transition log."""
        with self.lock:
            self._materialize_events()
            out = list(self._events)
            self._events.clear()
        return out

    # ------------------------------------------------------------------ #
    # sliding-window ring (windows over time slices, with num_slices=)
    # ------------------------------------------------------------------ #
    def _require_ring(self) -> WindowRing:
        if self.ring is None:
            raise ValueError(
                "windowed queries need a slice ring: construct the "
                "KeyedWindow with num_slices="
            )
        return self.ring

    def advance_slice(self) -> int:
        """Seal the live slice into the ring and recycle the bank in place.

        The window-advance tick (the ingest gateway calls it on its slice
        clock): the live bank is copied into the ring's head slot, then
        reset in place with ``levels=None``, so per-key collapse levels
        survive slice turnover.  Returns the number of merge-tree node
        rebuilds the seal triggered.
        """
        ring = self._require_ring()
        with self.lock:
            self._window += 1
            self._materialize_events()
            merges = ring.seal(self.bank)
            self.bank = self.engine.reset(self.bank)
            self._version += 1
        return merges

    def resolve_window(self, window=None, slices=None) -> int:
        """``?window=5m`` / ``?slices=8`` -> a validated slice count.

        Exactly one of the two must be given.  Durations round up to whole
        slices (a 5m window over 60 s slices covers 5 slices, the live head
        included) and need ``slice_seconds``; raises ``ValueError`` (the
        HTTP 400 contract) on unparseable input or windows wider than the
        ring.
        """
        ring = self._require_ring()
        if (window is None) == (slices is None):
            raise ValueError("pass exactly one of window= or slices=")
        if slices is not None:
            try:
                w = int(str(slices))
            except ValueError:
                raise ValueError(f"slices must be an integer, got {slices!r}") from None
        else:
            secs = parse_duration(window)
            if self.slice_seconds is None:
                raise ValueError(
                    "duration windows need slice_seconds configured; use slices= instead"
                )
            w = max(1, int(np.ceil(secs / self.slice_seconds)))
        if w < 1:
            raise ValueError(f"window must cover at least 1 slice, got {w}")
        if w > ring.num_slices:
            raise ValueError(
                f"window of {w} slices exceeds the ring ({ring.num_slices} slices retained)"
            )
        return w

    def windowed_quantiles(self, key: str, qs, *, window=None, slices=None) -> list[float]:
        """Per-key quantiles over the last N slices (live slice included):
        the ring's O(log S) cached nodes and one range-merge launch, off
        the published snapshot (lock-free against seals and ingest)."""
        self._require_ring()
        return self.snapshot().windowed_quantiles(key, qs, window=window, slices=slices)

    def windowed_all_quantiles(
        self, qs, *, window=None, slices=None
    ) -> dict[str, list[float]]:
        """Windowed quantiles for every live key (one range-merge launch)."""
        self._require_ring()
        return self.snapshot().windowed_all_quantiles(qs, window=window, slices=slices)

    def windowed_rollup(self, qs, *, window=None, slices=None) -> list[float]:
        """Fleet-view quantiles over the last N slices ("p99 across all
        keys, last 5 minutes")."""
        self._require_ring()
        return self.snapshot().windowed_rollup(qs, window=window, slices=slices)

    def ring_stats(self) -> dict | None:
        """Ring occupancy / maintenance metadata (None when no ring)."""
        if self.ring is None:
            return None
        with self.lock:
            return self.ring.stats()

    def engine_stats(self) -> dict:
        """Call-path, ring and read-path counters for ``/stats``."""
        with self.lock:
            out = {
                "executable_cache": self.engine.cache_info(),
                "read_path": {
                    "version": self._version,
                    "snapshot_builds": self._snap_builds,
                    "slab_snapshot_builds": self._slab_builds,
                },
            }
            if self.ring is not None:
                out["ring"] = self.ring.stats()
        return out

    def reset(self) -> None:
        """Start the next window: zero the bank in place.

        Keys idle for ``evict_after`` or more whole windows are evicted and
        their rows rejoin the free pool at level 0; live keys keep their
        rows and their adapted collapse levels.
        """
        with self.lock:
            self._window += 1
            self._materialize_events()  # before rows change hands below
            levels = self.engine.host_rows(self.bank.level).copy()
            for key in list(self.key_to_row):
                if key == OVERFLOW_KEY:
                    continue
                if self._window - self._last_seen.get(key, self._window) > self.evict_after:
                    rid = self.key_to_row.pop(key)
                    self._last_seen.pop(key, None)
                    self._free.append(rid)
                    levels[rid] = 0  # fresh tenants start at full resolution
            self._levels = levels.astype(np.int64)
            self.bank = self.engine.reset(self.bank, levels.astype(np.int32))
            self._version += 1


class KeyedAggregator:
    """Host-tier rollups: one exact DDSketch per key, merged across windows.

    Window rows arrive at whatever collapse level they adapted to; the
    host-tier merge aligns mixed levels, so per-key totals stay
    exact-after-merge.  Collapse events drain from each flushed window.
    """

    def __init__(self, spec: BucketSpec, max_events: int = 4096):
        self.spec = spec
        self.totals: dict[str, DDSketch] = {}
        self.windows_flushed = 0
        self.events: deque[CollapseEvent] = deque(maxlen=max_events)

    def flush(self, window: KeyedWindow) -> None:
        """Merge a window into the per-key totals and reset it.

        The bank moves to the host in one copy per leaf.  Holds
        ``window.lock`` across the read-then-reset, so a concurrent writer
        can slip no record between the copy and the reset.
        """
        with window.lock:
            bank_h = window.engine.host_bank(window.bank)
            counts = np.asarray(bank_h.counts)
            for key, rid in window.key_to_row.items():
                if counts[rid] == 0:
                    continue
                host = sbank.to_host(bank_h, window.spec, rid)
                if key in self.totals:
                    self.totals[key].merge(host)
                else:
                    self.totals[key] = host
            self.events.extend(window.drain_events())
            self.windows_flushed += 1
            window.reset()

    def quantiles(self, key: str, qs) -> list[float]:
        return self.totals[key].quantiles(qs)

    def alphas(self) -> dict[str, float]:
        """Per-key effective relative-error guarantee of the rollups."""
        return {k: sk.effective_alpha for k, sk in self.totals.items()}

    def events_for(self, key: str) -> list[CollapseEvent]:
        """Collapse transitions recorded for one key (all flushed windows)."""
        return [e for e in self.events if e.key == key]

    def keys(self) -> list[str]:
        return [k for k in self.totals if k != OVERFLOW_KEY]
