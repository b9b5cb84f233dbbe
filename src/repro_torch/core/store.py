"""Bucket stores for DDSketch (paper §2.2 "Implementation Details").

* ``DenseStore`` — contiguous counter array with an index offset; grows to
  cover the key range ("for fast addition").
* ``CollapsingLowestDenseStore`` — dense store with a ``max_bins`` cap that
  collapses the *lowest* keys into the lowest kept bucket (Algorithm 3/4's
  collapse; used for the positive-value store).
* ``CollapsingHighestDenseStore`` — mirror image (collapses highest keys);
  used for the negative-value store so that collapses always eat the values
  farthest from zero-magnitude quantile interest.
* ``SparseStore`` — dict-backed store ("sparse manner ... sacrificing speed
  for space efficiency").

All stores share the same API so DDSketch and the benchmarks can swap them.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "DenseStore",
    "CollapsingLowestDenseStore",
    "CollapsingHighestDenseStore",
    "SparseStore",
    "make_store",
]

_GROWTH = 128  # allocation granularity for dense stores


class DenseStore:
    """Contiguous counters; ``counts[k - offset]`` is the count of key k."""

    def __init__(self, max_bins: int | None = None):
        self.max_bins = max_bins
        self.counts = np.zeros(0, dtype=np.int64)
        self.offset = 0  # key of counts[0]
        self.count = 0

    # -- geometry ----------------------------------------------------------
    def is_empty(self) -> bool:
        return self.count == 0

    def min_key(self) -> int:
        nz = np.flatnonzero(self.counts)
        if nz.size == 0:
            raise ValueError("store is empty")
        return self.offset + int(nz[0])

    def max_key(self) -> int:
        nz = np.flatnonzero(self.counts)
        if nz.size == 0:
            raise ValueError("store is empty")
        return self.offset + int(nz[-1])

    def num_bins(self) -> int:
        """Number of non-empty buckets (what the paper's Fig. 7 counts)."""
        return int(np.count_nonzero(self.counts))

    def byte_size(self) -> int:
        """In-memory footprint: 8B per allocated counter + bookkeeping."""
        return 8 * len(self.counts) + 32

    # -- growth / collapse -------------------------------------------------
    def _extend_to(self, key: int) -> int:
        """Grow the array so that ``key`` is representable; may collapse.

        Returns the (possibly collapsed) index to increment.
        """
        if len(self.counts) == 0:
            self.offset = key - _GROWTH // 2
            self.counts = np.zeros(_GROWTH, dtype=np.int64)
        lo = self.offset
        hi = self.offset + len(self.counts) - 1
        if key < lo:
            grow = lo - key
            new = np.zeros(_round_up(len(self.counts) + grow), dtype=np.int64)
            new[len(new) - len(self.counts):] = self.counts
            self.offset -= len(new) - len(self.counts)
            self.counts = new
        elif key > hi:
            grow = key - hi
            new = np.zeros(_round_up(len(self.counts) + grow), dtype=np.int64)
            new[: len(self.counts)] = self.counts
            self.counts = new
        return key

    # -- mutation ------------------------------------------------------------
    def add(self, key: int, weight: int = 1) -> None:
        key = self._extend_to(int(key))
        self.counts[key - self.offset] += weight
        self.count += weight
        self._maybe_collapse()

    def remove(self, key: int, weight: int = 1) -> None:
        """Deletion (paper §2.1: 'Deletion works similarly')."""
        idx = int(key) - self.offset
        if not 0 <= idx < len(self.counts) or self.counts[idx] < weight:
            raise ValueError(f"cannot remove {weight} of key {key}")
        self.counts[idx] -= weight
        self.count -= weight

    def merge(self, other: "DenseStore") -> None:
        """Algorithm 4: sum counts per key, then collapse back under the cap."""
        if other.is_empty():
            return
        nz = np.flatnonzero(other.counts)
        self._extend_to(other.offset + int(nz[0]))
        self._extend_to(other.offset + int(nz[-1]))
        src = other.counts[nz]
        dst_idx = other.offset + nz - self.offset
        np.add.at(self.counts, dst_idx, src)
        self.count += int(src.sum())
        self._maybe_collapse()

    def _maybe_collapse(self) -> None:
        pass  # unbounded store

    # -- iteration -----------------------------------------------------------
    def items_ascending(self):
        for i in np.flatnonzero(self.counts):
            yield self.offset + int(i), int(self.counts[i])

    def items_descending(self):
        for i in np.flatnonzero(self.counts)[::-1]:
            yield self.offset + int(i), int(self.counts[i])

    def key_at_rank(self, rank: float, lower: bool = True) -> int:
        """Smallest key whose cumulative count exceeds ``rank`` (Algorithm 2)."""
        running = 0
        for key, cnt in self.items_ascending():
            running += cnt
            if (running > rank) if lower else (running >= rank + 1):
                return key
        return self.max_key()

    def to_dict(self) -> dict:
        nz = np.flatnonzero(self.counts)
        return {
            "keys": (self.offset + nz).tolist(),
            "counts": self.counts[nz].tolist(),
            "max_bins": self.max_bins,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DenseStore":
        store = cls(d["max_bins"]) if cls is not DenseStore else cls()
        for k, c in zip(d["keys"], d["counts"]):
            store.add(int(k), int(c))
        return store


def _round_up(n: int) -> int:
    return ((n + _GROWTH - 1) // _GROWTH) * _GROWTH


class CollapsingLowestDenseStore(DenseStore):
    """Caps non-empty bins at ``max_bins`` by folding lowest keys upward.

    This is the paper's Algorithm 3/4 collapse: the bucket with the lowest
    index is merged into the next-lowest non-empty bucket until the cap holds.
    (Equivalent batched form: all keys below a threshold fold into the
    threshold bucket.)
    """

    def __init__(self, max_bins: int):
        if max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        super().__init__(max_bins)

    def _maybe_collapse(self) -> None:
        while self.num_bins() > self.max_bins:
            nz = np.flatnonzero(self.counts)
            i0, i1 = int(nz[0]), int(nz[1])
            self.counts[i1] += self.counts[i0]
            self.counts[i0] = 0


class CollapsingHighestDenseStore(DenseStore):
    """Mirror of the above for the negative store: collapses *highest* keys."""

    def __init__(self, max_bins: int):
        if max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        super().__init__(max_bins)

    def _maybe_collapse(self) -> None:
        while self.num_bins() > self.max_bins:
            nz = np.flatnonzero(self.counts)
            i0, i1 = int(nz[-1]), int(nz[-2])
            self.counts[i1] += self.counts[i0]
            self.counts[i0] = 0


class SparseStore:
    """dict-backed store: O(non-empty buckets) memory, slower adds."""

    def __init__(self, max_bins: int | None = None):
        self.max_bins = max_bins
        self.bins: dict[int, int] = {}
        self.count = 0

    def is_empty(self) -> bool:
        return self.count == 0

    def min_key(self) -> int:
        if not self.bins:
            raise ValueError("store is empty")
        return min(self.bins)

    def max_key(self) -> int:
        if not self.bins:
            raise ValueError("store is empty")
        return max(self.bins)

    def num_bins(self) -> int:
        return len(self.bins)

    def byte_size(self) -> int:
        return 16 * len(self.bins) + 32  # key+count per entry

    def add(self, key: int, weight: int = 1) -> None:
        key = int(key)
        self.bins[key] = self.bins.get(key, 0) + weight
        self.count += weight
        self._maybe_collapse()

    def remove(self, key: int, weight: int = 1) -> None:
        key = int(key)
        if self.bins.get(key, 0) < weight:
            raise ValueError(f"cannot remove {weight} of key {key}")
        self.bins[key] -= weight
        if self.bins[key] == 0:
            del self.bins[key]
        self.count -= weight

    def merge(self, other) -> None:
        for key, cnt in other.items_ascending():
            self.bins[key] = self.bins.get(key, 0) + cnt
            self.count += cnt
        self._maybe_collapse()

    def _maybe_collapse(self) -> None:
        if self.max_bins is None:
            return
        while len(self.bins) > self.max_bins:
            ks = sorted(self.bins)
            self.bins[ks[1]] += self.bins.pop(ks[0])

    def items_ascending(self):
        for key in sorted(self.bins):
            yield key, self.bins[key]

    def items_descending(self):
        for key in sorted(self.bins, reverse=True):
            yield key, self.bins[key]

    def key_at_rank(self, rank: float, lower: bool = True) -> int:
        running = 0
        for key, cnt in self.items_ascending():
            running += cnt
            if (running > rank) if lower else (running >= rank + 1):
                return key
        return self.max_key()

    def to_dict(self) -> dict:
        return {
            "keys": list(self.bins.keys()),
            "counts": list(self.bins.values()),
            "max_bins": self.max_bins,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SparseStore":
        store = cls(d["max_bins"])
        for k, c in zip(d["keys"], d["counts"]):
            store.add(int(k), int(c))
        return store


def make_store(kind: str, max_bins: int | None):
    if kind == "dense":
        return DenseStore() if max_bins is None else CollapsingLowestDenseStore(max_bins)
    if kind == "dense_high":
        return DenseStore() if max_bins is None else CollapsingHighestDenseStore(max_bins)
    if kind == "sparse":
        return SparseStore(max_bins)
    raise ValueError(f"unknown store kind {kind!r}")
