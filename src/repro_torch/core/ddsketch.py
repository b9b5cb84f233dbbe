"""DDSketch (paper §2): fully-mergeable, relative-error quantile sketch.

Host-tier implementation: exact Algorithms 1-4 with

* a positive store (collapsing lowest keys, Algorithm 3),
* a negative store (keys computed on |x|, collapsing highest keys, §2.2),
* a dedicated zero bucket for values within float error of 0 (§2.2),
* tracked min/max/sum/count (§2.2 "keep separate track of min and max"),
* deletion (§2.1), merging (Algorithm 4), and serialization for
  checkpointing / wire transfer,
* a **uniform-collapse mode** (UDDSketch, Epicoco et al. 2020): with
  ``collapse="uniform"`` the bin cap is enforced by halving the whole
  sketch's resolution — fold key pairs (2j-1, 2j) into j, which squares
  gamma and degrades the guarantee to alpha' = 2*alpha/(1 + alpha^2) —
  instead of collapsing only the lowest keys.  ``collapse_level`` counts
  the folds; sketches at *different* levels of the same base gamma merge
  exactly by collapsing the finer one first (Cafaro et al. 2021's
  mixed-gamma data-stream fusion), so host <-> device round-trips stay
  lossless at any level.

The device tier (a bank of fixed-geometry rows on the card) lives in
``repro_torch.core.sketch_bank``; both share the mapping definitions and
the collapse-level key/value conventions.  This module is a copy of the
JAX package's jax-free host sketch, kept here so the port imports nothing
of that package.
"""

from __future__ import annotations

import math

from .mapping import KeyMapping, make_mapping
from .store import make_store

__all__ = ["DDSketch"]


class DDSketch:
    def __init__(
        self,
        relative_accuracy: float = 0.01,
        max_bins: int | None = 2048,
        mapping: str | KeyMapping = "log",
        store: str = "dense",
        collapse: str = "lowest",
        collapse_level: int = 0,
    ):
        self.mapping = (
            mapping if isinstance(mapping, KeyMapping) else make_mapping(mapping, relative_accuracy)
        )
        if collapse not in ("lowest", "uniform"):
            raise ValueError(f"collapse must be 'lowest' or 'uniform', got {collapse!r}")
        if collapse == "uniform" and (max_bins is None or max_bins < 4):
            # folding converges to <= 2 non-empty bins per store, so caps
            # below 4 could never be met and the collapse loop would spin
            raise ValueError("collapse='uniform' needs a finite max_bins cap >= 4")
        self._store_kind = store
        self._collapse_mode = collapse
        self.collapse_level = int(collapse_level)
        self.max_bins = max_bins
        # Uniform mode keeps per-store caps off: the cap is enforced by
        # uniform collapse of the whole sketch, not by edge-key folding.
        store_cap = None if collapse == "uniform" else max_bins
        self.store = self._new_store(store_cap, negative=False)  # positive values
        self.negative_store = self._new_store(store_cap, negative=True)
        self.zero_count = 0
        self.min = math.inf
        self.max = -math.inf
        self.sum = 0.0
        # uniform mode: adds remaining before the next num_bins() cap scan
        # (each add creates at most one non-empty bin, so the scan can be
        # amortized instead of paid per insert)
        self._adds_until_cap_check = 0

    def _new_store(self, max_bins: int | None, *, negative: bool):
        # Negative store: keys from |x|; collapse must eat the *highest* keys
        # (largest magnitudes) per §2.2.
        kind = (
            "dense_high"
            if negative and self._store_kind == "dense"
            else self._store_kind
        )
        return make_store(kind, max_bins)

    # ------------------------------------------------------------------ #
    @property
    def count(self) -> int:
        return self.store.count + self.negative_store.count + self.zero_count

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else math.nan

    @property
    def gamma_effective(self) -> float:
        """Logical bucket ratio at the current level: gamma**(2**level)."""
        return self.mapping.gamma ** (1 << self.collapse_level)

    @property
    def effective_alpha(self) -> float:
        """Guarantee at the current level: one collapse maps alpha to
        2*alpha/(1 + alpha^2); closed form (g - 1)/(g + 1), g = gamma_eff."""
        g = self.gamma_effective
        return (g - 1.0) / (g + 1.0)

    def num_bins(self) -> int:
        return self.store.num_bins() + self.negative_store.num_bins()

    def byte_size(self) -> int:
        return self.store.byte_size() + self.negative_store.byte_size() + 64

    # ------------------------------------------------------------------ #
    def _key(self, magnitude: float) -> int:
        """Level-shifted bucket key: ceil(base_key / 2**level) (exact int)."""
        k = self.mapping.key(magnitude)
        return -((-k) >> self.collapse_level)

    def _value(self, key: int) -> float:
        """Estimate of level bucket ``key`` (``KeyMapping.value_at_level``,
        the shared source of truth for both tiers)."""
        return self.mapping.value_at_level(key, self.collapse_level)

    # ------------------------------------------------------------------ #
    def add(self, value: float, weight: int = 1) -> None:
        """Algorithm 1 / Algorithm 3 insert, extended to all of R (§2.2)."""
        if weight <= 0:
            raise ValueError("weight must be positive")
        value = float(value)
        if value > self.mapping.min_indexable:
            self.store.add(self._key(value), weight)
        elif value < -self.mapping.min_indexable:
            self.negative_store.add(self._key(-value), weight)
        else:
            self.zero_count += weight
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.sum += value * weight
        self._maybe_uniform_collapse()

    def extend(self, values) -> None:
        for v in values:
            self.add(float(v))

    def delete(self, value: float, weight: int = 1) -> None:
        """Paper §2.1: deletion decrements the bucket counter.

        min/max cannot be maintained exactly under deletion; they become
        conservative bounds (documented limitation shared by the reference
        implementations).
        """
        value = float(value)
        if value > self.mapping.min_indexable:
            self.store.remove(self._key(value), weight)
        elif value < -self.mapping.min_indexable:
            self.negative_store.remove(self._key(-value), weight)
        else:
            if self.zero_count < weight:
                raise ValueError("cannot delete more zeros than were added")
            self.zero_count -= weight
        self.sum -= value * weight

    # ------------------------------------------------------------------ #
    # uniform collapse (UDDSketch Algorithm 2)
    # ------------------------------------------------------------------ #
    def collapse(self) -> None:
        """One uniform-collapse step: every key k folds to ceil(k/2).

        Squares the logical gamma (level += 1), halving resolution while
        doubling indexable range; count/sum/min/max are untouched.
        """
        for attr in ("store", "negative_store"):
            old = getattr(self, attr)
            new = self._new_store(old.max_bins, negative=attr == "negative_store")
            for key, cnt in old.items_ascending():
                new.add((key + 1) >> 1, cnt)
            setattr(self, attr, new)
        self.collapse_level += 1

    def collapse_to(self, level: int) -> None:
        """Fold until ``collapse_level >= level``."""
        while self.collapse_level < level:
            self.collapse()

    def _maybe_uniform_collapse(self, *, force: bool = False) -> None:
        """Enforce the uniform-mode bin cap, amortizing the O(m) bin scan.

        A single ``add`` creates at most one new non-empty bin, so after a
        scan that counted ``b`` bins the cap cannot be exceeded for another
        ``max_bins - b`` adds — skip the scan until that budget is spent.
        ``merge`` can add many bins at once and passes ``force=True``.
        """
        if self._collapse_mode != "uniform":
            return
        if not force and self._adds_until_cap_check > 0:
            self._adds_until_cap_check -= 1
            return
        while self.num_bins() > self.max_bins:
            self.collapse()
        self._adds_until_cap_check = self.max_bins - self.num_bins()

    # ------------------------------------------------------------------ #
    def quantile(self, q: float) -> float:
        """Algorithm 2 extended over (negatives, zero, positives)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0,1], got {q}")
        n = self.count
        if n == 0:
            return math.nan
        # extrema are tracked exactly (§2.2); answer them exactly like the
        # reference implementations do
        if q == 0.0:
            return self.min
        if q == 1.0:
            return self.max
        rank = q * (n - 1)  # Algorithm 2's threshold: first bucket w/ cum > rank

        neg = self.negative_store.count
        if rank < neg:
            # walk negatives from most-negative upward == descending |x| keys
            running = 0
            for key, cnt in self.negative_store.items_descending():
                running += cnt
                if running > rank:
                    est = -self._value(key)
                    break
        elif rank < neg + self.zero_count:
            est = 0.0
        else:
            key = self.store.key_at_rank(rank - neg - self.zero_count)
            est = self._value(key)
        # Clamp with the exactly-tracked extrema (never hurts the guarantee).
        return min(max(est, self.min), self.max)

    def quantiles(self, qs) -> list[float]:
        return [self.quantile(q) for q in qs]

    # ------------------------------------------------------------------ #
    def merge(self, other: "DDSketch") -> None:
        """Algorithm 4, generalized to mixed collapse levels.

        Requires the same base gamma/mapping (data-independent bucket
        boundaries are what make the merge exact).  Operands at different
        levels align by collapsing the finer one first — the coarser grid's
        buckets are exact unions of the finer grid's, so the aligned merge
        is exactly Algorithm 4 at the coarser gamma (``other`` is never
        mutated; a collapsed copy is used when it is the finer operand).
        """
        if self.mapping != other.mapping:
            raise ValueError(
                f"cannot merge sketches with different mappings: "
                f"{self.mapping} vs {other.mapping}"
            )
        if other.collapse_level > self.collapse_level:
            self.collapse_to(other.collapse_level)
        elif other.collapse_level < self.collapse_level:
            other = other.copy()
            other.collapse_to(self.collapse_level)
        self.store.merge(other.store)
        self.negative_store.merge(other.negative_store)
        self.zero_count += other.zero_count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.sum += other.sum
        self._maybe_uniform_collapse(force=True)  # merge adds many bins at once

    def copy(self) -> "DDSketch":
        return DDSketch.from_dict(self.to_dict())

    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return {
            "mapping": self.mapping.to_dict(),
            "store_kind": self._store_kind,
            "max_bins": self.max_bins,
            "collapse": self._collapse_mode,
            "collapse_level": self.collapse_level,
            "store": self.store.to_dict(),
            "negative_store": self.negative_store.to_dict(),
            "zero_count": self.zero_count,
            "min": self.min,
            "max": self.max,
            "sum": self.sum,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DDSketch":
        sk = cls(
            relative_accuracy=d["mapping"]["relative_accuracy"],
            max_bins=d["max_bins"],
            mapping=d["mapping"]["kind"],
            store=d["store_kind"],
            collapse=d.get("collapse", "lowest"),
            collapse_level=d.get("collapse_level", 0),
        )
        for key, cnt in zip(d["store"]["keys"], d["store"]["counts"]):
            sk.store.add(int(key), int(cnt))
        for key, cnt in zip(d["negative_store"]["keys"], d["negative_store"]["counts"]):
            sk.negative_store.add(int(key), int(cnt))
        sk.zero_count = d["zero_count"]
        sk.min = d["min"]
        sk.max = d["max"]
        sk.sum = d["sum"]
        return sk

    def __repr__(self) -> str:
        return (
            f"DDSketch(alpha={self.mapping.relative_accuracy}, n={self.count}, "
            f"bins={self.num_bins()}, level={self.collapse_level}, "
            f"min={self.min:.4g}, max={self.max:.4g})"
        )
