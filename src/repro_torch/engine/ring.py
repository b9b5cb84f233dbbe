"""WindowRing: S sealed time slices as one device-resident slab, with a
power-of-two merge-tree cache so any slice range costs O(log S) node reads.

Merge is a per-bucket '+' (Algorithm 4, full mergeability), so sliding-
window quantiles keep one bank per time slice and merge the slices a query
covers.  Naively that is W-1 host-looped merges per query; here it is
O(log S) cached nodes read in place by ONE ``bank_range_merge`` launch:

* **Slab** -- all ring state is one stacked bank of shape ``(2S-1, K, ...)``
  per leaf, minted by ``SketchEngine.new_slab``.  Nodes ``0..S-1`` are the
  slice leaves (slot = absolute slice index mod S); nodes ``S..2S-2`` hold
  the merge tree, level-j slots storing pre-merged blocks of ``2**j``
  consecutive slices.  ``seal_slice`` / ``merge_node`` write in place, so
  the ring's memory is one slab.
* **Incremental cascade** -- sealing absolute slice ``a`` writes leaf
  ``a mod S`` and then, for each level ``j`` with ``(a+1) % 2**j == 0``,
  rebuilds one level-j node from its two level-(j-1) children: about one
  extra merge per seal.
* **Freshness by construction** -- a level-j slot holds the latest
  completed block congruent to it mod ``S/2**j``, which for any aligned
  block of a range inside the retention window ``[t-S, t)`` is the block
  the decomposition wants; ``_built`` asserts it.
* **O(log S) range cover** -- ``range_nodes`` takes the largest aligned
  block at the range's left edge each step, at most ``2*log2(S)`` nodes;
  ``query_args`` pads the cover to ``max_range_nodes``, so every window
  size is one (path, geometry) key of the engine.

The ring is host bookkeeping (a few ints); the data stays on the device.
The live (unsealed) head slice is the caller's bank: queries append it as
one more masked slice, and after ``seal`` the caller recycles the bank
through the engine's in-place ``reset`` (levels surviving).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.sketch_bank import SketchBank
from repro_torch.engine.engine import SketchEngine

__all__ = ["WindowRing"]


class WindowRing:
    """Segment-tree ring of ``num_slices`` sealed slices over one engine.

    ``num_slices`` must be a power of two >= 2 (the aligned-block
    decomposition and slot recycling both lean on it).  One ring serves
    one bank geometry on one device.
    """

    def __init__(self, engine: SketchEngine, num_slices: int):
        s = int(num_slices)
        if s < 2 or s & (s - 1):
            raise ValueError(
                f"num_slices must be a power of two >= 2, got {num_slices}"
            )
        self.engine = engine
        self.num_slices = s
        self.tree_levels = s.bit_length() - 1  # log2(S)
        # node layout: level j occupies [base[j], base[j] + S >> j)
        self._base = [0]
        for j in range(self.tree_levels):
            self._base.append(self._base[-1] + (s >> j))
        self.num_nodes = self._base[-1] + 1  # 2S - 1
        self.slab: SketchBank = engine.new_slab(self.num_nodes)
        self.sealed = 0  # absolute count of sealed slices (t)
        self.node_merges = 0  # cumulative merge-tree maintenance merges
        # absolute block id currently resident per node slot (-1 = never)
        self._built = np.full(self.num_nodes, -1, np.int64)

    # ------------------------------------------------------------------ #
    # node indexing
    # ------------------------------------------------------------------ #
    def node_index(self, level: int, block: int) -> int:
        """Slab node holding level-``level`` block ``block`` (absolute)."""
        return self._base[level] + block % (self.num_slices >> level)

    @property
    def max_range_nodes(self) -> int:
        """Fixed padded length of every range cover: ``2 * log2(S)``."""
        return max(1, 2 * self.tree_levels)

    # ------------------------------------------------------------------ #
    # sealing + cascade
    # ------------------------------------------------------------------ #
    def seal(self, bank: SketchBank) -> int:
        """Seal ``bank`` as absolute slice ``self.sealed``; returns the
        number of merge-tree node rebuilds this seal triggered.

        The bank is copied into the leaf slot (the slab is updated in
        place); the caller still owns the bank and recycles it via
        ``engine.reset``: levels survive, so per-key collapse state
        persists across slice turnover.
        """
        t = self.sealed
        leaf = t % self.num_slices
        self.slab = self.engine.seal_slice(self.slab, bank, leaf)
        self._built[leaf] = t
        self.sealed = t + 1
        merges = 0
        for j in range(1, self.tree_levels + 1):
            if self.sealed % (1 << j):
                break
            block = self.sealed // (1 << j) - 1
            left = self.node_index(j - 1, 2 * block)
            right = self.node_index(j - 1, 2 * block + 1)
            # children completed earlier in this bottom-up cascade
            assert self._built[left] == 2 * block, (j, block, self._built[left])
            assert self._built[right] == 2 * block + 1
            dst = self.node_index(j, block)
            self.slab = self.engine.merge_node(self.slab, dst, left, right)
            self._built[dst] = block
            merges += 1
        self.node_merges += merges
        return merges

    # ------------------------------------------------------------------ #
    # range decomposition
    # ------------------------------------------------------------------ #
    def _cover(self, sealed: int, lo: int, hi: int) -> list[tuple[int, int]]:
        """``(level, block)`` of each aligned block covering ``[lo, hi)``,
        left to right: the largest aligned block at the left edge each step."""
        if not (max(0, sealed - self.num_slices) <= lo <= hi <= sealed):
            raise ValueError(
                f"range [{lo}, {hi}) outside the retained window "
                f"[{max(0, sealed - self.num_slices)}, {sealed}]"
            )
        out: list[tuple[int, int]] = []
        while lo < hi:
            j = 0
            while (
                j < self.tree_levels
                and lo % (1 << (j + 1)) == 0
                and lo + (1 << (j + 1)) <= hi
            ):
                j += 1
            out.append((j, lo >> j))
            lo += 1 << j
        return out

    def range_nodes_at(self, sealed: int, lo: int, hi: int) -> list[int]:
        """Canonical aligned-block node cover of ``[lo, hi)`` *as of* a
        past ``sealed`` count — pure slot arithmetic, no live bookkeeping.

        The snapshot read path: a slab copied when ``self.sealed`` was
        ``sealed`` holds exactly the blocks this decomposition names
        (freshness by construction), so covers computed against the
        captured count stay valid however far the live ring advances.
        """
        return [self.node_index(j, b) for j, b in self._cover(sealed, lo, hi)]

    def range_nodes(self, lo: int, hi: int) -> list[int]:
        """Canonical aligned-block node cover of absolute range ``[lo, hi)``.

        Requires ``max(0, sealed - S) <= lo <= hi <= sealed`` (the
        retention window); at most ``2 * log2(S)`` nodes.
        """
        out: list[int] = []
        for j, b in self._cover(self.sealed, lo, hi):
            node = self.node_index(j, b)
            # freshness by construction: the slot's latest completed block
            # is exactly this one for any in-window aligned block
            assert self._built[node] == b, (j, b, self._built[node])
            out.append(node)
        return out

    def query_args_at(
        self, sealed: int, window_slices: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """``query_args`` evaluated at a captured ``sealed`` count.

        Pure math over the ring's static layout — safe to call without
        holding the writer lock, against ring state that has since moved
        on.  Pair with a slab snapshot taken at the same count.
        """
        w = int(window_slices)
        if w < 1:
            raise ValueError(f"window must cover at least 1 slice, got {w}")
        if w > self.num_slices:
            raise ValueError(
                f"window of {w} slices exceeds the ring "
                f"({self.num_slices} slices retained)"
            )
        span = min(w - 1, sealed)  # can't read more than is sealed
        cover = self.range_nodes_at(sealed, sealed - span, sealed)
        dmax = self.max_range_nodes
        nodes = np.zeros(dmax, np.int32)
        valid = np.zeros(dmax, np.float32)
        nodes[: len(cover)] = cover
        valid[: len(cover)] = 1.0
        return nodes, valid

    def query_args(self, window_slices: int) -> tuple[np.ndarray, np.ndarray]:
        """Padded ``(nodes, valid)`` arrays covering the last
        ``window_slices - 1`` sealed slices (the window's remaining slice
        is the live bank, appended by the engine).

        Fixed length ``max_range_nodes`` regardless of the window, so every
        window size shares one ``window_query`` (path, geometry) key.
        """
        return self.query_args_at(self.sealed, window_slices)

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    def quantiles(
        self, bank: SketchBank, qs, *, window_slices: int, include_live: bool = True
    ):
        """Per-row quantiles over the last ``window_slices`` slices
        (live bank included), shape ``(K, len(qs))``: one range-merge launch."""
        nodes, valid = self.query_args(window_slices)
        return self.engine.window_query(
            self.slab, bank, nodes, valid, include_live, qs
        )

    def rollup(
        self, bank: SketchBank, qs, *, window_slices: int, include_live: bool = True
    ):
        """All-rows quantiles over the last ``window_slices`` slices,
        shape ``(len(qs),)``."""
        nodes, valid = self.query_args(window_slices)
        return self.engine.window_rollup(
            self.slab, bank, nodes, valid, include_live, qs
        )

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Ring occupancy / maintenance metadata (the /stats payload)."""
        return {
            "num_slices": self.num_slices,
            "sealed": self.sealed,
            "slot": self.sealed % self.num_slices,
            "occupancy": min(self.sealed, self.num_slices),
            "node_merges": self.node_merges,
            "max_range_nodes": self.max_range_nodes,
        }
