"""SketchEngine: the bank's call paths, run eagerly with in-place state.

The JAX engine owns one ahead-of-time compiled executable per (path, batch
geometry) and donates the bank to each state-in/state-out call.  Here the
calls run eagerly and the bank's tensors are updated in place, which is
the port's form of donation: ``ingest``, ``reset``, ``collapse_to``,
``auto_collapse`` and ``merge`` write into the preallocated bank tensors
and return the same bank, so a tick allocates no new bank.  The
(path, geometry) keys are still counted, so ``cache_info()`` (and the HTTP
``/stats`` payload) keeps its shape; a CUDA-graph cache keyed the same way
is later work.

Batches are padded to the next power of two with inert lanes (NaN value /
id -1 / weight 0), so the kernels see the same shapes as the JAX path.

The window-ring slab (``new_slab``) is a bank with a leading node axis;
``seal_slice`` and ``merge_node`` write into it in place, and
``window_query`` / ``window_rollup`` answer a slice range through one
``bank_range_merge`` launch that reads the covered slab nodes and the live
bank where they lie (``window_merge_bank``).

The engine's ``device`` defaults to the card; ``device="cuda"`` without a
CUDA device raises instead of carrying on on the CPU.  Row sharding
(``ROADMAP.md`` queue 1 item 10) is not ported.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import sketch_bank as sbank
from repro_torch.core import torch_sketch
from repro_torch.core.sketch_bank import SketchBank
from repro_torch.engine.tables import next_pow2
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MAX_COLLAPSE_LEVEL, BucketSpec, f32

__all__ = ["SketchEngine", "make_engine", "resolve_device", "window_merge_bank"]

_MIN_BATCH = 32  # smallest padded ingest batch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device the machine lacks."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch.cuda.is_available() is False; pass "
            'device="cpu" to run the plain PyTorch path'
        )
    return dev


def window_merge_bank(
    slab: SketchBank,
    bank: SketchBank,
    nodes: torch.Tensor,
    valid: torch.Tensor,
    live: torch.Tensor,
    *,
    spec: BucketSpec,
) -> SketchBank:
    """A window query's merge: slab nodes plus the live bank -> one bank.

    Reads the ``(D,)`` ``nodes`` of the slab (``valid`` is their (D,) 0/1
    mask; padding entries point at node 0 and contribute nothing), then
    the live bank as one more slice gated by the 0-d ``live``, reconciles
    every slice row to the range's per-row max collapse level and sums the
    slice axis.  Returns a float32 ``SketchBank`` of the merged rows,
    bit-identical for integer-valued counts to merging the slices one by
    one with ``sketch_bank.merge``.

    The pos and neg stores ride ONE ``ops.bank_range_merge_nodes`` launch
    that reads the slab nodes and the live bank where they lie: no
    ``(D+1, 2K, m)`` block is gathered, and an int32 slab is converted as
    it is read.  The reference picks a steady-state sum or the reconciling
    merge with a ``lax.cond``; here the merge's delta-0 case is the steady
    sum, so no host read picks a branch.  The slice order is nodes
    ``0..D-1``, then the live bank (the reference's reconciliation order;
    its steady branch adds the live bank first, which matters for
    fractional counts only).  Only the small per-row leaves (levels and
    the six stats, ``(D+1, K)``) are gathered.
    """
    f32_ = torch.float32
    mask = torch.cat([valid.to(f32_).reshape(-1), live.to(f32_).reshape(1)])  # (D+1,)
    alive = mask > 0

    def stacked(node_leaf, bank_leaf):  # (D+1, K) float32
        return torch.cat([node_leaf.index_select(0, nodes).to(f32_), bank_leaf.to(f32_)[None]])

    lvl = torch.cat([slab.level.index_select(0, nodes), bank.level[None]])  # (D+1, K)
    target = torch.where(alive[:, None], lvl, 0).amax(0).to(torch.int32)  # (K,)
    pos, neg = ops.bank_range_merge_nodes(
        slab.pos, slab.neg, nodes, valid, bank.pos, bank.neg, live, target[None, :] - lvl,
        spec=spec,
    )

    def msum(node_leaf, bank_leaf):
        return (stacked(node_leaf, bank_leaf) * mask[:, None]).sum(0)

    def mext(node_leaf, bank_leaf, fill, red):
        return red(torch.where(alive[:, None], stacked(node_leaf, bank_leaf), fill), 0)

    return SketchBank(
        pos=pos,
        neg=neg,
        zero=msum(slab.zero, bank.zero),
        overflow=msum(slab.overflow, bank.overflow),
        underflow=msum(slab.underflow, bank.underflow),
        summ=msum(slab.summ, bank.summ),
        vmin=mext(slab.vmin, bank.vmin, float("inf"), torch.amin),
        vmax=mext(slab.vmax, bank.vmax, float("-inf"), torch.amax),
        level=target,
    )


def make_engine(
    spec: BucketSpec, num_sketches: int, *, num_shards: int | None = None, **kwargs
) -> "SketchEngine":
    """Engine factory: single-device for ``num_shards in (None, 1)``."""
    if num_shards is not None and int(num_shards) != 1:
        raise NotImplementedError(
            "row-sharded banks (num_shards > 1) are not ported yet "
            "(ROADMAP.md queue 1 item 10)"
        )
    return SketchEngine(spec, num_sketches, **kwargs)


class SketchEngine:
    """Call paths for one bank geometry (spec, K, counts dtype, device).

    Stateless with respect to the bank: banks are passed in and returned
    (updated in place), so one engine can drive many banks of the same
    geometry.  ``new_bank()`` mints a fresh one.
    """

    def __init__(
        self,
        spec: BucketSpec,
        num_sketches: int,
        *,
        counts_dtype=torch.float32,
        method: str | None = None,
        device="cuda",
    ):
        sbank._check_method(method)
        self.spec = spec
        self.num_sketches = int(num_sketches)
        self.counts_dtype = torch_sketch._counts_dtype(counts_dtype)
        self.method = method
        self.device = resolve_device(device)
        self._keys: set[tuple] = set()
        self._hits = 0
        self._misses = 0
        # host-side hooks fired at the top of every ingest tick (the
        # gateway's drain loop and fault injection observe ticks here)
        self.tick_hooks: list[Callable[[str], None]] = []

    def _note(self, key: tuple) -> None:
        """Count a (path, geometry) call for ``cache_info``."""
        if key in self._keys:
            self._hits += 1
        else:
            self._keys.add(key)
            self._misses += 1

    def cache_info(self) -> dict:
        return {"executables": len(self._keys), "hits": self._hits, "misses": self._misses}

    # ------------------------------------------------------------------ #
    # bank lifecycle
    # ------------------------------------------------------------------ #
    def new_bank(self) -> SketchBank:
        """Fresh zero bank in this engine's geometry, on its device."""
        return sbank.empty(
            self.spec, self.num_sketches, counts_dtype=self.counts_dtype, device=self.device
        )

    def host_rows(self, arr) -> np.ndarray:
        """A per-row tensor ((K,) or (K, Q)) as a host numpy array."""
        return sbank._host(arr)

    def host_bank(self, bank: SketchBank) -> SketchBank:
        """The whole bank as host numpy arrays (one transfer per leaf)."""
        return sbank.to_numpy(bank)

    def snapshot(self, state: SketchBank) -> SketchBank:
        """A copy of the bank (or slab) in fresh tensors.

        The read path's publish step: later in-place ticks, seals and node
        merges on ``state`` never touch the copy.  The clones are enqueued
        on the current stream, the same stream the in-place ingest runs on,
        so they read the state as of this call.
        """
        self._note(("snapshot", "slab" if state.pos.dim() == 3 else "bank"))
        return SketchBank(*(t.clone() for t in state))

    def reset(self, bank: SketchBank, levels=None) -> SketchBank:
        """Zero the bank in place, keeping (``levels=None``) or replacing
        (``(K,)`` int32) the per-row collapse levels."""
        self._note(("reset",))
        for t in bank[:6]:
            t.zero_()
        bank.vmin.fill_(float("inf"))
        bank.vmax.fill_(float("-inf"))
        if levels is not None:
            lv = torch.as_tensor(np.asarray(levels, np.int32))
            bank.level.copy_(lv.to(bank.level.device))
        return bank

    # ------------------------------------------------------------------ #
    # ingest (in place, fused with the reactive collapse)
    # ------------------------------------------------------------------ #
    def add(
        self, bank: SketchBank, values, sketch_ids, weights=None, *, auto_collapse=False
    ) -> SketchBank:
        """``sketch_bank.add_impl`` through the engine; the bank updates in
        place."""
        bank, _, _ = self.ingest(
            bank, values, sketch_ids, weights, auto_collapse=auto_collapse
        )
        return bank

    def _prep_batch(self, v: np.ndarray, s: np.ndarray, w):
        """Pad a host batch to the next power of two with inert lanes (NaN
        value / id -1 / weight 0) and move it to the device."""
        n = v.size
        pad = next_pow2(max(n, 1), _MIN_BATCH) - n
        if pad:
            v = np.pad(v, (0, pad), constant_values=np.nan)
            s = np.pad(s, (0, pad), constant_values=-1)
            if w is not None:
                w = np.pad(w, (0, pad))
        dev = self.device
        return (
            torch.from_numpy(v).to(dev),
            torch.from_numpy(s).to(dev),
            None if w is None else torch.from_numpy(w).to(dev),
            v.size,
        )

    def ingest(
        self,
        bank: SketchBank,
        values,
        sketch_ids,
        weights=None,
        *,
        threshold: float | None = None,
        auto_collapse: bool = False,
    ):
        """Add a batch, then reactive-collapse hot rows: ``(bank, fired,
        clamped)``, the bank updated in place.

        With ``threshold`` set, rows whose clamped mass (overflow +
        underflow after the add) exceeds it fold once and have their clamp
        counters reset; ``fired`` is the ``(K,)`` bool mask of rows that
        folded and ``clamped`` the mass each had clamped.  Both stay on the
        device until the caller reads them.  ``threshold=None`` skips the
        reactive pass and returns ``(bank, None, None)``.
        """
        if self.tick_hooks:
            for hook in self.tick_hooks:
                hook("ingest")
        v = np.asarray(values, np.float32).reshape(-1)
        s = np.asarray(sketch_ids, np.int32).reshape(-1)
        if v.shape != s.shape:
            raise ValueError(f"values {v.shape} vs sketch_ids {s.shape}")
        w = None if weights is None else np.asarray(weights, np.float32).reshape(-1)
        vv, ss, ww, geom = self._prep_batch(v, s, w)
        reactive = threshold is not None
        self._note(("ingest", geom, w is not None, reactive, auto_collapse))
        sbank.add_impl(
            bank, vv, ss, ww, spec=self.spec, auto_collapse=auto_collapse, method=self.method
        )
        if not reactive:
            return bank, None, None
        clamped = (bank.overflow + bank.underflow).to(torch.float32)
        fire = (clamped > f32(threshold)) & (bank.level < MAX_COLLAPSE_LEVEL)
        sbank.collapse(bank, fire, spec=self.spec)
        bank.overflow.masked_fill_(fire, 0)
        bank.underflow.masked_fill_(fire, 0)
        return bank, fire, clamped

    # ------------------------------------------------------------------ #
    # resolution management and merge (in place)
    # ------------------------------------------------------------------ #
    def collapse_to(self, bank: SketchBank, target) -> SketchBank:
        """``sketch_bank.collapse_to`` (scalar or ``(K,)`` target), in place."""
        self._note(("collapse_to",))
        tgt = torch.as_tensor(
            np.broadcast_to(np.asarray(target, np.int32), (self.num_sketches,)).copy()
        )
        return sbank.collapse_to(bank, tgt.to(self.device), spec=self.spec)

    def auto_collapse(self, bank: SketchBank, threshold: float = 0.0) -> SketchBank:
        """Reactive collapse (see ``sketch_bank.auto_collapse``), in place."""
        self._note(("auto_collapse",))
        return sbank.auto_collapse(bank, spec=self.spec, threshold=threshold)

    def merge(self, a: SketchBank, b: SketchBank) -> SketchBank:
        """``sketch_bank.merge``: ``a``'s tensors take the result."""
        self._note(("merge",))
        return sbank.merge(a, b, spec=self.spec)

    # ------------------------------------------------------------------ #
    # queries (read-only)
    # ------------------------------------------------------------------ #
    def quantiles(self, bank: SketchBank, qs) -> torch.Tensor:
        """Fused per-row quantiles ``(K, len(qs))``: one kernel launch."""
        qf = np.atleast_1d(np.asarray(qs, np.float32))
        self._note(("quantiles", qf.size))
        return sbank.quantiles_impl(bank, qf, spec=self.spec)

    def quantile(self, bank: SketchBank, q) -> torch.Tensor:
        """One quantile for every row, shape ``(K,)``."""
        return self.quantiles(bank, [q])[:, 0]

    def rollup_quantiles(self, bank: SketchBank, qs) -> torch.Tensor:
        """Quantiles of the union of every row, shape ``(len(qs),)``.

        Rows align to the bank-max level (folded into scratch copies, so the
        bank itself is untouched), sum into one bucket array (Algorithm 4 as
        a reduction over rows) and answer one query through the same fused
        kernel as ``quantiles``, with K = 1.  Exact for integer-weight
        counts.  One host sync reads how many folds the laggard rows need.
        """
        qf = np.atleast_1d(np.asarray(qs, np.float32))
        self._note(("rollup", qf.size))
        return self._rollup(bank, qf)

    def _rollup(self, bank: SketchBank, qf: np.ndarray) -> torch.Tensor:
        gmax = bank.level.max()
        pos, neg = bank.pos, bank.neg
        steps = int(gmax - bank.level.min()) if bank.level.numel() else 0
        level = bank.level
        for i in range(steps):
            rows = level < gmax
            pos = ops.fold_pairs(pos, spec=self.spec, rows=rows, out=None if i == 0 else pos)
            neg = ops.fold_pairs(neg, spec=self.spec, rows=rows, out=None if i == 0 else neg)
            level = level + rows.to(torch.int32)
        return ops.bank_quantiles(
            pos.to(torch.float32).sum(0, keepdim=True),
            neg.to(torch.float32).sum(0, keepdim=True),
            bank.zero.to(torch.float32).sum().reshape(1),
            bank.vmin.min().reshape(1),
            bank.vmax.max().reshape(1),
            gmax.reshape(1),
            qf,
            spec=self.spec,
        )[0]

    # ------------------------------------------------------------------ #
    # window-ring slab: stacked per-slice banks + fused range queries
    # ------------------------------------------------------------------ #
    def new_slab(self, num_nodes: int) -> SketchBank:
        """A bank of banks: every leaf gains a leading node axis of
        ``num_nodes`` (``engine.ring.WindowRing`` owns the node layout).
        Sealing, node merges and range queries work on it in place, so a
        ring's memory is one slab."""
        n, k, m = int(num_nodes), self.num_sketches, self.spec.num_buckets
        cd, dev = self.counts_dtype, self.device
        f = dict(dtype=torch.float32, device=dev)
        return SketchBank(
            pos=torch.zeros((n, k, m), dtype=cd, device=dev),
            neg=torch.zeros((n, k, m), dtype=cd, device=dev),
            zero=torch.zeros((n, k), dtype=cd, device=dev),
            overflow=torch.zeros((n, k), dtype=cd, device=dev),
            underflow=torch.zeros((n, k), dtype=cd, device=dev),
            summ=torch.zeros((n, k), **f),
            vmin=torch.full((n, k), float("inf"), **f),
            vmax=torch.full((n, k), float("-inf"), **f),
            level=torch.zeros((n, k), dtype=torch.int32, device=dev),
        )

    def seal_slice(self, slab: SketchBank, bank: SketchBank, node) -> SketchBank:
        """Copy ``bank`` into slab node ``node`` in place; the caller keeps
        the bank and recycles it through ``reset`` (levels surviving)."""
        self._note(("slab_seal", slab.level.shape[0]))
        i = int(node)
        for leaf, x in zip(slab, bank):
            leaf[i].copy_(x)
        return slab

    def merge_node(self, slab: SketchBank, dst, left, right) -> SketchBank:
        """``slab[dst] = merge(slab[left], slab[right])`` in place: the
        merge-tree step between two resident nodes.  ``dst`` takes a copy
        of ``left`` and then merges ``right`` in through views of the node;
        ``sketch_bank.merge`` aligns ``right`` on a copy, so neither child
        moves."""
        self._note(("slab_merge_node", slab.level.shape[0]))
        d, a, b = int(dst), int(left), int(right)
        for leaf in slab:
            leaf[d].copy_(leaf[a])
        sbank.merge(
            SketchBank(*(leaf[d] for leaf in slab)),
            SketchBank(*(leaf[b] for leaf in slab)),
            spec=self.spec,
        )
        return slab

    def _window_args(self, nodes, valid, include_live):
        dev = self.device
        nd = torch.as_tensor(np.asarray(nodes, np.int64).reshape(-1)).to(dev)
        vm = torch.as_tensor(np.asarray(valid, np.float32).reshape(-1)).to(dev)
        live = torch.tensor(1.0 if include_live else 0.0, device=dev)
        return nd, vm, live

    def window_query(
        self, slab: SketchBank, bank: SketchBank, nodes, valid, include_live, qs
    ) -> torch.Tensor:
        """Per-row quantiles over a slice range: ``(K, len(qs))``.

        ``nodes`` / ``valid`` are the ring's padded node cover of the range
        (``WindowRing.query_args``); ``include_live`` gates the live bank.
        One ``bank_range_merge`` launch and one fused query, whatever the
        window; the padded cover keeps one (path, geometry) key for every
        window size.  Reads slab and bank without changing them.
        """
        qf = np.atleast_1d(np.asarray(qs, np.float32))
        nd, vm, live = self._window_args(nodes, valid, include_live)
        self._note(("window_query", slab.level.shape[0], nd.numel(), qf.size))
        mb = window_merge_bank(slab, bank, nd, vm, live, spec=self.spec)
        return sbank.quantiles_impl(mb, qf, spec=self.spec)

    def window_rollup(
        self, slab: SketchBank, bank: SketchBank, nodes, valid, include_live, qs
    ) -> torch.Tensor:
        """Quantiles of every row over a slice range, shape ``(len(qs),)``:
        the window's range merge, then ``rollup_quantiles``' collapse to the
        max level, row sum and K = 1 query."""
        qf = np.atleast_1d(np.asarray(qs, np.float32))
        nd, vm, live = self._window_args(nodes, valid, include_live)
        self._note(("window_rollup", slab.level.shape[0], nd.numel(), qf.size))
        mb = window_merge_bank(slab, bank, nd, vm, live, spec=self.spec)
        return self._rollup(mb, qf)
