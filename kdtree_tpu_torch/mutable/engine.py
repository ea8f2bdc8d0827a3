"""The mutable index engine: LSM-style overlay + zero-downtime epochs.

The port of ``kdtree_tpu/mutable/engine.py``'s k-NN surface and write
path. ``MutableEngine`` wraps the serving facade
(:class:`~kdtree_tpu_torch.serve.engine.ServeEngine`) with a write path
while keeping every answer **exact at every moment**:

- **Upserts** land in a small brute-force :class:`DeltaBuffer`; if the
  id already exists in the main tree, the main copy is *masked*
  (tombstoned on the device flat storage — +inf coordinates, -1 id,
  exactly the padding convention every engine already prunes).
- **Deletes** drop the delta copy and mask the main copy.
- **Queries** run the tiled main-tree dispatch unchanged, then overlay:
  mask tombstoned ids out of the main hits, brute-force the delta buffer
  (the same path as the degradation fallback), and merge by the stable
  (distance, id) order. A row whose main top-k lost a masked hit is
  re-answered through the masked flat storage — the main survivors alone
  might be one candidate short at the k boundary — so the result is
  byte-identical to a rebuild-from-scratch index over the surviving
  points, always.
- **Verbs** (radius / range / count) overlay the same way: tombstoned
  hits are struck, delta hits brute-forced and unioned; a count answer
  subtracts the tombstoned points inside its region and adds the
  delta's.

A background **epoch rebuilder** compacts main+delta into a fresh Morton
tree once the write backlog (delta rows + tombstones) crosses the
configured threshold, pre-warms it, and swaps it in atomically between
batches: queries snapshot the epoch state per call, so an in-flight
batch finishes on the epoch it started on and the next batch runs on the
new one. Writes that arrive during a rebuild apply live AND append to a
journal that is replayed onto the new epoch before the swap. A primary
hands each new epoch's tree to its ``snapshot_sink`` after the swap (the
blue/green artifact), and a snapshot-following replica swaps in a loaded
tree through :meth:`MutableEngine.adopt_tree`.

Tombstones are copy-on-write: each mask batch builds NEW masked tensors
with the out-of-place ``Tensor.index_put`` (JAX's ``.at[].set``), never
an in-place write — the first masked tensors are views of the tree's own
storage, and a query's snapshot must keep seeing the arrays it took.

Threading model: one RLock serializes writers, epoch swaps, and the
per-query snapshot read; queries hold it only long enough to copy
references. All threads launch on the device's current (default) stream,
so their device work is ordered; nothing here synchronizes a stream or
captures a graph.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.mutable.delta import MIN_CAPACITY, DeltaBuffer
from kdtree_tpu_torch.mutable.merge import in_sorted, merge_rows
from kdtree_tpu_torch.obs import flight
from kdtree_tpu_torch.ops import bruteforce
from kdtree_tpu_torch.serve.engine import _pow2_ceil
from kdtree_tpu_torch.utils import locks

DEFAULT_MAX_DELTA_ROWS = 4096
DEFAULT_MAX_DELTA_FRAC = 0.25
MAX_ID = 2**31  # local ids must fit the engines' int32 gid storage
_CORRECTION_MIN_BUCKET = 8  # pow2 pad floor for the re-answer dispatch
# tombstone-scatter index widths: mask batches pad up to the next rung
# (repeating a position — the scatter is idempotent), so the write path
# cycles four index shapes, each run once off the engine lock at epoch
# construction: the write lock then never holds a first-use allocation
_MASK_PAD_BUCKETS = (8, 64, 512, 4096)
# the serve-latency family the rebuild-impact join reads from the
# history ring (one definition so the joiner and its test agree)
_REQUEST_LATENCY_KEY = 'kdtree_serve_request_seconds{phase="total"}'


def _mask_bucket(n: int) -> int:
    for b in _MASK_PAD_BUCKETS:
        if n <= b:
            return b
    return _pow2_ceil(n)


def rebuild_impact(
    history, t0_unix: float, t1_unix: float, quantile: float = 0.99,
    hist_key: str = _REQUEST_LATENCY_KEY,
) -> Optional[Dict]:
    """Epoch-rebuild impact on serving latency, joined through the
    metric-history ring: the request-latency ``quantile`` over the
    rebuild window ``[t0, t1]`` minus the same-width window immediately
    before it. None when either window lacks data (no sampler, no
    traffic, or a rebuild faster than two sample periods) — an absent
    measurement must read as absent, not as zero impact."""
    dur = float(t1_unix) - float(t0_unix)
    if dur <= 0:
        return None
    during = history.quantile(hist_key, quantile, window_s=dur,
                              now=t1_unix)
    before = history.quantile(hist_key, quantile, window_s=dur,
                              now=t0_unix)
    if during is None or before is None:
        return None
    return {
        "p99_before_ms": round(before * 1e3, 3),
        "p99_during_ms": round(during * 1e3, 3),
        "p99_delta_ms": round((during - before) * 1e3, 3),
        "window_s": round(dur, 3),
    }


class _EpochState:
    """Everything one epoch serves from. Queries snapshot references to
    these fields; writers replace the replaced-on-write fields (masked
    tensors, sorted-id arrays) instead of mutating them, so a snapshot
    taken before a write stays internally consistent."""

    def __init__(self, inner, epoch: int, min_cap: int) -> None:
        self.inner = inner
        self.epoch = int(epoch)
        self.n_main = int(inner.tree.n_real)
        self.delta = DeltaBuffer(inner.tree.dim, min_capacity=min_cap,
                                 device=inner.tree.device)
        self.dead: set = set()  # masked main ids: deleted or superseded
        self.dead_sorted = np.empty(0, dtype=np.int64)
        # the epoch's live bounding box, seeded from the tree's root
        # AABB and EXPANDED by every upsert so the published box is never
        # stale-exclusive of a delta point. Deletes never shrink it; the
        # next epoch's own root box is where deletions tighten it.
        self.box_lo = np.array(inner.box_lo, dtype=np.float32)
        self.box_hi = np.array(inner.box_hi, dtype=np.float32)
        # masked flat storage starts as the tree's own flat views; each
        # mask batch produces new tensors (copy-on-write, see apply_masks)
        self.masked_pts = inner._flat_pts
        self.masked_gid = inner._flat_gid
        # main id -> flat position, for masking and shadow detection:
        # sorted on the device, fetched once per EPOCH (construction /
        # rebuild thread), not per query or per write
        flat_gid = inner._flat_gid
        pos = torch.nonzero(flat_gid >= 0).reshape(-1)
        vals, order = torch.sort(flat_gid[pos], stable=True)
        self.gid_sorted = vals.cpu().numpy().astype(np.int64)
        self.gid_pos = pos[order].cpu().numpy()
        # both construction sites (engine bootstrap, rebuild thread) run
        # OFF the engine lock — exactly where first-use allocations belong
        self.warm_write_dispatch()

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Flat positions of main-tree ids (-1 where absent)."""
        if self.gid_sorted.size == 0:
            return np.full(ids.shape, -1, dtype=np.int64)
        idx = np.searchsorted(self.gid_sorted, ids)
        idx_c = np.minimum(idx, self.gid_sorted.size - 1)
        ok = (idx < self.gid_sorted.size) & (self.gid_sorted[idx_c] == ids)
        return np.where(ok, self.gid_pos[idx_c], -1)

    def _masked(self, positions: np.ndarray):
        idx = torch.from_numpy(positions).to(self.masked_pts.device)
        inf = torch.tensor(float("inf"), dtype=self.masked_pts.dtype,
                           device=self.masked_pts.device)
        neg = torch.tensor(-1, dtype=self.masked_gid.dtype,
                           device=self.masked_gid.device)
        # out of place: NEW tensors, so a snapshot holding the previous
        # ones (or the tree's own storage) is never written under it
        return (self.masked_pts.index_put((idx,), inf),
                self.masked_gid.index_put((idx,), neg))

    def apply_masks(self, positions: List[int]) -> None:
        """Tombstone flat rows: +inf coordinates (never selected while
        real candidates remain) and -1 ids (the padding id every
        downstream mask already drops). Launches only — no sync, safe
        under the engine lock.

        The index vector pads up to a ``_MASK_PAD_BUCKETS`` rung by
        repeating the first position (writing the same padding values to
        the same row twice is a no-op), so the write path cycles the
        handful of shapes :meth:`warm_write_dispatch` ran off the lock."""
        if not positions:
            return
        arr = np.array(positions, dtype=np.int64)
        bucket = _mask_bucket(arr.size)
        if bucket > arr.size:
            arr = np.concatenate(
                [arr, np.full(bucket - arr.size, arr[0], dtype=np.int64)]
            )
        self.masked_pts, self.masked_gid = self._masked(arr)

    def warm_write_dispatch(self) -> None:
        """Run every mask-scatter shape this epoch can dispatch once and
        discard the results — called from construction (bootstrap: main
        thread, pre-serving) and from the rebuild thread (new epochs),
        both OFF the engine lock. Out-of-place writes make the warm-up
        free of side effects."""
        for bucket in _MASK_PAD_BUCKETS:
            self._masked(np.zeros(bucket, dtype=np.int64))

    def refresh_dead(self) -> None:
        self.dead_sorted = np.array(sorted(self.dead), dtype=np.int64)

    def backlog(self) -> int:
        """Write backlog that the epoch rebuild compacts away: live
        delta rows, masked main rows, AND dropped delta slots (holes
        are garbage only a compaction reclaims — without counting them
        an upsert-then-delete churn workload would double the buffer
        forever while the gauge read ~0)."""
        return self.delta.rows + len(self.dead) + self.delta.holes


def _pad_cols(
    d2: np.ndarray, ids: np.ndarray, k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Widen a (d2, ids) answer to ``k`` columns with the engines'
    padding convention (+inf distance, -1 id). A no-op at full width."""
    w = d2.shape[1]
    if w >= k:
        return d2[:, :k], ids[:, :k]
    pad_d = np.full((d2.shape[0], k - w), np.inf, dtype=d2.dtype)
    pad_i = np.full((ids.shape[0], k - w), -1, dtype=ids.dtype)
    return (np.concatenate([d2, pad_d], axis=1),
            np.concatenate([ids, pad_i], axis=1))


class _Snapshot:
    """One query's consistent view of the epoch (plain references)."""

    __slots__ = ("inner", "epoch", "delta_rows", "delta_view",
                 "dead_sorted", "masked_pts", "masked_gid", "gid_sorted",
                 "gid_pos")

    def __init__(self, st: _EpochState) -> None:
        self.inner = st.inner
        self.epoch = st.epoch
        self.delta_rows = st.delta.rows
        self.delta_view = st.delta.view() if self.delta_rows else None
        self.dead_sorted = st.dead_sorted
        self.masked_pts = st.masked_pts
        self.masked_gid = st.masked_gid
        # the epoch's host id map (built once per epoch, never replaced):
        # the count overlay locates tombstoned main rows through it
        self.gid_sorted = st.gid_sorted
        self.gid_pos = st.gid_pos

    @property
    def empty(self) -> bool:
        return self.delta_rows == 0 and self.dead_sorted.size == 0


class MutableEngine:
    """The write-capable engine facade the serving stack dispatches
    through. Duck-compatible with
    :class:`~kdtree_tpu_torch.serve.engine.ServeEngine` (``tree``, ``k``,
    ``knn_batch``, ``fallback_knn``, the verbs, ``bounds``) plus the
    write path (``upsert``/``delete``), epoch introspection, the
    blue/green ``adopt_tree``, and ``close``."""

    def __init__(
        self,
        inner,
        max_delta_rows: int = DEFAULT_MAX_DELTA_ROWS,
        max_delta_frac: float = DEFAULT_MAX_DELTA_FRAC,
        requested_k: Optional[int] = None,
        epoch0: int = 0,
        snapshot_sink=None,
    ) -> None:
        self._lock = locks.make_rlock("mutable.engine")
        # epoch numbering continues from the snapshot this process booted
        # from: a primary restarted at epoch E compacts to E+1, and
        # followers comparing /healthz epochs see one monotone sequence
        self._epoch0 = int(epoch0)
        # called (tree, epoch) on the rebuild thread AFTER each swap — the
        # epoch compactor IS a snapshot build, so the primary emits the
        # artifact secondaries adopt. Never allowed to fail the swap that
        # already landed.
        self._snapshot_sink = snapshot_sink
        # the CONFIGURED k, not inner.k: the bootstrap ServeEngine clamps
        # k to its n_real, and pinning that clamp as the forever-k would
        # cap every future epoch at the seed index's size
        self._k_cfg = int(requested_k) if requested_k is not None \
            else int(inner.k)
        self._min_cap = max(MIN_CAPACITY, _pow2_ceil(self._k_cfg))
        self.max_delta_rows = int(max_delta_rows)
        self.max_delta_frac = float(max_delta_frac)
        # buckets the epoch rebuilder pre-warms on the NEW engine before
        # the swap (warmup records what it actually ran)
        self.warm_buckets: List[int] = []
        self._state = _EpochState(inner, epoch=self._epoch0,
                                  min_cap=self._min_cap)
        # epoch of the latest knn_batch answer
        self.last_answer_epoch = self._epoch0
        # gear facts of the latest answer (the ServeEngine surface): the
        # visit cap (None = exact) and its recall estimate
        self.last_visit_cap: Optional[int] = None
        self.last_recall_estimate: float = 1.0
        self._rebuilding = False
        # (dead_sorted identity, host coords) — see _dead_points
        self._dead_pts_cache: Optional[tuple] = None
        self._journal: Optional[List[tuple]] = None
        self._rebuild_thread: Optional[threading.Thread] = None
        self._closed = False
        reg = obs.get_registry()
        self._writes = {
            op: reg.counter("kdtree_mutable_writes_total",
                            labels={"op": op})
            for op in ("upsert", "delete")
        }
        self._rebuilds = reg.counter("kdtree_mutable_rebuilds_total")
        self._corrections = reg.counter("kdtree_mutable_corrections_total")
        self._g_epoch = reg.gauge("kdtree_epoch")
        self._g_delta = reg.gauge("kdtree_mutable_delta_rows")
        self._g_tomb = reg.gauge("kdtree_mutable_tombstones")
        self._g_headroom = reg.gauge("kdtree_mutable_delta_headroom")
        self._update_gauges(self._state)
        # construction runs before serving and outside the lock: the
        # right moment to run the overlay's correction dispatch once
        self._warm_overlay(self._state)

    # -- ServeEngine-compatible surface -------------------------------------

    @property
    def tree(self):
        return self._state.inner.tree

    @property
    def k(self) -> int:
        """The CONFIGURED k — stable across deletes and epoch swaps:
        answers for k beyond the live point count pad with (+inf, -1),
        exactly what a fresh undersized index answers."""
        return self._k_cfg

    @property
    def k_effective(self) -> int:
        """How many real (non-padding) neighbors a query can currently
        get: min(configured k, live point count)."""
        with self._lock:
            st = self._state
            live = st.n_main - len(st.dead) + st.delta.rows
        return max(0, min(self._k_cfg, live))

    @property
    def epoch(self) -> int:
        return self._state.epoch

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """The live bounding box /healthz publishes: the current epoch's
        root AABB expanded by every delta upsert."""
        with self._lock:
            st = self._state
            return st.box_lo.copy(), st.box_hi.copy()

    def warmup(self, buckets: List[int]) -> None:
        """The serving warmup ladder on the current epoch's engine, k-NN
        and verbs (the overlay of a new server is empty, a passthrough);
        the epoch rebuilder and :meth:`adopt_tree` run its k-NN rungs on
        each new epoch before its swap."""
        self.warm_buckets = list(buckets)
        self._snapshot().inner.warmup(self.warm_buckets, verbs=True)

    def _snapshot(self) -> _Snapshot:
        with self._lock:
            return _Snapshot(self._state)

    def knn_batch(
        self, queries: np.ndarray,
        recall_target: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray, str]:
        """k-NN for one padded micro-batch: the main-tree dispatch (exact,
        or bounded-visit under a ``recall_target``, forwarded to the inner
        engine's dial), overlaid with the delta buffer and tombstone
        masks. The overlay is always exact, so an approximate answer's
        recall comes only from the main tree's bounded visit. With an
        empty overlay and no target this is a pure passthrough — byte for
        byte the immutable serving path."""
        snap = self._snapshot()
        d2, ids, source = snap.inner.knn_batch(queries, recall_target)
        # gear facts mirror the ANSWERING inner engine's (the snapshot's)
        self.last_visit_cap = snap.inner.last_visit_cap
        self.last_recall_estimate = snap.inner.last_recall_estimate
        # which epoch ANSWERED this call — the snapshot's, not whatever
        # self.epoch reads after a concurrent swap (the batch worker is
        # the only steady-state caller)
        self.last_answer_epoch = snap.epoch
        # an epoch smaller than the configured k dispatches at its own
        # clamped width; pad back up so the serving contract (k columns)
        # holds regardless of the current epoch's size
        d2, ids = _pad_cols(d2, ids, self._k_cfg)
        if snap.empty:
            return d2, ids, source
        return self._overlay(queries, d2, ids, snap) + (source,)

    def fallback_knn(
        self, queries: np.ndarray, k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The degradation path, mutable-aware: masked flat storage plus
        delta, merged — exact over the surviving points."""
        k = min(int(k), self._k_cfg)
        snap = self._snapshot()
        if snap.empty:
            d2, ids = snap.inner.fallback_knn(queries, k)
            return _pad_cols(d2, ids, k)
        d2, ids = self._masked_main_knn(queries, snap, k)
        if snap.delta_rows:
            dd2, dids = self._delta_knn(queries, snap, k)
            d2 = np.concatenate([d2, dd2], axis=1)
            ids = np.concatenate([ids, dids], axis=1)
        d2, ids = merge_rows(d2, ids, k)
        return _pad_cols(d2, ids, k)

    # -- query verbs (radius / range / count) --------------------------------

    def radius_batch(
        self, queries: np.ndarray, r: np.ndarray,
        recall_target: Optional[float] = None, with_ids: bool = True,
    ):
        """Radius (or radius-count) with the write overlay: the main
        tree's pruned answer, minus tombstoned hits, plus delta hits —
        exact over the surviving points."""
        snap = self._snapshot()
        res = snap.inner.radius_batch(queries, r, recall_target,
                                      with_ids=with_ids)
        self.last_visit_cap = snap.inner.last_visit_cap
        self.last_recall_estimate = snap.inner.last_recall_estimate
        self.last_answer_epoch = snap.epoch
        if snap.empty:
            return res
        return self._verb_overlay("radius", res, snap, queries=queries,
                                  r=r, with_ids=with_ids)

    def range_batch(
        self, box_lo: np.ndarray, box_hi: np.ndarray,
        recall_target: Optional[float] = None, with_ids: bool = True,
    ):
        """Box-range (or box-count) with the write overlay — same
        contract as :meth:`radius_batch`."""
        snap = self._snapshot()
        res = snap.inner.range_batch(box_lo, box_hi, recall_target,
                                     with_ids=with_ids)
        self.last_visit_cap = snap.inner.last_visit_cap
        self.last_recall_estimate = snap.inner.last_recall_estimate
        self.last_answer_epoch = snap.epoch
        if snap.empty:
            return res
        return self._verb_overlay("range", res, snap, box_lo=box_lo,
                                  box_hi=box_hi, with_ids=with_ids)

    def fallback_radius(self, queries: np.ndarray, r: np.ndarray,
                        with_ids: bool = True):
        """The verb degradation path, mutable-aware: brute force over
        the tombstone-masked flat storage (masked rows carry +inf
        coords / -1 ids and self-exclude) merged with the delta — exact
        over the surviving points."""
        from kdtree_tpu_torch.verbs import device as verb_device
        from kdtree_tpu_torch.verbs import oracle as verb_oracle

        snap = self._snapshot()
        if snap.empty:
            return snap.inner.fallback_radius(queries, r, with_ids=with_ids)
        main = verb_oracle.radius_oracle(snap.masked_pts, queries, r,
                                         gid=snap.masked_gid,
                                         with_ids=with_ids)
        if not snap.delta_rows:
            return main
        return verb_device.merge_results(
            "radius", main,
            self._delta_verb("radius", snap, queries=queries, r=r,
                             with_ids=with_ids))

    def fallback_range(self, box_lo: np.ndarray, box_hi: np.ndarray,
                       with_ids: bool = True):
        """Brute-force box-range over masked storage + delta."""
        from kdtree_tpu_torch.verbs import device as verb_device
        from kdtree_tpu_torch.verbs import oracle as verb_oracle

        snap = self._snapshot()
        if snap.empty:
            return snap.inner.fallback_range(box_lo, box_hi,
                                             with_ids=with_ids)
        main = verb_oracle.range_oracle(snap.masked_pts, box_lo, box_hi,
                                        gid=snap.masked_gid,
                                        with_ids=with_ids)
        if not snap.delta_rows:
            return main
        return verb_device.merge_results(
            "range", main,
            self._delta_verb("range", snap, box_lo=box_lo, box_hi=box_hi,
                             with_ids=with_ids))

    def _verb_overlay(self, kind: str, res, snap: _Snapshot, *,
                      queries=None, r=None, box_lo=None, box_hi=None,
                      with_ids: bool = True):
        """Correct a main-tree verb answer for writes.

        Id-materializing form: tombstoned hits are struck from the
        buffers (and the counts — verb results are not k-capped, so
        unlike k-NN no replacement fetch is ever needed), delta hits are
        brute-forced and unioned, rows re-canonicalized.

        Count form (no ids to strike by): main count minus the dead
        points inside the region (their coordinates gathered once per
        write generation and cached) plus the delta's count."""
        from kdtree_tpu_torch.verbs import device as verb_device
        from kdtree_tpu_torch.verbs import oracle as verb_oracle
        from kdtree_tpu_torch.verbs.device import VerbResult

        if not with_ids:
            counts = res.counts.copy()
            dead_pts = self._dead_points(snap)
            if dead_pts is not None:
                if kind == "radius":
                    dw = verb_oracle.radius_count_oracle(dead_pts, queries, r)
                else:
                    dw = verb_oracle.range_count_oracle(dead_pts, box_lo,
                                                        box_hi)
                counts = np.maximum(counts - dw, 0)
            if snap.delta_rows:
                counts = counts + self._delta_verb(
                    kind, snap, queries=queries, r=r, box_lo=box_lo,
                    box_hi=box_hi, with_ids=False).counts
            return VerbResult(counts, None, None, res.truncated,
                              res.retries)
        counts = res.counts.copy()
        ids = res.ids.copy()
        d2 = res.d2.copy() if res.d2 is not None else None
        if snap.dead_sorted.size:
            hit = in_sorted(snap.dead_sorted, ids)
            if hit.any():
                counts = counts - hit.sum(axis=1)
                ids[hit] = -1
                if d2 is not None:
                    d2[hit] = np.inf
        if kind == "radius":
            cd2, cids = verb_device.canonical_radius_rows(d2, ids)
            out = VerbResult(counts, cd2, cids, res.truncated, res.retries)
        else:
            out = VerbResult(counts, None,
                             verb_device.canonical_range_rows(ids),
                             res.truncated, res.retries)
        if snap.delta_rows:
            out = verb_device.merge_results(
                kind, out,
                self._delta_verb(kind, snap, queries=queries, r=r,
                                 box_lo=box_lo, box_hi=box_hi,
                                 with_ids=True))
        return verb_device.trim_result(out)

    def _delta_verb(self, kind: str, snap: _Snapshot, *, queries=None,
                    r=None, box_lo=None, box_hi=None,
                    with_ids: bool = True):
        """Exact verb answer over the delta buffer — dropped slots hold
        +inf coords / -1 gid and self-exclude, the same convention as
        the k-NN delta scan."""
        from kdtree_tpu_torch.verbs import oracle as verb_oracle

        dev_pts, gid_host = snap.delta_view
        if kind == "radius":
            return verb_oracle.radius_oracle(dev_pts, queries, r,
                                             gid=gid_host,
                                             with_ids=with_ids)
        return verb_oracle.range_oracle(dev_pts, box_lo, box_hi,
                                        gid=gid_host, with_ids=with_ids)

    def _dead_points(self, snap: _Snapshot) -> Optional[torch.Tensor]:
        """Device coordinates of the tombstoned main rows, for the count
        overlay's subtraction. Gathered once per write generation — the
        write path replaces ``dead_sorted`` (never mutates it), so the
        array's identity keys the cache."""
        ds = snap.dead_sorted
        if ds.size == 0:
            return None
        cached = self._dead_pts_cache
        if cached is not None and cached[0] is ds:
            return cached[1]
        idx = np.searchsorted(snap.gid_sorted, ds)
        idx_c = np.minimum(idx, max(snap.gid_sorted.size - 1, 0))
        ok = (idx < snap.gid_sorted.size) & (snap.gid_sorted[idx_c] == ds)
        pos = torch.from_numpy(snap.gid_pos[idx_c][ok].astype(np.int64))
        flat = snap.inner._flat_pts
        pts = flat[pos.to(flat.device)]
        self._dead_pts_cache = (ds, pts)
        return pts

    # -- query overlay -------------------------------------------------------

    def _overlay(
        self, queries: np.ndarray, d2: np.ndarray, ids: np.ndarray,
        snap: _Snapshot,
    ) -> Tuple[np.ndarray, np.ndarray]:
        kk = d2.shape[1]
        # copy so masking never mutates a buffer the caller may still hold
        d2 = d2.copy()
        ids = ids.copy()
        contaminated = None
        if snap.dead_sorted.size:
            hit = in_sorted(snap.dead_sorted, ids)
            if hit.any():
                contaminated = hit.any(axis=1)
                d2[hit] = np.inf
                ids[hit] = -1
        dd2 = dids = None
        if snap.delta_rows:
            dd2, dids = self._delta_knn(queries, snap, kk)
            d2 = np.concatenate([d2, dd2], axis=1)
            ids = np.concatenate([ids, dids], axis=1)
        d2, ids = merge_rows(d2, ids, kk)
        if contaminated is not None and contaminated.any():
            # a masked hit inside a row's main top-k means the main
            # survivors may be short exactly at the k boundary: the
            # masked slot's replacement (the true (k+1)-th main point)
            # was never fetched. Re-answer those rows over the masked
            # flat storage — exact by construction — and re-merge.
            nrows = int(contaminated.sum())
            self._corrections.inc(nrows)
            sub = queries[contaminated]
            fd2, fids = self._masked_main_knn_padded(sub, snap, kk)
            if dd2 is not None:
                fd2 = np.concatenate([fd2, dd2[contaminated]], axis=1)
                fids = np.concatenate([fids, dids[contaminated]], axis=1)
            cd2, cids = merge_rows(fd2, fids, kk)
            # fewer surviving candidates than kk pad back to full width
            cd2, cids = _pad_cols(cd2, cids, kk)
            d2[contaminated] = cd2
            ids[contaminated] = cids
        return d2, ids

    def _delta_knn(
        self, queries: np.ndarray, snap: _Snapshot, k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over the padded delta buffer — the same brute
        force and padding convention as the flat-storage degradation
        path, so +inf slots come back as (inf, -1) and sort last."""
        dev_pts, gid_host = snap.delta_view
        kk = min(int(k), dev_pts.shape[0])
        d2, idx = bruteforce.knn(dev_pts, queries, k=kk)
        # the response boundary of the overlay: delta hits merge on the
        # host with the already-fetched main hits
        d2 = d2.cpu().numpy()
        idx = idx.cpu().numpy()
        ids = np.where(idx >= 0, gid_host[np.maximum(idx, 0)], -1)
        return d2, ids.astype(np.int32)

    def _masked_main_knn(
        self, queries: np.ndarray, snap: _Snapshot, k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over the tombstone-masked flat storage (masked
        rows carry +inf coords / -1 ids — identical to padding)."""
        kk = min(int(k), snap.masked_pts.shape[0])
        d2, idx = bruteforce.knn(snap.masked_pts, queries, k=kk)
        gids = torch.where(idx >= 0,
                           snap.masked_gid[idx.long().clamp_min(0)], -1)
        return d2.cpu().numpy(), gids.cpu().numpy()

    def _masked_main_knn_padded(
        self, sub: np.ndarray, snap: _Snapshot, k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The correction dispatch, pow2-padded so steady-state
        contamination cycles a handful of shapes — the batcher's own
        quantization trick."""
        rows = sub.shape[0]
        bucket = _pow2_ceil(max(rows, _CORRECTION_MIN_BUCKET))
        if bucket > rows:
            pad = np.broadcast_to(sub[-1], (bucket - rows, sub.shape[1]))
            sub = np.concatenate([sub, pad], axis=0)
        d2, ids = self._masked_main_knn(sub, snap, k)
        return d2[:rows], ids[:rows]

    # -- the write path ------------------------------------------------------

    @staticmethod
    def _check_write(ids: np.ndarray,
                     points: Optional[np.ndarray]) -> np.ndarray:
        ids = ids.astype(np.int64, copy=False).reshape(-1)
        if ids.size == 0:
            raise ValueError("write needs at least one id")
        if ids.min() < 0 or ids.max() >= MAX_ID:
            raise ValueError(
                f"point ids must be in [0, {MAX_ID}) — the engines store "
                "ids as int32"
            )
        if len(np.unique(ids)) != ids.size:
            raise ValueError("duplicate ids in one write request")
        if points is not None and (
            points.ndim != 2 or points.shape[0] != ids.size
        ):
            raise ValueError(
                f"points must be [{ids.size}, D] to match ids, got "
                f"{points.shape}"
            )
        return ids

    def upsert(self, ids: np.ndarray, points: np.ndarray) -> Dict:
        """Insert or update points (validated host arrays: int ids,
        f32[m, D] finite coordinates). Existing main-tree copies of the
        ids are masked; the delta copy is authoritative from now until
        the next epoch compacts it into the main tree."""
        points = points.astype(np.float32, copy=False)
        with self._lock:
            if self._closed:
                raise RuntimeError("mutable engine is closed")
            ids = self._check_write(ids, points)
            if points.shape[1] != self._state.inner.tree.dim:
                raise ValueError(
                    f"points are {points.shape[1]}-D but the index is "
                    f"{self._state.inner.tree.dim}-D"
                )
            st = self._state
            res = self._apply_upsert(st, ids, points)
            if self._journal is not None:
                self._journal.append(("upsert", ids.copy(), points.copy()))
            self._writes["upsert"].inc(ids.size)
            flight.record("mutable.upsert", ids=int(ids.size),
                          fresh=res["fresh"], epoch=st.epoch,
                          delta_rows=st.delta.rows)
            self._update_gauges(st)
            self._maybe_rebuild(st)
            return self._write_report(st, res)

    def delete(self, ids: np.ndarray) -> Dict:
        """Delete points by id: masks main copies, drops delta copies.
        Unknown ids are counted but not an error (idempotent)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("mutable engine is closed")
            ids = self._check_write(ids, None)
            st = self._state
            res = self._apply_delete(st, ids)
            if self._journal is not None:
                self._journal.append(("delete", ids.copy(), None))
            self._writes["delete"].inc(ids.size)
            flight.record("mutable.delete", ids=int(ids.size),
                          applied=res["applied"], epoch=st.epoch,
                          tombstones=len(st.dead))
            self._update_gauges(st)
            self._maybe_rebuild(st)
            return self._write_report(st, res)

    def _apply_upsert(self, st: _EpochState, ids: np.ndarray,
                      points: np.ndarray) -> Dict:
        # expand the epoch's box FIRST: a /healthz probe racing this write
        # may publish the grown box before the delta row serves, never
        # the reverse
        st.box_lo = np.minimum(st.box_lo, points.min(axis=0))
        st.box_hi = np.maximum(st.box_hi, points.max(axis=0))
        pos = st.lookup(ids)
        fresh = 0
        masks: List[int] = []
        for i, gid in enumerate(ids.tolist()):
            if st.delta.put(gid, points[i]):
                fresh += 1
            if pos[i] >= 0 and gid not in st.dead:
                # the id already lives in the main tree: shadow that
                # copy — the delta row is now the authoritative one
                st.dead.add(gid)
                masks.append(int(pos[i]))
        st.apply_masks(masks)
        st.delta.refresh()
        st.refresh_dead()
        return {"applied": int(ids.size), "fresh": fresh,
                "updated": int(ids.size) - fresh}

    def _apply_delete(self, st: _EpochState, ids: np.ndarray) -> Dict:
        pos = st.lookup(ids)
        applied = 0
        masks: List[int] = []
        for i, gid in enumerate(ids.tolist()):
            was_delta = st.delta.drop(gid)
            newly_dead = False
            if pos[i] >= 0 and gid not in st.dead:
                st.dead.add(gid)
                masks.append(int(pos[i]))
                newly_dead = True
            if was_delta or newly_dead:
                applied += 1
        st.apply_masks(masks)
        st.delta.refresh()
        st.refresh_dead()
        return {"applied": applied}

    def _write_report(self, st: _EpochState, res: Dict) -> Dict:
        out = dict(res)
        out.update(
            delta_rows=st.delta.rows,
            tombstones=len(st.dead),
            backlog=st.backlog(),
            epoch=st.epoch,
            rebuilding=self._rebuilding,
            threshold=self.rebuild_threshold(st),
        )
        return out

    # -- epoch rebuild -------------------------------------------------------

    def rebuild_threshold(
        self, st: Optional[_EpochState] = None,
    ) -> Optional[int]:
        """Backlog size that triggers a compaction: the tighter of the
        absolute row cap and the fraction-of-main cap; None when both
        knobs are disabled (<= 0) — writes then accumulate forever."""
        st = st if st is not None else self._state
        cands = []
        if self.max_delta_rows > 0:
            cands.append(self.max_delta_rows)
        if self.max_delta_frac > 0:
            cands.append(max(1, int(self.max_delta_frac * st.n_main)))
        return min(cands) if cands else None

    def _update_gauges(self, st: _EpochState) -> None:
        self._g_epoch.set(st.epoch)
        self._g_delta.set(st.delta.rows)
        self._g_tomb.set(len(st.dead))
        thr = self.rebuild_threshold(st)
        self._g_headroom.set(
            1.0 if thr is None else max(0.0, 1.0 - st.backlog() / thr)
        )

    def _maybe_rebuild(self, st: _EpochState) -> None:
        """(Holding the lock.) Kick the background compaction when the
        backlog crosses the threshold — at most one rebuild in flight,
        so one overflow triggers exactly one rebuild."""
        thr = self.rebuild_threshold(st)
        if thr is None or st.backlog() < thr:
            return
        if self._rebuilding or self._closed:
            return
        self._rebuilding = True
        self._journal = []
        delta_pts, delta_ids = st.delta.items()
        dead = set(st.dead)
        flight.record("mutable.rebuild_start", epoch=st.epoch,
                      backlog=st.backlog(), threshold=thr)
        self._rebuild_thread = threading.Thread(
            target=self._rebuild_worker, args=(st, delta_pts, delta_ids,
                                               dead),
            name="kdtree-mutable-rebuild", daemon=True,
        )
        self._rebuild_thread.start()

    def _rebuild_worker(self, old: _EpochState, delta_pts: np.ndarray,
                        delta_ids: np.ndarray, dead: set) -> None:
        t0_unix = time.time()
        try:
            with obs.span("mutable.rebuild", sync=False, epoch=old.epoch,
                          delta_rows=int(delta_ids.size),
                          tombstones=len(dead)):
                new_st = self._compact(old, delta_pts, delta_ids, dead)
                with self._lock:
                    journal = self._journal or []
                    for op, ids, pts in journal:
                        if op == "upsert":
                            self._apply_upsert(new_st, ids, pts)
                        else:
                            self._apply_delete(new_st, ids)
                    self._state = new_st
                    self._journal = None
                    self._rebuilding = False
                    self._rebuilds.inc()
                    self._update_gauges(new_st)
                    flight.record(
                        "mutable.epoch_swap", epoch=new_st.epoch,
                        n=new_st.n_main, replayed=len(journal),
                        delta_rows=new_st.delta.rows,
                        tombstones=len(new_st.dead),
                    )
            # the rebuild's wall cost lands in the maintenance side of the
            # cost ledger: epochs are not free even though no request pays
            from kdtree_tpu_torch.obs import costs as costs_mod

            costs_mod.count_rebuild((time.time() - t0_unix) * 1e3)
            # a compaction IS a snapshot build: emit the new epoch's
            # artifact for blue/green secondaries (off the lock, on this
            # thread — the swap already landed, so serving never waits on
            # the disk write)
            self._emit_snapshot(new_st)
            # rebuild-overlap serving impact, joined through the history
            # ring AFTER the swap (off the lock, on this thread)
            self._note_rebuild_impact(old.epoch, new_st.epoch, t0_unix,
                                      time.time())
            with self._lock:
                # journal replay may have re-crossed the threshold (a
                # write flood during the rebuild); evaluate once more
                self._maybe_rebuild(self._state)
        except Exception as e:  # a failed rebuild must not kill serving
            flight.record("mutable.rebuild_error", error=repr(e)[:200],
                          epoch=old.epoch)
            flight.auto_dump("mutable-rebuild-error")
            with self._lock:
                self._rebuilding = False
                self._journal = None

    def _compact(self, old: _EpochState, delta_pts: np.ndarray,
                 delta_ids: np.ndarray, dead: set) -> _EpochState:
        """Build the next epoch: surviving main rows (in flat order) +
        delta rows into a fresh Morton tree (original ids preserved
        through the ``morton_view`` gid mapping), pre-warmed before
        anyone serves from it. Runs on the rebuild thread, on the tree's
        device."""
        from kdtree_tpu_torch.ops.morton import morton_view
        from kdtree_tpu_torch.serve.engine import ServeEngine

        t = old.inner.tree
        dev = t.device
        flat_pts = t.bucket_pts.reshape(-1, t.dim)
        flat_gid = t.bucket_gid.reshape(-1)
        dead_t = torch.tensor(sorted(dead), dtype=flat_gid.dtype, device=dev)
        alive = (flat_gid >= 0) & ~torch.isin(flat_gid, dead_t)
        pts = torch.cat([flat_pts[alive],
                         torch.from_numpy(delta_pts).to(dev)])
        ids = torch.cat([flat_gid[alive],
                         torch.from_numpy(delta_ids.astype(np.int32)).to(dev)])
        if ids.numel() == 0:
            raise RuntimeError(
                "refusing to compact to an empty index — the last point "
                "was deleted; keep serving the overlay instead"
            )
        new_tree = morton_view(pts, gid=ids, n_real=int(ids.numel()))
        new_inner = ServeEngine(new_tree, self._k_cfg)
        # the new epoch's batch shapes run once BEFORE the swap (the
        # serving warmup ladder's dummy batches)
        new_inner.warmup(list(self.warm_buckets))
        new_st = _EpochState(new_inner, epoch=old.epoch + 1,
                             min_cap=self._min_cap)
        self._warm_overlay(new_st)
        return new_st

    def _warm_overlay(self, st: _EpochState) -> None:
        """Run the overlay's correction dispatch (the masked-storage
        brute-force re-answer at its minimum pow2 bucket) once, off the
        serving path; results are discarded. Never raises: warming
        observes the epoch, it must not fail its construction."""
        try:
            dim = st.inner.tree.dim
            q = torch.zeros((_CORRECTION_MIN_BUCKET, dim), dtype=torch.float32)
            kk = max(1, min(self._k_cfg, int(st.masked_pts.shape[0])))
            bruteforce.knn(st.masked_pts, q, k=kk)
        except Exception:
            pass

    def _emit_snapshot(self, st: _EpochState) -> None:
        """Hand the new epoch's tree to the snapshot sink (rebuild
        thread, off the lock). A failed emit is an incident for the
        fleet's convergence — counted and flight-dumped — but never
        undoes the in-process swap that already serves."""
        if self._snapshot_sink is None:
            return
        try:
            self._snapshot_sink(st.inner.tree, st.epoch)
        except Exception as e:
            obs.get_registry().counter(
                "kdtree_snapshot_sink_errors_total").inc()
            flight.record("snapshot.sink_error", epoch=st.epoch,
                          error=repr(e)[:200])
            flight.auto_dump("snapshot-sink-error")

    def adopt_tree(self, tree, epoch: int) -> None:
        """Blue/green handoff for snapshot-following read replicas
        (``snapshot/follower.py``): wrap a freshly loaded tree in a new
        epoch state, run its k-NN warmup rungs on the CALLING thread (the
        first use of every batch shape stays off the serving path — the
        epoch rebuilder's own discipline), then swap atomically between
        batches. The configured k is preserved across the swap.

        A follower replica is read-only, so the overlay it discards is
        empty; if local writes somehow exist, the adoption wins — the
        snapshot is the shard's authoritative state — and the discarded
        backlog is flight-recorded rather than silently dropped."""
        from kdtree_tpu_torch.serve.engine import ServeEngine

        new_inner = ServeEngine(tree, self._k_cfg)
        new_inner.warmup(list(self.warm_buckets))
        new_st = _EpochState(new_inner, epoch=int(epoch),
                             min_cap=self._min_cap)
        self._warm_overlay(new_st)
        with self._lock:
            if self._closed:
                return
            discarded = self._state.backlog()
            self._state = new_st
            self._update_gauges(new_st)
            flight.record("snapshot.adopt", epoch=new_st.epoch,
                          n=new_st.n_main, discarded_backlog=discarded)

    def _note_rebuild_impact(self, old_epoch: int, new_epoch: int,
                             t0_unix: float, t1_unix: float) -> None:
        """Publish the rebuild window's p99 delta (gauge + flight event)
        — runs on the rebuild thread, never raises."""
        try:
            from kdtree_tpu_torch.obs import history as obs_history

            impact = rebuild_impact(obs_history.get_history(), t0_unix,
                                    t1_unix)
            if impact is not None:
                # registered LAZILY, only once a delta was measured: a
                # gauge that exports 0 before any rebuild ever ran would
                # read as "measured, no impact" on every scrape
                obs.get_registry().gauge(
                    "kdtree_mutable_rebuild_p99_delta_ms"
                ).set(impact["p99_delta_ms"])
            flight.record(
                "mutable.rebuild_impact", epoch=new_epoch,
                previous_epoch=old_epoch,
                duration_ms=round((t1_unix - t0_unix) * 1e3, 3),
                **(impact if impact is not None
                   else {"p99_delta_ms": None}),
            )
        except Exception:
            pass

    # -- lifecycle / introspection ------------------------------------------

    def stats(self) -> Dict:
        """The /healthz "mutable" block."""
        with self._lock:
            st = self._state
            return {
                "epoch": st.epoch,
                "n": st.inner.tree.n_real,
                "delta_rows": st.delta.rows,
                "tombstones": len(st.dead),
                "backlog": st.backlog(),
                "rebuilding": self._rebuilding,
                "threshold": self.rebuild_threshold(st),
                "k_configured": self._k_cfg,
                "k_effective": self.k_effective,
            }

    def close(self, timeout_s: float = 120.0) -> None:
        """Stop accepting writes and join any in-flight rebuild — the
        serving shutdown path calls this so a drain never races an
        epoch swap."""
        with self._lock:
            self._closed = True
            t = self._rebuild_thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)
