"""Serving lifecycle: the engine facade, the serving state, startup.

The port of ``kdtree_tpu/serve/lifecycle.py``: ``ServeEngine``
(``knn_batch`` — exact, or bounded-visit under a ``recall_target`` — the
verbs' ``radius_batch``/``range_batch``, the
brute-force ``fallback_knn``/``fallback_radius``/``fallback_range``, the
root-box ``bounds``, the warmup ladder), ``ServeState`` (what the HTTP
layer reads: engine, knobs, readiness, the read-only flag),
``tree_for_serving`` and ``build_state``, with ``batch_bucket`` from
``serve/batcher.py``.

Startup does the expensive things once, before the first request can
observe them: load or build the index on the device, wrap it in the
write-capable :class:`~kdtree_tpu_torch.mutable.engine.MutableEngine`,
and run one dummy batch per pow2 row bucket (k-NN and each verb) —
``/healthz`` turns ready only after that, so the first real batch of
every shape finds its kernels built and its allocations made. Every
micro-batch is one tiled dispatch on the tree's device; results come back
to the host here, at the response boundary, so the batcher and HTTP
layers stay host code.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from kdtree_tpu_torch import obs, resolve_device
from kdtree_tpu_torch.obs import flight
from kdtree_tpu_torch.obs import history as obs_history
from kdtree_tpu_torch.obs import slo as obs_slo
from kdtree_tpu_torch.models.tree import KDTree
from kdtree_tpu_torch.ops import bruteforce
from kdtree_tpu_torch.ops.morton import MortonTree, morton_view
from kdtree_tpu_torch.ops.tile_query import (TileStats, morton_knn_tiled,
                                             plan_tiled)

MIN_BUCKET = 8  # smallest padded batch: sub-8-row traffic shares one shape
REQUEST_TIMEOUT_S = 60.0  # a queued request's wait for its batch


def _pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def batch_bucket(rows: int, max_batch: int, min_bucket: int = MIN_BUCKET) -> int:
    """The padded row count a ``rows``-row batch dispatches at: pow2-ceil
    with a floor, capped at ``max_batch``."""
    return min(_pow2_ceil(max(rows, min_bucket)), max_batch)


def warmup_buckets(max_batch: int, min_bucket: int = MIN_BUCKET) -> List[int]:
    """The pow2 row buckets a server warms, from the smallest to
    ``max_batch`` (itself rounded up to a power of two)."""
    max_batch = _pow2_ceil(max_batch)
    b = batch_bucket(1, max_batch, min_bucket)
    buckets = []
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return buckets


def ladder_batch(tree: MortonTree, rows: int) -> np.ndarray:
    """The warmup ladder's dummy batch: ``rows`` points spread along the
    diagonal of the tree's root box — real coordinates, representative
    tile geometry, deterministic (the reference's construction)."""
    lo = tree.node_lo[0].cpu().numpy().astype(np.float64)
    hi = tree.node_hi[0].cpu().numpy().astype(np.float64)
    lo = np.where(np.isfinite(lo), lo, 0.0)
    hi = np.where(np.isfinite(hi) & (hi > lo), hi, lo + 1.0)
    frac = (np.arange(rows, dtype=np.float64)[:, None] + 0.5) / rows
    return (lo[None, :] + frac * (hi - lo)[None, :]).astype(np.float32)


class ServeEngine:
    """Exact k-NN for serving micro-batches over one Morton tree."""

    def __init__(self, tree: MortonTree, k: int) -> None:
        if not isinstance(tree, MortonTree):
            raise TypeError(
                f"serving needs a MortonTree index, got {type(tree).__name__}")
        self.tree = tree
        self.k = min(int(k), tree.n_real)
        # flat bucket storage for the brute-force path: padding rows carry
        # +inf coords (never selected while k <= n_real) and id -1
        self._flat_pts = tree.bucket_pts.reshape(-1, tree.dim)
        self._flat_gid = tree.bucket_gid.reshape(-1)
        self.box_lo = tree.node_lo[0].cpu().numpy().astype(np.float32)
        self.box_hi = tree.node_hi[0].cpu().numpy().astype(np.float32)
        self.stats = TileStats()
        # facts about the LAST dispatch (the batch worker is the only
        # steady-state caller): the visit cap that answered (None = exact)
        # and the recall estimate it carries (the measured calibration
        # when one exists, the requested target otherwise, 1.0 exact)
        self.last_visit_cap: Optional[int] = None
        self.last_recall_estimate: float = 1.0

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """The index's AABB (the root box) as host f32[D] arrays."""
        return self.box_lo, self.box_hi

    def _resolve(self, plan, recall_target: Optional[float]):
        """(visit cap, recall estimate) for ``recall_target`` at ``plan``'s
        signature: the plan store's calibration (its measured recall is
        the estimate), or the heuristic with the target as the estimate;
        (None, 1.0) when the answer is exact."""
        if recall_target is None:
            return None, 1.0
        from kdtree_tpu_torch import approx, tuning

        t = self.tree
        prof = tuning.profile_for(plan.sig) if plan.sig is not None else None
        visit_cap = approx.resolve_visit_cap(
            recall_target, t.num_buckets, self.k, t.bucket_size, profile=prof)
        if visit_cap is None:
            return None, 1.0
        measured = (prof or {}).get("recall_measured") or {}
        try:
            estimate = float(measured.get(f"{float(recall_target):g}",
                                          recall_target))
        except (TypeError, ValueError):
            estimate = float(recall_target)
        return visit_cap, estimate

    def _plan(self, Q: int):
        t = self.tree
        return plan_tiled(Q, t.dim, t.n_real, t.num_buckets, t.bucket_size,
                          self.k, device=t.device)

    def knn_batch(self, queries: np.ndarray,
                  recall_target: Optional[float] = None,
                  ) -> Tuple[np.ndarray, np.ndarray, str]:
        """k-NN for one padded micro-batch via the tiled engine: exact by
        default, bounded-visit under a ``recall_target`` (resolved to a
        visit cap through the plan store's calibration, or the
        heuristic). Returns host (d2 f32[Q, k], ids i32[Q, k]) and the plan
        source, resolved here once, so the batcher labels its warm/cold
        metric from the lookup the dispatch used."""
        t = self.tree
        plan = self._plan(queries.shape[0])
        visit_cap, estimate = self._resolve(plan, recall_target)
        with obs.span("serve.batch", sync=False, q=queries.shape[0],
                      plan=plan.source, v=plan.v, tb=plan.tb,
                      visit_cap=visit_cap):
            d2, gid = morton_knn_tiled(t, queries, k=self.k, plan=plan,
                                       stats=self.stats, visit_cap=visit_cap)
            # response materialization boundary: the batch is complete
            # and per-request slices leave as JSON from here
            out = d2.cpu().numpy(), gid.cpu().numpy()
        self.last_visit_cap = visit_cap
        self.last_recall_estimate = estimate
        return out[0], out[1], plan.source

    def _verb_visit_cap(self, Q: int, recall_target: Optional[float]):
        """(visit cap, recall estimate) of a verb batch, resolved through
        the same calibration as the k-NN path (the pow2 row bucket's
        signature): a verb's truncated answer rides the same gear and
        recall contract."""
        if recall_target is None:
            return None, 1.0
        return self._resolve(self._plan(Q), recall_target)

    def radius_batch(self, queries: np.ndarray, r: np.ndarray,
                     recall_target: Optional[float] = None,
                     with_ids: bool = True):
        """Radius (or radius-count, ``with_ids=False``) for one
        micro-batch via the tree-pruned verb search. Exact by default;
        under a ``recall_target`` the resolved visit cap truncates the
        lb-ascending candidate list and the answer is a flagged sound
        lower bound (``truncated``). Returns a host
        :class:`~kdtree_tpu_torch.verbs.device.VerbResult`."""
        from kdtree_tpu_torch.verbs import device as verb_device

        visit_cap, estimate = self._verb_visit_cap(queries.shape[0],
                                                   recall_target)
        with obs.span("serve.verb", sync=False, verb="radius",
                      q=int(queries.shape[0]), visit_cap=visit_cap,
                      ids=with_ids):
            res = verb_device.radius_search(self.tree, queries, r,
                                            visit_cap=visit_cap,
                                            with_ids=with_ids)
        self.last_visit_cap = visit_cap
        self.last_recall_estimate = estimate
        return res

    def range_batch(self, box_lo: np.ndarray, box_hi: np.ndarray,
                    recall_target: Optional[float] = None,
                    with_ids: bool = True):
        """Box-range (or box-count) for one micro-batch — same contract
        as :meth:`radius_batch`."""
        from kdtree_tpu_torch.verbs import device as verb_device

        visit_cap, estimate = self._verb_visit_cap(box_lo.shape[0],
                                                   recall_target)
        with obs.span("serve.verb", sync=False, verb="range",
                      q=int(box_lo.shape[0]), visit_cap=visit_cap,
                      ids=with_ids):
            res = verb_device.range_search(self.tree, box_lo, box_hi,
                                           visit_cap=visit_cap,
                                           with_ids=with_ids)
        self.last_visit_cap = visit_cap
        self.last_recall_estimate = estimate
        return res

    def fallback_radius(self, queries: np.ndarray, r: np.ndarray,
                        with_ids: bool = True):
        """Brute-force radius over the flat bucket storage — the verb
        analog of :meth:`fallback_knn` (exact, no batch coupling);
        padding rows self-exclude through the gid mask."""
        from kdtree_tpu_torch.verbs import oracle as verb_oracle

        return verb_oracle.radius_oracle(self._flat_pts, queries, r,
                                         gid=self._flat_gid,
                                         with_ids=with_ids)

    def fallback_range(self, box_lo: np.ndarray, box_hi: np.ndarray,
                       with_ids: bool = True):
        """Brute-force box-range over the flat bucket storage."""
        from kdtree_tpu_torch.verbs import oracle as verb_oracle

        return verb_oracle.range_oracle(self._flat_pts, box_lo, box_hi,
                                        gid=self._flat_gid,
                                        with_ids=with_ids)

    def fallback_knn(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact brute force over the flat bucket storage — no tiles, no
        plans: the path for an oversized or already-late request."""
        k = min(int(k), self.tree.n_real)
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.tree.device)
        d2, idx = bruteforce.knn(self._flat_pts, q, k=k)
        ids = torch.where(idx >= 0, self._flat_gid[idx.long().clamp_min(0)], -1)
        return d2.cpu().numpy(), ids.cpu().numpy()

    def warmup(self, buckets: List[int], verbs: bool = False) -> None:
        """One dummy batch per row bucket (:func:`ladder_batch`), so every
        serving shape has run once; with ``verbs``, each rung also runs
        the radius and range forms, ids and counts (a tiny radius keeps
        the hit buffers at their floor; the box form shares the range
        search)."""
        for b in buckets:
            q = ladder_batch(self.tree, b)
            self.knn_batch(q)
            if verbs:
                tiny = np.full(b, 1e-6, dtype=np.float32)
                self.radius_batch(q, tiny)
                self.radius_batch(q, tiny, with_ids=False)
                self.range_batch(q, q)
                self.range_batch(q, q, with_ids=False)


class ServeState:
    """Everything the HTTP layer needs: the engine, the knobs, readiness."""

    def __init__(self, engine, max_batch: int, meta: Optional[dict] = None,
                 id_offset: int = 0, read_only: bool = False,
                 ladder_enabled: bool = False) -> None:
        self.engine = engine
        self.max_batch = max_batch
        self.meta = dict(meta or {})
        # sharded serving: this process holds rows [id_offset, id_offset +
        # n) of a larger partitioned point set and answers GLOBAL ids —
        # the offset is added at the response boundary (padding stays -1)
        self.id_offset = int(id_offset)
        # snapshot-following read replicas reject writes (403): writes go
        # to the shard primary only, and a secondary's local delta would
        # silently diverge from the snapshot stream it converges by
        self.read_only = bool(read_only)
        # the server's history sampler evaluates these on every tick and
        # /healthz reports the verdict in an "slo" block (readiness is NOT
        # gated on it): the process-default specs (request p99,
        # error/shed/degraded rates, device busy) plus the delta-backlog
        # and recall SLOs, over the process history ring
        self.slo_engine = obs_slo.SloEngine(
            specs=(obs_slo.default_specs() + obs_slo.mutable_specs()
                   + obs_slo.recall_specs()),
            history=obs_history.get_history(),
        )
        # the degradation ladder's master switch: the serve CLI arms it
        # (its warmup runs before traffic); in-process embedders opt in,
        # because a cold engine's first dispatches read as a burn
        self.ladder_enabled = bool(ladder_enabled)
        self._ready = threading.Event()
        self._ready_gauge = obs.get_registry().gauge("kdtree_serve_ready")
        self._ready_gauge.set(0)

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    def warmup_buckets(self) -> List[int]:
        return warmup_buckets(self.max_batch)

    def warmup(self, buckets: Optional[List[int]] = None) -> None:
        """Run the engine's warmup ladder, then flip readiness.
        ``buckets`` narrows the ladder — tests warm a single shape instead
        of the full ladder."""
        if buckets is None:
            buckets = self.warmup_buckets()
        # the runtime facts (platform, device, init time) every serving
        # report carries; idempotent
        from kdtree_tpu_torch.obs import torchrt

        torchrt.install(self.engine.tree.device)
        with obs.span("serve.warmup", sync=False, buckets=len(buckets)):
            self.engine.warmup(buckets)
        obs.get_registry().gauge("kdtree_serve_warmup_buckets").set(
            len(buckets))
        flight.record("serve.ready", buckets=len(buckets),
                      n=self.engine.tree.n_real, k=self.engine.k)
        self._ready.set()
        self._ready_gauge.set(1)


def tree_for_serving(tree) -> MortonTree:
    """Adapt a checkpointed index to the MortonTree the tiled serving path
    needs: Morton trees serve as-is; a classic KDTree serves through its
    Morton view (the CLI's dense dispatch does the same). Other kinds fail
    crisply — rebuild with ``--engine morton``."""
    if isinstance(tree, MortonTree):
        return tree
    if isinstance(tree, KDTree):
        return morton_view(points=tree.points)
    raise TypeError(
        f"cannot serve a {type(tree).__name__} checkpoint: the serving "
        "path needs a Morton(-viewable) tree — rebuild with "
        "`kdtree-tpu-torch --engine morton build`"
    )


def build_state(
    tree=None,
    points=None,
    problem: Optional[tuple] = None,
    k: int = 1,
    max_batch: int = 1024,
    meta: Optional[dict] = None,
    id_offset: int = 0,
    max_delta_rows: Optional[int] = None,
    max_delta_frac: Optional[float] = None,
    device=None,
    read_only: bool = False,
    epoch0: int = 0,
    snapshot_sink=None,
    ladder_enabled: bool = False,
) -> ServeState:
    """Assemble a ready-to-warmup :class:`ServeState` from exactly one
    index source: a loaded ``tree`` (served on its own device — a
    snapshot's, say), a ``points`` array, or a seeded ``problem`` (seed,
    dim, n) on the threefry row stream — the last two built on ``device``
    (CUDA unless the caller asks for the CPU).

    The engine is always write-capable
    (:class:`~kdtree_tpu_torch.mutable.engine.MutableEngine`):
    ``/v1/upsert`` and ``/v1/delete`` append to the delta buffer, and the
    epoch rebuilder compacts once the backlog crosses
    ``min(max_delta_rows, max_delta_frac * n)`` (either knob <= 0
    disables that bound). Snapshot plumbing: epoch numbering starts at
    ``epoch0`` (the loaded snapshot's), a primary's compactor emits each
    new epoch through ``snapshot_sink(tree, epoch)``, and a
    ``read_only`` follower answers writes 403. ``meta`` rides to
    ``/healthz`` (its ``"snapshot"`` block, when the CLI sets one).
    ``ladder_enabled`` arms the degradation ladder."""
    from kdtree_tpu_torch.mutable.engine import (
        DEFAULT_MAX_DELTA_FRAC,
        DEFAULT_MAX_DELTA_ROWS,
        MutableEngine,
    )
    from kdtree_tpu_torch.ops.morton import build_morton

    if sum(x is not None for x in (tree, points, problem)) != 1:
        raise ValueError("need exactly one of tree=, points=, problem=")
    if tree is not None:
        tree = tree_for_serving(tree)
    else:
        dev = resolve_device(device)
        if points is None:
            from kdtree_tpu_torch.ops.generate import generate_points_rowwise

            seed, dim, n = (int(x) for x in problem[:3])
            points = generate_points_rowwise(seed, dim, n, device=dev)
        tree = build_morton(points, device=dev)
    engine = MutableEngine(
        ServeEngine(tree, k),
        max_delta_rows=(DEFAULT_MAX_DELTA_ROWS if max_delta_rows is None
                        else int(max_delta_rows)),
        max_delta_frac=(DEFAULT_MAX_DELTA_FRAC if max_delta_frac is None
                        else float(max_delta_frac)),
        # the configured k, so an epoch rebuilt over a grown index can
        # serve the full k even when the bootstrap index was smaller
        requested_k=int(k),
        epoch0=int(epoch0),
        snapshot_sink=snapshot_sink,
    )
    return ServeState(engine, max_batch=_pow2_ceil(max_batch), meta=meta,
                      id_offset=id_offset, read_only=read_only,
                      ladder_enabled=ladder_enabled)
