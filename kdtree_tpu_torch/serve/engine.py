"""Serving lifecycle: the engine facade, the serving state, startup.

The port of ``kdtree_tpu/serve/lifecycle.py`` on the k-NN path:
``ServeEngine`` (exact ``knn_batch``, brute-force ``fallback_knn``, the
root-box ``bounds``, the warmup ladder), ``ServeState`` (what the HTTP
layer reads: engine, knobs, readiness), ``tree_for_serving`` and
``build_state``, with ``batch_bucket`` from ``serve/batcher.py``.

Startup does the expensive things once, before the first request can
observe them: load or build the index on the device, wrap it in the
write-capable :class:`~kdtree_tpu_torch.mutable.engine.MutableEngine`,
and run one dummy batch per pow2 row bucket — ``/healthz`` turns ready
only after that, so the first real batch of every shape finds its kernels
built and its allocations made. Every micro-batch is one tiled dispatch
on the tree's device; results come back to the host here, at the
response boundary, so the batcher and HTTP layers stay host code.
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
from kdtree_tpu_torch.ops import bruteforce
from kdtree_tpu_torch.ops.morton import MortonTree
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

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """The index's AABB (the root box) as host f32[D] arrays."""
        return self.box_lo, self.box_hi

    def knn_batch(self, queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray, str]:
        """Exact k-NN for one padded micro-batch via the tiled engine.
        Returns host (d2 f32[Q, k], ids i32[Q, k]) and the plan source."""
        t = self.tree
        Q, D = queries.shape
        plan = plan_tiled(Q, D, t.n_real, t.num_buckets, t.bucket_size,
                          self.k, device=t.device)
        with obs.span("serve.batch", sync=False, q=Q, plan=plan.source,
                      v=plan.v, tb=plan.tb):
            d2, gid = morton_knn_tiled(t, queries, k=self.k, plan=plan,
                                       stats=self.stats)
            # response materialization boundary: the batch is complete
            # and per-request slices leave as JSON from here
            out = d2.cpu().numpy(), gid.cpu().numpy()
        return out[0], out[1], plan.source

    def fallback_knn(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact brute force over the flat bucket storage — no tiles, no
        plans: the path for an oversized or already-late request."""
        k = min(int(k), self.tree.n_real)
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.tree.device)
        d2, idx = bruteforce.knn(self._flat_pts, q, k=k)
        ids = torch.where(idx >= 0, self._flat_gid[idx.long().clamp_min(0)], -1)
        return d2.cpu().numpy(), ids.cpu().numpy()

    def warmup(self, buckets: List[int]) -> None:
        """One dummy batch per row bucket (:func:`ladder_batch`), so every
        serving shape has run once."""
        for b in buckets:
            self.knn_batch(ladder_batch(self.tree, b))


class ServeState:
    """Everything the HTTP layer needs: the engine, the knobs, readiness."""

    def __init__(self, engine, max_batch: int, meta: Optional[dict] = None,
                 id_offset: int = 0) -> None:
        self.engine = engine
        self.max_batch = max_batch
        self.meta = dict(meta or {})
        # sharded serving: this process holds rows [id_offset, id_offset +
        # n) of a larger partitioned point set and answers GLOBAL ids —
        # the offset is added at the response boundary (padding stays -1)
        self.id_offset = int(id_offset)
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
        with obs.span("serve.warmup", sync=False, buckets=len(buckets)):
            self.engine.warmup(buckets)
        obs.get_registry().gauge("kdtree_serve_warmup_buckets").set(
            len(buckets))
        flight.record("serve.ready", buckets=len(buckets),
                      n=self.engine.tree.n_real, k=self.engine.k)
        self._ready.set()
        self._ready_gauge.set(1)


def tree_for_serving(tree) -> MortonTree:
    """The MortonTree the tiled serving path needs. Morton trees serve
    as-is; the classic median-split trees come with ROADMAP item 16 (and
    their Morton view with them), so any other kind fails crisply."""
    if isinstance(tree, MortonTree):
        return tree
    raise TypeError(
        f"cannot serve a {type(tree).__name__} checkpoint: the port serves "
        "Morton trees only (classic trees are ROADMAP queue 1 item 16) — "
        "rebuild with `--engine morton build`"
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
) -> ServeState:
    """Assemble a ready-to-warmup :class:`ServeState` from exactly one
    index source: a loaded ``tree`` (served on its own device), a
    ``points`` array, or a seeded ``problem`` (seed, dim, n) on the
    threefry row stream — the last two built on ``device`` (CUDA unless
    the caller asks for the CPU).

    The engine is always write-capable
    (:class:`~kdtree_tpu_torch.mutable.engine.MutableEngine`):
    ``/v1/upsert`` and ``/v1/delete`` append to the delta buffer, and the
    epoch rebuilder compacts once the backlog crosses
    ``min(max_delta_rows, max_delta_frac * n)`` (either knob <= 0
    disables that bound)."""
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
    )
    return ServeState(engine, max_batch=_pow2_ceil(max_batch), meta=meta,
                      id_offset=id_offset)
