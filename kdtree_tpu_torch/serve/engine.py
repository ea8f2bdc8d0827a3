"""The serving engine facade: the exact k-NN path of every micro-batch.

The port of ``kdtree_tpu/serve/lifecycle.py``'s ``ServeEngine`` (exact
``knn_batch``, brute-force ``fallback_knn``, the root-box ``bounds``) and
of the k-NN half of its warmup ladder, with ``batch_bucket`` from
``serve/batcher.py``. Every micro-batch is one tiled dispatch on the
tree's device; results come back to the host here, at the response
boundary.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from kdtree_tpu_torch.ops import bruteforce
from kdtree_tpu_torch.ops.morton import MortonTree
from kdtree_tpu_torch.ops.tile_query import (TileStats, morton_knn_tiled,
                                             plan_tiled)

MIN_BUCKET = 8  # smallest padded batch: sub-8-row traffic shares one shape


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
        d2, gid = morton_knn_tiled(t, queries, k=self.k, plan=plan,
                                   stats=self.stats)
        return d2.cpu().numpy(), gid.cpu().numpy(), plan.source

    def fallback_knn(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact brute force over the flat bucket storage — no tiles, no
        plans: the path for an oversized or already-late request."""
        k = min(int(k), self.tree.n_real)
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.tree.device)
        d2, idx = bruteforce.knn(self._flat_pts, q, k=k)
        ids = torch.where(idx >= 0, self._flat_gid[idx.long().clamp_min(0)], -1)
        return d2.cpu().numpy(), ids.cpu().numpy()

    def warmup(self, buckets: List[int]) -> None:
        """One dummy batch per row bucket, rows spread across the root box
        (the reference's ladder), so every serving shape has run once."""
        lo = self.box_lo.astype(np.float64)
        hi = self.box_hi.astype(np.float64)
        lo = np.where(np.isfinite(lo), lo, 0.0)
        hi = np.where(np.isfinite(hi) & (hi > lo), hi, lo + 1.0)
        for b in buckets:
            frac = (np.arange(b, dtype=np.float64)[:, None] + 0.5) / b
            q = (lo[None, :] + frac * (hi - lo)[None, :]).astype(np.float32)
            self.knn_batch(q)
