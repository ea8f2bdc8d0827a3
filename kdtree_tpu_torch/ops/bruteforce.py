"""Exact brute-force k-NN — the oracle every check of the port uses.

The port of ``kdtree_tpu/ops/bruteforce.py``:

- ``method='exact'`` (default for D <= 32): direct ``(q - p)^2`` sums,
  accumulated axis by axis exactly like the JAX oracle
  (:func:`kdtree_tpu_torch.ops._arith.sq_dist`), and the k smallest
  (d2, index) kept: on the card one fused kernel that never writes the
  distance block (:mod:`kdtree_tpu_torch.kernels.knn_scan`), on the CPU
  its plain version, point tile by point tile. The answer, and the
  kernel, ignore the tiling;
- ``method='matmul'`` (default for D > 32): the ``|q|^2 + |p|^2 - 2 q.p``
  product as a COARSE ranking (float32 matmul, TF32 off — the analog of
  ``Precision.HIGHEST``), then exact rescoring of the k + REFINE_SLACK best
  per point tile, so returned distances are exact.

Selection is by the pair (distance, point index): the lowest index wins a
tie, as ``lax.top_k`` does. Each (d2, index) pair is packed into one int64
key — the float32 bits of a non-negative distance order like the
distance — so every key is distinct and ``torch.topk`` over keys has no
ties to break: its result is the same set, in the same order, on every
device.

Both stream the points with a running top-k, so N is bounded by device
memory, not by a [Q, N] matrix.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.kernels.knn_scan import _TILE_ELEMS, _keys, _smallest, _unkey, knn_scan
from kdtree_tpu_torch.kernels.pair_d2 import pair_d2
from kdtree_tpu_torch.ops._arith import sq_dist, sq_sum_windows

EXACT_DIM_MAX = 32
REFINE_SLACK = 8


def block_d2_exact(queries: torch.Tensor, ptile: torch.Tensor) -> torch.Tensor:
    """[Q, T] squared distances by direct subtraction, accumulated axis by
    axis in the arithmetic of the JAX package's jitted ``_block_d2_exact``
    (:func:`~kdtree_tpu_torch.ops._arith.sq_dist`): the ``pair_d2`` kernel
    on the card, its plain version on the CPU
    (:mod:`kdtree_tpu_torch.kernels.pair_d2`)."""
    return pair_d2(queries.contiguous(), ptile.contiguous())


def _matmul_d2(queries: torch.Tensor, ptile: torch.Tensor) -> torch.Tensor:
    qn = (queries * queries).sum(dim=1, keepdim=True)
    pn = (ptile * ptile).sum(dim=1)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cross = queries @ ptile.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.clamp_min(qn + pn[None, :] - 2.0 * cross, 0.0)


def knn(points: torch.Tensor, queries: torch.Tensor, k: int = 1,
        method: str = "auto", tile: int | None = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by streaming brute force on the points' device.

    Returns (dists_sq f32[Q, k], indices i32[Q, k]) ascending, lowest
    index first on equal distances. ``k`` is clamped to N. ``tile`` is the
    point rows a streaming step of the matmul form and of the exact form's
    plain version; the exact answer, and its kernel, ignore it."""
    n, d = points.shape
    Q = queries.shape[0]
    k = min(k, n)
    if method == "auto":
        method = "exact" if d <= EXACT_DIM_MAX else "matmul"
    if method not in ("exact", "matmul"):
        raise ValueError(f"unknown method {method!r}")
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=points.device)
    obs.count_query("bruteforce", Q)
    if tile is None:
        tile = max(_TILE_ELEMS // max(Q * max(d, 1), 1), k + REFINE_SLACK, 1)
    if method == "exact":
        return knn_scan(points.contiguous(), queries.contiguous(), k, tile=tile)
    best = None
    for base in range(0, n, tile):
        ptile = points[base: base + tile]
        t = ptile.shape[0]
        idx = torch.arange(base, base + t, dtype=torch.int64,
                           device=points.device)
        kk = min(k + REFINE_SLACK, t)
        coarse = _smallest(
            _keys(_matmul_d2(queries, ptile), idx[None, :].expand(Q, t)), kk)
        sel = (coarse & 0xFFFFFFFF)
        cand = _keys(sq_dist(queries[:, None, :], points[sel]), sel)
        # cand holds k + REFINE_SLACK rescored keys, out of order: one
        # tile's answer is selected too
        best = _smallest(cand if best is None else torch.cat([best, cand], 1), k)
    return _unkey(best)


def knn_exact_d2(points: torch.Tensor, queries: torch.Tensor, k: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-tiled direct-subtraction oracle (test-sized problems).

    Like the JAX oracle, which runs op by op outside ``jit``, each square
    is rounded before it is added (no fused multiply-add) and the squares
    are summed as XLA:CPU's reduction sums them
    (:func:`~kdtree_tpu_torch.ops._arith.sq_sum_windows`: in order up to
    32 axes), so its distances can differ from :func:`knn`'s in the last
    bit."""
    n = points.shape[0]
    k = min(k, n)
    diff = queries[:, None, :] - points[None, :, :]
    d2 = sq_sum_windows(diff * diff)
    idx = torch.arange(n, dtype=torch.int64, device=points.device)
    return _unkey(_smallest(_keys(d2, idx[None, :].expand_as(d2)), k))
