"""Presort build: O(N) work per level instead of a sort per level.

The port of ``kdtree_tpu/ops/build_presort.py``. The point ids are
sorted once per axis, by (coordinate, id); then every axis keeps the
invariant

    list_a = point ids ordered segment-major, coord_a-minor,

over the same static segments as the sort build (``TreeSpec``). A level
needs no sort:

1. position-space classification, shared by all axes, from cummax/cummin
   scans of the static structure: ``H[p]``, the nearest hole at or left
   of p (segment start = H + 1); ``M[p]`` / ``Q[p]``, the nearest dying
   position left / right (the segment's median); and the side of p —
   left, dies now, right, or stays (a hole, or a frozen bucket segment);
2. the split axis's list maps sides from positions to point ids (one
   scatter);
3. every axis list stably repartitions [left | hole | right] inside each
   segment with two cumsums and one scatter.

The trees are identical to :func:`kdtree_tpu_torch.ops.build.build_jit`'s
(both order segments by (coordinate, id)); the sort strategy is the
production path, as in the reference.
"""

from __future__ import annotations

import torch

from kdtree_tpu_torch.models.tree import KDTree, tree_spec
from kdtree_tpu_torch.ops.build import _as_points, extract_nodes, ordered_bits, spec_arrays

# side codes
_LEFT, _DIES, _RIGHT, _STAY = 0, 1, 2, 3


def presort_lists(points: torch.Tensor, consume: torch.Tensor, *,
                  num_levels: int) -> torch.Tensor:
    """Run the presort level loop; returns the per-axis lists i32[D, N].

    ``consume[p]`` is the level at which position p's point is consumed
    as a median (>= num_levels for positions that never die, such as
    bucket points). Segments with no dying median at a level (finished
    buckets) stay in place."""
    n, d = points.shape
    dev = points.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    # the only sorts: one stable (coordinate, id) ordering per axis
    lists = torch.stack([torch.sort(ordered_bits(points[:, a]), stable=True).indices
                         for a in range(d)])  # i64[D, N]
    consume = consume.to(torch.int64)
    minus1 = torch.full_like(iota, -1)
    for lvl in range(num_levels):
        # ---- position-space structure for this level (axis-independent)
        hole = consume < lvl
        dying = consume == lvl
        H = torch.cummax(torch.where(hole, iota, minus1), 0).values
        M = torch.cummax(torch.where(dying, iota, minus1), 0).values
        valid = consume <= lvl
        Q = torch.cummin(torch.where(valid, iota, torch.full_like(iota, n)).flip(0),
                         0).values.flip(0)
        cq = consume[Q.clamp(max=n - 1)]
        seg_start = H + 1
        # the segment median is right of p while p is in the left half
        med = torch.where(cq == lvl, Q, M)
        side_pos = torch.where(
            hole, _STAY,
            torch.where(dying, _DIES,
                        torch.where(cq == lvl, _LEFT,
                                    torch.where(M >= seg_start, _RIGHT, _STAY))))

        # ---- map sides from positions to points via the split-axis list
        side_of_pid = torch.zeros(n, dtype=torch.int64, device=dev)
        side_of_pid[lists[lvl % d]] = side_pos

        # ---- stable 3-way repartition of every axis list
        side = side_of_pid[lists]  # [D, N]
        left = (side == _LEFT).to(torch.int64)
        right = (side == _RIGHT).to(torch.int64)
        exl = torch.cumsum(left, 1) - left  # exclusive
        exr = torch.cumsum(right, 1) - right
        at = seg_start.clamp(max=n - 1)  # a hole at n - 1: clamped, as jax gathers
        rank_l = exl - exl[:, at]
        rank_r = exr - exr[:, at]
        new_pos = torch.where(
            side == _LEFT, seg_start + rank_l,
            torch.where(side == _DIES, med,
                        torch.where(side == _RIGHT, med + 1 + rank_r, iota)))
        lists = torch.zeros_like(lists).scatter_(1, new_pos, lists)
    return lists.to(torch.int32)


def build_presort_impl(points: torch.Tensor, consume: torch.Tensor,
                       all_nodes: torch.Tensor, all_medpos: torch.Tensor,
                       node_axes: torch.Tensor, *, num_levels: int) -> KDTree:
    lists = presort_lists(points, consume, num_levels=num_levels)
    # consumed points sit at their hole in every list; use list 0
    return extract_nodes(points, lists[0], all_nodes, all_medpos, node_axes)


def build_presort(points, device=None) -> KDTree:
    """The presort build: the same tree as ``build_jit`` (slower than it
    on the card, as the reference found on a TPU). ``device`` as in
    ``build_jit``."""
    points = _as_points(points, device)
    n, d = points.shape
    return build_presort_impl(points, *spec_arrays(n, d, points.device),
                              num_levels=tree_spec(n).num_levels)
