"""Level-synchronous k-d tree construction.

The port of ``kdtree_tpu/ops/build.py``: all segments of a level are
sorted at once. Per level:

1. ``segkey[p] = 2 * cumsum(dead)[p] - dead[p]`` — an int32 that is
   constant within each live segment and unique for every dead (already
   consumed) position, so a sort by (segkey, coord, id) sorts within
   segments and leaves the consumed medians in place;
2. one sort by (segkey, coordinate on the level's axis, point id);
3. the level's (static) median positions die.

The reference sorts ``(segkey, coord, perm)`` with one stable 3-key
``lax.sort``. Torch has no multi-key sort, and the third key is the point
id, not the position, so a sort by (segkey, coord) alone goes wrong from
level 1 on. :func:`_level_sort` sorts the ids instead: in id order, each
id's key is its position's segkey in the high 32 bits of an int64 and its
coordinate's order-preserving bits in the low 32, and a stable sort of
those keys breaks every tie by id. ``lax.sort`` compares floats with -0.0
equal to 0.0 and NaNs equal, after everything else; the bits of a
coordinate are taken after -0.0 becomes 0.0 and every NaN the one quiet
NaN, so the keys compare the same way.

The tree arrays are bit-identical to ``kdtree_tpu.build_jit`` on the same
points (``tests/test_torch_classic.py``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from kdtree_tpu_torch import obs, resolve_device
from kdtree_tpu_torch.models.tree import KDTree, node_levels, tree_spec
from kdtree_tpu_torch.utils.guards import check_rows_fit_i32

_U32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=16)
def _position_arrays(n: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    spec = tree_spec(n)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (spec.consume_level, spec.all_nodes, spec.all_medpos))


@functools.lru_cache(maxsize=32)
def _node_axes(heap_size: int, d: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(node_levels(heap_size) % d).to(device)


def spec_arrays(n: int, d: int, device=None) -> Tuple[torch.Tensor, ...]:
    """The structure arrays of a tree over n points in d dims, on
    ``device``: (consume_level i32[N], all_nodes i32[N], all_medpos
    i32[N], node_axes i32[H]). The O(N) position arrays are cached per
    (n, device), node_axes per (heap_size, d, device)."""
    dev = resolve_device(device)
    consume, all_nodes, all_medpos = _position_arrays(n, dev)
    return consume, all_nodes, all_medpos, _node_axes(tree_spec(n).heap_size, d, dev)


def ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) that order float32 ``x`` as ``lax.sort``
    does: -0.0 equal to 0.0, every NaN equal and after +inf."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    b = x.view(torch.int32).to(torch.int64) & _U32
    return torch.where(b >= 1 << 31, _U32 - b, b | (1 << 31))


def _level_sort(perm: torch.Tensor, segkey: torch.Tensor,
                coord_by_id: torch.Tensor) -> torch.Tensor:
    """The new permutation: the ids ordered by (segkey of their position,
    coordinate, id)."""
    n = perm.shape[0]
    pos = torch.empty_like(perm)
    pos[perm.long()] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    key = (segkey[pos.long()].to(torch.int64) << 32) | ordered_bits(coord_by_id)
    return torch.sort(key, stable=True).indices.to(torch.int32)


def segment_sort_levels(points: torch.Tensor, consume: torch.Tensor,
                        num_levels: int) -> torch.Tensor:
    """The level loop shared by the classic and the bucket build: the
    final position -> point id permutation after ``num_levels`` sorts."""
    n, d = points.shape
    perm = torch.arange(n, dtype=torch.int32, device=points.device)
    for lvl in range(num_levels):
        dead = (consume < lvl).to(torch.int32)
        segkey = 2 * torch.cumsum(dead, 0, dtype=torch.int32) - dead
        perm = _level_sort(perm, segkey, points[:, lvl % d])
    return perm


def extract_nodes(points: torch.Tensor, perm: torch.Tensor, all_nodes: torch.Tensor,
                  all_medpos: torch.Tensor, node_axes: torch.Tensor) -> KDTree:
    """The tree from the final permutation: consumed positions never move
    again, so one gather recovers every node's point."""
    heap_size = node_axes.shape[0]
    node_point = torch.full((heap_size,), -1, dtype=torch.int32, device=points.device)
    node_point[all_nodes.long()] = perm[all_medpos.long()]
    gathered = points[node_point.clamp(min=0).long(), node_axes.long()]
    split_val = torch.where(node_point >= 0, gathered, torch.zeros_like(gathered))
    return KDTree(points=points, node_point=node_point, split_val=split_val)


def build_impl(points: torch.Tensor, consume: torch.Tensor, all_nodes: torch.Tensor,
               all_medpos: torch.Tensor, node_axes: torch.Tensor, *,
               num_levels: int) -> KDTree:
    """The build on structure arrays that the caller passes in."""
    perm = segment_sort_levels(points, consume, num_levels)
    return extract_nodes(points, perm, all_nodes, all_medpos, node_axes)


def _as_points(points, device) -> torch.Tensor:
    """``points`` as a contiguous float32 tensor: ``device=None`` keeps a
    tensor on its own device and puts an array on CUDA."""
    if isinstance(points, torch.Tensor) and device is None:
        dev = points.device
    else:
        dev = resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev).contiguous()
    check_rows_fit_i32(points.shape[0], "point set")
    return points


def build(points, device=None) -> KDTree:
    """Build the implicit-array k-d tree over ``points`` (f32[N, D]): the
    same tree as :func:`build_jit`. The reference's traceable form, which
    other builds call from inside their own programs, so it counts no
    build."""
    points = _as_points(points, device)
    n, d = points.shape
    return build_impl(points, *spec_arrays(n, d, points.device),
                      num_levels=tree_spec(n).num_levels)


def build_jit(points, device=None) -> KDTree:
    """Build the tree (the reference's jitted entry point, counted as a
    ``tree`` build). ``points`` is a float32 tensor or array [N, D];
    ``device=None`` keeps a tensor on its own device and puts an array on
    CUDA."""
    points = _as_points(points, device)
    n, d = points.shape
    spec = tree_spec(n)
    obs.count_build("tree", n)
    return build_impl(points, *spec_arrays(n, d, points.device),
                      num_levels=spec.num_levels)


# ---------------------------------------------------------------------------
# host-side validation (a test and debug utility)
# ---------------------------------------------------------------------------


def validate_invariants(tree: KDTree) -> None:
    """Assert the k-d invariant on every node, on the host with numpy.

    For node i at level l with axis a = l % D: every point in the left
    subtree has coord[a] <= split_val[i] and every point in the right
    subtree has coord[a] >= split_val[i] (ties may land on either side of
    the median). Also checks that node_point is a permutation. One
    bottom-up subtree-min/max sweep over the heap plus one check per
    level: O(H * D)."""
    pts = tree.points.cpu().numpy()
    npnt = tree.node_point.cpu().numpy()
    sval = tree.split_val.cpu().numpy()
    d = pts.shape[1]
    # heap_size is max occupied node + 1; pad to a full heap so every level
    # slice below is complete (padding slots are unoccupied)
    num_levels = tree.heap_size.bit_length()
    h = (1 << num_levels) - 1
    npnt = np.concatenate([npnt, np.full(h - tree.heap_size, -1, npnt.dtype)])
    sval = np.concatenate([sval, np.zeros(h - tree.heap_size, sval.dtype)])

    used = npnt[npnt >= 0]
    assert used.size == tree.n, f"{used.size} nodes for {tree.n} points"
    assert np.array_equal(np.sort(used), np.arange(tree.n)), "node_point is not a permutation"

    occupied = npnt >= 0
    own = pts[np.maximum(npnt, 0)]
    submin = np.where(occupied[:, None], own, np.inf)
    submax = np.where(occupied[:, None], own, -np.inf)
    for lvl in range(num_levels - 2, -1, -1):
        lo, hi = (1 << lvl) - 1, (1 << (lvl + 1)) - 1
        c = np.s_[2 * lo + 1: 2 * hi + 1]  # both children levels, contiguous
        kid_min = np.minimum(submin[c][0::2], submin[c][1::2])
        kid_max = np.maximum(submax[c][0::2], submax[c][1::2])
        submin[lo:hi] = np.minimum(submin[lo:hi], kid_min)
        submax[lo:hi] = np.maximum(submax[lo:hi], kid_max)

    for lvl in range(num_levels):
        lo, hi = (1 << lvl) - 1, min((1 << (lvl + 1)) - 1, h)
        a = lvl % d
        occ = occupied[lo:hi]
        if not occ.any():
            continue
        ids = np.nonzero(occ)[0] + lo
        assert np.array_equal(sval[ids], pts[npnt[ids], a]), f"split_val mismatch at level {lvl}"
        left, right = 2 * ids + 1, 2 * ids + 2
        inb = left < h  # leaves of a full heap have no child slots
        if inb.any():
            li, ri, si = left[inb], right[inb], sval[ids[inb]]
            bad_l = submax[li, a] > si
            assert not bad_l.any(), f"left violation at node {li[bad_l][:5]}"
            bad_r = submin[ri, a] < si
            assert not bad_r.any(), f"right violation at node {ri[bad_r][:5]}"
