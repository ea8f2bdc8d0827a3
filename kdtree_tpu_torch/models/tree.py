"""The implicit array k-d tree: the classic median-split tree as data.

The port of ``kdtree_tpu/models/tree.py``. A built tree is three tensors:

- ``points``      f32[N, D]  the point cloud (never permuted);
- ``node_point``  i32[H]     heap-indexed (node ``i`` has children ``2i+1``
                             and ``2i+2``): the index into ``points`` of the
                             point stored at node ``i``, or -1 where the
                             node does not exist;
- ``split_val``   f32[H]     the node's coordinate on its split axis
                             (``axis = level(i) % D``), 0 where absent.

The tree's shape depends only on N: a segment of ``c`` points puts its
median at local offset ``c // 2``, its left child gets ``c // 2`` points
and its right child ``c - c // 2 - 1``. :func:`tree_spec` computes that
static structure once per N on the host (numpy), and the build
(:mod:`kdtree_tpu_torch.ops.build`) only moves the permutation.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class TreeSpec:
    """Static (host-side) structure of a k-d tree over ``n`` points.

    Attributes:
      n: number of points.
      num_levels: number of level-synchronous build rounds (= max depth).
      heap_size: size of the implicit heap arrays (max node id + 1).
      level_medpos: per level, the permutation positions consumed as that
        level's node points (the segment medians), in segment order.
      level_nodes: per level, the heap node ids those medians become.
      level_segstart: per level, each node's segment start position.
    """

    n: int
    num_levels: int
    heap_size: int
    level_medpos: Tuple[np.ndarray, ...]
    level_nodes: Tuple[np.ndarray, ...]
    level_segstart: Tuple[np.ndarray, ...]

    @property
    def consume_level(self) -> np.ndarray:
        """i32[N]: the build level at which each permutation position is
        consumed as a node (positions never move after that level)."""
        out = np.empty(self.n, np.int32)
        for lvl, pos in enumerate(self.level_medpos):
            out[pos] = lvl
        return out

    @property
    def position_node(self) -> np.ndarray:
        """i32[N]: the heap node id that each permutation position becomes."""
        out = np.empty(self.n, np.int32)
        for pos, nodes in zip(self.level_medpos, self.level_nodes):
            out[pos] = nodes
        return out

    @property
    def all_medpos(self) -> np.ndarray:
        return np.concatenate(self.level_medpos) if self.level_medpos else np.zeros(0, np.int32)

    @property
    def all_nodes(self) -> np.ndarray:
        return np.concatenate(self.level_nodes) if self.level_nodes else np.zeros(0, np.int32)


@functools.lru_cache(maxsize=64)
def tree_spec(n: int) -> TreeSpec:
    """The recursion's shape (sizes only), level by level.

    The reference walks the segments of a level in a Python loop; this
    walks them as numpy arrays, one level per step: every segment
    ``(start, count, node)`` yields its median ``start + count // 2`` and
    its children, left before right and dropped when empty, in segment
    order. The arrays are the reference's, element for element
    (``tests/test_torch_classic.py``)."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    start = np.zeros(1, np.int64)
    count = np.full(1, n, np.int64)
    node = np.zeros(1, np.int64)
    level_medpos, level_nodes, level_segstart = [], [], []
    max_node = 0
    while start.size:
        m = count // 2
        level_medpos.append((start + m).astype(np.int32))
        level_nodes.append(node.astype(np.int32))
        level_segstart.append(start.astype(np.int32))
        max_node = max(max_node, int(node.max()))
        # children interleaved per segment: (left, right), then the empty
        # ones dropped
        cs = np.stack([start, start + m + 1], axis=1).ravel()
        cc = np.stack([m, count - m - 1], axis=1).ravel()
        cn = np.stack([2 * node + 1, 2 * node + 2], axis=1).ravel()
        keep = cc > 0
        start, count, node = cs[keep], cc[keep], cn[keep]
    return TreeSpec(
        n=n,
        num_levels=len(level_medpos),
        heap_size=max_node + 1,
        level_medpos=tuple(level_medpos),
        level_nodes=tuple(level_nodes),
        level_segstart=tuple(level_segstart),
    )


def node_levels(heap_size: int) -> np.ndarray:
    """Static level of each heap node: level(i) = floor(log2(i + 1))."""
    # frexp is exact for ints < 2**53 (unlike log2, which can round)
    return (np.frexp(np.arange(1, heap_size + 1, dtype=np.int64).astype(np.float64))[1]
            - 1).astype(np.int32)


class KDTree:
    """The built tree: three tensors on one device."""

    def __init__(self, points, node_point, split_val):
        self.points = points
        self.node_point = node_point
        self.split_val = split_val

    @property
    def device(self) -> torch.device:
        return self.points.device

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def heap_size(self) -> int:
        return self.node_point.shape[0]

    def __repr__(self):
        return f"KDTree(n={self.n}, dim={self.dim}, heap_size={self.heap_size})"
