"""Global-tree mode: ONE exact k-d tree over points sharded across a mesh.

The port of ``kdtree_tpu/parallel/global_tree.py``. The single-device
build is "per level, a stable sort by (segment key, axis coordinate,
id)"; here each level's sort is a distributed block-bitonic sort over the
shards: every shard sorts its block, then a bitonic merge network pairs
shard ``r`` with ``r ^ j``, exchanges whole blocks (a ppermute), merges
the two sorted blocks and keeps the lower or the upper half. Segment keys
come from the static position layout, so the result is node for node the
single-device tree over the same rows (``build_jit``): the module's own
contract, and its role in the framework is that structural-identity
oracle. The tree is returned as a node-coordinate heap (coordinates and
global id per heap slot), assembled by a psum of each shard's owned
positions; it is replicated, so the engine is bounded by one device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.models.tree import tree_spec
from kdtree_tpu_torch.ops.build import ordered_bits
from kdtree_tpu_torch.ops.generate import generate_points_shard
from kdtree_tpu_torch.ops.query import _knn_batch_nodes
from kdtree_tpu_torch.utils.guards import check_rows_fit_i32

from .mesh import Mesh, all_gather, make_mesh, ppermute, psum


class GlobalKDTree:
    """A globally built tree: node-coordinate heap ``node_coords`` f32[H,
    D], global point ids ``node_gid`` i32[H] (-1 for padding or an empty
    slot), and the static reachability mask ``node_traversable`` bool[H]
    (a node's subtree holds real points iff its segment start lies below
    n_real)."""

    ARRAYS = ("node_coords", "node_gid", "node_traversable")
    AUX = ("n_real", "num_levels")

    def __init__(self, node_coords, node_gid, node_traversable, n_real, num_levels):
        self.node_coords = node_coords
        self.node_gid = node_gid
        self.node_traversable = node_traversable
        self.n_real = int(n_real)
        self.num_levels = int(num_levels)

    @property
    def device(self) -> torch.device:
        return self.node_coords.device

    @property
    def heap_size(self) -> int:
        return self.node_coords.shape[0]

    @property
    def dim(self) -> int:
        return self.node_coords.shape[1]

    def __repr__(self):
        return (f"GlobalKDTree(n={self.n_real}, heap_size={self.heap_size}, "
                f"dim={self.dim})")


@functools.lru_cache(maxsize=16)
def _traversable_mask(n_pad: int, n_real: int) -> np.ndarray:
    """bool[heap]: the node's subtree intersects the real prefix. Padding
    rows (+inf everywhere) sort behind every real row of their segment, so
    they hold the global suffix [n_real, n_pad) at every level."""
    spec = tree_spec(n_pad)
    mask = np.zeros(spec.heap_size, bool)
    for nodes, starts in zip(spec.level_nodes, spec.level_segstart):
        mask[nodes] = starts < n_real
    return mask


def _sort_block(skey, coord, gid, coords):
    """Stable sort of one block by (skey, coord, gid): by gid, then
    stably by (skey, coordinate order)."""
    o1 = torch.sort(gid, stable=True).indices
    key = (skey[o1].to(torch.int64) << 32) | ordered_bits(coord[o1])
    order = o1[torch.sort(key, stable=True).indices]
    return skey[order], coord[order], gid[order], coords[order]


def _bitonic_level_sort(blocks, mesh: Mesh):
    """Distributed stable sort by (skey, coord, gid) over the shards'
    blocks (per-shard tuples), in place of the list."""
    p = mesh.size
    blocks = [_sort_block(*b) for b in blocks]
    k = 2
    while k <= p:
        j = k // 2
        while j >= 1:
            pairs = [(i, i ^ j) for i in range(p)]
            others = [ppermute([b[f] for b in blocks], mesh, pairs) for f in range(4)]
            new = []
            for r in range(p):
                partner = r ^ j
                ascending = (r & k) == 0
                keep_lower = (r < partner) == ascending
                L = blocks[r][0].shape[0]
                merged = _sort_block(*(torch.cat([blocks[r][f], others[f][r]])
                                       for f in range(4)))
                lo = 0 if keep_lower else L
                new.append(tuple(x[lo:lo + L] for x in merged))
            blocks = new
            j //= 2
        k *= 2
    return blocks


def _global_build(coords, gid, consume, posnode, mesh: Mesh, num_levels: int,
                  heap_size: int):
    """The level loop over per-shard row blocks (coords [L, D], gid [L];
    ``consume``/``posnode`` the static per-position arrays of each shard's
    positions), then the heap assembly. Returns (node_coords, node_gid)
    on the mesh's first device."""
    p = mesh.size
    d = coords[0].shape[1]
    for lvl in range(num_levels):
        dead = [(c < lvl).to(torch.int32) for c in consume]
        local_csum = [torch.cumsum(x, 0, dtype=torch.int32) for x in dead]
        totals = all_gather([c[-1] for c in local_csum], mesh.devices[0]).cpu().tolist()
        blocks = []
        for r in range(p):
            csum = local_csum[r] + sum(totals[:r])
            segkey = 2 * csum - dead[r]
            blocks.append((segkey, coords[r][:, lvl % d], gid[r], coords[r]))
        blocks = _bitonic_level_sort(blocks, mesh)
        coords = [b[3] for b in blocks]
        gid = [b[2] for b in blocks]
    ng, nc = [], []
    for r, dev in enumerate(mesh.devices):
        pn = posnode[r].long()
        ng.append(torch.zeros(heap_size, dtype=torch.int32, device=dev)
                  .index_add_(0, pn, gid[r] + 1))
        nc.append(torch.zeros((heap_size, d), dtype=coords[r].dtype, device=dev)
                  .index_add_(0, pn, coords[r]))
    return psum(nc, mesh)[0], psum(ng, mesh)[0] - 1


def _positions(spec, mesh: Mesh, rows: int):
    consume = torch.from_numpy(spec.consume_level)
    posnode = torch.from_numpy(spec.position_node)
    return ([consume[r * rows:(r + 1) * rows].to(d) for r, d in enumerate(mesh.devices)],
            [posnode[r * rows:(r + 1) * rows].to(d) for r, d in enumerate(mesh.devices)])


def _check_pow2(p: int) -> None:
    if p & (p - 1):
        raise ValueError(f"global-tree mode needs a power-of-2 device count, got {p}")


def build_global(points, mesh: Mesh | None = None) -> GlobalKDTree:
    """One exact global tree over ``points`` (f32[N, D], a tensor or an
    array) sharded across the mesh; the shard count must be a power of two.
    N pads to a multiple of P with +inf rows, which build into leaves that
    never win. The tree equals the single-device ``build_jit`` of the
    same rows, node for node."""
    mesh = make_mesh() if mesh is None else mesh
    p = mesh.size
    _check_pow2(p)
    points = torch.as_tensor(points, dtype=torch.float32, device=mesh.devices[0])
    n, d = points.shape
    pad = (-n) % p
    if pad:
        points = torch.cat([points, torch.full((pad, d), float("inf"), device=points.device)])
    n_pad = n + pad
    check_rows_fit_i32(n_pad, "global tree point set")
    spec = tree_spec(n_pad)
    rows = n_pad // p
    ids = torch.arange(n_pad, device=points.device)
    gid = torch.where(ids < n, ids, -1).to(torch.int32)
    consume, posnode = _positions(spec, mesh, rows)
    node_coords, node_gid = _global_build(
        [points[r * rows:(r + 1) * rows].to(dv) for r, dv in enumerate(mesh.devices)],
        [gid[r * rows:(r + 1) * rows].to(dv) for r, dv in enumerate(mesh.devices)],
        consume, posnode, mesh, spec.num_levels, spec.heap_size)
    trav = torch.from_numpy(_traversable_mask(n_pad, n)).to(node_coords.device)
    obs.count_build("global", n)
    return GlobalKDTree(node_coords, node_gid, trav, n, spec.num_levels)


def build_global_gen(seed: int, dim: int, num_points: int,
                     mesh: Mesh | None = None) -> GlobalKDTree:
    """:func:`build_global` over the seeded row stream, each shard drawing
    only its own rows; the same tree as ``build_global(
    generate_points_rowwise(seed, dim, n), mesh)``."""
    mesh = make_mesh() if mesh is None else mesh
    p = mesh.size
    _check_pow2(p)
    rows = -(-num_points // p)
    n_pad = p * rows
    check_rows_fit_i32(n_pad, "generative global-tree problem")
    spec = tree_spec(n_pad)
    pts, gid = [], []
    for r, dev in enumerate(mesh.devices):
        x = generate_points_shard(seed, dim, r * rows, rows, device=dev)
        g = (r * rows + torch.arange(rows, device=dev)).to(torch.int32)
        valid = g < num_points
        pts.append(torch.where(valid[:, None], x, float("inf")))
        gid.append(torch.where(valid, g, -1))
    consume, posnode = _positions(spec, mesh, rows)
    node_coords, node_gid = _global_build(pts, gid, consume, posnode, mesh,
                                          spec.num_levels, spec.heap_size)
    trav = torch.from_numpy(_traversable_mask(n_pad, num_points)).to(node_coords.device)
    return GlobalKDTree(node_coords, node_gid, trav, num_points, spec.num_levels)


def global_knn(gtree: GlobalKDTree, queries, k: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN against a globally built tree: (d2 f32[Q, k], global
    ids i32[Q, k]) ascending."""
    queries = torch.as_tensor(queries, dtype=torch.float32, device=gtree.device)
    k = min(k, gtree.n_real)
    obs.count_query("global", queries.shape[0])
    return _knn_batch_nodes(gtree.node_coords, gtree.node_gid, gtree.node_traversable,
                            queries, k, gtree.num_levels)


def global_build_knn(points, queries, k: int = 1,
                     mesh: Mesh | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed build + query in one call."""
    return global_knn(build_global(points, mesh), queries, k=k)
