"""The scalable exact median-split tree.

The port of ``kdtree_tpu/parallel/global_exact.py``:

- **The top log2(P) levels are exact global medians.** At each level every
  live segment spans a contiguous group of shards, and its median, in the
  single-device build's (coordinate, id) order, is found by a distributed
  radix select: 32 bit rounds over a monotone u32 image of the axis
  coordinate, then 31 rounds over the ids among ties, each round one psum
  of per-segment counts. The medians are the single-device tree's top
  nodes.
- **One mirror exchange per level.** Rows on the wrong side of their
  group's median move to the mirror shard (``p ^ half``) in one ppermute
  into fixed-capacity buffers; overflow is counted and refuses the build.
- **Shard-local exact builds below**, with the single-device build; the
  top-level medians live in a small replicated top heap.

Queries are replicated: every shard answers over its local tree, the P
buffers merge, and the top heap's nodes are folded in. Dense low-D batches
go through a per-shard Morton view of the local rows and the forest's
tiled engine (the scan kernel on the card).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.models.tree import tree_spec
from kdtree_tpu_torch.ops._arith import sq_dist
from kdtree_tpu_torch.ops.build import build_impl, spec_arrays
from kdtree_tpu_torch.ops.query import _knn_batch
from kdtree_tpu_torch.ops.topk import sort_pairs
from kdtree_tpu_torch.utils.guards import check_rows_fit_i32

from .global_morton import (
    _count_sharded_query, _gen_shard, _merge_partials, _shards,
)
from .mesh import Mesh, all_gather, make_mesh, mesh_for, ppermute, psum

DEFAULT_SLACK = 1.6
_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=64)
def _top_layout(n: int, p: int) -> Tuple[Tuple[int, ...], ...]:
    """Per top level, the segment sizes in position order (left c // 2,
    the median, right c - c // 2 - 1)."""
    levels = []
    sizes = [n]
    for _ in range(p.bit_length() - 1):
        levels.append(tuple(sizes))
        nxt = []
        for c in sizes:
            m = c // 2
            nxt.append(m)
            nxt.append(max(c - m - 1, 0))
        sizes = nxt
    return tuple(levels)


def _f32_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone u32 image (in int64) of float32 ``x``: a total order with
    +inf at the top."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    return torch.where((b >> 31) == 1, ~b & _M32, b | 0x80000000)


def _radix_select(keys, ties, valids, segs, k_by_seg, S: int, mesh: Mesh):
    """Distributed lexicographic (key, tie) k-th smallest per segment.

    Per-shard lists of keys (u32 in int64), ties (ids) and valid masks;
    ``segs[p]`` is shard p's segment; ``k_by_seg`` i64[S] the 0-based
    ranks. Every bit round counts each shard's candidates below the bit
    and sums the counts per segment (one psum). Returns (key i64[S], tie
    i64[S]) on the mesh's first device."""
    dev0 = mesh.devices[0]
    seg_idx = torch.tensor(segs, device=dev0)

    def select(bits_from: int, values, candidates, krem):
        prefix = torch.zeros(S, dtype=torch.int64, device=dev0)
        for b in range(bits_from, -1, -1):
            above = (~((1 << (b + 1)) - 1)) & _M32
            pv = prefix[seg_idx] & above
            counts = torch.stack([
                (candidates[p] & ((values[p] & above) == pv[p].to(values[p].device))
                 & (((values[p] >> b) & 1) == 0)).sum().to(dev0)
                for p in range(mesh.size)])
            cnt = torch.zeros(S, dtype=torch.int64, device=dev0).index_add_(0, seg_idx, counts)
            take1 = krem >= cnt
            prefix = torch.where(take1, prefix | (1 << b), prefix)
            krem = torch.where(take1, krem - cnt, krem)
        return prefix, krem

    med_key, krem = select(31, keys, valids, k_by_seg)
    # rank among exact key ties, by id (ids are unique, >= 0, < 2^31)
    mk = med_key[seg_idx]
    eq = [valids[p] & (keys[p] == mk[p].to(keys[p].device)) for p in range(mesh.size)]
    med_tie, _ = select(30, [t.to(torch.int64) for t in ties], eq, krem)
    return med_key, med_tie


def _mirror_exchange(pts, gid, ship, keep, cap: int, half: int, mesh: Mesh):
    """Send every shard's ``ship`` rows to shard ``p ^ half`` in one
    ppermute (at most ``cap`` of them), and merge its ``keep`` rows and
    what it received into a buffer of the same width, valid rows first in
    order. Returns (pts, gid, overflow): rows dropped by the send cap or
    by the merge width, summed over the shards."""
    p = mesh.size
    send_pts, send_gid, over = [], [], []
    for i in range(p):
        W, d = pts[i].shape
        rank = torch.cumsum(ship[i].to(torch.int64), 0) - 1
        ok = ship[i] & (rank < cap)
        sp = torch.full((cap, d), float("inf"), dtype=pts[i].dtype, device=pts[i].device)
        sg = torch.full((cap,), -1, dtype=torch.int32, device=pts[i].device)
        sp[rank[ok]] = pts[i][ok]
        sg[rank[ok]] = gid[i][ok]
        send_pts.append(sp)
        send_gid.append(sg)
        over.append((ship[i] & (rank >= cap)).sum())
    perm = [(i, i ^ half) for i in range(p)]
    recv_pts = ppermute(send_pts, mesh, perm)
    recv_gid = ppermute(send_gid, mesh, perm)
    out_pts, out_gid = [], []
    for i in range(p):
        W = pts[i].shape[0]
        all_pts = torch.cat([torch.where(keep[i][:, None], pts[i], float("inf")), recv_pts[i]])
        all_gid = torch.cat([torch.where(keep[i], gid[i], -1), recv_gid[i]])
        order = torch.sort((all_gid < 0).to(torch.int8), stable=True).indices
        n_valid = (all_gid >= 0).sum()
        over[i] = over[i] + torch.clamp_min(n_valid - W, 0)
        out_pts.append(all_pts[order][:W])
        out_gid.append(all_gid[order][:W])
    return out_pts, out_gid, psum(over, mesh)[0]


class GlobalExactTree:
    """A replicated top heap of exact global medians over P shard-local
    classic k-d trees.

    ``top_pts`` f32[Htop, D] and ``top_gid`` i32[Htop] (+inf / -1 where
    absent) on one device; per-shard lists (or stacked [P, ...] tensors):
    ``local_pts`` [W, D], ``local_node`` and ``local_split`` [H] (the
    shard's ``KDTree`` columns), and ``local_gid`` [W] mapping local rows
    to global ids (-1 padding)."""

    ARRAYS = ("top_pts", "top_gid", "local_pts", "local_node", "local_split",
              "local_gid")
    AUX = ("num_points", "seed")
    REPLICATED = ("top_pts", "top_gid")

    def __init__(self, top_pts, top_gid, local_pts, local_node, local_split,
                 local_gid, num_points, seed):
        self.top_pts = top_pts
        self.top_gid = top_gid
        self.local_pts = _shards(local_pts)
        self.local_node = _shards(local_node)
        self.local_split = _shards(local_split)
        self.local_gid = _shards(local_gid)
        self.num_points = int(num_points)
        self.seed = int(seed)

    @property
    def devices(self) -> int:
        return len(self.local_pts)

    @property
    def device(self) -> torch.device:
        return self.local_pts[0].device

    @property
    def dim(self) -> int:
        return self.local_pts[0].shape[1]

    @property
    def n_real(self) -> int:
        return self.num_points

    def __repr__(self):
        return (f"GlobalExactTree(n={self.num_points}, devices={self.devices}, "
                f"dim={self.dim})")


def build_global_exact(
    seed: int,
    dim: int,
    num_points: int,
    mesh: Mesh | None = None,
    slack: float = DEFAULT_SLACK,
    distribution: str = "uniform",
) -> GlobalExactTree:
    """Build the exact-median global tree from the seeded row stream
    ("uniform" or "clustered"); every shard generates only its own rows.
    The shard count must be a power of two. Raises RuntimeError on mirror
    exchange overflow (retry with a higher ``slack``)."""
    check_rows_fit_i32(num_points, "generative problem")
    mesh = make_mesh() if mesh is None else mesh
    p = mesh.size
    if p & (p - 1):
        raise ValueError(f"global-exact needs a power-of-2 device count, got {p}")
    rows = -(-num_points // p)
    # headroom for the exchange's occupancy fluctuation (~sqrt(rows) a
    # level); never real data
    width = rows + max(16, int(4 * rows ** 0.5 * max(slack / DEFAULT_SLACK, 1.0)))
    cap = max(1, min(width, int(width / 2 * slack)))
    htop = max(p - 1, 1)
    L = p.bit_length() - 1
    med_ks = tuple(tuple(c // 2 for c in sizes) for sizes in _top_layout(num_points, p))
    dev0 = mesh.devices[0]
    pts, gid = [], []
    for i, dev in enumerate(mesh.devices):
        start = i * rows
        x = _gen_shard(distribution, seed, dim, start, width, dev)
        g = (start + torch.arange(width, device=dev)).to(torch.int32)
        valid = (torch.arange(width, device=dev) < rows) & (g < num_points)
        pts.append(torch.where(valid[:, None], x, float("inf")))
        gid.append(torch.where(valid, g, -1))
    top_pts = torch.full((htop, dim), float("inf"), device=dev0)
    top_gid = torch.full((htop,), -1, dtype=torch.int32, device=dev0)
    overflow = torch.zeros((), dtype=torch.int64, device=dev0)
    for lvl in range(L):
        S = 1 << lvl
        segs = [i >> (L - lvl) for i in range(p)]
        axis = lvl % dim
        keys = [_f32_key(x[:, axis]) for x in pts]
        valids = [g >= 0 for g in gid]
        k_by_seg = torch.tensor(med_ks[lvl], dtype=torch.int64, device=dev0)
        med_key, med_gid = _radix_select(keys, gid, valids, segs, k_by_seg, S, mesh)
        # this level's nodes into the replicated top heap: the median row
        # lives on exactly one shard, the rest contribute zeros
        tps, tgs, ships, keeps = [], [], [], []
        for i, dev in enumerate(mesh.devices):
            mk = med_key[segs[i]].to(dev)
            mg = med_gid[segs[i]].to(dev)
            key, g, valid = keys[i], gid[i], valids[i]
            is_med = valid & (key == mk) & (g == mg)
            node = (S - 1) + segs[i]
            tp = torch.zeros((htop, dim), device=dev)
            tp[node] = torch.where(is_med[:, None], pts[i], 0.0).sum(dim=0)
            tg = torch.zeros((htop,), dtype=torch.int32, device=dev)
            tg[node] = torch.where(is_med, g + 1, 0).sum().to(torch.int32)
            tps.append(tp)
            tgs.append(tg)
            # the consumed median is neither kept nor shipped
            left = valid & ((key < mk) | ((key == mk) & (g < mg)))
            right = valid & ~left & ~is_med
            half = 1 << (L - lvl - 1)
            ship = right if (i & half) == 0 else left
            ships.append(ship)
            keeps.append(valid & ~ship & ~is_med)
        tp = psum(tps, mesh)[0]
        tg = psum(tgs, mesh)[0]
        top_pts = torch.where((tg > 0)[:, None], tp, top_pts)
        top_gid = torch.where(tg > 0, tg - 1, top_gid)
        pts, gid, ov = _mirror_exchange(pts, gid, ships, keeps, cap,
                                        1 << (L - lvl - 1), mesh)
        overflow = overflow + ov.to(dev0)
    ov = int(overflow)
    if ov > 0:
        raise RuntimeError(f"mirror-exchange capacity overflow ({ov} rows); "
                           f"retry with slack > {slack}")
    num_levels = tree_spec(width).num_levels
    trees = [build_impl(x, *spec_arrays(width, dim, x.device), num_levels=num_levels)
             for x in pts]
    obs.count_build("global-exact", num_points)
    return GlobalExactTree(
        top_pts, top_gid, [t.points for t in trees], [t.node_point for t in trees],
        [t.split_val for t in trees], gid, num_points=num_points, seed=seed)


def _fold_top(md, mi, top_pts, top_gid, queries, k: int):
    """Fold the top heap's nodes (in no local tree) into the merged
    buffers: their distances, one more k-smallest selection (lowest
    candidate first on equal d2) and the stable (d2, id) sort."""
    top_pts = top_pts.to(queries.device)
    top_gid = top_gid.to(queries.device)
    td2 = sq_dist(queries[:, None, :], top_pts[None])
    td2 = torch.where((top_gid >= 0)[None, :], td2, float("inf"))
    cat_d = torch.cat([md, td2], dim=1)
    cat_i = torch.cat([mi, top_gid[None].expand(td2.shape)], dim=1)
    kk = min(k, cat_d.shape[1])
    srt, sel = torch.sort(cat_d, dim=1, stable=True)
    return sort_pairs(srt[:, :kk], torch.gather(cat_i, 1, sel[:, :kk]))


def _query_dfs(tree: GlobalExactTree, queries, k: int, devices):
    """Every shard's plane-bound DFS over its local tree, the merge, and
    the top heap's fold. ``devices``: the mesh's, or each shard's own."""
    num_levels = tree_spec(tree.local_pts[0].shape[0]).num_levels
    out = queries.device
    all_d, all_i = [], []
    for p, dev in enumerate(devices):
        d2, li = _knn_batch(tree.local_node[p].to(dev), tree.local_pts[p].to(dev),
                            queries.to(dev), k, num_levels)
        lgid = tree.local_gid[p].to(dev)
        gi = torch.where(li >= 0, lgid[li.long().clamp_min(0)], -1)
        all_d.append(torch.where(gi >= 0, d2, float("inf")))
        all_i.append(gi)
    md, mi = _merge_partials(all_gather(all_d, out), all_gather(all_i, out), k)
    return _fold_top(md, mi, tree.top_pts, tree.top_gid, queries, k)


def _exact_to_forest(tree: GlobalExactTree, bucket_cap: int = 128):
    """The tree's rows as a Morton forest (the top-heap medians excepted:
    they are folded separately), built once and cached on the tree. The
    device-memory guard sizes the copy by rows per physical device."""
    forest = getattr(tree, "_forest_cache", None)
    if forest is not None:
        return forest
    from kdtree_tpu_torch.ops.morton import check_build_capacity, default_bits

    from .global_morton import _forest, local_forest

    p, rows = tree.devices, tree.local_pts[0].shape[0]
    ndev = max(1, len({x.device for x in tree.local_pts}))
    check_build_capacity(-((p * rows) // -ndev), tree.dim, tree.device)
    bits = default_bits(tree.dim)
    parts, occ = local_forest(tree.local_pts, tree.local_gid,
                              [x.device for x in tree.local_pts], bucket_cap, bits)
    forest = _forest(parts, occ, num_points=tree.num_points, seed=tree.seed,
                     bucket_cap=bucket_cap, bits=bits)
    tree._forest_cache = forest
    return forest


def global_exact_query_tiled(
    tree: GlobalExactTree, queries, k: int = 1, mesh: Mesh | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense-batch path: the forest view of the local rows (cached)
    served by the forest's tiled query, plus one fold of the top heap."""
    from .global_morton import global_morton_query_tiled

    queries = torch.as_tensor(queries, dtype=torch.float32, device=tree.device)
    k = min(k, tree.num_points)
    forest = _exact_to_forest(tree)
    md, mi = global_morton_query_tiled(forest, queries, k=k, mesh=mesh)
    return _fold_top(md, mi, tree.top_pts, tree.top_gid, queries, k)


def global_exact_query(
    tree: GlobalExactTree, queries, k: int = 1, mesh: Mesh | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN against the exact-median tree. Dense low-D batches take
    :func:`global_exact_query_tiled` (unless its view would not fit);
    without a matching mesh the query runs mesh-free, with the same
    answers. Returns (d2 f32[Q, k], ids i32[Q, k])."""
    from kdtree_tpu_torch.ops.morton import BuildCapacityError
    from kdtree_tpu_torch.ops.tile_query import dense_lowd

    queries = torch.as_tensor(queries, dtype=torch.float32, device=tree.device)
    k = min(k, tree.num_points)
    _count_sharded_query("global-exact", queries.shape[0], tree.devices)
    if mesh is None:
        mesh = mesh_for(tree.devices, tree.device)
    if dense_lowd(queries.shape[0], tree.num_points, tree.dim):
        try:
            return global_exact_query_tiled(tree, queries, k=k, mesh=mesh)
        except BuildCapacityError:
            pass  # the view would not fit: the DFS queries the tree in place
    if mesh is not None and mesh.size == tree.devices:
        return _query_dfs(tree, queries, k, mesh.devices)
    return _query_dfs(tree, queries, k, [x.device for x in tree.local_pts])


def global_exact_knn(
    seed: int, dim: int, num_points: int, queries, k: int = 1,
    mesh: Mesh | None = None, slack: float = DEFAULT_SLACK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build + query in one call (generative, like ``global_morton_knn``)."""
    mesh = make_mesh() if mesh is None else mesh
    tree = build_global_exact(seed, dim, num_points, mesh=mesh, slack=slack)
    return global_exact_query(tree, queries, k=k, mesh=mesh)
