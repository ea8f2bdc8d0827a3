"""Bucketed k-d tree: leaf buckets instead of single-point leaves.

The port of ``kdtree_tpu/ops/bucket.py``. The recursion stops once a
segment fits a bucket of ``bucket_cap`` points: internal nodes still hold
their median point (its distance is tested on visit), buckets hold the
rest of their segment, and the same plane bounds prune bucket visits.

Storage (tensors on one device):
  node_coords f32[H, D]      internal node point coordinates (inf where absent)
  node_gid    i32[H]         internal node point ids (-1 where absent)
  node_bucket i32[H]         bucket index for bucket-leaf heap slots, else -1
  bucket_pts  f32[NB, B, D]  bucket contents (inf padding)
  bucket_gid  i32[NB, B]     bucket point ids (-1 padding)

The build shares the classic build's level sort
(:func:`kdtree_tpu_torch.ops.build.segment_sort_levels`), and its presort
strategy the classic presort's lists; every array is bit-identical to
``kdtree_tpu.build_bucket``'s for both strategies.

The query (:func:`bucket_knn`) is the reference's two-phase DFS as a
lockstep loop over a chunk of queries: phase A descends every lane to its
home bucket in ``num_levels`` steps and scans it; phase B is the
stack-based prune-and-backtrack that collects up to V buckets per lane and
scans them in one dense block, in rounds of ``_ROUND_STEPS`` steps with
one look from the host per round, as the Morton DFS runs
(``ops/morton.py``). Distances: internal points as the classic DFS sums
them (``_arith.sq_dist_rows``, over the chunk's lanes), bucket points as
``_arith.sq_dist`` sums them (the FMA chain of the jitted reference).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.models.tree import node_levels
from kdtree_tpu_torch.ops._arith import sq_dist, sq_dist_rows
from kdtree_tpu_torch.ops.build import _as_points, segment_sort_levels
from kdtree_tpu_torch.ops.morton import _ROUND_STEPS, DfsStats, _round_runner
from kdtree_tpu_torch.ops.topk import merge_topk, scan_bucket_block, sort_pairs

DEFAULT_BUCKET = 128
_QUERY_COLLECT = 8  # buckets per dense-scan round in phase B (the reference's V)
_CHUNK = 16384  # queries per lockstep chunk, as the reference's lax.scan


class BucketKDTree:
    """The built bucketed tree: five tensors on one device and two ints."""

    def __init__(self, node_coords, node_gid, node_bucket, bucket_pts, bucket_gid,
                 n_real, num_levels):
        self.node_coords = node_coords
        self.node_gid = node_gid
        self.node_bucket = node_bucket
        self.bucket_pts = bucket_pts
        self.bucket_gid = bucket_gid
        self.n_real = int(n_real)
        self.num_levels = int(num_levels)  # internal levels (max traversal depth)

    @property
    def device(self) -> torch.device:
        return self.node_coords.device

    @property
    def dim(self) -> int:
        return self.node_coords.shape[1]

    @property
    def heap_size(self) -> int:
        return self.node_coords.shape[0]

    @property
    def bucket_size(self) -> int:
        return self.bucket_pts.shape[1]

    def __repr__(self):
        return (f"BucketKDTree(n={self.n_real}, heap={self.heap_size}, "
                f"buckets={self.bucket_pts.shape[0]}x{self.bucket_size})")


@dataclass(frozen=True)
class BucketSpec:
    """Static structure of a bucketed tree over n points, bucket cap b."""

    n: int
    bucket_cap: int
    num_levels: int
    heap_size: int
    num_buckets: int
    consume_level: np.ndarray  # i32[N]; num_levels where never consumed
    med_nodes: np.ndarray  # i32[M] heap ids of internal nodes
    med_pos: np.ndarray  # i32[M] their (final) permutation positions
    bucket_node: np.ndarray  # i32[NB] heap id of each bucket leaf
    bucket_start: np.ndarray  # i32[NB] position range start
    bucket_len: np.ndarray  # i32[NB]


@functools.lru_cache(maxsize=16)
def bucket_spec(n: int, bucket_cap: int = DEFAULT_BUCKET) -> BucketSpec:
    """The classic tree's recursion arithmetic (``tree_spec``), but a
    segment of at most ``bucket_cap`` points becomes a leaf bucket."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    if bucket_cap < 2:
        # a size-2 segment has no right child; phase A's descent would walk
        # empty heap slots
        raise ValueError(f"bucket_cap must be >= 2, got {bucket_cap}")
    segs = [(0, n, 0)]
    med_levels, med_nodes, med_pos = [], [], []
    buckets = []
    level = 0
    max_node = 0
    while segs:
        nxt = []
        for s, c, node in segs:
            max_node = max(max_node, node)
            if c <= bucket_cap:
                buckets.append((node, s, c))
                continue
            m = c // 2
            med_levels.append(level)
            med_nodes.append(node)
            med_pos.append(s + m)
            nxt.append((s, m, 2 * node + 1))
            if c - m - 1 > 0:
                nxt.append((s + m + 1, c - m - 1, 2 * node + 2))
        segs = nxt
        level += 1
    num_levels = (max(med_levels) + 1) if med_levels else 0
    consume = np.full(n, num_levels, np.int32)  # bucket points: never consumed
    if med_pos:
        consume[np.array(med_pos, np.int64)] = np.array(med_levels, np.int32)
    return BucketSpec(
        n=n,
        bucket_cap=bucket_cap,
        num_levels=num_levels,
        heap_size=max_node + 1,
        num_buckets=len(buckets),
        consume_level=consume,
        med_nodes=np.array(med_nodes, np.int32),
        med_pos=np.array(med_pos, np.int32),
        bucket_node=np.array([b[0] for b in buckets], np.int32),
        bucket_start=np.array([b[1] for b in buckets], np.int32),
        bucket_len=np.array([b[2] for b in buckets], np.int32),
    )


@functools.lru_cache(maxsize=16)
def _bucket_arrays(n: int, bucket_cap: int, device: torch.device):
    spec = bucket_spec(n, bucket_cap)
    return tuple(torch.from_numpy(a).to(device) for a in (
        spec.consume_level, spec.med_nodes, spec.med_pos, spec.bucket_node,
        spec.bucket_start, spec.bucket_len))


def _extract_bucket_tree(points, perm, med_nodes, med_pos, bucket_node, bucket_start,
                         bucket_len, *, num_levels: int, heap_size: int,
                         bucket_cap: int) -> BucketKDTree:
    """Assemble the tree from the final position -> point id permutation."""
    n, d = points.shape
    dev = points.device
    mn, mp = med_nodes.long(), perm[med_pos.long()]
    # internal nodes
    node_gid = torch.full((heap_size,), -1, dtype=torch.int32, device=dev)
    node_gid[mn] = mp
    node_coords = torch.full((heap_size, d), float("inf"), dtype=points.dtype, device=dev)
    node_coords[mn] = points[mp.long()]
    # bucket leaves
    node_bucket = torch.full((heap_size,), -1, dtype=torch.int32, device=dev)
    node_bucket[bucket_node.long()] = torch.arange(bucket_node.shape[0], dtype=torch.int32,
                                                   device=dev)
    offs = torch.arange(bucket_cap, dtype=torch.int32, device=dev)
    pos = bucket_start[:, None] + offs[None, :]  # [NB, B]
    valid = offs[None, :] < bucket_len[:, None]
    gid = torch.where(valid, perm[pos.clamp(max=n - 1).long()], -1)
    bpts = torch.where(valid[:, :, None], points[gid.clamp(min=0).long()],
                       torch.tensor(float("inf"), dtype=points.dtype, device=dev))
    return BucketKDTree(node_coords, node_gid, node_bucket, bpts, gid, n, num_levels)


def build_bucket_impl(points, consume, med_nodes, med_pos, bucket_node, bucket_start,
                      bucket_len, *, num_levels: int, heap_size: int,
                      bucket_cap: int) -> BucketKDTree:
    perm = segment_sort_levels(points, consume, num_levels)
    return _extract_bucket_tree(points, perm, med_nodes, med_pos, bucket_node,
                                bucket_start, bucket_len, num_levels=num_levels,
                                heap_size=heap_size, bucket_cap=bucket_cap)


def build_bucket_presort_impl(points, consume, med_nodes, med_pos, bucket_node,
                              bucket_start, bucket_len, *, num_levels: int,
                              heap_size: int, bucket_cap: int) -> BucketKDTree:
    """The presort strategy: the same tree as :func:`build_bucket_impl`.
    Both order bucket contents by (last level's axis coordinate, id): the
    sort build because its last level sorts by that axis, the presort
    build because ``lists[a]`` keeps that order in every segment."""
    from kdtree_tpu_torch.ops.build_presort import presort_lists

    n, d = points.shape
    if num_levels == 0:
        final = torch.arange(n, dtype=torch.int32, device=points.device)
    else:
        final = presort_lists(points, consume, num_levels=num_levels)[(num_levels - 1) % d]
    return _extract_bucket_tree(points, final, med_nodes, med_pos, bucket_node,
                                bucket_start, bucket_len, num_levels=num_levels,
                                heap_size=heap_size, bucket_cap=bucket_cap)


def build_bucket(points, bucket_cap: int = DEFAULT_BUCKET, strategy: str = "auto",
                 device=None) -> BucketKDTree:
    """Build a bucketed tree. ``strategy``: "sort" (one sort per level) or
    "presort" (per-axis presorted lists and scan repartitions); "auto" is
    "sort", as in the reference. Identical trees either way. ``points`` is
    a float32 tensor or array [N, D]; ``device=None`` keeps a tensor on its
    own device and puts an array on CUDA."""
    if strategy == "auto":
        strategy = "sort"
    if strategy not in ("sort", "presort"):
        raise ValueError(f"unknown strategy {strategy!r}")
    points = _as_points(points, device)
    n, _ = points.shape
    spec = bucket_spec(n, bucket_cap)
    obs.count_build("bucket", n)
    impl = build_bucket_presort_impl if strategy == "presort" else build_bucket_impl
    return impl(points, *_bucket_arrays(n, bucket_cap, points.device),
                num_levels=spec.num_levels, heap_size=spec.heap_size,
                bucket_cap=spec.bucket_cap)


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _levels(heap_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(node_levels(heap_size)).to(device=device, dtype=torch.int64)


def _insert(best_d, best_i, d2, gid, take):
    """Replace each taking lane's first largest ``best_d`` by (d2, gid)."""
    wi = best_d.argmax(1, keepdim=True)
    t = take[:, None]
    best_d.scatter_(1, wi, torch.where(t, d2[:, None], best_d.gather(1, wi)))
    best_i.scatter_(1, wi, torch.where(t, gid[:, None], best_i.gather(1, wi)))


def _bucket_scan_merge(tree: BucketKDTree, q, bkt, enabled, best_d, best_i):
    """Dense single-bucket scan per lane, merged into the k-buffer;
    ``enabled`` masks a lane's whole update."""
    b = bkt.clamp(min=0).long()
    bd2 = sq_dist(q[:, None, :], tree.bucket_pts[b])  # [Q, B] (inf at padding)
    bd2 = torch.where(enabled[:, None], bd2, float("inf"))
    return merge_topk(best_d, best_i, bd2, tree.bucket_gid[b], enabled)


def _bucket_knn_chunk(tree: BucketKDTree, qs: torch.Tensor, k: int,
                      st: DfsStats) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``vmap(_bucket_knn_one)`` over one chunk of lanes."""
    dev = qs.device
    Q = qs.shape[0]
    heap_size, d = tree.heap_size, tree.dim
    levels = _levels(heap_size, dev)
    axes = levels % d
    best_d = torch.full((Q, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    st.chunks += 1

    def split(nc, p):
        """The near child's side: right when q[ax] >= p[ax]."""
        ax = axes[nc][:, None]
        return qs.gather(1, ax)[:, 0], p.gather(1, ax)[:, 0]

    # ---- phase A: descend to the home bucket (at most num_levels hops) ----
    node = torch.zeros(Q, dtype=torch.int64, device=dev)
    for _ in range(tree.num_levels):
        nc = node.clamp(max=heap_size - 1)
        active = tree.node_bucket[nc] < 0
        p = tree.node_coords[nc]
        gid = tree.node_gid[nc]
        d2 = sq_dist_rows(qs, p)
        _insert(best_d, best_i, d2, gid, active & (gid >= 0) & (d2 < best_d.amax(1)))
        qa, pa = split(nc, p)
        node = torch.where(active, 2 * nc + 1 + (qa >= pa).to(torch.int64), node)
    home = node
    home_bkt = tree.node_bucket[home.clamp(max=heap_size - 1)]
    best_d, best_i = _bucket_scan_merge(tree, qs, home_bkt, home_bkt >= 0, best_d, best_i)

    # ---- phase B: collect-then-scan backtracking ----
    home_lvl = levels[home.clamp(max=heap_size - 1)]
    V = _QUERY_COLLECT
    cap = tree.num_levels + 2
    stack_n = torch.zeros((Q, cap), dtype=torch.int64, device=dev)
    stack_b = torch.zeros((Q, cap), dtype=torch.float32, device=dev)
    sp = torch.ones(Q, dtype=torch.int64, device=dev)  # root pre-pushed, bound 0
    # blist's extra slot V takes the writes of lanes that are not collecting
    blist = torch.full((Q, V + 1), -1, dtype=torch.int64, device=dev)
    bcnt = torch.zeros(Q, dtype=torch.int64, device=dev)

    def step():  # in place: a captured graph replays on these tensors
        active = (sp > 0) & (bcnt < V)
        top = (sp - 1).clamp(min=0)[:, None]
        node = stack_n.gather(1, top)[:, 0]
        bound = stack_b.gather(1, top)[:, 0]
        worst = best_d.amax(1)
        nc = node.clamp(0, heap_size - 1)
        bkt = tree.node_bucket[nc]
        gid = tree.node_gid[nc]
        occupied = (node < heap_size) & ((gid >= 0) | (bkt >= 0))
        visit = active & occupied & (bound < worst)
        is_bucket = visit & (bkt >= 0)
        is_internal = visit & (bkt < 0)
        # skip what phase A already counted: the home path's points
        dl = home_lvl - levels[nc]
        on_home_path = (dl >= 0) & (((home + 1) >> dl.clamp(min=0)) == node + 1)
        p = tree.node_coords[nc]
        d2 = sq_dist_rows(qs, p)
        _insert(best_d, best_i, d2, gid, is_internal & (d2 < worst) & ~on_home_path)
        qa, pa = split(nc, p)
        delta = qa - pa
        go_right = (delta >= 0).to(torch.int64)
        # pop, then push far (with its plane bound) and near at the new sp,
        # slots that are dead unless the lane pushes
        sp.sub_(active.to(torch.int64))
        slot = sp[:, None]
        stack_n.scatter_(1, slot, (2 * nc + 2 - go_right)[:, None])
        stack_b.scatter_(1, slot, (delta * delta)[:, None])
        nxt = (slot + 1).clamp(max=cap - 1)
        stack_n.scatter_(1, nxt, (2 * nc + 1 + go_right)[:, None])
        stack_b.scatter_(1, nxt, torch.zeros_like(bound)[:, None])
        sp.add_(2 * is_internal.to(torch.int64))
        # ... and the home bucket is never collected again
        collect = is_bucket & (bkt != home_bkt)
        blist.scatter_(1, bcnt.clamp(max=V)[:, None],
                       torch.where(collect, bkt.to(torch.int64), -1)[:, None])
        bcnt.add_(collect.to(torch.int64))

    def steps():
        for _ in range(_ROUND_STEPS):
            step()

    run = _round_runner(steps, dev, st)
    while True:
        st.steps += _ROUND_STEPS
        ready = (bcnt == V) | ((sp == 0) & (bcnt > 0))
        n_ready, n_alive = torch.stack([ready.sum(), (sp > 0).sum()]).tolist()
        st.syncs += 1
        if n_ready:
            # the ready lanes, ascending, without a second sync
            idx = torch.sort((~ready).to(torch.int8), stable=True).indices[:n_ready]
            d, i = scan_bucket_block(qs[idx], tree.bucket_pts, tree.bucket_gid,
                                     blist[idx, :V], bcnt[idx], best_d[idx], best_i[idx])
            best_d[idx], best_i[idx] = d, i
            blist[idx] = -1
            bcnt[idx] = 0
            st.scans += 1
        if not n_alive:  # every lane's stack is empty and its buckets scanned
            break
        run()
    return sort_pairs(best_d, best_i)


def bucket_knn(tree: BucketKDTree, queries, k: int = 1, chunk: int = _CHUNK,
               stats: DfsStats | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN against a bucketed tree, on the tree's device.

    Returns (dists_sq f32[Q, k], indices i32[Q, k]) ascending by (distance,
    id): the same answer as ``kdtree_tpu.bucket_knn`` on the same tree.
    Queries run in chunks of ``chunk`` lanes, the last padded with zero
    rows to a full chunk, as in the reference. ``stats``, if given,
    accumulates the DFS's steps and host syncs."""
    queries = torch.as_tensor(queries, dtype=torch.float32, device=tree.device)
    k = min(k, tree.n_real)
    nq = queries.shape[0]
    obs.count_query("bucket", nq)
    chunk = min(chunk, max(nq, 1))
    pad = (-nq) % chunk
    if pad:
        queries = torch.cat([queries, queries.new_zeros((pad, queries.shape[1]))])
    st = stats if stats is not None else DfsStats()
    parts = [_bucket_knn_chunk(tree, queries[i:i + chunk], k, st)
             for i in range(0, queries.shape[0], chunk)]
    if not parts:
        return (torch.zeros((0, k), device=tree.device),
                torch.zeros((0, k), dtype=torch.int32, device=tree.device))
    return torch.cat([p[0] for p in parts])[:nq], torch.cat([p[1] for p in parts])[:nq]
