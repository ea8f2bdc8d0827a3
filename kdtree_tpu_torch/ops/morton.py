"""Morton-order bucket tree: one stable sort, then dense reductions.

The port of ``kdtree_tpu/ops/morton.py``'s build and of its per-query
best-first DFS (:func:`morton_knn`). The build: quantize each axis,
interleave into a Morton code, ONE stable sort by code (ties keep the
original row order, so the point id breaks them), cut the sorted order
into buckets of B points padded with +inf rows and id -1, and build the
implicit complete AABB heap bottom-up over the power-of-two-padded
buckets. Every array is bit-identical to the JAX build on the same
points.

Codes are u32 in the reference; torch has no full uint32 arithmetic or
sort, so they live in int64 here, each value below 2^32.

The DFS's arithmetic is the jitted reference's on XLA:CPU, found by
holding the two against each other (``tests/test_torch_morton_knn.py``)
and read in its compiled code: both the box bound (``jnp.sum(gap * gap)``)
and the leaf scan (``jnp.sum(dv * dv, -1)``) compile to a reduction loop
from 0 whose ``acc + x*x`` steps are each one fused multiply-add, so
both are ``_arith.sq_add`` chains from 0 over d = 0..D-1 (the
``_arith.sq_dist`` form, not the straight-line ``sq_sum_unrolled``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from kdtree_tpu_torch import resolve_device
from kdtree_tpu_torch.ops._arith import sq_add
from kdtree_tpu_torch.ops.topk import scan_bucket_block, sort_pairs
from kdtree_tpu_torch.utils.guards import check_rows_fit_i32

DEFAULT_BUCKET = 256
_QUERY_COLLECT = 8  # buckets per dense-scan round in the query loop
# DFS steps between two looks at the lanes from the host: 16 was the
# fastest of 4, 8, 16 and 32 on the card (``chip_smoke.py
# --dfs-round-sweep``; PERF.md)
_ROUND_STEPS = 16


class MortonTree:
    """Implicit complete AABB tree over Morton-sorted point buckets.

    Tensors (one device):
      node_lo / node_hi  f32[H, D]      heap-indexed AABBs; node i has
                                        children 2i+1 / 2i+2; the last NBP
                                        slots are the leaves, leaf i maps
                                        to bucket i - (NBP - 1)
      bucket_pts         f32[NBP, B, D] bucket contents (+inf padding)
      bucket_gid         i32[NBP, B]    original point ids (-1 padding)
    Plain ints: n_real, num_levels (= log2 NBP, the traversal depth).
    """

    def __init__(self, node_lo, node_hi, bucket_pts, bucket_gid, n_real,
                 num_levels):
        self.node_lo = node_lo
        self.node_hi = node_hi
        self.bucket_pts = bucket_pts
        self.bucket_gid = bucket_gid
        self.n_real = int(n_real)
        self.num_levels = int(num_levels)

    @property
    def device(self) -> torch.device:
        return self.bucket_pts.device

    @property
    def dim(self) -> int:
        return self.bucket_pts.shape[2]

    @property
    def num_buckets(self) -> int:
        return self.bucket_pts.shape[0]

    @property
    def bucket_size(self) -> int:
        return self.bucket_pts.shape[1]

    @property
    def heap_size(self) -> int:
        return self.node_lo.shape[0]

    def __repr__(self):
        return (
            f"MortonTree(n={self.n_real}, buckets={self.num_buckets}x"
            f"{self.bucket_size}, dim={self.dim}, device={self.device})"
        )


def default_bits(dim: int) -> int:
    """The most quantization bits per axis that still fit a u32
    interleaved code for this dimensionality, capped at 16."""
    return max(1, min(32 // max(dim, 1), 16))


def quantize(points: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 cell coordinates in [0, 2^bits), per axis, on the data's own
    per-axis bounds. Rows with a non-finite coordinate go to the top cell
    (they sort to the end); the clip happens in float, before the cast."""
    finite = torch.isfinite(points)
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    lo = torch.where(finite, points, inf).amin(dim=0)
    hi = torch.where(finite, points, -inf).amax(dim=0)
    scale = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    t = (points - lo) / scale * float(1 << bits)
    t = torch.where(finite.all(dim=1, keepdim=True), t,
                    torch.full_like(t, float(1 << bits)))
    return t.clamp(0.0, float((1 << bits) - 1)).to(torch.int64)


def morton_codes(points: torch.Tensor, bits: int) -> torch.Tensor:
    """Morton (Z-order) codes, u32 values in int64; ``bits`` per axis.
    Interleave slots at or past bit 32 do not contribute (the reference's
    guard for D > 32)."""
    n, d = points.shape
    cells = quantize(points, bits)
    code = torch.zeros(n, dtype=torch.int64, device=points.device)
    for b in range(bits):
        for a in range(d):
            if b * d + a < 32:
                code = code | (((cells[:, a] >> b) & 1) << (b * d + a))
    return code


@functools.lru_cache(maxsize=32)
def _tree_shape(n: int, bucket_cap: int) -> Tuple[int, int, int]:
    """(num_buckets_padded, heap_size, num_levels) for n points."""
    nb = max(1, -(-n // bucket_cap))
    nbp = 1 << (nb - 1).bit_length()
    return nbp, 2 * nbp - 1, (nb - 1).bit_length()


def build_morton_impl(points: torch.Tensor, *, bucket_cap: int,
                      bits: int) -> MortonTree:
    n, d = points.shape
    check_rows_fit_i32(n, "point set")
    nbp, _, num_levels = _tree_shape(n, bucket_cap)
    code = morton_codes(points, bits)
    order = torch.sort(code, stable=True).indices
    pad = nbp * bucket_cap - n
    dev = points.device
    sgid = torch.cat([order.to(torch.int32),
                      torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    spts = torch.cat([points[order],
                      torch.full((pad, d), float("inf"), dtype=points.dtype,
                                 device=dev)])
    bucket_pts = spts.reshape(nbp, bucket_cap, d)
    bucket_gid = sgid.reshape(nbp, bucket_cap)
    valid = (bucket_gid >= 0)[:, :, None]
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=dev)
    # leaf AABBs (masked so padding rows never loosen a bound)
    levels_lo = [torch.where(valid, bucket_pts, inf).amin(dim=1)]
    levels_hi = [torch.where(valid, bucket_pts, -inf).amax(dim=1)]
    while levels_lo[0].shape[0] > 1:
        levels_lo.insert(0, levels_lo[0].reshape(-1, 2, d).amin(dim=1))
        levels_hi.insert(0, levels_hi[0].reshape(-1, 2, d).amax(dim=1))
    return MortonTree(torch.cat(levels_lo), torch.cat(levels_hi), bucket_pts,
                      bucket_gid, n, num_levels)


class BuildCapacityError(ValueError):
    """A single-device build would exceed the device memory it has free."""


def check_build_capacity(n: int, d: int, device) -> None:
    """Refuse a CUDA build whose working set (~3 live copies of the
    (d+2)-column sort operand: 3 * n * (d + 2) * 4 bytes) exceeds the
    device's free memory, instead of failing mid-build."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    need = 3 * n * (d + 2) * 4
    free, _ = torch.cuda.mem_get_info(dev)
    if need > free:
        raise BuildCapacityError(
            f"single-device Morton build of n={n}, d={d} needs ~{need >> 20} "
            f"MiB working set, more than the {free >> 20} MiB free on {dev}"
        )


def build_morton(points, bucket_cap: int = DEFAULT_BUCKET,
                 bits: int | None = None, device=None) -> MortonTree:
    """Build the Morton bucket tree. ``points`` is a float32 tensor or
    array [N, D]; ``device=None`` keeps a tensor on its own device and puts
    an array on CUDA. ``bits`` defaults to (and is clamped by) the most
    that fit a u32 code for this dimensionality (10 at D=3)."""
    if isinstance(points, torch.Tensor) and device is None:
        dev = points.device
    else:
        dev = resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n, d = points.shape
    check_build_capacity(n, d, dev)
    bits = default_bits(d) if bits is None else max(1, min(bits, default_bits(d)))
    return build_morton_impl(points.contiguous(), bucket_cap=bucket_cap,
                             bits=bits)


def morton_view(points, gid=None, n_real: int | None = None,
                bucket_cap: int = DEFAULT_BUCKET, bits: int | None = None,
                device=None) -> MortonTree:
    """A Morton bucket tree over another index's point storage, answering
    with that index's ids: ``gid`` maps each row of ``points`` to its
    original point id (-1 for padding rows, which build into +inf leaves
    the tiled scan prunes). ``n_real`` overrides the real point count;
    with ``gid`` given and ``n_real`` omitted it is the count of real ids
    (one host sync). The epoch rebuild of the mutable index builds its
    next tree this way, from the surviving main rows and the delta rows.
    The port of ``kdtree_tpu/ops/morton.py::morton_view``."""
    tree = build_morton(points, bucket_cap=bucket_cap, bits=bits, device=device)
    if gid is not None:
        gid = torch.as_tensor(gid, dtype=torch.int32, device=tree.device)
        if n_real is None:
            n_real = int((gid >= 0).sum())
        bg = torch.where(tree.bucket_gid >= 0,
                         gid[tree.bucket_gid.long().clamp_min(0)], -1)
        return MortonTree(tree.node_lo, tree.node_hi, tree.bucket_pts, bg,
                          n_real, tree.num_levels)
    if n_real is not None and n_real != tree.n_real:
        return MortonTree(tree.node_lo, tree.node_hi, tree.bucket_pts,
                          tree.bucket_gid, n_real, tree.num_levels)
    return tree


# ---------------------------------------------------------------------------
# query: per-query best-first DFS, lockstep over a chunk of queries
# ---------------------------------------------------------------------------


@dataclass
class DfsStats:
    """What a :func:`morton_knn` run did, for the caller that passes one
    in: chunks, lockstep DFS steps, rounds that scanned buckets, host
    syncs (each a read of lane state that waits for the device), and CUDA
    graphs captured (one per chunk on CUDA)."""

    chunks: int = 0
    steps: int = 0
    scans: int = 0
    syncs: int = 0
    graphs: int = 0


def _bbox_d2(q, lo, hi):
    """Exact lower bound on |q - p|^2 over any p inside [lo, hi] (last
    axis), accumulated like the jitted reference's reduction."""
    gap = torch.clamp_min(torch.maximum(lo - q, q - hi), 0.0)
    acc = torch.zeros_like(gap[..., 0])
    for d in range(gap.shape[-1]):
        acc = sq_add(acc, gap[..., d])
    return acc


def _round_runner(steps, dev: torch.device, st: DfsStats):
    """Run ``steps`` (one round of DFS steps, in place) once, and return
    the callable that runs each later round: ``steps`` itself, or on CUDA
    the replay of a graph captured from it. A round is some thousand small
    launches, so eager launching would hold the card to the host's pace;
    the eager first round is the warm-up a capture needs."""
    if dev.type != "cuda":
        steps()
        return steps
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        steps()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps()
    st.graphs += 1
    return graph.replay


def _morton_knn_batch(tree: MortonTree, qs: torch.Tensor, k: int,
                      stats: DfsStats | None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``vmap(_morton_knn_one)`` over one chunk, as one
    lockstep loop: each lane keeps the per-query state of
    ``_morton_knn_one`` (stack of (node, bound), k-buffer, collected bucket
    list) and steps exactly as that loop would. Lanes never interact, so
    the schedule is free: every step pops once for each lane that is
    collecting; every ``_ROUND_STEPS`` steps the lanes whose collection
    ended (V buckets held, or the stack empty with some held) scan their
    buckets, and the host looks once at whether any lane is left."""
    dev = qs.device
    Q = qs.shape[0]
    V = _QUERY_COLLECT
    first_leaf = tree.num_buckets - 1
    cap = 2 * tree.num_levels + 2  # both children at every level
    last = tree.heap_size - 1
    best_d = torch.full((Q, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    if Q == 0:
        return best_d, best_i
    # slots at or above a lane's sp are dead, so every step writes its two
    # pushes there unconditionally and advances sp only past the real ones;
    # blist's extra slot V takes the writes of lanes that are not collecting
    stack_n = torch.zeros((Q, cap), dtype=torch.int64, device=dev)
    stack_b = torch.zeros((Q, cap), dtype=torch.float32, device=dev)
    sp = torch.ones(Q, dtype=torch.int64, device=dev)  # root pre-pushed, bound 0
    blist = torch.full((Q, V + 1), -1, dtype=torch.int64, device=dev)
    bcnt = torch.zeros(Q, dtype=torch.int64, device=dev)
    worst = best_d.amax(1)
    kids = torch.tensor([1, 2], dtype=torch.int64, device=dev)
    st = stats if stats is not None else DfsStats()
    st.chunks += 1

    def step():  # in place: a captured graph replays on these tensors
        active = (sp > 0) & (bcnt < V)
        top = (sp - 1).clamp(min=0)[:, None]
        node = stack_n.gather(1, top)[:, 0]
        bound = stack_b.gather(1, top)[:, 0]
        visit = active & (bound < worst)
        leaf = visit & (node >= first_leaf)
        internal = visit & (node < first_leaf)
        sp.sub_(active.long())  # pop
        # internal: push the children nearer-last (visited first), each
        # only if its own bound beats the current worst
        c = (2 * node[:, None] + kids).clamp(max=last)
        bd = _bbox_d2(qs[:, None, :], tree.node_lo[c], tree.node_hi[c])
        swap = bd[:, 0] < bd[:, 1]
        order = torch.stack([swap.long(), 1 - swap.long()], 1)
        cs, bs = c.gather(1, order), bd.gather(1, order)
        for j in (0, 1):
            slot = sp.clamp(max=cap - 1)[:, None]
            stack_n.scatter_(1, slot, cs[:, j:j + 1])
            stack_b.scatter_(1, slot, bs[:, j:j + 1])
            sp.add_((internal & (bs[:, j] < worst)).long())
        blist.scatter_(1, bcnt.clamp(max=V)[:, None],
                       torch.where(leaf, node - first_leaf, -1)[:, None])
        bcnt.add_(leaf.long())

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
            worst[idx] = d.amax(1)
            blist[idx] = -1
            bcnt[idx] = 0
            st.scans += 1
        if not n_alive:  # every lane's stack is empty and its buckets scanned
            break
        run()
    return sort_pairs(best_d, best_i)


def morton_knn(tree: MortonTree, queries, k: int = 1, chunk: int = 4096,
               stats: DfsStats | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN against a Morton bucket tree (per-query best-first DFS),
    on the tree's device.

    Returns (dists_sq f32[Q, k], indices i32[Q, k]) ascending — the same
    answer as ``kdtree_tpu.morton_knn`` on the same tree, ties included.
    Queries run in chunks of ``chunk`` lanes; a ragged tail is padded with
    copies of the last query, as in the reference. ``stats``, if given,
    accumulates the steps and host syncs. For large dense batches prefer
    :func:`kdtree_tpu_torch.ops.tile_query.morton_knn_tiled`."""
    queries = torch.as_tensor(queries, dtype=torch.float32, device=tree.device)
    k = min(k, tree.n_real)
    q = queries.shape[0]
    chunk = min(chunk, max(q, 1))
    if q <= chunk:
        return _morton_knn_batch(tree, queries, k, stats)
    pad = (-q) % chunk
    if pad:
        queries = torch.cat([queries, queries[-1:].expand(pad, queries.shape[1])])
    parts = [_morton_knn_batch(tree, queries[i:i + chunk], k, stats)
             for i in range(0, queries.shape[0], chunk)]
    return (torch.cat([p[0] for p in parts])[:q],
            torch.cat([p[1] for p in parts])[:q])
