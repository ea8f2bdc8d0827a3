"""The Morton DFS: wrapper, checks, launch count and the kernel's mirror.

:func:`morton_dfs` answers exact k-NN on a Morton bucket tree by the
per-query best-first DFS of the JAX package's XLA program
``kdtree_tpu/ops/morton.py::_morton_knn_one`` (``:403``). On a CUDA tensor
it launches the hand-written kernel of ``csrc/morton_dfs.cu`` (built by
:mod:`kdtree_tpu_torch.kernels._build` at first use, bound through ctypes),
one warp a query and one launch for the whole batch, or raises; it never
falls back. On a CPU tensor it runs the plain version,
:func:`kdtree_tpu_torch.ops.morton.morton_knn_plain` (the lockstep loop
``_morton_knn_batch`` over chunks of queries). The two agree bit for bit,
d2 and ids, and neither answer depends on the chunking.

:func:`morton_dfs_mirror` follows the kernel's control flow query by query
on the CPU: the walk, the survivor filter (d2 at or below the k-list's
last), the selection of the k smallest survivors by (d2, position) and their
merge into the k-list by (d2, id). The CPU tests hold it bit-equal to the
plain loop and to the reference.

``morton_dfs.launches`` counts the calls that launched the kernel (a plain
integer), so a run can show that its main path went through it.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from kdtree_tpu_torch.kernels import _build
from kdtree_tpu_torch.kernels.scan_knn import _check
from kdtree_tpu_torch.ops._arith import sq_dist
from kdtree_tpu_torch.ops.morton import (
    _QUERY_COLLECT, DfsStats, MortonTree, _bbox_d2, morton_knn_plain,
)

SMEM_K = 64  # kSmemK in the source: longer k-lists live in device memory (a scratch)
MAX_LEVELS = 31  # the kernel's stack holds 2 * 31 + 2 entries
MAX_HEAP = (1 << 31) - 1  # node indices are int32
_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("morton_dfs").morton_dfs_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_args(tree: MortonTree, queries: torch.Tensor, k: int, seen) -> None:
    dev = queries.device
    if queries.dim() != 2:
        raise ValueError(f"morton_dfs takes [Q, D] queries, got shape {tuple(queries.shape)}")
    nb, B, D = tree.bucket_pts.shape
    H = tree.node_lo.shape[0]
    _check("queries", queries, torch.float32, (queries.shape[0], D), dev)
    _check("node_lo", tree.node_lo, torch.float32, (H, D), dev)
    _check("node_hi", tree.node_hi, torch.float32, (H, D), dev)
    _check("bucket_pts", tree.bucket_pts, torch.float32, (nb, B, D), dev)
    _check("bucket_gid", tree.bucket_gid, torch.int32, (nb, B), dev)
    if D < 1 or B < 1:
        raise ValueError(f"morton_dfs takes rows of at least one axis and buckets of at "
                         f"least one row, got D={D}, B={B}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if H != 2 * nb - 1 or nb & (nb - 1):
        raise ValueError(f"a heap of {H} nodes over {nb} buckets is not a complete tree")
    if tree.num_levels > MAX_LEVELS or H > MAX_HEAP:
        raise ValueError(f"a tree of {tree.num_levels} levels and {H} nodes is past the "
                         f"kernel's {MAX_LEVELS} levels and {MAX_HEAP} nodes")
    if seen is not None:
        nodes, buckets, work = seen
        _check("seen nodes", nodes, torch.uint8, (H,), dev)
        _check("seen buckets", buckets, torch.uint8, (nb,), dev)
        _check("seen work", work, torch.int64, (2,), dev)


def morton_dfs(tree: MortonTree, queries: torch.Tensor, k: int, chunk: int = 4096,
               stats: DfsStats | None = None, seen=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2 f32[Q, k], ids i32[Q, k]) ascending by (d2, id): the k nearest
    points of ``tree`` to each row of ``queries`` f32[Q, D], as
    ``kdtree_tpu.morton_knn`` answers them, ties included; slots past the
    tree's points are (+inf, -1). Queries and tree on one device,
    contiguous. CUDA tensors launch the kernel over the whole batch
    (``stats`` counts one chunk and one launch, no host sync); CPU tensors
    run the plain version in chunks of ``chunk`` queries (``stats`` counts
    its chunks, steps, scans and host syncs). ``seen``, CUDA tensors
    (nodes u8[H], buckets u8[NB], work i64[2]), is a measurement: the
    kernel sets the flag of every child box and bucket a query reads and
    adds its box bounds and scanned pairs to ``work``; the answer is the
    same."""
    dev = queries.device
    _check_args(tree, queries, k, seen)
    if dev.type == "cpu":
        if seen is not None:
            raise ValueError("seen is the kernel's measurement: it takes CUDA tensors")
        return morton_knn_plain(tree, queries, k, chunk, stats)
    if dev.type != "cuda":
        raise ValueError(f"morton_dfs runs on CUDA or CPU tensors, got {dev}")
    fn = _fn()
    Q, D = queries.shape
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0 or k == 0:
        return out_d, out_i
    for name, x in (("queries", queries), ("node_lo", tree.node_lo),
                    ("node_hi", tree.node_hi), ("bucket_pts", tree.bucket_pts),
                    ("bucket_gid", tree.bucket_gid)):
        if x.data_ptr() % 4:
            raise ValueError(f"{name} must start on a 4-byte boundary")
    scr_d = scr_i = None
    if k > SMEM_K:  # the rounds' selections, beside the k-lists in the output rows
        scr_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
        scr_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    nodes, buckets, work = seen if seen is not None else (None, None, None)
    nb, B, _ = tree.bucket_pts.shape

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):  # the launch goes to the current device
        err = fn(queries.data_ptr(), tree.node_lo.data_ptr(), tree.node_hi.data_ptr(),
                 tree.bucket_pts.data_ptr(), tree.bucket_gid.data_ptr(), out_d.data_ptr(),
                 out_i.data_ptr(), ptr(scr_d), ptr(scr_i), ptr(nodes), ptr(buckets),
                 ptr(work), Q, D, B, k, nb, tree.node_lo.shape[0],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"morton_dfs kernel launch failed with CUDA error {err}")
    morton_dfs.launches += 1
    if stats is not None:
        stats.chunks += 1
        stats.launches += 1
    return out_d, out_i


morton_dfs.launches = 0


def fold_round(kl: list, cd: np.ndarray, ci: np.ndarray, k: int) -> list:
    """One scan round's fold as the kernel does it: ``kl`` the k-list of
    (d2, id) pairs, ascending; ``cd``/``ci`` the round's candidates
    (float32 d2 and int32 ids) in position order. The survivors (d2 at or
    below the list's last, and finite) go into a selection by (d2,
    position), each after every entry at or below it, the last dropped past
    k; the selection then merges into the list by (d2, id), the list's
    entries first among equal keys, stopping at the first entry above the
    list's last. Returns the new list."""
    worst = kl[-1][0]
    keep = np.nonzero((cd <= worst) & (cd < float("inf")))[0]
    sel_d, sel_i = [], []
    for p in keep.tolist():
        x = float(cd[p])
        if len(sel_d) == k and not x < sel_d[-1]:
            continue
        at = bisect.bisect_right(sel_d, x)
        sel_d.insert(at, x)
        sel_i.insert(at, int(ci[p]))
        if len(sel_d) > k:
            sel_d.pop()
            sel_i.pop()
    kl = list(kl)
    for x, i in zip(sel_d, sel_i):
        if x > kl[-1][0]:
            break
        at = bisect.bisect_right(kl, (x, i))
        if at < k:
            kl.insert(at, (x, i))
            kl.pop()
    return kl


def morton_dfs_mirror(tree: MortonTree, queries: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's control flow, one query at a time, on CPU tensors. A
    query's box bounds to every node and distances to every bucket row are
    computed first, in the kernel's arithmetic (``_bbox_d2``, ``sq_dist``);
    the walk and the rounds (:func:`fold_round`) then run in Python on
    those float32 values, exactly as ``csrc/morton_dfs.cu`` orders them."""
    Q = queries.shape[0]
    out_d = torch.full((Q, k), float("inf"), dtype=torch.float32)
    out_i = torch.full((Q, k), -1, dtype=torch.int32)
    if k == 0:
        return out_d, out_i
    nb, B, _ = tree.bucket_pts.shape
    first_leaf = nb - 1
    last = tree.node_lo.shape[0] - 1
    gid = tree.bucket_gid.numpy()
    for qi in range(Q):
        q = queries[qi]
        bnd = _bbox_d2(q, tree.node_lo, tree.node_hi).tolist()
        d2 = sq_dist(q, tree.bucket_pts).numpy()  # [NB, B]
        kl = [(float("inf"), -1)] * k  # the k-list, ascending by (d2, id)
        stack = [(0, 0.0)]  # the root, bound 0
        worst = float("inf")
        while stack:
            blist = []
            while stack and len(blist) < _QUERY_COLLECT:
                node, bound = stack.pop()
                if not bound < worst:
                    continue
                if node >= first_leaf:
                    blist.append(node - first_leaf)
                    continue
                c1, c2 = min(2 * node + 1, last), min(2 * node + 2, last)
                b0, b1 = bnd[c1], bnd[c2]
                pushes = ((c2, b1), (c1, b0)) if b0 < b1 else ((c1, b0), (c2, b1))
                for c, b in pushes:
                    if b < worst:
                        stack.append((c, b))
            if not blist:
                continue
            kl = fold_round(kl, d2[blist].reshape(-1), gid[blist].reshape(-1), k)
            worst = kl[-1][0]
        out_d[qi] = torch.tensor([e[0] for e in kl], dtype=torch.float32)
        out_i[qi] = torch.tensor([e[1] for e in kl], dtype=torch.int32)
    return out_d, out_i
