"""The Morton DFS: wrapper, checks, launch count and the kernel's mirror.

:func:`morton_dfs` answers exact k-NN on a Morton bucket tree by the
per-query best-first DFS of the JAX package's XLA program
``kdtree_tpu/ops/morton.py::_morton_knn_one`` (``:403``). On a CUDA tensor
it launches the hand-written kernel of ``csrc/morton_dfs.cu`` (built by
:mod:`kdtree_tpu_torch.kernels._build` at first use, bound through ctypes),
one launch for the whole batch, or raises; it never falls back. The kernel
has two layouts with the same bits, and :func:`layout_for` picks one from
the batch and the card: a block of :data:`BLOCK_WARPS` warps a query for
small batches, one warp a query for large ones. On a CPU tensor it runs
the plain version, :func:`kdtree_tpu_torch.ops.morton.morton_knn_plain`
(the lockstep loop ``_morton_knn_batch`` over chunks of queries). The two
agree bit for bit, d2 and ids, and neither answer depends on the chunking.

:func:`morton_dfs_mirror` follows the kernel's control flow query by query
on the CPU, in either layout: the walk and its windows of bounds, each
warp's share of a round in batches of 32 candidates (the survivor filter,
the bitonic sort of a batch's survivors and its merge into the selection
by ranks), the block layout's join of its warps' selections, and the
selection's merge into the k-list by (d2, id). The CPU tests hold it
bit-equal to the plain loop and to the reference.

``morton_dfs.launches`` counts the calls that launched the kernel (a plain
integer), so a run can show that its main path went through it.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from kdtree_tpu_torch.kernels import _build
from kdtree_tpu_torch.kernels.scan_knn import _check
from kdtree_tpu_torch.ops._arith import sq_dist
from kdtree_tpu_torch.ops.morton import (
    _QUERY_COLLECT, DfsStats, MortonTree, _bbox_d2, morton_knn_plain,
)

SMEM_K = 64  # kSmemK in the source: longer lists live in device memory (a scratch)
MAX_LEVELS = 31  # the kernel's stack holds 2 * 31 + 2 entries
MAX_HEAP = (1 << 31) - 1  # node indices are int32
WINDOW_LEVELS = 5  # kL: a window holds the 2 + 4 + ... + 32 boxes below its root
BLOCK_WARPS = 8  # kBlockW: the block layout's warps a query
# kUWarp, kUBlock: rows a lane loads before any is tested, by layout and D == 3
LANE_ROWS = {("warp", True): 4, ("warp", False): 8, ("block", True): 8, ("block", False): 4}
STAMP_COLS = ("total", "walk", "scan", "select", "merge", "windows")  # clock64 sums a query
# the block layout up to this many queries an SM, the warp layout past it:
# the crossover chip_smoke.py's phase 3d measures (at 3-D it lies between 8
# and 16 a card's SM; at 8 some other shapes already run faster one warp a
# query)
BLOCK_QUERIES_PER_SM = 4
LAYOUTS = ("warp", "block")
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn():
    lib = _build.load("morton_dfs")
    fn = lib.morton_dfs_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.morton_dfs_scratch.argtypes = [ctypes.c_int]
    lib.morton_dfs_scratch.restype = ctypes.c_int
    return fn, lib.morton_dfs_scratch


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layout_for(q: int, sms: int) -> str:
    """The kernel's layout for a batch of ``q`` queries on a card of
    ``sms`` SMs: ``"block"`` (one block of :data:`BLOCK_WARPS` warps a
    query) up to :data:`BLOCK_QUERIES_PER_SM` queries an SM, else
    ``"warp"`` (one warp a query)."""
    return "block" if q <= BLOCK_QUERIES_PER_SM * sms else "warp"


def _check_args(tree: MortonTree, queries: torch.Tensor, k: int, seen, stamps,
                layout) -> None:
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
    if nb * B >= 1 << 32 or _QUERY_COLLECT * B >= 1 << 31:
        raise ValueError(f"{nb} buckets of {B} rows are past the kernel's 2^32 rows or its "
                         f"2^31 positions a round")
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if seen is not None:
        nodes, buckets, work = seen
        _check("seen nodes", nodes, torch.uint8, (H,), dev)
        _check("seen buckets", buckets, torch.uint8, (nb,), dev)
        _check("seen work", work, torch.int64, (3,), dev)
    if stamps is not None:
        _check("stamps", stamps, torch.int64, (queries.shape[0], len(STAMP_COLS)), dev)


def morton_dfs(tree: MortonTree, queries: torch.Tensor, k: int, chunk: int = 4096,
               stats: DfsStats | None = None, seen=None, stamps=None,
               _layout: str | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2 f32[Q, k], ids i32[Q, k]) ascending by (d2, id): the k nearest
    points of ``tree`` to each row of ``queries`` f32[Q, D], as
    ``kdtree_tpu.morton_knn`` answers them, ties included; slots past the
    tree's points are (+inf, -1). Queries and tree on one device,
    contiguous. CUDA tensors launch the kernel over the whole batch
    (``stats`` counts one chunk and one launch, no host sync) in the
    layout :func:`layout_for` picks (``_layout`` forces one, for the
    kernel's checks; both give the same bits); CPU tensors run the plain
    version in chunks of ``chunk`` queries (``stats`` counts its chunks,
    steps, scans and host syncs). ``seen`` and ``stamps``, CUDA tensors,
    are measurements and leave the answer as it is: ``seen`` (nodes
    u8[H], buckets u8[NB], work i64[3]) takes the flag of every child box
    and bucket the walk reads and adds its box bounds, scanned pairs and
    the boxes its windows load to ``work``; ``stamps`` i64[Q, 6] takes
    each query's clock64() sums (:data:`STAMP_COLS`) from a stamped
    instantiation of the kernel."""
    dev = queries.device
    _check_args(tree, queries, k, seen, stamps, _layout)
    if dev.type == "cpu":
        if seen is not None or stamps is not None:
            raise ValueError("seen and stamps are the kernel's measurements: they take "
                             "CUDA tensors")
        return morton_knn_plain(tree, queries, k, chunk, stats)
    if dev.type != "cuda":
        raise ValueError(f"morton_dfs runs on CUDA or CPU tensors, got {dev}")
    fn, scratch = _fn()
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
    layout = _layout or layout_for(Q, _sm_count(dev.index if dev.index is not None
                                                else torch.cuda.current_device()))
    block = int(layout == "block")
    scr_key = scr_id = None
    if k > SMEM_K:  # the k-list and the selections live in a scratch
        n = scratch(block)
        scr_key = torch.empty((Q, (n & 0xFFFF) * k), dtype=torch.int64, device=dev)
        scr_id = torch.empty((Q, (n >> 16) * k), dtype=torch.int32, device=dev)
    nodes, buckets, work = seen if seen is not None else (None, None, None)
    nb, B, _ = tree.bucket_pts.shape

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):  # the launch goes to the current device
        err = fn(queries.data_ptr(), tree.node_lo.data_ptr(), tree.node_hi.data_ptr(),
                 tree.bucket_pts.data_ptr(), tree.bucket_gid.data_ptr(), out_d.data_ptr(),
                 out_i.data_ptr(), ptr(scr_key), ptr(scr_id), ptr(nodes), ptr(buckets),
                 ptr(work), ptr(stamps), Q, D, B, k, nb, tree.node_lo.shape[0], block,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"morton_dfs kernel launch failed with CUDA error {err}")
    morton_dfs.launches += 1
    if stats is not None:
        stats.chunks += 1
        stats.launches += 1
    return out_d, out_i


morton_dfs.launches = 0


KNONE = (1 << 64) - 1  # kNone: above every key
_INF = float("inf")


@dataclass
class MirrorStats:
    """What :func:`morton_dfs_mirror` did, for the tests to show each path
    of the kernel was reached: window loads (and of those, moves of a band
    to another root, a popped sibling outside the window), boxes loaded,
    expansions, buffered survivors merged 32 at a time (sorted, or one
    alone), batches whose survivors the lanes' least keys bounded, merges
    into a list past one chunk of 32, and rounds whose warps'
    selections were joined with more than one warp holding entries."""

    window_loads: int = 0
    bounded_batches: int = 0
    window_moves: int = 0
    boxes_loaded: int = 0
    expansions: int = 0
    sorted_groups: int = 0
    single_groups: int = 0
    long_merges: int = 0
    joins: int = 0


def _key(d2: float, low: int) -> int:
    return (int(np.float32(d2).view(np.uint32)) << 32) | (low & 0xFFFFFFFF)


def _id_bits(i: int) -> int:  # the kernel's id_bits: signed order as unsigned
    return (i & 0xFFFFFFFF) ^ 0x80000000


def _key_d2(key: int) -> float:
    return float(np.uint32(key >> 32).view(np.float32))


def sort32(keys, ids):
    """The kernel's ``sort32``: a bitonic network over the 32 lanes
    (partner ``lane ^ stride``; the lower lane of an ascending pair keeps
    the smaller key), ids travelling with their keys."""
    # kdt-lint: disable=KDT201 the mirror's keys are host python ints, not a device value
    keys = np.array(keys, dtype=np.uint64)
    # kdt-lint: disable=KDT201 the mirror's ids are host python ints, not a device value
    ids = np.array(ids, dtype=np.int64)
    lane = np.arange(32)
    size = 2
    while size <= 32:
        stride = size >> 1
        while stride:
            other, other_id = keys[lane ^ stride], ids[lane ^ stride]
            up = (lane & size) == 0
            low = (lane & stride) == 0
            take = np.where(low == up, other < keys, other > keys)
            keys = np.where(take, other, keys)
            ids = np.where(take, other_id, ids)
            stride >>= 1
        size <<= 1
    return [int(x) for x in keys], [int(x) for x in ids]


def _group_rank(gk, x: int) -> int:
    """The kernel's ``group_rank``: the keys of the sorted group below x,
    by the binary search over shuffles (steps 16, 8, 4, 2, 1, then one)."""
    c = 0
    for step in (16, 8, 4, 2, 1):
        if gk[c + step - 1] < x:
            c += step
    return c + 1 if gk[c] < x else c


def merge_group(lk: list, li, n: int, k: int, gk, gi, g: int, stats=None) -> int:
    """The kernel's ``merge_group``, in place on the list ``lk`` (and its
    ids ``li``, or None) of capacity k holding n ascending keys: the sorted
    group's g keys (``gk[:g]``, KNONE above) go to their ranks (a search of
    the list before anything moves, after its equal keys), the list's
    entries move up by theirs among the group's keys, chunk by chunk from
    the top, each chunk read before it is written; whatever lands at k or
    above drops out."""
    to = [lane + bisect.bisect_right(lk, gk[lane], 0, n) if lane < g else None
          for lane in range(32)]
    if stats is not None and n > 32:
        stats.long_merges += 1
    for c in range((n - 1) >> 5, -1, -1):
        moves = []
        for lane in range(32):
            e = (c << 5) + lane
            x = lk[e] if e < n else KNONE
            r = e + _group_rank(gk, x)
            if e < n and r < k:
                moves.append((r, x, li[e] if li is not None else None))
        for r, x, xi in moves:
            lk[r] = x
            if li is not None:
                li[r] = xi
    for lane in range(g):
        if to[lane] < k:
            lk[to[lane]] = gk[lane]
            if li is not None:
                li[to[lane]] = gi[lane]
    return min(k, n + g)


class _Sel:
    """A selection: ascending (d2, position) keys and their ids."""

    def __init__(self, k):
        self.key, self.id, self.n, self.thr = [0] * k, [0] * k, 0, 0


def _scan_range(s: _Sel, cd, ci, p0: int, p1: int, worst: float, k: int, rows: int,
                bounded: bool, stats) -> None:
    """The kernel's ``scan_range``: a warp's positions [p0, p1) of the
    round in batches of ``rows`` rows a lane. A batch's survivors (tested
    against the selection as it stood when the batch began; with more than
    32 of them, k <= 32 and ``bounded``, also at or below the k-th smallest
    of the lanes' least keys) go to a buffer in position order; then the
    buffer, 32 at a time, is tested again against the tightened threshold,
    sorted and merged."""
    for base in range(p0, p1, 32 * rows):
        n0, thr0 = s.n, s.thr
        ok = []
        for p in range(base, min(p1, base + 32 * rows)):
            d, x = float(cd[p]), _key(cd[p], p)
            if d <= worst and d < _INF and (n0 < k or x < thr0):
                ok.append((p, x))
        bound = KNONE
        if bounded and k <= 32 and len(ok) > 32:
            least = [KNONE] * 32  # lane p % 32's least key
            for p, x in ok:
                least[(p - base) % 32] = min(least[(p - base) % 32], x)
            bound = sort32(least, [0] * 32)[0][k - 1]
            stats.bounded_batches += 1
        buf = [(x, int(ci[p])) for p, x in ok if x <= bound]
        for b in range(0, len(buf), 32):
            part = buf[b:b + 32]
            gk = [KNONE if s.n == k and x >= s.thr else x for x, _ in part]
            gk += [KNONE] * (32 - len(gk))
            gi = [i for _, i in part] + [part[0][1]] * (32 - len(part))
            real = [x != KNONE for x in gk]
            g = sum(real)
            if not g:
                continue
            if real[0] and g == 1:  # one survivor in lane 0 is sorted
                stats.single_groups += 1
            else:
                gk, gi = sort32(gk, gi)
                stats.sorted_groups += 1
            s.n = merge_group(s.key, s.id, s.n, k, gk, gi, g, stats)
            if s.n == k:
                s.thr = s.key[k - 1]


def _merge_klist(kl: list, sk, si, n: int, k: int, stats) -> None:
    """The kernel's ``merge_klist``: the selection into the k-list by
    (d2, id), 32 entries at a time re-keyed, sorted and merged."""
    for c in range(0, n, 32):
        gk = [(sk[e] & ~0xFFFFFFFF) | _id_bits(si[e]) if e < n else KNONE
              for e in range(c, c + 32)]
        if n - c > 1:  # one entry is sorted
            gk, _ = sort32(gk, [0] * 32)
        merge_group(kl, None, k, k, gk, None, min(32, n - c), stats)


def fold_round(kl: list, cd: np.ndarray, ci: np.ndarray, k: int, layout: str = "warp",
               stats: MirrorStats | None = None, D: int = 3) -> list:
    """One scan round's fold as the kernel does it in ``layout``: ``kl``
    the k-list of (d2, id) pairs, ascending; ``cd``/``ci`` the round's
    candidates (float32 d2 and int32 ids) in position order; ``D`` the
    tree's axes (the kernel's batches depend on it). Each warp's
    share of the positions (all of them in the warp layout; contiguous
    shares in warp order in the block layout) folds into its selection,
    the k smallest survivors (d2 at or below the list's last, finite) by
    (d2, position); the block layout joins the warps' selections by rank;
    the selection then merges into the list by (d2, id). Returns the new
    list."""
    stats = stats if stats is not None else MirrorStats()
    worst = kl[-1][0]
    keys = [_key(d, _id_bits(i)) for d, i in kl]
    total = len(cd)
    if layout == "warp":
        s = _Sel(k)
        _scan_range(s, cd, ci, 0, total, worst, k, LANE_ROWS[layout, D == 3], D <= 32, stats)
        sk, si, n = s.key, s.id, s.n
    else:
        share = -(-total // (32 * BLOCK_WARPS)) * 32
        sels = []
        for v in range(BLOCK_WARPS):
            s = _Sel(k)
            p0 = min(total, v * share)
            _scan_range(s, cd, ci, p0, min(total, p0 + share), worst, k,
                        LANE_ROWS[layout, D == 3], D <= 32, stats)
            sels.append(s)
        stats.joins += sum(s.n > 0 for s in sels) > 1
        sk, si = [0] * k, [0] * k
        for v, s in enumerate(sels):  # an entry's rank: its index plus its rank elsewhere
            for i in range(s.n):
                x = s.key[i]
                rank = i + sum(bisect.bisect_right(o.key, x, 0, o.n)
                               for u, o in enumerate(sels) if u != v)
                if rank < k:
                    sk[rank], si[rank] = x, s.id[i]
        n = min(k, sum(s.n for s in sels))
    _merge_klist(keys, sk, si, n, k, stats)
    return [(_key_d2(x), int(np.uint32(_id_bits(x)).view(np.int32))) for x in keys]


def morton_dfs_mirror(tree: MortonTree, queries: torch.Tensor, k: int, layout: str = "warp",
                      stats: MirrorStats | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's control flow in ``layout``, one query at a time, on
    CPU tensors. A query's box bounds to every node and distances to every
    bucket row are computed first, in the kernel's arithmetic
    (``_bbox_d2``, ``sq_dist``); the walk (its windows: a band's 62 bounds
    read at once, kept until the walk moves to another subtree) and the
    rounds (:func:`fold_round`) then run in Python on those float32
    values, exactly as ``csrc/morton_dfs.cu`` orders them. ``stats``
    (:class:`MirrorStats`) counts the paths taken."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    stats = stats if stats is not None else MirrorStats()
    Q = queries.shape[0]
    out_d = torch.full((Q, k), _INF, dtype=torch.float32)
    out_i = torch.full((Q, k), -1, dtype=torch.int32)
    if k == 0:
        return out_d, out_i
    nb, B, D = tree.bucket_pts.shape
    first_leaf = nb - 1
    last = tree.node_lo.shape[0] - 1
    ld = nb.bit_length() - 1  # the leaves' depth
    L = WINDOW_LEVELS
    gid = tree.bucket_gid.numpy()
    for qi in range(Q):
        q = queries[qi]
        bnd = _bbox_d2(q, tree.node_lo, tree.node_hi).tolist()
        d2 = sq_dist(q, tree.bucket_pts).numpy()  # [NB, B]
        kl = [(_INF, -1)] * k  # the k-list, ascending by (d2, id)
        stack = [(0, 0.0)]  # the root, bound 0
        win, root = {}, {}  # band -> its window's bounds and root
        worst = _INF
        while stack:
            blist = []
            held = None  # an expansion's nearer child, taken without the stack
            while (stack or held) and not blist:
                while (stack or held) and len(blist) < _QUERY_COLLECT:
                    node, bound = held if held else stack.pop()
                    held = None
                    if not bound < worst:
                        continue
                    if node >= first_leaf:
                        blist.append(node - first_leaf)
                        continue
                    c1, c2 = min(2 * node + 1, last), min(2 * node + 2, last)
                    dn = (node + 1).bit_length() - 1
                    band = (ld - dn - 1) // L
                    rdep = max(0, ld - L * (band + 1))
                    r = ((node + 1) >> (dn - rdep)) - 1
                    if root.get(band) != r:
                        nl = ld - L * band - rdep
                        slots = range((2 << nl) - 2)
                        win[band] = [bnd[((r + 1) << j) - 1 + (s + 2 - (1 << j))]
                                     for s, j in ((s, (s + 2).bit_length() - 1) for s in slots)]
                        stats.window_moves += band in root
                        stats.window_loads += 1
                        stats.boxes_loaded += len(slots)
                        root[band] = r
                    j = dn + 1 - rdep
                    slot = (1 << j) - 2 + 2 * (node + 1) - ((r + 1) << j)
                    b0, b1 = win[band][slot], win[band][slot + 1]
                    stats.expansions += 1
                    (fc, fb), (nc, nbd) = ((c2, b1), (c1, b0)) if b0 < b1 else ((c1, b0), (c2, b1))
                    if fb < worst:
                        stack.append((fc, fb))
                    held = (nc, nbd) if nbd < worst else None  # pushed, then popped next
            if not blist:
                break
            kl = fold_round(kl, d2[blist].reshape(-1), gid[blist].reshape(-1), k, layout,
                            stats, D)
            worst = kl[-1][0]
        out_d[qi] = torch.tensor([e[0] for e in kl], dtype=torch.float32)
        out_i[qi] = torch.tensor([e[1] for e in kl], dtype=torch.int32)
    return out_d, out_i
