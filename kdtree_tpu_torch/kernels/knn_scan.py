"""The exact k-NN oracle's fused kernel: wrapper, plain version, plan and
launch count.

:func:`knn_scan` returns the k smallest (d2, point index) per query row,
ascending, the lowest index first on equal distances, with d2 in the
arithmetic of the JAX package's jitted ``_knn_scan``
(``kdtree_tpu/ops/bruteforce.py:59``): the fused multiply-add chain up to
32 axes, rounded squares summed in windows of 32 above
(:func:`kdtree_tpu_torch.ops._arith.sq_dist`). A slot at +inf (a masked
row's distance) has id -1, as the reference's running top-k gives it: it
starts from (+inf, -1) entries, which win every tie at +inf. ``k`` is
clamped to the point count. On a CUDA tensor it launches the hand-written
kernel of ``csrc/knn_scan.cu`` (built by
:mod:`kdtree_tpu_torch.kernels._build` at first use, bound through ctypes),
which keeps the distances on chip: S blocks a query tile each take the k
best of an ascending index range of the points, and the merge kernel
(:func:`kdtree_tpu_torch.kernels.scan_knn.merge_partials`) joins the S
lists; it raises rather than fall back. At every D a block is 8 query rows
a query warp (one warp for an 8-row batch) and a producer warp that copies
the points in stages (1,024 rows at D = 3, about 8 KB of rows elsewhere,
:func:`stage_rows`) by bulk copies into a ring. When the call culls
(always at D = 3, else past one tile of queries), a first kernel writes
the boxes of the chunks' stages, and a stage is copied in only when its
box does not exclude some query of the block, and computed by a warp only
when it does not exclude some query of the warp, against thresholds the
chunks share (the source's note; the plain mirror is :func:`tile_boxes`
with :func:`tile_lb_plain`, and the per-warp rule's
:func:`knn_scan_culled_partials_plain`). On a CPU tensor it runs the plain
version, :func:`knn_scan_plain`: the distance block of each point tile,
then packed int64 (d2, index) keys and ``torch.topk``. The two agree bit
for bit, and neither answer depends on the tiling or the cull. On a card
the built kernel says how many query rows a block takes, how many rows a
stage holds and how large its box table is (``knn_scan_tile``,
``knn_scan_stage``, ``knn_scan_box_floats``); ``TILE``, ``WARPS``,
``STAGE``, :func:`tile_rows` and :func:`stage_rows` mirror that layout for
the CPU tests.

``knn_scan.launches`` counts the calls that launched the kernel (a plain
integer), so a run can show that its main path went through it.
:func:`knn_scan_partials_plain` builds the kernel's partial lists from the
plain version, the CPU tests' account of why the chunked answer is the
whole one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from kdtree_tpu_torch.kernels import _build
from kdtree_tpu_torch.kernels.pair_d2 import pair_d2_plain
from kdtree_tpu_torch.kernels.scan_knn import _check, _sm_count, merge_partials
from kdtree_tpu_torch.ops._arith import sq_dist_to_box

# The kernel's layout as the CPU mirrors take it (csrc/knn_scan.cu's kRQ,
# kWarps, kStage3 and kStageBytes; on a card the build's own values are used)
WARP_ROWS = 8  # query rows a warp
WARPS = 7  # query warps a block at most
TILE = WARPS * WARP_ROWS  # query rows a block at most
STAGE = 1024  # points a stage at D = 3: its cull's tiles
STAGE_BYTES = 8192  # a stage's rows at other D, about (whole tiles of 128 rows, one at least)
SMEM_K = 64  # kSmemK there: longer k-lists live in the partial buffers in device memory
MIN_CHUNK = 512  # the least points a chunk (four of the kernel's 128-point tiles)
MAX_SPLITS = 65535  # the grid's y extent
MAX_POINTS = (1 << 31) - 1  # ids are int32
_TILE_ELEMS = 1 << 26  # [Q, tile] block elements per step of the plain version
_NO_THRESHOLD = 0xFFFFFFFF  # a shared threshold no chunk has lowered yet

_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]


def _keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 (d2, idx) sort keys; d2 >= 0 (or +inf), 0 <= idx < 2^31. The
    float32 bits of a non-negative distance order like the distance, so
    every key is distinct and ``torch.topk`` over keys has no ties to
    break: its result is the same set, in the same order, on every
    device."""
    return (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | idx


def _unkey(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d2 = (keys >> 32).to(torch.int32).view(torch.float32)
    return d2, (keys & 0xFFFFFFFF).to(torch.int32)


def _smallest(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest keys per row, ascending (keys are distinct)."""
    return torch.topk(keys, k, dim=1, largest=False, sorted=True).values


def knn_scan_plain(points: torch.Tensor, queries: torch.Tensor, k: int,
                   tile: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: point tiles of ``tile`` rows (at least k), each tile's [Q,
    tile] distance block (:func:`pair_d2_plain`) packed into (d2, index)
    keys and the k smallest kept with the running best, ids at +inf set
    to -1. ``k`` <= N."""
    n, d = points.shape
    Q = queries.shape[0]
    tile = max(_TILE_ELEMS // max(Q * max(d, 1), 1) if tile is None else tile, k, 1)
    best = None
    for base in range(0, n, tile):
        ptile = points[base: base + tile]
        t = ptile.shape[0]
        idx = torch.arange(base, base + t, dtype=torch.int64, device=points.device)
        cand = _smallest(_keys(pair_d2_plain(queries, ptile), idx[None, :].expand(Q, t)),
                         min(k, t))
        best = _smallest(cand if best is None else torch.cat([best, cand], 1), k)
    d2, ids = _unkey(best)
    return d2, ids.masked_fill_(torch.isinf(d2), -1)


def tile_rows(Q: int, d: int) -> int:
    """The query rows a block takes for Q queries of d axes (the partials'
    third extent), as the kernel's ``knn_scan_tile`` picks them, at every d:
    8 a query warp, the ceil(Q / 8) warps shared out evenly over as few
    tiles of at most WARPS warps as hold them, so a small batch computes no
    rows past the next 8."""
    warps = -(-max(Q, 1) // WARP_ROWS)
    tiles = -(-warps // WARPS)
    return WARP_ROWS * -(-warps // tiles)


def stage_rows(d: int) -> int:
    """Rows a stage of the kernel at d axes (``knn_scan_stage``): STAGE at
    d = 3, else about STAGE_BYTES of rows in whole tiles of 128, one at
    least."""
    if d == 3:
        return STAGE
    return max(128, STAGE_BYTES // (4 * d) // 128 * 128)


def plan_splits(Q: int, n: int, k: int, slots: int, tq: int = TILE) -> int:
    """The point chunks S of one call: as many as keep the grid of ceil(Q
    / tq) x S blocks within one wave of ``slots`` resident blocks (one
    chunk when the query tiles alone fill it), each chunk at least
    max(k, MIN_CHUNK) points. ``tq`` is the kernel's tile for the call
    (:func:`tile_rows`), and ``slots`` counts blocks of that layout."""
    tiles = -(-Q // tq)
    S = max(1, slots // max(tiles, 1))
    return max(1, min(S, n // max(k, MIN_CHUNK), MAX_SPLITS))


def chunk_bounds(n: int, S: int) -> list[tuple[int, int]]:
    """The kernel's chunks: floor(n / S) points each, the last to n."""
    c = n // S
    return [(s * c, n if s == S - 1 else (s + 1) * c) for s in range(S)]


def knn_scan_partials_plain(points: torch.Tensor, queries: torch.Tensor, k: int, S: int,
                            tq: int = TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's partial lists from the plain version: (pd f32[T, S, tq,
    k], pi i32[T, S, tq, k]), T = ceil(Q / tq), chunk s's k smallest (d2,
    index) per query row (rows past Q repeat the last query), for any
    ``tq``. Every chunk must hold at least k points."""
    n = points.shape[0]
    Q = queries.shape[0]
    T = -(-Q // tq)
    qp = torch.cat([queries, queries[-1:].expand(T * tq - Q, -1)])
    pd = torch.empty((T, S, tq, k), dtype=torch.float32, device=points.device)
    pi = torch.empty((T, S, tq, k), dtype=torch.int32, device=points.device)
    for s, (lo, hi) in enumerate(chunk_bounds(n, S)):
        if hi - lo < k:
            raise ValueError(f"chunk {s} holds {hi - lo} points, fewer than k={k}")
        d2, ids = knn_scan_plain(points[lo:hi], qp, k)
        pd[:, s] = d2.view(T, tq, k)
        pi[:, s] = torch.where(ids < 0, ids, ids + lo).view(T, tq, k)
    return pd, pi


def tile_boxes(rows: torch.Tensor, stage: int = STAGE) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) f32[G, D]: the box of each run of ``stage`` consecutive rows
    (the last may be shorter), as the kernel's box table holds it:
    per axis lo is the min over the rows and hi the max over the rows whose
    first coordinate is not +inf (pad and masked rows, whose d2 is +inf),
    NaN passed over; a run of such rows alone has hi = -inf, which bounds
    at +inf."""
    n, d = rows.shape
    g = -(-n // stage)
    inf = float("inf")
    x = torch.cat([rows, rows.new_full((g * stage - n, d), inf)]).view(g, stage, d)
    nan = torch.isnan(x)
    keep = (x[..., :1] != inf) & ~nan
    return (torch.where(nan, inf, x).amin(dim=1), torch.where(keep, x, -inf).amax(dim=1))


def tile_lb_plain(queries: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """f32[Q, G]: each query's lower bound to each box, in d2's arithmetic
    (:func:`~kdtree_tpu_torch.ops._arith.sq_dist_to_box`: per axis the gap
    lo - q or q - hi, 0 inside, then the FMA chain, windows of 32 above 32
    axes), the kernel's ``box_bound``. Rounding is monotone in each gap, so
    every row inside a box has d2 bits >= the bound's, and a row left out
    of it has d2 = +inf."""
    return sq_dist_to_box(queries[:, None, :], lo[None], hi[None])


def _bits(d2: torch.Tensor) -> torch.Tensor:
    """float32 bits as non-negative int64: the order of d2 >= 0 and +inf."""
    return d2.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def knn_scan_culled_partials_plain(points: torch.Tensor, queries: torch.Tensor, k: int,
                                   S: int, tq: int = TILE, stage: int = STAGE
                                   ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """The kernel's cull in plain torch, at any D: (pd, pi, culled,
    examined) with pd/pi as :func:`knn_scan_partials_plain`'s. Query rows
    go in warps of 8 (rows past Q repeat the last query); every chunk's
    stages of ``stage`` points run in turn, stage g of every chunk before
    stage g + 1. A warp skips a stage when each of its queries' bounds to
    the stage's box (:func:`tile_boxes`, :func:`tile_lb_plain`) is
    strictly above its threshold: the smaller of its chunk's own k-th and
    the query's shared word, which every full chunk list lowers to its
    k-th's bits after each stage; survivors above the threshold are
    dropped as the kernel's compare drops them. At a warp's first stage
    in a chunk, up to k = 32 and at D != 3, each query's threshold and
    shared word are first lowered to the k-th smallest of the 32 lanes'
    least distance bits over the stage's first 128 points (lane l's:
    points l, l + 32, l + 64, l + 96), as the kernel's ``first_bounds``
    does. (The kernel's producer skips a stage for the whole block only
    where every warp would.) Lists short of k are padded with (+inf, -1)
    and ids at +inf are -1. ``culled`` and ``examined`` count (warp,
    stage) pairs."""
    n = points.shape[0]
    Q = queries.shape[0]
    T = -(-Q // tq)
    rows = T * tq
    dev = points.device
    row_q = torch.arange(rows, device=dev).clamp_max(Q - 1)
    qp = queries[row_q]
    none = torch.iinfo(torch.int64).max
    keys = torch.full((S, rows, k), none, dtype=torch.int64, device=dev)
    shared = torch.full((Q,), _NO_THRESHOLD, dtype=torch.int64, device=dev)
    bounds = chunk_bounds(n, S)
    fresh = torch.ones((S, rows // WARP_ROWS), dtype=torch.bool, device=dev)
    culled = examined = 0
    for g in range(-(-max(hi - lo for lo, hi in bounds) // stage)):
        for s, (lo, hi) in enumerate(bounds):
            a = lo + g * stage
            if a >= hi:
                continue
            tile = points[a: min(a + stage, hi)]
            blo, bhi = tile_boxes(tile, stage)
            lb = _bits(tile_lb_plain(qp, blo, bhi)[:, 0])
            kth = keys[s, :, k - 1]
            own = torch.where(kth == none, _NO_THRESHOLD, kth >> 32)
            thr = torch.minimum(own, shared[row_q])
            live = (lb <= thr).view(rows // WARP_ROWS, WARP_ROWS).any(dim=1)
            examined += live.numel()
            culled += int((~live).sum())
            if not live.any():
                continue
            sel = live.repeat_interleave(WARP_ROWS).nonzero().squeeze(1)
            idx = torch.arange(a, a + tile.shape[0], dtype=torch.int64, device=dev)
            d2 = pair_d2_plain(qp[sel], tile)
            first = fresh[s][live].repeat_interleave(WARP_ROWS)
            fresh[s] &= ~live
            if k <= 32 and points.shape[1] != 3 and first.any():
                head = torch.full((int(first.sum()), 128), _NO_THRESHOLD, dtype=torch.int64,
                                  device=dev)
                head[:, :min(128, tile.shape[0])] = _bits(d2[first, :128])
                t0 = head.view(-1, 4, 32).amin(dim=1).sort(dim=1).values[:, k - 1]
                rf = sel[first]
                thr[rf] = torch.minimum(thr[rf], t0)
                shared = shared.scatter_reduce(0, row_q[rf], t0, "amin")
            new = _keys(d2, idx[None, :].expand_as(d2))
            new = torch.where(_bits(d2) <= thr[sel, None], new, none)
            keys[s, sel] = _smallest(torch.cat([keys[s, sel], new], 1), k)
        kth = keys[:, :, k - 1]
        full = torch.where(kth == none, _NO_THRESHOLD, kth >> 32).amin(dim=0)
        shared = shared.scatter_reduce(0, row_q, full, "amin")
    pad = keys == none
    d2, ids = _unkey(torch.where(pad, 0x7F800000 << 32, keys))
    ids = ids.masked_fill_(torch.isinf(d2), -1)
    pd = d2.view(S, T, tq, k).transpose(0, 1).contiguous()
    pi = ids.view(S, T, tq, k).transpose(0, 1).contiguous()
    return pd, pi, culled, examined


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("knn_scan")
    lib.knn_scan_launch.argtypes = _LAUNCH_ARGTYPES
    lib.knn_scan_launch.restype = ctypes.c_int
    lib.knn_scan_slots.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    lib.knn_scan_slots.restype = ctypes.c_int
    lib.knn_scan_tile.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.knn_scan_tile.restype = ctypes.c_int
    lib.knn_scan_stage.argtypes = [ctypes.c_int]
    lib.knn_scan_stage.restype = ctypes.c_int
    lib.knn_scan_box_floats.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                        ctypes.c_int]
    lib.knn_scan_box_floats.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _slots(index: int, d: int, k: int, tq: int) -> int:
    # the kernel's layout for tq queries is the one it picks for a call of tq rows
    with torch.cuda.device(index):
        per_sm = _lib().knn_scan_slots(d, k, tq)
    if per_sm < 0:
        raise RuntimeError(f"knn_scan occupancy query failed with CUDA error {-per_sm} "
                           f"(D = {d}: the kernel takes at most 256 axes, fewer where a "
                           f"stage does not fit shared memory)")
    return max(1, per_sm) * _sm_count(index)


def kernel_stage(d: int) -> int:
    """Points a stage of the built kernel at d axes: its cull's tiles."""
    return _lib().knn_scan_stage(d)


def plan(index: int, Q: int, n: int, d: int, k: int) -> Tuple[int, int]:
    """(tq, S): the query rows a block (the built kernel's ``knn_scan_tile``)
    and the point chunks (:func:`plan_splits` over the blocks of that
    layout resident on card ``index``) of a call; k <= n."""
    tq = _lib().knn_scan_tile(d, Q)
    return tq, plan_splits(Q, n, k, _slots(index, d, k, tq), tq)


def knn_scan(points: torch.Tensor, queries: torch.Tensor, k: int, tile: int | None = None,
             counts: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2 f32[Q, k], ids i32[Q, k]): the k smallest (d2, index) of the
    rows of ``points`` f32[N, D] to each row of ``queries`` f32[Q, D], both
    contiguous on one device, ascending; ``k`` is clamped to N. CUDA
    tensors launch the fused kernel over :func:`plan_splits`'s point
    chunks; CPU tensors run :func:`knn_scan_plain`, whose point tiles
    ``tile`` sets. Neither changes the answer. ``counts``, an int64[2]
    CUDA tensor, gets the kernel's culled and examined (warp, stage) pairs
    added to it (a measurement; the answer is the same; a call that does
    not cull counts every pair examined)."""
    dev = points.device
    if points.dim() != 2 or queries.dim() != 2:
        raise ValueError(f"knn_scan takes [N, D] points and [Q, D] queries, got shapes "
                         f"{tuple(points.shape)} and {tuple(queries.shape)}")
    n, d = points.shape
    Q = queries.shape[0]
    _check("points", points, torch.float32, (n, d), dev)
    _check("queries", queries, torch.float32, (Q, d), dev)
    if d < 1:
        raise ValueError("knn_scan takes rows of at least one axis")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"knn_scan runs on CUDA or CPU tensors, got {dev}")
    for name, x in (("points", points), ("queries", queries)):
        if x.data_ptr() % 4:
            raise ValueError(f"{name} must start on a 4-byte boundary")
    if counts is not None:
        _check("counts", counts, torch.int64, (2,), dev)
    k = min(k, n)
    if n > MAX_POINTS:
        raise ValueError(f"{n} points overflow the int32 ids")
    lib = _lib() if dev.type == "cuda" else None
    if Q == 0 or k == 0:
        return (torch.empty((Q, k), dtype=torch.float32, device=dev),
                torch.empty((Q, k), dtype=torch.int32, device=dev))
    if dev.type == "cpu":
        return knn_scan_plain(points, queries, k, tile)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    tq, S = plan(index, Q, n, d, k)
    T = -(-Q // tq)
    pd = torch.empty((T, S, tq, k), dtype=torch.float32, device=dev)
    pi = torch.empty((T, S, tq, k), dtype=torch.int32, device=dev)
    # the chunks' shared thresholds start all ones (no k-th yet); a call
    # that culls writes the stages' boxes to a table
    gthr = torch.full((T * tq,), -1, dtype=torch.int32, device=dev)
    nbox = lib.knn_scan_box_floats(d, Q, n, S)
    boxes = torch.empty((nbox,), dtype=torch.float32, device=dev) if nbox else None
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.knn_scan_launch(queries.data_ptr(), points.data_ptr(), pd.data_ptr(),
                                  pi.data_ptr(), gthr.data_ptr(),
                                  0 if boxes is None else boxes.data_ptr(),
                                  0 if counts is None else counts.data_ptr(), Q, n, d, k, S,
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_scan kernel launch failed with CUDA error {err}")
    knn_scan.launches += 1
    if S > 1:
        pd, pi = merge_partials(pd, pi)
    return pd.view(T * tq, k)[:Q], pi.view(T * tq, k)[:Q]


knn_scan.launches = 0
