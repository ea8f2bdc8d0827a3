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
lists; it raises rather than fall back. On a CPU tensor it runs
the plain version, :func:`knn_scan_plain`: the distance block of each point
tile, then packed int64 (d2, index) keys and ``torch.topk``. The two agree
bit for bit, and neither answer depends on the tiling.

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

TILE = 64  # queries a block: csrc/knn_scan.cu's kTQ
SMEM_K = 64  # kSmemK there: longer k-lists live in the partial buffers in device memory
MIN_CHUNK = 512  # the least points a chunk (four of the kernel's 128-point stages)
MAX_SPLITS = 65535  # the grid's y extent
MAX_POINTS = (1 << 31) - 1  # ids are int32
_TILE_ELEMS = 1 << 26  # [Q, tile] block elements per step of the plain version

_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 \
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


def plan_splits(Q: int, n: int, k: int, slots: int) -> int:
    """The point chunks S of one call: as many as keep the grid of ceil(Q
    / TILE) x S blocks within one wave of ``slots`` resident blocks (one
    chunk when the query tiles alone fill it), each chunk at least
    max(k, MIN_CHUNK) points."""
    tiles = -(-Q // TILE)
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


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("knn_scan")
    lib.knn_scan_launch.argtypes = _LAUNCH_ARGTYPES
    lib.knn_scan_launch.restype = ctypes.c_int
    lib.knn_scan_slots.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.knn_scan_slots.restype = ctypes.c_int
    lib.knn_scan_tile.restype = ctypes.c_int
    if lib.knn_scan_tile() != TILE:
        raise RuntimeError(f"csrc/knn_scan.cu takes {lib.knn_scan_tile()} queries a block, "
                           f"kernels/knn_scan.py plans for {TILE}")
    return lib


@functools.lru_cache(maxsize=None)
def slots(index: int, d: int, k: int) -> int:
    """Blocks of the kernel for (d, k) resident on the card at once."""
    with torch.cuda.device(index):
        per_sm = _lib().knn_scan_slots(d, k)
    if per_sm < 0:
        raise RuntimeError(f"knn_scan occupancy query failed with CUDA error {-per_sm}")
    return max(1, per_sm) * _sm_count(index)


def knn_scan(points: torch.Tensor, queries: torch.Tensor, k: int, tile: int | None = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2 f32[Q, k], ids i32[Q, k]): the k smallest (d2, index) of the
    rows of ``points`` f32[N, D] to each row of ``queries`` f32[Q, D], both
    contiguous on one device, ascending; ``k`` is clamped to N. CUDA
    tensors launch the fused kernel over :func:`plan_splits`'s point
    chunks; CPU tensors run :func:`knn_scan_plain`, whose point tiles
    ``tile`` sets. Neither changes the answer."""
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
    S = plan_splits(Q, n, k, slots(index, d, k))
    T = -(-Q // TILE)
    pd = torch.empty((T, S, TILE, k), dtype=torch.float32, device=dev)
    pi = torch.empty((T, S, TILE, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.knn_scan_launch(queries.data_ptr(), points.data_ptr(), pd.data_ptr(),
                                  pi.data_ptr(), Q, n, d, k, S,
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_scan kernel launch failed with CUDA error {err}")
    knn_scan.launches += 1
    if S > 1:
        pd, pi = merge_partials(pd, pi)
    return pd.view(T * TILE, k)[:Q], pi.view(T * TILE, k)[:Q]


knn_scan.launches = 0
