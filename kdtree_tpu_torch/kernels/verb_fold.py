"""The query verbs' fold kernels: wrappers, checks and launch counts.

:func:`radius_fold` and :func:`range_fold` fold each query tile's candidate
buckets into exact per-query hit counts and an m-slot hit buffer. On a CUDA
tensor they launch the hand-written kernels of ``csrc/verb_fold.cu`` (built
by :mod:`kdtree_tpu_torch.kernels._build` at first use and bound through
ctypes) or raise; they never fall back. On a CPU tensor they run the plain
versions, :func:`_radius_fold_plain` and :func:`_range_fold_plain`, because
that is where the tensor lies. The kernels
replace no TPU kernel: the JAX package runs these folds as XLA programs
(``kdtree_tpu/verbs/device.py::_radius_tiles`` and ``::_range_tiles``).

The contract both paths keep: counts are exact; a query whose count is <= m
holds every hit in its buffer (the plain version in (d2, candidate position)
order, the kernel in arrival order; :func:`~kdtree_tpu_torch.verbs.device.
canonical_radius_rows` and ``canonical_range_rows`` make them equal); a
query with more hits holds some m of them, and the verbs' retry loop reruns it
with a buffer sized to its count. ``m = 0`` is the count form: the buffers
come back with width 0 and nothing is allocated for them.

The kernels cull before they fold: a (query, bucket) pair whose leaf box
cannot hold a hit (:func:`leaf_pass_plain`, the same test in plain PyTorch)
never has its points read. The plain versions fold every point of every
candidate, as the reference does; the cull changes no result.

``radius_fold.launches`` and ``range_fold.launches`` count wrapper calls that
launched the kernel (plain integers), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.profiler import record_function

from kdtree_tpu_torch.kernels import _build
from kdtree_tpu_torch.kernels.scan_knn import _check, blocks_per_tile
from kdtree_tpu_torch.ops._arith import sq_dist, sq_dist_to_box

MAX_TILE = 256  # queries per tile: the kernel's shared counters
ID_INF = 2**31 - 1  # the plain range fold's "no hit" id: real gids are < 2^31
_SCAN_V = 4  # fewest buckets the plain folds take per chunk
_FOLD_ELEMS = 1 << 22  # (query, point) lanes per plain fold step: wider
# chunks when the tiles are few, so a small batch is not a long host loop
_MAX_STAGE_ROW_BYTES = 48 * 1024  # a staged row of D + 1 words fits a 48 KB stage
# Candidate positions a block at D != 3. At D = 3 the cull drops almost every
# pair and a block's time is its box tests, so the folds split a tile as the
# scan does; at wide D most pairs survive and each position is a bucket of
# FP32 work, so short chunks spread it evenly over the SMs (chip_smoke.py
# phase 9a times both at 1,000 rows of its 2^19 x 47-D tree).
_WIDE_CHUNK = 8
_RADIUS_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_RANGE_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _blocks(dev, T: int, C: int, D: int) -> int:
    """Blocks a tile: the scan kernel's split at D = 3, one per
    ``_WIDE_CHUNK`` positions at other D."""
    return blocks_per_tile(dev, T, C, None if D == 3 else -(-C // _WIDE_CHUNK))


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.load("verb_fold"), name)
    fn.argtypes = _RADIUS_ARGTYPES if name == "verb_radius_fold_launch" else _RANGE_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(tree, name, tiles, cand, m: int):
    """The checks both paths make on the tiles, the candidates, the tree's
    buckets and m; returns (device, T, TQ, D)."""
    dev = tiles.device
    if tiles.dim() != 3:
        raise ValueError(f"{name} must be [T, TQ, D], got shape {tuple(tiles.shape)}")
    T, TQ, D = tiles.shape
    _check(name, tiles, torch.float32, (T, TQ, D), dev)
    if cand.dim() != 2:
        raise ValueError(f"cand must be [T, C], got shape {tuple(cand.shape)}")
    _check("cand", cand, torch.int32, (T, cand.shape[1]), dev)
    nb, B = tree.bucket_gid.shape
    _check("bucket_pts", tree.bucket_pts, torch.float32, (nb, B, D), dev)
    _check("bucket_gid", tree.bucket_gid, torch.int32, (nb, B), dev)
    _check("node_lo", tree.node_lo, torch.float32, (2 * nb - 1, D), dev)
    _check("node_hi", tree.node_hi, torch.float32, (2 * nb - 1, D), dev)
    if m < 0:
        raise ValueError(f"m must be >= 0, got {m}")
    if not 1 <= TQ <= MAX_TILE:
        raise ValueError(f"the fold takes 1..{MAX_TILE} queries per tile, got {TQ}")
    if (D + 1) * 4 > _MAX_STAGE_ROW_BYTES:
        raise ValueError(f"dimension {D} is too wide for the fold kernel's staging")
    return dev, T, TQ, D


def _chunked(cand, v: int):
    """Pad the candidate list to a multiple of ``v`` (with -1) and expose
    it as scan chunks [C//v, T, v]."""
    T, C = cand.shape
    cpad = (-C) % v
    if cpad:
        cand = torch.cat([cand, torch.full((T, cpad), -1, dtype=cand.dtype,
                                           device=cand.device)], dim=1)
        C += cpad
    return cand.reshape(T, C // v, v).transpose(0, 1)


def _gather_chunk(tree, cb):
    """One chunk's flattened bucket points + masked gids:
    cb i32[T, v] -> (pts f32[T, v*B, D], gids i32[T, v*B])."""
    B = tree.bucket_size
    sel = cb.long().clamp_min(0)
    pts = tree.bucket_pts[sel]  # [T, v, B, D]
    gids = torch.where((cb >= 0)[:, :, None], tree.bucket_gid[sel], -1)
    T, v = cb.shape
    return pts.reshape(T, v * B, -1), gids.reshape(T, v * B)


def _chunk_width(tree, T: int, TQ: int, ncand: int) -> int:
    per_bucket = max(T * TQ * tree.bucket_size, 1)
    v = max(_SCAN_V, 1 << (max(_FOLD_ELEMS // per_bucket, 1) - 1).bit_length())
    return max(1, min(v, ncand))


def _radius_fold_plain(tree, tq, r2, cand, m: int):
    """The radius fold's plain version (the kernel's, :func:`radius_fold`):
    the reference's ``lax.scan`` step as a loop over candidate chunks.
    Returns (counts i32[T, TQ], best_d f32[T, TQ, m], best_i i32[T, TQ,
    m]): per query the hits d2 <= r2 of real points and the m smallest by
    (d2, candidate position), padded (+inf, -1); ``m = 0`` is the count
    form. Each chunk's gather, distances, test and merge run in the
    profiler ranges ``verbs.fold.gather``, ``.d2``, ``.test`` and
    ``.sort``."""
    T, TQ, _ = tq.shape
    dev = tq.device
    counts = torch.zeros((T, TQ), dtype=torch.int32, device=dev)
    best_d = torch.full((T, TQ, m), float("inf"), device=dev)
    best_i = torch.full((T, TQ, m), -1, dtype=torch.int32, device=dev)
    ncand = cand.shape[1]
    if ncand:
        v = _chunk_width(tree, T, TQ, ncand)
        for cb in _chunked(cand, v):
            with record_function("verbs.fold.gather"):
                pts, gids = _gather_chunk(tree, cb)
            with record_function("verbs.fold.d2"):
                # [T, TQ, v*B]
                d2 = sq_dist(tq[:, :, None, :], pts[:, None, :, :])
            with record_function("verbs.fold.test"):
                hit = (gids[:, None, :] >= 0) & (d2 <= r2[:, :, None])
                counts += hit.sum(dim=-1, dtype=torch.int32)
            if m:
                with record_function("verbs.fold.sort"):
                    key = torch.where(hit, d2, float("inf"))
                    all_d = torch.cat([best_d, key], dim=-1)
                    all_i = torch.cat(
                        [best_i, gids[:, None, :].expand(key.shape)], dim=-1)
                    # the m smallest by (d2, lane): lax.top_k(-all_d, m)'s
                    # order
                    srt, order = torch.sort(all_d, dim=-1, stable=True)
                    best_d = srt[..., :m]
                    best_i = torch.gather(all_i, -1, order[..., :m])
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return counts, best_d, best_i


def _range_fold_plain(tree, qlo, qhi, cand, m: int):
    """The range fold's plain version (the kernel's, :func:`range_fold`):
    per-axis containment of every candidate point in each query's box,
    looped over candidate chunks. Returns (counts i32[T, TQ], best_i
    i32[T, TQ, m]), the m smallest contained ids ascending, padded with -1;
    ``m = 0`` is the count form. Profiler ranges as
    :func:`_radius_fold_plain`'s, but for ``.d2`` (the containment test is
    ``verbs.fold.test``)."""
    T, TQ, D = qlo.shape
    dev = qlo.device
    counts = torch.zeros((T, TQ), dtype=torch.int32, device=dev)
    best_i = torch.full((T, TQ, m), ID_INF, dtype=torch.int32, device=dev)
    ncand = cand.shape[1]
    if ncand:
        v = _chunk_width(tree, T, TQ, ncand)
        for cb in _chunked(cand, v):
            with record_function("verbs.fold.gather"):
                pts, gids = _gather_chunk(tree, cb)
            with record_function("verbs.fold.test"):
                hit = (gids[:, None, :] >= 0).expand(T, TQ, pts.shape[1])
                # per-axis containment, one axis at a time (no [T, TQ, W, D]
                # intermediate)
                for d in range(D):
                    pd = pts[:, None, :, d]
                    hit = (hit & (pd >= qlo[:, :, d:d + 1])
                           & (pd <= qhi[:, :, d:d + 1]))
                counts += hit.sum(dim=-1, dtype=torch.int32)
            if m:
                with record_function("verbs.fold.sort"):
                    key = torch.where(hit, gids[:, None, :].expand(hit.shape),
                                      ID_INF)
                    # the m SMALLEST ids, ascending (lax.top_k(-ids) in the
                    # reference)
                    all_i = torch.cat([best_i, key], dim=-1)
                    best_i = torch.sort(all_i, dim=-1).values[..., :m]
    return counts, torch.where(best_i == ID_INF, -1, best_i)


def leaf_pass_plain(tree, verb: str, qa, qb, cand) -> torch.Tensor:
    """The kernels' cull in plain PyTorch: bool[T, TQ, C], whether query q
    of tile t may hit a point of candidate ``cand[t, c]``. The leaf of bucket
    b is heap slot ``num_buckets - 1 + b``, whose box covers the bucket's
    real points only. ``verb`` "radius" (qa = tq, qb = r2): the leaf box's
    squared distance in the scan's skip arithmetic
    (:func:`~kdtree_tpu_torch.ops._arith.sq_dist_to_box`) is <= r2; rounding
    is monotone, so it is never above a point's d2 and no hit is culled.
    "range" (qa = lo, qb = hi): the query box is not inverted and meets the
    leaf box on every axis (each compare written as not-disjoint, so a NaN
    face never culls). A -1 candidate and an empty leaf (+inf / -inf box)
    never pass, nor does a padding row (r2 < 0, the empty box)."""
    T, _, D = qa.shape
    sel = cand.long().clamp_min(0) + (tree.num_buckets - 1)
    out = []
    for t in range(T):  # one tile at a time: [TQ, C, D] at most
        lo, hi = tree.node_lo[sel[t]], tree.node_hi[sel[t]]  # [C, D]
        real = (cand[t] >= 0) & ~(lo[:, 0] > hi[:, 0])
        if verb == "radius":
            bnd = sq_dist_to_box(qa[t][:, None, :], lo[None], hi[None])  # [TQ, C]
            ok = bnd <= qb[t][:, None]
        else:
            ql, qh = qa[t][:, None, :], qb[t][:, None, :]
            ok = (~(lo[None] > qh) & ~(hi[None] < ql) & ~(ql > qh)).all(dim=-1)
        out.append(ok & real[None, :])
    return torch.stack(out) if out else torch.zeros(
        (0, qa.shape[1], cand.shape[1]), dtype=torch.bool, device=qa.device)


def radius_fold(tree, tq, r2, cand, m: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Radius fold over tiles: tq f32[T, TQ, D], r2 f32[T, TQ] (negative =
    a padding row, never hits), cand i32[T, C] candidate buckets (-1
    padding). Returns (counts i32[T, TQ], best_d f32[T, TQ, m], best_i
    i32[T, TQ, m]): the hits d2 <= r2 of real points (gid >= 0), the
    buffers padded (+inf, -1). CUDA tensors launch the kernel; CPU tensors
    run the plain version."""
    dev, T, TQ, D = _check_inputs(tree, "tq", tq, cand, m)
    _check("r2", r2, torch.float32, (T, TQ), dev)
    if dev.type == "cpu":
        return _radius_fold_plain(tree, tq, r2, cand, m)
    if dev.type != "cuda":
        raise ValueError(f"radius_fold runs on CUDA or CPU tensors, got {dev}")
    fn = _fn("verb_radius_fold_launch")
    C, B = cand.shape[1], tree.bucket_size
    counts = torch.zeros((T, TQ), dtype=torch.int32, device=dev)
    best_d = torch.full((T, TQ, m), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((T, TQ, m), -1, dtype=torch.int32, device=dev)
    if T == 0 or C == 0:
        return counts, best_d, best_i
    S = _blocks(dev, T, C, D)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = fn(tq.data_ptr(), r2.data_ptr(), cand.data_ptr(), tree.bucket_pts.data_ptr(),
                 tree.bucket_gid.data_ptr(), tree.node_lo.data_ptr(), tree.node_hi.data_ptr(),
                 counts.data_ptr(), best_d.data_ptr() if m else None,
                 best_i.data_ptr() if m else None, T, TQ, D, C, B, tree.num_buckets, m, S,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"verb_radius_fold kernel launch failed with CUDA error {err}")
    radius_fold.launches += 1
    return counts, best_d, best_i


def range_fold(tree, qlo, qhi, cand, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Box-containment fold over tiles: qlo/qhi f32[T, TQ, D] per-query
    boxes, inclusive faces (an empty box, lo = +inf and hi = -inf, marks a
    padding row), cand as :func:`radius_fold`'s. Returns (counts i32[T, TQ],
    best_i i32[T, TQ, m]) padded with -1. CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    dev, T, TQ, D = _check_inputs(tree, "qlo", qlo, cand, m)
    _check("qhi", qhi, torch.float32, (T, TQ, D), dev)
    if dev.type == "cpu":
        return _range_fold_plain(tree, qlo, qhi, cand, m)
    if dev.type != "cuda":
        raise ValueError(f"range_fold runs on CUDA or CPU tensors, got {dev}")
    fn = _fn("verb_range_fold_launch")
    C, B = cand.shape[1], tree.bucket_size
    counts = torch.zeros((T, TQ), dtype=torch.int32, device=dev)
    best_i = torch.full((T, TQ, m), -1, dtype=torch.int32, device=dev)
    if T == 0 or C == 0:
        return counts, best_i
    S = _blocks(dev, T, C, D)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = fn(qlo.data_ptr(), qhi.data_ptr(), cand.data_ptr(), tree.bucket_pts.data_ptr(),
                 tree.bucket_gid.data_ptr(), tree.node_lo.data_ptr(), tree.node_hi.data_ptr(),
                 counts.data_ptr(), best_i.data_ptr() if m else None, T, TQ, D, C, B,
                 tree.num_buckets, m, S, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"verb_range_fold kernel launch failed with CUDA error {err}")
    range_fold.launches += 1
    return counts, best_i


radius_fold.launches = 0
range_fold.launches = 0
