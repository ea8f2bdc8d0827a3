"""The tiled engine's scan kernels: wrappers, checks and launch counts.

:func:`scan_tiles` is the drop-in for the plain
:func:`kdtree_tpu_torch.ops.tile_query._scan_tiles`. On a CUDA tensor it
launches the hand-written kernels of ``csrc/scan_knn.cu`` (built by
:mod:`kdtree_tpu_torch.kernels._build` at first use and bound through
ctypes) or raises; it never falls back. On a CPU tensor it runs the plain
version, because that is where the tensor lies. The scan kernel replaces
the TPU kernel ``kdtree_tpu/pallas/scan_knn.py::_scan_kernel``; it splits
each tile's candidate list over ``S`` blocks, and :func:`merge_partials`
(the merge kernel, plain version
:func:`kdtree_tpu_torch.ops.tile_query.merge_partials`) joins their partial
buffers. Both agree with their plain versions bit for bit on distances and
ids.

``scan_tiles.launches`` and ``merge_partials.launches`` count kernel
launches (plain integers), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from kdtree_tpu_torch.kernels import _build
from kdtree_tpu_torch.ops import tile_query

MAX_TILE = 256  # queries per tile: one thread each
_MAX_STAGE_ROW_BYTES = 48 * 1024
# The split policy. chip_smoke.py phase 5 sweeps the blocks per tile at the
# serve shapes (1, 8 and 128 tiles of 8 queries, one warp per block; see
# PERF.md): the fastest count at each gives every block about 64 positions,
# many waves of blocks, since a block that starts after its tile's shared
# bound has tightened stops at once; shorter chunks lose to the merge.
_FILLED_PER_SM = 2  # tiles per SM at which tiles alone fill the card
_CHUNK = 64  # below that, one block per this many candidate positions
_MAX_SPLITS = 65535  # the grid's y extent
_INF_BITS = 0x7F800000

_SCAN_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_MERGE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_splits(T: int, C: int, sms: int) -> int:
    """How many blocks walk each tile's candidate list: 1 when the tiles
    alone fill ``sms`` SMs (``_FILLED_PER_SM`` each), else one block per
    ``_CHUNK`` positions."""
    if T >= sms * _FILLED_PER_SM:
        return 1
    return max(1, min(-(-C // _CHUNK), _MAX_SPLITS))


def _lib(name_fn: str, argtypes):
    fn = getattr(_build.load("scan_knn"), name_fn)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def merge_partials(pd: torch.Tensor, pi: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Join per-chunk partial buffers pd f32[T, S, TQ, k], pi i32[T, S, TQ, k]
    into (d2 f32[T, TQ, k], gid i32[T, TQ, k]), the k smallest by (d2,
    chunk). CUDA tensors launch the merge kernel; CPU tensors run the plain
    version."""
    dev = pd.device
    if dev.type == "cpu":
        return tile_query.merge_partials(pd, pi)
    if dev.type != "cuda":
        raise ValueError(f"merge_partials runs on CUDA or CPU tensors, got {dev}")
    T, S, TQ, k = pd.shape
    _check("pd", pd, torch.float32, (T, S, TQ, k), dev)
    _check("pi", pi, torch.int32, (T, S, TQ, k), dev)
    out_d = torch.empty((T, TQ, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((T, TQ, k), dtype=torch.int32, device=dev)
    fn = _lib("scan_knn_merge_launch", _MERGE_ARGTYPES)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = fn(pd.data_ptr(), pi.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                 T, S, TQ, k, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_knn merge kernel launch failed with CUDA error {err}")
    if T * TQ > 0:  # the launcher launches nothing for no rows
        merge_partials.launches += 1
    return out_d, out_i


def scan_partials(tree, tq, cand, cand_lb, k: int,
                  visited: torch.Tensor | None = None, splits: int | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the scan kernel on CUDA tensors: (d2 f32[T, S, TQ, k], gid
    i32[T, S, TQ, k]), chunk s's ascending partial buffers, ``k`` already
    clamped. :func:`scan_tiles` documents the arguments."""
    dev = tq.device
    if dev.type != "cuda":
        raise ValueError(f"the scan kernel runs on CUDA tensors, got {dev}")
    T, TQ, D = tq.shape
    C = cand.shape[1]
    nbp, B = tree.bucket_gid.shape
    if not 1 <= TQ <= MAX_TILE:
        raise ValueError(f"the scan kernel takes 1..{MAX_TILE} queries per "
                         f"tile, got {TQ}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if (D + 1) * 4 > _MAX_STAGE_ROW_BYTES:
        raise ValueError(f"dimension {D} is too wide for the kernel's staging")
    _check("tq", tq, torch.float32, (T, TQ, D), dev)
    _check("cand", cand, torch.int32, (T, C), dev)
    _check("cand_lb", cand_lb, torch.float32, (T, C), dev)
    _check("bucket_pts", tree.bucket_pts, torch.float32, (nbp, B, D), dev)
    _check("bucket_gid", tree.bucket_gid, torch.int32, (nbp, B), dev)
    _check("node_lo", tree.node_lo, torch.float32, (2 * nbp - 1, D), dev)
    _check("node_hi", tree.node_hi, torch.float32, (2 * nbp - 1, D), dev)
    if visited is not None:
        _check("visited", visited, torch.int32, (T,), dev)
        visited.zero_()
    if splits is None:
        splits = plan_splits(T, C, _sm_count(dev.index if dev.index is not None
                                             else torch.cuda.current_device()))
    # every block gets a non-empty contiguous range of ceil(C / S) positions
    S = max(1, min(splits, C, _MAX_SPLITS))
    S = -(-C // -(-C // S)) if C > 0 else 1
    out_d = torch.empty((T, S, TQ, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((T, S, TQ, k), dtype=torch.int32, device=dev)
    q_worst = (torch.full((T, TQ), _INF_BITS, dtype=torch.int32, device=dev)
               if S > 1 else None)
    fn = _lib("scan_knn_launch", _SCAN_ARGTYPES)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = fn(tq.data_ptr(), cand.data_ptr(), cand_lb.data_ptr(),
                 tree.bucket_pts.data_ptr(), tree.bucket_gid.data_ptr(),
                 tree.node_lo.data_ptr(), tree.node_hi.data_ptr(),
                 out_d.data_ptr(), out_i.data_ptr(),
                 None if visited is None else visited.data_ptr(),
                 None if q_worst is None else q_worst.data_ptr(),
                 T, TQ, D, C, B, k, S, nbp,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_knn kernel launch failed with CUDA error "
                           f"{err}")
    if T > 0:  # the launcher launches nothing for no tiles
        scan_tiles.launches += 1
    return out_d, out_i


def scan_tiles(tree, tq, cand, cand_lb, k: int, v: int = 1, tb: int = 1,
               visited: torch.Tensor | None = None, splits: int | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-scan each tile's candidate buckets into per-query k-buffers.

    tq f32[T, TQ, D]; cand i32[T, C] lb-ascending (-1 pad); cand_lb
    f32[T, C] (+inf at pad). Returns (d2 f32[T, TQ, k], gid i32[T, TQ, k])
    ascending, with ``k`` clamped to the tree's point count. ``v``/``tb``
    shape only the plain version's blocks. ``visited`` (CUDA only, i32[T])
    receives each tile's count of candidate buckets reached before its
    walk stopped. ``splits`` forces the number of blocks per tile (for
    tests; the CPU path ignores it); by default :func:`plan_splits` picks
    it from the shape and the card. On CUDA, the scan kernel's launches
    count in ``scan_tiles.launches`` and the merge's in
    ``merge_partials.launches``."""
    if splits is not None and splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    k = min(k, tree.n_real)
    dev = tq.device
    if dev.type == "cpu":
        if visited is not None:
            raise ValueError("visited counts come from the CUDA kernel only")
        return tile_query._scan_tiles(tree, tq, cand, cand_lb, k, v, tb)
    if dev.type != "cuda":
        raise ValueError(f"scan_tiles runs on CUDA or CPU tensors, got {dev}")
    pd, pi = scan_partials(tree, tq, cand, cand_lb, k, visited, splits)
    T, S, TQ, _ = pd.shape
    if S == 1:
        return pd.view(T, TQ, k), pi.view(T, TQ, k)
    return merge_partials(pd, pi)


scan_tiles.launches = 0
merge_partials.launches = 0
