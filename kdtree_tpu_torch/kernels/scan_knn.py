"""The tiled engine's scan kernel: wrapper, checks and launch count.

:func:`scan_tiles` is the drop-in for the plain
:func:`kdtree_tpu_torch.ops.tile_query._scan_tiles`. On a CUDA tensor it
launches the hand-written kernel ``csrc/scan_knn.cu`` (built by
:mod:`kdtree_tpu_torch.kernels._build` at first use and bound through
ctypes) or raises; it never falls back. On a CPU tensor it runs the plain
version, because that is where the tensor lies. The kernel replaces the TPU
kernel ``kdtree_tpu/pallas/scan_knn.py::_scan_kernel`` and agrees with the
plain version bit for bit on distances and ids.

``scan_tiles.launches`` counts kernel launches (a plain integer), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from kdtree_tpu_torch.kernels import _build
from kdtree_tpu_torch.ops import tile_query

MAX_TILE = 256  # queries per tile: one thread each, one CTA per tile
_MAX_STAGE_ROW_BYTES = 48 * 1024

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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


def scan_tiles(tree, tq, cand, cand_lb, k: int, v: int = 1, tb: int = 1,
               visited: torch.Tensor | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-scan each tile's candidate buckets into per-query k-buffers.

    tq f32[T, TQ, D]; cand i32[T, C] lb-ascending (-1 pad); cand_lb
    f32[T, C] (+inf at pad). Returns (d2 f32[T, TQ, k], gid i32[T, TQ, k])
    ascending, with ``k`` clamped to the tree's point count. ``v``/``tb``
    shape only the plain version's blocks. ``visited`` (CUDA only, i32[T])
    receives each tile's count of scanned buckets."""
    k = min(k, tree.n_real)
    dev = tq.device
    if dev.type == "cpu":
        if visited is not None:
            raise ValueError("visited counts come from the CUDA kernel only")
        return tile_query._scan_tiles(tree, tq, cand, cand_lb, k, v, tb)
    if dev.type != "cuda":
        raise ValueError(f"scan_tiles runs on CUDA or CPU tensors, got {dev}")
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
    if visited is not None:
        _check("visited", visited, torch.int32, (T,), dev)
    fn = _build.load("scan_knn").scan_knn_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out_d = torch.empty((T, TQ, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((T, TQ, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = fn(tq.data_ptr(), cand.data_ptr(), cand_lb.data_ptr(),
                 tree.bucket_pts.data_ptr(), tree.bucket_gid.data_ptr(),
                 out_d.data_ptr(), out_i.data_ptr(),
                 None if visited is None else visited.data_ptr(),
                 T, TQ, D, C, B, k, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_knn kernel launch failed with CUDA error "
                           f"{err}")
    scan_tiles.launches += 1
    return out_d, out_i


scan_tiles.launches = 0
