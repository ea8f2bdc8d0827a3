"""The brute-force oracle's distance block: wrapper, checks and launch count.

:func:`pair_d2` computes every squared distance between the rows of
``queries`` f32[Q, D] and ``ptile`` f32[T, D] in the arithmetic of the JAX
package's jitted ``_block_d2_exact`` (``kdtree_tpu/ops/bruteforce.py:44``):
the fused multiply-add chain up to 32 axes, rounded squares summed in
windows of 32 above (:func:`kdtree_tpu_torch.ops._arith.sq_dist`). On a
CUDA tensor it launches the hand-written kernel of ``csrc/pair_d2.cu``
(built by :mod:`kdtree_tpu_torch.kernels._build` at first use, bound
through ctypes) or raises; it never falls back. On a CPU tensor it runs the
plain version, :func:`pair_d2_plain`. The two agree bit for bit.

``pair_d2.launches`` counts the calls that launched the kernel (a plain
integer), so a run can show that its main path went through it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kdtree_tpu_torch.kernels import _build
from kdtree_tpu_torch.kernels.scan_knn import _check
from kdtree_tpu_torch.ops._arith import sq_dist

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("pair_d2").pair_d2_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def pair_d2_plain(queries: torch.Tensor, ptile: torch.Tensor) -> torch.Tensor:
    """The plain version: ``sq_dist`` over the broadcast rows."""
    return sq_dist(queries[:, None, :], ptile[None, :, :])


def pair_d2(queries: torch.Tensor, ptile: torch.Tensor) -> torch.Tensor:
    """[Q, T] squared distances between the rows of ``queries`` f32[Q, D]
    and ``ptile`` f32[T, D], both contiguous on one device. CUDA tensors
    launch the kernel; CPU tensors run :func:`pair_d2_plain`."""
    dev = queries.device
    if queries.dim() != 2 or ptile.dim() != 2:
        raise ValueError(f"pair_d2 takes [Q, D] and [T, D] rows, got shapes "
                         f"{tuple(queries.shape)} and {tuple(ptile.shape)}")
    Q, D = queries.shape
    T = ptile.shape[0]
    _check("queries", queries, torch.float32, (Q, D), dev)
    _check("ptile", ptile, torch.float32, (T, D), dev)
    if D < 1:
        raise ValueError("pair_d2 takes rows of at least one axis")
    if dev.type == "cpu":
        return pair_d2_plain(queries, ptile)
    if dev.type != "cuda":
        raise ValueError(f"pair_d2 runs on CUDA or CPU tensors, got {dev}")
    fn = _fn()
    out = torch.empty((Q, T), dtype=torch.float32, device=dev)
    if Q == 0 or T == 0:
        return out
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = fn(queries.data_ptr(), ptile.data_ptr(), out.data_ptr(), Q, T, D,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair_d2 kernel launch failed with CUDA error {err}")
    pair_d2.launches += 1
    return out


pair_d2.launches = 0
