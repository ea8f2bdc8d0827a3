"""Morton-order bucket tree: one stable sort, then dense reductions.

The port of ``kdtree_tpu/ops/morton.py``'s build: quantize each axis,
interleave into a Morton code, ONE stable sort by code (ties keep the
original row order, so the point id breaks them), cut the sorted order
into buckets of B points padded with +inf rows and id -1, and build the
implicit complete AABB heap bottom-up over the power-of-two-padded
buckets. Every array is bit-identical to the JAX build on the same
points.

Codes are u32 in the reference; torch has no full uint32 arithmetic or
sort, so they live in int64 here, each value below 2^32.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from kdtree_tpu_torch import resolve_device
from kdtree_tpu_torch.utils.guards import check_rows_fit_i32

DEFAULT_BUCKET = 256


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
