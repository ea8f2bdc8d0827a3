"""The frontier descent: wrapper, checks, launch count and the kernel's mirror.

:func:`frontier` descends the bucket-AABB heap for each tile box and keeps,
level by level, the <= ``cap`` nodes with the smallest box-to-box lower
bound that pass the tile's bound: the function of the plain version
:func:`kdtree_tpu_torch.ops.tile_query._frontier`, the port of the JAX
package's XLA program ``kdtree_tpu/ops/tile_query.py::_frontier``. On a CUDA
tensor it launches the hand-written kernel of ``csrc/frontier.cu`` (built by
:mod:`kdtree_tpu_torch.kernels._build` at first use, bound through ctypes)
or raises; it never falls back. On a CPU tensor it runs the plain version.
The two agree bit for bit: bucket ids, lower bounds and overflow flags.

The plain version selects with one stable sort a level. The kernel ranks a
level's live candidates in position order and sorts their (lb bits, rank)
keys, in shared memory up to ``smem_keys`` candidates and past that by a
stable radix sort in device memory. :func:`frontier_mirror` follows it step
for step, both paths included, so the CPU tests reach each path at small
sizes through its ``smem_keys`` argument.

``frontier.launches`` counts the calls that launched the kernel (a plain
integer), so a run can show that its main path went through it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kdtree_tpu_torch.kernels import _build
from kdtree_tpu_torch.kernels.scan_knn import _check
from kdtree_tpu_torch.ops.tile_query import _frontier, _gathered_box_lb

SMEM_KEYS_MAX = 8192  # candidates a level sorts in shared memory (12 bytes each)
MAX_THREADS = 512
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("frontier").frontier_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def start_level(cap: int, levels: int) -> int:
    """The level the descent starts at: the deepest whose 2^s nodes fit cap."""
    return min(max(cap.bit_length() - 1, 0), levels)


def smem_keys_for(cap: int) -> int:
    """Candidates a level sorts in shared memory: all 2 cap children while
    they fit :data:`SMEM_KEYS_MAX`."""
    return min(1 << (2 * cap - 1).bit_length(), SMEM_KEYS_MAX)


def threads_for(cap: int) -> int:
    """Threads a block: one a slot up to :data:`MAX_THREADS`, at least a warp."""
    return min(MAX_THREADS, max(32, 1 << (cap - 1).bit_length()))


def _check_args(tree, box_lo, box_hi, bound, cap, smem_keys):
    dev = box_lo.device
    if box_lo.dim() != 2:
        raise ValueError(f"frontier takes tile boxes [T, D], got shape {tuple(box_lo.shape)}")
    T, D = box_lo.shape
    H = tree.node_lo.shape[0]
    _check("box_lo", box_lo, torch.float32, (T, D), dev)
    _check("box_hi", box_hi, torch.float32, (T, D), dev)
    _check("bound", bound, torch.float32, (T,), dev)
    _check("tree.node_lo", tree.node_lo, torch.float32, (H, D), dev)
    _check("tree.node_hi", tree.node_hi, torch.float32, (H, D), dev)
    if D < 1:
        raise ValueError("frontier takes boxes of at least one axis")
    if isinstance(cap, bool) or not isinstance(cap, int) or cap < 1:
        raise ValueError(f"cap must be an int >= 1, got {cap!r}")
    if smem_keys is not None and (smem_keys < 2 or smem_keys > SMEM_KEYS_MAX
                                  or smem_keys & (smem_keys - 1)):
        raise ValueError(f"smem_keys must be a power of two in [2, {SMEM_KEYS_MAX}], "
                         f"got {smem_keys}")
    return dev, T, D


def frontier(tree, box_lo, box_hi, bound, cap: int, smem_keys: int | None = None):
    """(bucket ids i32[T, cap] lb-ascending with -1 padding, lower bounds
    f32[T, cap] with +inf padding, overflow bool[T]) for tile boxes
    ``box_lo``/``box_hi`` f32[T, D] and bounds f32[T] on ``tree``'s device:
    see :func:`kdtree_tpu_torch.ops.tile_query._frontier`. CUDA tensors
    launch the kernel (``smem_keys``, a power of two, forces a smaller
    shared-memory sort so that small caps reach the radix path; the result
    is the same); CPU tensors run the plain version."""
    dev, T, D = _check_args(tree, box_lo, box_hi, bound, cap, smem_keys)
    if dev.type == "cpu":
        return _frontier(tree, box_lo, box_hi, bound, cap)
    if dev.type != "cuda":
        raise ValueError(f"frontier runs on CUDA or CPU tensors, got {dev}")
    fn = _fn()
    sk = smem_keys_for(cap) if smem_keys is None else smem_keys
    bucket = torch.empty((T, cap), dtype=torch.int32, device=dev)
    lb = torch.empty((T, cap), dtype=torch.float32, device=dev)
    overflow = torch.empty(T, dtype=torch.bool, device=dev)
    if T == 0:
        return bucket, lb, overflow
    keys = nodes = None
    if 2 * cap > sk:
        keys = torch.empty((T, 4 * cap), dtype=torch.int64, device=dev)
        nodes = torch.empty((T, 2 * cap), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = fn(tree.node_lo.data_ptr(), tree.node_hi.data_ptr(), box_lo.data_ptr(),
                 box_hi.data_ptr(), bound.data_ptr(), bucket.data_ptr(), lb.data_ptr(),
                 overflow.data_ptr(), None if keys is None else keys.data_ptr(),
                 None if nodes is None else nodes.data_ptr(), T, D, cap,
                 start_level(cap, tree.num_levels), tree.num_levels, tree.num_buckets - 1,
                 sk, threads_for(cap), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"frontier kernel launch failed with CUDA error {err}")
    frontier.launches += 1
    return bucket, lb, overflow


frontier.launches = 0


def _radix_sort(keys, stats):
    """The kernel's device-memory sort: stable by one 8-bit digit of the lb
    bits a pass from bit 32 up, a pass whose digit every key shares
    skipped."""
    for shift in (32, 40, 48, 56):
        digit = (keys >> shift) & 255
        if keys.numel() == 0 or bool((digit == digit[0]).all()):
            stats["passes_skipped"] += 1
            continue
        stats["passes"] += 1
        keys = keys[torch.sort(digit, stable=True).indices]
    return keys


def frontier_mirror(tree, box_lo, box_hi, bound, cap: int, smem_keys: int | None = None):
    """A step-for-step mirror of the frontier kernel
    (``csrc/frontier.cu::frontier_kernel``), for the tests: per tile, per
    level, the candidates in position order (the start level's nodes, or the
    left children of the live slots, then their right children), the live
    ones (lb <= bound and finite) ranked, their keys (lb bits << 32 | rank)
    sorted in one sort when the level has at most ``smem_keys`` candidates
    and by the radix passes otherwise, the cap smallest kept. Returns
    (bucket i32[T, cap], lb f32[T, cap], overflow bool[T], stats: levels by
    path and radix passes run and skipped), the first three equal to
    :func:`kdtree_tpu_torch.ops.tile_query._frontier`'s bit for bit."""
    _, T, _ = _check_args(tree, box_lo, box_hi, bound, cap, smem_keys)
    sk = smem_keys_for(cap) if smem_keys is None else smem_keys
    L = tree.num_levels
    s = start_level(cap, L)
    dev = box_lo.device
    bucket = torch.full((T, cap), -1, dtype=torch.int32, device=dev)
    lbs = torch.full((T, cap), float("inf"), device=dev)
    overflow = torch.zeros(T, dtype=torch.bool, device=dev)
    stats = {"shared": 0, "radix": 0, "passes": 0, "passes_skipped": 0}
    for t in range(T):
        slots = torch.arange(1 << s, dtype=torch.int64, device=dev) + ((1 << s) - 1)
        for level in range(s, L + 1):
            cand = slots if level == s else torch.cat([2 * slots + 1, 2 * slots + 2])
            lb = _gathered_box_lb(tree, box_lo[t:t + 1], box_hi[t:t + 1], cand[None])[0]
            live = (lb <= bound[t]) & torch.isfinite(lb)
            nodes, lb = cand[live], lb[live]
            count = nodes.numel()
            overflow[t] |= count > cap
            keys = (lb.view(torch.int32).long() << 32) | torch.arange(count, device=dev)
            if cand.numel() <= sk:
                stats["shared"] += 1
                keys = torch.sort(keys).values
            else:
                stats["radix"] += 1
                keys = _radix_sort(keys, stats)
            keys = keys[:cap]
            slots = nodes[keys & 0xFFFFFFFF]
            slot_lb = (keys >> 32).to(torch.int32).view(torch.float32)
        n = slots.numel()
        bucket[t, :n] = (slots - (tree.num_buckets - 1)).to(torch.int32)
        lbs[t, :n] = slot_lb
    return bucket, lbs, overflow, stats
