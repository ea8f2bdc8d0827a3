"""The frontier descent: wrapper, plan, checks, launch count and the kernel's mirror.

:func:`frontier` descends the bucket-AABB heap for each tile box and keeps,
level by level, the <= ``cap`` nodes with the smallest box-to-box lower
bound that pass the tile's bound: the function of the plain version
:func:`kdtree_tpu_torch.ops.tile_query._frontier`, the port of the JAX
package's XLA program ``kdtree_tpu/ops/tile_query.py::_frontier``. On a CUDA
tensor it launches the hand-written kernel of ``csrc/frontier.cu`` (built by
:mod:`kdtree_tpu_torch.kernels._build` at first use, bound through ctypes)
or raises; it never falls back. On a CPU tensor it runs the plain version.
The two agree bit for bit: bucket ids, lower bounds and overflow flags.

The plain version selects with one stable sort a level. The kernel runs a
tile on a cluster of ``c`` CTAs (:func:`plan` picks ``c`` from the shapes):
each CTA takes a contiguous slice of a level's positions, ranks its live
candidates, and a cluster-wide prefix of the counts makes their keys
(lb bits << 32 | rank) unique; each CTA sorts its keys and the cluster
merges the sorted runs, in shared memory, or in per-CTA slices of device
memory past what a cluster's shared memory holds. A level whose live lbs are
all equal skips the sort; a level with none ends the descent.
:func:`frontier_mirror` follows it step for step, so the CPU tests reach
each path at small sizes through its ``cluster`` and ``smem_keys``
arguments.

``frontier.launches`` counts the calls that launched the kernel (a plain
integer), so a run can show that its main path went through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from kdtree_tpu_torch.kernels import _build
from kdtree_tpu_torch.kernels.scan_knn import _check
from kdtree_tpu_torch.ops.tile_query import _frontier, _gathered_box_lb

SMEM_KEYS_MAX = 8192  # keys a CTA holds in shared memory (16 bytes each: the key and its spare)
CLUSTERS = (1, 2, 4, 8, 16)  # CTAs a tile; 16 is past the portable 8
MAX_THREADS = 1024  # a CTA of a cluster
SOLO_THREADS = 512  # a tile's one block
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("frontier").frontier_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def start_level(cap: int, levels: int) -> int:
    """The level the descent starts at: the deepest whose 2^s nodes fit cap."""
    return min(max(cap.bit_length() - 1, 0), levels)


def level_width(cap: int, levels: int) -> int:
    """The most candidates any level of the descent evaluates: the start
    level's 2^s nodes, or the children of at most cap slots."""
    s = start_level(cap, levels)
    return 1 << s if s >= levels else min(2 * cap, 1 << levels)


def _pow2ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class Plan(NamedTuple):
    """How the kernel runs a call: ``cluster`` CTAs a tile, each holding
    ``slice`` keys (in shared memory when ``on_chip``, else in device
    memory), ``threads`` a CTA."""

    cluster: int
    slice: int
    on_chip: bool
    threads: int


def _spread(T: int, width: int) -> int:
    """CTAs a tile should take by the cluster sweeps of ``chip_smoke.py``'s
    phase 4c (every descent of the served batches, verb ladders and tiled
    batches on the 2^24-point tree; NVIDIA H100 80GB HBM3, 700.00 W):
    64 tiles and more fill the card at one CTA each; 16 gain from 4 CTAs on
    levels past 2,048 candidates and lose on narrower ones, where a
    cluster's barriers cost more than its SMs give; 3-8 tiles from up to 8
    at a CTA per 512 candidates, and one or two tiles from up to 16 (the
    served 7-row collect: 0.0557 ms at 16 against 0.0725 at 8)."""
    if T >= 64:
        return 1
    if T > 8:
        return max(1, min(4, width // 2048))
    if width <= 1024:
        return 1
    return max(1, min(16 if T <= 2 else 8, width // 512))


def plan(T: int, cap: int, levels: int, smem_keys: int | None = None,
         cluster: int | None = None) -> Plan:
    """The launch's plan, from the shapes alone. Unless ``cluster`` forces
    it, c is the larger of the smallest size whose slices fit ``smem_keys``
    keys and the measured spread of :func:`_spread`; when no size's slices
    fit, the slices go to device memory."""
    sk = SMEM_KEYS_MAX if smem_keys is None else smem_keys
    width = level_width(cap, levels)

    def slice_for(c):
        return _pow2ceil(-(-width // c))

    if cluster is None:
        fits = next((c for c in CLUSTERS if slice_for(c) <= sk), 1)
        spread = 1 << (_spread(T, width).bit_length() - 1)
        cluster = max(fits, spread)
    sl = slice_for(cluster)
    threads = min(MAX_THREADS if cluster > 1 else SOLO_THREADS, max(32, sl // 2))
    return Plan(cluster, sl, sl <= sk, threads)


def _check_args(tree, box_lo, box_hi, bound, cap, smem_keys, cluster):
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
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}, got {cluster!r}")
    return dev, T, D


def frontier(tree, box_lo, box_hi, bound, cap: int, smem_keys: int | None = None,
             cluster: int | None = None):
    """(bucket ids i32[T, cap] lb-ascending with -1 padding, lower bounds
    f32[T, cap] with +inf padding, overflow bool[T]) for tile boxes
    ``box_lo``/``box_hi`` f32[T, D] and bounds f32[T] on ``tree``'s device:
    see :func:`kdtree_tpu_torch.ops.tile_query._frontier`. CUDA tensors
    launch the kernel on the :func:`plan` of the shapes; ``cluster`` forces
    the CTAs a tile and ``smem_keys`` (a power of two) the keys a CTA holds
    in shared memory, so that every path can be reached (a slice past it
    goes to device memory); the result is the same. A launch the card
    refuses raises. CPU tensors run the plain version."""
    dev, T, D = _check_args(tree, box_lo, box_hi, bound, cap, smem_keys, cluster)
    if dev.type == "cpu":
        return _frontier(tree, box_lo, box_hi, bound, cap)
    if dev.type != "cuda":
        raise ValueError(f"frontier runs on CUDA or CPU tensors, got {dev}")
    fn = _fn()
    p = plan(T, cap, tree.num_levels, smem_keys, cluster)
    bucket = torch.empty((T, cap), dtype=torch.int32, device=dev)
    lb = torch.empty((T, cap), dtype=torch.float32, device=dev)
    overflow = torch.empty(T, dtype=torch.bool, device=dev)
    if T == 0:
        return bucket, lb, overflow
    keys = None
    if not p.on_chip:
        keys = torch.empty((T * p.cluster, 2 * p.slice), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = fn(tree.node_lo.data_ptr(), tree.node_hi.data_ptr(), box_lo.data_ptr(),
                 box_hi.data_ptr(), bound.data_ptr(), bucket.data_ptr(), lb.data_ptr(),
                 overflow.data_ptr(), None if keys is None else keys.data_ptr(), T, D, cap,
                 start_level(cap, tree.num_levels), tree.num_levels, tree.num_buckets - 1,
                 p.cluster, p.slice, p.threads, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"frontier kernel launch failed with CUDA error {err} "
                           f"({p.cluster} CTAs a tile, {p.slice} keys each, "
                           f"{'shared' if p.on_chip else 'device'} memory)")
    frontier.launches += 1
    return bucket, lb, overflow


frontier.launches = 0


def _merge_path(a, b, d: int) -> int:
    """How many of the first ``d`` keys of the stable merge of ``a`` and
    ``b`` (on equal lb, ``a`` first) come from ``a``: the kernel's
    merge-path search, on the lb bits."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] >> 32 <= b[d - 1 - mid] >> 32:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _stable_by_lb(keys):
    return keys[np.argsort(keys >> 32, kind="stable")]


def _merge_runs(a, b, cap: int, Q: int):
    """One merge of two sorted runs as the kernel's CTAs make it: the first
    min(len a + len b, cap) keys of their stable merge, each CTA's Q of them
    from the merge-path splits of its range."""
    n = min(len(a) + len(b), cap)
    out = []
    for base in range(0, n, Q):
        end = min(base + Q, n)
        i0, i1 = _merge_path(a, b, base), _merge_path(a, b, end)
        out.append(_stable_by_lb(np.concatenate([a[i0:i1], b[base - i0:end - i1]])))
    return np.concatenate(out) if out else a[:0]


def frontier_mirror(tree, box_lo, box_hi, bound, cap: int, smem_keys: int | None = None,
                    cluster: int | None = None):
    """A step-for-step mirror of the frontier kernel
    (``csrc/frontier.cu::frontier_kernel_cluster`` and ``_solo``), for the
    tests: per tile, per level, the positions (the start level's nodes, or
    the left children of the live slots, then their right children) cut
    into the plan's ``c`` contiguous slices; each slice's live candidates
    (lb <= bound and finite) as keys (lb bits << 32 | node) in position
    order; the level ended when the cluster has none; the live keys
    rebalanced into shares of Q = ceil(count / c) in rank order, or all to
    the first CTA when they fit half its slice (Q = count); left so when
    every live lb is equal, else each share sorted stably by lb and the
    shares merged pairwise in log2(c) rounds of merge-path splits (on equal
    lb the lower CTA's run first), the first min(count, cap) kept. Returns
    (bucket i32[T, cap], lb f32[T, cap], overflow bool[T], stats), the
    first three equal to :func:`kdtree_tpu_torch.ops.tile_query._frontier`'s
    bit for bit; stats count the levels by path (``shared``, ``device``),
    the levels ``sorted`` and left in order (``uniform``), the
    ``merge_rounds``, the levels whose rebalance moved keys between CTAs
    (``rebalanced``), the cluster levels sorted by one CTA (``gathered``)
    or in shares (``spread``), the slices with no live candidate of a level
    that had some (``empty_slices``), and the tiles whose descent ``ended``
    at an empty level; ``cluster`` is the plan's c."""
    _, T, _ = _check_args(tree, box_lo, box_hi, bound, cap, smem_keys, cluster)
    L = tree.num_levels
    s = start_level(cap, L)
    p = plan(T, cap, L, smem_keys, cluster)
    c = p.cluster
    dev = box_lo.device
    bucket = torch.full((T, cap), -1, dtype=torch.int32, device=dev)
    lbs = torch.full((T, cap), float("inf"), device=dev)
    overflow = torch.zeros(T, dtype=torch.bool, device=dev)
    stats = {"cluster": c, "shared": 0, "device": 0, "sorted": 0, "uniform": 0,
             "merge_rounds": 0, "rebalanced": 0, "gathered": 0, "spread": 0,
             "empty_slices": 0, "ended": 0}
    path = "shared" if p.on_chip else "device"
    bound_np = bound.cpu().numpy()
    for t in range(T):
        slots = (np.arange(1 << s, dtype=np.int64) + ((1 << s) - 1))
        for level in range(s, L + 1):
            nodes = slots & 0xFFFFFFFF if level > s else slots
            cand = nodes if level == s else np.concatenate([2 * nodes + 1, 2 * nodes + 2])
            n = len(cand)
            P = -(-n // c)
            lb = _gathered_box_lb(tree, box_lo[t:t + 1], box_hi[t:t + 1],
                                  torch.from_numpy(cand)[None].to(dev))[0].cpu().numpy()
            with np.errstate(invalid="ignore"):
                live = (lb <= bound_np[t]) & np.isfinite(lb)
            keys = (lb.view(np.int32).astype(np.int64) << 32) | cand
            stats[path] += 1
            slices = [keys[j * P:(j + 1) * P][live[j * P:(j + 1) * P]] for j in range(c)]
            counts = [len(k) for k in slices]
            total = sum(counts)
            overflow[t] |= total > cap
            if total == 0:
                stats["ended"] += 1
                slots = slots[:0]
                break
            stats["empty_slices"] += sum(k == 0 for k in counts)
            Q = total if 2 * total <= p.slice else -(-total // c)  # one CTA, or a share each
            if c > 1:
                stats["gathered" if Q == total else "spread"] += 1
            ranked = np.concatenate(slices)
            shares = [ranked[j * Q:(j + 1) * Q] for j in range(c)]
            stats["rebalanced"] += [len(k) for k in shares] != counts
            if (ranked >> 32).min() == (ranked >> 32).max():
                stats["uniform"] += 1
                slots = ranked[:cap]
                continue
            stats["sorted"] += 1
            runs = [_stable_by_lb(k) for k in shares]
            while Q < total and len(runs) > 1:
                stats["merge_rounds"] += 1
                runs = [_merge_runs(runs[g], runs[g + 1], cap, Q) for g in range(0, len(runs), 2)]
            slots = runs[0][:cap]
        k = len(slots)
        bucket[t, :k] = torch.from_numpy((slots & 0xFFFFFFFF) - (tree.num_buckets - 1)).to(
            torch.int32)
        lbs[t, :k] = torch.from_numpy((slots >> 32).astype(np.int32).view(np.float32))
    return bucket, lbs, overflow, stats
