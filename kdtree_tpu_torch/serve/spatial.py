"""Spatial sharding + selective router fan-out: the geometry layer.

The port of ``kdtree_tpu/serve/spatial.py``, host code copied as it is.

A k-d tree search prunes a subtree when the best-so-far distance beats
its region's lower bound. A router over shards that own contiguous
**id** ranges has no analog of that argument: every query hits every
shard, and aggregate cost is linear in shard count. This module is the
same lb-ordered early-exit idea ONE LEVEL UP: shards own contiguous
**Morton-range regions** instead, publish their bounding boxes, and the router ranks shards by
point-to-box lower bound and widens its fan-out only while the running
k-th best distance still exceeds the next shard's box bound — answers
provably identical to the full fan-out, at a fraction of the contacts.

Everything here is host code (numpy + stdlib, **no torch**): the router
process must stay device-free, and the partitioner's Morton quantization
must agree bit-for-bit with the router's write-ownership computation —
one implementation guarantees that. The formula mirrors
:func:`kdtree_tpu_torch.ops.morton.morton_codes` exactly (same grid, same
clip-before-cast, same interleave), so a partition built here produces
the same cell assignment the device build would.

Three layers:

- **codes/partition** — :func:`morton_codes_np` (the numpy twin of the
  device coder), :func:`plan_partition` (split a cloud into P
  near-equal contiguous Morton-range shards; each shard's slice of the
  sorted order, its half-open code range, and its tight AABB), and
  :func:`owner_of` (which shard's code range contains a point — the
  router's spatial write routing);
- **bounds** — :func:`box_lower_bounds`: exact squared lower bound from
  each query to a shard's AABB, computed in float32 with the same
  gap-max-sum formula as the device kernel's ``_bbox_d2`` so the
  router's pruning threshold can never ride above a distance the shard
  itself would compute;
- **selection** — :func:`initial_wave` / :func:`widen_wave`: the
  two-wave widening policy. Wave 1 contacts every box that CONTAINS a
  query (lb == 0), every legacy no-box shard (never prunable — a fleet
  mixing box-publishing and legacy shards degrades to full fan-out for
  the legacy ones, never prunes them silently), and the nearest shard
  otherwise. After wave 1's merge, a remaining shard is needed for
  query q iff q still lacks k real candidates or the shard's lower
  bound does not STRICTLY exceed q's running k-th best distance (ties
  must be contacted: an equal-distance lower-id candidate would
  displace the incumbent in the (distance, id) merge — strictness is
  what makes the answer byte-identical, not just equal-distance).
  Exact mode contacts every needed shard; because merged worsts only
  shrink, nothing un-pruned can become needed afterwards, so two waves
  always suffice. With a ``recall_target`` t the widening stops once
  the fraction of queries holding the full exactness guarantee reaches
  t — guaranteed queries have per-query recall exactly 1, so the mean
  recall@k over the batch is bounded below by t (the spatial analog of
  the recall dial's gear contract; queries short of k real candidates always
  force widening — padding is correctness, not recall).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PARTITION_MANIFEST", "SpatialGrid", "morton_codes_np",
    "plan_partition", "owner_of", "box_lower_bounds", "box_union",
    "initial_wave", "widen_wave",
]

PARTITION_MANIFEST = "PARTITION.json"
PARTITION_SCHEMA = 1


class SpatialGrid:
    """The quantization grid one spatial fleet shares: per-axis ``lo`` /
    ``hi`` (float32) and ``bits`` per axis. Every shard's manifest
    carries it; the router reads any shard's copy (they are identical
    by construction) to compute write ownership."""

    __slots__ = ("lo", "hi", "bits")

    def __init__(self, lo, hi, bits: int) -> None:
        self.lo = np.asarray(lo, dtype=np.float32).reshape(-1)
        self.hi = np.asarray(hi, dtype=np.float32).reshape(-1)
        self.bits = int(bits)
        if self.lo.shape != self.hi.shape or self.lo.size < 1:
            raise ValueError("grid lo/hi must be matching [D] vectors")
        if not (1 <= self.bits <= 16):
            raise ValueError(f"grid bits must be in [1, 16], got {bits}")

    @property
    def dim(self) -> int:
        return int(self.lo.size)

    def to_json(self) -> Dict:
        return {"lo": [float(x) for x in self.lo],
                "hi": [float(x) for x in self.hi],
                "bits": self.bits}

    @classmethod
    def from_json(cls, obj) -> Optional["SpatialGrid"]:
        """Parse a wire/manifest grid dict; None for anything malformed
        (advisory metadata reads as absent, never as a crash — the
        plan-store trust model)."""
        if not isinstance(obj, dict):
            return None
        try:
            lo = [float(x) for x in obj["lo"]]
            hi = [float(x) for x in obj["hi"]]
            grid = cls(lo, hi, int(obj["bits"]))
        except (KeyError, TypeError, ValueError):
            return None
        return grid if len(lo) == len(hi) and lo else None


def default_bits_np(dim: int) -> int:
    """The shared quantization-bit rule — numerically identical to
    :func:`kdtree_tpu_torch.ops.morton.default_bits`, restated here so the
    host-only layer never imports the device module (a test pins the
    two equal)."""
    return max(1, min(32 // max(dim, 1), 16))


def morton_codes_np(points: np.ndarray, grid: SpatialGrid) -> np.ndarray:
    """u32 Morton codes on an explicit grid — the numpy twin of
    :func:`kdtree_tpu_torch.ops.morton.morton_codes` (same float32
    normalization, same clip-before-cast, same ``b*d+a < 32``
    interleave), so the partitioner's cell assignment and the router's
    write-ownership computation cannot disagree with each other or with
    the device coder."""
    pts = np.asarray(points, dtype=np.float32)
    n, d = pts.shape
    bits = grid.bits
    scale = np.where(grid.hi > grid.lo, grid.hi - grid.lo,
                     np.float32(1.0))
    t = (pts - grid.lo) / scale * np.float32(1 << bits)
    finite = np.isfinite(pts).all(axis=1)
    t = np.where(finite[:, None], t, np.float32(1 << bits))
    cells = np.clip(t, 0.0, float((1 << bits) - 1)).astype(np.uint32)
    code = np.zeros(n, dtype=np.uint32)
    for b in range(bits):
        for a in range(d):
            if b * d + a < 32:
                code |= ((cells[:, a] >> np.uint32(b)) & np.uint32(1)) \
                    << np.uint32(b * d + a)
    return code


def code_space(dim: int, bits: int) -> int:
    """Exclusive upper bound of the code range the grid can mint — the
    last shard's half-open range ends here so the shard ranges tile the
    whole space (every point, even one far outside the original cloud,
    clamps into some cell and therefore has exactly one owner)."""
    return 1 << min(bits * dim, 32)


def plan_partition(
    points: np.ndarray, shards: int, bits: Optional[int] = None,
) -> Dict:
    """Split a point cloud into ``shards`` contiguous Morton-range
    partitions of near-equal size.

    Returns a plan dict::

        {"grid": SpatialGrid, "order": i64[N] (morton-rank -> original
         row), "bounds": [(start, end)] global-rank slices,
         "code_ranges": [(code_lo, code_hi)] half-open, tiling
         [0, code_space), "boxes": [(lo f32[D], hi f32[D])] tight
         per-shard AABBs}

    Global ids are the Morton ranks: shard i owns ranks
    ``[start_i, end_i)``, so every shard's id set is contiguous AND its
    region is a contiguous code range — the two ownership notions
    coincide at build time. The cut codes are shared-cell-safe: a code
    value never splits across two shards (the range test
    ``code_lo <= code(p) < code_hi`` must name exactly one owner), so
    cuts shift to the next code boundary and shard sizes are
    near-equal, not exactly equal, on duplicate-heavy clouds."""
    pts = np.asarray(points, dtype=np.float32)
    n, d = pts.shape
    shards = int(shards)
    if shards < 1:
        raise ValueError(f"need at least 1 shard, got {shards}")
    if n < shards:
        raise ValueError(
            f"cannot cut {n} points into {shards} non-empty shards"
        )
    bits = default_bits_np(d) if bits is None else \
        max(1, min(int(bits), default_bits_np(d)))
    finite = np.isfinite(pts)
    lo = np.min(np.where(finite, pts, np.inf), axis=0)
    hi = np.max(np.where(finite, pts, -np.inf), axis=0)
    grid = SpatialGrid(lo, hi, bits)
    codes = morton_codes_np(pts, grid)
    # stable sort by (code, original row) — the same tie-break as the
    # device build's stable lax.sort by (code, gid)
    order = np.argsort(codes, kind="stable").astype(np.int64)
    sorted_codes = codes[order]
    space = code_space(d, bits)
    bounds: List[Tuple[int, int]] = []
    code_ranges: List[Tuple[int, int]] = []
    boxes: List[Tuple[np.ndarray, np.ndarray]] = []
    start = 0
    prev_code_hi = 0
    for i in range(shards):
        if i == shards - 1:
            end = n
        else:
            end = max(start + 1, round(n * (i + 1) / shards))
            # never split one code value across two shards: ownership
            # is a half-open CODE range, so a straddling cut would give
            # a cell two owners. Advance to the next code boundary.
            while end < n and sorted_codes[end] == sorted_codes[end - 1]:
                end += 1
        if end <= start:
            raise ValueError(
                f"partition collapsed: shard {i} would be empty "
                f"(duplicate-heavy cloud needs fewer shards)"
            )
        code_hi = space if i == shards - 1 else int(sorted_codes[end - 1]) + 1
        sub = pts[order[start:end]]
        boxes.append((sub.min(axis=0), sub.max(axis=0)))
        bounds.append((start, end))
        code_ranges.append((prev_code_hi, code_hi))
        prev_code_hi = code_hi
        start = end
    return {"grid": grid, "order": order, "bounds": bounds,
            "code_ranges": code_ranges, "boxes": boxes}


def owner_of(
    points: np.ndarray, grid: SpatialGrid,
    code_ranges: Sequence[Tuple[int, int]],
) -> np.ndarray:
    """The owning shard index per point — the shard whose half-open
    code range contains the point's Morton code. Ranges tile the code
    space and every row (even far outside the grid, or non-finite —
    both clamp into the top cell, exactly like the device coder) codes
    inside it, so every row has exactly one owner; -1 is returned only
    against ranges that do NOT tile the space (a malformed fleet)."""
    codes = morton_codes_np(np.asarray(points, dtype=np.float32), grid)
    los = np.asarray([r[0] for r in code_ranges], dtype=np.int64)
    idx = np.searchsorted(los, codes.astype(np.int64), side="right") - 1
    his = np.asarray([r[1] for r in code_ranges], dtype=np.int64)
    ok = (idx >= 0) & (codes.astype(np.int64) < his[np.maximum(idx, 0)])
    return np.where(ok, idx, -1).astype(np.int64)


def write_fleet_manifest(dirpath: str, plan: Dict,
                         shard_dirs: List[str]) -> str:
    """The partitioner's operator-facing summary (``PARTITION.json``):
    grid, per-shard ranges/boxes/dirs. The router does NOT read this —
    it learns topology from each shard's /healthz — but a human
    assembling the fleet command line does."""
    man = {
        "partition_schema": PARTITION_SCHEMA,
        "shards": len(shard_dirs),
        "grid": plan["grid"].to_json(),
        "entries": [
            {
                "shard": i,
                "dir": shard_dirs[i],
                "id_range": [int(s), int(e)],
                "code_range": [int(c0), int(c1)],
                "box": {"lo": [float(x) for x in blo],
                        "hi": [float(x) for x in bhi]},
            }
            for i, ((s, e), (c0, c1), (blo, bhi)) in enumerate(
                zip(plan["bounds"], plan["code_ranges"], plan["boxes"])
            )
        ],
    }
    path = os.path.join(dirpath, PARTITION_MANIFEST)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------


def box_lower_bounds(queries: np.ndarray, lo: np.ndarray,
                     hi: np.ndarray) -> np.ndarray:
    """Exact squared lower bound from each query to the AABB
    ``[lo, hi]`` — f32[Q], the numpy twin of the device kernel's
    ``_bbox_d2`` (same gap-max-sum formula, float32 arithmetic), so a
    pruning threshold computed here can never exceed a true distance
    the shard's own kernel would report for a point inside the box."""
    q = np.asarray(queries, dtype=np.float32)
    gap = np.maximum(np.maximum(lo[None, :] - q, q - hi[None, :]),
                     np.float32(0.0))
    return np.sum(gap * gap, axis=1, dtype=np.float32)


def box_union(
    boxes: Sequence[Optional[Tuple[np.ndarray, np.ndarray]]],
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Union of the known boxes (None entries skipped); None when none
    are known. A replica set's effective box is the union over its
    replicas — replicas can lag each other by an epoch, and a union is
    conservative (never stale-exclusive) for all of them."""
    known = [b for b in boxes if b is not None]
    if not known:
        return None
    lo = known[0][0]
    hi = known[0][1]
    for blo, bhi in known[1:]:
        lo = np.minimum(lo, blo)
        hi = np.maximum(hi, bhi)
    return lo, hi


# ---------------------------------------------------------------------------
# fan-out selection
# ---------------------------------------------------------------------------


def initial_wave(lbs: List[Optional[np.ndarray]]) -> List[int]:
    """Wave-1 shard indices: every legacy shard (``lbs[i] is None`` —
    no box means no pruning argument, so it is ALWAYS contacted),
    every shard whose box contains at least one query (lb == 0), and —
    when no box contains a query — the nearest shard by minimum lb, so
    the wave is never empty."""
    wave = [i for i, lb in enumerate(lbs) if lb is None]
    boxed = [(i, lb) for i, lb in enumerate(lbs) if lb is not None]
    containing = [i for i, lb in boxed if float(lb.min()) == 0.0]
    wave.extend(containing)
    if boxed and not containing:
        wave.append(min(boxed, key=lambda t: float(t[1].min()))[0])
    if not wave and lbs:
        wave.append(0)
    return sorted(set(wave))


def _needed_mask(lb: np.ndarray, worst: np.ndarray,
                 short: np.ndarray) -> np.ndarray:
    """Per-query need for one remaining shard: the query still lacks k
    real candidates (``short``), or the shard's box bound does not
    STRICTLY exceed the running k-th best distance. ``<=`` on the tie:
    an equal-distance candidate with a smaller id would displace the
    incumbent in the (distance, id) merge, so a tied box must be
    contacted for the answer to stay byte-identical."""
    return short | (lb.astype(np.float64) <= worst)


def widen_wave(
    lbs: List[Optional[np.ndarray]],
    remaining: Sequence[int],
    worst: np.ndarray,
    short: np.ndarray,
    recall_target: Optional[float] = None,
) -> Tuple[List[int], int]:
    """Wave-2 selection after the initial wave's merge.

    ``worst`` is the per-query running k-th best distance (+inf where
    fewer than k real candidates merged so far) and ``short`` the
    per-query fewer-than-k-real-candidates mask. ``lbs`` must be in
    the SAME value space as ``worst`` — the router passes float64
    sqrt distances for both, matching the response wire format, so the
    strict-tie comparison compares like with like.

    Exact mode (``recall_target`` None): returns every remaining shard
    some query still needs. The merge after this wave can only shrink
    ``worst``, so un-returned shards can never become needed — two
    waves are always enough, and the result is byte-identical to full
    fan-out.

    With a ``recall_target`` t: walks the needed shards in ascending
    min-lb order and stops once the fraction of queries holding the
    full exactness guarantee (no needed shard left uncontacted)
    reaches t. Queries short of k real candidates ALWAYS force
    widening — under-filled answers are a correctness matter, not a
    recall trade. Returns ``(wave, unguaranteed)`` where
    ``unguaranteed`` is how many queries were left without the full
    guarantee (0 means the answer is exact despite the target — the
    response then carries no spatial gear)."""
    nq = int(worst.shape[0])
    needsets: Dict[int, set] = {}  # query -> needed remaining shards
    by_shard: Dict[int, np.ndarray] = {}
    for s in remaining:
        lb = lbs[s]
        if lb is None:
            # a legacy shard in `remaining` (only possible when the
            # caller excluded it from wave 1) is needed by everyone
            mask = np.ones(nq, dtype=bool)
        else:
            mask = _needed_mask(lb, worst, short)
        if mask.any():
            by_shard[s] = mask
            for qi in np.nonzero(mask)[0]:
                needsets.setdefault(int(qi), set()).add(s)
    if not by_shard:
        return [], 0
    if recall_target is None:
        return sorted(by_shard), 0
    target = float(recall_target)
    # ascending min-lb: the same lb-ordered widening as the exact path,
    # just allowed to stop early
    ordered = sorted(
        by_shard,
        key=lambda s: float(lbs[s].min()) if lbs[s] is not None else -1.0,
    )
    must = {int(qi) for qi in np.nonzero(short)[0] if int(qi) in needsets}
    wave: List[int] = []
    unguaranteed = len(needsets)
    max_unguaranteed = math.floor((1.0 - target) * nq + 1e-9)
    for s in ordered:
        if unguaranteed <= max_unguaranteed and not must:
            break
        wave.append(s)
        for qi in list(needsets):
            qset = needsets[qi]
            qset.discard(s)
            if not qset:
                del needsets[qi]
                must.discard(qi)
                unguaranteed -= 1
    return sorted(wave), len(needsets)
