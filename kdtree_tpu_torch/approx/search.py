"""Bounded-visit approximate k-NN: a cap on the exact candidate ranking.

The port of ``kdtree_tpu/approx/search.py``. The tiled engine's collect
pass already ranks every candidate bucket lb-ascending per tile, and its
dense scan walks that ranking front to back behind an early exit. The
approximate mode is a truncation of that list, not a new traversal:
scan only the ``visit_cap`` nearest buckets and stop. Three properties
follow:

- **monotone recall**: truncations of one ranking are nested, so a larger
  cap can only add candidates;
- **exactness at full cap**: a cap at least as wide as the collected list
  is the exact run, byte for byte;
- **true distances**: an answer is the exact top-k over the visited
  points; only the candidate set is bounded, which is what recall@k
  measures.

On the card every approximate batch is a launch of the CUDA scan kernel
on the shorter list.

:func:`resolve_visit_cap` maps a ``recall_target`` to a cap: from the
plan-store calibration the recall harness persisted
(:mod:`kdtree_tpu_torch.approx.recall`), or from a conservative
fraction-of-buckets heuristic. Both are advisory.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from kdtree_tpu_torch import obs

# the calibration grid the harness measures and serving resolves against;
# ascending, so "smallest calibrated target covering the request" is a scan
DEFAULT_TARGETS = (0.5, 0.75, 0.9, 0.95, 0.99)

# uncalibrated fallback: the fraction of the bucket count visited per
# recall band. Conservative on purpose: a missed neighbour costs an answer,
# a visit only costs time
_HEURISTIC_FRACS = (
    (0.99, 0.5),
    (0.95, 0.33),
    (0.9, 0.25),
    (0.0, 0.125),
)
_MIN_VISIT = 2

# the wire contract's rejection text, shared by every validator
RECALL_TARGET_ERROR = "recall_target must be a number in (0, 1]"


def parse_recall_target(raw) -> Tuple[bool, Optional[float]]:
    """Validate one wire ``recall_target`` value: ``(ok, normalized)``.
    ``ok`` False means reject with :data:`RECALL_TARGET_ERROR`;
    ``normalized`` is None for absent / 1.0 (both spell exact), the float
    target otherwise."""
    if raw is None:
        return True, None
    if not isinstance(raw, (int, float)) or isinstance(raw, bool) or \
            not (0.0 < raw <= 1.0):
        return False, None
    target = float(raw)
    return True, None if target >= 1.0 else target


def _min_cap_for_k(k: int, bucket_size: int) -> int:
    """Fewer than ceil(k / B) buckets cannot even hold k candidates; one
    more keeps the k-th slot contested."""
    return max(_MIN_VISIT, -(-int(k) // max(int(bucket_size), 1)) + 1)


def _calibrated_cap(recall_caps: dict, target: float) -> Optional[int]:
    """The smallest calibrated cap whose measured target covers the
    requested one, or None. ``recall_caps`` is the store's ``{"0.99": 12,
    ...}`` mapping; anything malformed reads as absent."""
    best: Optional[int] = None
    for raw_t, raw_cap in (recall_caps or {}).items():
        try:
            t, cap = float(raw_t), int(raw_cap)
        except (TypeError, ValueError):
            continue
        if isinstance(raw_cap, bool) or cap < 1 or t < float(target):
            continue
        if best is None or cap < best:
            best = cap
    return best


def resolve_visit_cap(
    recall_target: Optional[float],
    nbp: int,
    k: int,
    bucket_size: int,
    sig=None,
    profile: Optional[dict] = None,
) -> Optional[int]:
    """The visit cap serving a ``recall_target`` — None means exact.

    An explicit ``profile`` (or the plan-store profile for ``sig``) with a
    ``recall_caps`` calibration wins; the fraction-of-buckets heuristic
    answers otherwise. ``None`` and targets >= 1.0 are exact. The cap is
    clamped so that k real candidates stay reachable, and a cap of the
    whole bucket count is exact (None)."""
    if recall_target is None or float(recall_target) >= 1.0:
        return None
    target = float(recall_target)
    nbp = int(nbp)
    if profile is None and sig is not None:
        from kdtree_tpu_torch import tuning

        profile = tuning.profile_for(sig)
    cap = None
    if isinstance(profile, dict):
        cap = _calibrated_cap(profile.get("recall_caps"), target)
    if cap is None:
        frac = _HEURISTIC_FRACS[-1][1]
        for floor, f in _HEURISTIC_FRACS:
            if target >= floor:
                frac = f
                break
        cap = int(math.ceil(nbp * frac))
    cap = max(cap, _min_cap_for_k(k, bucket_size))
    if cap >= nbp:
        return None
    return cap


def morton_knn_approx(
    tree,
    queries,
    k: int = 1,
    visit_cap: Optional[int] = None,
    recall_target: Optional[float] = None,
    plan=None,
):
    """Approximate k-NN over a Morton tree: the tiled engine with its
    dense scan bounded to the ``visit_cap`` nearest candidate buckets per
    tile. Same contract as
    :func:`~kdtree_tpu_torch.ops.tile_query.morton_knn_tiled` (d2 f32[Q,
    k], ids i32[Q, k], ascending; exact over the visited points).

    An explicit ``visit_cap`` wins; a ``recall_target`` resolves through
    :func:`resolve_visit_cap`. Neither, or a cap of the full bucket count,
    runs the exact path unchanged."""
    from kdtree_tpu_torch.ops.tile_query import morton_knn_tiled

    if visit_cap is None and recall_target is not None:
        visit_cap = resolve_visit_cap(
            recall_target, tree.num_buckets, k, tree.bucket_size,
        )
    if visit_cap is not None:
        visit_cap = min(max(int(visit_cap), 1), int(tree.num_buckets))
        obs.get_registry().gauge("kdtree_approx_visit_cap").set(visit_cap)
        if visit_cap >= int(tree.num_buckets):
            visit_cap = None
    return morton_knn_tiled(tree, queries, k=k, plan=plan,
                            visit_cap=visit_cap)
