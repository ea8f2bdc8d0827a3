"""The query verbs' wire contract, shared by shard server and router.

A copy of ``kdtree_tpu/verbs/wire.py`` (host numpy only), so the port's
server parses and shapes exactly what the reference's does. One module
owns request validation and response row shaping for
``/v1/radius``, ``/v1/range`` and ``/v1/count`` so the two HTTP fronts
cannot drift apart — the same single-validator idea as
``approx.parse_recall_target``. Every rejection names what was wrong.

JSON schemas (requests):

- ``/v1/radius``: ``{"queries": [[f32 x D] x q], "r": f | [f x q]}``
  plus the shared optionals (``recall_target``, ``deadline_ms``).
- ``/v1/range``:  ``{"lo": [[f32 x D] x q], "hi": [[f32 x D] x q]}``.
  ``lo > hi`` on any axis is a legitimately EMPTY box, not an error.
- ``/v1/count``:  exactly one of the two shapes above (``"r"`` selects
  the radius form, ``"lo"``/``"hi"`` the box form).

Responses carry ``counts`` always; ``ids`` (global, offset applied,
ascending or (distance, id)-ascending) and ``distances`` (sqrt of the
f32 d2 in float64, the k-NN response convention) only for the
id-materializing verbs; ``truncated`` whenever a bounded-visit answer
is a lower bound rather than exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

VERBS = ("radius", "range", "count")
COUNT_FORMS = ("radius", "box")


class VerbParseError(ValueError):
    """Invalid verb request body; ``str(e)`` is the 400 message."""


def _parse_matrix(payload, key: str, dim: int) -> np.ndarray:
    if key not in payload:
        raise VerbParseError(f'body must include "{key}"')
    try:
        arr = np.asarray(payload[key], dtype=np.float32)
    except (TypeError, ValueError):
        raise VerbParseError(f'"{key}" must be a [q, d] number array')
    if arr.ndim != 2 or arr.shape[0] < 1:
        raise VerbParseError(f'"{key}" must be non-empty [q, {dim}], '
                             f"got shape {arr.shape}")
    if arr.shape[1] != dim:
        raise VerbParseError(f'"{key}" rows are {arr.shape[1]}-D but '
                             f"the index is {dim}-D")
    if not np.isfinite(arr).all():
        raise VerbParseError(f'"{key}" contains non-finite values')
    return arr


def parse_radius_body(payload: dict,
                      dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Validated (queries f32[q, D], r f32[q]). ``r`` may be a scalar
    (shared by all rows) or per-query; r = 0 is the legitimate
    degenerate radius (hits only coincident points)."""
    queries = _parse_matrix(payload, "queries", dim)
    if "r" not in payload:
        raise VerbParseError('body must include "r" (radius, scalar or '
                             "per-query list)")
    try:
        r = np.asarray(payload["r"], dtype=np.float32)
    except (TypeError, ValueError):
        raise VerbParseError('"r" must be a number or a [q] number list')
    if r.ndim not in (0, 1):
        raise VerbParseError('"r" must be a scalar or a [q] list, got '
                             f"shape {r.shape}")
    if r.ndim == 1 and r.shape[0] != queries.shape[0]:
        raise VerbParseError(f'"r" has {r.shape[0]} entries for '
                             f"{queries.shape[0]} queries")
    if not np.isfinite(r).all() or (np.asarray(r) < 0).any():
        raise VerbParseError('"r" must be finite and >= 0')
    return queries, np.broadcast_to(r, (queries.shape[0],)).astype(
        np.float32)


def parse_range_body(payload: dict,
                     dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Validated (lo f32[q, D], hi f32[q, D])."""
    lo = _parse_matrix(payload, "lo", dim)
    hi = _parse_matrix(payload, "hi", dim)
    if lo.shape != hi.shape:
        raise VerbParseError(f'"lo" {lo.shape} and "hi" {hi.shape} must '
                             "have the same shape")
    return lo, hi


def parse_count_body(
    payload: dict, dim: int,
) -> Tuple[str, np.ndarray, Optional[np.ndarray], Optional[np.ndarray],
           Optional[np.ndarray]]:
    """Validated (form, queries|lo, r|None, lo|None, hi|None): the count
    verb is radius-form or box-form, selected by which keys are present
    (exactly one form, never both)."""
    has_r = "r" in payload or "queries" in payload
    has_box = "lo" in payload or "hi" in payload
    if has_r == has_box:
        raise VerbParseError(
            'count takes exactly one form: {"queries", "r"} (within '
            'radius) or {"lo", "hi"} (within box)')
    if has_r:
        queries, r = parse_radius_body(payload, dim)
        return "radius", queries, r, None, None
    lo, hi = parse_range_body(payload, dim)
    return "box", lo, None, lo, hi


def globalize_ids(ids: np.ndarray, id_offset: int) -> np.ndarray:
    """Shard-local gids -> global ids (padding stays -1); int64 like
    the k-NN response so deep shards can't wrap the i32 gid table."""
    ids = ids.astype(np.int64)
    if id_offset:
        ids = np.where(ids >= 0, ids + id_offset, -1)
    return ids


def radius_rows_json(d2: np.ndarray, ids: np.ndarray,
                     counts: np.ndarray, id_offset: int):
    """Variable-length response rows for the radius verb: per query,
    the hit ids ((distance, id)-ascending, padding stripped) and their
    Euclidean distances (sqrt of the f32 d2 in float64, the k-NN
    convention — identical arithmetic on every shard keeps the
    router's dedup-union merge byte-identical)."""
    gids = globalize_ids(ids, id_offset)
    dist = np.sqrt(d2.astype(np.float64))
    out_ids, out_d = [], []
    for q in range(ids.shape[0]):
        n = int(counts[q])
        out_ids.append(gids[q, :n].tolist())
        out_d.append(dist[q, :n].tolist())
    return out_ids, out_d


def range_rows_json(ids: np.ndarray, counts: np.ndarray,
                    id_offset: int):
    """Variable-length response rows for the range verb: per query,
    the contained ids ascending, padding stripped."""
    gids = globalize_ids(ids, id_offset)
    return [gids[q, :int(counts[q])].tolist()
            for q in range(ids.shape[0])]
