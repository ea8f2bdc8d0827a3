"""Tree-pruned device search for the query verbs (radius / range / count).

The port of ``kdtree_tpu/verbs/device.py``. The k-NN tile engine already
computes the one geometric fact every spatial verb needs: the exact
box-to-box lower bound of |q - p|^2 between a tile of queries and a tree
node, ranked lb-ascending by the level-synchronous frontier
(:func:`~kdtree_tpu_torch.kernels.frontier.frontier`: the hand-written
kernel on the card, its plain version
:func:`~kdtree_tpu_torch.ops.tile_query._frontier` on the CPU). The verbs
reuse that frontier unchanged — only the *bound* and the *fold* differ per verb:

- **radius** (all points with d(q, p) <= r): collect every bucket whose
  lower bound vs the tile's covering box is <= the tile's largest r^2;
  the fold keeps, per query, the m best (d2, id) hits.
- **range** (axis-aligned box containment): the same frontier with the
  union of the tile's query boxes as the "tile box" and bound 0 (a node
  survives iff its box is not disjoint from the union); the fold keeps
  the m smallest contained ids.
- **count**: either traversal with the id fold stripped.

The folds, XLA programs in the reference, are hand-written CUDA kernels on
the card (:mod:`kdtree_tpu_torch.kernels.verb_fold`, ``csrc/verb_fold.cu``)
whose plain versions, ``_radius_fold_plain`` and ``_range_fold_plain`` of
the same module (named here too), run on the CPU. Each pass runs its frontier
inside the profiler range ``verbs.frontier`` and its fold inside
``verbs.fold``, so a trace splits a batch's device time between the two.
Membership is decided by ``d2 <= r^2``, so d2 is computed in the
reference's arithmetic (:func:`~kdtree_tpu_torch.ops._arith.sq_dist`: the
FMA chain XLA:CPU compiles ``jnp.sum(diff * diff, -1)`` to, or its window
sum of rounded squares above 32 axes; the kernel's ``csrc/d2.cuh``): a
one-ulp difference would change the hit set, not only a distance.

Exactness contract: identical to k-NN. Candidate overflow (more buckets
pass the bound than the frontier cap holds) and hit overflow (more hits
than the per-query buffer holds) are both detected and retried by the
host driver with doubled capacity — overflow is the only sign of an
incomplete answer, never silent truncation. An overflowing frontier
skips its fold, since the retry replaces it.

Bounded-visit truncation (``visit_cap``): the lb-ascending candidate list
of each tile is cut to its first ``visit_cap`` buckets right after the
frontier, as the approximate k-NN cuts it (:mod:`kdtree_tpu_torch.approx`),
and the answer is a flagged sound lower bound (``truncated``: some tile
had more finite candidates than the cap). Frontier overflow is not
retried under a cap: the beam the frontier kept is what the cap truncates,
as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from kdtree_tpu_torch.kernels import verb_fold
from kdtree_tpu_torch.kernels.frontier import frontier
from kdtree_tpu_torch.kernels.verb_fold import (  # noqa: F401 (the plain folds, named here)
    ID_INF, _radius_fold_plain, _range_fold_plain)
from kdtree_tpu_torch.ops.morton import MortonTree, default_bits
from kdtree_tpu_torch.ops.tile_query import _sort_queries
from kdtree_tpu_torch.serve.engine import _pow2_ceil

DEFAULT_TILE = 64  # queries per tile: verbs carry per-query bounds, so
# smaller tiles keep the tile-box over-approximation (max r^2 / union
# box) tight; pow2 like the k-NN tiles
DEFAULT_CAP = 64  # candidate buckets per tile (doubles on frontier overflow)
DEFAULT_HITS = 128  # per-query hit-buffer lanes (doubles on hit overflow)
_MAX_Q = 1 << 15  # queries per device program; larger sets stream in slices

# the int32 "no hit" sentinel: real gids are < 2^31 (guarded at build),
# so the sentinel always sorts last
_ID_INF = np.int32(ID_INF)


class VerbResult(NamedTuple):
    """One verb answer over a query batch, host-materialized.

    ``counts`` is exact (or a sound lower bound when ``truncated``).
    ``d2``/``ids`` are None for count-only calls; otherwise rows are
    canonically (d2, id)-ascending for radius and id-ascending for
    range, padded to the common width with (+inf, -1).
    """

    counts: np.ndarray  # i64[Q]
    d2: Optional[np.ndarray]  # f32[Q, m] | None
    ids: Optional[np.ndarray]  # i32[Q, m] | None
    truncated: bool  # visit_cap actually cut a tile's candidate list
    retries: int  # overflow-retry doublings the driver paid


def canonical_radius_rows(d2: np.ndarray, ids: np.ndarray):
    """Row-wise canonical (d2, id)-ascending order, (+inf, -1) padding
    last — the byte-identity normal form shared by the device driver,
    the brute-force oracle, and the mutable overlay's merge. Two stable
    argsorts compose into a lexsort (secondary key first)."""
    d2 = np.where(ids < 0, np.inf, d2)
    by_id = np.argsort(np.where(ids < 0, _ID_INF, ids), axis=1,
                       kind="stable")
    d2 = np.take_along_axis(d2, by_id, axis=1)
    ids = np.take_along_axis(ids, by_id, axis=1)
    by_d = np.argsort(d2, axis=1, kind="stable")
    return (np.take_along_axis(d2, by_d, axis=1),
            np.take_along_axis(ids, by_d, axis=1))


def canonical_range_rows(ids: np.ndarray) -> np.ndarray:
    """Row-wise id-ascending order with -1 padding last — the range
    verb's normal form (containment has no distances)."""
    ids = np.sort(np.where(ids < 0, _ID_INF, ids), axis=1, kind="stable")
    return np.where(ids == _ID_INF, -1, ids)


def merge_results(kind: str, a: VerbResult, b: VerbResult) -> VerbResult:
    """Row-wise union of two :class:`VerbResult`\\ s over the same query
    batch whose underlying point sets are DISJOINT (the mutable overlay:
    masked main storage vs the delta buffer) — counts add, id rows
    concatenate and re-canonicalize. ``kind`` is "radius" or "range"."""
    counts = a.counts + b.counts
    truncated = a.truncated or b.truncated
    retries = a.retries + b.retries
    if a.ids is None:
        return VerbResult(counts, None, None, truncated, retries)
    ids = np.concatenate([a.ids, b.ids], axis=1)
    if kind == "radius":
        d2 = np.concatenate([a.d2, b.d2], axis=1)
        d2, ids = canonical_radius_rows(d2, ids)
        return VerbResult(counts, d2, ids, truncated, retries)
    return VerbResult(counts, None, canonical_range_rows(ids),
                      truncated, retries)


def trim_result(res: VerbResult) -> VerbResult:
    """Drop all-padding trailing columns (rows stay canonical — padding
    sorts last) so overlay-widened buffers leave at hit width."""
    if res.ids is None:
        return res
    m = max(int(res.counts.max(initial=0)), 1)
    if m >= res.ids.shape[1]:
        return res
    return VerbResult(res.counts,
                      None if res.d2 is None else res.d2[:, :m],
                      res.ids[:, :m], res.truncated, res.retries)


def _host_rows(x) -> np.ndarray:
    """A writable host f32 copy of caller rows (array or tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    # kdt-lint: disable=KDT201 verb API boundary: caller rows arrive as host arrays or are copied off the device just above
    return np.array(x, dtype=np.float32)


def _truncate(cand, cand_lb, visit_cap):
    """Slice the lb-ascending candidate list to ``visit_cap`` (the verbs'
    analog of the k-NN bounded-visit slice) and report, per tile, whether
    anything finite was cut."""
    if visit_cap is None or visit_cap >= cand.shape[1]:
        return cand, torch.zeros(cand.shape[0], dtype=torch.bool,
                                 device=cand.device)
    cut = torch.isfinite(cand_lb).sum(dim=1) > visit_cap
    return cand[:, :visit_cap], cut


def _live_candidates(cand, overflow, cut):
    """(any tile overflowed, candidate columns any tile uses, any tile
    truncated): one host fetch. The frontier's candidates are an
    lb-ascending prefix with -1 padding after it, so the columns past the
    longest prefix hold only padding, and folding them changes nothing."""
    flags = torch.stack([overflow.any().to(torch.int64),
                         (cand >= 0).sum(dim=1).max().to(torch.int64),
                         cut.any().to(torch.int64)])
    ovf, ncand, trunc = flags.cpu().tolist()
    return bool(ovf), int(ncand), bool(trunc)


def _radius_tiles(tree: MortonTree, tq, r2, cap: int, m: int,
                  visit_cap: Optional[int], count_only: bool,
                  skip_fold_on_overflow: bool):
    """Radius over tiles: tq f32[T, TQ, D], r2 f32[T, TQ] (negative =
    padding row, never hits). Returns (counts i32[T, TQ], best_d
    f32[T, TQ, m], best_i i32[T, TQ, m], frontier overflow, truncated);
    the fold is skipped (counts None) when the frontier overflowed and
    the caller will retry. The fold is
    :func:`kdtree_tpu_torch.kernels.verb_fold.radius_fold`: the kernel on
    the card, the plain version on the CPU. Its rows hold every hit of a
    query whose count is <= m, in no set order (the slice orders them)."""
    box_lo = tq.amin(dim=1)
    box_hi = tq.amax(dim=1)
    bound = r2.amax(dim=1)  # covers every query the tile holds
    with record_function("verbs.frontier"):
        cand, cand_lb, overflow = frontier(tree, box_lo, box_hi, bound, cap)
        cand, cut = _truncate(cand, cand_lb, visit_cap)
        ovf, ncand, trunc = _live_candidates(cand, overflow, cut)
    if ovf and skip_fold_on_overflow:
        return None, None, None, True, trunc
    with record_function("verbs.fold"):
        counts, best_d, best_i = verb_fold.radius_fold(
            tree, tq.contiguous(), r2.contiguous(), cand[:, :ncand].contiguous(),
            0 if count_only else m)
    return counts, best_d, best_i, ovf, trunc


def _range_tiles(tree: MortonTree, qlo, qhi, cap: int, m: int,
                 visit_cap: Optional[int], count_only: bool,
                 skip_fold_on_overflow: bool):
    """Box containment over tiles: qlo/qhi f32[T, TQ, D] per-query boxes
    (padding rows carry the empty box lo=+inf/hi=-inf). The tile box is
    the UNION of its query boxes; bound 0 keeps exactly the nodes not
    disjoint from it. Returns (counts, best_i i32[T, TQ, m], frontier
    overflow, truncated); the fold is
    :func:`kdtree_tpu_torch.kernels.verb_fold.range_fold`, whose rows hold
    every hit of a query whose count is <= m, in no set order."""
    T = qlo.shape[0]
    box_lo = qlo.amin(dim=1)
    box_hi = qhi.amax(dim=1)
    bound = torch.zeros(T, dtype=torch.float32, device=qlo.device)
    with record_function("verbs.frontier"):
        cand, cand_lb, overflow = frontier(tree, box_lo, box_hi, bound, cap)
        cand, cut = _truncate(cand, cand_lb, visit_cap)
        ovf, ncand, trunc = _live_candidates(cand, overflow, cut)
    if ovf and skip_fold_on_overflow:
        return None, None, True, trunc
    with record_function("verbs.fold"):
        counts, best_i = verb_fold.range_fold(
            tree, qlo.contiguous(), qhi.contiguous(), cand[:, :ncand].contiguous(),
            0 if count_only else m)
    return counts, best_i, ovf, trunc


def _tile_for(q: int) -> int:
    return min(DEFAULT_TILE, _pow2_ceil(max(q, 1)))


def _cap_ceiling(tree: MortonTree) -> int:
    return _pow2_ceil(tree.num_buckets)


def _slices(q: int):
    for s in range(0, q, _MAX_Q):
        yield s, min(s + _MAX_Q, q)


def _empty(with_ids: bool, with_dists: bool) -> VerbResult:
    counts = np.zeros(0, np.int64)
    if not with_ids:
        return VerbResult(counts, None, None, False, 0)
    d2 = np.zeros((0, 1), np.float32) if with_dists else None
    return VerbResult(counts, d2, np.zeros((0, 1), np.int32), False, 0)


def radius_search(
    tree: MortonTree,
    queries,
    r,
    *,
    visit_cap: int | None = None,
    with_ids: bool = True,
    cap: int | None = None,
    max_hits: int | None = None,
) -> VerbResult:
    """All points within Euclidean distance ``r`` of each query, on the
    tree's device (inclusive: d2 <= r^2 in f32, the same arithmetic the
    oracle uses).

    ``queries`` is a host array (or tensor) [Q, D]; ``r`` a host scalar
    or per-query [Q] array. ``with_ids=False`` is the count verb:
    per-query cardinalities only, no id buffers anywhere. ``cap`` and
    ``max_hits`` set the starting capacities (both double on overflow).
    ``visit_cap`` truncates each tile's lb-ascending candidate list; the
    answer is then a flagged lower bound (``truncated``). Zero queries
    answer the oracle's empty result.
    """
    queries = _host_rows(queries)
    Q, D = queries.shape
    if Q == 0:
        return _empty(with_ids, True)
    # kdt-lint: disable=KDT201 verb API boundary: r is a host scalar or per-query host list
    r = np.broadcast_to(np.asarray(r, dtype=np.float32), (Q,))
    r2 = (r * r).astype(np.float32)
    parts = [
        _radius_slice(tree, queries[s:e], r2[s:e], visit_cap, with_ids, cap,
                      max_hits)
        for s, e in _slices(Q)
    ]
    return _concat_results(parts, with_dists=with_ids)


def _start_caps(tree, cap, max_hits):
    c = min(DEFAULT_CAP if cap is None else _pow2_ceil(int(cap)),
            _cap_ceiling(tree))
    m = _pow2_ceil(DEFAULT_HITS if max_hits is None else int(max_hits))
    return c, m


def _radius_slice(tree, queries, r2, visit_cap, with_ids, cap,
                  max_hits) -> VerbResult:
    Q, D = queries.shape
    dev = tree.device
    t = _tile_for(Q)
    qpad = (-Q) % t
    sq, order = _sort_queries(torch.as_tensor(queries, device=dev),
                              default_bits(D), qpad)
    # padding duplicates the last query; a NEGATIVE r2 makes those rows
    # hit nothing (d2 <= r2 < 0 is impossible)
    r2p = np.concatenate([r2, np.full(qpad, -1.0, np.float32)])
    order_h = order.cpu().numpy()
    r2s = torch.as_tensor(r2p[order_h], device=dev).reshape(-1, t)
    tq = sq.reshape(-1, t, D)

    c, m = _start_caps(tree, cap, max_hits)
    retries = 0
    while True:
        # under a visit cap the frontier's beam is what gets truncated:
        # no overflow retry (the reference's rule)
        can_grow = visit_cap is None and c < _cap_ceiling(tree)
        counts, bd, bi, ovf, truncated = _radius_tiles(
            tree, tq, r2s, c, m if with_ids else 0, visit_cap, not with_ids,
            can_grow)
        if ovf and can_grow:
            c = min(c * 2, _cap_ceiling(tree))
            retries += 1
            continue
        counts_h = counts.cpu().numpy().reshape(-1)
        if with_ids and int(counts_h.max(initial=0)) > m:
            # counts are exact regardless of m, so ONE retry sized to
            # the measured maximum always suffices
            m = _pow2_ceil(int(counts_h.max()))
            retries += 1
            continue
        break
    counts_out = np.zeros(Q + qpad, np.int64)
    counts_out[order_h] = counts_h
    if not with_ids:
        return VerbResult(counts_out[:Q], None, None, truncated, retries)
    d2s = bd.cpu().numpy().reshape(len(order_h), -1)
    idss = bi.cpu().numpy().reshape(len(order_h), -1)
    d2_out = np.empty_like(d2s)
    ids_out = np.empty_like(idss)
    d2_out[order_h] = d2s
    ids_out[order_h] = idss
    d2c, idc = canonical_radius_rows(d2_out[:Q], ids_out[:Q])
    return VerbResult(counts_out[:Q], d2c, idc, truncated, retries)


def range_search(
    tree: MortonTree,
    box_lo,
    box_hi,
    *,
    visit_cap: int | None = None,
    with_ids: bool = True,
    cap: int | None = None,
    max_hits: int | None = None,
) -> VerbResult:
    """All points inside each axis-aligned box [box_lo, box_hi]
    (inclusive on both faces), on the tree's device. Boxes where lo > hi
    on any axis are legitimately empty. Returns ids ascending per query
    (containment has no distances); ``with_ids=False`` is the count
    form. ``visit_cap`` as in :func:`radius_search`."""
    box_lo = _host_rows(box_lo)
    box_hi = _host_rows(box_hi)
    Q, D = box_lo.shape
    if Q == 0:
        return _empty(with_ids, False)
    parts = [
        _range_slice(tree, box_lo[s:e], box_hi[s:e], visit_cap, with_ids,
                     cap, max_hits)
        for s, e in _slices(Q)
    ]
    return _concat_results(parts, with_dists=False)


def _range_slice(tree, box_lo, box_hi, visit_cap, with_ids, cap,
                 max_hits) -> VerbResult:
    Q, D = box_lo.shape
    dev = tree.device
    t = _tile_for(Q)
    qpad = (-Q) % t
    if qpad:
        # pad with the EMPTY box: +inf lo / -inf hi contains nothing and
        # cannot widen the tile's union box
        box_lo = np.concatenate(
            [box_lo, np.full((qpad, D), np.inf, np.float32)])
        box_hi = np.concatenate(
            [box_hi, np.full((qpad, D), -np.inf, np.float32)])
    qlo = torch.as_tensor(box_lo, device=dev).reshape(-1, t, D)
    qhi = torch.as_tensor(box_hi, device=dev).reshape(-1, t, D)

    c, m = _start_caps(tree, cap, max_hits)
    retries = 0
    while True:
        can_grow = visit_cap is None and c < _cap_ceiling(tree)
        counts, bi, ovf, truncated = _range_tiles(
            tree, qlo, qhi, c, m if with_ids else 0, visit_cap, not with_ids,
            can_grow)
        if ovf and can_grow:
            c = min(c * 2, _cap_ceiling(tree))
            retries += 1
            continue
        counts_h = counts.cpu().numpy().reshape(-1)
        if with_ids and int(counts_h.max(initial=0)) > m:
            m = _pow2_ceil(int(counts_h.max()))
            retries += 1
            continue
        break
    counts_out = counts_h[:Q].astype(np.int64)
    if not with_ids:
        return VerbResult(counts_out, None, None, truncated, retries)
    ids = bi.cpu().numpy().reshape(len(counts_h), -1)[:Q]
    return VerbResult(counts_out, None, canonical_range_rows(ids), truncated,
                      retries)


def _concat_results(parts, with_dists: bool) -> VerbResult:
    if len(parts) == 1:
        return parts[0]
    counts = np.concatenate([p.counts for p in parts])
    truncated = any(p.truncated for p in parts)
    retries = sum(p.retries for p in parts)
    if parts[0].ids is None:
        return VerbResult(counts, None, None, truncated, retries)
    m = max(p.ids.shape[1] for p in parts)

    def widen(a, fill, dtype):
        return np.concatenate([
            np.concatenate([x, np.full((x.shape[0], m - x.shape[1]),
                                       fill, dtype)], axis=1)
            for x in a
        ])

    ids = widen([p.ids for p in parts], -1, np.int32)
    d2 = (widen([p.d2 for p in parts], np.inf, np.float32)
          if with_dists else None)
    return VerbResult(counts, d2, ids, truncated, retries)
