"""Exact host-side (distance, id) top-k merge for the mutable overlay.

A verbatim copy of ``kdtree_tpu/mutable/merge.py`` (numpy only). The
merge contract is the one the reference's SPMD forest query and serving
router rely on too: per query row, order the union of candidate
(distance, id) pairs by the stable two-key sort and keep the k best. Each
candidate source contributes its own *exact* top-k, so the merged top-k
is the exact top-k of the union — the algebra that makes an LSM-style
delta buffer answer-preserving: main-tree hits, delta-buffer hits, and
masked (tombstoned) slots all meet here, and the result is byte-identical
to a rebuild-from-scratch index over the surviving points.

Padding follows the engines' convention: distance ``+inf`` with id
``-1``. Those pairs sort after every real candidate, so they appear in a
merged row only when the row has fewer than k real candidates at all —
the same contract a freshly built undersized index has.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def in_sorted(sorted_ids: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Vectorized membership test: which entries of ``ids`` appear in the
    ascending ``sorted_ids`` array. Padding ids (-1) never match — the
    mask sets only carry real (>= 0) ids."""
    if sorted_ids.size == 0:
        return np.zeros(ids.shape, dtype=bool)
    idx = np.searchsorted(sorted_ids, ids)
    idx_c = np.minimum(idx, sorted_ids.size - 1)
    return (idx < sorted_ids.size) & (sorted_ids[idx_c] == ids)


def merge_rows(
    d2: np.ndarray, ids: np.ndarray, k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (distance, id) top-k over concatenated candidate columns.

    ``d2`` f32[Q, C] and ``ids`` int[Q, C] hold every candidate (already
    each source's exact top-k); returns (f32[Q, k], int[Q, k]) in the
    stable (distance, id) order every exact path in this repo uses. Fully
    vectorized: one ``np.lexsort`` with the row index as the primary key,
    so a 1024-row batch merges in one host call, no Python loop."""
    q, c = d2.shape
    k = min(int(k), c)
    rows = np.repeat(np.arange(q), c)
    # float64 view of the f32 distances is exact, and np.lexsort's last
    # key is the primary: rows, then distance, then id — the stable
    # two-key tie-break, applied row-independently in one call
    order = np.lexsort((ids.ravel(), d2.ravel().astype(np.float64), rows))
    d2_sorted = d2.ravel()[order].reshape(q, c)
    ids_sorted = ids.ravel()[order].reshape(q, c)
    return d2_sorted[:, :k], ids_sorted[:, :k]
