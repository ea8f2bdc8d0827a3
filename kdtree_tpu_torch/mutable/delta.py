"""The delta buffer: the L0 of the LSM-shaped mutable index.

Upserts land here as flat rows — the same padded-flat-storage shape the
serving degradation path already queries exactly (+inf coordinate rows,
-1 ids, ``serve/engine.ServeEngine.fallback_knn``), so the brute-force
path answers over the buffer with no new device code. Capacity is a
power of two and doubles on overflow, so the device sees a handful of
array shapes instead of one shape per write.

The buffer itself is NOT thread-safe — the owning
:class:`~kdtree_tpu_torch.mutable.engine.MutableEngine` serializes writers and
hands queries an immutable snapshot: ``view()`` returns a cached
(device points, host id copy) pair that is regenerated by the *writer*
after each mutation, never by a query, so the query path does a pure
reference read and no transfer.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

import torch

from kdtree_tpu_torch import resolve_device
from kdtree_tpu_torch.serve.engine import _pow2_ceil

MIN_CAPACITY = 64  # also the floor that keeps capacity >= any sane k


class DeltaBuffer:
    """Flat exact storage for upserted points: f32[cap, D] coordinates
    (+inf padding) and int32[cap] local ids (-1 padding), plus an
    id -> row index for O(1) update/delete. Dropped rows become padding
    in place (slots are not reused — the next epoch compaction reclaims
    them), so a query snapshot taken before a drop stays valid."""

    def __init__(self, dim: int, min_capacity: int = MIN_CAPACITY,
                 device=None) -> None:
        if dim < 1:
            raise ValueError(f"dim must be >= 1, got {dim}")
        cap = _pow2_ceil(max(int(min_capacity), MIN_CAPACITY))
        self.dim = int(dim)
        self.device = resolve_device(device)
        self._pts = np.full((cap, dim), np.inf, dtype=np.float32)
        self._gid = np.full(cap, -1, dtype=np.int32)
        self._index: Dict[int, int] = {}
        self._used = 0  # next append slot (monotone; holes stay padding)
        self._view: Optional[Tuple[object, np.ndarray]] = None

    @property
    def capacity(self) -> int:
        return self._pts.shape[0]

    @property
    def rows(self) -> int:
        """Live (non-dropped) upserted rows."""
        return len(self._index)

    @property
    def holes(self) -> int:
        """Dropped (padding) slots below the append cursor. Slots are
        never reused — only an epoch compaction reclaims them — so
        holes MUST count toward the rebuild backlog: an
        upsert-then-delete churn workload keeps ``rows`` near zero
        while the buffer doubles forever otherwise."""
        return self._used - len(self._index)

    def __contains__(self, gid: int) -> bool:
        return int(gid) in self._index

    def get(self, gid: int) -> Optional[np.ndarray]:
        row = self._index.get(int(gid))
        return None if row is None else self._pts[row].copy()

    def _grow(self) -> None:
        cap = self.capacity * 2
        pts = np.full((cap, self.dim), np.inf, dtype=np.float32)
        gid = np.full(cap, -1, dtype=np.int32)
        pts[: self._pts.shape[0]] = self._pts
        gid[: self._gid.shape[0]] = self._gid
        self._pts, self._gid = pts, gid

    def put(self, gid: int, point: np.ndarray) -> bool:
        """Insert or update one point; True when ``gid`` was new to the
        buffer. Updates overwrite in place — the authoritative copy of an
        id lives in exactly one slot."""
        gid = int(gid)
        if gid < 0:
            raise ValueError(f"point id must be >= 0, got {gid}")
        row = self._index.get(gid)
        fresh = row is None
        if fresh:
            if self._used >= self.capacity:
                self._grow()
            row = self._used
            self._used += 1
            self._index[gid] = row
            self._gid[row] = gid
        # plain slot assignment (numpy coerces the host row to f32) —
        # `point` is host data end to end, no device value in sight
        self._pts[row, :] = point
        self._view = None
        return fresh

    def drop(self, gid: int) -> bool:
        """Remove ``gid`` if present (slot becomes padding); True when a
        row was actually dropped."""
        row = self._index.pop(int(gid), None)
        if row is None:
            return False
        self._pts[row] = np.inf
        self._gid[row] = -1
        self._view = None
        return True

    def refresh(self) -> None:
        """(Writer-side) regenerate the cached query view after a batch
        of mutations: one device transfer of the padded buffer plus one
        host id copy. Queries only ever *read* the cached pair."""
        # transfer a COPY: torch.from_numpy shares the host memory (and
        # so does .to() onto the CPU), and a device view aliasing the
        # master buffer would mutate under a query snapshot's feet
        self._view = (torch.from_numpy(self._pts.copy()).to(self.device),
                      self._gid.copy())

    def view(self):
        """The immutable query snapshot: (device f32[cap, D], host
        int32[cap] copy). Writers call :meth:`refresh` after mutating;
        a stale call here (no mutations yet) builds the initial view."""
        if self._view is None:
            self.refresh()
        return self._view

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of the live rows — (f32[m, D], int32[m]) — the
        epoch compaction's input."""
        live = self._gid >= 0
        return self._pts[live].copy(), self._gid[live].copy()
