"""kdtree_tpu_torch.mutable — the write path: an LSM-shaped mutable index.

The port of ``kdtree_tpu/mutable``: answers stay **exact at every
moment**, byte-identical to a rebuild-from-scratch index over the
surviving points.

- :mod:`~kdtree_tpu_torch.mutable.delta` — the L0: a small brute-force
  buffer of upserted rows in the padded flat-storage shape the serving
  degradation path already queries (+inf coords, -1 ids);
- :mod:`~kdtree_tpu_torch.mutable.merge` — the exact (distance, id) host
  merge;
- :mod:`~kdtree_tpu_torch.mutable.engine` — :class:`MutableEngine`: the
  write-capable facade (upsert / delete / overlay query / masked
  degradation path) and the background epoch rebuilder that compacts
  main+delta into a fresh Morton tree and swaps it in atomically between
  batches (``kdtree_epoch``).

Serving wires it through ``POST /v1/upsert`` / ``POST /v1/delete``.
"""

from __future__ import annotations

from kdtree_tpu_torch.mutable.delta import DeltaBuffer
from kdtree_tpu_torch.mutable.engine import (
    DEFAULT_MAX_DELTA_FRAC,
    DEFAULT_MAX_DELTA_ROWS,
    MutableEngine,
)
from kdtree_tpu_torch.mutable.merge import in_sorted, merge_rows

__all__ = [
    "DEFAULT_MAX_DELTA_FRAC",
    "DEFAULT_MAX_DELTA_ROWS",
    "DeltaBuffer",
    "MutableEngine",
    "in_sorted",
    "merge_rows",
]
