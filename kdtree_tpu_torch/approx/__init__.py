"""kdtree_tpu_torch.approx — approximate k-NN with a measured recall dial.

The port of ``kdtree_tpu/approx``. The rest of the package is exact by
contract; this is the deliberate exception, and every approximation here
is measured against the exact engine:

- :mod:`~kdtree_tpu_torch.approx.search` — bounded-visit search: a cap on
  the tiled engine's lb-ascending candidate ranking, so recall is
  monotone in the cap and the full cap is the exact engine;
  ``resolve_visit_cap`` turns a ``recall_target`` into a cap;
- :mod:`~kdtree_tpu_torch.approx.recall` — the recall harness (``recall``
  on the CLI): sweep caps against the exact engine and persist the
  recall_target -> visit_cap calibration into the plan store;
- :mod:`~kdtree_tpu_torch.approx.ladder` — the serving degradation
  ladder, exact -> approx(0.99) -> approx(0.9) -> brute-force-deadline.

A request without ``recall_target`` runs the exact path, unchanged.
"""

from __future__ import annotations

from kdtree_tpu_torch.approx.ladder import (
    GEARS,
    DegradationLadder,
    GearSpec,
    gear_token,
)
from kdtree_tpu_torch.approx.recall import (
    RECALL_VERSION,
    calibrate_caps,
    recall_at_k,
    sweep_recall,
)
from kdtree_tpu_torch.approx.search import (
    DEFAULT_TARGETS,
    RECALL_TARGET_ERROR,
    morton_knn_approx,
    parse_recall_target,
    resolve_visit_cap,
)

__all__ = [
    "DEFAULT_TARGETS",
    "RECALL_TARGET_ERROR",
    "parse_recall_target",
    "DegradationLadder",
    "GEARS",
    "GearSpec",
    "RECALL_VERSION",
    "calibrate_caps",
    "gear_token",
    "morton_knn_approx",
    "recall_at_k",
    "resolve_visit_cap",
    "sweep_recall",
]
