"""kdtree_tpu_torch.tuning — the persistent plan store.

The part of ``kdtree_tpu/tuning`` the snapshots need
(:mod:`~kdtree_tpu_torch.tuning.store`): profiles keyed by a quantized
problem signature, under the port's own cache namespace. The lookup in
``plan_tiled``, the per-run feedback and the ``tune`` sweep are ROADMAP
queue 1 item 13.
"""

from __future__ import annotations

from kdtree_tpu_torch.tuning.store import (
    ENV_CACHE_DIR,
    PlanSignature,
    PlanStore,
    default_cache_dir,
    default_store,
    make_signature,
)

__all__ = [
    "ENV_CACHE_DIR",
    "PlanSignature",
    "PlanStore",
    "default_cache_dir",
    "default_store",
    "make_signature",
]
