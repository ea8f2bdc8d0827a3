"""kdtree_tpu_torch.tuning — the closed auto-tune loop for the tiled query.

The port of ``kdtree_tpu/tuning``:

- :mod:`~kdtree_tpu_torch.tuning.store` — persistent plan profiles keyed by
  a quantized problem signature, under the port's own cache namespace;
- :mod:`~kdtree_tpu_torch.tuning.feedback` — each auto-planned run records
  its settled cap and retry count back;
- :mod:`~kdtree_tpu_torch.tuning.tuner` — the ``tune`` sweep that times
  (tile, cmax) and then (v, tb) candidates and persists the winner.

``plan_tiled`` (:mod:`kdtree_tpu_torch.ops.tile_query`) reads the store
through :func:`lookup` on every automatic plan: a hit is a ``"warm"`` plan,
which skips the first batch's cap-settling probe. Profiles are advisory:
the overflow retry still guards exactness.
"""

from __future__ import annotations

from typing import Optional

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.tuning.feedback import PlanFeedback, feedback_for, occupancy_p90_hint
from kdtree_tpu_torch.tuning.store import (
    ENV_CACHE_DIR,
    PlanSignature,
    PlanStore,
    default_cache_dir,
    default_store,
    make_signature,
)


def lookup(
    sig: PlanSignature, use_kernel: Optional[bool] = None,
    store: Optional[PlanStore] = None,
) -> Optional[dict]:
    """The stored launch profile for ``sig``, or None (store disabled,
    miss, corrupt file). A profile recorded for the other scan engine
    (``use_kernel`` disagrees with this run's) reads as a miss: tiles tuned
    for the CUDA kernel are wrong for the plain scan and the other way
    round. CPU and CUDA profiles never mix, since the signature's backend
    is the device type. Hits and misses count in
    ``kdtree_plan_cache_{hits,misses}_total``."""
    store = store if store is not None else default_store()
    if not store.enabled:
        return None
    prof = store.get(sig)
    if prof is not None and use_kernel is not None and \
            "use_kernel" in prof and bool(prof["use_kernel"]) != use_kernel:
        prof = None
    reg = obs.get_registry()
    if prof is None:
        reg.counter("kdtree_plan_cache_misses_total").inc()
    else:
        reg.counter("kdtree_plan_cache_hits_total").inc()
    return prof


def profile_for(
    sig: PlanSignature, store: Optional[PlanStore] = None,
) -> Optional[dict]:
    """The raw (version-checked, launch-knob-free) profile for ``sig`` —
    the read path of advisory payload such as the recall calibration
    (:mod:`kdtree_tpu_torch.approx`), which may live in a profile no tuner
    has settled launch knobs into. It does not touch the hit/miss
    counters, which measure the warm-plan ratio."""
    store = store if store is not None else default_store()
    return store.get_raw(sig)


__all__ = [
    "ENV_CACHE_DIR",
    "PlanFeedback",
    "PlanSignature",
    "PlanStore",
    "default_cache_dir",
    "default_store",
    "feedback_for",
    "lookup",
    "make_signature",
    "occupancy_p90_hint",
    "profile_for",
]
