"""Feedback recorder: write each tiled run's settled plan back into the
plan store.

The port of ``kdtree_tpu/tuning/feedback.py``'s loop-closing tier: the
settled ``cmax`` and the run's overflow-retry count are host-side facts
once ``drive_batches`` has read every overflow flag, so
:meth:`PlanFeedback.settled` records them at once — one small JSON write
per query call, and only when the profile changed
(:meth:`~kdtree_tpu_torch.tuning.store.PlanStore.record` suppresses no-op
rewrites, so a steady serving loop settles to zero writes). The recorded
profile is what ``plan_tiled`` reads on the next run of the same
signature.

:func:`occupancy_p90_hint` is the read side the forest's exchange sizing
consults (``parallel/global_morton.py::_resolve_slack``): the largest
``occupancy_p90`` that a profile of a matching build shape records.
"""

from __future__ import annotations

from typing import Optional

from kdtree_tpu_torch.tuning.store import (
    PlanSignature,
    PlanStore,
    _pow2_ceil,
    default_store,
)


def occupancy_p90_hint(
    dim: int, n: int, bucket_cap: int, devices: int,
    backend: Optional[str] = None, store: Optional[PlanStore] = None,
) -> Optional[float]:
    """The largest ``occupancy_p90`` that a profile of this build shape
    records, or None. Profiles are keyed by query signatures, so the match
    is on the build's fields: the same dim, bucket capacity and backend
    (the port device's type), ``devices`` equal to the forest's shard
    count or 1, and a quantized row bucket between half a shard's share
    and the build's total. The maximum wins: overestimating occupancy only
    buys exchange headroom. The port of
    ``kdtree_tpu/tuning/feedback.py::occupancy_p90_hint``."""
    store = store if store is not None else default_store()
    if not store.enabled:
        return None
    if backend is None:
        from kdtree_tpu_torch import resolve_device

        backend = resolve_device(None).type
    n_hi = _pow2_ceil(max(int(n), 1))
    n_lo = max(1, _pow2_ceil(max(int(n) // max(int(devices), 1), 1)) // 2)
    best: Optional[float] = None
    for sig, prof in store.scan():
        occ = prof.get("occupancy_p90")
        if not isinstance(occ, (int, float)) or isinstance(occ, bool) \
                or occ <= 0:
            continue
        if sig.get("dim") != int(dim) or \
                sig.get("bucket_size") != int(bucket_cap) or \
                sig.get("backend") != str(backend):
            continue
        if sig.get("devices") not in (1, int(devices)):
            continue
        nb = sig.get("n_bucket")
        if not isinstance(nb, int) or not (n_lo <= nb <= n_hi):
            continue
        best = occ if best is None else max(best, occ)
    return best


class PlanFeedback:
    """One tiled run's report-back handle; made by :func:`feedback_for`
    and driven by ``drive_batches`` once the cap has settled."""

    def __init__(self, sig: PlanSignature, plan, store: PlanStore) -> None:
        self.sig = sig
        self.plan = plan
        self.store = store

    def settled(self, cmax: int, retries: int) -> None:
        """Record the run's settled launch configuration (called by
        ``drive_batches`` after every batch has a clean overflow flag)."""
        self.store.record(
            self.sig,
            tile=int(self.plan.tile),
            cmax=int(cmax),
            seeds=int(self.plan.seeds),
            use_kernel=bool(self.plan.use_kernel),
            overflow_retries=int(retries),
            source="feedback",
        )

    def record_stats(self, prune_rate=None) -> None:
        """Record this run's tile prune rate (called at report time by the
        batch driver's deferred candidate flush; 0.0 is recorded too)."""
        if prune_rate is not None:
            self.store.record(self.sig, prune_rate=round(float(prune_rate), 6))


def feedback_for(
    plan, store: Optional[PlanStore] = None,
) -> Optional[PlanFeedback]:
    """The feedback handle for an auto-planned tiled run, or None when
    nothing should be recorded: the store is disabled, or the caller
    forced the plan's knobs (``source == "explicit"`` — a one-off override
    recorded would steer every later auto run). Records under
    ``plan.sig``, the signature ``plan_tiled``'s lookup read."""
    if getattr(plan, "source", "explicit") == "explicit":
        return None
    sig = getattr(plan, "sig", None)
    if sig is None:
        return None
    store = store if store is not None else default_store()
    if not store.enabled:
        return None
    return PlanFeedback(sig, plan, store)
