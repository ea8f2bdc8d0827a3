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
"""

from __future__ import annotations

from typing import Optional

from kdtree_tpu_torch.tuning.store import PlanSignature, PlanStore, default_store


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
