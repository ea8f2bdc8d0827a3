"""The serving degradation ladder: gears between exact and the cliff.

The port of ``kdtree_tpu/approx/ladder.py``:

    exact -> approx(0.99) -> approx(0.9) -> brute-force-deadline

The controller reads the watched SLOs' states on every history-sampler
tick, steps DOWN one gear after ``down_after`` consecutive PAGE ticks,
and climbs UP one gear after ``up_after`` consecutive all-OK ticks —
hysteresis on both edges, so a flapping burn cannot saw the gear. Every
shift is flight-recorded (``ladder.shift``), counted
(``kdtree_recall_ladder_transitions_total``) and exported as the
``kdtree_recall_gear`` gauge, with the gear's recall estimate on
``kdtree_recall_estimate`` — the gauge the served-recall SLO watches.

The last gear, ``brute-deadline``, answers every request through the
exact brute-force path (flagged degraded), so recall there is 1.0 again.
Tests drive the ladder deterministically with ``tick(burning=True)`` or a
``batch=latency`` fault.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.obs import flight
from kdtree_tpu_torch.obs.slo import PAGE
from kdtree_tpu_torch.utils import locks


class GearSpec(NamedTuple):
    """One ladder gear. ``recall_target`` None = exact candidate set;
    ``brute`` routes dispatch through the exact brute-force fallback.
    ``recall_estimate`` is the gauge value while the gear is engaged —
    the gear's promise, replaced by the measured calibration value when
    one exists (``DegradationLadder.engaged``)."""

    name: str
    recall_target: Optional[float]
    recall_estimate: float
    brute: bool = False


GEARS: Tuple[GearSpec, ...] = (
    GearSpec("exact", None, 1.0),
    GearSpec("approx-0.99", 0.99, 0.99),
    GearSpec("approx-0.9", 0.9, 0.9),
    GearSpec("brute-deadline", None, 1.0, brute=True),
)

# the burn signals that mean "shed or slow": the two failure shapes a
# recall gear can relieve
DEFAULT_WATCH = ("request-p99-latency", "shed-rate")
DEFAULT_DOWN_AFTER = 2   # consecutive PAGE ticks before a downshift
DEFAULT_UP_AFTER = 5     # consecutive OK ticks before an upshift


def gear_token(spec: GearSpec) -> Optional[str]:
    """The wire token of a response's ``gear`` field for this gear: None
    for exact (no field), ``approx:<target>`` or ``brute-deadline``
    otherwise."""
    if spec.brute:
        return "brute-deadline"
    if spec.recall_target is not None:
        return f"approx:{spec.recall_target:g}"
    return None


class DegradationLadder:
    """The gear state machine. ``tick()`` runs on the history-sampler tick
    (after the SLO engine evaluated); the readers (``gear()``, ``spec()``)
    are cheap — the batcher consults them per batch."""

    def __init__(
        self,
        slo_engine=None,
        gears: Sequence[GearSpec] = GEARS,
        watch: Sequence[str] = DEFAULT_WATCH,
        down_after: int = DEFAULT_DOWN_AFTER,
        up_after: int = DEFAULT_UP_AFTER,
        enabled: bool = True,
    ) -> None:
        if not gears:
            raise ValueError("ladder needs at least one gear")
        self.slo_engine = slo_engine
        self.gears = tuple(gears)
        self.watch = tuple(watch)
        self.down_after = max(int(down_after), 1)
        self.up_after = max(int(up_after), 1)
        self.enabled = bool(enabled)
        self._lock = locks.make_lock("approx.ladder")
        self._gear = 0
        self._page_streak = 0
        self._ok_streak = 0
        reg = obs.get_registry()
        self._g_gear = reg.gauge("kdtree_recall_gear")
        self._g_estimate = reg.gauge("kdtree_recall_estimate")
        self._g_gear.set(0)
        self._g_estimate.set(self.gears[0].recall_estimate)

    def gear(self) -> int:
        with self._lock:
            return self._gear

    def spec(self) -> GearSpec:
        with self._lock:
            return self.gears[self._gear]

    def engaged(self, recall_estimate: Optional[float] = None) -> None:
        """Report the recall the CURRENT gear actually serves — the
        batcher calls this for ladder-forced batches only, with the
        measured calibration value when the engine resolved one."""
        if recall_estimate is not None and self.enabled:
            self._g_estimate.set(float(recall_estimate))

    def _burning(self) -> bool:
        if self.slo_engine is None:
            return False
        states = self.slo_engine.states()
        return any(states.get(name, 0) == PAGE for name in self.watch)

    def tick(self, burning: Optional[bool] = None) -> int:
        """One controller step; returns the (possibly new) gear index.
        ``burning`` overrides the SLO read for deterministic tests. Never
        raises: it runs on the sampler thread of a live server."""
        if not self.enabled:
            return 0
        try:
            burn = self._burning() if burning is None else bool(burning)
        except Exception:
            return self.gear()
        shift = None
        with self._lock:
            if burn:
                self._page_streak += 1
                self._ok_streak = 0
                if (self._page_streak >= self.down_after
                        and self._gear < len(self.gears) - 1):
                    shift = (self._gear, self._gear + 1, "burn")
                    self._gear += 1
                    self._page_streak = 0
            else:
                self._ok_streak += 1
                self._page_streak = 0
                if self._ok_streak >= self.up_after and self._gear > 0:
                    # one gear per quiet period: jumping straight back to
                    # exact would re-offer the full load that caused it
                    shift = (self._gear, self._gear - 1, "recovered")
                    self._gear -= 1
                    self._ok_streak = 0
            gear = self._gear
        if shift is not None:
            self._report(*shift)
        return gear

    def _report(self, old: int, new: int, reason: str) -> None:
        old_spec, new_spec = self.gears[old], self.gears[new]
        self._g_gear.set(new)
        self._g_estimate.set(new_spec.recall_estimate)
        obs.get_registry().counter(
            "kdtree_recall_ladder_transitions_total",
            labels={"to": new_spec.name},
        ).inc()
        flight.record(
            "ladder.shift", previous=old_spec.name, to=new_spec.name,
            reason=reason, gear=new,
        )
        if new > old:
            # a downshift is an incident: the ring dump carries the burn
            # that caused it (rate-limited per reason)
            flight.auto_dump("ladder-downshift")
