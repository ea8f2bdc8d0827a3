"""Declarative SLOs with Google-SRE-style multi-window burn-rate alerts.

An SLO here is a named objective over the metric history
(:mod:`kdtree_tpu_torch.obs.history`): "99% of requests complete within
250 ms", "99.9% answered without error". Each spec carries an error
*budget* (``1 - target``) and two window tiers; the engine evaluates the
**burn rate** — the fraction of budget consumed per unit of budget, i.e.
``bad_fraction / budget`` — over each tier's long AND short window:

- **fast** tier (default 60 s long / 10 s short, burn > 10×): both
  windows over threshold → **PAGE**. The short window makes the alert
  reset quickly once the burn stops (the classic multi-window trick:
  the long window alone would keep paging for its whole length).
- **slow** tier (default 600 s / 60 s, burn > 2×): both over → **WARN**.

State is exported as ``kdtree_slo_state{slo=...}`` (0 OK / 1 WARN /
2 PAGE) and ``kdtree_slo_burn_rate{slo,window}`` gauges on every
evaluation — a scrape sees the verdict, not just the raw series — and a
transition *into* PAGE triggers a rate-limited flight-recorder dump
whose filename names the burning SLO (``flight-slo-<name>.json``, with
the history ring dumped alongside it), so the incident timeline is on
disk before anyone asks.

Spec kinds (all evaluated from history windows, no device work):

- ``ratio``: bad/total counter prefixes (error rate, shed rate,
  degraded-answer fraction);
- ``latency``: fraction of histogram observations above ``threshold``
  seconds (p-quantile objectives in ratio form — "1% may exceed 250 ms"
  IS the p99 objective, stated so burn-rate math applies);
- ``gauge_min``: fraction of in-window samples where a gauge sits below
  ``threshold`` (device ``busy_frac`` floor).

No data (no samples, series absent, zero traffic) evaluates to OK with
``data: false`` — an idle server is not in violation. Spec *names* are
metric-label identity: they must be static strings from a bounded set
(docs/STATIC_ANALYSIS.md).

The port of ``kdtree_tpu/obs/slo.py``'s serving specs and engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kdtree_tpu_torch.utils import locks
from kdtree_tpu_torch.obs import history as hist_mod
from kdtree_tpu_torch.obs.registry import get_registry

OK, WARN, PAGE = 0, 1, 2
STATE_NAMES = {OK: "OK", WARN: "WARN", PAGE: "PAGE"}

# the p99 objective's latency bound: a _LATENCY_BUCKETS bound on purpose,
# so frac_le needs no conservative bucket rounding at the default
DEFAULT_P99_THRESHOLD_S = 0.25
# device busy_frac floor (docs/TUNING.md "Raw speed": tuned steady state
# measures >90%; below half the device is mostly waiting on the host)
DEFAULT_BUSY_FLOOR = 0.5


@dataclass(frozen=True)
class BurnWindow:
    """One alerting tier: fire when burn > ``max_burn`` over BOTH the
    long and the short window."""

    long_s: float
    short_s: float
    max_burn: float


# serving-scale default windows: minutes, not SRE-handbook hours — this
# process's history ring holds ~8.5 min by default, and a k-NN replica's
# operator wants pages within a minute of a sustained burn, not an hour
DEFAULT_FAST = BurnWindow(long_s=60.0, short_s=10.0, max_burn=10.0)
DEFAULT_SLOW = BurnWindow(long_s=600.0, short_s=60.0, max_burn=2.0)


@dataclass(frozen=True)
class SloSpec:
    """One declarative objective. ``name`` feeds ``kdtree_slo_*`` gauge
    labels — static strings only."""

    name: str
    objective: str
    target: float
    kind: str  # "ratio" | "latency" | "gauge_min"
    bad: Tuple[str, ...] = ()   # ratio: bad-counter prefixes (summed)
    total: str = ""             # ratio: total-counter prefix
    hist: str = ""              # latency: histogram series prefix
    gauge: str = ""             # gauge_min: gauge key
    threshold: float = 0.0      # latency: seconds bound; gauge_min: floor
    fast: BurnWindow = field(default_factory=lambda: DEFAULT_FAST)
    slow: BurnWindow = field(default_factory=lambda: DEFAULT_SLOW)

    @property
    def budget(self) -> float:
        return max(1.0 - float(self.target), 1e-9)


def bad_fraction(
    spec: SloSpec,
    history: hist_mod.MetricHistory,
    window_s: float,
    now: Optional[float] = None,
) -> Optional[float]:
    """The fraction of the window's events (or samples) violating the
    objective; None when the window has no data — an SLO with no traffic
    is not burning."""
    if spec.kind == "ratio":
        total = history.counter_delta(spec.total, window_s, now)
        if not total:
            return None
        bad = 0.0
        for prefix in spec.bad:
            bad += history.counter_delta(prefix, window_s, now) or 0.0
        return min(max(bad / total, 0.0), 1.0)
    if spec.kind == "latency":
        fr = history.frac_le(spec.hist, spec.threshold, window_s, now)
        if fr is None:
            return None
        le, total = fr
        if total <= 0:
            return None
        return min(max(1.0 - le / total, 0.0), 1.0)
    if spec.kind == "gauge_min":
        vals = history.gauge_values(spec.gauge, window_s, now)
        if not vals:
            return None
        return sum(1 for v in vals if v < spec.threshold) / len(vals)
    return None


def default_specs() -> List[SloSpec]:
    """The shipped serving SLOs (docs/OBSERVABILITY.md "SLOs & burn
    rates"). Names are a bounded enum by construction."""
    return [
        SloSpec(
            name="request-p99-latency",
            objective="99% of served requests complete within 250 ms "
                      "(total = queue + dispatch)",
            target=0.99,
            kind="latency",
            hist='kdtree_serve_request_seconds{phase="total"}',
            threshold=DEFAULT_P99_THRESHOLD_S,
        ),
        SloSpec(
            name="error-rate",
            objective="99.9% of requests answered without server error "
                      "or in-service timeout",
            target=0.999,
            kind="ratio",
            bad=(
                'kdtree_serve_requests_total{status="error"}',
                'kdtree_serve_requests_total{status="timeout"}',
            ),
            total="kdtree_serve_requests_total",
        ),
        SloSpec(
            name="shed-rate",
            objective="99% of requests admitted (not shed 429 at the "
                      "admission gate)",
            target=0.99,
            kind="ratio",
            bad=('kdtree_serve_requests_total{status="shed"}',),
            total="kdtree_serve_requests_total",
        ),
        SloSpec(
            name="degraded-answers",
            objective="95% of answers served by the tiled path (not the "
                      "brute-force degradation ladder)",
            target=0.95,
            kind="ratio",
            bad=('kdtree_serve_requests_total{status="degraded"}',),
            total="kdtree_serve_requests_total",
        ),
        SloSpec(
            name="device-busy",
            # the gauge is written each time a profiler capture is
            # analyzed (obs/timeline.py): a POST /debug/profile window,
            # the `profile` command, or the server's duty cycle every
            # KDTREE_TPU_PROFILE_DUTY_PERIOD_S when KDTREE_TPU_PROFILE_DUTY=1
            # (off by default in the port). Between captures the gauge is
            # missing data, never a burn.
            objective="captured device busy_frac stays above 0.5 (fed by "
                      "the profiling duty cycle; duty off => only manual "
                      "captures feed it and verdicts stay data:false "
                      "between them)",
            target=0.90,
            kind="gauge_min",
            gauge="kdtree_device_busy_frac",
            threshold=DEFAULT_BUSY_FLOOR,
            # burn thresholds sized to THIS spec's wide budget (0.1):
            # with the default fast tier (burn > 10x) the maximum
            # possible burn is 1.0/0.1 = 10 — PAGE would be
            # mathematically unreachable. >4x burn = >40% of samples
            # below the floor, a genuinely starved device.
            fast=BurnWindow(long_s=60.0, short_s=10.0, max_burn=4.0),
            slow=BurnWindow(long_s=600.0, short_s=60.0, max_burn=1.5),
        ),
    ]


def mutable_specs() -> List[SloSpec]:
    """The mutable-index SLO (armed alongside :func:`default_specs` by
    a serving process, which is always write-capable): the write backlog
    must not outrun the epoch rebuilder. ``kdtree_mutable_delta_headroom``
    is 1 - backlog/threshold — a healthy replica compacts long before it
    reaches 0, so sustained samples under the floor mean rebuilds are
    not keeping up with write traffic (docs/SERVING.md "Mutable
    index")."""
    return [
        SloSpec(
            name="delta-backlog",
            objective="delta+tombstone backlog stays under 90% of the "
                      "epoch-rebuild threshold (headroom >= 0.1)",
            target=0.90,
            kind="gauge_min",
            gauge="kdtree_mutable_delta_headroom",
            threshold=0.1,
            # same wide-budget burn sizing as device-busy: with budget
            # 0.1 the default >10x fast tier is mathematically
            # unreachable (max burn = 1.0/0.1 = 10)
            fast=BurnWindow(long_s=60.0, short_s=10.0, max_burn=4.0),
            slow=BurnWindow(long_s=600.0, short_s=60.0, max_burn=1.5),
        ),
    ]


def recall_specs() -> List[SloSpec]:
    """The recall-dial SLO (docs/SERVING.md "Degradation ladder"),
    armed alongside :func:`default_specs` by a serving process: the
    recall the serving gears actually deliver — the
    ``kdtree_recall_estimate`` gauge, which carries the MEASURED
    calibration value of the engaged gear, not its promise — must stay
    at or above the 0.9 floor. Sustained samples below it mean the
    ladder is parked past its deepest approximate gear, or a
    calibration is claiming a recall the harness never measured —
    either way the dial is lying to clients, which pages like any
    other burn."""
    return [
        SloSpec(
            name="served-recall",
            objective="served recall estimate (measured calibration of "
                      "the engaged gear) stays >= 0.9",
            target=0.90,
            kind="gauge_min",
            gauge="kdtree_recall_estimate",
            # just under the deepest shipped gear's 0.9 target: the
            # gear MEETING its promise must not burn, only a measured
            # shortfall below it
            threshold=0.895,
            # same wide-budget burn sizing as device-busy: with budget
            # 0.1 the default >10x fast tier is unreachable
            fast=BurnWindow(long_s=60.0, short_s=10.0, max_burn=4.0),
            slow=BurnWindow(long_s=600.0, short_s=60.0, max_burn=1.5),
        ),
        SloSpec(
            name="sampled-recall",
            objective="shadow-sampled MEASURED served recall (every "
                      "Nth approx batch re-answered exactly) stays "
                      ">= 0.9",
            target=0.90,
            kind="gauge_min",
            # the online recall sampler's gauge (serve --recall-sample,
            # docs/SERVING.md "Degradation ladder"): unlike
            # served-recall above this watches a measurement, not a
            # calibration promise — a calibration that lies shows up
            # HERE first. Registered lazily: no samples = no data = OK
            # (idle is not violating), exactly like the rebuild-impact
            # gauge.
            gauge="kdtree_recall_sampled",
            threshold=0.895,
            fast=BurnWindow(long_s=60.0, short_s=10.0, max_burn=4.0),
            slow=BurnWindow(long_s=600.0, short_s=60.0, max_burn=1.5),
        ),
    ]


def router_specs() -> List[SloSpec]:
    """The routing-process SLOs (``route`` arms these instead
    of :func:`default_specs` — a router has no batches or device, it has
    shard availability). Same burn-rate machinery, router families."""
    return [
        SloSpec(
            name="router-availability",
            objective="99.9% of routed requests answered (not 503 below "
                      "quorum)",
            target=0.999,
            kind="ratio",
            bad=('kdtree_router_requests_total{status="unavailable"}',),
            total="kdtree_router_requests_total",
        ),
        SloSpec(
            name="router-partial",
            objective="99% of routed requests merged over ALL shards "
                      "(not degraded to a partial quorum answer)",
            target=0.99,
            kind="ratio",
            bad=('kdtree_router_requests_total{status="partial"}',),
            total="kdtree_router_requests_total",
        ),
        SloSpec(
            name="router-p99-latency",
            objective="99% of routed requests complete within 1 s "
                      "(scatter to merged answer)",
            target=0.99,
            kind="latency",
            hist="kdtree_router_request_seconds",
            threshold=1.0,
        ),
    ]


class SloEngine:
    """Evaluates specs against a history ring, exports state gauges,
    and turns PAGE transitions into incident dumps. ``evaluate`` is
    called from the history sampler's tick and NEVER raises."""

    def __init__(
        self,
        specs: Optional[Sequence[SloSpec]] = None,
        history: Optional[hist_mod.MetricHistory] = None,
        registry=None,
    ) -> None:
        self.specs = list(default_specs() if specs is None else specs)
        self.history = (
            history if history is not None else hist_mod.get_history()
        )
        self._reg = registry or get_registry()
        self._lock = locks.make_lock("obs.slo.engine")
        self._states: Dict[str, int] = {}
        self._last: Dict[str, dict] = {}

    # -- evaluation ---------------------------------------------------------

    def _tier_burns(
        self, spec: SloSpec, win: BurnWindow, now: Optional[float],
    ) -> Tuple[Optional[float], Optional[float]]:
        bl = bad_fraction(spec, self.history, win.long_s, now)
        bs = bad_fraction(spec, self.history, win.short_s, now)
        budget = spec.budget
        return (
            None if bl is None else bl / budget,
            None if bs is None else bs / budget,
        )

    def evaluate(self, now: Optional[float] = None) -> Dict[str, dict]:
        """One pass over every spec: compute burns, set gauges, handle
        transitions. Returns ``{name: detail}``; swallows everything —
        it runs on the sampler thread inside a live server."""
        out: Dict[str, dict] = {}
        for spec in self.specs:
            try:
                out[spec.name] = self._evaluate_one(spec, now)
            except Exception:
                pass
        return out

    def _evaluate_one(self, spec: SloSpec, now: Optional[float]) -> dict:
        fast_l, fast_s = self._tier_burns(spec, spec.fast, now)
        slow_l, slow_s = self._tier_burns(spec, spec.slow, now)

        def fired(win: BurnWindow, bl, bs) -> bool:
            return (
                bl is not None and bs is not None
                and bl > win.max_burn and bs > win.max_burn
            )

        if fired(spec.fast, fast_l, fast_s):
            state = PAGE
        elif fired(spec.slow, slow_l, slow_s):
            state = WARN
        else:
            state = OK
        detail = {
            "state": STATE_NAMES[state],
            "burn_fast": fast_l,
            "burn_slow": slow_l,
            "data": fast_l is not None or slow_l is not None,
            "objective": spec.objective,
            "target": spec.target,
        }
        self._reg.gauge(
            "kdtree_slo_state", labels={"slo": spec.name}
        ).set(state)
        self._reg.gauge(
            "kdtree_slo_burn_rate", labels={"slo": spec.name, "window": "fast"}
        ).set(fast_l or 0.0)
        self._reg.gauge(
            "kdtree_slo_burn_rate", labels={"slo": spec.name, "window": "slow"}
        ).set(slow_l or 0.0)

        with self._lock:
            prev = self._states.get(spec.name, OK)
            self._states[spec.name] = state
            self._last[spec.name] = detail
        if state != prev:
            self._on_transition(spec, prev, state, detail)
        return detail

    def _on_transition(
        self, spec: SloSpec, prev: int, state: int, detail: dict,
    ) -> None:
        from kdtree_tpu_torch.obs import flight

        self._reg.counter(
            "kdtree_slo_transitions_total",
            labels={"slo": spec.name, "to": STATE_NAMES[state]},
        ).inc()
        flight.record(
            "slo.transition", slo=spec.name,
            previous=STATE_NAMES[prev], to=STATE_NAMES[state],
            burn_fast=detail["burn_fast"], burn_slow=detail["burn_slow"],
        )
        if state == PAGE:
            # the incident artifact: a flight + history dump pair whose
            # filename names the burning SLO (rate-limited per reason by
            # the recorder, so a flapping SLO can't carpet the disk)
            self.history.mark("slo_page")
            flight.auto_dump("slo-" + spec.name)

    # -- reading ------------------------------------------------------------

    def states(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._states)

    def health_block(self) -> dict:
        """The ``/healthz`` ``"slo"`` block: overall worst state plus a
        per-SLO breakdown. Readiness itself is NOT gated on this — a
        burning SLO degrades the report, not the 200."""
        with self._lock:
            last = {k: dict(v) for k, v in self._last.items()}
            states = dict(self._states)
        worst = max(states.values(), default=OK)
        return {
            "state": STATE_NAMES[worst],
            "slos": {
                name: {
                    "state": last.get(name, {}).get("state", "OK"),
                    "burn_fast": last.get(name, {}).get("burn_fast"),
                    "burn_slow": last.get(name, {}).get("burn_slow"),
                    "data": last.get(name, {}).get("data", False),
                }
                for name in sorted(states)
            },
        }
