"""Per-request cost attribution, the profiling duty cycle, and the
capacity-headroom model.

The port of ``kdtree_tpu/obs/costs.py``: the ledger and the headroom
model are the reference's host code as it is (the same counters, report
and headroom for the same calls); the duty cycle opens
:mod:`kdtree_tpu_torch.obs.profile` windows through the server's batch
worker and analyzes them with :mod:`kdtree_tpu_torch.obs.timeline`. It reads the
same ``KDTREE_TPU_PROFILE_DUTY*`` environment names.

The serving stack could always say how *long* a request took (latency
histograms) but not what it *cost*: device time was only visible inside
manual ``/debug/profile`` captures, and nothing connected "this mix of
traffic" to "this much sustainable rate". This module closes the loop:

- :class:`CostLedger` — every answered request is attributed a cost
  vector (queue_ms, device_ms, rows, candidate visits, overflow
  retries, bytes in/out), accumulated under a **bounded class enum**
  ``{verb x gear x outcome}`` (unknown values
  fold into ``"other"``, they can never mint a new label) and exported
  as ``kdtree_cost_*`` counters. The key accounting identity:
  a batch's dispatch span is **amortized to member requests by row
  share**, and the per-request shares sum *exactly* to the measured
  span (:func:`amortize_span_ms`, integer-microsecond largest-remainder
  rounding) — cost totals reconcile against wall clock, always.
- :class:`ProfileDutyCycle` — a background thread opening a short
  profiler capture window on a period (default 2 s every 300 s; off
  unless ``KDTREE_TPU_PROFILE_DUTY=1``, where the reference's is on
  unless it is 0, see ``duty_enabled``) so ``kdtree_device_busy_frac`` and the
  per-dispatch lag stay live in steady state and the device-busy SLO
  burns on real data instead of starving between manual captures. The
  single-capture lock is respected: a manual ``POST /debug/profile``
  in flight means the window is *skipped* (counted, flight-recorded),
  never contended.
- the **capacity-headroom model** — predicted sustainable rate =
  measured device budget / current-mix cost-per-query, where the
  cost-per-query is a windowed read of the cost counters off the
  history ring and the budget is scaled by the duty cycle's measured
  ``busy_frac`` when one exists. Published as
  ``kdtree_capacity_headroom_frac`` / ``kdtree_capacity_predicted_rate``
  (lazily — absent until there is data, the registered-gauge idiom),
  served as ``/debug/costs`` and rendered by ``costs``.

Telemetry-tier contract: attribution is host-side counter math on numbers
the batcher already computed — no device work, never raises.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from kdtree_tpu_torch.utils import locks
from kdtree_tpu_torch.obs.registry import get_registry

COSTS_VERSION = 1

# The bounded class enum: every answered request lands in
# exactly one {verb x gear x outcome} cell. Unknown inputs FOLD into
# "other" — folding is total, so the label space is bounded by
# construction and an unknown verb/gear can never mint a new series.
COST_VERBS = ("knn", "radius", "range", "count", "other")
COST_GEARS = ("exact", "approx", "brute-deadline", "other")
COST_OUTCOMES = ("ok", "degraded", "other")

# write-path op labels (bounded, mirrors the /v1/upsert|delete surface)
COST_WRITE_OPS = ("upsert", "delete", "other")

DEFAULT_WINDOW_S = 60.0
# the busy gauge refreshes once per duty period; the headroom read must
# look back far enough to see the last window even with default pacing
DEFAULT_BUSY_LOOKBACK_S = 900.0

DEFAULT_DUTY_PERIOD_S = 300.0
DEFAULT_DUTY_WINDOW_S = 2.0

# The switch (``KDTREE_TPU_PROFILE_DUTY``): the reference runs its duty
# cycle unless it is 0/off/none; the port runs it only when it is
# 1/on/true/yes. A window pauses the server's batch worker while the
# profiler starts and stops, and every Python thread while its trace is
# written (the export holds the GIL); the process's first window pays
# seconds of CUPTI start. So a default serve takes no windows it was not
# asked for; POST /debug/profile works either way.
_DUTY_ON = ("1", "on", "true", "yes")


def duty_enabled() -> bool:
    """Whether the profiling duty cycle runs in this process
    (``KDTREE_TPU_PROFILE_DUTY``, read when the cycle starts)."""
    return os.environ.get("KDTREE_TPU_PROFILE_DUTY", "").lower() in _DUTY_ON


def duty_period_s() -> float:
    """Seconds between duty-cycle capture windows
    (``KDTREE_TPU_PROFILE_DUTY_PERIOD_S``, default 300), defaulting —
    not crashing — on garbage."""
    raw = os.environ.get("KDTREE_TPU_PROFILE_DUTY_PERIOD_S", "")
    try:
        v = float(raw) if raw else DEFAULT_DUTY_PERIOD_S
    except ValueError:
        return DEFAULT_DUTY_PERIOD_S
    return v if v > 0 else DEFAULT_DUTY_PERIOD_S


def duty_window_s() -> float:
    """Length of one duty-cycle capture window
    (``KDTREE_TPU_PROFILE_DUTY_WINDOW_S``, default 2 s)."""
    raw = os.environ.get("KDTREE_TPU_PROFILE_DUTY_WINDOW_S", "")
    try:
        v = float(raw) if raw else DEFAULT_DUTY_WINDOW_S
    except ValueError:
        return DEFAULT_DUTY_WINDOW_S
    return v if v > 0 else DEFAULT_DUTY_WINDOW_S


# -- class folding -----------------------------------------------------------


def verb_class(verb: Optional[str]) -> str:
    """Fold a request verb into the bounded cost-class verb: the two
    count forms share ``"count"`` (same rule as the batcher's verb
    families), anything unrecognized folds to ``"other"``."""
    v = str(verb or "knn")
    if v.startswith("count"):
        return "count"
    return v if v in COST_VERBS else "other"


def gear_class(gear: Optional[str]) -> str:
    """Fold an answering gear token (``None`` = exact,
    ``"approx:0.9"``, ``"brute-deadline"``) into the bounded gear
    class. The precise target stays in the response token and the
    flight ring, never in a label."""
    if gear is None or gear == "" or gear == "exact":
        return "exact"
    g = str(gear)
    if g.startswith("approx"):
        return "approx"
    if g.startswith("brute"):
        return "brute-deadline"
    return "other"


def outcome_class(outcome: Optional[str]) -> str:
    """Fold an answer outcome into the bounded set: ``"ok"`` (kept
    contract) / ``"degraded"`` (deadline straggler, ladder-forced gear,
    oversized fallback) / ``"other"``."""
    o = "ok" if not outcome else str(outcome)
    return o if o in COST_OUTCOMES else "other"


# -- exact-sum amortization --------------------------------------------------


def _largest_remainder(total: int, weights: Sequence[int]) -> List[int]:
    """Split integer ``total`` proportionally to ``weights`` so the
    parts sum exactly to ``total``: floor division plus one extra unit
    to the largest fractional remainders (ties broken by index, so the
    split is deterministic)."""
    wsum = sum(weights)
    if total <= 0 or wsum <= 0:
        return [0] * len(weights)
    base = [total * w // wsum for w in weights]
    rem = total - sum(base)
    if rem > 0:
        order = sorted(range(len(weights)),
                       key=lambda i: (-(total * weights[i] % wsum), i))
        for i in order[:rem]:
            base[i] += 1
    return base


def amortize_span_ms(span_ms: float, rows: Sequence[int]) -> List[float]:
    """Amortize one batch dispatch span over its member requests by row
    share, at microsecond resolution, with the accounting identity the
    ledger's tests pin: the returned shares sum *exactly* to the span
    rounded to 3 decimals (compare in integer microseconds — every
    share is an exact multiple of 0.001 ms)."""
    micros = int(round(max(float(span_ms), 0.0) * 1000.0))
    parts = _largest_remainder(micros, [max(int(r), 0) for r in rows])
    return [p / 1000.0 for p in parts]


# -- the ledger --------------------------------------------------------------

_COST_FIELDS = (
    "requests", "rows", "queue_ms", "device_ms", "visits", "retries",
    "bytes_in", "bytes_out",
)


class CostLedger:
    """Accumulates per-request cost vectors under the bounded
    {verb x gear x outcome} class enum and answers the windowed
    cost/headroom questions over the history ring.

    Public methods never raise — cost accounting observes serving, it
    must not fail a request that already answered."""

    def __init__(self, registry=None) -> None:
        self._reg = registry or get_registry()
        self._lock = locks.make_lock("obs.costs.ledger")
        # lazily-registered per-class counter rows: keys are already
        # folded, so this dict is bounded by |verbs|x|gears|x|outcomes|
        self._classes: Dict[Tuple[str, str, str], Dict[str, object]] = {}

    def _counters(self, verb: Optional[str], gear: Optional[str],
                  outcome: Optional[str]) -> Dict[str, object]:
        key = (verb_class(verb), gear_class(gear), outcome_class(outcome))
        with self._lock:
            row = self._classes.get(key)
            if row is None:
                labels = {"verb": key[0], "gear": key[1],
                          "outcome": key[2]}
                row = self._classes[key] = {
                    "requests": self._reg.counter(
                        "kdtree_cost_requests_total", labels=labels),
                    "rows": self._reg.counter(
                        "kdtree_cost_rows_total", labels=labels),
                    "queue_ms": self._reg.counter(
                        "kdtree_cost_queue_ms_total", labels=labels),
                    "device_ms": self._reg.counter(
                        "kdtree_cost_device_ms_total", labels=labels),
                    "visits": self._reg.counter(
                        "kdtree_cost_visits_total", labels=labels),
                    "retries": self._reg.counter(
                        "kdtree_cost_retries_total", labels=labels),
                    "bytes_in": self._reg.counter(
                        "kdtree_cost_bytes_in_total", labels=labels),
                    "bytes_out": self._reg.counter(
                        "kdtree_cost_bytes_out_total", labels=labels),
                }
            return row

    # -- attribution (the batcher side) ------------------------------------

    def attribute_batch(
        self, *, verb: str, gear: Optional[str], span_ms: float,
        members: Sequence[Tuple[int, float, str]],
        retries: int = 0, visits_per_row: int = 0,
    ) -> List[float]:
        """Attribute one dispatch to its member requests.

        ``members`` is ``(rows, queue_ms, outcome)`` per request;
        ``span_ms`` is the batch's measured dispatch span (which
        already CONTAINS any overflow-retry re-dispatches — the verb
        driver retries inside the call), amortized by row share under
        the exact-sum identity. ``retries`` (the driver's doubling
        count) and candidate visits (``rows x visits_per_row``,
        the planned candidate-bucket visits: the resolved visit cap
        for approximate gears, every bucket for exact) follow the same
        integer split. Returns the per-member device_ms shares (what
        the flight ring records per request). Never raises."""
        try:
            rows = [max(int(m[0]), 0) for m in members]
            shares = amortize_span_ms(span_ms, rows)
            retry_parts = _largest_remainder(max(int(retries), 0), rows)
            vpr = max(int(visits_per_row), 0)
            for (r, queue_ms, outcome), dev, rt in zip(
                    members, shares, retry_parts):
                row = self._counters(verb, gear, outcome)
                row["requests"].inc()
                row["rows"].inc(max(int(r), 0))
                row["queue_ms"].inc(max(float(queue_ms), 0.0))
                row["device_ms"].inc(dev)
                if vpr:
                    row["visits"].inc(max(int(r), 0) * vpr)
                if rt:
                    row["retries"].inc(rt)
            return shares
        except Exception:
            return [0.0] * len(members)

    def attribute_request(
        self, *, verb: str, gear: Optional[str], span_ms: float,
        rows: int, queue_ms: float, outcome: str = "ok",
        visits_per_row: int = 0,
    ) -> float:
        """Single-request convenience (fallback / oversized dispatches
        — a batch of one, where the identity is trivial)."""
        shares = self.attribute_batch(
            verb=verb, gear=gear, span_ms=span_ms,
            members=[(rows, queue_ms, outcome)],
            visits_per_row=visits_per_row,
        )
        return shares[0] if shares else 0.0

    def attribute_correction(self, span_ms: float, rows: int) -> None:
        """Account a correction dispatch — the recall sampler's exact
        shadow re-answer of a batch that already served. It answers no
        client, so it must NOT inflate any request class (that would
        corrupt cost-per-query); it is still real device time the
        capacity model owes an entry for. Never raises."""
        try:
            self._reg.counter(
                "kdtree_cost_correction_ms_total"
            ).inc(max(float(span_ms), 0.0))
            self._reg.counter(
                "kdtree_cost_correction_rows_total"
            ).inc(max(int(rows), 0))
        except Exception:
            pass

    def count_bytes(
        self, *, verb: str, gear: Optional[str], outcome: str,
        bytes_in: int = 0, bytes_out: int = 0,
    ) -> None:
        """Attribute request/response payload sizes to the answered
        class (called from the HTTP layer, where both are known).
        Never raises."""
        try:
            row = self._counters(verb, gear, outcome)
            if bytes_in:
                row["bytes_in"].inc(max(int(bytes_in), 0))
            if bytes_out:
                row["bytes_out"].inc(max(int(bytes_out), 0))
        except Exception:
            pass

    # -- windowed model (the history-ring side) ----------------------------

    def window_costs(
        self, window_s: float = DEFAULT_WINDOW_S, history=None,
        now: Optional[float] = None,
    ) -> Optional[dict]:
        """Current-mix cost-per-query over the history window: device_ms
        and request deltas of the cost counters (summed over classes).
        None when the window has no answered traffic — idle is absence
        of data, not zero cost."""
        try:
            if history is None:
                from kdtree_tpu_torch.obs import history as hist_mod

                history = hist_mod.get_history()
            nreq = history.counter_delta(
                "kdtree_cost_requests_total", window_s, now)
            dev = history.counter_delta(
                "kdtree_cost_device_ms_total", window_s, now)
            rate = history.counter_rate(
                "kdtree_cost_requests_total", window_s, now)
            if not nreq or dev is None:
                return None
            return {
                "window_s": float(window_s),
                "requests": nreq,
                "device_ms": dev,
                "cost_per_query_ms": dev / nreq,
                "observed_rate": rate or 0.0,
            }
        except Exception:
            return None

    def _busy_frac(self, history, now: Optional[float]) -> Optional[float]:
        """Latest duty-cycle (or manual-capture) busy_frac within the
        lookback, read from history samples so an unset gauge stays
        absent instead of registering as 0."""
        try:
            vals = history.gauge_values(
                "kdtree_device_busy_frac", DEFAULT_BUSY_LOOKBACK_S, now)
            return vals[-1] if vals else None
        except Exception:
            return None

    def headroom(
        self, window_s: float = DEFAULT_WINDOW_S, history=None,
        now: Optional[float] = None,
    ) -> dict:
        """The capacity-headroom model: predicted sustainable rate =
        measured device budget / current-mix cost-per-query.

        The budget is one second of dispatch-span wall time per second
        (the batch worker is serial), scaled by the duty cycle's
        measured ``busy_frac`` when a capture has published one — a
        device that a profiler shows 60% busy during dispatch spans
        cannot bank the idle 40%. ``headroom_frac`` is the fraction of
        the predicted rate not yet consumed by the observed rate;
        ``data: false`` (with gauges left absent) when the window saw
        no answered traffic."""
        if history is None:
            from kdtree_tpu_torch.obs import history as hist_mod

            history = hist_mod.get_history()
        w = self.window_costs(window_s, history, now)
        busy = self._busy_frac(history, now)
        if w is None or w["cost_per_query_ms"] <= 0:
            return {"data": False, "window_s": float(window_s),
                    "busy_frac": busy}
        budget_ms = 1000.0 * (busy if busy is not None and busy > 0
                              else 1.0)
        predicted = budget_ms / w["cost_per_query_ms"]
        observed = w["observed_rate"]
        frac = max(0.0, 1.0 - observed / predicted) if predicted > 0 \
            else 0.0
        return {
            "data": True,
            "window_s": float(window_s),
            "cost_per_query_ms": w["cost_per_query_ms"],
            "observed_rate": observed,
            "predicted_rate": predicted,
            "headroom_frac": frac,
            "busy_frac": busy,
        }

    def publish(self, history=None, now: Optional[float] = None) -> None:
        """Refresh the headroom gauges from the current window (the
        sampler tick calls this). Gauges are registered LAZILY — they
        stay absent (not 0) until there is answered traffic to model.
        Never raises."""
        try:
            hr = self.headroom(history=history, now=now)
            if not hr.get("data"):
                return
            self._reg.gauge("kdtree_cost_per_query_ms").set(
                round(hr["cost_per_query_ms"], 6))
            self._reg.gauge("kdtree_capacity_predicted_rate").set(
                round(hr["predicted_rate"], 3))
            self._reg.gauge("kdtree_capacity_headroom_frac").set(
                round(hr["headroom_frac"], 6))
        except Exception:
            pass

    # -- reporting ---------------------------------------------------------

    def class_rows(self) -> List[dict]:
        """Cumulative per-class cost vectors, sorted by class key (the
        ``/debug/costs`` table). Read from the registry snapshot, not
        this instance's lazily-created rows: the counters are
        get-or-create on the shared registry, so a second ledger over
        the same registry (a fresh in-process server, a test fixture)
        must report the same table /metrics exports — not just the
        classes it has personally attributed."""
        snap = self._reg.snapshot()["counters"]
        classes: Dict[Tuple[str, str, str], Dict[str, float]] = {}
        for field in _COST_FIELDS:
            prefix = f"kdtree_cost_{field}_total{{"
            for key, val in snap.items():
                if not key.startswith(prefix):
                    continue
                labels = {}
                for part in key.split("{", 1)[1].rstrip("}").split(","):
                    if "=" in part:
                        lk, lv = part.split("=", 1)
                        labels[lk] = lv.strip('"')
                try:
                    ck = (labels["verb"], labels["gear"],
                          labels["outcome"])
                except KeyError:
                    continue
                row = classes.setdefault(
                    ck, dict.fromkeys(_COST_FIELDS, 0.0))
                row[field] = float(val)
        out = []
        for (verb, gear, outcome) in sorted(classes):
            row = classes[(verb, gear, outcome)]
            d = {"verb": verb, "gear": gear, "outcome": outcome}
            for f in _COST_FIELDS:
                d[f] = round(row[f], 3)
            n = d["requests"]
            d["cost_ms"] = round(d["device_ms"] / n, 6) if n else 0.0
            out.append(d)
        return out

    def report(
        self, window_s: float = DEFAULT_WINDOW_S, history=None,
        now: Optional[float] = None,
    ) -> dict:
        """The ``GET /debug/costs`` payload: identity, cumulative
        per-class vectors + totals, the windowed current-mix read, the
        headroom model, and the maintenance (write/rebuild/correction)
        costs that consume budget without answering queries."""
        classes = self.class_rows()
        totals = {f: round(sum(c[f] for c in classes), 3)
                  for f in _COST_FIELDS}
        n = totals.get("requests", 0.0)
        totals["cost_ms"] = round(totals["device_ms"] / n, 6) if n \
            else 0.0
        snap = self._reg.snapshot()["counters"]
        maintenance = {
            key: round(float(snap.get(name, 0.0)), 3)
            for key, name in (
                ("correction_ms", "kdtree_cost_correction_ms_total"),
                ("correction_rows", "kdtree_cost_correction_rows_total"),
                ("write_ms", None),
                ("rebuild_ms", "kdtree_cost_rebuild_ms_total"),
                ("rebuilds", "kdtree_cost_rebuilds_total"),
            ) if name is not None
        }
        maintenance["write_ms"] = round(sum(
            v for k, v in snap.items()
            if k.startswith("kdtree_cost_write_ms_total")), 3)
        maintenance["writes"] = round(sum(
            v for k, v in snap.items()
            if k.startswith("kdtree_cost_writes_total")), 3)
        return {
            "costs_version": COSTS_VERSION,
            "generated_unix": time.time(),
            "pid": os.getpid(),
            "window_s": float(window_s),
            "classes": classes,
            "totals": totals,
            "window": self.window_costs(window_s, history, now),
            "headroom": self.headroom(window_s, history, now),
            "maintenance": maintenance,
        }


# -- maintenance costs (module-level: callers own no ledger) -----------------


def count_write(op: str, apply_ms: float, registry=None) -> None:
    """Account one mutable-index write's apply time under the bounded
    op label (``kdtree_cost_write_ms_total{op=...}``) — write traffic
    consumes the same serial worker budget queries do, so the capacity
    model owes it a line item. Never raises."""
    try:
        reg = registry or get_registry()
        o = op if op in COST_WRITE_OPS else "other"
        reg.counter("kdtree_cost_writes_total", labels={"op": o}).inc()
        reg.counter("kdtree_cost_write_ms_total", labels={"op": o}).inc(
            max(float(apply_ms), 0.0))
    except Exception:
        pass


def count_rebuild(rebuild_ms: float, registry=None) -> None:
    """Account one epoch rebuild's wall time
    (``kdtree_cost_rebuild_ms_total``) — rebuilds run on a background
    thread but compete for the same host/device, and a capacity plan
    that ignores them overpromises during compaction. Never raises."""
    try:
        reg = registry or get_registry()
        reg.counter("kdtree_cost_rebuilds_total").inc()
        reg.counter("kdtree_cost_rebuild_ms_total").inc(
            max(float(rebuild_ms), 0.0))
    except Exception:
        pass


# -- the profiling duty cycle ------------------------------------------------


class ProfileDutyCycle:
    """Background thread: one short profiler capture window per period,
    analyzed through :mod:`kdtree_tpu_torch.obs.timeline` so
    ``kdtree_device_busy_frac`` and ``kdtree_dispatch_lag_us`` stay
    live in steady state (the device-busy SLO's data source — see
    :func:`kdtree_tpu_torch.obs.slo.default_specs`).

    Discipline: daemon thread, never raises, idempotent start/stop;
    respects the process-wide single-capture lock by SKIPPING a window
    when a manual capture is active (counted in
    ``kdtree_profile_duty_skipped_total``, never contended); every
    window and skip is a flight event; trace artifacts are deleted
    after analysis so a long-lived replica cannot fill the disk."""

    def __init__(
        self,
        log_dir: Optional[str] = None,
        period_s: Optional[float] = None,
        window_s: Optional[float] = None,
        *,
        capture_for,
    ) -> None:
        # how a window is opened: ``capture_for(seconds, log_dir)`` ->
        # CaptureResult. Every window must start and stop on the thread
        # that launches the kernels (obs/profile.py): a server passes its
        # batch worker's, never a window opened by this duty thread
        self._capture_for = capture_for
        self.period_s = max(
            float(period_s) if period_s is not None else duty_period_s(),
            0.05)
        self.window_s = max(
            float(window_s) if window_s is not None else duty_window_s(),
            0.01)
        self.log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), f"kdtree-duty-{os.getpid()}")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._windows = reg.counter("kdtree_profile_duty_windows_total")
        self._skipped = reg.counter("kdtree_profile_duty_skipped_total")

    @property
    def enabled(self) -> bool:
        return duty_enabled()

    def start(self) -> None:
        """No-op unless enabled by env, or when already running."""
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="kdtree-profile-duty", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None

    def _run(self) -> None:
        # first window after one full period: startup (warmup compiles,
        # cold caches) is exactly the regime the steady-state busy
        # signal must NOT be polluted by
        while not self._stop.wait(self.period_s):
            try:
                self.run_window()
            except Exception:
                # the duty cycle observes the process; never kills it
                pass

    def run_window(self) -> Optional[dict]:
        """One capture window: capture, analyze, publish, clean up.
        Returns the timeline report (None when skipped or the trace
        went missing). Exposed for tests and for an operator forcing a
        window out of band."""
        from kdtree_tpu_torch.obs import flight, profile

        try:
            res = self._capture_for(self.window_s, self.log_dir)
        except profile.CaptureBusyError:
            # a manual /debug/profile owns the lock — its capture will
            # publish the same gauges; skipping is correct, not a loss
            self._skipped.inc()
            flight.record("profile.duty_skip", reason="capture-busy")
            return None
        except Exception as e:
            self._skipped.inc()
            flight.record("profile.duty_skip", reason=repr(e)[:160])
            return None
        rep: Optional[dict] = None
        busy = lag = None
        try:
            if res.trace_file:
                from kdtree_tpu_torch.obs import timeline

                # analyze_trace_file publishes kdtree_device_busy_frac
                # and kdtree_dispatch_lag_us itself (last capture wins
                # — manual and duty windows feed the same gauges)
                rep = timeline.analyze_trace_file(res.trace_file)
                busy = (rep.get("device") or {}).get("busy_frac")
                lag = ((rep.get("dispatches") or {}).get("lag_us")
                       or {}).get("median")
        except Exception:
            rep = None
        finally:
            self._cleanup(res.trace_file)
        self._windows.inc()
        flight.record(
            "profile.duty_window", seconds=self.window_s,
            busy_frac=busy, lag_us_median=lag,
            trace_file=res.trace_file or "",
        )
        return rep

    @staticmethod
    def _cleanup(trace_file: Optional[str]) -> None:
        """Best-effort removal of one window's trace file — each window
        writes a fresh multi-MB artifact, and the analysis already
        extracted everything the gauges need."""
        if not trace_file:
            return
        try:
            os.remove(trace_file)
        except OSError:
            pass
