"""Metric history: a bounded in-process time-series ring over the registry.

The registry (:mod:`kdtree_tpu_torch.obs.registry`) answers "what are the
totals right now"; Prometheus answers "what happened over time" only if
an external scraper was pointed at the process all along. This module is
the in-between: a bounded ring of registry snapshots taken on a period,
so a serving replica can answer "has my p99 been burning for the last
ten minutes" *by itself* — the temporal substrate the SLO engine
(:mod:`kdtree_tpu_torch.obs.slo`) evaluates burn rates against, the payload of
``GET /debug/history``, and the companion artifact dumped next to flight
rings on incidents.

Discipline (same tier as the flight recorder, docs/OBSERVABILITY.md):

- **Bounded by construction**: a deque of at most
  ``KDTREE_TPU_HISTORY_SAMPLES`` (default 512) samples; at the default
  1 s period (``KDTREE_TPU_HISTORY_PERIOD_S``) that is ~8.5 minutes of
  retention in a few MB.
- **Never raises** into the sampled process: ``record``/``sample`` and
  the background :class:`Sampler` swallow everything — telemetry must
  not fail the run it observes.
- **No device work**: a sample is ``registry.snapshot()`` — pure host
  dict copies under per-instrument locks. Sampling deliberately does NOT
  run ``obs.flush()`` (the deferred device fetches stay where they are:
  report time), so the sampler thread can never sync the accelerator.
- **Cheap**: one snapshot of a serving-sized registry measures in the
  tens of µs–low-ms range; at 1 Hz that is ≤ ~0.1% of a core — far
  inside the <2% serving overhead bar, and ``KDTREE_TPU_HISTORY=0``
  disables recording entirely for the A/B measurement (same idiom as
  ``KDTREE_TPU_FLIGHT=0``).

Query surface: windowed counter ``delta``/``rate``, gauge stats, and
windowed histogram quantiles / ≤-threshold fractions computed from
cumulative-bucket differences between the oldest and newest sample in
the window — exactly the inputs multi-window burn-rate math needs.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kdtree_tpu_torch.utils import locks

HISTORY_VERSION = 1
DEFAULT_CAPACITY = 512
DEFAULT_PERIOD_S = 1.0
# distinct mark() series cap: marks are meant for a handful of static
# event names (SLO page transitions); past the cap new names are dropped
# rather than growing the dict — the same cardinality contract the
# reference's lint enforces statically on the call sites
_MAX_MARK_NAMES = 64


def _env_capacity() -> int:
    raw = os.environ.get("KDTREE_TPU_HISTORY_SAMPLES", "")
    try:
        v = int(raw) if raw else DEFAULT_CAPACITY
    except ValueError:
        return DEFAULT_CAPACITY
    return v if v >= 2 else DEFAULT_CAPACITY


def default_period() -> float:
    """Sampler period: ``KDTREE_TPU_HISTORY_PERIOD_S`` (default 1.0 s),
    defaulting (not crashing) on garbage."""
    raw = os.environ.get("KDTREE_TPU_HISTORY_PERIOD_S", "")
    try:
        v = float(raw) if raw else DEFAULT_PERIOD_S
    except ValueError:
        return DEFAULT_PERIOD_S
    return v if v > 0 else DEFAULT_PERIOD_S


def _match(key: str, prefix: str) -> bool:
    """Series selector: an exact flat key (``name{k="v"}``) matches only
    itself; a bare family name matches every label set of that family."""
    return key == prefix or key.startswith(prefix + "{")


def _sum_prefix(flat: Dict[str, float], prefix: str) -> Optional[float]:
    vals = [v for k, v in flat.items() if _match(k, prefix)]
    if not vals:
        return None
    return float(sum(vals))


class MetricHistory:
    """Bounded ring of timestamped registry snapshots + windowed queries.

    Samples are ``{"ts", "seq", "counters", "gauges", "histograms"}``
    with the registry's flat ``name{label="v"}`` keys; ``seq`` is
    monotone so a reader knows how much history fell off the front."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        # REENTRANT, same lesson as the flight recorder's ring: the
        # SIGUSR2 handler (which dumps the history companion) runs on
        # the main thread between any two bytecodes — including inside
        # record()'s critical section. A plain Lock would deadlock the
        # process right there.
        self._lock = locks.make_rlock("obs.history.ring")
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self._marks: Dict[str, Dict[str, float]] = {}

    # -- recording (the sampler side) --------------------------------------

    def record(self, snapshot: Dict, ts: Optional[float] = None) -> None:
        """Append one registry snapshot. Never raises into the caller."""
        try:
            sample = {
                "ts": time.time() if ts is None else float(ts),
                "counters": snapshot.get("counters", {}),
                "gauges": snapshot.get("gauges", {}),
                "histograms": snapshot.get("histograms", {}),
            }
            with self._lock:
                sample["seq"] = self._seq
                self._seq += 1
                self._ring.append(sample)
        except Exception:
            pass

    def sample(self, registry=None) -> None:
        """Snapshot the registry into the ring (host dict copies only —
        deliberately no ``obs.flush()``: the sampler thread must never
        run deferred device fetches). Never raises."""
        try:
            from kdtree_tpu_torch.obs.registry import get_registry

            reg = registry or get_registry()
            reg.counter("kdtree_history_samples_total").inc()
            self.record(reg.snapshot())
        except Exception:
            pass

    def mark(self, name: str) -> None:
        """Count a named event into the history (a *bounded* set of
        static names — SLO page transitions and the like).
        Never raises."""
        try:
            now = time.time()
            with self._lock:
                m = self._marks.get(name)
                if m is None:
                    if len(self._marks) >= _MAX_MARK_NAMES:
                        return
                    m = self._marks[name] = {"count": 0.0, "last_ts": 0.0}
                m["count"] += 1.0
                m["last_ts"] = now
        except Exception:
            pass

    # -- reading ------------------------------------------------------------

    def samples(
        self, window_s: Optional[float] = None, now: Optional[float] = None,
    ) -> List[dict]:
        """Copy of the ring, oldest first; ``window_s`` keeps only
        samples with ``now - window_s <= ts <= now``. The upper bound
        matters for retrospective windows (the rebuild-impact join asks
        for "the window ENDING at t0" after t1 has already been
        sampled): without it, every windowed query silently extended to
        the newest sample and a "before the incident" window included
        the incident."""
        with self._lock:
            out = list(self._ring)
        if window_s is None:
            return out
        end = time.time() if now is None else float(now)
        cutoff = end - float(window_s)
        return [s for s in out if cutoff <= s["ts"] <= end]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            n = len(self._ring)
            return {
                "capacity": self.capacity,
                "samples": n,
                "dropped": self._seq - n,
            }

    # -- windowed queries ---------------------------------------------------

    def counter_delta(
        self, prefix: str, window_s: float, now: Optional[float] = None,
    ) -> Optional[float]:
        """Increase of the counter series matching ``prefix`` (summed
        over label sets) between the oldest and newest in-window sample;
        None when fewer than two samples cover the window or the series
        is absent."""
        win = self.samples(window_s, now)
        if len(win) < 2:
            return None
        last = _sum_prefix(win[-1]["counters"], prefix)
        if last is None:
            return None
        first = _sum_prefix(win[0]["counters"], prefix) or 0.0
        return max(last - first, 0.0)

    def counter_rate(
        self, prefix: str, window_s: float, now: Optional[float] = None,
    ) -> Optional[float]:
        """``counter_delta`` per second over the actual sample span —
        computed from ONE ring read: a sampler append between two reads
        would hand the delta one more period than the span."""
        win = self.samples(window_s, now)
        if len(win) < 2:
            return None
        span = win[-1]["ts"] - win[0]["ts"]
        if span <= 0:
            return None
        last = _sum_prefix(win[-1]["counters"], prefix)
        if last is None:
            return None
        first = _sum_prefix(win[0]["counters"], prefix) or 0.0
        return max(last - first, 0.0) / span

    def gauge_values(
        self, key: str, window_s: float, now: Optional[float] = None,
    ) -> List[float]:
        """Every in-window observation of one gauge key (absent samples
        skipped — a gauge that was never set reads as no data)."""
        return [
            float(s["gauges"][key])
            for s in self.samples(window_s, now)
            if key in s["gauges"]
        ]

    def gauge_stats(
        self, key: str, window_s: float, now: Optional[float] = None,
    ) -> Optional[Dict[str, float]]:
        vals = self.gauge_values(key, window_s, now)
        if not vals:
            return None
        return {
            "n": float(len(vals)),
            "last": vals[-1],
            "mean": sum(vals) / len(vals),
            "min": min(vals),
            "max": max(vals),
        }

    def hist_delta(
        self, prefix: str, window_s: float, now: Optional[float] = None,
    ) -> Optional[Dict]:
        """Windowed histogram increase for the series matching
        ``prefix`` (summed over label sets): cumulative bucket counts,
        total count and sum, all as oldest-vs-newest differences (the
        difference of two cumulative snapshots is itself cumulative)."""
        win = self.samples(window_s, now)
        if len(win) < 2:
            return None
        first, last = win[0]["histograms"], win[-1]["histograms"]
        buckets: Dict[str, float] = {}
        count = 0.0
        total = 0.0
        matched = False
        for key, snap in last.items():
            if not _match(key, prefix):
                continue
            matched = True
            prev = first.get(key, {})
            count += snap["count"] - prev.get("count", 0)
            total += snap["sum"] - prev.get("sum", 0.0)
            pbuckets = prev.get("buckets", {})
            for upper, cum in snap["buckets"].items():
                buckets[upper] = (
                    buckets.get(upper, 0.0) + cum - pbuckets.get(upper, 0)
                )
        if not matched:
            return None
        return {"count": max(count, 0.0), "sum": total, "buckets": buckets}

    @staticmethod
    def _sorted_bounds(buckets: Dict[str, float]) -> List[Tuple[float, float]]:
        finite = []
        inf_cum = None
        for upper, cum in buckets.items():
            if upper == "+Inf":
                inf_cum = float(cum)
            else:
                finite.append((float(upper), float(cum)))
        finite.sort()
        if inf_cum is not None:
            finite.append((float("inf"), inf_cum))
        return finite

    def quantile(
        self, prefix: str, q: float, window_s: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Windowed q-quantile of a histogram series: linear
        interpolation inside the bucket where the quantile falls, the
        standard Prometheus ``histogram_quantile`` estimate. +Inf-bucket
        hits report the largest finite bound (the histogram cannot say
        more)."""
        d = self.hist_delta(prefix, window_s, now)
        if d is None or d["count"] <= 0:
            return None
        bounds = self._sorted_bounds(d["buckets"])
        if not bounds:
            return None
        target = min(max(q, 0.0), 1.0) * d["count"]
        prev_upper, prev_cum = 0.0, 0.0
        for upper, cum in bounds:
            if cum >= target:
                if upper == float("inf"):
                    return prev_upper if prev_upper > 0 else None
                if cum <= prev_cum:
                    return upper
                frac = (target - prev_cum) / (cum - prev_cum)
                return prev_upper + frac * (upper - prev_upper)
            prev_upper, prev_cum = (0.0 if upper == float("inf") else upper), cum
        return bounds[-1][0] if bounds[-1][0] != float("inf") else prev_upper

    def frac_le(
        self, prefix: str, bound: float, window_s: float,
        now: Optional[float] = None,
    ) -> Optional[Tuple[float, float]]:
        """``(observations <= bound, total observations)`` over the
        window, using the LARGEST bucket upper <= ``bound``: a bound
        between buckets counts the in-between observations as
        violations — conservative against the SLO (over-alerting beats
        a latency burn the rounding hid). A bound below every bucket
        counts nothing as good for the same reason."""
        d = self.hist_delta(prefix, window_s, now)
        if d is None or d["count"] <= 0:
            return None
        le = 0.0
        for upper, cum in self._sorted_bounds(d["buckets"]):
            if upper <= bound + 1e-12:
                le = cum
            else:
                break
        return le, d["count"]

    # -- exporting ----------------------------------------------------------

    def report(self, limit: Optional[int] = None) -> dict:
        """The ``GET /debug/history`` payload (also the incident-dump
        body): identity + stats + the samples themselves (newest-last;
        ``limit`` keeps only the newest N)."""
        snap = self.samples()
        if limit is not None and limit > 0:
            snap = snap[-limit:]
        st = self.stats()
        with self._lock:
            marks = {k: dict(v) for k, v in self._marks.items()}
        return {
            "history_version": HISTORY_VERSION,
            "generated_unix": time.time(),
            "pid": os.getpid(),
            "capacity": st["capacity"],
            "samples": st["samples"],
            "dropped": st["dropped"],
            "period_hint_s": default_period(),
            "marks": marks,
            "events": snap,
        }

    def dump(self, path: str, limit: Optional[int] = None) -> str:
        """Atomic write (tmp + ``os.replace``), same contract as the
        flight recorder's dump. Returns ``path``."""
        rep = self.report(limit=limit)
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(rep, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
        os.replace(tmp, path)
        return path


class Sampler:
    """Background sampling thread: one :meth:`MetricHistory.sample` per
    period, then the optional ``on_sample`` hook (where the SLO engine
    evaluates). Daemon, never raises, idempotent start/stop."""

    def __init__(
        self,
        period_s: Optional[float] = None,
        history: Optional[MetricHistory] = None,
        registry=None,
        on_sample: Optional[Callable[[], None]] = None,
    ) -> None:
        self.period_s = (
            default_period() if period_s is None
            else max(float(period_s), 0.01)
        )
        self.history = history if history is not None else get_history()
        self._registry = registry
        self.on_sample = on_sample
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        while True:
            try:
                if not _DISABLED:
                    self.history.sample(self._registry)
                if self.on_sample is not None:
                    self.on_sample()
            except Exception:
                # the sampler observes the process; it must never kill it
                pass
            if self._stop.wait(self.period_s):
                return

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="kdtree-history-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None


_history = MetricHistory(capacity=_env_capacity())

# A/B kill switch, read once at import (same idiom as KDTREE_TPU_FLIGHT):
# KDTREE_TPU_HISTORY=0/off/none disables recording entirely — the
# measurement partner for the <2% serving-overhead check.
_DISABLED = os.environ.get(
    "KDTREE_TPU_HISTORY", ""
).lower() in ("0", "off", "none")


def get_history() -> MetricHistory:
    return _history


def sample(registry=None) -> None:
    """Module-level convenience over the process history (where the kill
    switch applies) — the explicit-sampling entry point for CLI runs
    that have no background sampler."""
    if _DISABLED:
        return
    _history.sample(registry)


def auto_dump(reason: str, limit: Optional[int] = None) -> Optional[str]:
    """Dump the process history ring next to a flight-recorder incident
    dump: ``history-<reason>.json`` in the flight dir (disabled the same
    way). Never raises; rate limiting is the flight recorder's — this is
    only called when a flight dump actually happened."""
    try:
        from kdtree_tpu_torch.obs.flight import _dump_dir

        d = _dump_dir()
        if d is None or _DISABLED:
            return None
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason) or "dump"
        return _history.dump(os.path.join(d, f"history-{safe}.json"),
                             limit=limit)
    except Exception:
        return None
