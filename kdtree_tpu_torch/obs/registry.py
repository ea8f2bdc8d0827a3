"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Pure Python, no torch import — the registry must be importable (and cheap)
from every host-side hot path, including the CLI before any backend
initializes. All instruments are thread-safe: per-instrument locks make
concurrent increments from host threads (e.g. the HTTP handlers vs the
batch worker) well-defined — a bare ``+=`` on a Python float is
NOT atomic across the bytecode boundary.

Design constraints, in order:

1. **Cheap on the hot path.** ``counter(...).inc()`` is two dict lookups
   and one locked add. Call sites that run per-batch or per-query keep a
   bound instrument reference instead of re-resolving the name.
2. **No background machinery.** Nothing polls, nothing flushes; exporters
   (:mod:`kdtree_tpu_torch.obs.export`) read a consistent snapshot on demand.
3. **Prometheus-compatible naming.** Metric identity is (name, sorted
   label pairs); the flat key ``name{k="v"}`` is what reports and the
   text exposition format use.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from kdtree_tpu_torch.utils import locks

LabelItems = Tuple[Tuple[str, str], ...]

# log-spaced seconds buckets: host phases span ~100us (a counter fetch) to
# minutes (a 10M-query bench section)
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
    30.0, 60.0, 300.0,
)


def _label_items(labels: Optional[Mapping[str, object]]) -> LabelItems:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def format_key(name: str, label_items: LabelItems) -> str:
    """Flat report/exposition key: ``name`` or ``name{k="v",k2="v2"}``."""
    if not label_items:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in label_items)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing value."""

    kind = "counter"
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = locks.make_lock("obs.counter")
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins value (may go up or down)."""

    kind = "gauge"
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = locks.make_lock("obs.gauge")
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative counts at export time, Prometheus
    style). Buckets are upper bounds; an implicit +Inf bucket catches the
    rest. ``observe_array`` batch-bins a numpy array in one searchsorted —
    the path the bucket-occupancy instrumentation uses for [NBP]-sized
    inputs."""

    kind = "histogram"
    __slots__ = ("_lock", "uppers", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, buckets: Sequence[float]) -> None:
        if not buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.uppers: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        self._lock = locks.make_lock("obs.histogram")
        self._counts = [0] * (len(self.uppers) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        # last exemplar per bucket index: {i: (label_value, value, unix)}.
        # Populated only when a call site passes exemplar= (serving
        # paths pass the trace id) — observe() without one costs nothing
        # extra, and the default text exposition never renders these
        # (only GET /metrics?openmetrics=1 does, obs/export.py).
        self._exemplars: Dict[int, Tuple[str, float, float]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        i = bisect.bisect_left(self.uppers, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if exemplar:
                import time

                self._exemplars[i] = (str(exemplar)[:128], float(value),
                                      time.time())

    def observe_array(self, values) -> None:
        import numpy as np

        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.uppers), arr, side="left")
        binned = np.bincount(idx, minlength=len(self._counts))
        with self._lock:
            for i, c in enumerate(binned):
                self._counts[i] += int(c)
            self._sum += float(arr.sum())
            self._count += int(arr.size)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cumulative: Dict[str, int] = {}
        running = 0
        for upper, c in zip(self.uppers, counts[:-1]):
            running += c
            cumulative[repr(upper)] = running
        cumulative["+Inf"] = total
        return {"count": total, "sum": s, "buckets": cumulative}

    def exemplars(self) -> Dict[str, Tuple[str, float, float]]:
        """Last recorded exemplar per bucket, keyed like ``snapshot``'s
        buckets (``repr(upper)`` / ``"+Inf"``): ``(label_value, observed
        value, unix timestamp)``. Empty for call sites that never pass
        ``exemplar=``."""
        with self._lock:
            ex = dict(self._exemplars)
        keys = [repr(u) for u in self.uppers] + ["+Inf"]
        return {keys[i]: v for i, v in ex.items() if i < len(keys)}


class MetricsRegistry:
    """Named, labeled instruments with kind-consistency enforcement."""

    def __init__(self) -> None:
        self._lock = locks.make_lock("obs.registry")
        self._kinds: Dict[str, str] = {}
        self._metrics: Dict[str, Dict[LabelItems, object]] = {}

    def _get(self, cls, name: str, labels, **kw):
        items = _label_items(labels)
        with self._lock:
            kind = self._kinds.get(name)
            if kind is None:
                self._kinds[name] = cls.kind
                self._metrics[name] = {}
            elif kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as a {kind}, "
                    f"cannot re-register as a {cls.kind}"
                )
            family = self._metrics[name]
            inst = family.get(items)
            if inst is None:
                inst = family[items] = cls(**kw)
            return inst

    def counter(self, name: str, labels: Optional[Mapping] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Mapping] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self, name: str, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
        labels: Optional[Mapping] = None,
    ) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def collect(self) -> List[Tuple[str, str, LabelItems, object]]:
        """Consistent (name, kind, label_items, instrument) listing, sorted
        for stable export output."""
        with self._lock:
            out = []
            for name in sorted(self._metrics):
                kind = self._kinds[name]
                for items in sorted(self._metrics[name]):
                    out.append((name, kind, items, self._metrics[name][items]))
            return out

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} with
        flat ``name{labels}`` keys."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, object] = {}
        for name, kind, items, inst in self.collect():
            key = format_key(name, items)
            if kind == "counter":
                counters[key] = inst.value
            elif kind == "gauge":
                gauges[key] = inst.value
            else:
                hists[key] = inst.snapshot()
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def reset(self) -> None:
        """Drop every instrument (tests only — live references keep
        counting into detached instruments)."""
        with self._lock:
            self._kinds.clear()
            self._metrics.clear()


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry
