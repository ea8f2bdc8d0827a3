"""kdtree_tpu_torch.obs — the telemetry the serving stack reports through.

The port of the part of ``kdtree_tpu/obs`` that serving calls:

- :mod:`~kdtree_tpu_torch.obs.registry` — process-wide counters / gauges /
  fixed-bucket histograms, cheap enough for host-side hot paths;
- :mod:`~kdtree_tpu_torch.obs.spans` — nested, thread-safe span timing,
  named in any running ``torch.profiler`` trace, with the
  :func:`hard_sync` completion barrier;
- :mod:`~kdtree_tpu_torch.obs.export` — the Prometheus text exposition
  (``GET /metrics``);
- :mod:`~kdtree_tpu_torch.obs.flight` — the always-on flight recorder;
- :mod:`~kdtree_tpu_torch.obs.history` — the metric-history ring;
- :mod:`~kdtree_tpu_torch.obs.slo` — declarative SLOs with multi-window
  burn rates.

Two cost tiers, as in the reference: host-side counters, gauges and spans
are always on; anything that costs a device reduction or a host fetch is
gated on :func:`enabled` (``KDTREE_TPU_METRICS=1`` or
:func:`set_enabled`) and finalised through :func:`defer` / :func:`flush`.
The reports, the JSONL log, profiler captures and runtime telemetry are
ROADMAP item 15.
"""

from __future__ import annotations

import os
from typing import Optional

from kdtree_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from kdtree_tpu_torch.utils import locks

_enabled_override: Optional[bool] = None


def enabled() -> bool:
    """Whether device-side (fetch/reduction-costing) telemetry is on."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("KDTREE_TPU_METRICS", "").lower() in (
        "1", "true", "yes", "on",
    )


def set_enabled(value: Optional[bool]) -> None:
    """Force device-side telemetry on/off; ``None`` restores the env
    default (``KDTREE_TPU_METRICS``)."""
    global _enabled_override
    _enabled_override = value


_deferred: list = []
_deferred_lock = locks.make_lock("obs.defer")
_DEFER_CAP = 256


def defer(fn) -> None:
    """Queue a telemetry finalization callback — typically the host fetch
    of a tiny device tensor an instrumented hot path just launched — to
    run at :func:`flush` time, so no metric sync lands in the hot path
    itself. Bounded: past ``_DEFER_CAP`` pending callbacks the queue
    drains inline so a long-running serving process can't grow it."""
    with _deferred_lock:
        _deferred.append(fn)
        drain = _deferred[:] if len(_deferred) > _DEFER_CAP else None
        if drain is not None:
            _deferred.clear()
    if drain is not None:
        _run_deferred(drain)


def _run_deferred(fns) -> None:
    for fn in fns:
        try:
            fn()
        except Exception:
            # telemetry finalization must never fail the run it observed
            pass


def flush() -> None:
    """Run every pending deferred telemetry callback (``GET /metrics``
    calls this before it renders)."""
    with _deferred_lock:
        drain = _deferred[:]
        _deferred.clear()
    _run_deferred(drain)


def hard_sync(outputs) -> None:
    from kdtree_tpu_torch.obs.spans import hard_sync as _hs

    _hs(outputs)


def span(name: str, **kw):
    from kdtree_tpu_torch.obs.spans import span as _span

    return _span(name, **kw)


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "enabled",
    "set_enabled",
    "hard_sync",
    "span",
    "defer",
    "flush",
]
