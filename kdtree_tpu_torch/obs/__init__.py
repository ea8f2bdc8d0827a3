"""kdtree_tpu_torch.obs — the telemetry the serving stack reports through.

The port of the part of ``kdtree_tpu/obs`` that serving calls:

- :mod:`~kdtree_tpu_torch.obs.registry` — process-wide counters / gauges /
  fixed-bucket histograms, cheap enough for host-side hot paths;
- :mod:`~kdtree_tpu_torch.obs.spans` — nested, thread-safe span timing,
  named in any running ``torch.profiler`` trace, with the
  :func:`hard_sync` completion barrier;
- :mod:`~kdtree_tpu_torch.obs.torchrt` — PyTorch runtime telemetry: the
  platform and device that ran, device init, device memory, and the
  count of CUDA kernel builds at first use;
- :mod:`~kdtree_tpu_torch.obs.export` — JSONL event log (size-capped),
  one-shot JSON report (``stats`` renders it), the Prometheus text
  exposition (``GET /metrics``);
- :mod:`~kdtree_tpu_torch.obs.flight` — the always-on flight recorder;
- :mod:`~kdtree_tpu_torch.obs.profile` — ``torch.profiler`` capture
  windows (one at a time, process-wide, every thread);
- :mod:`~kdtree_tpu_torch.obs.timeline` — the Chrome-trace parser joining
  the card's kernel slices back to host spans (``profile`` renders it);
- :mod:`~kdtree_tpu_torch.obs.trace` — distributed traces: propagated
  context, tail-sampled buffers, assembly (``GET /debug/trace``);
- :mod:`~kdtree_tpu_torch.obs.costs` — the per-request cost ledger, the
  profiling duty cycle and the capacity-headroom model
  (``GET /debug/costs``);
- :mod:`~kdtree_tpu_torch.obs.history` — the metric-history ring;
- :mod:`~kdtree_tpu_torch.obs.slo` — declarative SLOs with multi-window
  burn rates.

Two cost tiers, as in the reference: host-side counters, gauges and spans
are always on; anything that costs a device reduction or a host fetch is
gated on :func:`enabled` (``KDTREE_TPU_METRICS=1``, the CLI's
``--metrics-out``, or :func:`set_enabled`) and finalised through
:func:`defer` / :func:`flush`. A profiler capture is neither: it runs only
inside an explicit window.
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


def configure(
    metrics_out: Optional[str] = None,
    jsonl: Optional[str] = None,
    install_runtime: bool = True,
    enable: bool = True,
    jsonl_max_bytes: Optional[int] = None,
    device=None,
) -> MetricsRegistry:
    """One-call setup for a telemetry-producing run: flips the device-side
    gate, records the runtime facts of ``device``
    (:func:`kdtree_tpu_torch.obs.torchrt.install`), and points the JSONL
    event log somewhere (size-capped — ``jsonl_max_bytes`` overrides the
    ``KDTREE_TPU_JSONL_MAX_BYTES`` budget). ``metrics_out`` is recorded
    for :func:`finalize` to write the report to."""
    global _metrics_out_path
    if enable:
        set_enabled(True)
    if install_runtime:
        from kdtree_tpu_torch.obs import torchrt

        torchrt.install(device)
    if jsonl is not None:
        from kdtree_tpu_torch.obs import export

        export.configure_jsonl(jsonl, max_bytes=jsonl_max_bytes)
    if metrics_out is not None:
        _metrics_out_path = metrics_out
    return get_registry()


_metrics_out_path: Optional[str] = None


def finalize(extra: Optional[dict] = None) -> Optional[dict]:
    """Write the one-shot report to the path ``configure(metrics_out=...)``
    recorded (no-op without one). Returns the report dict if written."""
    if _metrics_out_path is None:
        return None
    from kdtree_tpu_torch.obs import export

    return export.write_report(_metrics_out_path, extra=extra)


def sidecar_path(default_path: str) -> Optional[str]:
    """Resolve a script's telemetry-sidecar destination from the shared
    ``KDTREE_TPU_METRICS_OUT`` contract: the env var overrides
    ``default_path``, and ``""``/``0``/``none``/``off`` disables telemetry
    entirely (returns None)."""
    path = os.environ.get("KDTREE_TPU_METRICS_OUT", default_path)
    return None if path.lower() in ("", "0", "none", "off") else path


def finalize_guarded(extra: Optional[dict] = None) -> Optional[dict]:
    """Device-memory snapshot + :func:`finalize`, never raising — failed
    telemetry must not turn a successful run into a crash. Returns the
    report dict, or None if disabled or the write/snapshot failed (the
    failure is reported on stderr)."""
    import sys

    try:
        from kdtree_tpu_torch.obs import torchrt

        torchrt.snapshot_device_memory()
        return finalize(extra=extra)
    except Exception as e:
        print(f"telemetry sidecar write failed: {e!r}", file=sys.stderr)
        return None


def count_build(engine: str, points: int) -> None:
    """Record one index build of ``points`` rows by ``engine`` — the shared
    domain-counter shape every build entry point uses."""
    reg = get_registry()
    reg.counter("kdtree_builds_total", labels={"engine": engine}).inc()
    reg.counter("kdtree_build_points_total", labels={"engine": engine}).inc(points)


def count_query(engine: str, rows: int) -> None:
    """Record one query call of ``rows`` query rows by ``engine``."""
    reg = get_registry()
    reg.counter("kdtree_queries_total", labels={"engine": engine}).inc()
    reg.counter("kdtree_query_rows_total", labels={"engine": engine}).inc(rows)


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
    "configure",
    "finalize",
    "sidecar_path",
    "finalize_guarded",
    "count_build",
    "count_query",
    "hard_sync",
    "span",
    "defer",
    "flush",
]
