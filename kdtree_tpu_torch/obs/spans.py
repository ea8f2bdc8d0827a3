"""Nested span timing, named in the profiler, with the completion barrier.

The port of ``kdtree_tpu/obs/spans.py``. ``span(name)`` times a region of
host code, names it in any running ``torch.profiler`` trace
(``record_function``), and — unless ``sync=False`` — waits for the device
tensors the caller appends to the yielded handle before the clock stops
(:func:`hard_sync`: ``torch.cuda.synchronize()`` plus a one-element host
fetch). Serving spans pass ``sync=False``: a synchronize on the batch
worker would stall every other thread's device work with it.

Spans nest per thread (a thread-local stack); a span's recorded path is
``parent/child``. Every completed span lands in the registry histogram
``kdtree_span_seconds{span=...}``, in the flight ring and, when a JSONL
event log is configured, as one ``{"type": "span", ...}`` event line.
Under an active distributed-trace context (:mod:`~kdtree_tpu_torch.obs.
trace`) a span gets a span id, is parented to the innermost open span or
to the context's span, and is recorded in the trace buffer.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional

import torch

from kdtree_tpu_torch.obs.registry import MetricsRegistry, get_registry
from kdtree_tpu_torch.utils.timing import hard_sync

_tls = threading.local()

# span durations range from sub-ms counter flushes to multi-minute
# sections; one shared log-spaced bucket set keeps every span family
# comparable in the exposition output
SPAN_TIME_BUCKETS = (
    0.0001, 0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 300.0,
)

__all__ = ["Span", "span", "current_span", "hard_sync", "SPAN_TIME_BUCKETS"]


class Span(list):
    """The handle a ``span(...)`` block yields: a list — append device
    outputs to have them synced before the span's clock stops.
    ``duration`` is set on exit; ``path`` is the slash-joined nesting
    path. Under an active trace context, ``span_id``/``parent_id`` link
    the completion into the trace buffer and the flight ring."""

    def __init__(self, name: str, path: str) -> None:
        super().__init__()
        self.name = name
        self.path = path
        self.duration: Optional[float] = None
        self.span_id: Optional[str] = None
        self.parent_id: Optional[str] = None


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


@contextlib.contextmanager
def span(
    name: str,
    registry: Optional[MetricsRegistry] = None,
    sync: bool = True,
    **attrs,
) -> Iterator[Span]:
    """Time a named region; nested calls record ``parent/child`` paths.

    ``sync=False`` skips the exit barrier for regions that end with work
    still in flight — the duration then covers launching, not execution,
    and the flight event records ``synced: false``."""
    from kdtree_tpu_torch.obs import trace as trace_mod

    reg = registry or get_registry()
    stack = _stack()
    path = "/".join([s.name for s in stack] + [name])
    sp = Span(name, path)
    # under an active request context this span is a causally linked
    # node: parented to the innermost open span on this thread, or to the
    # propagated context's span at the top of the stack
    tctx = trace_mod.current() if trace_mod.enabled() else None
    if tctx is not None:
        sp.span_id = trace_mod.new_span_id()
        sp.parent_id = (stack[-1].span_id if stack and stack[-1].span_id
                        else tctx.span_id)
    stack.append(sp)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            try:
                yield sp
            finally:
                # inside the profiler range, so a trace attributes the wait
                # to this span; it may raise (a deferred device error), so
                # the pop below lives in the outer finally
                if sync and len(sp):
                    hard_sync(list(sp))
    finally:
        sp.duration = time.perf_counter() - t0
        if stack and stack[-1] is sp:
            stack.pop()
        reg.histogram(
            "kdtree_span_seconds", buckets=SPAN_TIME_BUCKETS,
            labels={"span": path},
        ).observe(sp.duration)
        from kdtree_tpu_torch.obs import export, flight

        export.emit_event({
            "type": "span", "span": path, "seconds": sp.duration,
            "synced": bool(sync), **attrs,
        })
        link = {}
        if tctx is not None:
            link = {"trace_id": tctx.trace_id, "span_id": sp.span_id,
                    "parent_id": sp.parent_id}
            end_unix = time.time()
            trace_mod.record_span(
                tctx.trace_id, sp.span_id, sp.parent_id or "", path,
                end_unix - sp.duration, end_unix, **attrs,
            )
        flight.record("span", span=path, seconds=sp.duration,
                      synced=bool(sync), **link, **attrs)


def current_span() -> Optional[Span]:
    """The innermost open span on this thread, if any."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None

