"""Admission control: the bounded queue between HTTP handlers and the
batch worker.

Load shedding happens HERE, at the door, not in the engine: a query row
admitted past capacity would not fail — it would wait, and a queue that
only ever waits converts overload into unbounded latency for every
client instead of a crisp 429 for the marginal one. Depth is counted in
query ROWS (the unit of engine work), not requests, so one 1024-row
request and 1024 singletons cost the same admission budget.

The handshake: each handler thread submits a :class:`PendingRequest`
and blocks on its event; the batch worker pops, coalesces, dispatches,
and fulfills. Deadlines are carried as absolute monotonic times — the
worker checks them at dispatch, where the remedy (the brute-force
degradation path, ``MutableEngine.fallback_knn``) is cheap to apply
per straggler.

The port of ``kdtree_tpu/serve/admission.py`` on the k-NN path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.utils import locks
from kdtree_tpu_torch.obs import flight

# a shed or two is normal backpressure; this many sheds inside one second
# is an incident — the flight recorder dumps its ring once per burst so
# the timeline that LED INTO the overload survives the overload
SHED_BURST_THRESHOLD = 10
SHED_BURST_WINDOW_S = 1.0

# Retry-After derivation (docs/SERVING.md): the drain-rate estimate
# averages over this many recent worker pops, and the advised wait is
# clamped so a stalled worker advises "a while", never "an hour"
_DRAIN_SAMPLES = 64
RETRY_AFTER_MIN_S = 1.0
RETRY_AFTER_MAX_S = 30.0


class QueueFullError(Exception):
    """Admission refused: queue depth at capacity (HTTP 429)."""


class QueueClosedError(Exception):
    """Admission refused: the server is shutting down (HTTP 503)."""


class PendingRequest:
    """One in-flight k-NN request: inputs, the completion event the
    handler thread waits on, and the result slots the worker fills."""

    __slots__ = (
        "queries", "k", "deadline", "enqueued_at", "dispatched_at",
        "event", "d2", "ids", "degraded", "error", "trace_id",
    )

    def __init__(
        self, queries: np.ndarray, k: int,
        deadline: Optional[float] = None,
        trace_id: str = "",
    ) -> None:
        self.queries = queries  # f32[q, D], validated by the handler
        self.k = k
        self.deadline = deadline  # absolute time.monotonic(), or None
        # per-request trace id (client X-Request-Id or server-generated):
        # threads admission -> batcher -> dispatch, so one slow request's
        # queue/coalesce/device decomposition can be pulled from the
        # flight ring by id
        self.trace_id = trace_id
        self.enqueued_at = time.monotonic()
        self.dispatched_at: Optional[float] = None
        self.event = threading.Event()
        self.d2: Optional[np.ndarray] = None
        self.ids: Optional[np.ndarray] = None
        self.degraded: Optional[str] = None  # None | "deadline" | "oversized"
        self.error: Optional[str] = None

    @property
    def rows(self) -> int:
        return int(self.queries.shape[0])

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline

    def fulfill(
        self, d2: np.ndarray, ids: np.ndarray,
        degraded: Optional[str] = None,
    ) -> None:
        self.d2, self.ids, self.degraded = d2, ids, degraded
        self.event.set()

    def fail(self, message: str) -> None:
        self.error = message
        self.event.set()


class AdmissionQueue:
    """Bounded FIFO of :class:`PendingRequest` with row-counted depth.

    ``submit`` is the admission gate (raises :class:`QueueFullError` /
    :class:`QueueClosedError`); ``pop_wait`` feeds the batch
    worker; ``push_front`` returns an over-coalesced pop without losing
    FIFO order. Closing stops admission but NOT draining — accepted
    requests are a promise the shutdown path keeps.
    """

    def __init__(self, max_rows: int) -> None:
        if max_rows < 1:
            raise ValueError(f"queue depth must be >= 1 rows, got {max_rows}")
        self.max_rows = int(max_rows)
        self._items: deque = deque()
        self._rows = 0
        self._cond = locks.make_condition("serve.admission")
        self._closed = False
        # recent worker pops as (monotonic time, rows): the measured
        # drain rate behind the 429 Retry-After header
        self._pops: deque = deque(maxlen=_DRAIN_SAMPLES)
        reg = obs.get_registry()
        self._depth = reg.gauge("kdtree_serve_queue_depth")
        self._shed = reg.counter("kdtree_serve_shed_total")
        self._shed_burst = flight.BurstDetector(
            SHED_BURST_THRESHOLD, SHED_BURST_WINDOW_S
        )

    def _count_shed(self, rows: int, depth: int, trace_id: str = "") -> None:
        """Shed accounting shared by submit/reserve — called OUTSIDE the
        queue lock (the burst dump does file I/O, which must never block
        admissions): counter + flight event, and a rate-limited ring
        dump when sheds burst."""
        self._shed.inc()
        flight.record("serve.shed", rows=rows, trace=trace_id,
                      depth=depth, budget=self.max_rows)
        if self._shed_burst.mark():
            flight.auto_dump("serve-shed-burst")

    @property
    def rows(self) -> int:
        return self._rows

    def submit(self, req: PendingRequest) -> None:
        with self._cond:
            if self._closed:
                raise QueueClosedError("server is shutting down")
            depth = self._rows
            if depth + req.rows <= self.max_rows:
                self._items.append(req)
                self._rows += req.rows
                self._depth.set(self._rows)
                self._cond.notify()
                flight.record("serve.admit", rows=req.rows,
                              trace=req.trace_id, depth=self._rows)
                return
        self._count_shed(req.rows, depth, req.trace_id)
        raise QueueFullError(
            f"admission queue at capacity ({depth}/{self.max_rows} rows)"
        )

    def reserve(self, rows: int, trace_id: str = "") -> int:
        """Charge ``rows`` against the admission budget WITHOUT enqueueing
        — the oversized degradation path runs outside the batch queue but
        must not escape shedding: unbounded concurrent brute-force scans
        are exactly the overload the 429 gate exists to refuse. The charge
        is clamped to the whole budget so a single request larger than the
        budget is still admissible on an idle server (taking everything).
        Returns the charged amount; pass it back to :meth:`release`."""
        with self._cond:
            if self._closed:
                raise QueueClosedError("server is shutting down")
            depth = self._rows
            charge = min(int(rows), self.max_rows)
            if depth + charge <= self.max_rows:
                self._rows += charge
                self._depth.set(self._rows)
                return charge
        self._count_shed(rows, depth, trace_id)
        raise QueueFullError(
            f"admission queue at capacity ({depth}/{self.max_rows} rows)"
        )

    def release(self, charge: int) -> None:
        """Return a :meth:`reserve` charge to the budget."""
        with self._cond:
            self._rows -= charge
            self._depth.set(self._rows)
            self._cond.notify_all()

    def _note_pop(self, rows: int, now: Optional[float] = None) -> None:
        """Record one worker pop for the drain-rate estimate (caller
        holds the lock)."""
        self._pops.append(
            (now if now is not None else time.monotonic(), rows)
        )

    def drain_rate(self, now: Optional[float] = None) -> float:
        """Measured drain rate in rows/second over the recent pops;
        0.0 when there is not enough history to estimate."""
        with self._cond:
            pops = list(self._pops)
        if len(pops) < 2:
            return 0.0
        now = now if now is not None else time.monotonic()
        span = now - pops[0][0]
        if span <= 0:
            return 0.0
        return sum(r for _, r in pops) / span

    def retry_after_s(self, rows: int, now: Optional[float] = None) -> float:
        """How long a just-shed ``rows``-row request should wait before
        retrying: the time the measured drain rate needs to free enough
        budget, clamped to [RETRY_AFTER_MIN_S, RETRY_AFTER_MAX_S]. With
        no drain history (cold start, stalled worker) the floor applies —
        an honest "soon, probably" beats a made-up number."""
        with self._cond:
            depth = self._rows
        excess = depth + min(int(rows), self.max_rows) - self.max_rows
        if excess <= 0:
            return RETRY_AFTER_MIN_S
        rate = self.drain_rate(now)
        if rate <= 0:
            return RETRY_AFTER_MIN_S
        return min(max(excess / rate, RETRY_AFTER_MIN_S), RETRY_AFTER_MAX_S)

    def pop_wait(self, timeout: float) -> Optional[PendingRequest]:
        """Pop the oldest request, waiting up to ``timeout`` seconds for
        one to arrive; None on timeout (or an empty closed queue)."""
        end = time.monotonic() + timeout
        with self._cond:
            while not self._items:
                remaining = end - time.monotonic()
                if remaining <= 0 or (self._closed and not self._items):
                    return None
                self._cond.wait(remaining)
            req = self._items.popleft()
            self._rows -= req.rows
            self._depth.set(self._rows)
            self._note_pop(req.rows)
            return req

    def push_front(self, req: PendingRequest) -> None:
        """Return a popped request to the head (it did not fit the batch
        being assembled). Never sheds: the rows were already admitted."""
        with self._cond:
            self._items.appendleft(req)
            self._rows += req.rows
            self._depth.set(self._rows)
            self._cond.notify()

    def close(self) -> None:
        """Stop admitting; wake any waiting worker so it can drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
