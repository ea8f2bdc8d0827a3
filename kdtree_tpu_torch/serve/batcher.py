"""Micro-batching: coalesce concurrent requests into pow2-bucket batches.

The port of ``kdtree_tpu/serve/batcher.py`` on the exact k-NN path. The
tiled engine's unit of efficiency is the batch, so the worker here does
two things at once:

1. **Coalesce**: pop the oldest admitted request, then keep absorbing
   arrivals until ``max_batch`` rows or ``max_wait_ms`` elapse —
   concurrency is converted into batch width instead of queue depth.
2. **Quantize**: pad the coalesced rows up to the next power of two
   (floor ``MIN_BUCKET``), so the steady state cycles through the handful
   of shapes the warmup ladder already ran.

Requests whose deadline expired while queued are split off and answered
through the engine's brute-force degradation path (exact, flagged
``degraded``), so one slow burst degrades its stragglers instead of
erroring them. Each request gets its own k columns of the batch's
answer. The verb batches (ROADMAP item 11) and the recall dial, ladder
and online recall sampler (item 12) are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.obs import flight
from kdtree_tpu_torch.serve.admission import AdmissionQueue, PendingRequest
from kdtree_tpu_torch.serve.engine import MIN_BUCKET, _pow2_ceil, batch_bucket
from kdtree_tpu_torch.serve.faults import SITE_BATCH

DEFAULT_MAX_BATCH = 1024
DEFAULT_MAX_WAIT_MS = 2.0

# serving latencies are ms-scale; the generic span buckets start too coarse
_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)
_BATCH_ROW_BUCKETS = tuple(float(1 << i) for i in range(13))  # 1..4096
_BATCH_REQ_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

__all__ = ["DEFAULT_MAX_BATCH", "DEFAULT_MAX_WAIT_MS", "MIN_BUCKET",
           "MicroBatcher", "batch_bucket"]


class MicroBatcher:
    """The batch worker: one non-daemon thread draining an
    :class:`~kdtree_tpu_torch.serve.admission.AdmissionQueue` through the
    serving engine."""

    def __init__(
        self,
        engine,
        queue: AdmissionQueue,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
        faults=None,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.queue = queue
        # the server's fault set: the "batch" site injects dispatch
        # latency/errors
        self.faults = faults
        # pow2: batch_bucket can never exceed it for an admitted row count
        self.max_batch = _pow2_ceil(max_batch)
        self.max_wait = max(float(max_wait_ms), 0.0) / 1e3
        self._thread: Optional[threading.Thread] = None
        reg = obs.get_registry()
        self._lat = {
            phase: reg.histogram(
                "kdtree_serve_request_seconds", buckets=_LATENCY_BUCKETS,
                labels={"phase": phase},
            )
            for phase in ("queue", "dispatch", "total")
        }
        self._batch_rows = reg.histogram(
            "kdtree_serve_batch_rows", buckets=_BATCH_ROW_BUCKETS
        )
        self._batch_reqs = reg.histogram(
            "kdtree_serve_batch_requests", buckets=_BATCH_REQ_BUCKETS
        )
        self._batches = {
            temp: reg.counter(
                "kdtree_serve_batches_total", labels={"plan_cache": temp}
            )
            for temp in ("warm", "cold")
        }
        self._deadline = reg.counter("kdtree_serve_deadline_timeouts_total")
        self._degraded = {
            reason: reg.counter(
                "kdtree_serve_degraded_total", labels={"reason": reason}
            )
            for reason in ("deadline", "oversized")
        }
        self._errors = reg.counter("kdtree_serve_batch_errors_total")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._worker, name="kdtree-serve-batcher"
        )
        self._thread.start()

    def stop(self) -> None:
        """Graceful: close admission, drain every accepted request, join.
        Accepted requests always get an answer — shedding happens at the
        admission gate or not at all."""
        self.queue.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- worker -------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            first = self.queue.pop_wait(0.05)
            if first is None:
                # exit gates on the QUEUE's closed flag, not a separate
                # stop flag: close() happens-before any post-close submit
                # raises, so a request this check can't see was never
                # admitted
                if self.queue.closed and self.queue.rows == 0:
                    return
                continue
            self._dispatch(self._collect(first))

    def _collect(self, first: PendingRequest) -> List[PendingRequest]:
        """Absorb arrivals behind ``first`` until the batch is full or
        ``max_wait`` has elapsed since coalescing began."""
        batch = [first]
        rows = first.rows
        t_end = time.monotonic() + self.max_wait
        while rows < self.max_batch:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break
            nxt = self.queue.pop_wait(remaining)
            if nxt is None:
                break
            if rows + nxt.rows > self.max_batch:
                self.queue.push_front(nxt)  # keeps FIFO; next batch leads with it
                break
            batch.append(nxt)
            rows += nxt.rows
        return batch

    def _dispatch(self, batch: List[PendingRequest]) -> None:
        if self.faults is not None:
            # the "batch" injection site: latency/hang are served inside
            # fire(); act-kinds fail the whole batch like an engine error
            act = self.faults.fire(SITE_BATCH)
            if act is not None:
                self._errors.inc()
                for r in batch:
                    r.fail("injected batch fault (serve/faults.py)")
                return
        now = time.monotonic()
        for req in batch:
            req.dispatched_at = now
            self._lat["queue"].observe(now - req.enqueued_at)
        live = [r for r in batch if not r.expired(now)]
        late = [r for r in batch if r.expired(now)]
        if live:
            self._run_batch(live)
        for req in late:
            self._deadline.inc()
            self._run_fallback(req, reason="deadline")

    def _run_batch(self, live: List[PendingRequest]) -> None:
        rows = sum(r.rows for r in live)
        bucket = batch_bucket(rows, self.max_batch)
        q = np.concatenate([r.queries for r in live], axis=0)
        if bucket > rows:
            # repeat the last row: harmless real coordinates, results are
            # sliced away — same trick as the tiled engine's own qpad
            pad = np.broadcast_to(q[-1], (bucket - rows, q.shape[1]))
            q = np.concatenate([q, pad], axis=0)
        try:
            d2, ids, source = self.engine.knn_batch(q)
        except Exception as e:
            self._errors.inc()
            flight.record("serve.batch_error", rows=rows,
                          requests=len(live), error=repr(e)[:200],
                          traces=[r.trace_id for r in live])
            flight.auto_dump("serve-error")
            for r in live:
                r.fail(f"batch dispatch failed: {e!r}")
            return
        done = time.monotonic()
        self._batches["warm" if source == "warm" else "cold"].inc()
        self._batch_rows.observe(rows)
        self._batch_reqs.observe(len(live))
        flight.record(
            "serve.batch", rows=rows, bucket=bucket, requests=len(live),
            plan=source, gear="exact",
            dispatch_ms=round((done - live[0].dispatched_at) * 1e3, 3),
            # which index generation ANSWERED this batch: an epoch swap
            # between two batches shows in the ring as this number stepping
            epoch=getattr(self.engine, "last_answer_epoch", 0),
            traces=[r.trace_id for r in live],
        )
        off = 0
        for r in live:
            self._lat["dispatch"].observe(done - r.dispatched_at)
            self._lat["total"].observe(done - r.enqueued_at,
                                       exemplar=r.trace_id)
            # per-request decomposition, by trace id: queue (admit ->
            # dispatch) vs device (dispatch -> done)
            flight.record(
                "serve.request", trace=r.trace_id, rows=r.rows,
                queue_ms=round((r.dispatched_at - r.enqueued_at) * 1e3, 3),
                device_ms=round((done - r.dispatched_at) * 1e3, 3),
                total_ms=round((done - r.enqueued_at) * 1e3, 3),
            )
            # fulfill LAST: it wakes the waiting handler thread, and a
            # client that reads its answer and immediately snapshots the
            # ring must find this request's decomposition already there
            r.fulfill(d2[off:off + r.rows, :r.k], ids[off:off + r.rows, :r.k])
            off += r.rows

    def _run_fallback(self, req: PendingRequest, reason: str) -> None:
        """Answer one straggler through the exact brute-force path."""
        self._degraded[reason].inc()
        try:
            d2, ids = self.engine.fallback_knn(req.queries, req.k)
        except Exception as e:
            self._errors.inc()
            flight.record("serve.batch_error", rows=req.rows, requests=1,
                          error=repr(e)[:200], traces=[req.trace_id])
            flight.auto_dump("serve-error")
            req.fail(f"fallback dispatch failed: {e!r}")
            return
        done = time.monotonic()
        if req.dispatched_at is not None:
            self._lat["dispatch"].observe(done - req.dispatched_at)
        self._lat["total"].observe(done - req.enqueued_at,
                                   exemplar=req.trace_id)
        flight.record(
            "serve.request", trace=req.trace_id, rows=req.rows,
            degraded=reason,
            total_ms=round((done - req.enqueued_at) * 1e3, 3),
        )
        # fulfill last, same response-implies-ring-event ordering as the
        # batch path above
        req.fulfill(d2, ids, degraded=reason)
