"""Micro-batching: coalesce concurrent requests into pow2-bucket batches.

The port of ``kdtree_tpu/serve/batcher.py``: k-NN and the query verbs,
with the recall dial. The tiled engine's unit of efficiency is the batch,
so the worker here does two things at once:

1. **Coalesce**: pop the oldest admitted request, then keep absorbing
   arrivals of the same verb and recall target until ``max_batch`` rows
   or ``max_wait_ms`` elapse — concurrency is converted into batch width
   instead of queue depth. One batch is one verb and one gear: a mixed
   batch has no single engine call (the per-query radii and boxes ride in
   each request).
2. **Quantize**: pad the coalesced rows up to the next power of two
   (floor ``MIN_BUCKET``), so the steady state cycles through the handful
   of shapes the warmup ladder already ran.

Requests whose deadline expired while queued are split off and answered
through the engine's brute-force degradation path (exact, flagged
``degraded``), so one slow burst degrades its stragglers instead of
erroring them. Each k-NN request gets its own k columns of the batch's
answer, each verb request its rows of counts (and hits).

The recall dial: a batch runs at the MINIMUM of the degradation ladder's
gear target and its requests' ``recall_target`` (:mod:`kdtree_tpu_torch.
approx`). A ladder-forced approximation is flagged ``degraded``; a
client-requested one is a kept contract, echoed as its ``gear`` only. At
the ladder's floor gear every request goes through the brute-force path.
The online recall sampler re-answers every Nth approximate batch exactly
and publishes the measured recall as ``kdtree_recall_sampled``.

Every answered request is attributed a cost vector in the server's
:class:`~kdtree_tpu_torch.obs.costs.CostLedger`: its row share of the
batch's measured dispatch span (the shares sum exactly to the span), its
queue wait, rows, planned visits and overflow retries; the recall
sampler's shadow re-answers go to the ledger's maintenance side. Under a
request's trace context (:mod:`kdtree_tpu_torch.obs.trace`) the worker
records its ``serve/queue`` and ``serve/dispatch`` spans, and the batch
runs under the coalescing leader's context so engine spans nest there.

Profiler capture windows (``POST /debug/profile``, the duty cycle) start
and stop on the worker's own thread, between batches
(:meth:`MicroBatcher.capture_for`): the thread that launches every
kernel is the thread that starts and stops the profiler. Windows opened
from another thread while the worker launched kernels crashed the
process now and then (a SIGSEGV in a native thread; 1 of 21 on an H100
under 4 clients, ``chip_smoke.py --profile-stress``); none of 30 opened
on the worker's thread did. The asking thread writes the trace. No batch
is dispatched while the profiler starts or stops, and the export holds
the GIL: a window pauses serving for their sum (``CaptureResult``'s
``start_seconds``/``stop_seconds``/``export_seconds``), seconds for the
process's first window, when CUPTI starts.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.obs import costs as costs_mod
from kdtree_tpu_torch.obs import flight
from kdtree_tpu_torch.obs import trace as trace_mod
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


class _CaptureRequest:
    """One capture window asked of the batch worker."""

    def __init__(self, seconds: float, log_dir: str) -> None:
        self.seconds = max(float(seconds), 0.0)
        self.log_dir = log_dir
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


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
        ladder=None,
        faults=None,
        recall_sample: float = 0.0,
        costs: Optional[costs_mod.CostLedger] = None,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.queue = queue
        # the degradation ladder whose gear caps every batch, and the
        # server's fault set (the "batch" site injects dispatch
        # latency/errors: the deterministic overload the ladder steps
        # down under)
        self.ladder = ladder
        self.faults = faults
        # pow2: batch_bucket can never exceed it for an admitted row count
        self.max_batch = _pow2_ceil(max_batch)
        self.max_wait = max(float(max_wait_ms), 0.0) / 1e3
        self._thread: Optional[threading.Thread] = None
        # the pending or open capture window (capture_for), and the
        # worker-side state of an open one: (its Window, deadline)
        self._capture_lock = threading.Lock()
        self._capture_req: Optional[_CaptureRequest] = None
        self._window: Optional[tuple] = None
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
            for reason in ("deadline", "oversized", "ladder",
                           "brute-deadline")
        }
        # requests by answering gear class, a bounded label set: the
        # precise target rides in the response's gear token
        self._by_gear = {
            gear: reg.counter(
                "kdtree_recall_requests_total", labels={"gear": gear}
            )
            for gear in ("exact", "approx", "brute-deadline")
        }
        self._errors = reg.counter("kdtree_serve_batch_errors_total")
        # the query verbs: request and batch-row accounting per verb
        # FAMILY — a bounded label set: the two count forms share the
        # "count" label, the geometry rides in the flight ring
        self._verb_requests = {
            v: reg.counter("kdtree_verb_requests_total",
                           labels={"verb": v})
            for v in ("radius", "range", "count")
        }
        self._verb_rows = {
            v: reg.histogram("kdtree_verb_batch_rows",
                             buckets=_BATCH_ROW_BUCKETS,
                             labels={"verb": v})
            for v in ("radius", "range", "count")
        }
        self._verb_truncated = {
            v: reg.counter("kdtree_verb_truncated_total",
                           labels={"verb": v})
            for v in ("radius", "range", "count")
        }
        self._verb_retries = reg.counter(
            "kdtree_verb_overflow_retries_total")
        # the online recall sampler: every Nth APPROXIMATE k-NN batch is
        # re-answered exactly and its measured recall@k published.
        # Deterministic every-Nth, so a seeded drill samples the same
        # batches; 0 disables (the default for in-process embedders; the
        # serve CLI arms it)
        self.recall_sample = max(float(recall_sample), 0.0)
        self._sample_every = (int(round(1.0 / self.recall_sample))
                              if self.recall_sample > 0 else 0)
        self._sample_tick = 0
        self._sampled_ewma: Optional[float] = None
        self._samples = reg.counter("kdtree_recall_samples_total")
        # the cost ledger; the server shares this instance so the HTTP
        # layer's byte counts land in the same class table
        self.costs = costs if costs is not None else costs_mod.CostLedger()

    def _attribute(self, live, verb, gear, forced, span_ms, visit_cap,
                   retries=0):
        """Amortize one dispatch's span over its members by row share;
        returns the per-member device_ms shares. Planned visits per row
        are the resolved visit cap of an approximate gear, every bucket
        of an exact one."""
        return self.costs.attribute_batch(
            verb=verb, gear=gear, span_ms=span_ms,
            members=[
                (r.rows, round((r.dispatched_at - r.enqueued_at) * 1e3, 3),
                 "degraded" if forced is not None else "ok")
                for r in live
            ],
            retries=retries,
            visits_per_row=int(visit_cap or self.engine.tree.num_buckets),
        )

    @staticmethod
    def _trace_phases(r, done, done_unix, dispatch_ctx, lead, **attrs):
        """A request's ``serve/queue`` (admit -> dispatch) and
        ``serve/dispatch`` (dispatch -> done) spans under its server-root
        span: monotonic deltas anchored to one wall-clock read. The
        leader's dispatch span keeps the id its engine spans nest under."""
        if r.trace_ctx is None:
            return
        ctx = r.trace_ctx
        trace_mod.record_span(
            ctx.trace_id, trace_mod.new_span_id(), ctx.span_id,
            "serve/queue",
            done_unix - (done - r.enqueued_at),
            done_unix - (done - r.dispatched_at),
            rows=r.rows,
        )
        trace_mod.record_span(
            ctx.trace_id,
            (dispatch_ctx.span_id if lead is r and dispatch_ctx is not None
             else trace_mod.new_span_id()),
            ctx.span_id, "serve/dispatch",
            done_unix - (done - r.dispatched_at), done_unix, **attrs,
        )

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
            self._service_capture()
            first = self.queue.pop_wait(0.05)
            if first is None:
                # exit gates on the QUEUE's closed flag, not a separate
                # stop flag: close() happens-before any post-close submit
                # raises, so a request this check can't see was never
                # admitted
                if self.queue.closed and self.queue.rows == 0:
                    self._service_capture(closing=True)
                    return
                continue
            self._dispatch(self._collect(first))

    # -- profiler capture windows --------------------------------------------

    def capture_for(self, seconds: float, log_dir: str):
        """A capture window of ``seconds`` over the serving process. The
        batch worker starts and stops the profiler on its own thread,
        between batches, while it keeps serving; this (the asking) thread
        waits, then writes the trace. Returns the closed
        :class:`~kdtree_tpu_torch.obs.profile.CaptureResult`. Raises
        :class:`~kdtree_tpu_torch.obs.profile.CaptureBusyError` when a
        window is already pending or open, and whatever the capture
        raised."""
        from kdtree_tpu_torch.obs.profile import CaptureBusyError

        req = _CaptureRequest(seconds, log_dir)
        with self._capture_lock:
            if self._capture_req is not None:
                raise CaptureBusyError(
                    "a profiler capture is already active in this process "
                    "(one capture at a time)")
            self._capture_req = req
        while not req.done.wait(0.5):
            if self._thread is None or not self._thread.is_alive():
                # the worker exited before it saw the request
                with self._capture_lock:
                    if self._capture_req is req:
                        self._capture_req = None
                raise RuntimeError("the batch worker is not running")
        if req.error is not None:
            raise req.error
        # the export is the window's longest step; it runs here, off the
        # worker (it holds the GIL all the same, so Python threads pause)
        return req.result.export()

    def _service_capture(self, closing: bool = False) -> None:
        """Between batches: open a requested window, or stop one whose
        time is up (or, with ``closing``, any open one: the worker is
        exiting) and hand it to the asking thread to export."""
        from kdtree_tpu_torch.obs import profile

        req = self._capture_req
        if req is None:
            return
        if self._window is None:
            if closing:
                self._finish_capture(req, error=RuntimeError(
                    "the server stopped before the capture window opened"))
                return
            try:
                window = profile.Window(req.log_dir, self.engine.tree.device)
            except Exception as e:
                self._finish_capture(req, error=e)
                return
            self._window = (window, time.monotonic() + req.seconds)
            return
        window, deadline = self._window
        if closing or time.monotonic() >= deadline:
            self._window = None
            try:
                window.stop()
            except Exception as e:
                self._finish_capture(req, error=e)
                return
            self._finish_capture(req, result=window)

    def _finish_capture(self, req, result=None, error=None) -> None:
        req.result, req.error = result, error
        with self._capture_lock:
            self._capture_req = None
        req.done.set()

    def _collect(self, first: PendingRequest) -> List[PendingRequest]:
        """Absorb arrivals behind ``first`` until the batch is full or
        ``max_wait`` has elapsed since coalescing began. Only requests
        sharing ``first``'s (verb, recall target) join: one batch = one
        dispatch kind and one gear."""
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
            if rows + nxt.rows > self.max_batch or \
                    nxt.recall_target != first.recall_target or \
                    nxt.verb != first.verb:
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
            spec = self.ladder.spec() if self.ladder is not None else None
            if spec is not None and spec.brute:
                # the ladder's floor gear: every request through the exact
                # brute-force path
                for req in live:
                    self._run_fallback(req, reason="brute-deadline")
            elif live[0].verb != "knn":
                self._run_verb_batch(live, spec)
            else:
                self._run_batch(live, spec)
        for req in late:
            self._deadline.inc()
            self._run_fallback(req, reason="deadline")

    def _account_gear(self, live, effective, ladder_t):
        """Count a batch that ran at ``effective`` by the gear that actually
        ANSWERED (a target can resolve to the exact run when its cap covers
        every bucket) and return (gear token, degraded flag, visit cap). A
        batch the LADDER pushed below what its requests asked is degraded;
        a client-requested target is a kept contract."""
        visit_cap = getattr(self.engine, "last_visit_cap", None)
        gear = forced = None
        req_t = live[0].recall_target
        if effective is not None and visit_cap is not None:
            gear = f"approx:{effective:g}"
            if ladder_t is not None and (req_t is None or ladder_t < req_t):
                forced = gear
                self._degraded["ladder"].inc(len(live))
        self._by_gear["approx" if gear else "exact"].inc(len(live))
        if self.ladder is not None and forced is not None:
            # the ladder gear's promise refined by the measured
            # calibration — for ladder-forced batches only: a client's
            # low target must not move the served-recall SLO's gauge
            self.ladder.engaged(getattr(self.engine, "last_recall_estimate",
                                        1.0))
        return gear, forced, visit_cap

    @staticmethod
    def _effective(live, spec):
        """(effective target, ladder target): the minimum of what the
        ladder caps and what the gear-homogeneous batch asked; None is
        exact."""
        ladder_t = spec.recall_target if spec is not None else None
        asked = [t for t in (ladder_t, live[0].recall_target) if t is not None]
        return (min(asked) if asked else None), ladder_t

    def _run_batch(self, live: List[PendingRequest], spec=None) -> None:
        rows = sum(r.rows for r in live)
        bucket = batch_bucket(rows, self.max_batch)
        q = np.concatenate([r.queries for r in live], axis=0)
        if bucket > rows:
            # repeat the last row: harmless real coordinates, results are
            # sliced away — same trick as the tiled engine's own qpad
            pad = np.broadcast_to(q[-1], (bucket - rows, q.shape[1]))
            q = np.concatenate([q, pad], axis=0)
        effective, ladder_t = self._effective(live, spec)
        # the batch's device work runs under the COALESCING LEADER's trace
        # context (engine spans can parent under one trace only)
        lead = next((r for r in live if r.trace_ctx is not None), None)
        dispatch_ctx = lead.trace_ctx.child() if lead is not None else None
        try:
            with trace_mod.active(dispatch_ctx):
                if effective is None:
                    d2, ids, source = self.engine.knn_batch(q)
                else:
                    d2, ids, source = self.engine.knn_batch(
                        q, recall_target=effective)
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
        gear, forced, visit_cap = self._account_gear(live, effective, ladder_t)
        self._batches["warm" if source == "warm" else "cold"].inc()
        self._batch_rows.observe(rows)
        self._batch_reqs.observe(len(live))
        flight.record(
            "serve.batch", rows=rows, bucket=bucket, requests=len(live),
            plan=source, gear=gear or "exact", visit_cap=visit_cap,
            dispatch_ms=round((done - live[0].dispatched_at) * 1e3, 3),
            # which index generation ANSWERED this batch: an epoch swap
            # between two batches shows in the ring as this number stepping
            epoch=getattr(self.engine, "last_answer_epoch", 0),
            traces=[r.trace_id for r in live],
        )
        shares = self._attribute(
            live, "knn", gear, forced,
            round((done - live[0].dispatched_at) * 1e3, 3), visit_cap)
        done_unix = time.time()
        off = 0
        for r, share in zip(live, shares):
            self._lat["dispatch"].observe(done - r.dispatched_at)
            self._lat["total"].observe(done - r.enqueued_at,
                                       exemplar=r.trace_id)
            self._trace_phases(r, done, done_unix, dispatch_ctx, lead,
                               rows=rows, bucket=bucket,
                               coalesced=len(live), plan=source,
                               gear=gear or "exact")
            # per-request decomposition, by trace id: queue (admit ->
            # dispatch) vs device (dispatch -> done, the wait) and the
            # request's amortized share of the span (its cost)
            flight.record(
                "serve.request", trace=r.trace_id, rows=r.rows,
                queue_ms=round((r.dispatched_at - r.enqueued_at) * 1e3, 3),
                device_ms=round((done - r.dispatched_at) * 1e3, 3),
                device_share_ms=share,
                total_ms=round((done - r.enqueued_at) * 1e3, 3),
            )
            # fulfill LAST: it wakes the waiting handler thread, and a
            # client that reads its answer and immediately snapshots the
            # ring must find this request's decomposition already there
            r.fulfill(d2[off:off + r.rows, :r.k],
                      ids[off:off + r.rows, :r.k],
                      degraded=forced, gear=gear)
            off += r.rows
        if visit_cap is not None and self._sample_every:
            # shadow-sample AFTER the answers left: the exact re-answer
            # delays the next batch by one dispatch, never the requests
            # it measures
            self._sample_tick += 1
            if self._sample_tick >= self._sample_every:
                self._sample_tick = 0
                self._shadow_sample(
                    q, rows, ids,
                    getattr(self.engine, "last_recall_estimate", 1.0))

    def _shadow_sample(self, q: np.ndarray, rows: int,
                       approx_ids: np.ndarray, estimate: float) -> None:
        """One online recall sample: re-answer the (padded) batch exactly
        and publish the measured recall@k of the approximate answer that
        served, as an EWMA (alpha 0.3), so one small batch's quantized
        recall does not whipsaw the SLO. The gauge is registered lazily:
        absent, not 0, until something was measured. Never raises."""
        try:
            from kdtree_tpu_torch.approx.recall import recall_at_k

            t0 = time.monotonic()
            _, exact_ids, _ = self.engine.knn_batch(q)
            # a correction dispatch answers no client: maintenance cost
            self.costs.attribute_correction(
                round((time.monotonic() - t0) * 1e3, 3), rows)
            measured = recall_at_k(approx_ids[:rows], exact_ids[:rows])
        except Exception as e:
            flight.record("recall.sample_error", error=repr(e)[:200])
            return
        prev = self._sampled_ewma
        self._sampled_ewma = (measured if prev is None
                              else 0.7 * prev + 0.3 * measured)
        obs.get_registry().gauge("kdtree_recall_sampled").set(
            round(self._sampled_ewma, 6))
        self._samples.inc()
        flight.record("recall.sample", rows=rows,
                      measured=round(measured, 6),
                      estimate=round(float(estimate), 6),
                      ewma=round(self._sampled_ewma, 6))

    @staticmethod
    def _verb_family(verb: str) -> str:
        """Metric label for a request verb: the two count forms share one
        bounded "count" label."""
        return "count" if verb.startswith("count") else verb

    def _run_verb_batch(self, live: List[PendingRequest], spec=None) -> None:
        """Dispatch one verb-homogeneous batch (radius / range / either
        count form) through the engine's verb methods: the k-NN path's
        pow2 row quantization and gear resolution, the result back per
        request as (counts, ids, distances) row slices. ``truncated`` is
        a batch-level flag: every request of a cut batch is flagged
        (calling an exact row a lower bound is sound, the reverse is
        not)."""
        verb = live[0].verb
        fam = self._verb_family(verb)
        rows = sum(r.rows for r in live)
        bucket = batch_bucket(rows, self.max_batch)
        q = np.concatenate([r.queries for r in live], axis=0)
        if verb in ("radius", "count_radius"):
            aux = np.concatenate([r.radius for r in live])
        else:
            aux = np.concatenate([r.box_hi for r in live], axis=0)
        if bucket > rows:
            pad = np.broadcast_to(q[-1], (bucket - rows, q.shape[1]))
            q = np.concatenate([q, pad], axis=0)
            ap = np.broadcast_to(aux[-1], (bucket - rows,) + aux.shape[1:])
            aux = np.concatenate([aux, ap], axis=0)
        effective, ladder_t = self._effective(live, spec)
        with_ids = not verb.startswith("count")
        lead = next((r for r in live if r.trace_ctx is not None), None)
        dispatch_ctx = lead.trace_ctx.child() if lead is not None else None
        try:
            with trace_mod.active(dispatch_ctx):
                if verb in ("radius", "count_radius"):
                    res = self.engine.radius_batch(
                        q, aux, recall_target=effective, with_ids=with_ids)
                else:
                    res = self.engine.range_batch(
                        q, aux, recall_target=effective, with_ids=with_ids)
        except Exception as e:
            self._errors.inc()
            flight.record("serve.batch_error", rows=rows,
                          requests=len(live), verb=verb,
                          error=repr(e)[:200],
                          traces=[r.trace_id for r in live])
            flight.auto_dump("serve-error")
            for r in live:
                r.fail(f"batch dispatch failed: {e!r}")
            return
        done = time.monotonic()
        gear, forced, visit_cap = self._account_gear(live, effective, ladder_t)
        self._verb_requests[fam].inc(len(live))
        self._verb_rows[fam].observe(rows)
        if res.truncated:
            self._verb_truncated[fam].inc(len(live))
        if res.retries:
            self._verb_retries.inc(res.retries)
        self._batch_rows.observe(rows)
        self._batch_reqs.observe(len(live))
        flight.record(
            "serve.batch", rows=rows, bucket=bucket, requests=len(live),
            verb=verb, gear=gear or "exact", visit_cap=visit_cap,
            truncated=bool(res.truncated),
            retries=int(res.retries),
            dispatch_ms=round((done - live[0].dispatched_at) * 1e3, 3),
            epoch=getattr(self.engine, "last_answer_epoch", 0),
            traces=[r.trace_id for r in live],
        )
        # the span already CONTAINS the verb driver's overflow-retry
        # re-dispatches; the retry count follows the same row shares
        shares = self._attribute(
            live, fam, gear, forced,
            round((done - live[0].dispatched_at) * 1e3, 3), visit_cap,
            retries=int(res.retries))
        done_unix = time.time()
        off = 0
        for r, share in zip(live, shares):
            self._lat["dispatch"].observe(done - r.dispatched_at)
            self._lat["total"].observe(done - r.enqueued_at,
                                       exemplar=r.trace_id)
            self._trace_phases(r, done, done_unix, dispatch_ctx, lead,
                               rows=rows, bucket=bucket,
                               coalesced=len(live), verb=verb,
                               gear=gear or "exact")
            flight.record(
                "serve.request", trace=r.trace_id, rows=r.rows, verb=verb,
                queue_ms=round((r.dispatched_at - r.enqueued_at) * 1e3, 3),
                device_ms=round((done - r.dispatched_at) * 1e3, 3),
                device_share_ms=share,
                total_ms=round((done - r.enqueued_at) * 1e3, 3),
            )
            r.fulfill(
                None if res.d2 is None else res.d2[off:off + r.rows],
                None if res.ids is None else res.ids[off:off + r.rows],
                degraded=forced, gear=gear,
                counts=res.counts[off:off + r.rows],
                truncated=bool(res.truncated),
            )
            off += r.rows

    def _run_fallback(self, req: PendingRequest, reason: str) -> None:
        """Answer one straggler (or, at the ladder's floor gear, every
        request) through the exact brute-force path (the k-NN one, or the
        verb's)."""
        self._degraded[reason].inc()
        # every answered request lands in one gear class: a deadline
        # straggler's brute-force answer is exact; only the ladder's floor
        # gear is the brute-deadline class
        self._by_gear["brute-deadline" if reason == "brute-deadline"
                      else "exact"].inc()
        counts = None
        t0 = time.monotonic()
        try:
            if req.verb == "knn":
                d2, ids = self.engine.fallback_knn(req.queries, req.k)
            else:
                with_ids = not req.verb.startswith("count")
                if req.verb in ("radius", "count_radius"):
                    res = self.engine.fallback_radius(
                        req.queries, req.radius, with_ids=with_ids)
                else:
                    res = self.engine.fallback_range(
                        req.queries, req.box_hi, with_ids=with_ids)
                d2, ids, counts = res.d2, res.ids, res.counts
                fam = self._verb_family(req.verb)
                self._verb_requests[fam].inc()
                self._verb_rows[fam].observe(req.rows)
        except Exception as e:
            self._errors.inc()
            flight.record("serve.batch_error", rows=req.rows, requests=1,
                          error=repr(e)[:200], traces=[req.trace_id])
            flight.auto_dump("serve-error")
            req.fail(f"fallback dispatch failed: {e!r}")
            return
        done = time.monotonic()
        # a fallback is its own single-member dispatch: the brute-force
        # span is the request's whole device cost; every fallback answer
        # is degraded
        self.costs.attribute_request(
            verb=self._verb_family(req.verb) if req.verb != "knn" else "knn",
            gear="brute-deadline" if reason == "brute-deadline" else "exact",
            span_ms=round((done - t0) * 1e3, 3),
            rows=req.rows,
            queue_ms=round(
                ((req.dispatched_at if req.dispatched_at is not None
                  else done) - req.enqueued_at) * 1e3, 3),
            outcome="degraded",
        )
        if req.dispatched_at is not None:
            self._lat["dispatch"].observe(done - req.dispatched_at)
        self._lat["total"].observe(done - req.enqueued_at,
                                   exemplar=req.trace_id)
        if req.trace_ctx is not None:
            ctx = req.trace_ctx
            done_unix = time.time()
            start = (req.dispatched_at if req.dispatched_at is not None
                     else req.enqueued_at)
            trace_mod.record_span(
                ctx.trace_id, trace_mod.new_span_id(), ctx.span_id,
                "serve/queue",
                done_unix - (done - req.enqueued_at),
                done_unix - (done - start), rows=req.rows,
            )
            trace_mod.record_span(
                ctx.trace_id, trace_mod.new_span_id(), ctx.span_id,
                "serve/fallback", done_unix - (done - start), done_unix,
                rows=req.rows, degraded=reason,
            )
        flight.record(
            "serve.request", trace=req.trace_id, rows=req.rows,
            degraded=reason,
            total_ms=round((done - req.enqueued_at) * 1e3, 3),
        )
        # fulfill last, same response-implies-ring-event ordering as the
        # batch path above
        req.fulfill(d2, ids, degraded=reason,
                    gear="brute-deadline" if reason == "brute-deadline"
                    else None,
                    counts=counts)
