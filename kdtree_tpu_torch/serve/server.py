"""The HTTP layer: stdlib ``ThreadingHTTPServer`` in front of the batcher.

The port of ``kdtree_tpu/serve/server.py`` on the exact paths: k-NN, the
query verbs and the write path. Answers are byte-identical to a reference
server's on the same points and requests (``tests/test_torch_server.py``,
``tests/test_torch_verbs.py``, ``tests/test_torch_snapshot.py``).

- ``POST /v1/knn`` — JSON ``{"queries": [[x, y, ...], ...], "k": int?,
  "deadline_ms": number?}`` in; ``{"k": int, "ids": [[...]],
  "distances": [[...]], "degraded": null | reason, "trace_id": str}`` out.
  Distances are Euclidean (float64 sqrt of the engines' f32 d2), ids the
  original point rows shifted by ``--id-offset``.
- ``POST /v1/upsert`` / ``POST /v1/delete`` — the mutable-index write
  path: ``{"ids": [...], "points": [[...]]}`` / ``{"ids": [...]}`` with
  GLOBAL ids (this shard's ``--id-offset`` is subtracted; ids below it
  are rejected). Answers stay exact at every moment and the epoch
  rebuilder compacts in the background (``kdtree_epoch``). A read-only
  replica (a snapshot follower) answers writes 403, after reading the
  body.
- ``POST /v1/radius`` / ``POST /v1/range`` / ``POST /v1/count`` — the
  query verbs: ``{"queries": [[...]], "r": f | [f]}`` (radius),
  ``{"lo": [[...]], "hi": [[...]]}`` (range), either form for count;
  ``{"counts": [...], "ids": [[...]]?, "distances": [[...]]?,
  "truncated": false, "degraded": null | reason, "trace_id": str}`` out
  (``kdtree_tpu_torch/verbs/wire.py`` validates and shapes both). A
  request past ``max_batch`` rows is answered by the verb oracle in its
  handler thread, flagged ``oversized``.
- ``GET /healthz`` — 200 once the index is loaded and warmed up, 503
  (with ``Retry-After``) while warming. The body carries the mutable
  block (epoch, delta rows, tombstones), the box, ``id_offset``,
  ``read_only`` and the ``snapshot`` block (role, dir, live version) when
  they apply, the SLO verdicts, the degradation ladder's gear (when
  the ladder is armed) and the capacity ``headroom`` verdict
  (``obs/costs.py``; ``data: false`` until requests were answered).
- ``GET /metrics`` — the Prometheus text exposition of the registry
  (``?openmetrics=1`` for the exemplar flavour).
- ``GET /debug/flight`` — the flight recorder's ring as JSON
  (``?trace=<id>`` / ``?reason=<r>`` filter it).
- ``GET /debug/history`` — the metric-history ring (``?limit=N``).
- ``POST /debug/profile?seconds=N`` — open a ``torch.profiler`` capture
  window over the live process for N seconds (0 < N <= 60, default 3),
  every thread and the card, then answer the analyzed device timeline
  (``obs/timeline.py`` report JSON). One capture at a time: 409 while one
  runs (the profiling duty cycle's windows included).
- ``GET /debug/trace`` — the pinned-trace index; ``GET /debug/trace/<id>``
  — one trace's local span list (``obs/trace.py``).
- ``GET /debug/costs?window=S`` — the cost ledger: per-class cost
  vectors, the windowed cost-per-query and the headroom verdict.
- ``GET`` / ``POST /debug/faults`` — the deterministic fault-injection
  layer (``serve/faults.py``), opt-in (``--debug-faults`` or
  ``KDTREE_TPU_FAULTS``), 403 otherwise.

The recall dial: a ``/v1/knn`` or verb body may carry ``recall_target``
in (0, 1] (absent or 1.0 is exact; anything else is a 400 with the
reference's text). An approximate answer echoes its ``gear``
(``approx:<t>``); one the degradation ladder forced is also flagged
``degraded``; a verb answer cut by the visit cap says ``truncated``.

429 shed responses carry a ``Retry-After`` header derived from the
admission queue's measured drain rate. Every ``/v1/knn`` request carries
a trace id (client ``X-Request-Id`` or server-generated, echoed as
``trace_id``) that threads admission, batcher and dispatch in the flight
ring. The request adopts a propagated ``X-Trace-Context`` (or mints a
local root): its server-root, queue and dispatch spans land in the trace
buffer, and errored, degraded and p99-slow requests are pinned there.
Every answer's request and response bytes go to the cost ledger.
Handler threads are glue: validate, admit, block on the request
future, serialize. All engine work happens in the batch worker — except
the oversized-request degradations, which run brute force right here.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.obs import costs as costs_mod
from kdtree_tpu_torch.obs import flight
from kdtree_tpu_torch.obs import history as obs_history
from kdtree_tpu_torch.obs import trace as trace_mod
from kdtree_tpu_torch.serve.admission import (
    AdmissionQueue,
    PendingRequest,
    QueueClosedError,
    QueueFullError,
)
from kdtree_tpu_torch.serve.batcher import DEFAULT_MAX_WAIT_MS, MicroBatcher
from kdtree_tpu_torch.serve.engine import REQUEST_TIMEOUT_S, ServeState
from kdtree_tpu_torch.serve.faults import (
    SITE_HEALTHZ,
    SITE_KNN,
    SITE_VERB,
    FaultSpecError,
    from_env,
)
from kdtree_tpu_torch.verbs import wire as verb_wire

__all__ = ["GracefulHTTPServer", "JsonRequestHandler", "KnnRequestHandler",
           "KnnServer", "make_server",
           "FaultSpecError"]  # FaultSpecError re-exported for the CLI

MAX_BODY_BYTES = 64 << 20  # a [max_batch, D] float batch is far smaller
MAX_WRITE_IDS = 4096  # rows per upsert/delete request (split larger)
DEFAULT_PROFILE_SECONDS = 3.0
MAX_PROFILE_SECONDS = 60.0  # /debug/profile window cap

# write-path apply latency buckets (milliseconds): healthy masked-write
# applies sit in the sub-10ms range
_WRITE_LATENCY_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0,
)

_TRACE_ID_BAD = re.compile(r"[^A-Za-z0-9._-]")


def _trace_id(headers) -> str:
    """The request's trace id: the client's ``X-Request-Id`` (sanitized,
    capped — it flows into flight dumps verbatim) or a fresh id."""
    raw = headers.get("X-Request-Id", "")
    clean = _TRACE_ID_BAD.sub("-", raw)[:64]
    return clean or uuid.uuid4().hex[:16]


def _count_request(status: str) -> None:
    obs.get_registry().counter(
        "kdtree_serve_requests_total", labels={"status": status}
    ).inc()


class JsonRequestHandler(BaseHTTPRequestHandler):
    """JSON-over-HTTP handler glue: response serialization, the body
    reader, the keep-alive socket timeout, and the shared observability
    endpoints."""

    protocol_version = "HTTP/1.1"
    # idle keep-alive connections park their handler thread in readline();
    # with daemon_threads=False server_close() would join that thread
    # forever and a persistent scraper would wedge the SIGTERM drain. The
    # socket timeout bounds the idle wait.
    timeout = 5

    # the default handler logs every request line to stderr; serving
    # telemetry lives in the metrics registry instead
    def log_message(self, format: str, *args) -> None:
        pass

    def _send_bytes(
        self, code: int, body: bytes, content_type: str,
        extra_headers: Optional[dict] = None,
    ) -> int:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if not self.close_connection:
            # advertise how long a parked keep-alive socket stays honored
            self.send_header("Keep-Alive", f"timeout={self.timeout}")
        for key, val in (extra_headers or {}).items():
            self.send_header(key, val)
        self.end_headers()
        self.wfile.write(body)
        return len(body)

    def _send_json(
        self, code: int, obj: dict, extra_headers: Optional[dict] = None,
    ) -> int:
        # default=str: flight-ring events carry arbitrary recorded fields;
        # one unserializable value must not drop the connection. Returns
        # the body size — the cost ledger's bytes_out source
        return self._send_bytes(
            code, (json.dumps(obj, default=str) + "\n").encode("utf-8"),
            "application/json", extra_headers,
        )

    def _send_metrics(self) -> None:
        """``GET /metrics``: the registry's Prometheus text, deferred
        device fetches flushed first; ``?openmetrics=1`` opts into the
        OpenMetrics flavour (exemplars + ``# EOF``)."""
        from kdtree_tpu_torch.obs.export import openmetrics_text, prometheus_text

        obs.flush()
        qs = parse_qs(urlparse(self.path).query)
        if qs.get("openmetrics", ["0"])[0] not in ("", "0"):
            self._send_bytes(
                200, openmetrics_text().encode("utf-8"),
                "application/openmetrics-text; version=1.0.0; charset=utf-8",
            )
            return
        self._send_bytes(
            200, prometheus_text().encode("utf-8"),
            "text/plain; version=0.0.4; charset=utf-8",
        )

    def _send_flight(self) -> None:
        """``GET /debug/flight``: the live ring — the SIGUSR2 dump's
        payload — filtered server-side by ``?trace=`` / ``?reason=``."""
        qs = parse_qs(urlparse(self.path).query)
        trace = (qs.get("trace") or [None])[0]
        reason = (qs.get("reason") or [None])[0]
        rep = flight.recorder().report("debug-endpoint")
        if trace is not None or reason is not None:
            rep["events"] = flight.filter_events(
                rep["events"], trace=trace, reason=reason)
            rep["filter"] = {"trace": trace, "reason": reason,
                             "matched": len(rep["events"])}
        self._send_json(200, rep)

    def _send_trace(self, path: str) -> None:
        """``GET /debug/trace`` (the pinned-trace index) and
        ``GET /debug/trace/<id>`` (one trace's local span list)."""
        tid = path[len("/debug/trace"):].strip("/")
        if not tid:
            self._send_json(200, trace_mod.index())
            return
        payload = trace_mod.get_trace(tid)
        if payload is None:
            self._send_json(404, {"error": f"no such trace: {tid} "
                                           "(aged out or never recorded)"})
            return
        payload["trace_version"] = trace_mod.TRACE_VERSION
        payload["pid"] = os.getpid()
        self._send_json(200, payload)

    def _note_offered_rate(self) -> None:
        """Mirror the load generator's ``X-Loadgen-Rate`` header into the
        ``kdtree_loadgen_offered_rate`` gauge and, when it changes, a
        ``loadgen.rate`` flight event, so an SLO page that fires mid-run
        names the offered rate in its incident dump. The shard server and
        the router both call it; ordinary traffic carries no header."""
        raw = self.headers.get("X-Loadgen-Rate")
        if not raw:
            return
        try:
            rate = float(raw)
        except ValueError:
            return
        if rate != getattr(self.server, "loadgen_rate", None):
            # benign last-writer-wins race: the gauge and the ring both
            # want the rate the client most recently declared
            self.server.loadgen_rate = rate
            obs.get_registry().gauge("kdtree_loadgen_offered_rate").set(rate)
            flight.record("loadgen.rate", rate=rate)

    def _read_json_object(self, max_bytes: int = MAX_BODY_BYTES):
        """Read + parse one JSON-object request body, or None with the
        4xx already written: 411 missing Content-Length, 400 negative,
        413 oversized, 400 non-JSON / non-object."""
        try:
            length = int(self.headers.get("Content-Length", ""))
        except ValueError:
            self._send_json(411, {"error": "Content-Length required"})
            return None
        if not (0 <= length <= max_bytes):
            self._send_json(400 if length < 0 else 413,
                            {"error": f"Content-Length must be in "
                                      f"[0, {max_bytes}]"})
            return None
        # the cost ledger's bytes_in source: the declared body size the
        # answer paths attribute to the request's cost class
        self._body_bytes = length
        try:
            payload = json.loads(self.rfile.read(length).decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            self._send_json(400, {"error": "body is not valid JSON"})
            return None
        if not isinstance(payload, dict):
            self._send_json(400, {"error": "body must be a JSON object"})
            return None
        return payload

    def _drain_body(self) -> None:
        """Consume the request body before answering without reading it:
        unread bytes on a keep-alive socket would be parsed as the
        client's next request line. A body past the cap (or a bad length)
        closes the connection instead."""
        try:
            length = int(self.headers.get("Content-Length", "0") or 0)
        except ValueError:
            length = -1
        if 0 < length <= MAX_BODY_BYTES:
            self.rfile.read(length)
        elif length != 0:
            self.close_connection = True


class GracefulHTTPServer(ThreadingHTTPServer):
    """Server base: non-daemon handler threads (server_close() joins every
    in-flight handler, so stop() cannot drop an accepted request) and
    disconnect-tolerant error handling — a client that hung up
    mid-response is normal serving weather, not a stack trace."""

    daemon_threads = False

    def handle_error(self, request, client_address) -> None:
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                            ConnectionAbortedError)):
            flight.record("serve.client_gone",
                          peer=str(client_address), error=repr(exc)[:200])
            return
        super().handle_error(request, client_address)


class KnnRequestHandler(JsonRequestHandler):
    """Request glue; its methods materialize engine results into JSON."""

    server_version = "kdtree-tpu-serve/1.0"

    def _fire_fault(self, site: str) -> bool:
        """Run the fault-injection site; True when a response (or a
        deliberate non-response) was already produced and the caller
        must return. Delay faults (latency/hang) are served inside
        ``fire`` and fall through to normal handling."""
        act = self.server.faults.fire(site)
        if act is None:
            return False
        if act["kind"] == "drop":
            # no status line, no body: the client sees the connection
            # close mid-exchange — a network fault, not an HTTP one
            self.close_connection = True
            return True
        # error kind: answer WITHOUT touching the engine — but consume the
        # request body first (keep-alive protocol desync otherwise)
        self._drain_body()
        self._send_json(act["status"],
                        {"error": "injected fault (serve/faults.py)"})
        return True

    # -- GET ----------------------------------------------------------------

    def do_GET(self) -> None:
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            if self._fire_fault(SITE_HEALTHZ):
                return
            state: ServeState = self.server.state
            if state.ready:
                self._send_json(200, self._health_body(state))
            else:
                self._send_json(503, {"status": "warming"},
                                extra_headers={"Retry-After": "1"})
            return
        if path == "/metrics":
            self._send_metrics()
            return
        if path == "/debug/flight":
            self._send_flight()
            return
        if path == "/debug/history":
            # the metric-history ring the SLO engine reads — same payload
            # shape as an incident's history-<reason>.json dump
            qs = parse_qs(urlparse(self.path).query)
            try:
                limit = int(qs.get("limit", ["0"])[0]) or None
            except ValueError:
                limit = None
            self._send_json(200, self.server.history.report(limit=limit))
            return
        if path == "/debug/faults":
            self._send_json(200, {"enabled": self.server.faults_mutable,
                                  "active": self.server.faults.describe()})
            return
        if path == "/debug/trace" or path.startswith("/debug/trace/"):
            self._send_trace(path)
            return
        if path == "/debug/costs":
            # the cost ledger's report: per-class cumulative cost vectors,
            # the windowed cost-per-query and the headroom verdict — what
            # the `costs` command renders
            qs = parse_qs(urlparse(self.path).query)
            try:
                window_s = float(qs.get("window", ["60"])[0])
            except ValueError:
                window_s = costs_mod.DEFAULT_WINDOW_S
            if not (window_s > 0):
                window_s = costs_mod.DEFAULT_WINDOW_S
            self._send_json(200, self.server.costs.report(
                window_s=window_s, history=self.server.history))
            return
        self._send_json(404, {"error": f"no such path: {path}"})

    def _health_body(self, state: ServeState) -> dict:
        body = {
            "status": "ok",
            # this process's wall clock, stamped mid-exchange (a router's
            # clock-offset estimate reads it from every health probe)
            "server_unix": time.time(),
            "n": state.engine.tree.n_real,
            "dim": state.engine.tree.dim,
            "k_max": state.engine.k,
            "max_batch": state.max_batch,
            # the router's write-ownership source: this shard owns global
            # ids in [id_offset, next shard's offset)
            "id_offset": state.id_offset,
        }
        # the shard's bounding box (expanded live by delta upserts,
        # recomputed at every epoch swap); only published while finite
        blo, bhi = state.engine.bounds()
        if np.isfinite(blo).all() and np.isfinite(bhi).all():
            body["box"] = {"lo": [float(x) for x in blo],
                           "hi": [float(x) for x in bhi]}
        if "spatial" in state.meta:
            body["spatial"] = state.meta["spatial"]
        mut = state.engine.stats()
        body["mutable"] = mut
        body["epoch"] = mut["epoch"]
        # k_max is the CONFIGURED request cap (stable across deletes and
        # epoch swaps); k_effective says how many real neighbors exist
        body["k_effective"] = mut["k_effective"]
        if state.read_only:
            body["read_only"] = True
        if "snapshot" in state.meta:
            # the snapshot block (role, dir, live version): the follower
            # updates version on each blue/green adopt, so a fleet's
            # convergence is one /healthz sweep
            body["snapshot"] = state.meta["snapshot"]
        # SLO verdict rides along without gating readiness
        body["slo"] = state.slo_engine.health_block()
        ladder = getattr(self.server, "ladder", None)
        if ladder is not None and ladder.enabled:
            spec = ladder.spec()
            # the engaged degradation gear: a fleet's gear distribution
            # is one /healthz sweep
            body["ladder"] = {
                "gear": ladder.gear(),
                "name": spec.name,
                "recall_target": spec.recall_target,
            }
        # the capacity-headroom verdict: predicted sustainable rate vs
        # observed; data:false while idle — no traffic is not no headroom
        body["headroom"] = self.server.costs.headroom(
            history=self.server.history)
        return body

    # -- POST ---------------------------------------------------------------

    def do_POST(self) -> None:
        path = self.path.split("?", 1)[0]
        self._note_offered_rate()
        if path == "/debug/profile":
            self._do_debug_profile()
            return
        if path == "/debug/faults":
            self._do_debug_faults()
            return
        if path in ("/v1/upsert", "/v1/delete"):
            self._do_write("upsert" if path == "/v1/upsert" else "delete")
            return
        if path in ("/v1/radius", "/v1/range", "/v1/count"):
            self._do_verb(path.rsplit("/", 1)[1])
            return
        if path != "/v1/knn":
            self._send_json(404, {"error": f"no such path: {path}"})
            return
        if self._fire_fault(SITE_KNN):
            return
        trace = _trace_id(self.headers)
        tr = self._trace_start(trace)
        parsed = self._parse_knn_body()
        if parsed is None:
            return  # error response already sent
        queries, k, deadline_s, recall_target = parsed
        state: ServeState = self.server.state
        if not state.ready:
            _count_request("unready")
            self._send_json(503, {"error": "index is still warming up"},
                            extra_headers={"Retry-After": "1"})
            return
        if queries.shape[0] > state.max_batch:
            out = self._oversized(trace, tr, int(queries.shape[0]),
                                  lambda: state.engine.fallback_knn(queries, k))
            if out is not None:
                sent = self._send_json(200, self._result_json(
                    out[0], out[1], k, degraded="oversized", trace_id=trace))
                self._count_bytes("knn", "exact", "degraded", sent)
            return
        deadline = (time.monotonic() + deadline_s) if deadline_s else None
        req = PendingRequest(queries, k, deadline, trace_id=trace,
                             recall_target=recall_target,
                             trace_ctx=self._root_ctx(tr))
        if self._submit_and_wait(req, trace, tr):
            sent = self._send_json(200, self._result_json(
                req.d2, req.ids, k, degraded=req.degraded, trace_id=trace,
                gear=req.gear))
            self._count_bytes("knn", req.gear,
                              "degraded" if req.degraded else "ok", sent)

    def _trace_start(self, trace: str):
        """The request's trace handle: (adopted or minted context, its
        server-root span id, start wall clock), or None with tracing off."""
        if not trace_mod.enabled():
            return None
        return (trace_mod.adopt(self.headers, trace),
                trace_mod.new_span_id(), time.time())

    @staticmethod
    def _root_ctx(tr):
        """The context the batcher parents a request's spans under: the
        server-root span of ``tr``."""
        if tr is None:
            return None
        ctx, root_id, _ = tr
        return trace_mod.TraceContext(ctx.trace_id, root_id, ctx.sampled)

    def _trace_finish(self, tr, status: str, degraded, rows: int,
                      track_slow: bool = True) -> None:
        """Close the request's server-root span and apply the tail-sampling
        promotion rules: errored/timed-out and degraded answers always pin,
        p99-relative slow answers pin, head-sampled contexts pin. Never
        raises — called on the response path."""
        if tr is None:
            return
        try:
            ctx, root_id, t0_unix = tr
            end = time.time()
            attrs = {"status": status, "rows": rows}
            if degraded:
                attrs["degraded"] = degraded
            trace_mod.record_span(
                ctx.trace_id, root_id, ctx.span_id or "",
                "serve/request", t0_unix, end, **attrs,
            )
            if status in ("error", "timeout"):
                trace_mod.promote(ctx.trace_id, "error")
            if degraded:
                trace_mod.promote(ctx.trace_id, "degraded")
            if track_slow and status in ("ok", "degraded") and \
                    self.server.slow_tracker.note(end - t0_unix):
                trace_mod.promote(ctx.trace_id, "slow")
            if ctx.sampled:
                trace_mod.promote(ctx.trace_id, "sampled")
        except Exception:
            pass

    def _count_bytes(self, verb: str, gear, outcome: str, sent: int) -> None:
        self.server.costs.count_bytes(
            verb=verb, gear=gear, outcome=outcome,
            bytes_in=getattr(self, "_body_bytes", 0), bytes_out=sent)

    def _submit_and_wait(self, req: PendingRequest, trace: str, tr) -> bool:
        """Admit ``req`` to the batcher and wait for its answer. False
        with the 429/503/504/500 already written; True once the answer is
        in ``req`` (counted ok or degraded) for the caller to send."""
        try:
            self.server.queue.submit(req)
        except QueueFullError:
            _count_request("shed")
            self._send_json(429, {"error": "overloaded: admission queue "
                                           "at capacity",
                                  "trace_id": trace},
                            extra_headers=self._retry_after(req.rows))
            return False
        except QueueClosedError:
            _count_request("unready")
            self._send_json(503, {"error": "server is shutting down",
                                  "trace_id": trace})
            return False
        if not req.event.wait(timeout=REQUEST_TIMEOUT_S):
            _count_request("timeout")
            flight.record("serve.timeout", trace=trace, rows=req.rows)
            flight.auto_dump("serve-error")
            self._trace_finish(tr, "timeout", None, req.rows)
            self._send_json(504, {"error": "request timed out in service",
                                  "trace_id": trace})
            return False
        if req.error is not None:
            _count_request("error")
            self._trace_finish(tr, "error", None, req.rows)
            self._send_json(500, {"error": req.error, "trace_id": trace})
            return False
        _count_request("degraded" if req.degraded else "ok")
        self._trace_finish(tr, "degraded" if req.degraded else "ok",
                           req.degraded, req.rows)
        return True

    def _oversized(self, trace: str, tr, rows: int, answer, **fields):
        """One request bigger than any micro-batch: ``answer()`` (the
        brute-force path) runs HERE — exact, flagged degraded — instead of
        erroring or distorting the batch pipeline. The rows still charge
        the admission budget (reserve/release): the most expensive
        requests must be the first the 429 gate can refuse. Returns the
        answer, or None with the error response already written."""
        try:
            charge = self.server.queue.reserve(rows, trace_id=trace)
        except QueueFullError:
            _count_request("shed")
            self._send_json(429, {"error": "overloaded: admission "
                                           "queue at capacity",
                                  "trace_id": trace},
                            extra_headers=self._retry_after(rows))
            return None
        except QueueClosedError:
            _count_request("unready")
            self._send_json(503, {"error": "server is shutting down",
                                  "trace_id": trace})
            return None
        obs.get_registry().counter(
            "kdtree_serve_degraded_total", labels={"reason": "oversized"}
        ).inc()
        flight.record("serve.oversized", trace=trace, rows=rows, **fields)
        try:
            out = answer()
        except Exception as e:
            _count_request("error")
            flight.record("serve.error", trace=trace, error=repr(e)[:200])
            flight.auto_dump("serve-error")
            self._trace_finish(tr, "error", None, rows)
            self._send_json(500, {"error": f"engine failure: {e!r}",
                                  "trace_id": trace})
            return None
        finally:
            self.server.queue.release(charge)
        _count_request("degraded")
        self._trace_finish(tr, "degraded", "oversized", rows)
        return out

    def _parse_knn_body(
        self,
    ) -> Optional[Tuple[np.ndarray, int, Optional[float], Optional[float]]]:
        """Validated (queries f32[q, D], k, deadline seconds | None,
        recall_target | None), or None with the 4xx already written.
        Every rejection names what was wrong."""
        state: ServeState = self.server.state
        payload = self._read_json_object()
        if payload is None:
            return None
        if "queries" not in payload:
            self._send_json(400, {"error": 'body must be a JSON object '
                                           'with "queries"'})
            return None
        try:
            queries = np.asarray(payload["queries"], dtype=np.float32)
        except (TypeError, ValueError):
            self._send_json(400, {"error": "queries must be a [q, d] "
                                           "number array"})
            return None
        dim = state.engine.tree.dim
        if queries.ndim != 2 or queries.shape[0] < 1:
            self._send_json(400, {"error": f"queries must be non-empty "
                                           f"[q, {dim}], got shape "
                                           f"{queries.shape}"})
            return None
        if queries.shape[1] != dim:
            self._send_json(400, {"error": f"queries are "
                                           f"{queries.shape[1]}-D but the "
                                           f"index is {dim}-D"})
            return None
        if not np.isfinite(queries).all():
            self._send_json(400, {"error": "queries contain non-finite "
                                           "values"})
            return None
        k = payload.get("k", state.engine.k)
        if not isinstance(k, int) or isinstance(k, bool) or \
                not (1 <= k <= state.engine.k):
            self._send_json(400, {"error": f"k must be an int in "
                                           f"[1, {state.engine.k}] (the "
                                           "server's --k caps the compiled "
                                           f"batch width), got {k!r}"})
            return None
        deadline_ms = payload.get("deadline_ms")
        deadline_s: Optional[float] = None
        if deadline_ms is not None:
            if not isinstance(deadline_ms, (int, float)) or \
                    isinstance(deadline_ms, bool) or deadline_ms <= 0:
                self._send_json(400, {"error": "deadline_ms must be a "
                                               "positive number"})
                return None
            deadline_s = float(deadline_ms) / 1e3
        recall_target = self._parse_recall_target(payload)
        if recall_target is False:
            return None
        return queries, k, deadline_s, recall_target

    def _parse_recall_target(self, payload: dict):
        """The request's recall target: None (absent, null or 1.0 — the
        exact path), a float in (0, 1), or False with the 400 already
        written. One validator with the reference's text."""
        from kdtree_tpu_torch.approx.search import (
            RECALL_TARGET_ERROR,
            parse_recall_target,
        )

        ok, recall_target = parse_recall_target(payload.get("recall_target"))
        if not ok:
            self._send_json(400, {"error": RECALL_TARGET_ERROR})
            return False
        return recall_target

    def _do_verb(self, endpoint: str) -> None:
        """``POST /v1/radius`` / ``/v1/range`` / ``/v1/count``: the k-NN
        flow — parse, admit, block on the request future, answer — with
        the verb and its per-query geometry riding the
        :class:`PendingRequest` so the batcher can group per-verb
        micro-batches; the oversized degradation runs the brute-force
        verb oracle right here, exactly like oversized k-NN."""
        if self._fire_fault(SITE_VERB):
            return
        trace = _trace_id(self.headers)
        tr = self._trace_start(trace)
        parsed = self._parse_verb_body(endpoint)
        if parsed is None:
            return  # error response already sent
        verb, queries, radius, box_hi, deadline_s, recall_target = parsed
        state: ServeState = self.server.state
        if not state.ready:
            _count_request("unready")
            self._send_json(503, {"error": "index is still warming up"},
                            extra_headers={"Retry-After": "1"})
            return
        if queries.shape[0] > state.max_batch:
            # oversized verb request: the brute-force verb oracle here,
            # like the oversized k-NN path
            by_radius = verb in ("radius", "count_radius")
            fallback = (state.engine.fallback_radius if by_radius
                        else state.engine.fallback_range)
            res = self._oversized(
                trace, tr, int(queries.shape[0]),
                lambda: fallback(queries, radius if by_radius else box_hi,
                                 with_ids=not verb.startswith("count")),
                verb=verb)
            if res is not None:
                sent = self._send_json(200, self._verb_result_json(
                    verb, res.counts, res.d2, res.ids, bool(res.truncated),
                    degraded="oversized", trace_id=trace))
                self._count_bytes(verb, "exact", "degraded", sent)
            return
        deadline = (time.monotonic() + deadline_s) if deadline_s else None
        req = PendingRequest(queries, state.engine.k, deadline,
                             trace_id=trace, verb=verb, radius=radius,
                             box_hi=box_hi, recall_target=recall_target,
                             trace_ctx=self._root_ctx(tr))
        if self._submit_and_wait(req, trace, tr):
            sent = self._send_json(200, self._verb_result_json(
                verb, req.counts, req.d2, req.ids, req.truncated,
                degraded=req.degraded, trace_id=trace, gear=req.gear))
            self._count_bytes(verb, req.gear,
                              "degraded" if req.degraded else "ok", sent)

    def _parse_verb_body(self, endpoint: str):
        """Validated (verb, queries|lo, r|None, hi|None, deadline seconds
        | None, recall_target | None) for a verb endpoint, or None with
        the 4xx already written. Geometry validation lives in
        :mod:`kdtree_tpu_torch.verbs.wire`; the deadline check is the
        k-NN one."""
        state: ServeState = self.server.state
        payload = self._read_json_object()
        if payload is None:
            return None
        dim = state.engine.tree.dim
        radius: Optional[np.ndarray] = None
        box_hi: Optional[np.ndarray] = None
        try:
            if endpoint == "radius":
                verb = "radius"
                queries, radius = verb_wire.parse_radius_body(payload, dim)
            elif endpoint == "range":
                verb = "range"
                queries, box_hi = verb_wire.parse_range_body(payload, dim)
            else:
                form, q_or_lo, r, lo, hi = verb_wire.parse_count_body(
                    payload, dim)
                if form == "radius":
                    verb, queries, radius = "count_radius", q_or_lo, r
                else:
                    verb, queries, box_hi = "count_box", lo, hi
        except verb_wire.VerbParseError as e:
            self._send_json(400, {"error": str(e)})
            return None
        deadline_ms = payload.get("deadline_ms")
        deadline_s: Optional[float] = None
        if deadline_ms is not None:
            if not isinstance(deadline_ms, (int, float)) or \
                    isinstance(deadline_ms, bool) or deadline_ms <= 0:
                self._send_json(400, {"error": "deadline_ms must be a "
                                               "positive number"})
                return None
            deadline_s = float(deadline_ms) / 1e3
        recall_target = self._parse_recall_target(payload)
        if recall_target is False:
            return None
        return verb, queries, radius, box_hi, deadline_s, recall_target

    def _verb_result_json(
        self, verb: str, counts: np.ndarray,
        d2: Optional[np.ndarray], ids: Optional[np.ndarray],
        truncated: bool, degraded: Optional[str], trace_id: str = "",
        gear: Optional[str] = None,
    ) -> dict:
        offset = self.server.state.id_offset
        out = {
            "counts": np.asarray(counts).astype(np.int64).tolist(),
            # the soundness flag: true only when a bounded visit made the
            # answer a lower bound — false on every exact answer
            "truncated": bool(truncated),
            "degraded": degraded,
            "trace_id": trace_id,
        }
        if verb == "radius" and ids is not None and d2 is not None:
            out["ids"], out["distances"] = verb_wire.radius_rows_json(
                d2, ids, counts, offset)
        elif verb == "range" and ids is not None:
            out["ids"] = verb_wire.range_rows_json(ids, counts, offset)
        if gear is not None:
            out["gear"] = gear
        return out

    def _do_write(self, op: str) -> None:
        """``POST /v1/upsert`` / ``/v1/delete``: validates, converts GLOBAL
        ids to this shard's local ids (``--id-offset``), applies through
        the engine's write lock, and reports the post-write
        delta/tombstone/epoch state — the caller's backpressure signal."""
        trace = _trace_id(self.headers)
        state: ServeState = self.server.state
        engine = state.engine
        # consume the body BEFORE any early 503: answering with the JSON
        # still unread leaves its bytes on the keep-alive socket
        payload = self._read_json_object()
        if payload is None:
            return
        if state.read_only:
            # snapshot-following secondary: writes belong to the shard
            # primary; a local delta here would silently diverge from the
            # snapshot stream this replica converges by
            self._send_json(403, {"error": "this replica is read-only "
                                           "(snapshot follower) — send "
                                           "writes to the shard primary",
                                  "trace_id": trace})
            return
        if self.server.queue.closed:
            self._send_json(503, {"error": "server is shutting down",
                                  "trace_id": trace})
            return
        if not state.ready:
            self._send_json(503, {"error": "index is still warming up",
                                  "trace_id": trace},
                            extra_headers={"Retry-After": "1"})
            return
        ids = payload.get("ids")
        if not isinstance(ids, list) or not (1 <= len(ids) <= MAX_WRITE_IDS):
            self._send_json(400, {"error": f'"ids" must be a list of 1..'
                                           f"{MAX_WRITE_IDS} ints"})
            return
        if not all(isinstance(i, int) and not isinstance(i, bool)
                   for i in ids):
            self._send_json(400, {"error": '"ids" must all be ints'})
            return
        offset = state.id_offset
        if min(ids) < offset:
            # ids are GLOBAL; anything below this shard's offset belongs
            # to another shard
            self._send_json(400, {"error": f"ids below this shard's "
                                           f"id_offset {offset} are not "
                                           "owned here"})
            return
        try:
            local = np.asarray(ids, dtype=np.int64) - offset
        except OverflowError:
            # a Python int past int64 passes the isinstance checks but
            # cannot convert — that must be a 400, not a dead handler
            self._send_json(400, {"error": "ids must fit a 64-bit int"})
            return
        points = None
        if op == "upsert":
            try:
                points = np.asarray(payload.get("points"), dtype=np.float32)
            except (TypeError, ValueError):
                self._send_json(400, {"error": '"points" must be a '
                                               "[m, d] number array"})
                return
            dim = engine.tree.dim
            if points.ndim != 2 or points.shape != (len(ids), dim):
                self._send_json(400, {"error": f'"points" must be '
                                               f"[{len(ids)}, {dim}] to "
                                               "match ids, got shape "
                                               f"{points.shape}"})
                return
            if not np.isfinite(points).all():
                self._send_json(400, {"error": "points contain non-finite "
                                               "values"})
                return
        tr = self._trace_start(trace)
        t0 = time.perf_counter()
        try:
            # the write's root context is active, so engine-internal spans
            # (delta append, rebuild start) nest under it
            with trace_mod.active(self._root_ctx(tr)):
                if op == "upsert":
                    res = engine.upsert(local, points)
                else:
                    res = engine.delete(local)
        except ValueError as e:
            self._trace_finish(tr, "error", None, len(ids))
            self._send_json(400, {"error": str(e), "trace_id": trace})
            return
        except RuntimeError as e:
            self._trace_finish(tr, "error", None, len(ids))
            self._send_json(503, {"error": str(e), "trace_id": trace})
            return
        # apply duration includes the engine-lock wait, so rebuild-swap
        # contention shows up here, not only in a profiler capture
        apply_ms = (time.perf_counter() - t0) * 1e3
        self.server.write_latency[op].observe(apply_ms, exemplar=trace)
        costs_mod.count_write(op, apply_ms)
        if tr is not None:
            ctx, root_id, t_w0 = tr
            trace_mod.record_span(
                ctx.trace_id, trace_mod.new_span_id(), root_id,
                "serve/write", t_w0, t_w0 + apply_ms / 1e3,
                op=op, ids=len(ids), applied=res["applied"],
            )
        # writes do not feed the k-NN slow tracker: rebuild-heavy applies
        # would inflate the p99 the "slow" promotion is relative to
        self._trace_finish(tr, "ok", None, len(ids), track_slow=False)
        flight.record("serve.write", op=op, trace=trace,
                      ids=len(ids), applied=res["applied"],
                      delta_rows=res["delta_rows"], epoch=res["epoch"])
        res["op"] = op
        res["trace_id"] = trace
        self._send_json(200, res)

    def _retry_after(self, rows: int) -> dict:
        """The 429 extra-headers dict: Retry-After derived from the
        admission queue's measured drain rate (seconds, integer-ceil so a
        compliant client never retries early)."""
        return {"Retry-After":
                str(int(math.ceil(self.server.queue.retry_after_s(rows))))}

    def _do_debug_faults(self) -> None:
        """``POST /debug/faults``: arm (``{"spec": ...}``) or clear
        (``{"clear": true}``) the process's injected faults; the response
        echoes what is now armed."""
        if not self.server.faults_mutable:
            self._drain_body()
            self._send_json(403, {"error": "fault injection is disabled "
                                           "on this server; start with "
                                           "--debug-faults (or "
                                           "KDTREE_TPU_FAULTS) to arm the "
                                           "drill endpoint"})
            return
        payload = self._read_json_object(max_bytes=1 << 20)
        if payload is None:
            return
        if ("spec" not in payload) == ("clear" not in payload) or \
                ("clear" in payload and payload["clear"] is not True):
            self._send_json(400, {"error": 'body must be {"spec": "..."} '
                                           'or {"clear": true}'})
            return
        try:
            if "clear" in payload:
                self.server.faults.clear()
            else:
                self.server.faults.set_spec(str(payload["spec"]))
        except FaultSpecError as e:
            self._send_json(400, {"error": str(e)})
            return
        self._send_json(200, {"active": self.server.faults.describe()})

    def _do_debug_profile(self) -> None:
        """``POST /debug/profile?seconds=N``: a capture window over the
        live process (every thread, and the serving card; the batch worker
        opens and closes it), then the analyzed device-timeline report.
        The single-capture lock maps to 409. The body, if any, is read
        first (keep-alive)."""
        from kdtree_tpu_torch.obs import profile as obs_profile
        from kdtree_tpu_torch.obs import timeline as obs_timeline

        self._drain_body()
        qs = parse_qs(urlparse(self.path).query)
        raw = qs.get("seconds", [str(DEFAULT_PROFILE_SECONDS)])[0]
        try:
            seconds = float(raw)
        except ValueError:
            self._send_json(400, {"error": f"seconds must be a number, "
                                           f"got {raw!r}"})
            return
        if not (0.0 < seconds <= MAX_PROFILE_SECONDS):
            self._send_json(400, {"error": "seconds must be in "
                                           f"(0, {MAX_PROFILE_SECONDS:g}]"})
            return
        import tempfile

        log_dir = tempfile.mkdtemp(prefix="kdtree-serve-profile-")
        try:
            # the batch worker opens and closes the window on its own
            # thread, between batches (serve/batcher.py)
            result = self.server.batcher.capture_for(seconds, log_dir)
        except obs_profile.CaptureBusyError:
            self._send_json(409, {"error": "a profiler capture is already "
                                           "running (one at a time)"})
            return
        except Exception as e:
            self._send_json(500, {"error": f"capture failed: {e!r}"})
            return
        try:
            rep = obs_timeline.analyze_trace_file(result.trace_file)
        except (OSError, ValueError) as e:
            self._send_json(500, {"error": f"cannot parse trace "
                                           f"{result.trace_file}: {e!r}"})
            return
        rep["seconds_requested"] = seconds
        self._send_json(200, rep)

    def _result_json(
        self, d2: np.ndarray, ids: np.ndarray, k: int,
        degraded: Optional[str], trace_id: str = "",
        gear: Optional[str] = None,
    ) -> dict:
        dist = np.sqrt(d2[:, :k].astype(np.float64))
        ids = ids[:, :k]
        offset = self.server.state.id_offset
        if offset:
            # sharded serving answers GLOBAL ids: shard-local rows shift
            # by the shard's offset, padding ids stay -1; int64 so a deep
            # shard cannot wrap the i32 gid table
            ids = np.where(ids >= 0, ids.astype(np.int64) + offset, -1)
        out = {
            "k": k,
            "ids": ids.tolist(),
            "distances": dist.tolist(),
            "degraded": degraded,
            "trace_id": trace_id,
        }
        if gear is not None:
            # the answering gear, on every non-plain-exact answer — a
            # client-requested approximation carries it without degraded;
            # absent on exact answers, so their bytes are unchanged
            out["gear"] = gear
        return out


class KnnServer(GracefulHTTPServer):
    """The serving process object: HTTP accept loop + admission queue +
    batch worker + history sampler, with an explicit graceful stop."""

    def __init__(
        self,
        address: Tuple[str, int],
        state: ServeState,
        max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
        queue_rows: Optional[int] = None,
        faults=None,
        debug_faults: Optional[bool] = None,
        recall_sample: float = 0.0,
    ) -> None:
        super().__init__(address, KnnRequestHandler)
        self.state = state
        # the most recent X-Loadgen-Rate a client declared (None until a
        # load-harness run shows up); see _note_offered_rate
        self.loadgen_rate: Optional[float] = None
        # per-server fault set: defaults to the KDTREE_TPU_FAULTS env
        # spec; in-process tests pass their own
        self.faults = faults if faults is not None else from_env()
        # POST /debug/faults is a remote wedge-this-process button: it
        # must be OPTED INTO, never ambient on a production shard
        self.faults_mutable = (
            faults is not None
            or bool(debug_faults)
            or "KDTREE_TPU_FAULTS" in os.environ
        )
        # default admission budget: a few batches' worth of rows — deep
        # enough to ride a burst, shallow enough that shed beats queueing
        self.queue = AdmissionQueue(
            queue_rows if queue_rows is not None else 4 * state.max_batch
        )
        # the degradation ladder: exact -> approx(0.99) -> approx(0.9) ->
        # brute-force-deadline under sustained burn, ticked on the history
        # sampler's tick after the SLO engine. Disabled, it never leaves
        # gear 0 and serving is exactly the exact path
        from kdtree_tpu_torch.approx.ladder import DegradationLadder

        self.ladder = DegradationLadder(state.slo_engine,
                                        enabled=state.ladder_enabled)
        # ONE cost ledger per server: the batcher attributes dispatch
        # spans into it, the HTTP layer adds bytes, /debug/costs and the
        # healthz headroom block read it
        self.costs = costs_mod.CostLedger()
        self.batcher = MicroBatcher(
            state.engine, self.queue,
            max_batch=state.max_batch,
            max_wait_ms=max_wait_ms,
            ladder=self.ladder,
            faults=self.faults,
            recall_sample=recall_sample,
            costs=self.costs,
        )
        # the profiling duty cycle: a short capture window every period
        # keeps kdtree_device_busy_frac live; off unless
        # KDTREE_TPU_PROFILE_DUTY=1 (each window pauses the batch worker)
        self.duty = costs_mod.ProfileDutyCycle(
            capture_for=self.batcher.capture_for)
        # the p99-relative slowness detector behind the "slow" trace
        # promotion: slow relative to this server's recent window
        self.slow_tracker = trace_mod.SlowTracker()
        # the history ring /debug/history serves and the sampler feeds
        self.history = state.slo_engine.history
        self._sampler: Optional[obs_history.Sampler] = None
        self._serve_thread: Optional[threading.Thread] = None
        reg = obs.get_registry()
        self.write_latency = {
            op: reg.histogram("kdtree_write_latency_ms",
                              buckets=_WRITE_LATENCY_BUCKETS_MS,
                              labels={"op": op})
            for op in ("upsert", "delete")
        }

    def _slo_tick(self) -> None:
        self.state.slo_engine.evaluate()  # never raises (sampler-thread contract)
        # the ladder's controller runs on the same tick, after the SLO
        # verdicts it reads
        self.ladder.tick()
        # refresh the published cost/headroom gauges (never raises; they
        # stay absent while idle)
        self.costs.publish(history=self.history)

    def start(self, warmup: bool = True, warmup_buckets=None) -> None:
        """Start the batch worker, the history sampler (+ SLO evaluation
        per tick), and the accept loop, then (by default) run warmup
        synchronously — ``/healthz`` answers 503-warming meanwhile and
        flips to 200 the moment this returns."""
        self.batcher.start()
        self._sampler = obs_history.Sampler(
            history=self.history,
            on_sample=self._slo_tick,
        )
        self._sampler.start()
        self.duty.start()  # no-op unless KDTREE_TPU_PROFILE_DUTY=1
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name="kdtree-serve-accept"
        )
        self._serve_thread.start()
        if warmup and not self.state.ready:
            self.state.warmup(warmup_buckets)

    def stop(self) -> None:
        """Graceful shutdown: stop accepting, drain every accepted
        request, join the handler threads and any epoch rebuild."""
        self.shutdown()  # stops serve_forever; no new connections accepted
        # release (not disarm) injected hangs: server_close() below joins
        # every handler thread, and a drained shutdown must not be
        # hostage to a fault drill parked in an injected wedge
        self.faults.release()
        if self._serve_thread is not None:
            self._serve_thread.join()
            self._serve_thread = None
        if self._sampler is not None:
            self._sampler.stop()
            self._sampler = None
        self.duty.stop()
        self.batcher.stop()  # closes admission, drains, fulfills futures
        # join any in-flight epoch rebuild: the drain must not race an
        # epoch swap, and the rebuild thread must not outlive teardown
        self.state.engine.close()
        self.server_close()  # joins in-flight handler threads
        obs.flush()


def make_server(
    state: ServeState,
    host: str = "127.0.0.1",
    port: int = 0,
    max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
    queue_rows: Optional[int] = None,
    faults=None,
    debug_faults: Optional[bool] = None,
    recall_sample: float = 0.0,
) -> KnnServer:
    """Bind (port 0 = ephemeral; read ``server_address[1]``) but do not
    start — callers decide when the accept loop and warmup run.
    ``recall_sample`` arms the online recall sampler (the fraction of
    approximate batches re-answered exactly; 0 is off)."""
    return KnnServer((host, port), state, max_wait_ms=max_wait_ms,
                     queue_rows=queue_rows, faults=faults,
                     debug_faults=debug_faults, recall_sample=recall_sample)
