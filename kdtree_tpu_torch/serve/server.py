"""The HTTP layer: stdlib ``ThreadingHTTPServer`` in front of the batcher.

The port of ``kdtree_tpu/serve/server.py`` on the exact k-NN path and the
write path. Answers are byte-identical to a reference server's on the
same points and requests (``tests/test_torch_server.py``).

- ``POST /v1/knn`` — JSON ``{"queries": [[x, y, ...], ...], "k": int?,
  "deadline_ms": number?}`` in; ``{"k": int, "ids": [[...]],
  "distances": [[...]], "degraded": null | reason, "trace_id": str}`` out.
  Distances are Euclidean (float64 sqrt of the engines' f32 d2), ids the
  original point rows shifted by ``--id-offset``.
- ``POST /v1/upsert`` / ``POST /v1/delete`` — the mutable-index write
  path: ``{"ids": [...], "points": [[...]]}`` / ``{"ids": [...]}`` with
  GLOBAL ids (this shard's ``--id-offset`` is subtracted; ids below it
  are rejected). Answers stay exact at every moment and the epoch
  rebuilder compacts in the background (``kdtree_epoch``).
- ``GET /healthz`` — 200 once the index is loaded and warmed up, 503
  (with ``Retry-After``) while warming. The body carries the mutable
  block (epoch, delta rows, tombstones), the box, ``id_offset`` and the
  SLO verdicts — every key of the reference's but ``headroom``.
- ``GET /metrics`` — the Prometheus text exposition of the registry
  (``?openmetrics=1`` for the exemplar flavour).
- ``GET /debug/flight`` — the flight recorder's ring as JSON
  (``?trace=<id>`` / ``?reason=<r>`` filter it).
- ``GET /debug/history`` — the metric-history ring (``?limit=N``).
- ``GET`` / ``POST /debug/faults`` — the deterministic fault-injection
  layer (``serve/faults.py``), opt-in (``--debug-faults`` or
  ``KDTREE_TPU_FAULTS``), 403 otherwise.

What the reference serves beyond this answers 501 naming its ROADMAP
item, after reading the request body (an unread body would desync a
keep-alive connection): ``/v1/radius``, ``/v1/range`` and ``/v1/count``
(item 11), a ``/v1/knn`` body with a ``recall_target`` (item 12), and
``/debug/profile``, ``/debug/trace`` and ``/debug/costs`` (item 15).

429 shed responses carry a ``Retry-After`` header derived from the
admission queue's measured drain rate. Every ``/v1/knn`` request carries
a trace id (client ``X-Request-Id`` or server-generated, echoed as
``trace_id``) that threads admission, batcher and dispatch in the flight
ring. Handler threads are glue: validate, admit, block on the request
future, serialize. All engine work happens in the batch worker — except
the oversized-request degradation, which runs brute force right here.
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
from kdtree_tpu_torch.obs import flight
from kdtree_tpu_torch.obs import history as obs_history
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

__all__ = ["GracefulHTTPServer", "JsonRequestHandler", "KnnRequestHandler",
           "KnnServer", "make_server",
           "FaultSpecError"]  # FaultSpecError re-exported for the CLI

MAX_BODY_BYTES = 64 << 20  # a [max_batch, D] float batch is far smaller
MAX_WRITE_IDS = 4096  # rows per upsert/delete request (split larger)

# write-path apply latency buckets (milliseconds): healthy masked-write
# applies sit in the sub-10ms range
_WRITE_LATENCY_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0,
)

# the reference's endpoints this port answers 501, by the ROADMAP queue 1
# item that brings them
_NOT_PORTED = {
    "/v1/radius": 11, "/v1/range": 11, "/v1/count": 11,
    "/debug/profile": 15, "/debug/trace": 15, "/debug/costs": 15,
}

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


def _not_ported(what: str, item: int) -> dict:
    return {"error": f"{what} is not ported to kdtree_tpu_torch yet "
                     f"(ROADMAP queue 1 item {item})"}


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
        # one unserializable value must not drop the connection
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
        item = _NOT_PORTED.get(
            "/debug/trace" if path.startswith("/debug/trace/") else path)
        if item is not None:
            self._send_json(501, _not_ported(f"GET {path}", item))
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
        # SLO verdict rides along without gating readiness
        body["slo"] = state.slo_engine.health_block()
        return body

    # -- POST ---------------------------------------------------------------

    def do_POST(self) -> None:
        path = self.path.split("?", 1)[0]
        if path == "/debug/faults":
            self._do_debug_faults()
            return
        if path in ("/v1/upsert", "/v1/delete"):
            self._do_write("upsert" if path == "/v1/upsert" else "delete")
            return
        if path in _NOT_PORTED:
            if path.startswith("/v1/") and self._fire_fault(SITE_VERB):
                return
            self._drain_body()
            self._send_json(501, _not_ported(f"POST {path}", _NOT_PORTED[path]))
            return
        if path != "/v1/knn":
            self._send_json(404, {"error": f"no such path: {path}"})
            return
        if self._fire_fault(SITE_KNN):
            return
        trace = _trace_id(self.headers)
        parsed = self._parse_knn_body()
        if parsed is None:
            return  # error response already sent
        queries, k, deadline_s = parsed
        state: ServeState = self.server.state
        if not state.ready:
            _count_request("unready")
            self._send_json(503, {"error": "index is still warming up"},
                            extra_headers={"Retry-After": "1"})
            return
        if queries.shape[0] > state.max_batch:
            self._do_oversized(state, queries, k, trace)
            return
        deadline = (time.monotonic() + deadline_s) if deadline_s else None
        req = PendingRequest(queries, k, deadline, trace_id=trace)
        try:
            self.server.queue.submit(req)
        except QueueFullError:
            _count_request("shed")
            self._send_json(429, {"error": "overloaded: admission queue "
                                           "at capacity",
                                  "trace_id": trace},
                            extra_headers=self._retry_after(req.rows))
            return
        except QueueClosedError:
            _count_request("unready")
            self._send_json(503, {"error": "server is shutting down",
                                  "trace_id": trace})
            return
        if not req.event.wait(timeout=REQUEST_TIMEOUT_S):
            _count_request("timeout")
            flight.record("serve.timeout", trace=trace, rows=req.rows)
            flight.auto_dump("serve-error")
            self._send_json(504, {"error": "request timed out in service",
                                  "trace_id": trace})
            return
        if req.error is not None:
            _count_request("error")
            self._send_json(500, {"error": req.error, "trace_id": trace})
            return
        _count_request("degraded" if req.degraded else "ok")
        self._send_json(200, self._result_json(
            req.d2, req.ids, k, degraded=req.degraded, trace_id=trace))

    def _do_oversized(self, state: ServeState, queries: np.ndarray, k: int,
                      trace: str) -> None:
        """One request bigger than any micro-batch: answered HERE via
        brute force — exact, flagged degraded — instead of erroring or
        distorting the batch pipeline. The rows still charge the
        admission budget (reserve/release): the most expensive requests
        must be the first the 429 gate can refuse."""
        rows = int(queries.shape[0])
        try:
            charge = self.server.queue.reserve(rows, trace_id=trace)
        except QueueFullError:
            _count_request("shed")
            self._send_json(429, {"error": "overloaded: admission "
                                           "queue at capacity",
                                  "trace_id": trace},
                            extra_headers=self._retry_after(rows))
            return
        except QueueClosedError:
            _count_request("unready")
            self._send_json(503, {"error": "server is shutting down",
                                  "trace_id": trace})
            return
        obs.get_registry().counter(
            "kdtree_serve_degraded_total", labels={"reason": "oversized"}
        ).inc()
        flight.record("serve.oversized", trace=trace, rows=rows)
        try:
            d2, ids = state.engine.fallback_knn(queries, k)
        except Exception as e:
            _count_request("error")
            flight.record("serve.error", trace=trace, error=repr(e)[:200])
            flight.auto_dump("serve-error")
            self._send_json(500, {"error": f"engine failure: {e!r}",
                                  "trace_id": trace})
            return
        finally:
            self.server.queue.release(charge)
        _count_request("degraded")
        self._send_json(200, self._result_json(
            d2, ids, k, degraded="oversized", trace_id=trace))

    def _parse_knn_body(
        self,
    ) -> Optional[Tuple[np.ndarray, int, Optional[float]]]:
        """Validated (queries f32[q, D], k, deadline seconds | None), or
        None with the 4xx/501 already written. Every rejection names what
        was wrong."""
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
        if payload.get("recall_target") is not None:
            # absent (or null) is the exact path; the recall dial itself
            # is not here yet
            self._send_json(501, _not_ported("recall_target on /v1/knn", 12))
            return None
        return queries, k, deadline_s

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
        t0 = time.perf_counter()
        try:
            if op == "upsert":
                res = engine.upsert(local, points)
            else:
                res = engine.delete(local)
        except ValueError as e:
            self._send_json(400, {"error": str(e), "trace_id": trace})
            return
        except RuntimeError as e:
            self._send_json(503, {"error": str(e), "trace_id": trace})
            return
        # apply duration includes the engine-lock wait, so rebuild-swap
        # contention shows up here, not only in a profiler capture
        apply_ms = (time.perf_counter() - t0) * 1e3
        self.server.write_latency[op].observe(apply_ms, exemplar=trace)
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

    def _result_json(
        self, d2: np.ndarray, ids: np.ndarray, k: int,
        degraded: Optional[str], trace_id: str = "",
    ) -> dict:
        dist = np.sqrt(d2[:, :k].astype(np.float64))
        ids = ids[:, :k]
        offset = self.server.state.id_offset
        if offset:
            # sharded serving answers GLOBAL ids: shard-local rows shift
            # by the shard's offset, padding ids stay -1; int64 so a deep
            # shard cannot wrap the i32 gid table
            ids = np.where(ids >= 0, ids.astype(np.int64) + offset, -1)
        return {
            "k": k,
            "ids": ids.tolist(),
            "distances": dist.tolist(),
            "degraded": degraded,
            "trace_id": trace_id,
        }


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
    ) -> None:
        super().__init__(address, KnnRequestHandler)
        self.state = state
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
        self.batcher = MicroBatcher(
            state.engine, self.queue,
            max_batch=state.max_batch,
            max_wait_ms=max_wait_ms,
            faults=self.faults,
        )
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
) -> KnnServer:
    """Bind (port 0 = ephemeral; read ``server_address[1]``) but do not
    start — callers decide when the accept loop and warmup run."""
    return KnnServer((host, port), state, max_wait_ms=max_wait_ms,
                     queue_rows=queue_rows, faults=faults,
                     debug_faults=debug_faults)
