"""The open-loop runner: replay a schedule, emit a capacity block.

The port of ``kdtree_tpu/loadgen/runner.py``, host code copied as it is.

The runner takes a precomputed :class:`~kdtree_tpu_torch.loadgen.schedule.
Schedule` and a live target (a ``serve`` shard or a
``route`` front) and does exactly three things:

1. **Dispatch on schedule.** A scheduler walks the arrivals and hands
   each one to a worker pool *at its intended time* — it never waits
   for a response. The pool is sized by ``max_inflight``; if every
   worker is busy the arrival queues client-side, and because latency
   is measured from the **intended** send time, that wait is charged to
   the measurement, not hidden from it (the report carries the send-lag
   p99 so a client-saturated run is self-describing).
2. **Classify.** Each response lands in its step's accumulator:
   ok / shed (429) / degraded / partial / error (5xx, protocol) /
   timeout, plus the intended-latency sample. Goodput is 200-answers
   per second of step time.
3. **Summarize.** Per step: client-side p50/p95/p99 intended latency,
   goodput, shed/degraded/partial/error fractions. Across steps: the
   **knee** — the highest offered rate whose step met the latency SLO
   at the configured quantile with an acceptable bad fraction. A final
   ``/metrics`` scrape folds the server's own write-path evidence
   (``kdtree_write_latency_ms``, the epoch-rebuild p99 delta, the
   epoch counter) into the block, so one artifact carries both sides
   of the run.

Every request carries ``X-Loadgen-Rate`` (the step's offered rate) —
the serving process mirrors it into a gauge and a flight event, so an
SLO PAGE that fires mid-run names the offered rate in its incident
dump. Step transitions and the knee verdict land in this process's own
flight ring too.

Stdlib + numpy only — no device; the client must not perturb
the machine it measures.
"""

from __future__ import annotations

import http.client
import json
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

import numpy as np

from kdtree_tpu_torch.obs import flight

CAPACITY_VERSION = 1
DEFAULT_SLO_MS = 250.0  # matches the request-p99-latency serving SLO
DEFAULT_SLO_QUANTILE = 0.99
DEFAULT_MAX_BAD_FRAC = 0.05
DEFAULT_MAX_INFLIGHT = 64
DEFAULT_TIMEOUT_S = 10.0
# relative band the capacity-headroom model's predicted rate must land
# within of the loadgen-measured knee (same posture as trend's
# DEFAULT_BAND): a model off by more than this is not a model
DEFAULT_KNEE_BAND = 0.5

__all__ = ["discover", "run_load", "compute_knee", "scrape_server_block",
           "scrape_pool_counters", "scrape_cost_classes",
           "CAPACITY_VERSION", "DEFAULT_KNEE_BAND"]


def _host_port(target: str) -> Tuple[str, int]:
    parsed = urlparse(target if "//" in target else f"http://{target}")
    if not parsed.hostname or not parsed.port:
        raise ValueError(
            f"target {target!r} must be http://host:port"
        )
    return parsed.hostname, parsed.port


def _request(
    target: str, method: str, path: str, body: Optional[dict],
    timeout_s: float, headers: Optional[Dict[str, str]] = None,
) -> Tuple[int, Optional[dict]]:
    """One one-shot HTTP exchange; (status, parsed JSON | None). Raises
    OSError/http.client.HTTPException on transport failure — the caller
    decides whether that is an outcome or a fatal. Used by the control
    plane (discovery); the measured load path uses per-worker
    keep-alive connections (:class:`_WorkerConn`)."""
    host, port = _host_port(target)
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        payload = None if body is None else json.dumps(body).encode()
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request(method, path, body=payload, headers=hdrs)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            parsed = json.loads(raw) if raw else None
        except ValueError:
            parsed = None
        return resp.status, parsed
    finally:
        conn.close()


# reuse a worker's keep-alive connection only while comfortably inside
# the serve handlers' 5 s idle socket timeout: a connection the server
# already closed would turn the first request after an idle spell into
# a spurious connection-reset "error" in the measurement
_CONN_IDLE_REUSE_S = 2.0


class _WorkerConn:
    """One worker thread's persistent HTTP connection to the target.

    The measured path must not pay a TCP handshake per request (at
    sustained ladder rates that both depresses the measured quantiles —
    the knee would partly measure the generator — and churns one
    ephemeral port per request). Stale or failed connections are closed
    and reopened; a request that failed on the wire is NOT retried —
    the failure is the measurement."""

    __slots__ = ("host", "port", "timeout_s", "conn", "last")

    def __init__(self, target: str, timeout_s: float) -> None:
        self.host, self.port = _host_port(target)
        self.timeout_s = timeout_s
        self.conn = None
        self.last = 0.0

    def request(self, path: str, body: dict,
                headers: Dict[str, str]) -> Tuple[int, Optional[dict]]:
        now = time.monotonic()
        if self.conn is None or now - self.last > _CONN_IDLE_REUSE_S:
            self.close()
            self.conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers)
        try:
            self.conn.request("POST", path, body=json.dumps(body).encode(),
                              headers=hdrs)
            resp = self.conn.getresponse()
            raw = resp.read()
        except BaseException:
            self.close()  # never leave a half-read connection for reuse
            raise
        self.last = time.monotonic()
        if resp.will_close:
            self.close()
        try:
            parsed = json.loads(raw) if raw else None
        except ValueError:
            parsed = None
        return resp.status, parsed

    def close(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except Exception:
                pass
            self.conn = None


def _write_base_of(detail: Dict) -> int:
    """The first id fresh upserts can mint against one shard without
    colliding with its served rows. A spatially-partitioned shard
    serves GLOBAL morton-rank ids at ``id_offset`` 0 — its occupied
    span is the ``spatial.id_range``, not ``[0, n)`` (offset + n would
    collide with a sibling shard's ids)."""
    spatial = detail.get("spatial")
    if isinstance(spatial, dict):
        id_range = spatial.get("id_range")
        try:
            return int(id_range[1])
        except (TypeError, ValueError, IndexError):
            pass
    return int(detail.get("id_offset", 0)) + int(detail.get("n", 0))


def _leaf_details(entry: Dict) -> List[Dict]:
    """The data-bearing leaf healthz details under one router shard
    entry. A plain shard's own detail carries ``dim`` directly; a
    replica set's primary may be ejected, so the first serving
    replica's detail stands in; and under two-level routing the entry
    is a CHILD ROUTER whose detail is its own aggregated breakdown —
    recurse, so a parent target sums n over the whole tree."""
    detail = entry.get("detail") or {}
    if "dim" in detail:
        return [detail]
    for rep in entry.get("replicas") or []:
        rdetail = rep.get("detail") or {}
        if "dim" in rdetail:
            return [rdetail]
    leaves: List[Dict] = []
    for sub in detail.get("shards") or []:
        leaves.extend(_leaf_details(sub))
    return leaves


def discover(
    target: str, timeout_s: float = 5.0, retries: int = 60,
    retry_sleep_s: float = 0.5,
) -> Dict:
    """Read the target's ``/healthz`` until it answers ready and derive
    the schedule facts: ``dim``, total ``n``, ``k_max``, and
    ``write_base`` (the first id fresh upserts can mint without
    colliding with served rows). Handles both shapes: a shard's flat
    body and the router's aggregated ``shards`` breakdown (per-shard
    detail = that shard's own healthz body)."""
    last = None
    for _ in range(max(int(retries), 1)):
        try:
            status, body = _request(target, "GET", "/healthz", None,
                                    timeout_s)
        except (OSError, http.client.HTTPException) as e:
            last = repr(e)
            time.sleep(retry_sleep_s)
            continue
        if status == 200 and isinstance(body, dict):
            if "dim" in body:
                return {
                    "dim": int(body["dim"]),
                    "n": int(body.get("n", 0)),
                    "k_max": int(body.get("k_max", 1)),
                    "write_base": _write_base_of(body),
                }
            if "shards" in body:
                dims, kmaxs, bases, total = [], [], [0], 0
                for s in body["shards"]:
                    for detail in _leaf_details(s):
                        dims.append(int(detail["dim"]))
                        kmaxs.append(int(detail.get("k_max", 1)))
                        total += int(detail.get("n", 0))
                        bases.append(_write_base_of(detail))
                if dims:
                    return {
                        "dim": dims[0],
                        "n": total,
                        "k_max": min(kmaxs),
                        "write_base": max(bases),
                    }
        last = f"healthz answered {status}"
        time.sleep(retry_sleep_s)
    raise RuntimeError(
        f"target {target} never reported ready: {last}"
    )


# --------------------------------------------------------------------------
# per-step accounting
# --------------------------------------------------------------------------


class _StepAcc:
    """One rate step's outcome ledger (appended under the runner lock —
    the lock guards list/int updates only, never I/O)."""

    __slots__ = ("rate", "intended", "sent", "latencies_ms",
                 "send_lag_ms", "counts", "gears", "fanout", "slowest",
                 "verbs")

    def __init__(self, rate: float) -> None:
        self.rate = float(rate)
        self.intended = 0
        self.sent = 0
        self.latencies_ms: List[float] = []
        self.send_lag_ms: List[float] = []
        self.counts = {
            "ok": 0, "shed": 0, "degraded": 0, "partial": 0,
            "errors": 0, "timeouts": 0, "writes_ok": 0,
        }
        # answered-query gear distribution (docs/SERVING.md
        # "Degradation ladder"): "exact", "approx:<t>", or
        # "brute-deadline" — the response's gear token, so a capacity
        # step says WHICH gear its goodput was measured at
        self.gears: Dict[str, int] = {}
        # per-answered-query fan-out samples (contacted / total from a
        # router response's shards block; empty against a plain shard
        # target) — the selective fan-out evidence (docs/SERVING.md
        # "Spatial sharding & selective fan-out")
        self.fanout: List[float] = []
        # (latency_ms, request id) of the step's slowest exchange: the
        # id doubles as the TRACE id server-side, so the capacity block
        # names the exact trace to pull a waterfall for (``trace --id
        # <it> --target <router>``)
        self.slowest: Optional[Tuple[float, str]] = None
        # per-read-verb ledger (docs/SERVING.md "Query verbs"),
        # populated only when the schedule carries a verb mix: verb →
        # {"lat": [...], "ok": n, "sent": n, "bad": n} — the per-verb
        # latency/goodput columns and the per-verb knees come from here
        self.verbs: Dict[str, Dict] = {}


def _classify(op: str, status: int, body: Optional[dict]) -> List[str]:
    """Outcome tags for one completed exchange (a 200 can be both ok
    and degraded/partial — the fractions are independent signals)."""
    if status == 429:
        return ["shed"]
    if status != 200:
        return ["errors"]
    tags = ["ok"]
    if op != "query":
        tags.append("writes_ok")
        return tags
    degraded = (body or {}).get("degraded")
    if isinstance(degraded, str):
        tags.append("partial" if degraded.startswith("partial")
                    else "degraded")
    return tags


def _gear_of(op: str, status: int, body: Optional[dict]) -> Optional[str]:
    """The answering gear of one completed QUERY exchange — the
    response's gear token, "exact" when a 200 carries none. None for
    writes and failures (they have no gear)."""
    if op != "query" or status != 200:
        return None
    gear = (body or {}).get("gear")
    return gear if isinstance(gear, str) else "exact"


def _fanout_of(op: str, status: int,
               body: Optional[dict]) -> Optional[float]:
    """Contacted-shard fraction of one answered QUERY exchange — the
    router's ``shards`` block (contacted / total). None for plain
    shard targets (no block), writes, and failures. Pre-selective
    routers carry no ``contacted`` key; their ``answered`` stands in
    (contacted == answered under full scatter)."""
    if op != "query" or status != 200:
        return None
    shards = (body or {}).get("shards")
    if not isinstance(shards, dict):
        return None
    total = shards.get("total")
    contacted = shards.get("contacted", shards.get("answered"))
    if not isinstance(total, int) or not isinstance(contacted, int) \
            or total < 1:
        return None
    return contacted / total


def _quantiles_ms(vals: List[float]) -> Dict[str, Optional[float]]:
    if not vals:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
    arr = np.asarray(vals, dtype=np.float64)
    p50, p95, p99 = np.percentile(arr, [50.0, 95.0, 99.0])
    return {"p50_ms": round(float(p50), 3), "p95_ms": round(float(p95), 3),
            "p99_ms": round(float(p99), 3)}


def compute_knee(
    steps: List[dict],
    slo_ms: float = DEFAULT_SLO_MS,
    slo_quantile: float = DEFAULT_SLO_QUANTILE,
    max_bad_frac: float = DEFAULT_MAX_BAD_FRAC,
) -> float:
    """The capacity verdict: the highest offered rate whose step met
    the SLO — quantile latency within ``slo_ms`` AND
    (shed + errors + timeouts) / sent within ``max_bad_frac``. 0.0 when
    no step qualified (the service has no measured capacity at this
    ladder — itself a finding, not an absence of data).

    Only the quantiles the steps actually report are judgeable; an
    unsupported value must be an error, not a silent fall-back to p99
    that contradicts the ``slo_quantile`` the artifact publishes."""
    qkey = {0.5: "p50_ms", 0.95: "p95_ms", 0.99: "p99_ms"}.get(
        round(float(slo_quantile), 4)
    )
    if qkey is None:
        raise ValueError(
            f"slo_quantile must be one of 0.5 / 0.95 / 0.99 (the "
            f"reported step quantiles), got {slo_quantile}"
        )
    knee = 0.0
    for s in steps:
        if not s.get("sent"):
            continue
        lat = s.get(qkey)
        if lat is None or lat > slo_ms:
            continue
        if s.get("bad_frac", 1.0) > max_bad_frac:
            continue
        knee = max(knee, float(s["rate"]))
    return knee


# --------------------------------------------------------------------------
# server-side evidence scrape
# --------------------------------------------------------------------------


def _parse_prom_lines(text: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        try:
            out[key] = float(val)
        except ValueError:
            continue
    return out


def _sum_series(parsed: Dict[str, float], family: str,
                must_contain: str = "") -> Optional[float]:
    """Sum every series of ``family`` whose key contains
    ``must_contain`` (matches across extra labels — a federated router
    scrape adds ``shard=...``)."""
    vals = [
        v for k, v in parsed.items()
        if (k == family or k.startswith(family + "{"))
        and must_contain in k
    ]
    return sum(vals) if vals else None


def _max_series(parsed: Dict[str, float], family: str) -> Optional[float]:
    """Max over a family's series — for stateful gauges like the epoch,
    where a federated scrape holds one series per shard/replica and a
    SUM would publish a meaningless total (6 replicas at epoch 1 are
    not 'epoch 6')."""
    vals = [
        v for k, v in parsed.items()
        if k == family or k.startswith(family + "{")
    ]
    return max(vals) if vals else None


def scrape_pool_counters(
        target: str, timeout_s: float = 2.0
) -> Optional[Tuple[float, float]]:
    """One ``/metrics`` scrape distilled to the router's connection-pool
    counters: ``(hits, misses)`` summed across series. None ONLY when
    the scrape itself failed; a 200 exposition without either family
    reads as ``(0, 0)`` — the registry exports counters lazily, so a
    pre-traffic router legitimately shows neither family at snapshot 0
    and the first window's deltas must still anchor there. A target
    that NEVER exports the families (a plain shard, a ``--no-pool``
    router) nets a zero delta across every window, and ``_reuse_frac``
    maps that to None: absent evidence, never a fake zero."""
    try:
        host, port = _host_port(target)
        conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            status, text = resp.status, resp.read().decode(
                "utf-8", "replace")
        finally:
            conn.close()
        if status != 200:
            return None
        parsed = _parse_prom_lines(text)
        hits = _sum_series(parsed, "kdtree_router_pool_hits_total")
        misses = _sum_series(parsed, "kdtree_router_pool_misses_total")
        return (hits or 0.0, misses or 0.0)
    except (OSError, http.client.HTTPException, ValueError):
        return None


def _reuse_frac(
        start: Optional[Tuple[float, float]],
        end: Optional[Tuple[float, float]],
) -> Optional[float]:
    """Connection-reuse fraction over a [start, end) counter window:
    hits / (hits + misses) of the DELTAS. None when either snapshot is
    missing or nothing was leased in the window."""
    if start is None or end is None:
        return None
    hits = end[0] - start[0]
    misses = end[1] - start[1]
    attempts = hits + misses
    if attempts <= 0:
        return None
    return round(hits / attempts, 4)


def scrape_server_block(target: str,
                        timeout_s: float = 5.0) -> Optional[Dict]:
    """One ``/metrics`` scrape distilled to the write-path evidence the
    capacity block publishes: per-op ``kdtree_write_latency_ms``
    count/mean, the epoch-rebuild p99 delta, and the epoch. Falls back
    to the router's federated scrape when the plain exposition has no
    write families (the shards hold them). None when the scrape failed
    — the client-side curve stands on its own."""
    for path in ("/metrics", "/metrics?federate=1"):
        try:
            host, port = _host_port(target)
            conn = http.client.HTTPConnection(host, port,
                                              timeout=timeout_s)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                status, text = resp.status, resp.read().decode(
                    "utf-8", "replace")
            finally:
                conn.close()
            if status != 200:
                return None
            parsed = _parse_prom_lines(text)
            writes = {}
            for op in ("upsert", "delete"):
                count = _sum_series(parsed, "kdtree_write_latency_ms_count",
                                    f'op="{op}"')
                total = _sum_series(parsed, "kdtree_write_latency_ms_sum",
                                    f'op="{op}"')
                if count:
                    writes[op] = {
                        "count": int(count),
                        "mean_ms": round((total or 0.0) / count, 3),
                    }
            if not writes and path == "/metrics":
                continue  # router front: the shards hold the families
            # max, not sum: per-shard/replica series of these are each
            # a whole statement about one process — the fleet summary
            # is the worst delta and the furthest epoch
            delta = _max_series(parsed,
                                "kdtree_mutable_rebuild_p99_delta_ms")
            epoch = _max_series(parsed, "kdtree_epoch")
            return {
                "write_latency_ms": writes,
                "rebuild_p99_delta_ms": (None if delta is None
                                         else round(delta, 3)),
                "epoch": None if epoch is None else int(epoch),
            }
        except (OSError, http.client.HTTPException, ValueError):
            return None
    return None


def scrape_cost_classes(
        target: str, timeout_s: float = 2.0,
) -> Optional[Dict[str, Dict[str, float]]]:
    """One ``/metrics`` scrape distilled to the cost ledger's per-class
    cumulative ``{requests, device_ms}`` counters, keyed
    ``"verb/gear/outcome"`` and summed across any federation labels.
    Falls back to the router's federated scrape when the plain
    exposition carries no cost families (the shards hold them). None
    when the scrape itself failed; a reachable pre-traffic target reads
    as ``{}`` so the first window's deltas can still anchor there."""
    for path in ("/metrics", "/metrics?federate=1"):
        try:
            host, port = _host_port(target)
            conn = http.client.HTTPConnection(host, port,
                                              timeout=timeout_s)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                status, text = resp.status, resp.read().decode(
                    "utf-8", "replace")
            finally:
                conn.close()
        except (OSError, http.client.HTTPException, ValueError):
            return None
        if status != 200:
            return None
        classes = _parse_cost_classes(text)
        if classes or path != "/metrics":
            return classes
        # plain scrape carried no cost families — try the router's
        # federated exposition before concluding "no traffic yet"
    return classes


def _parse_cost_classes(text: str) -> Dict[str, Dict[str, float]]:
    """Distill one exposition's cost counters to per-class cumulative
    ``{requests, device_ms}``, keyed ``"verb/gear/outcome"`` and summed
    across any extra (federation) labels."""
    classes: Dict[str, Dict[str, float]] = {}
    fields = {"kdtree_cost_requests_total": "requests",
              "kdtree_cost_device_ms_total": "device_ms"}
    for key, val in _parse_prom_lines(text).items():
        field = fields.get(key.split("{", 1)[0])
        if field is None or "{" not in key:
            continue
        labels = {}
        for part in key.split("{", 1)[1].rstrip("}").split(","):
            if "=" in part:
                lk, lv = part.split("=", 1)
                labels[lk] = lv.strip('"')
        ck = "/".join((labels.get("verb", "?"),
                       labels.get("gear", "?"),
                       labels.get("outcome", "?")))
        ent = classes.setdefault(
            ck, {"requests": 0.0, "device_ms": 0.0})
        ent[field] += val
    return classes


def _cost_delta(
        start: Optional[Dict[str, Dict[str, float]]],
        end: Optional[Dict[str, Dict[str, float]]],
) -> Optional[Dict[str, Dict[str, float]]]:
    """Per-class ``{requests, device_ms, cost_ms}`` deltas over a
    [start, end) boundary window. None when either snapshot is missing
    or no request landed in the window — absent evidence, never a fake
    zero-cost class."""
    if start is None or end is None:
        return None
    out: Dict[str, Dict[str, float]] = {}
    for ck, ent in end.items():
        base = start.get(ck, {})
        req = ent.get("requests", 0.0) - base.get("requests", 0.0)
        dev = ent.get("device_ms", 0.0) - base.get("device_ms", 0.0)
        if req > 0:
            out[ck] = {"requests": int(round(req)),
                       "device_ms": round(dev, 3),
                       "cost_ms": round(dev / req, 4)}
    return out or None


# --------------------------------------------------------------------------
# the runner
# --------------------------------------------------------------------------


def run_load(
    target: str,
    schedule,
    k: int = 4,
    slo_ms: float = DEFAULT_SLO_MS,
    slo_quantile: float = DEFAULT_SLO_QUANTILE,
    max_bad_frac: float = DEFAULT_MAX_BAD_FRAC,
    max_inflight: int = DEFAULT_MAX_INFLIGHT,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    scrape: bool = True,
    on_step=None,
    verb_radius: float = 0.1,
    knee_band: float = DEFAULT_KNEE_BAND,
) -> Dict:
    """Replay ``schedule`` against ``target``; return the full report
    (see the module docstring for the measurement contract). ``on_step``
    is an optional callback ``(step_index, rate)`` fired at each ladder
    transition — the CLI's progress line. ``verb_radius`` is the search
    radius (and range-box half-width) non-knn query verbs carry, in the
    unit-cube coordinates the schedule draws queries from — it pins
    verb selectivity so two runs at the same mix measure the same
    work."""
    # per-verb accounting only when the schedule mixes verbs: an
    # unmixed run's artifact stays byte-identical to pre-verb loadgen
    track_verbs = bool(getattr(schedule, "verb_mix", None))
    accs = [_StepAcc(r) for r in schedule.rates]
    for a in schedule.arrivals:
        accs[a.step].intended += 1
    lock = threading.Lock()
    work: "queue.Queue" = queue.Queue()

    # connection-reuse evidence: pool-counter snapshots at each step
    # boundary (docs/SERVING.md "Scaling the router"). The boundary
    # scrapes run on their own daemon threads so the open-loop
    # dispatcher never blocks on a GET; snapshot 0 and the final one
    # bracket the run synchronously (outside the measured window).
    # Attribution at a boundary is approximate by design — responses
    # from step N may still land after step N+1 opened — which is fine
    # for a fraction that moves by tens of points between the pooled
    # and --no-pool arms.
    pool_snaps: Dict[int, Tuple[float, float]] = {}
    # cost-ledger snapshots at the same boundaries: per-step per-class
    # cost columns and the run-wide predicted-knee check both difference
    # these (docs/OBSERVABILITY.md "Cost accounting & capacity headroom")
    cost_snaps: Dict[int, Dict[str, Dict[str, float]]] = {}
    snap_threads: List[threading.Thread] = []

    def snap_boundary(step: int) -> None:
        got = scrape_pool_counters(target)
        costs = scrape_cost_classes(target)
        with lock:
            if got is not None:
                pool_snaps[step] = got
            if costs is not None:
                cost_snaps[step] = costs

    if scrape:
        snap_boundary(0)
    t0 = time.monotonic()

    def record(arrival, intended: float, tags: List[str],
               done: float, actual_send: float,
               gear: Optional[str] = None,
               fanout: Optional[float] = None,
               req_id: str = "") -> None:
        acc = accs[arrival.step]
        lat_ms = (done - intended) * 1e3
        with lock:
            acc.sent += 1
            if req_id and (acc.slowest is None
                           or lat_ms > acc.slowest[0]):
                acc.slowest = (lat_ms, req_id)
            acc.latencies_ms.append(lat_ms)
            acc.send_lag_ms.append(
                max(actual_send - intended, 0.0) * 1e3)
            for tag in tags:
                acc.counts[tag] += 1
            if gear is not None:
                acc.gears[gear] = acc.gears.get(gear, 0) + 1
            if fanout is not None:
                acc.fanout.append(fanout)
            if track_verbs and arrival.op == "query":
                verb = getattr(arrival, "verb", "knn") or "knn"
                led = acc.verbs.setdefault(
                    verb, {"lat": [], "ok": 0, "sent": 0, "bad": 0})
                led["sent"] += 1
                led["lat"].append(lat_ms)
                if "ok" in tags:
                    led["ok"] += 1
                if any(tag in ("shed", "errors", "timeouts")
                       for tag in tags):
                    led["bad"] += 1

    def do_request(conn: _WorkerConn, arrival, intended: float,
                   seq: int) -> None:
        actual_send = time.monotonic()
        headers = {
            "X-Loadgen-Rate": f"{schedule.rates[arrival.step]:g}",
            # unique per arrival: an incident dump must correlate ONE
            # slow exchange to its server-side span, not a whole step
            "X-Request-Id": f"lg{schedule.seed}-{arrival.step}-{seq}",
        }
        if arrival.op == "query":
            verb = getattr(arrival, "verb", "knn") or "knn"
            point = arrival.point.tolist()
            if verb == "radius":
                path, body = "/v1/radius", {
                    "queries": [point], "r": float(verb_radius)}
            elif verb == "count":
                path, body = "/v1/count", {
                    "queries": [point], "r": float(verb_radius)}
            elif verb == "range":
                lo = (arrival.point - verb_radius).tolist()
                hi = (arrival.point + verb_radius).tolist()
                path, body = "/v1/range", {"lo": [lo], "hi": [hi]}
            else:
                path, body = "/v1/knn", {
                    "queries": [point], "k": int(k)}
            if getattr(arrival, "recall", None) is not None:
                body["recall_target"] = float(arrival.recall)
        elif arrival.op == "upsert":
            path, body = "/v1/upsert", {
                "ids": [int(arrival.gid)],
                "points": [arrival.point.tolist()]}
        else:
            path, body = "/v1/delete", {"ids": [int(arrival.gid)]}
        gear = fanout = None
        try:
            status, resp = conn.request(path, body, headers)
            tags = _classify(arrival.op, status, resp)
            gear = _gear_of(arrival.op, status, resp)
            fanout = _fanout_of(arrival.op, status, resp)
        except TimeoutError:
            # socket.timeout IS TimeoutError: the request outlived its
            # client budget — the open-loop analog of a deadline miss
            tags = ["timeouts"]
        except (http.client.HTTPException, OSError):
            tags = ["errors"]
        record(arrival, intended, tags, time.monotonic(), actual_send,
               gear, fanout, req_id=headers["X-Request-Id"])

    def worker() -> None:
        conn = _WorkerConn(target, timeout_s)
        try:
            while True:
                item = work.get()
                if item is None:
                    return
                do_request(conn, *item)
        finally:
            conn.close()

    n_workers = max(int(max_inflight), 1)
    threads = [
        threading.Thread(target=worker, name=f"kdtree-loadgen-{i}")
        for i in range(n_workers)
    ]
    for t in threads:
        t.start()

    current_step = -1
    try:
        for seq, arrival in enumerate(schedule.arrivals):
            if arrival.step != current_step:
                if scrape and arrival.step > 0:
                    st = threading.Thread(
                        target=snap_boundary, args=(arrival.step,),
                        name="kdtree-loadgen-poolsnap", daemon=True)
                    st.start()
                    snap_threads.append(st)
                current_step = arrival.step
                rate = schedule.rates[current_step]
                flight.record("loadgen.step", step=current_step,
                              rate=rate, target=target)
                if on_step is not None:
                    on_step(current_step, rate)
            intended = t0 + arrival.t
            delay = intended - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            # enqueue and move on: the schedule NEVER waits for a
            # response — that is the open-loop contract
            work.put((arrival, intended, seq))
    finally:
        for _ in threads:
            work.put(None)
        for t in threads:
            t.join()

    if scrape:
        for st in snap_threads:
            st.join(timeout=5.0)
        snap_boundary(len(accs))

    steps = []
    for si, acc in enumerate(accs):
        sent = acc.sent
        bad = (acc.counts["shed"] + acc.counts["errors"]
               + acc.counts["timeouts"])
        row = {
            "rate": acc.rate,
            "seconds": schedule.step_seconds,
            "intended": acc.intended,
            "sent": sent,
            "goodput_rps": round(acc.counts["ok"]
                                 / schedule.step_seconds, 3),
            "bad_frac": round(bad / sent, 5) if sent else None,
            "shed_frac": round(acc.counts["shed"] / sent, 5)
            if sent else None,
            "degraded_frac": round(acc.counts["degraded"] / sent, 5)
            if sent else None,
            "partial_frac": round(acc.counts["partial"] / sent, 5)
            if sent else None,
            **{key: acc.counts[key] for key in
               ("ok", "shed", "degraded", "partial", "errors",
                "timeouts", "writes_ok")},
            **_quantiles_ms(acc.latencies_ms),
            "send_lag_p99_ms": _quantiles_ms(acc.send_lag_ms)["p99_ms"],
            # the gear distribution the step's answered queries were
            # served at — a capacity point is only comparable to
            # another measured at the same gears
            "gears": dict(sorted(acc.gears.items())),
            # mean contacted-shard fraction of the step's answered
            # routed queries (None against a plain shard target): the
            # selective fan-out evidence the trend gate's
            # fanout-growth rule watches
            "fanout_frac": (round(float(np.mean(acc.fanout)), 4)
                            if acc.fanout else None),
            # the step's slowest exchange by request id — the id IS the
            # server-side trace id, so this names the waterfall to pull
            # (``trace --id <it>``) for the step's worst tail
            "slowest_trace_id": (acc.slowest[1] if acc.slowest
                                 else None),
            "slowest_ms": (round(acc.slowest[0], 3) if acc.slowest
                           else None),
            # connection-reuse fraction of the step's shard attempts
            # (pool hits / leases, from the target's own counters);
            # None against a pool-less target or when a boundary
            # scrape was lost — absent evidence, never a fake zero
            "conn_reuse_frac": _reuse_frac(pool_snaps.get(si),
                                           pool_snaps.get(si + 1)),
            # per-class cost columns for the step's boundary window
            # (additive key; None when a boundary scrape was lost):
            # knees measured at different class mixes are
            # incommensurable, and this is the evidence trend's
            # cost-growth rule compares mixes with
            "costs": _cost_delta(cost_snaps.get(si),
                                 cost_snaps.get(si + 1)),
        }
        if track_verbs:
            # per-verb latency/goodput columns (additive key — only
            # mixed runs carry it, and trend treats runs at differing
            # verb mixes as incommensurable): a mixed step's aggregate
            # quantiles blend verbs with different unit costs, so the
            # per-verb split is what a knee regression localizes with
            row["verbs"] = {
                verb: {
                    "sent": led["sent"],
                    "ok": led["ok"],
                    "goodput_rps": round(
                        led["ok"] / schedule.step_seconds, 3),
                    "bad_frac": (round(led["bad"] / led["sent"], 5)
                                 if led["sent"] else None),
                    **_quantiles_ms(led["lat"]),
                }
                for verb, led in sorted(acc.verbs.items())
            }
        steps.append(row)
    knee = compute_knee(steps, slo_ms=slo_ms, slo_quantile=slo_quantile,
                        max_bad_frac=max_bad_frac)
    verb_block = None
    if track_verbs:
        # per-verb knee: the highest OFFERED (total) ladder rate whose
        # step met the SLO judged on that verb's own samples — the
        # capacity verdict per read verb, same bar as the aggregate
        verb_block = {}
        all_verbs = sorted({v for acc in accs for v in acc.verbs})
        for verb in all_verbs:
            vsteps = []
            for acc in accs:
                led = acc.verbs.get(verb)
                if not led or not led["sent"]:
                    continue
                vsteps.append({
                    "rate": acc.rate,
                    "sent": led["sent"],
                    "bad_frac": round(led["bad"] / led["sent"], 5),
                    **_quantiles_ms(led["lat"]),
                })
            verb_block[verb] = {
                "knee_rate": compute_knee(
                    vsteps, slo_ms=slo_ms, slo_quantile=slo_quantile,
                    max_bad_frac=max_bad_frac),
            }
    server_block = scrape_server_block(target) if scrape else None
    all_fanout = [f for acc in accs for f in acc.fanout]
    capacity = {
        "capacity_version": CAPACITY_VERSION,
        "offered_unit": "req/s",
        "slo_ms": float(slo_ms),
        "slo_quantile": float(slo_quantile),
        "max_bad_frac": float(max_bad_frac),
        "knee_rate": knee,
        # run-level mean fan-out fraction (additive key, same
        # versioning posture as the per-step gears): a regression back
        # toward full scatter fails trend like a throughput cliff
        "fanout_frac": (round(float(np.mean(all_fanout)), 4)
                        if all_fanout else None),
        # run-level connection-reuse fraction over the whole ladder
        # (additive key, same versioning posture as fanout_frac): the
        # pooled-vs---no-pool A/B's second axis next to the knee
        "conn_reuse_frac": _reuse_frac(
            pool_snaps.get(0), pool_snaps.get(len(accs))),
        "steps": steps,
        "server": server_block,
    }
    if verb_block is not None:
        # additive key, same versioning posture as fanout_frac: the
        # per-verb capacity verdicts next to the aggregate knee
        capacity["verbs"] = verb_block
    # the capacity-headroom model's A/B (additive key): predicted
    # sustainable rate from the run-wide measured cost-per-query
    # (device budget 1000 ms/s — one serial batch worker) against the
    # knee the ladder actually measured. within_band is the CI verdict.
    run_costs = _cost_delta(cost_snaps.get(0), cost_snaps.get(len(accs)))
    if run_costs:
        total_req = sum(e["requests"] for e in run_costs.values())
        total_dev = sum(e["device_ms"] for e in run_costs.values())
        if total_req > 0 and total_dev > 0:
            cpq = total_dev / total_req
            predicted = 1000.0 / cpq
            capacity["predicted"] = {
                "cost_per_query_ms": round(cpq, 4),
                "predicted_rate": round(predicted, 3),
                "knee_rate": knee,
                "band": float(knee_band),
                "within_band": (abs(predicted - knee) <= knee_band * knee
                                if knee > 0 else None),
                "classes": run_costs,
            }
    flight.record("loadgen.knee", knee_rate=knee, slo_ms=float(slo_ms),
                  steps=len(steps), target=target)
    return {
        "loadgen_version": 1,
        "target": target,
        "schedule": schedule.describe(),
        "k": int(k),
        "capacity": capacity,
    }
