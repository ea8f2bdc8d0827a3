"""Fleet-wide distributed tracing: propagated context, tail-sampled
per-process trace buffers, cross-process assembly.

The port of ``kdtree_tpu/obs/trace.py``, host code copied as it is (the
port's lock factory in place of the lock-order sanitizer's); it reads the
same ``KDTREE_TPU_TRACE*`` environment names, speaks the same header, and
assembles and renders byte-equal waterfalls for the same span lists.

The serving stack is a tree — client → router → replica sets → shard
batcher → device dispatch, with retries, hedges and two scatter waves —
and per-process flight rings cannot answer "where did THIS request's
180 ms go" without hand-joining N of them. This module closes that gap
the way Dapper (Sigelman et al., 2010) did:

- **Propagation.** The router mints a W3C-traceparent-style context per
  request (``00-<trace_id>-<parent_span_id>-<flags>``, flags bit 0 =
  head-sampled) and forwards it on every shard-bound call — scatter
  waves, retries, hedges, writes. Health probes are deliberately
  excluded: they are the router's own heartbeat, not request causality.
  One deviation from W3C on purpose: the trace id is the existing
  request id (client ``X-Request-Id`` or server-minted, sanitized to
  ``[A-Za-z0-9._-]``), NOT 128-bit hex — it may contain dashes, so the
  header is parsed right-anchored (version first, flags last, span id
  second-to-last, everything between is the trace id).

- **Tail-sampled buffers.** Every process keeps a bounded ring of
  recent traces (flight-ring discipline: an RLock from the lock
  factory, never raises, env-tunable, ``KDTREE_TPU_TRACE=0`` kill
  switch for A/B overhead measurement). At response time the interesting
  tail — slow (p99-relative), errored, partial, hedged,
  deadline-degraded, wave-2 — is *promoted* to pinned retention;
  head-sampling (the context's sampled flag, ``--trace-frac``) covers
  the boring baseline. Incident flight dumps gain a
  ``trace-<reason>.json`` companion of the pinned traces.

- **Assembly.** ``GET /debug/trace/<id>`` serves one process's span
  list; the router's ``?assemble=1`` fans out to the shards the trace
  contacted and joins the span forest on this module's
  :func:`assemble`, mapping each shard's wall clock onto the router's
  via the RTT-midpoint offset the health-probe loop estimates
  (:func:`estimate_clock_offset`, published as
  ``kdtree_router_clock_skew_ms{shard}``). Orphan spans (parent never
  arrived) and unaccounted root-time gaps are flagged, never hidden.
  :func:`render_waterfall` turns an assembled trace into the ASCII
  waterfall ``python -m kdtree_tpu_torch trace`` prints.

Cost model: recording one span is one dict build + a locked append
(the flight ring's always-on tier); assembly and rendering run only on
demand. The port has no router yet (ROADMAP item 18): its server adopts
a propagated context or mints a local root.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional

from kdtree_tpu_torch.utils import locks

__all__ = [
    "TRACE_HEADER", "TraceContext", "mint", "parse", "fmt", "adopt",
    "outbound_header", "head_sampled", "new_span_id", "active",
    "current", "record_span", "promote", "get_trace", "index",
    "buffer", "reset", "auto_dump", "SlowTracker",
    "estimate_clock_offset", "assemble", "render_waterfall",
]

# the one propagation header: the reference's literal, so a reference
# router's context reaches a port shard
TRACE_HEADER = "X-Trace-Context"
TRACE_VERSION = 1
CONTEXT_VERSION = "00"

# promotion reasons are a BOUNDED enum (they feed the
# kdtree_trace_promoted_total counter's label); anything else counts as
# "manual" so a caller typo cannot mint an unbounded label set
PROMOTE_REASONS = (
    "slow", "error", "partial", "hedged", "degraded", "wave2",
    "sampled", "manual",
)

DEFAULT_TRACE_CAPACITY = 256   # recent traces retained per process
DEFAULT_PINNED_CAPACITY = 64   # promoted traces pinned per process
MAX_SPANS_PER_TRACE = 512      # one runaway trace must not eat the ring


def _env_int(name: str, default: int) -> int:
    """Env-tunable capacity, defaulting (not crashing) on garbage —
    same contract as the flight ring's ``_env_capacity``."""
    raw = os.environ.get(name, "")
    try:
        v = int(raw) if raw else default
    except ValueError:
        return default
    return v if v >= 1 else default


# ---------------------------------------------------------------------------
# context: mint / parse / propagate
# ---------------------------------------------------------------------------


class TraceContext:
    """One hop's trace context: which trace, which span is the parent
    of everything the receiving process does, and whether the trace was
    head-sampled at mint time."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 sampled: bool = False) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    def child(self) -> "TraceContext":
        """A fresh context for one downstream call: same trace, new
        parent span id."""
        return TraceContext(self.trace_id, new_span_id(), self.sampled)

    def __repr__(self) -> str:  # debug-friendly, never on a hot path
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, sampled={self.sampled})")


def new_span_id() -> str:
    """A fresh 16-hex span id (no dashes — the header parse is
    right-anchored on that)."""
    return uuid.uuid4().hex[:16]


def mint(trace_id: str, sampled: bool = False) -> TraceContext:
    """Mint a request's root context (what the router front does)."""
    return TraceContext(trace_id, new_span_id(), sampled)


def fmt(ctx: TraceContext) -> str:
    """The wire form: ``00-<trace_id>-<span_id>-<flags>``."""
    return (f"{CONTEXT_VERSION}-{ctx.trace_id}-{ctx.span_id}-"
            f"{'01' if ctx.sampled else '00'}")


def parse(value: Optional[str]) -> Optional[TraceContext]:
    """Parse the wire form back, or None for anything malformed — a bad
    header from an arbitrary client must degrade to "untraced", never
    to an error. Right-anchored split: the trace id may contain dashes
    (it is the sanitized request id), the span id and flags cannot."""
    if not value or not isinstance(value, str) or len(value) > 256:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4 or parts[0] != CONTEXT_VERSION:
        return None
    flags, span_id = parts[-1], parts[-2]
    trace_id = "-".join(parts[1:-2])
    if flags not in ("00", "01") or not trace_id:
        return None
    if not span_id or not all(c in "0123456789abcdef" for c in span_id):
        return None
    return TraceContext(trace_id, span_id, sampled=(flags == "01"))


def adopt(headers, trace_id: str) -> TraceContext:
    """What a shard server does on arrival: adopt the router's
    propagated context, or mint a local root (direct clients get local
    traces for free)."""
    ctx = parse(headers.get(TRACE_HEADER)) if headers is not None else None
    return ctx if ctx is not None else mint(trace_id)


def outbound_header(ctx: Optional[TraceContext]) -> str:
    """The header VALUE to forward downstream (empty string when
    tracing is off / no context — forwarding an empty value is
    harmless and keeps call sites branch-free)."""
    return fmt(ctx) if ctx is not None else ""


def head_sampled(trace_id: str, frac: float) -> bool:
    """Deterministic head-sampling decision: a stable hash of the trace
    id against ``frac`` (no RNG: a seeded drill must sample
    reproducibly, and retries of one id must agree with each other)."""
    if frac <= 0.0:
        return False
    if frac >= 1.0:
        return True
    import zlib

    return (zlib.crc32(trace_id.encode("utf-8", "replace")) % 10000) \
        < frac * 10000


# ---------------------------------------------------------------------------
# thread-local active context (what obs.span links through)
# ---------------------------------------------------------------------------

_tls = threading.local()


class _Active:
    """Context manager installing ``ctx`` as this thread's active trace
    context (what :func:`current` returns and ``obs.span`` links
    completed spans to). Re-entrant: restores the previous context."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]) -> None:
        self._ctx = ctx
        self._prev: Optional[TraceContext] = None

    def __enter__(self) -> Optional[TraceContext]:
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> None:
        _tls.ctx = self._prev


def active(ctx: Optional[TraceContext]) -> _Active:
    return _Active(ctx)


def current() -> Optional[TraceContext]:
    """This thread's active trace context, if any."""
    return getattr(_tls, "ctx", None)


# ---------------------------------------------------------------------------
# the tail-sampled trace buffer (flight-ring discipline)
# ---------------------------------------------------------------------------


class TraceBuffer:
    """Bounded per-process store of recent traces with pinned (tail-
    promoted) retention.

    Two tiers, both bounded by construction: ``recent`` is an LRU ring
    of the last N traces (every recorded span lands here); ``pinned``
    holds promoted traces — promotion shares the recent entry's span
    LIST object, so spans completing after promotion (a hedge loser
    finishing late) still attach to the pinned trace. Recording never
    raises into the instrumented caller."""

    def __init__(self, capacity: int = DEFAULT_TRACE_CAPACITY,
                 pinned_capacity: int = DEFAULT_PINNED_CAPACITY) -> None:
        if capacity < 1 or pinned_capacity < 1:
            raise ValueError(
                f"capacities must be >= 1, got {capacity}/{pinned_capacity}"
            )
        self.capacity = int(capacity)
        self.pinned_capacity = int(pinned_capacity)
        # REENTRANT for the same reason the flight ring's is: dump paths
        # may be entered from a signal handler mid-append on the main
        # thread
        self._lock = locks.make_rlock("obs.trace.buffer")
        self._recent: "collections.OrderedDict[str, List[dict]]" = \
            collections.OrderedDict()
        self._pinned: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._last_promoted: Dict[str, str] = {}  # reason -> trace id
        self._dropped_traces = 0
        self._dropped_spans = 0

    # -- recording (the hot side) ------------------------------------------

    def record_span(self, trace_id: str, span_id: str, parent_id: str,
                    name: str, start_unix: float, end_unix: float,
                    **attrs) -> None:
        """Append one completed span. Never raises — a telemetry bug
        must not fail the request it observes."""
        try:
            span = {
                "trace_id": trace_id, "span_id": span_id,
                "parent_id": parent_id, "name": name,
                "start_unix": start_unix, "end_unix": end_unix,
            }
            if attrs:
                span.update(attrs)
            with self._lock:
                spans = self._recent.get(trace_id)
                if spans is None:
                    spans = self._recent[trace_id] = []
                    while len(self._recent) > self.capacity:
                        evicted_id, _ = self._recent.popitem(last=False)
                        if evicted_id not in self._pinned:
                            self._dropped_traces += 1
                else:
                    self._recent.move_to_end(trace_id)
                if len(spans) >= MAX_SPANS_PER_TRACE:
                    self._dropped_spans += 1
                    return
                spans.append(span)
        except Exception:
            pass

    # -- promotion (tail sampling) -----------------------------------------

    def promote(self, trace_id: str, reason: str) -> bool:
        """Pin ``trace_id`` under ``reason`` (bounded enum — unknown
        reasons count as "manual"). Returns True when the trace was
        newly pinned; an already-pinned trace just accumulates the
        extra reason. Never raises."""
        try:
            reason = reason if reason in PROMOTE_REASONS else "manual"
            with self._lock:
                self._last_promoted[reason] = trace_id
                entry = self._pinned.get(trace_id)
                if entry is not None:
                    if reason not in entry["reasons"]:
                        entry["reasons"].append(reason)
                    return False
                spans = self._recent.get(trace_id)
                if spans is None:
                    # promote-before-record (a request that errored
                    # before any span completed): pin an empty list the
                    # recorder will keep appending to
                    spans = self._recent[trace_id] = []
                self._pinned[trace_id] = {
                    "reasons": [reason],
                    "promoted_unix": time.time(),
                    "spans": spans,  # SHARED list: late spans attach
                }
                while len(self._pinned) > self.pinned_capacity:
                    self._pinned.popitem(last=False)
            from kdtree_tpu_torch import obs

            obs.get_registry().counter(
                "kdtree_trace_promoted_total", labels={"reason": reason}
            ).inc()
            return True
        except Exception:
            return False

    # -- reading ------------------------------------------------------------

    def get(self, trace_id: str) -> Optional[dict]:
        """One trace's payload ({trace_id, pinned, reasons, spans}) or
        None when it has aged out (and was never pinned)."""
        with self._lock:
            entry = self._pinned.get(trace_id)
            if entry is not None:
                return {
                    "trace_id": trace_id, "pinned": True,
                    "reasons": list(entry["reasons"]),
                    "spans": [dict(s) for s in entry["spans"]],
                }
            spans = self._recent.get(trace_id)
            if spans is None:
                return None
            return {"trace_id": trace_id, "pinned": False,
                    "reasons": [], "spans": [dict(s) for s in spans]}

    def last_promoted(self, reason: Optional[str] = None) -> Optional[str]:
        """The most recently promoted trace id, optionally for one
        reason (``--last-slow`` reads reason="slow")."""
        with self._lock:
            if reason is not None:
                return self._last_promoted.get(reason)
            if not self._pinned:
                return None
            return next(reversed(self._pinned))

    def index(self) -> dict:
        """The ``GET /debug/trace/`` listing: pinned ids with reasons,
        newest last, plus the per-reason last-promoted pointers."""
        with self._lock:
            return {
                "trace_version": TRACE_VERSION,
                "pid": os.getpid(),
                "capacity": self.capacity,
                "pinned_capacity": self.pinned_capacity,
                "recent": len(self._recent),
                "dropped_traces": self._dropped_traces,
                "dropped_spans": self._dropped_spans,
                "pinned": [
                    {"trace_id": tid, "reasons": list(e["reasons"]),
                     "promoted_unix": e["promoted_unix"],
                     "spans": len(e["spans"])}
                    for tid, e in self._pinned.items()
                ],
                "last_promoted": dict(self._last_promoted),
            }

    def report(self, reason: str = "") -> dict:
        """The ``trace-<reason>.json`` companion payload: every pinned
        trace, plus identity to read one dump in isolation."""
        with self._lock:
            traces = [
                {"trace_id": tid, "reasons": list(e["reasons"]),
                 "promoted_unix": e["promoted_unix"],
                 "spans": [dict(s) for s in e["spans"]]}
                for tid, e in self._pinned.items()
            ]
        return {
            "trace_version": TRACE_VERSION,
            "generated_unix": time.time(),
            "reason": reason,
            "pid": os.getpid(),
            "traces": traces,
        }

    def reset(self) -> None:
        """Drop everything (test isolation — mirrors the flight ring's
        ``reset_dump_rate_limit`` contract)."""
        with self._lock:
            self._recent.clear()
            self._pinned.clear()
            self._last_promoted.clear()
            self._dropped_traces = 0
            self._dropped_spans = 0


_buffer = TraceBuffer(
    capacity=_env_int("KDTREE_TPU_TRACE_TRACES", DEFAULT_TRACE_CAPACITY),
    pinned_capacity=_env_int("KDTREE_TPU_TRACE_PINNED",
                             DEFAULT_PINNED_CAPACITY),
)

# A/B kill switch, read once at import (hot paths must not pay an env
# lookup per span): KDTREE_TPU_TRACE=0/off/none disables recording AND
# promotion — the measurement partner for the <2% overhead check, same
# idiom as KDTREE_TPU_FLIGHT
_DISABLED = os.environ.get(
    "KDTREE_TPU_TRACE", ""
).lower() in ("0", "off", "none")


def enabled() -> bool:
    return not _DISABLED


def buffer() -> TraceBuffer:
    return _buffer


def record_span(trace_id: str, span_id: str, parent_id: str, name: str,
                start_unix: float, end_unix: float, **attrs) -> None:
    """Module-level convenience over the process buffer (what
    instrumentation calls — and where the kill switch applies)."""
    if _DISABLED:
        return
    _buffer.record_span(trace_id, span_id, parent_id, name,
                        start_unix, end_unix, **attrs)


def promote(trace_id: str, reason: str) -> bool:
    if _DISABLED:
        return False
    return _buffer.promote(trace_id, reason)


def get_trace(trace_id: str) -> Optional[dict]:
    return _buffer.get(trace_id)


def index() -> dict:
    return _buffer.index()


def reset() -> None:
    _buffer.reset()


def _safe_reason(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in reason) or "dump"


def auto_dump(reason: str) -> Optional[str]:
    """Write the pinned traces as ``trace-<reason>.json`` next to the
    flight dump of the same reason (the flight module calls this after
    every claimed dump, so it piggybacks the flight rate limit — this
    never runs more often than a flight file is written). Never raises.
    Returns the path written, or None (disabled / empty / failed)."""
    if _DISABLED:
        return None
    try:
        from kdtree_tpu_torch.obs import flight

        d = flight._dump_dir()
        if d is None:
            return None
        rep = _buffer.report(reason)
        if not rep["traces"]:
            return None
        path = os.path.join(d, f"trace-{_safe_reason(reason)}.json")
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(rep, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
        os.replace(tmp, path)
        return path
    except Exception:
        return None


# ---------------------------------------------------------------------------
# tail-promotion helpers
# ---------------------------------------------------------------------------


class SlowTracker:
    """Streaming "is this request p99-slow?" verdict: a bounded window
    of recent latencies; a request is slow when it lands at or above
    the window's 0.99 quantile — relative to THIS process's own recent
    traffic, so a router fronting slow shards still promotes only its
    tail, not everything. Below ``min_samples`` every request reads
    not-slow (a cold process has no tail yet). Thread-safe; ~µs per
    note (one bisect insert into a bounded sorted list)."""

    def __init__(self, window: int = 512, quantile: float = 0.99,
                 min_samples: int = 50) -> None:
        self.window = max(int(window), 8)
        self.quantile = float(quantile)
        self.min_samples = max(int(min_samples), 2)
        self._lock = locks.make_lock("obs.trace.slow")
        self._ring: collections.deque = collections.deque(
            maxlen=self.window)
        self._sorted: List[float] = []

    def note(self, seconds: float) -> bool:
        """Record one latency; True when it is p99-slow relative to the
        window BEFORE this observation (a spike must be able to promote
        itself)."""
        try:
            s = float(seconds)
            with self._lock:
                slow = (
                    len(self._sorted) >= self.min_samples
                    and s >= self._sorted[
                        min(int(self.quantile * len(self._sorted)),
                            len(self._sorted) - 1)]
                )
                if len(self._ring) == self._ring.maxlen:
                    old = self._ring[0]
                    i = bisect.bisect_left(self._sorted, old)
                    if i < len(self._sorted):
                        del self._sorted[i]
                self._ring.append(s)
                bisect.insort(self._sorted, s)
            return slow
        except Exception:
            return False


# ---------------------------------------------------------------------------
# clock-offset estimation + cross-process assembly
# ---------------------------------------------------------------------------


def estimate_clock_offset(t0: float, t1: float,
                          server_unix: float) -> float:
    """RTT-midpoint clock-offset estimate from one probed exchange:
    how many seconds the server's wall clock reads AHEAD of ours,
    assuming the server stamped ``server_unix`` halfway through the
    [t0, t1] round trip. The error bound is ±RTT/2 — honest enough to
    order ms-scale spans across processes on one LAN (asymmetric paths
    shift the midpoint; sub-RTT gaps between processes are not
    trustworthy)."""
    return float(server_unix) - (float(t0) + float(t1)) / 2.0


def assemble(trace_id: str, sources: List[dict]) -> dict:
    """Join per-process span lists into one causally-ordered forest on
    the FIRST source's clock (the router passes itself first).

    ``sources``: ``[{"source": str, "clock_offset_s": float,
    "spans": [...], "error": str|None}, ...]`` — ``clock_offset_s`` is
    how far that source's clock reads ahead of the reference clock
    (0 for the reference itself); a source that could not be fetched
    contributes an ``error`` entry instead of silently shrinking the
    forest. Orphan spans (parent id never arrived) and unaccounted
    root-time gaps are FLAGGED in the result, not dropped."""
    spans: List[dict] = []
    src_meta: List[dict] = []
    seen_ids: set = set()
    for src in sources:
        off = float(src.get("clock_offset_s") or 0.0)
        name = str(src.get("source", "?"))
        err = src.get("error")
        src_meta.append({
            "source": name,
            "clock_offset_ms": round(off * 1e3, 3),
            "spans": len(src.get("spans") or ()),
            "error": err,
        })
        for s in src.get("spans") or ():
            # two sources backed by one process (an in-process fleet,
            # or a double-fetch) hand back the same spans: keep the
            # first copy — the reference-clock source comes first
            if s.get("span_id") in seen_ids:
                continue
            seen_ids.add(s.get("span_id"))
            adj = dict(s)
            adj["source"] = name
            adj["start_unix"] = float(s["start_unix"]) - off
            adj["end_unix"] = float(s["end_unix"]) - off
            spans.append(adj)
    spans.sort(key=lambda s: (s["start_unix"], s["end_unix"]))
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if not s.get("parent_id")]
    orphans = [
        s["span_id"] for s in spans
        if s.get("parent_id") and s["parent_id"] not in by_id
    ]
    coverage = None
    if roots:
        root = roots[0]
        r0, r1 = root["start_unix"], root["end_unix"]
        kids = [
            (max(s["start_unix"], r0), min(s["end_unix"], r1))
            for s in spans
            if s.get("parent_id") == root["span_id"]
            and s["end_unix"] > r0 and s["start_unix"] < r1
        ]
        kids.sort()
        accounted = 0.0
        gaps: List[dict] = []
        cursor = r0
        for a, b in kids:
            if a > cursor:
                gaps.append({
                    "start_ms": round((cursor - r0) * 1e3, 3),
                    "end_ms": round((a - r0) * 1e3, 3),
                })
            if b > cursor:
                accounted += b - max(a, cursor)
                cursor = b
        if cursor < r1:
            gaps.append({"start_ms": round((cursor - r0) * 1e3, 3),
                         "end_ms": round((r1 - r0) * 1e3, 3)})
        total = max(r1 - r0, 0.0)
        coverage = {
            "root_span_id": root["span_id"],
            "root_ms": round(total * 1e3, 3),
            "accounted_ms": round(accounted * 1e3, 3),
            "frac": round(accounted / total, 4) if total > 0 else 1.0,
            # sub-0.1ms slivers are clock noise, not evidence
            "gaps": [g for g in gaps if g["end_ms"] - g["start_ms"] >= 0.1],
        }
    return {
        "trace_version": TRACE_VERSION,
        "trace_id": trace_id,
        "assembled": True,
        "sources": src_meta,
        "spans": spans,
        "roots": [s["span_id"] for s in roots],
        "orphans": orphans,
        "coverage": coverage,
    }


# ---------------------------------------------------------------------------
# waterfall rendering (pure text; the CLI and tests share it)
# ---------------------------------------------------------------------------

_BAR_WIDTH = 40


def _depth_of(span: dict, by_id: Dict[str, dict]) -> int:
    d, seen = 0, set()
    cur = span
    while cur.get("parent_id") and cur["parent_id"] in by_id:
        if cur["span_id"] in seen:  # defensive: a cycle must not hang
            break
        seen.add(cur["span_id"])
        cur = by_id[cur["parent_id"]]
        d += 1
    return d


def _span_tag(span: dict) -> str:
    """The attribute suffix a waterfall line carries: shard / wave /
    hedge role / degradation — the fields that answer "which branch
    was this"."""
    bits = []
    if span.get("shard") is not None:
        bits.append(f"shard={span['shard']}")
    if span.get("replica"):
        bits.append(f"replica={span['replica']}")
    if span.get("wave") is not None:
        bits.append(f"wave={span['wave']}")
    if span.get("hedge"):
        bits.append(f"hedge={span['hedge']}")
    if span.get("outcome") and span.get("outcome") != "ok":
        bits.append(f"outcome={span['outcome']}")
    if span.get("degraded"):
        bits.append(f"degraded={span['degraded']}")
    return ("  [" + " ".join(bits) + "]") if bits else ""


def render_waterfall(assembled: dict, width: int = _BAR_WIDTH) -> str:
    """ASCII waterfall of an assembled trace: one line per span, bar
    position scaled to the root window, depth as indentation, orphans
    and unaccounted gaps called out at the bottom. Pure function over
    :func:`assemble`'s output — the CLI prints it, tests pin it."""
    spans = assembled.get("spans") or []
    lines = [f"trace {assembled.get('trace_id', '?')}"]
    if not spans:
        lines.append("  (no spans)")
        return "\n".join(lines) + "\n"
    by_id = {s["span_id"]: s for s in spans}
    t0 = min(s["start_unix"] for s in spans)
    t1 = max(s["end_unix"] for s in spans)
    window = max(t1 - t0, 1e-9)
    cov = assembled.get("coverage")
    if cov is not None:
        lines.append(
            f"root {cov['root_ms']:.2f}ms, "
            f"{cov['frac']:.0%} accounted by direct children, "
            f"{len(cov['gaps'])} gap(s) flagged"
        )
    lines.append(f"window {window * 1e3:.2f}ms; bar = {width} cols")
    orphan_ids = set(assembled.get("orphans") or ())
    for s in spans:
        depth = _depth_of(s, by_id)
        lo = int((s["start_unix"] - t0) / window * width)
        hi = int((s["end_unix"] - t0) / window * width)
        hi = max(hi, lo + 1)
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        dur_ms = (s["end_unix"] - s["start_unix"]) * 1e3
        name = "  " * depth + s.get("name", "?")
        mark = " !orphan" if s["span_id"] in orphan_ids else ""
        src = s.get("source")
        src_tag = f" @{src}" if src and src != "router" else ""
        lines.append(
            f"{name:<32.32s} |{bar}| {dur_ms:>9.2f}ms"
            f"{_span_tag(s)}{src_tag}{mark}"
        )
    if cov is not None and cov["gaps"]:
        for g in cov["gaps"]:
            lines.append(
                f"  gap: {g['start_ms']:.2f}..{g['end_ms']:.2f}ms "
                "unaccounted under root (flagged, not hidden)"
            )
    if orphan_ids:
        lines.append(f"  {len(orphan_ids)} orphan span(s): parent never "
                     "arrived (shard unreachable or buffer aged out)")
    return "\n".join(lines) + "\n"
