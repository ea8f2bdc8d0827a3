"""Fault-tolerant scatter/gather routing over per-shard serve processes.

The port of ``kdtree_tpu/serve/router.py``, host code copied as it is
(the port's lock factory in place of the lock-order sanitizer's). It
speaks the reference's wire protocol, so either package's router fronts
either package's shards, and a routed answer over healthy shards is
byte-identical to the single-index oracle in both.

The L1 layer of the reference is MPI data parallelism: every rank holds
a shard of the point set, every rank answers every query over its shard,
and the per-rank top-k buffers merge by distance. This module is that
layer re-expressed at serving time: N independent
``serve`` processes — each micro-batched, warm-planned, and
SLO-instrumented — behind one thin router that fans each ``POST
/v1/knn`` out and merges the per-shard top-k with the *same*
(distance, id) tie-break the SPMD forest query uses on-device
(``parallel/global_morton._merge_partials``). With every shard healthy
the routed answer is byte-identical to the single-index oracle; the
router adds horizontal scale, never approximation.

A fan-out service is only as available as its flakiest shard, so the
router is mostly a fault-tolerance kit (docs/SERVING.md "Routing &
fault tolerance"):

- **deadlines**: every scatter has an absolute budget; a shard that
  cannot answer inside it is *missing*, not *blocking*;
- **bounded retry** with jittered exponential backoff (deterministically
  seeded per (trace, shard) — a retry storm must be replayable);
- **hedging**: if a shard's attempt outlives its own p95, a second
  identical attempt fires and the first answer wins (the loser's
  connection is closed) — the tail-latency trade from the hedged-request
  literature, bounded to one hedge per attempt;
- **circuit breakers** per shard: closed → open after consecutive
  failures → half-open single probe after a cooldown → closed on
  success. An open breaker converts a known-bad shard's cost from
  "timeout per request" to "skip";
- **health ejection**: a background loop polls each shard's ``/healthz``
  and ejects shards that are unreachable, warming, or PAGE-burning their
  SLOs (a burning replica asked for traffic to be routed away);
- **partial results**: when at least ``quorum`` shards answered, the
  merged (still exact *per answered shard*) result returns 200 with
  ``degraded: "partial:k/N"`` and the missing shard indices — a k-NN
  answer over most of the index beats a 5xx for nearly every caller.
  Below quorum the router answers a crisp 503. Never a silent wrong
  answer: anything less than all-shards carries the degraded flag.

The router holds no index, no device, and no queue — shards shed (429 +
``Retry-After``, which the backoff honors) and the router propagates
pressure instead of buffering it.

**Replica sets** (docs/SERVING.md "Snapshots & replica fleets"): a
shard entry is a SET of equivalent serve processes over the same
partition — ``url0|url1|url2``, the first being the shard primary.
Reads load-balance round-robin across routable replicas, with the
whole per-replica fault-tolerance kit above (each replica owns its
breaker, latency window, and health verdict), and a hedge fires
against a *different* replica when one is available — true
tail-independence, not a second queue position behind the same slow
process. Writes go ONLY to the shard primary (secondaries are
snapshot-following read replicas and 403 writes). Exactness dedupe is
by shard ownership, not liveness: the scatter takes ONE answer per
shard set, so adding or losing replicas can never duplicate or drop a
point from the merged top-k.

Two fleet-facing extras ride on the same shard table:

- **write passthrough** (``POST /v1/upsert`` / ``/v1/delete``): the
  mutable-index write path (docs/SERVING.md "Mutable index") partitions
  ids by the owning shard — ownership is the contiguous id range
  starting at each shard's ``id_offset``, learned from its ``/healthz``
  body — and forwards each partition verbatim (ids are global; shards
  localize). Partial failures answer 502 with per-shard outcomes,
  never a silent half-write.
- **scrape federation** (``GET /metrics?federate=1``): one scrape
  returns the router's own exposition plus every shard's, re-labeled
  with ``shard="<index>"`` and regrouped per metric family (the text
  format requires families contiguous). Unreachable shards are
  reported as ``kdtree_router_federated_up{shard=...} 0`` instead of
  failing the scrape.

**Selective fan-out** (docs/SERVING.md "Spatial sharding & selective
fan-out"): when shards publish bounding boxes on ``/healthz`` (every
serve process does; a spatial partition — ``partition`` —
makes them disjoint and tight), the router applies the k-d tree's own
pruning argument one level up: rank shard sets by point-to-box lower
bound, contact the nearest few, and widen only while some query's
running k-th best distance does not strictly beat the next shard's
box bound (:mod:`kdtree_tpu_torch.serve.spatial`). Two waves always
suffice, answers are byte-identical to the full fan-out oracle, and
a ``recall_target`` instead stops widening once the guaranteed-query
fraction reaches the target (the recall dial's gear contract, spatially).
Shards without a box — a legacy fleet, or one not yet probed — are
ALWAYS contacted: no box, no pruning argument. Writes route
spatially too when every shard publishes its Morton code range:
upserts go to the region owner (plus stale-copy deletes of moved
ids elsewhere), deletes broadcast-resolve by id.
"""

from __future__ import annotations

import json
import random
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple
from urllib.parse import urlparse

import numpy as np

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.utils import locks
from kdtree_tpu_torch.obs import flight
from kdtree_tpu_torch.obs import trace as trace_mod
from kdtree_tpu_torch.serve import pool as pool_mod
from kdtree_tpu_torch.serve import spatial
from kdtree_tpu_torch.serve.server import (
    GracefulHTTPServer,
    JsonRequestHandler,
    _trace_id,
)

DEFAULT_DEADLINE_S = 2.0
DEFAULT_RETRIES = 2          # attempts per shard = retries + 1
DEFAULT_BACKOFF_BASE_S = 0.025
DEFAULT_BACKOFF_MAX_S = 0.5
DEFAULT_HEDGE_MIN_S = 0.05   # hedge-delay floor (and cold-start default)
DEFAULT_BREAKER_FAILURES = 3
DEFAULT_BREAKER_RESET_S = 2.0
DEFAULT_HEALTH_PERIOD_S = 1.0
MAX_BODY_BYTES = 64 << 20
_LAT_SAMPLES = 64            # per-shard latency window for the p95 hedge

_ROUTER_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)
# shard sets contacted per routed request (the fan-out histogram the
# selectivity acceptance reads: mean = _sum / _count)
_FANOUT_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0)
FANOUT_MODES = ("selective", "full")

# breaker states, exported as the kdtree_router_breaker_state gauge
CLOSED, OPEN, HALF_OPEN = 0, 1, 2
BREAKER_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half-open"}


class ShardError(Exception):
    """One failed shard attempt; ``retryable`` decides whether the retry
    loop may try again (4xx validation errors must not be retried — the
    request itself is wrong)."""

    def __init__(self, message: str, outcome: str, retryable: bool = True,
                 status: Optional[int] = None, body: Optional[dict] = None,
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(message)
        self.outcome = outcome  # bounded enum: see _OUTCOMES
        self.retryable = retryable
        self.status = status
        self.body = body
        self.retry_after_s = retry_after_s


_OUTCOMES = ("ok", "http_error", "shed", "network", "timeout",
             "breaker_open", "client_error")


class CircuitBreaker:
    """Per-shard closed → open → half-open machine.

    Counts *consecutive* failures (a hedge pair counts once): at
    ``failures`` the breaker opens and every ``allow()`` is refused for
    ``reset_s``; then exactly one probe request passes (half-open) — its
    success closes the breaker, its failure re-opens it for another
    cooldown. Thread-safe; transitions are reported through
    ``on_transition(old, new)`` so the router can export gauges and
    flight events without the breaker knowing about either.
    """

    def __init__(self, failures: int = DEFAULT_BREAKER_FAILURES,
                 reset_s: float = DEFAULT_BREAKER_RESET_S,
                 on_transition=None) -> None:
        if failures < 1:
            raise ValueError(f"breaker failures must be >= 1, got {failures}")
        self.failures = int(failures)
        self.reset_s = float(reset_s)
        self._on_transition = on_transition
        self._lock = locks.make_lock("route.breaker")
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False

    def _transition(self, new: int) -> Optional[Tuple[int, int]]:
        """State change under the lock; returns the (old, new) pair for
        the caller to REPORT AFTER RELEASING the lock — the reporter
        writes gauges and (on open) dumps the flight ring to disk, and
        a file write inside this lock would stall every concurrent
        allow() for its duration."""
        old, self._state = self._state, new
        return (old, new) if old != new else None

    def _report(self, pair: Optional[Tuple[int, int]]) -> None:
        if pair is not None and self._on_transition is not None:
            try:
                self._on_transition(*pair)
            except Exception:
                pass  # telemetry must not fail the breaker

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow(self, now: Optional[float] = None) -> bool:
        """May a request be sent to this shard right now? In half-open,
        only the single probe passes."""
        now = now if now is not None else time.monotonic()
        pair = None
        try:
            with self._lock:
                if self._state == CLOSED:
                    return True
                if self._state == OPEN:
                    if now - self._opened_at < self.reset_s:
                        return False
                    pair = self._transition(HALF_OPEN)
                    self._probing = True
                    return True
                # HALF_OPEN: one probe in flight at a time
                if self._probing:
                    return False
                self._probing = True
                return True
        finally:
            self._report(pair)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probing = False
            pair = (self._transition(CLOSED)
                    if self._state != CLOSED else None)
        self._report(pair)

    def record_failure(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.monotonic()
        pair = None
        with self._lock:
            self._consecutive += 1
            self._probing = False
            if self._state == HALF_OPEN or (
                self._state == CLOSED and self._consecutive >= self.failures
            ):
                self._opened_at = now
                pair = self._transition(OPEN)
        self._report(pair)


class ShardState:
    """One downstream serve process (one REPLICA of a shard): address,
    breaker, latency window (the hedge-delay source), health verdict,
    and shed backoff. ``index`` is the shard-set index; ``replica`` the
    position inside the set (0 = the write primary). ``multi`` controls
    whether metric labels carry the replica dimension — single-replica
    sets keep their historical ``{shard="i"}`` series identity."""

    def __init__(self, index: int, url: str, breaker: CircuitBreaker,
                 hedge_min_s: float = DEFAULT_HEDGE_MIN_S,
                 replica: int = 0, multi: bool = False) -> None:
        parsed = urlparse(url if "//" in url else f"http://{url}")
        if parsed.scheme != "http" or not parsed.hostname:
            raise ValueError(
                f"shard url {url!r} must be http://host:port"
            )
        self.index = index
        self.replica = int(replica)
        self.multi = bool(multi)
        self.url = url
        self.host = parsed.hostname
        self.port = parsed.port or 80
        self.breaker = breaker
        self.hedge_min_s = float(hedge_min_s)
        self._lock = locks.make_lock("route.shard")
        self._lat: List[float] = []
        self.healthy = True          # optimistic until the first probe
        self.health_detail: dict = {}
        self.retry_after_until = 0.0  # monotonic; set from 429 Retry-After
        # the shard's partition start (GLOBAL ids >= this belong here,
        # up to the next shard's offset): learned from the /healthz
        # body and kept across later probe failures — ownership is
        # topology, not liveness
        self.id_offset: Optional[int] = None
        # spatial topology, learned from the same /healthz body and
        # kept across failures exactly like id_offset: the replica's
        # published bounding box (the selective fan-out's pruning
        # input) and — for spatially-partitioned fleets — the shared
        # quantization grid plus this shard's owned Morton code range
        # (the spatial write-ownership source)
        self.box: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.grid = None  # spatial.SpatialGrid
        self.code_range: Optional[Tuple[int, int]] = None
        # RTT-midpoint clock-offset estimate (seconds this replica's
        # wall clock reads AHEAD of the router's), refreshed by every
        # successful health probe — the trace assembler's join input.
        # None until the first probed exchange; kept across later
        # failures like id_offset (a stale estimate beats none when
        # assembling a trace recorded just before an ejection)
        self.clock_offset_s: Optional[float] = None

    # -- latency / hedging ---------------------------------------------------

    def note_latency(self, seconds: float) -> None:
        with self._lock:
            self._lat.append(float(seconds))
            if len(self._lat) > _LAT_SAMPLES:
                del self._lat[0]

    def hedge_delay(self) -> float:
        """When to fire the hedge: this shard's observed p95, floored at
        ``hedge_min_s`` (which is also the cold-start default — hedging
        off a single sample would hedge everything)."""
        with self._lock:
            lat = sorted(self._lat)
        if len(lat) < 4:
            return self.hedge_min_s
        p95 = lat[min(len(lat) - 1, int(0.95 * len(lat)))]
        return max(p95, self.hedge_min_s)

    # -- shed backoff --------------------------------------------------------

    def note_retry_after(self, seconds: float,
                         now: Optional[float] = None) -> None:
        now = now if now is not None else time.monotonic()
        with self._lock:
            self.retry_after_until = max(
                self.retry_after_until, now + float(seconds)
            )

    def retry_after_remaining(self, now: Optional[float] = None) -> float:
        now = now if now is not None else time.monotonic()
        with self._lock:
            return max(0.0, self.retry_after_until - now)

    def label(self) -> dict:
        if self.multi:
            return {"shard": str(self.index), "replica": str(self.replica)}
        return {"shard": str(self.index)}

    def replica_label(self) -> dict:
        """Always replica-qualified — for the per-replica request
        counter, where the replica dimension is the whole point."""
        return {"shard": str(self.index), "replica": str(self.replica)}


class ReplicaSet:
    """One shard's replica set: the scatter takes ONE answer per set
    (exactness dedupe is by shard ownership), reads rotate round-robin
    over routable replicas, writes go to ``primary`` (replica 0)."""

    def __init__(self, index: int, replicas: List[ShardState]) -> None:
        self.index = index
        self.replicas = replicas
        self._rr = 0
        self._lock = locks.make_lock("route.replica")
        # router-side box expansion (docs/SERVING.md "Spatial sharding
        # & selective fan-out"): a routed upsert expands the cached box
        # IMMEDIATELY, covering the window until the next health probe
        # re-reads the shard's own (also already expanded) box — the
        # cached box is never stale-exclusive of a write this router
        # routed. Cleared once a probed box has caught up (contains it),
        # so a long-gone expansion cannot pin the box stale-large past
        # the epoch swap that tightened it.
        self._box_ext: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def primary(self) -> ShardState:
        return self.replicas[0]

    def pick_order(self) -> List[ShardState]:
        """All replicas in this request's rotation order — the caller
        walks it to the first healthy one whose breaker admits."""
        with self._lock:
            start = self._rr % len(self.replicas)
            self._rr += 1
        return self.replicas[start:] + self.replicas[:start]

    def hedge_candidate(self, picked: ShardState) -> Optional[ShardState]:
        """A DIFFERENT routable replica to aim the hedge at (the next
        one after ``picked`` in set order), or None — the hedge then
        falls back to re-asking the same replica, the single-replica
        behavior."""
        n = len(self.replicas)
        for off in range(1, n):
            cand = self.replicas[(picked.replica + off) % n]
            if cand.healthy and cand.breaker.state == CLOSED:
                return cand
        return None

    def id_offset(self) -> Optional[int]:
        """The set's partition start — every replica serves the same
        partition, so the first learned offset speaks for the set."""
        for r in self.replicas:
            if r.id_offset is not None:
                return r.id_offset
        return None

    def routable(self) -> bool:
        return any(r.healthy and r.breaker.state != OPEN
                   for r in self.replicas)

    # -- spatial topology ----------------------------------------------------

    def box(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The set's effective bounding box: the UNION over its
        replicas' learned boxes (replicas can lag each other by an
        epoch; a union is conservative for all of them) plus any
        router-side write expansion still ahead of the probes. None
        until some replica published one — a box-less set is never
        pruned."""
        probed = spatial.box_union([r.box for r in self.replicas])
        # read-check-clear UNDER the set lock: a concurrent
        # expand_box merging a routed write into _box_ext between an
        # unlocked read and the clear would be LOST — exactly the
        # stale-exclusive window the expansion exists to close
        with self._lock:
            ext = self._box_ext
            if ext is None:
                return probed
            if probed is not None and bool(
                np.all(probed[0] <= ext[0])
                and np.all(probed[1] >= ext[1])
            ):
                # the probed box caught up with every routed write —
                # the expansion has served its purpose
                self._box_ext = None
                return probed
        return spatial.box_union([probed, ext])

    def expand_box(self, lo: np.ndarray, hi: np.ndarray) -> None:
        with self._lock:
            ext = self._box_ext
            if ext is None:
                self._box_ext = (np.array(lo, dtype=np.float32),
                                 np.array(hi, dtype=np.float32))
            else:
                self._box_ext = (np.minimum(ext[0], lo),
                                 np.maximum(ext[1], hi))

    def spatial_grid(self):
        for r in self.replicas:
            if r.grid is not None:
                return r.grid
        return None

    def code_range_known(self) -> Optional[Tuple[int, int]]:
        for r in self.replicas:
            if r.code_range is not None:
                return r.code_range
        return None


class RouterConfig:
    """The routing knobs (CLI flags map 1:1; docs/SERVING.md)."""

    def __init__(
        self,
        deadline_s: float = DEFAULT_DEADLINE_S,
        retries: int = DEFAULT_RETRIES,
        backoff_base_s: float = DEFAULT_BACKOFF_BASE_S,
        backoff_max_s: float = DEFAULT_BACKOFF_MAX_S,
        hedge_min_s: float = DEFAULT_HEDGE_MIN_S,
        quorum: Optional[int] = None,
        breaker_failures: int = DEFAULT_BREAKER_FAILURES,
        breaker_reset_s: float = DEFAULT_BREAKER_RESET_S,
        health_period_s: float = DEFAULT_HEALTH_PERIOD_S,
        fanout: str = "selective",
        trace_frac: float = 0.0,
        pool: bool = True,
        pool_max_idle: int = pool_mod.DEFAULT_MAX_IDLE,
        pool_idle_reuse_s: float = pool_mod.DEFAULT_IDLE_REUSE_S,
        spec_wave: bool = True,
        parent: bool = False,
    ) -> None:
        if fanout not in FANOUT_MODES:
            raise ValueError(
                f"fanout must be one of {FANOUT_MODES}, got {fanout!r}"
            )
        # "selective" is the default because it is NOT a trade: with no
        # boxes learned it degrades to full fan-out, and with boxes it
        # is byte-identical by the lb argument. "full" exists for the
        # A/B (bench both, commit the pair) and as the operator's
        # big-red-switch if a fleet's boxes are ever suspect.
        self.fanout = fanout
        self.deadline_s = float(deadline_s)
        self.retries = max(int(retries), 0)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.hedge_min_s = float(hedge_min_s)
        self.quorum = quorum  # None = majority, resolved per shard count
        self.breaker_failures = int(breaker_failures)
        self.breaker_reset_s = float(breaker_reset_s)
        self.health_period_s = float(health_period_s)
        # head-sampling fraction for distributed tracing (--trace-frac):
        # tail promotion (slow/error/partial/hedged/...) is always on;
        # this additionally pins a deterministic slice of BORING
        # requests — the baseline a waterfall is read against
        if not (0.0 <= float(trace_frac) <= 1.0):
            raise ValueError(
                f"trace_frac must be in [0, 1], got {trace_frac}"
            )
        self.trace_frac = float(trace_frac)
        # hot-path scale-out knobs (docs/SERVING.md "Scaling the
        # router"): keep-alive pooling ON by default (--no-pool is the
        # A/B's fresh arm and the operator's big-red-switch), the
        # speculative widening wave likewise, and --parent marks the
        # downstream targets as CHILD ROUTERS (two-level routing) —
        # federation then scrapes them deep and labels per child.
        self.pool = bool(pool)
        self.pool_max_idle = int(pool_max_idle)
        self.pool_idle_reuse_s = float(pool_idle_reuse_s)
        self.spec_wave = bool(spec_wave)
        self.parent = bool(parent)

    def resolve_quorum(self, n_shards: int) -> int:
        if self.quorum is not None:
            q = int(self.quorum)
            if not (1 <= q <= n_shards):
                raise ValueError(
                    f"quorum {q} must be in [1, {n_shards}] shards"
                )
            return q
        return n_shards // 2 + 1  # majority


def merge_topk(
    payloads: List[dict], k: Optional[int],
) -> Tuple[List[List[float]], List[List[int]], int]:
    """Merge per-shard ``/v1/knn`` payloads into global (distances, ids).

    Exactly the SPMD forest merge (``_merge_partials``): per query,
    concatenate every shard's (distance, id) candidates, order by
    (distance, id) — the stable two-key sort that makes ties break
    identically on every code path — and keep the k best. The global
    top-k is a subset of the union of per-shard top-ks, so the merge is
    exact, and distances pass through the JSON float round-trip
    unchanged (repr round-trips float64), so an all-shards merge is
    byte-identical to the single-index oracle."""
    if not payloads:
        raise ValueError("merge_topk needs at least one shard payload")
    kk = min(p["k"] for p in payloads) if k is None else int(k)
    nq = len(payloads[0]["ids"])
    out_d: List[List[float]] = []
    out_i: List[List[int]] = []
    for qi in range(nq):
        cands: List[Tuple[float, int]] = []
        for p in payloads:
            cands.extend(zip(p["distances"][qi], p["ids"][qi]))
        cands.sort()
        top = cands[:kk]
        out_d.append([d for d, _ in top])
        out_i.append([i for _, i in top])
    return out_d, out_i, kk


def merge_gear(payloads: List[dict]) -> Optional[str]:
    """The merged answer's gear token (docs/SERVING.md "Degradation
    ladder") — the recall accounting the (distance, id) merge
    preserves: every global top-k member lives in exactly ONE shard and
    sits inside that shard's own top-k, and the merge keeps any found
    member (at most k-1 candidates can beat it), so the merged recall
    is bounded below by the worst shard's. The token therefore reports
    the MINIMUM recall target any shard answered at; exact-everywhere
    merges carry no gear, and a brute-deadline shard (exact, just slow)
    surfaces only when no approximate gear outranks it."""
    worst: Optional[float] = None
    brute = False
    for p in payloads:
        g = p.get("gear")
        if not isinstance(g, str):
            continue
        if g.startswith("approx:"):
            try:
                t = float(g.split(":", 1)[1])
            except ValueError:
                continue
            if worst is None or t < worst:
                worst = t
        elif g == "brute-deadline":
            brute = True
    if worst is not None:
        return f"approx:{worst:g}"
    return "brute-deadline" if brute else None


def merge_verb(endpoint: str, payloads: List[dict]) -> dict:
    """Merge per-shard verb payloads (docs/SERVING.md "Query verbs")
    into the single-index answer shape. Shards partition the points, so:

    - ``count`` is the SUM over answering shards — exact by
      construction, every live point is counted on exactly one shard;
    - ``radius`` is the per-query union of (distance, id) rows, deduped
      by id keeping the minimum distance (replica/box overlap safety —
      identical arithmetic on every shard makes duplicates carry
      identical distances anyway) and re-sorted by (distance, id), the
      same two-key order every shard and the oracle emit — so an
      all-shards merge is byte-identical to the single-index answer;
    - ``range`` is the per-query sorted dedup union of ids.

    ``truncated`` ORs across shards: one shard's lower bound makes the
    union/sum a lower bound."""
    if not payloads:
        raise ValueError("merge_verb needs at least one shard payload")
    nq = len(payloads[0]["counts"])
    out: dict = {"truncated": any(bool(p.get("truncated"))
                                  for p in payloads)}
    if endpoint == "count":
        out["counts"] = [sum(int(p["counts"][q]) for p in payloads)
                         for q in range(nq)]
        return out
    if endpoint == "radius":
        out_ids: List[List[int]] = []
        out_d: List[List[float]] = []
        for q in range(nq):
            best: dict = {}
            for p in payloads:
                for d, i in zip(p["distances"][q], p["ids"][q]):
                    if i not in best or d < best[i]:
                        best[i] = d
            rows = sorted((d, i) for i, d in best.items())
            out_d.append([d for d, _ in rows])
            out_ids.append([i for _, i in rows])
        out["ids"] = out_ids
        out["distances"] = out_d
        out["counts"] = [len(r) for r in out_ids]
        return out
    # range
    ids = [sorted(set(i for p in payloads for i in p["ids"][q]))
           for q in range(nq)]
    out["ids"] = ids
    out["counts"] = [len(r) for r in ids]
    return out


class RouterHandler(JsonRequestHandler):
    """Scatter/gather glue; pure host code (no device anywhere in the
    router process's request path). Serialization + keep-alive timeout
    are the shared :class:`JsonRequestHandler` contract."""

    server_version = "kdtree-tpu-route/1.0"

    # -- GET ----------------------------------------------------------------

    def do_GET(self) -> None:
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            self._send_health()
            return
        if path == "/metrics":
            from urllib.parse import parse_qs, urlparse

            qs = parse_qs(urlparse(self.path).query)
            if qs.get("federate", ["0"])[0] not in ("", "0"):
                # one scrape for the whole fleet: the router's own
                # exposition + every shard's, shard-labeled and
                # regrouped per family (docs/SERVING.md)
                self._send_bytes(
                    200,
                    self.server.federated_metrics_text().encode("utf-8"),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                return
            self._send_metrics()
            return
        if path == "/debug/flight":
            self._send_flight()
            return
        if path == "/debug/trace" or path.startswith("/debug/trace/"):
            from urllib.parse import parse_qs, urlparse

            qs = parse_qs(urlparse(self.path).query)
            if qs.get("assemble", ["0"])[0] not in ("", "0"):
                tid = path[len("/debug/trace"):].strip("/")
                if not tid:
                    self._send_json(400, {"error": "?assemble=1 needs "
                                                   "/debug/trace/<id>"})
                    return
                assembled = self.server.assemble_trace(tid)
                if assembled is None:
                    self._send_json(404, {"error": f"no such trace: "
                                                   f"{tid} (aged out or "
                                                   "never recorded)"})
                    return
                self._send_json(200, assembled)
                return
            self._send_trace(path)
            return
        if path == "/debug/shards":
            self._send_json(200, {"shards": self.server.shard_report()})
            return
        if path == "/debug/costs":
            # the fleet cost view: per-replica /debug/costs fan-out +
            # the aggregated headroom block (what `costs`
            # renders when pointed at a router)
            self._send_json(200, self.server.fleet_costs())
            return
        self._send_json(404, {"error": f"no such path: {path}"})

    def _send_health(self) -> None:
        """Aggregated readiness: the router is as ready as its quorum.
        200 while >= quorum shards are routable (healthy + breaker not
        open), 503 below — with the full per-shard breakdown either
        way, so one scrape names the failing shard."""
        rt: Router = self.server
        shards = rt.shard_report()
        available = sum(1 for s in shards if s["routable"])
        body = {
            "status": "ok" if available >= rt.quorum else "unavailable",
            "shards": shards,
            "available": available,
            "quorum": rt.quorum,
            "total": len(shards),
            # a PARENT router health-probes this router exactly like a
            # shard (docs/SERVING.md "Scaling the router"): stamp the
            # wall clock for its RTT-midpoint skew estimate
            "server_unix": time.time(),
        }
        # ... and publish the fleet's bounding box (the union over the
        # shard sets') so the parent's point-to-box pruning recurses.
        # Only when EVERY set has a box: a boxless set holds data the
        # union does not cover, and advertising a partial union would
        # let the parent prune a subtree that still owns candidates.
        set_boxes = [s.box() for s in rt.shard_sets]
        if set_boxes and all(b is not None for b in set_boxes):
            u = spatial.box_union(set_boxes)
            if u is not None:
                body["box"] = {"lo": [float(x) for x in u[0]],
                               "hi": [float(x) for x in u[1]]}
        if rt.slo_engine is not None:
            body["slo"] = rt.slo_engine.health_block()
        # fleet capacity headroom, summed over the routable replicas'
        # own /healthz headroom blocks (ejected shards contribute
        # nothing — see Router.fleet_headroom)
        body["headroom"] = rt.fleet_headroom()
        self._send_json(200 if available >= rt.quorum else 503, body)

    # -- POST ---------------------------------------------------------------

    def do_POST(self) -> None:
        path = self.path.split("?", 1)[0]
        if path not in ("/v1/knn", "/v1/upsert", "/v1/delete",
                        "/v1/radius", "/v1/range", "/v1/count"):
            self._send_json(404, {"error": f"no such path: {path}"})
            return
        # the router is an SLO-paging front a loadgen run can target:
        # mirror the declared offered rate here too, so a router-side
        # PAGE dump names it (shared helper on JsonRequestHandler)
        self._note_offered_rate()
        trace = _trace_id(self.headers)
        # the router MINTS the fleet's trace context (it is the root of
        # every fan-out): head-sampled at --trace-frac, tail-promoted
        # regardless at response time (obs/trace.py). Under two-level
        # routing the PARENT is the root — a child router ADOPTS the
        # propagated context instead, so its spans parent under the
        # parent's route/shard bar in one waterfall.
        ctx = None
        if trace_mod.enabled():
            inbound = trace_mod.parse(
                self.headers.get(trace_mod.TRACE_HEADER))
            if inbound is not None:
                ctx = inbound
                trace = inbound.trace_id
            else:
                ctx = trace_mod.mint(
                    trace,
                    sampled=trace_mod.head_sampled(
                        trace, self.server.config.trace_frac),
                )
        try:
            length = int(self.headers.get("Content-Length", ""))
        except ValueError:
            self._send_json(411, {"error": "Content-Length required"})
            return
        if not (0 <= length <= MAX_BODY_BYTES):
            self._send_json(400, {"error": "bad Content-Length"})
            return
        body = self.rfile.read(length)
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            self._send_json(400, {"error": "body is not valid JSON"})
            return
        if path in ("/v1/upsert", "/v1/delete"):
            op = "upsert" if path == "/v1/upsert" else "delete"
            code, out = self.server.route_write(op, payload, trace,
                                                ctx=ctx)
            self._send_json(code, out)
            return
        if path in ("/v1/radius", "/v1/range", "/v1/count"):
            if not isinstance(payload, dict):
                self._send_json(400, {"error": "body must be a JSON "
                                               "object"})
                return
            # shared dial, shared validator — reject here instead of
            # fanning out a request every shard will 400 (the geometry
            # itself is validated authoritatively by the shards, which
            # know the index dim; the router only reads it for pruning)
            from kdtree_tpu_torch.approx.search import (
                RECALL_TARGET_ERROR as _RT_ERR,
                parse_recall_target as _parse_rt,
            )

            if not _parse_rt(payload.get("recall_target"))[0]:
                self._send_json(400, {"error": _RT_ERR})
                return
            code, out, headers = self.server.route_verb(
                path, body, payload, trace, ctx=ctx)
            self._send_json(code, out, extra_headers=headers)
            return
        if not isinstance(payload, dict) or "queries" not in payload:
            self._send_json(400, {"error": 'body must be a JSON object '
                                           'with "queries"'})
            return
        k = payload.get("k")
        if k is not None and (not isinstance(k, int) or isinstance(k, bool)
                              or k < 1):
            self._send_json(400, {"error": "k must be a positive int"})
            return
        # recall_target rides to every shard in the VERBATIM body (the
        # scatter forwards bytes); reject a malformed one here instead
        # of fanning out a request every shard will 400 — through the
        # SAME validator the shards use, so the contracts cannot drift
        from kdtree_tpu_torch.approx.search import (
            RECALL_TARGET_ERROR,
            parse_recall_target,
        )

        if not parse_recall_target(payload.get("recall_target"))[0]:
            self._send_json(400, {"error": RECALL_TARGET_ERROR})
            return
        code, out, headers = self.server.route_knn(body, payload, k, trace,
                                                   ctx=ctx)
        self._send_json(code, out, extra_headers=headers)


class Router(GracefulHTTPServer):
    """The routing process object: accept loop + shard table + health
    loop + (optional) SLO sampler, with the same graceful-stop contract
    as the shard server — in-flight scatters drain, shard connections
    are closed in the attempt that opened them, nothing is orphaned."""

    client_gone_event = "route.client_gone"

    def __init__(
        self,
        address: Tuple[str, int],
        shard_urls: List[str],
        config: Optional[RouterConfig] = None,
        slo_engine=None,
    ) -> None:
        # validate BEFORE binding: a ValueError after super().__init__
        # would leak the bound socket (a corrected retry on the same
        # fixed port then flakes with EADDRINUSE until GC)
        if not shard_urls:
            raise ValueError("router needs at least one shard url")
        self.config = config or RouterConfig()
        self.quorum = self.config.resolve_quorum(len(shard_urls))
        parsed_sets: List[ReplicaSet] = []
        for i, entry in enumerate(shard_urls):
            # replica-set syntax (docs/SERVING.md "Snapshots & replica
            # fleets"): url0|url1|... — replica 0 is the shard primary
            urls = [u.strip() for u in str(entry).split("|")]
            if not all(urls):
                raise ValueError(
                    f"shard {i} entry {entry!r} has an empty replica url"
                )
            multi = len(urls) > 1
            replicas = [
                ShardState(
                    i, url,
                    CircuitBreaker(
                        failures=self.config.breaker_failures,
                        reset_s=self.config.breaker_reset_s,
                        on_transition=self._breaker_reporter(i, j, multi),
                    ),
                    hedge_min_s=self.config.hedge_min_s,
                    replica=j, multi=multi,
                )
                for j, url in enumerate(urls)
            ]
            parsed_sets.append(ReplicaSet(i, replicas))
        super().__init__(address, RouterHandler)
        reg = obs.get_registry()
        self.shard_sets: List[ReplicaSet] = parsed_sets
        # the flat replica list: health probing and federation walk every
        # process; routing policy walks the sets
        self.shards: List[ShardState] = [
            r for s in parsed_sets for r in s.replicas
        ]
        for shard in self.shards:
            reg.gauge("kdtree_router_breaker_state",
                      labels=shard.label()).set(CLOSED)
            reg.gauge("kdtree_router_shard_healthy",
                      labels=shard.label()).set(1)
        reg.gauge("kdtree_router_shards").set(len(self.shard_sets))
        for sset in self.shard_sets:
            reg.gauge("kdtree_router_replicas",
                      labels={"shard": str(sset.index)}).set(
                len(sset.replicas))
        self._req_lat = reg.histogram(
            "kdtree_router_request_seconds",
            buckets=_ROUTER_LATENCY_BUCKETS,
        )
        self._partial = reg.counter("kdtree_router_partial_total")
        # selective fan-out evidence (docs/SERVING.md "Spatial sharding
        # & selective fan-out"): per-request contacted-set size and the
        # running pruned-shard count — mean fan-out = _sum / _count
        self._contacted = reg.histogram(
            "kdtree_router_shards_contacted", buckets=_FANOUT_BUCKETS,
        )
        self._pruned = reg.counter("kdtree_router_shards_pruned_total")
        # the shard-call connection pool (serve/pool.py): leases ride
        # inside _call_shard; None = fresh-connection mode (the A/B's
        # control arm)
        self.pool: Optional[pool_mod.ConnectionPool] = (
            pool_mod.ConnectionPool(
                max_idle=self.config.pool_max_idle,
                idle_reuse_s=self.config.pool_idle_reuse_s,
            ) if self.config.pool else None
        )
        self.slo_engine = slo_engine
        self._serve_thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None
        self._sampler = None
        self._stopping = threading.Event()
        # the most recent X-Loadgen-Rate a client declared (see
        # JsonRequestHandler._note_offered_rate)
        self.loadgen_rate: Optional[float] = None
        # the p99-relative slowness detector behind the "slow" trace
        # promotion (obs/trace.py SlowTracker)
        self.slow_tracker = trace_mod.SlowTracker()

    # -- telemetry plumbing --------------------------------------------------

    def _breaker_reporter(self, index: int, replica: int = 0,
                          multi: bool = False):
        labels = {"shard": str(index)}
        if multi:
            labels["replica"] = str(replica)

        def report(old: int, new: int) -> None:
            reg = obs.get_registry()
            reg.gauge("kdtree_router_breaker_state", labels=labels).set(new)
            reg.counter(
                "kdtree_router_breaker_transitions_total",
                labels={**labels, "to": BREAKER_NAMES[new]},
            ).inc()
            flight.record("route.breaker", shard=index, replica=replica,
                          previous=BREAKER_NAMES[old], to=BREAKER_NAMES[new])
            if new == OPEN:
                # breaker-open IS an incident: dump the ring (rate-
                # limited) with the failing shard named in its events
                flight.auto_dump("route-breaker-open")

        return report

    def _count_request(self, status: str) -> None:
        obs.get_registry().counter(
            "kdtree_router_requests_total", labels={"status": status}
        ).inc()

    def _count_attempt(self, shard: ShardState, outcome: str) -> None:
        obs.get_registry().counter(
            "kdtree_router_shard_attempts_total",
            labels={"shard": str(shard.index), "outcome": outcome},
        ).inc()

    def _trace_route_finish(
        self, ctx: Optional[trace_mod.TraceContext], t0_wall: float,
        t_merge0: Optional[float], status: str, degraded: Optional[str],
        contacted: int, answered: int, pruned: int,
    ) -> None:
        """Close the routed request's trace: the router-side merge span,
        the ROOT route/request span (parent_id empty — this is the
        waterfall's denominator), and the tail-sampling promotions.
        Never raises — runs on every response path."""
        if ctx is None:
            return
        try:
            end = time.time()
            if t_merge0 is not None:
                trace_mod.record_span(
                    ctx.trace_id, trace_mod.new_span_id(), ctx.span_id,
                    "route/merge", t_merge0, end, answered=answered)
            attrs = {"status": status, "contacted": contacted,
                     "answered": answered, "pruned": pruned}
            if degraded:
                attrs["degraded"] = degraded
            trace_mod.record_span(ctx.trace_id, ctx.span_id, "",
                                  "route/request", t0_wall, end, **attrs)
            if status in ("unavailable", "client_error"):
                trace_mod.promote(ctx.trace_id, "error")
            if status == "partial":
                trace_mod.promote(ctx.trace_id, "partial")
            if degraded and status != "partial":
                trace_mod.promote(ctx.trace_id, "degraded")
            if status in ("ok", "partial") and \
                    self.slow_tracker.note(end - t0_wall):
                trace_mod.promote(ctx.trace_id, "slow")
            if ctx.sampled:
                trace_mod.promote(ctx.trace_id, "sampled")
        except Exception:
            pass

    # -- shard I/O -----------------------------------------------------------

    def _call_shard(
        self, shard: ShardState, body: bytes, timeout_s: float, trace: str,
        conn_box: Optional[dict] = None, tag: str = "primary",
        abort_check=None, path: str = "/v1/knn", tp: str = "",
    ) -> dict:
        """One HTTP attempt against one shard; returns the parsed
        payload or raises :class:`ShardError`. The connection handle is
        stored in ``conn_box`` (so a hedging race can abort the loser)
        and always disposed here — released to the keep-alive pool
        after a clean fully-drained exchange, closed-and-discarded on
        every other path — so shutdown can never orphan a shard
        connection. ``abort_check`` (checked after registering the
        connection) lets a hedge loser that registered AFTER the
        winner's close sweep abort itself instead of running a
        redundant full request. A REUSED pooled connection that fails
        before any response byte (the shard restarted, or its idle
        reaper won the keep-alive race) is transparently retried ONCE
        on a fresh connection: a stale socket costs one extra
        round-trip, never a false shard failure at ``retries=0``."""
        import http.client

        # the per-replica spread counter (CI's replica-smoke asserts
        # every replica of a set sees traffic): counted at dispatch, so
        # failed attempts count too — this measures where the router
        # SENT load, not who answered
        obs.get_registry().counter(
            "kdtree_router_replica_requests_total",
            labels=shard.replica_label(),
        ).inc()
        t0 = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            budget = max(timeout_s - (time.monotonic() - t0), 0.001)
            pc: Optional[pool_mod.PooledConn] = None
            if self.pool is not None:
                pc = self.pool.lease(shard.host, shard.port, budget)
                conn = pc.conn
            else:
                conn = http.client.HTTPConnection(
                    shard.host, shard.port, timeout=budget
                )
            if conn_box is not None:
                # the POOLED handle (not the raw connection) is what a
                # hedge winner's close sweep gets: PooledConn.close()
                # marks the lease dead too, so an aborted twin's socket
                # can never be returned dirty — even if the abort races
                # a release that already parked it on the idle list
                conn_box[tag] = pc if pc is not None else conn
            if abort_check is not None and abort_check():
                if pc is not None:
                    self.pool.discard(pc, "abort")
                else:
                    conn.close()
                raise ShardError(
                    f"shard {shard.index}: hedge twin already won",
                    outcome="network")
            reused = pc is not None and pc.reused
            try:
                conn.request(
                    "POST", path, body=body,
                    # X-Trace-Context propagates the distributed-trace
                    # context on EVERY outbound shard call — retries,
                    # hedges, and write partitions included (empty
                    # value = untraced)
                    headers={"Content-Type": "application/json",
                             "X-Request-Id": trace,
                             "X-Trace-Context": tp},
                )
                resp = conn.getresponse()
                raw = resp.read()
                status = resp.status
            except (TimeoutError, OSError) as e:
                # covers socket.timeout (= TimeoutError), refused
                # connections, resets, AND injected drops (the server
                # closing without a status line surfaces as
                # BadStatusLine below or a bare OSError here)
                aborted = pc is not None and pc.dead
                if pc is not None:
                    self.pool.discard(
                        pc, "abort" if aborted
                        else ("stale" if reused else "error"))
                else:
                    conn.close()
                if (reused and not aborted and attempt == 1
                        and not isinstance(e, TimeoutError)
                        and timeout_s - (time.monotonic() - t0) > 0):
                    # stale keep-alive reuse: crisp retry, fresh socket
                    flight.record("route.pool_stale_retry",
                                  shard=shard.index,
                                  replica=shard.replica, trace=trace)
                    continue
                outcome = ("timeout"
                           if isinstance(e, TimeoutError) else "network")
                raise ShardError(f"shard {shard.index}: {e!r}",
                                 outcome=outcome) from None
            except (http.client.HTTPException, ValueError,
                    AttributeError) as e:
                # ValueError: a hedge winner closing this twin's
                # connection mid-read surfaces as "I/O operation on
                # closed file" — a cancellation, not a crash.
                # AttributeError: the same close race one bytecode
                # later — http.client's _close_conn reads a fp the
                # concurrent close() already set to None ('NoneType'
                # has no attribute 'close'); escaping here killed the
                # hedge thread (caught by the blue/green fleet e2e).
                aborted = pc is not None and pc.dead
                if pc is not None:
                    self.pool.discard(
                        pc, "abort" if aborted
                        else ("stale" if reused else "error"))
                else:
                    conn.close()
                if (reused and not aborted and attempt == 1
                        and timeout_s - (time.monotonic() - t0) > 0):
                    # BadStatusLine("") IS the canonical symptom of a
                    # keep-alive connection the server already hung up
                    flight.record("route.pool_stale_retry",
                                  shard=shard.index,
                                  replica=shard.replica, trace=trace)
                    continue
                raise ShardError(f"shard {shard.index}: {e!r}",
                                 outcome="network") from None
            # the exchange completed and resp.read() drained the body
            # to EOF above — the one state a pooled connection may be
            # returned from (release itself still refuses will_close,
            # abort-marked, and shutdown-raced handles)
            if pc is not None:
                if resp.will_close or pc.dead:
                    self.pool.discard(
                        pc, "abort" if pc.dead else "error")
                else:
                    self.pool.release(pc, drained=True)
            else:
                conn.close()
            break
        if status == 429:
            retry_after = None
            try:
                retry_after = float(resp.headers.get("Retry-After", ""))
            except (TypeError, ValueError):
                pass
            raise ShardError(f"shard {shard.index} shed (429)",
                             outcome="shed", status=429,
                             retry_after_s=retry_after)
        if 400 <= status < 500:
            # the REQUEST is wrong (bad k, wrong dim): every shard will
            # agree, so propagate instead of retrying the inevitable
            try:
                err_body = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                err_body = {"error": f"shard {shard.index} answered "
                                     f"{status}"}
            raise ShardError(f"shard {shard.index}: client error {status}",
                             outcome="client_error", retryable=False,
                             status=status, body=err_body)
        if status != 200:
            raise ShardError(f"shard {shard.index}: HTTP {status}",
                             outcome="http_error", status=status)
        try:
            payload = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            raise ShardError(f"shard {shard.index}: unparseable 200 body",
                             outcome="network") from None
        # the per-endpoint sanity key: a 200 whose body lacks the
        # endpoint's result channel is a malformed shard, not an answer
        if path == "/v1/knn":
            want_key = "ids"
        elif path in ("/v1/radius", "/v1/range", "/v1/count"):
            want_key = "counts"
        else:
            want_key = "applied"
        if not isinstance(payload, dict) or want_key not in payload:
            raise ShardError(f"shard {shard.index}: malformed payload",
                             outcome="network")
        shard.note_latency(time.monotonic() - t0)
        obs.get_registry().histogram(
            "kdtree_router_shard_seconds",
            buckets=_ROUTER_LATENCY_BUCKETS, labels=shard.label(),
        ).observe(time.monotonic() - t0)
        return payload

    def _attempt_hedged(
        self, shard: ShardState, body: bytes, deadline: float, trace: str,
        allow_hedge: bool = True, hedge_shard: Optional[ShardState] = None,
        ctx: Optional[trace_mod.TraceContext] = None, wave: int = 1,
        spec: bool = False, path: str = "/v1/knn",
    ) -> Tuple[dict, ShardState]:
        """One logical attempt = a primary call plus (maybe) one hedge.
        The first success wins and the loser's connection is closed;
        both failing raises the primary's error. Raises ShardError.
        ``allow_hedge=False`` keeps a breaker's half-open probe to the
        single request its contract promises. ``hedge_shard`` aims the
        hedge at a DIFFERENT replica of the same shard set when one is
        routable — tail latency on one process says nothing about its
        siblings, which is the whole reason replica hedging beats
        re-queueing behind the same slow server.

        Returns ``(payload, winner)`` — the replica that actually
        answered — so the caller's breaker accounting can land on the
        right process (success on the winner; a picked replica whose
        SIBLING had to answer for it gets a failure mark — without
        that, a wedged replica whose hedges always rescue it would
        never trip its own breaker)."""
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise ShardError(f"shard {shard.index}: deadline exhausted",
                             outcome="timeout")
        result: dict = {}
        conns: dict = {}
        cond = locks.make_condition("route.hedge")
        reg = obs.get_registry()

        def run(tag: str) -> None:
            budget = deadline - time.monotonic()
            target = (hedge_shard
                      if tag == "hedge" and hedge_shard is not None
                      else shard)
            # each attempt carries its OWN child span id downstream, so
            # the shard's serve/request parents under this exact call —
            # a hedge pair shows up as two siblings, not one blurred bar
            a_ctx = ctx.child() if ctx is not None else None
            t_span0 = time.time()
            outcome = "ok"
            try:
                payload = self._call_shard(
                    target, body, budget, trace, conn_box=conns, tag=tag,
                    # a loser registering after the winner's close sweep
                    # aborts itself before sending anything
                    abort_check=lambda: result.get("winner") not in
                    (None, tag),
                    path=path,
                    tp=trace_mod.outbound_header(a_ctx),
                )
                with cond:
                    if "winner" not in result:
                        result["winner"] = tag
                        result["payload"] = payload
                    result[tag] = "ok"
                    cond.notify_all()
                # abort the losing twin: its answer is redundant and its
                # socket must not outlive the request
                loser = "hedge" if tag == "primary" else "primary"
                other = conns.get(loser)
                if other is not None and result.get("winner") == tag:
                    try:
                        other.close()
                    except Exception:
                        pass
                if result.get("winner") == tag and tag == "hedge":
                    # attributed to the replica that actually answered —
                    # a cross-replica hedge win is the sibling's credit
                    reg.counter("kdtree_router_hedge_wins_total",
                                labels=target.label()).inc()
            except ShardError as e:
                outcome = e.outcome
                with cond:
                    result[tag] = e
                    cond.notify_all()
            finally:
                if a_ctx is not None:
                    trace_mod.record_span(
                        a_ctx.trace_id, a_ctx.span_id,
                        ctx.span_id, "route/shard",
                        t_span0, time.time(),
                        shard=target.index, replica=target.replica,
                        wave=wave, role=tag,
                        hedge=("winner" if result.get("winner") == tag
                               else "loser"),
                        outcome=outcome,
                        # mark speculative wave-2 calls so a waterfall
                        # shows which bars were hedge-style bets
                        **({"spec": True} if spec else {}),
                    )

        primary = threading.Thread(
            target=run, args=("primary",), name="kdtree-route-primary"
        )
        primary.start()
        hedge_after = min(shard.hedge_delay(), max(remaining, 0.0))
        hedge_thread: Optional[threading.Thread] = None
        with cond:
            if allow_hedge:
                cond.wait_for(lambda: "primary" in result
                              or "winner" in result,
                              timeout=hedge_after)
            launch_hedge = (allow_hedge
                            and "winner" not in result
                            and not isinstance(result.get("primary"),
                                               ShardError)
                            and deadline - time.monotonic() > 0)
        if launch_hedge:
            reg.counter("kdtree_router_hedges_total",
                        labels=shard.label()).inc()
            flight.record("route.hedge", shard=shard.index, trace=trace,
                          after_ms=round(hedge_after * 1e3, 3))
            if ctx is not None:
                # a fired hedge IS tail evidence: promote at launch, so
                # the pair survives even if the response path races the
                # loser's span arriving late
                trace_mod.promote(ctx.trace_id, "hedged")
            hedge_thread = threading.Thread(
                target=run, args=("hedge",), name="kdtree-route-hedge"
            )
            hedge_thread.start()

        def settled() -> bool:
            if "winner" in result:
                return True
            done = isinstance(result.get("primary"), ShardError)
            if hedge_thread is not None:
                done = done and isinstance(result.get("hedge"), ShardError)
            return done

        with cond:
            cond.wait_for(settled, timeout=max(deadline - time.monotonic(),
                                               0.0) + 0.05)
        # join quickly; threads whose sockets were closed unwind fast,
        # a still-running loser is bounded by its own socket timeout
        primary.join(timeout=0.05)
        if hedge_thread is not None:
            hedge_thread.join(timeout=0.05)
        if "winner" in result:
            winner = (hedge_shard
                      if result["winner"] == "hedge"
                      and hedge_shard is not None else shard)
            return result["payload"], winner
        err = result.get("primary")
        if not isinstance(err, ShardError):
            err = result.get("hedge")
        if not isinstance(err, ShardError):
            # nothing settled inside the deadline: abort both calls so
            # their threads unwind instead of outliving the request
            for conn in list(conns.values()):
                try:
                    conn.close()
                except Exception:
                    pass
            err = ShardError(f"shard {shard.index}: no answer before "
                             "deadline", outcome="timeout")
        raise err

    def _shard_task(
        self, sset: ReplicaSet, body: bytes, deadline: float, trace: str,
        ctx: Optional[trace_mod.TraceContext] = None, wave: int = 1,
        spec: bool = False, path: str = "/v1/knn",
    ):
        """The full per-shard policy, replica-aware: pick a routable
        replica round-robin (ejection and breaker checks per replica),
        bounded retry with jittered backoff (429 Retry-After honored;
        each retry re-picks, so a retry naturally lands on a sibling
        replica). Returns ONE payload per shard set — exactness dedupe
        is by shard ownership — or the final ShardError."""
        cfg = self.config
        if not any(r.healthy for r in sset.replicas):
            self._count_attempt(sset.primary, "breaker_open")
            return ShardError(
                f"shard {sset.index}: all {len(sset.replicas)} "
                "replica(s) ejected (unhealthy)",
                outcome="breaker_open",
            )
        # deterministic jitter: a replayed request backs off identically
        rng = random.Random(f"{trace}:{sset.index}")
        last: Optional[ShardError] = None
        for attempt in range(cfg.retries + 1):
            now = time.monotonic()
            if now >= deadline:
                break
            shard: Optional[ShardState] = None
            for cand in sset.pick_order():
                if not cand.healthy:
                    continue
                # allow() claims the half-open probe slot, so it runs
                # only on the replica we commit to
                if cand.breaker.allow(now):
                    shard = cand
                    break
            if shard is None:
                self._count_attempt(sset.primary, "breaker_open")
                return ShardError(
                    f"shard {sset.index}: circuit breaker open on every "
                    "routable replica",
                    outcome="breaker_open",
                )
            try:
                payload, winner = self._attempt_hedged(
                    shard, body, deadline, trace,
                    # a half-open probe is ONE request by contract — a
                    # just-recovering shard must not be hedged into 2x
                    # load at its weakest moment
                    allow_hedge=shard.breaker.state != HALF_OPEN,
                    # aim the hedge at a sibling replica when one is
                    # routable (None falls back to the same process)
                    hedge_shard=sset.hedge_candidate(shard),
                    ctx=ctx, wave=wave, spec=spec, path=path,
                )
            except ShardError as e:
                last = e
                self._count_attempt(shard, e.outcome)
                if not e.retryable:
                    # a 4xx is the SHARD ANSWERING — the request was
                    # wrong, the shard is alive. Counting it a breaker
                    # failure would be unjust; not recording anything
                    # would leak a claimed half-open probe slot and
                    # refuse the shard forever. Success it is.
                    shard.breaker.record_success()
                    return e
                shard.breaker.record_failure()
                if e.retry_after_s is not None:
                    shard.note_retry_after(e.retry_after_s)
                if attempt >= cfg.retries:
                    break
                backoff = min(cfg.backoff_base_s * (2 ** attempt),
                              cfg.backoff_max_s)
                backoff *= 0.5 + 0.5 * rng.random()  # jitter in [0.5, 1.0]x
                # a shard that said "Retry-After: N" means it: the shed
                # backoff wins over the generic schedule. Fresh clock —
                # the pre-attempt `now` is stale by the attempt's own
                # duration and would over-sleep past the advice (and
                # maybe past the deadline, forfeiting a viable retry).
                # Per-replica advice: the NEXT pick may be a sibling the
                # shed replica's advice does not bind, but honoring the
                # max keeps the router conservative under fleet-wide
                # shedding.
                backoff = max(backoff, shard.retry_after_remaining())
                if time.monotonic() + backoff >= deadline:
                    break
                obs.get_registry().counter(
                    "kdtree_router_retries_total", labels=shard.label()
                ).inc()
                flight.record("route.retry", shard=shard.index,
                              replica=shard.replica, trace=trace,
                              attempt=attempt, outcome=e.outcome,
                              backoff_ms=round(backoff * 1e3, 3))
                time.sleep(backoff)
                continue
            if winner is not shard:
                # the picked replica never answered inside its own hedge
                # window — its SIBLING rescued the request. Success
                # belongs to the winner; the picked replica gets a
                # failure mark, or a wedged process whose hedges always
                # bail it out would keep a CLOSED breaker forever and
                # keep absorbing ~1/R of the reads at full hedge cost.
                # Consecutive-counting keeps this safe for healthy
                # replicas: one genuinely-answered pick resets it.
                winner.breaker.record_success()
                shard.breaker.record_failure()
            else:
                shard.breaker.record_success()
            self._count_attempt(winner, "ok")
            return payload
        return last if last is not None else ShardError(
            f"shard {sset.index}: deadline exhausted", outcome="timeout"
        )

    # -- the scatter/gather core --------------------------------------------

    def _scatter_start(
        self, indices: List[int], body: bytes, deadline: float,
        trace: str, results: List[Optional[object]],
        ctx: Optional[trace_mod.TraceContext] = None, wave: int = 1,
        spec: bool = False,
        on_done: Optional[Callable[[], None]] = None,
        path: str = "/v1/knn",
    ) -> List[threading.Thread]:
        """Launch one concurrent scatter wave over the named shard
        sets; results land in ``results`` by set index (waves touch
        disjoint index sets, so there is no write overlap). The caller
        joins via :meth:`_scatter_join` — possibly earlier than the
        request deadline, so a hung wave-1 shard cannot starve the
        widening wave of its budget (stragglers keep running against
        the full deadline and are harvested by the final join).
        ``on_done`` fires after EACH task's result lands — the
        speculative widening loop wakes on it instead of sleeping out
        its timer."""
        threads = []
        for i in indices:
            def task(s=self.shard_sets[i]):
                results[s.index] = self._shard_task(s, body, deadline,
                                                    trace, ctx=ctx,
                                                    wave=wave, spec=spec,
                                                    path=path)
                if on_done is not None:
                    on_done()

            t = threading.Thread(target=task, name="kdtree-route-scatter")
            t.start()
            threads.append(t)
        return threads

    @staticmethod
    def _scatter_join(threads: List[threading.Thread],
                      by: float) -> None:
        for t in threads:
            t.join(timeout=max(by - time.monotonic(), 0.0))

    @staticmethod
    def _spatial_inputs(payload):
        """(queries f32[Q, D] | None, recall_target | None) for the
        fan-out selection. The handler already validated the payload
        shape for the wire contract; anything that fails to parse here
        simply disables pruning for this request (full fan-out — the
        shards then issue the authoritative 400)."""
        from kdtree_tpu_torch.approx.search import parse_recall_target

        queries = None
        try:
            q = np.asarray(payload.get("queries"), dtype=np.float32)
            if q.ndim == 2 and q.shape[0] >= 1 and \
                    bool(np.isfinite(q).all()):
                queries = q
        except (TypeError, ValueError):
            pass
        ok, target = parse_recall_target(payload.get("recall_target"))
        return queries, (target if ok else None)

    @staticmethod
    def _lb_dists(queries: np.ndarray, box) -> np.ndarray:
        """Per-query lower-bound DISTANCES (float64 sqrt of the f32
        box d2 — the same value space as the shards' response
        distances, so the strict-tie pruning rule compares like with
        like)."""
        return np.sqrt(
            spatial.box_lower_bounds(queries, box[0], box[1])
            .astype(np.float64)
        )

    @staticmethod
    def _running_worst(
        payloads: List[dict], nq: int, k: Optional[int],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-query running k-th best DISTANCE over the answered
        payloads (+inf where fewer than k real candidates merged), and
        the fewer-than-k mask — the widening decision's inputs."""
        if not payloads:
            return (np.full(nq, np.inf), np.ones(nq, dtype=bool))
        kk = min(p["k"] for p in payloads) if k is None else int(k)
        dists = []
        idss = []
        for p in payloads:
            d = np.asarray(p["distances"], dtype=np.float64)[:, :kk]
            i = np.asarray(p["ids"], dtype=np.int64)[:, :kk]
            dists.append(d)
            idss.append(i)
        d = np.concatenate(dists, axis=1)
        ids = np.concatenate(idss, axis=1)
        d = np.where(ids >= 0, d, np.inf)
        d.sort(axis=1)
        worst = (d[:, kk - 1] if d.shape[1] >= kk
                 else np.full(nq, np.inf))
        return worst, ~np.isfinite(worst)

    # -- speculative overlapped wave 2 ---------------------------------------

    def _spec_delay(self, wave1: List[int]) -> float:
        """Hedge-style speculative delay: the largest p95-floored hedge
        delay across the wave-1 sets' replicas. By then the wave has
        answered with high probability — responses still missing are
        straggler evidence, and wave 2 fires on the conservative widen
        decision instead of waiting out the half-budget join."""
        d = self.config.hedge_min_s
        for i in wave1:
            for r in self.shard_sets[i].replicas:
                d = max(d, r.hedge_delay())
        return d

    def _optimistic_worst(
        self, payloads: List[dict],
        pending_lbs: List[Optional[np.ndarray]],
        nq: int, k: Optional[int],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """A LOWER bound on the final per-query k-th best distance
        while some wave-1 shards are still unanswered: each pending
        shard is assumed to deliver k candidates AT its box lower
        bound — the best it could possibly do (a pending legacy shard,
        boxless, is assumed to deliver k zero-distance candidates).
        The true merge can only land at or above this bound, and the
        assumed candidate counts can only overstate fill, so a
        remaining shard that clears the strict-tie needed-mask against
        THIS (worst, short) is in the exact widen decision no matter
        what the stragglers answer — launching it early is provably
        never waste."""
        kk = (int(k) if k is not None
              else min(p["k"] for p in payloads) if payloads else None)
        if kk is None:
            # nothing answered and no explicit k: no sound bound yet —
            # worst=0/short=False proves nothing (only lb==0 shards
            # would qualify, and those are already in wave 1)
            return np.zeros(nq), np.zeros(nq, dtype=bool)
        fakes = []
        for lb in pending_lbs:
            d = (np.tile(lb.astype(np.float64)[:, None], (1, kk))
                 if lb is not None else np.zeros((nq, kk)))
            fakes.append({"k": kk, "distances": d,
                          "ids": np.zeros((nq, kk), dtype=np.int64)})
        return self._running_worst(list(payloads) + fakes, nq, kk)

    def _spec_overlap(
        self, wave1: List[int], remaining: List[int],
        lbs: List[Optional[np.ndarray]], nq: int, k: Optional[int],
        body: bytes, deadline: float, half_by: float, trace: str,
        results: List[Optional[object]], cond,
        ctx: Optional[trace_mod.TraceContext],
    ) -> Tuple[List[threading.Thread], Set[int]]:
        """Overlap the widening wave with wave 1 instead of paying a
        serial second RTT. Wakes on every wave-1 completion and
        launches wave-2 calls on two triggers, both preserving the
        exact merge's byte-identity (contacting a SUPERSET of the
        exact decision never changes an exact merge):

        - **proven**: the optimistic bound (:meth:`_optimistic_worst`)
          already shows the shard is in the final widen decision —
          launch immediately, provably never waste.
        - **hedge**: past the p95-derived delay (:meth:`_spec_delay`)
          stragglers are being waited out — launch the conservative
          decision computed from the answers so far (a superset of the
          final decision: fewer payloads can only leave ``worst``
          larger). After it, no unseen answer can make another shard
          needed, so the loop ends.

        Returns (threads, launched). The caller charges each
        speculative launch to ``kdtree_router_spec_wave_total`` at
        merge time, once the full wave-1 evidence settles the exact
        decision (needed) or refutes it (wasted)."""
        spec_by = min(half_by, time.monotonic() + self._spec_delay(wave1))
        launched: Set[int] = set()
        threads: List[threading.Thread] = []

        def fire(need: List[int], trigger: str) -> None:
            flight.record("route.spec_wave", trace=trace,
                          launched=list(need), trigger=trigger)
            threads.extend(self._scatter_start(
                need, body, deadline, trace, results, ctx=ctx, wave=2,
                spec=True))
            launched.update(need)

        while True:
            unanswered = [i for i in wave1 if results[i] is None]
            todo = [i for i in remaining if i not in launched]
            if not unanswered or not todo:
                break
            now = time.monotonic()
            if now >= half_by:
                break
            payloads1 = [results[i] for i in wave1
                         if isinstance(results[i], dict)]
            opt_worst, opt_short = self._optimistic_worst(
                payloads1, [lbs[u] for u in unanswered], nq, k)
            proven, _ = spatial.widen_wave(lbs, todo, opt_worst,
                                           opt_short, None)
            if proven:
                fire(proven, "proven")
                continue
            if now >= spec_by:
                worst, short = self._running_worst(payloads1, nq, k)
                need, _ = spatial.widen_wave(lbs, todo, worst, short,
                                             None)
                if need:
                    fire(need, "hedge")
                break
            with cond:
                cond.wait(timeout=max(min(spec_by, half_by)
                                      - time.monotonic(), 0.0))
        return threads, launched

    @staticmethod
    def _spatial_gear(gear: Optional[str],
                      target: Optional[float]) -> Optional[str]:
        """Fold a spatial truncation into the merged gear token: the
        widening stopped at the recall target, so the batch recall is
        bounded below by it — the answer's gear is the MIN of that and
        whatever the contacted shards already reported."""
        if target is None:
            return gear
        if isinstance(gear, str) and gear.startswith("approx:"):
            try:
                return f"approx:{min(float(gear.split(':', 1)[1]), target):g}"
            except ValueError:
                pass
        return f"approx:{target:g}"

    def route_knn(
        self, body: bytes, payload: dict, k: Optional[int], trace: str,
        ctx: Optional[trace_mod.TraceContext] = None,
    ) -> Tuple[int, dict, Optional[dict]]:
        """Fan one validated request out — to every shard, or (with
        learned boxes) to the lb-ranked nearest few, widening only
        until exactness (or the recall target) is proven — gather
        inside the deadline, merge. Returns (status, response body,
        headers). ``ctx`` is the request's minted trace context; its
        span id is the trace's ROOT (the waterfall's denominator)."""
        t0 = time.monotonic()
        t0_wall = time.time()
        deadline = t0 + self.config.deadline_s
        n = len(self.shard_sets)
        results: List[Optional[object]] = [None] * n
        queries, recall_target = self._spatial_inputs(payload)
        boxes = [s.box() for s in self.shard_sets]
        selective = (
            self.config.fanout == "selective" and n > 1
            and queries is not None
            and any(b is not None and b[0].size == queries.shape[1]
                    for b in boxes)
        )
        spatial_cut = 0
        spec_launched: Set[int] = set()
        wave1: List[int] = []
        lbs: List[Optional[np.ndarray]] = []
        if selective:
            # per-set lower-bound distances; None = legacy/unprobed set
            # (no box, no pruning argument — ALWAYS contacted)
            lbs = [
                self._lb_dists(queries, b)
                if b is not None and b[0].size == queries.shape[1]
                else None
                for b in boxes
            ]
            wave1 = spatial.initial_wave(lbs)
            contacted = sorted(wave1)
            remaining = [i for i in range(n) if i not in set(wave1)]
            # speculation is exactness-only: under a recall target the
            # widening may STOP early, and a speculative superset would
            # contact shards the truncated decision deliberately skips
            spec_on = bool(self.config.spec_wave and remaining
                           and recall_target is None)
            cond = (locks.make_condition("route.spec")
                    if spec_on else None)

            def _wake() -> None:
                with cond:
                    cond.notify_all()

            threads = self._scatter_start(
                wave1, body, deadline, trace, results, ctx=ctx,
                on_done=_wake if spec_on else None)
            if remaining:
                # wave 1 gets at most HALF the remaining budget while
                # a widening wave may still need the rest: one hung
                # wave-1 shard must not convert a request full fan-out
                # would answer as a partial 200 into a 503. A shard
                # still unanswered at the cut reads as worst=inf for
                # its queries — the widening only gets MORE
                # conservative, and its late answer still merges (the
                # final join below harvests stragglers).
                now = time.monotonic()
                half_by = min(deadline, now + (deadline - now) / 2)
                if spec_on:
                    spec_threads, spec_launched = self._spec_overlap(
                        wave1, remaining, lbs, queries.shape[0], k,
                        body, deadline, half_by, trace, results, cond,
                        ctx)
                    threads += spec_threads
                self._scatter_join(threads, half_by)
                payloads1 = [results[i] for i in wave1
                             if isinstance(results[i], dict)]
                worst, short = self._running_worst(
                    payloads1, queries.shape[0], k)
                todo = [i for i in remaining if i not in spec_launched]
                wave2, spatial_cut = spatial.widen_wave(
                    lbs, todo, worst, short, recall_target)
                if wave2:
                    threads += self._scatter_start(wave2, body, deadline,
                                                   trace, results,
                                                   ctx=ctx, wave=2)
                if wave2 or spec_launched:
                    contacted = sorted(set(contacted) | set(wave2)
                                       | spec_launched)
                    if ctx is not None:
                        # a widening wave is tail evidence too: the
                        # pruning argument failed to close on wave 1
                        trace_mod.promote(ctx.trace_id, "wave2")
        else:
            contacted = list(range(n))
            threads = self._scatter_start(contacted, body, deadline,
                                          trace, results, ctx=ctx)
        self._scatter_join(threads, deadline + 0.25)
        m = len(contacted)
        pruned = n - m
        self._contacted.observe(m)
        if pruned:
            self._pruned.inc(pruned)
            flight.record("route.fanout", trace=trace, contacted=m,
                          total=n, pruned=pruned,
                          spatial_cut=spatial_cut)
        # ONE snapshot: a laggard task finishing between two reads of
        # `results` must not let the merge and the missing-list disagree
        snapshot = list(results)
        if spec_launched:
            # charge each speculative launch now that the full wave-1
            # evidence is in: the exact widen decision recomputed over
            # every answered wave-1 payload either wanted the shard
            # (needed — speculation saved its serial RTT) or not
            # (wasted — the hedge-style bet lost; the answer is still
            # byte-identical, a superset only costs shard work)
            payloads1f = [snapshot[i] for i in wave1
                          if isinstance(snapshot[i], dict)]
            worst_f, short_f = self._running_worst(
                payloads1f, queries.shape[0], k)
            final_need, _ = spatial.widen_wave(
                lbs, sorted(spec_launched), worst_f, short_f, None)
            needed = set(final_need)
            reg = obs.get_registry()
            for s in sorted(spec_launched):
                reg.counter(
                    "kdtree_router_spec_wave_total",
                    labels={"outcome": "needed" if s in needed
                            else "wasted"},
                ).inc()
        t_merge0 = time.time()
        payloads = [snapshot[i] for i in contacted
                    if isinstance(snapshot[i], dict)]
        errors = {i: snapshot[i] for i in contacted
                  if isinstance(snapshot[i], ShardError)}
        # a 4xx from a shard means the REQUEST is bad — propagate it
        # verbatim rather than merging around it or retrying it
        for err in errors.values():
            if err.outcome == "client_error" and err.body is not None:
                self._count_request("client_error")
                out = dict(err.body)
                out["trace_id"] = trace
                self._trace_route_finish(
                    ctx, t0_wall, None, "client_error", None,
                    len(contacted), len(payloads), pruned)
                return err.status or 400, out, None
        elapsed = time.monotonic() - t0
        self._req_lat.observe(elapsed, exemplar=trace)
        missing = sorted(set(contacted)
                         - {i for i in contacted
                            if isinstance(snapshot[i], dict)})
        answered = len(payloads)
        # an uncontacted (pruned) shard is NOT missing: the lb argument
        # proved it cannot contribute, so completeness — and the quorum
        # bar — is judged against the contacted set
        required = min(self.quorum, m)

        def shards_block() -> dict:
            return {"total": n, "contacted": m, "answered": answered,
                    "missing": missing, "pruned": pruned}

        if answered == m:
            dists, ids, kk = merge_topk(payloads, k)
            degraded = next(
                (p["degraded"] for p in payloads if p.get("degraded")), None
            )
            gear = self._spatial_gear(
                merge_gear(payloads),
                recall_target if spatial_cut else None)
            self._count_request("ok")
            out = {
                "k": kk, "ids": ids, "distances": dists,
                "degraded": degraded, "trace_id": trace,
                "shards": shards_block(),
            }
            if gear is not None:
                out["gear"] = gear
            self._trace_route_finish(ctx, t0_wall, t_merge0, "ok",
                                     degraded, m, answered, pruned)
            return 200, out, None
        if answered >= required:
            # partial degradation: exact over the answered shards,
            # honestly flagged — never a silent wrong answer
            dists, ids, kk = merge_topk(payloads, k)
            gear = self._spatial_gear(
                merge_gear(payloads),
                recall_target if spatial_cut else None)
            self._partial.inc()
            self._count_request("partial")
            # promote BEFORE the flight dump: its trace-route-partial
            # companion snapshots the pinned set, and this request's
            # trace is the whole point of that file
            self._trace_route_finish(
                ctx, t0_wall, t_merge0, "partial",
                f"partial:{answered}/{m}", m, answered, pruned)
            flight.record(
                "route.partial", trace=trace, answered=answered,
                total=n, contacted=m, missing=missing,
                outcomes={str(i): e.outcome for i, e in errors.items()},
            )
            flight.auto_dump("route-partial")
            out = {
                "k": kk, "ids": ids, "distances": dists,
                "degraded": f"partial:{answered}/{m}",
                "trace_id": trace,
                "shards": shards_block(),
            }
            if gear is not None:
                out["gear"] = gear
            return 200, out, None
        self._count_request("unavailable")
        self._trace_route_finish(ctx, t0_wall, t_merge0, "unavailable",
                                 None, m, answered, pruned)
        flight.record(
            "route.unavailable", trace=trace, answered=answered,
            total=n, contacted=m, quorum=self.quorum, missing=missing,
            outcomes={str(i): e.outcome for i, e in errors.items()},
        )
        flight.auto_dump("route-unavailable")
        return 503, {
            "error": f"only {answered}/{m} contacted shards answered "
                     f"(quorum {required}); failing shards: {missing}",
            "trace_id": trace,
            "shards": shards_block(),
        }, {"Retry-After": str(int(max(self.config.breaker_reset_s, 1.0)))}

    # -- query verbs ---------------------------------------------------------

    @staticmethod
    def _verb_inputs(payload) -> Optional[Tuple[str, np.ndarray,
                                                np.ndarray]]:
        """The verb request's pruning geometry: ``("ball", centers
        f32[Q, D], r2 f32[Q])`` for the radius forms or ``("box", lo
        f32[Q, D], hi f32[Q, D])`` for the box forms. Lenient like
        :meth:`_spatial_inputs`: anything that fails to parse disables
        pruning (full fan-out; the shards issue the authoritative 400).
        ``r2`` is computed in float32 — the SAME arithmetic the shard
        kernel prunes with, so the router can never prune a shard whose
        kernel would have reported a hit."""
        try:
            if "r" in payload or "queries" in payload:
                q = np.asarray(payload.get("queries"), dtype=np.float32)
                r = np.asarray(payload.get("r"), dtype=np.float32)
                if q.ndim == 2 and q.shape[0] >= 1 and \
                        bool(np.isfinite(q).all()) and \
                        r.ndim in (0, 1) and bool(np.isfinite(r).all()) \
                        and bool((r >= 0).all()):
                    r = np.broadcast_to(r, (q.shape[0],)) \
                        .astype(np.float32)
                    return "ball", q, r * r
            else:
                lo = np.asarray(payload.get("lo"), dtype=np.float32)
                hi = np.asarray(payload.get("hi"), dtype=np.float32)
                if lo.ndim == 2 and lo.shape == hi.shape and \
                        lo.shape[0] >= 1 and \
                        bool(np.isfinite(lo).all()) and \
                        bool(np.isfinite(hi).all()):
                    return "box", lo, hi
        except (TypeError, ValueError):
            pass
        return None

    def route_verb(
        self, path: str, body: bytes, payload: dict, trace: str,
        ctx: Optional[trace_mod.TraceContext] = None,
    ) -> Tuple[int, dict, Optional[dict]]:
        """Fan one verb request out and merge per-verb
        (:func:`merge_verb`). Selective fan-out is ONE wave, not the
        k-NN widening loop: a verb's geometry is fixed by the request —
        a shard either can hold a hit (box lower bound within the ball,
        or box-vs-box overlap) or provably cannot — so the exact
        contacted set is known before any shard answers. Boxless
        (legacy/unprobed) sets are always contacted. A partial merge
        (>= quorum answered) is flagged ``degraded: partial:a/m`` AND
        ``truncated: true`` — a union/sum over a subset of the shards
        is exactly the verbs' sound-lower-bound contract."""
        t0 = time.monotonic()
        t0_wall = time.time()
        deadline = t0 + self.config.deadline_s
        endpoint = path.rsplit("/", 1)[1]
        n = len(self.shard_sets)
        results: List[Optional[object]] = [None] * n
        geom = self._verb_inputs(payload)
        boxes = [s.box() for s in self.shard_sets]
        contacted = list(range(n))
        if self.config.fanout == "selective" and n > 1 and \
                geom is not None:
            kind, a, b = geom
            need: List[int] = []
            for i, box in enumerate(boxes):
                if box is None or box[0].size != a.shape[1]:
                    need.append(i)  # no box = no pruning argument
                    continue
                if kind == "ball":
                    # same f32 gap-max-sum bound the shard kernel
                    # prunes with: lb > r2 everywhere = provably no hit
                    lb = spatial.box_lower_bounds(a, box[0], box[1])
                    if bool((lb <= b).any()):
                        need.append(i)
                else:
                    # box-vs-box disjointness, exact comparisons
                    overlap = np.logical_and(
                        a <= box[1][None, :], box[0][None, :] <= b
                    ).all(axis=1)
                    if bool(overlap.any()):
                        need.append(i)
            contacted = need
        m = len(contacted)
        pruned = n - m
        if m == 0:
            # every shard provably holds no hit: the exact answer is
            # empty, no fan-out at all (counts all-zero, empty rows)
            nq = int(geom[1].shape[0])
            self._contacted.observe(0)
            self._pruned.inc(pruned)
            self._count_request("ok")
            self._trace_route_finish(ctx, t0_wall, time.time(), "ok",
                                     None, 0, 0, pruned)
            out = {"counts": [0] * nq, "truncated": False,
                   "degraded": None, "trace_id": trace,
                   "shards": {"total": n, "contacted": 0, "answered": 0,
                              "missing": [], "pruned": pruned}}
            if endpoint == "radius":
                out["ids"] = [[] for _ in range(nq)]
                out["distances"] = [[] for _ in range(nq)]
            elif endpoint == "range":
                out["ids"] = [[] for _ in range(nq)]
            return 200, out, None
        threads = self._scatter_start(contacted, body, deadline, trace,
                                      results, ctx=ctx, path=path)
        self._scatter_join(threads, deadline + 0.25)
        self._contacted.observe(m)
        if pruned:
            self._pruned.inc(pruned)
            flight.record("route.fanout", trace=trace, contacted=m,
                          total=n, pruned=pruned, verb=endpoint)
        snapshot = list(results)
        t_merge0 = time.time()
        payloads = [snapshot[i] for i in contacted
                    if isinstance(snapshot[i], dict)]
        errors = {i: snapshot[i] for i in contacted
                  if isinstance(snapshot[i], ShardError)}
        for err in errors.values():
            if err.outcome == "client_error" and err.body is not None:
                self._count_request("client_error")
                out = dict(err.body)
                out["trace_id"] = trace
                self._trace_route_finish(
                    ctx, t0_wall, None, "client_error", None, m,
                    len(payloads), pruned)
                return err.status or 400, out, None
        self._req_lat.observe(time.monotonic() - t0, exemplar=trace)
        missing = sorted(set(contacted)
                         - {i for i in contacted
                            if isinstance(snapshot[i], dict)})
        answered = len(payloads)
        required = min(self.quorum, m)
        shards_block = {"total": n, "contacted": m, "answered": answered,
                        "missing": missing, "pruned": pruned}
        if answered >= required and answered > 0:
            merged = merge_verb(endpoint, payloads)
            partial = answered < m
            degraded = (f"partial:{answered}/{m}" if partial else next(
                (p["degraded"] for p in payloads if p.get("degraded")),
                None))
            gear = merge_gear(payloads)
            out = dict(merged)
            if partial:
                # a subset union/sum is a sound lower bound — the same
                # flag a truncated single-shard answer carries
                out["truncated"] = True
            out["degraded"] = degraded
            out["trace_id"] = trace
            out["shards"] = shards_block
            if gear is not None:
                out["gear"] = gear
            status = "partial" if partial else "ok"
            self._count_request(status)
            self._trace_route_finish(ctx, t0_wall, t_merge0, status,
                                     degraded, m, answered, pruned)
            if partial:
                self._partial.inc()
                flight.record(
                    "route.partial", trace=trace, answered=answered,
                    total=n, contacted=m, missing=missing,
                    outcomes={str(i): e.outcome
                              for i, e in errors.items()},
                )
                flight.auto_dump("route-partial")
            return 200, out, None
        self._count_request("unavailable")
        self._trace_route_finish(ctx, t0_wall, t_merge0, "unavailable",
                                 None, m, answered, pruned)
        flight.record(
            "route.unavailable", trace=trace, answered=answered,
            total=n, contacted=m, quorum=self.quorum, missing=missing,
            outcomes={str(i): e.outcome for i, e in errors.items()},
        )
        flight.auto_dump("route-unavailable")
        return 503, {
            "error": f"only {answered}/{m} contacted shards answered "
                     f"(quorum {required}); failing shards: {missing}",
            "trace_id": trace,
            "shards": shards_block,
        }, {"Retry-After": str(int(max(self.config.breaker_reset_s, 1.0)))}

    # -- distributed-trace assembly ------------------------------------------

    def assemble_trace(self, trace_id: str) -> Optional[dict]:
        """Join this router's spans for ``trace_id`` with every
        contacted shard's (a ``GET /debug/trace/<id>`` fan-out),
        clock-corrected by the health loop's RTT-midpoint offset
        estimates. None when the router never recorded the trace. Who
        to ask is read off the local route/shard spans' shard/replica
        attrs; a replica that cannot answer contributes an ``error``
        source entry, never a silent hole in the waterfall."""
        import http.client

        local = trace_mod.get_trace(trace_id)
        if local is None:
            return None
        by_key = {(s.index, s.replica): s for s in self.shards}
        targets: List[ShardState] = []
        seen = set()
        for sp in local["spans"]:
            key = (sp.get("shard"), sp.get("replica"))
            if key in by_key and key not in seen:
                seen.add(key)
                targets.append(by_key[key])
        if not targets:
            # no scatter spans recorded (trace minted but fanned out
            # before tracing, or spans aged out): ask every primary
            # rather than assembling a router-only forest
            targets = [s.primary for s in self.shard_sets]
        sources: List[dict] = [{
            "source": "router", "clock_offset_s": 0.0,
            "spans": local["spans"], "error": None,
        }]

        def fetch(shard: ShardState, out: list, i: int) -> None:
            name = (f"shard{shard.index}/r{shard.replica}"
                    if shard.multi else f"shard{shard.index}")
            entry = {"source": name,
                     "clock_offset_s": shard.clock_offset_s or 0.0,
                     "spans": [], "error": None}
            try:
                conn = http.client.HTTPConnection(shard.host, shard.port,
                                                  timeout=2.0)
                try:
                    conn.request("GET", f"/debug/trace/{trace_id}")
                    resp = conn.getresponse()
                    raw = resp.read()
                finally:
                    conn.close()
                if resp.status != 200:
                    entry["error"] = f"HTTP {resp.status}"
                else:
                    payload = json.loads(raw.decode("utf-8"))
                    entry["spans"] = payload.get("spans") or []
            except (OSError, http.client.HTTPException, ValueError) as e:
                entry["error"] = repr(e)
            out[i] = entry

        # concurrent fetch, same reasoning as the health sweep: one
        # unreachable replica must not serialize its timeout in front
        # of every other source
        slots: List[Optional[dict]] = [None] * len(targets)
        threads = [
            threading.Thread(target=fetch, args=(t, slots, i),
                             name="kdtree-route-trace-fetch")
            for i, t in enumerate(targets)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=3.0)
        sources += [s for s in slots if s is not None]
        assembled = trace_mod.assemble(trace_id, sources)
        assembled["reasons"] = local.get("reasons", [])
        assembled["pinned"] = local.get("pinned", False)
        return assembled

    # -- write passthrough (mutable index) -----------------------------------

    def _owner_table(self) -> Optional[List[Tuple[int, ReplicaSet]]]:
        """(offset, shard set) ascending, or None while any set's
        ``id_offset`` is still unknown (no successful health probe yet)
        — routing a write on a guessed partition would corrupt it.
        Every replica of a set serves the same partition, so any
        replica's learned offset speaks for the set."""
        offs = [(s.id_offset(), s) for s in self.shard_sets]
        if any(o is None for o, _ in offs):
            return None
        return sorted(offs, key=lambda t: t[0])

    def route_write(
        self, op: str, payload, trace: str,
        ctx: Optional[trace_mod.TraceContext] = None,
    ) -> Tuple[int, dict]:
        """Partition a write request's GLOBAL ids by owning shard (the
        contiguous range starting at each shard's ``id_offset``) and
        forward each partition verbatim. One attempt per shard — writes
        are idempotent but a retry storm against a shedding shard helps
        nobody; the per-shard outcome map makes partial application
        visible, never silent."""
        def count(status: str) -> None:
            obs.get_registry().counter(
                "kdtree_router_write_requests_total",
                labels={"op": op, "status": status},
            ).inc()

        from kdtree_tpu_torch.serve.server import MAX_WRITE_IDS

        t0_wall = time.time()

        def tfinish(status: str) -> None:
            """Root span + promotions for a write that actually fanned
            out (pre-scatter 4xxs stay untraced: nothing downstream to
            decompose). Never raises."""
            if ctx is None:
                return
            try:
                trace_mod.record_span(
                    ctx.trace_id, ctx.span_id, "", "route/request",
                    t0_wall, time.time(), status=status, op=op)
                if status == "error":
                    trace_mod.promote(ctx.trace_id, "error")
                if ctx.sampled:
                    trace_mod.promote(ctx.trace_id, "sampled")
            except Exception:
                pass

        if self.config.parent:
            # a child router publishes no id_offset / code range, so
            # the parent has no ownership evidence — guessing would
            # half-apply writes across subtrees. Two-level routing
            # serves READS; writes go to a child router (or the owning
            # shard) directly (docs/SERVING.md "Scaling the router").
            count("unavailable")
            return 503, {
                "error": "this is a parent router: write ownership is "
                         "unknown at this level — send writes to a "
                         "child router or the owning shard directly",
                "trace_id": trace,
            }
        ids = payload.get("ids") if isinstance(payload, dict) else None
        if not isinstance(ids, list) or not ids or not all(
            isinstance(i, int) and not isinstance(i, bool) for i in ids
        ):
            count("client_error")
            return 400, {"error": '"ids" must be a non-empty list of '
                                  "ints", "trace_id": trace}
        if len(ids) > MAX_WRITE_IDS:
            # enforce the shards' per-request cap HERE: forwarding an
            # oversized partition would get it 400d by its shard while
            # other partitions apply — a guaranteed partial write for a
            # request the router appeared to accept
            count("client_error")
            return 400, {"error": f'"ids" must hold at most '
                                  f"{MAX_WRITE_IDS} ids per request "
                                  "(split larger writes)",
                         "trace_id": trace}
        if len(set(ids)) != len(ids):
            # same reasoning for duplicates: the shard's engine rejects
            # them, so a dup spanning shards would half-apply
            count("client_error")
            return 400, {"error": "duplicate ids in one write request",
                         "trace_id": trace}
        points = payload.get("points") if op == "upsert" else None
        if op == "upsert" and (
            not isinstance(points, list) or len(points) != len(ids)
        ):
            count("client_error")
            return 400, {"error": '"points" must be a list matching '
                                  '"ids"', "trace_id": trace}
        # ownership mode: SPATIAL when every shard set published its
        # Morton code range (the partition contract) —
        # upserts then go to the shard whose REGION contains the point,
        # with stale-copy deletes broadcast to the other shards so a
        # moved id can never serve from two places; deletes
        # broadcast-resolve by id (unknown ids are idempotent no-ops at
        # the engines). Id-range fleets keep today's behavior exactly.
        grid = next((s.spatial_grid() for s in self.shard_sets
                     if s.spatial_grid() is not None), None)
        ranges = [s.code_range_known() for s in self.shard_sets]
        spatial_mode = grid is not None and all(
            r is not None for r in ranges)
        # jobs: (shard set, op, sub-payload, counts_toward_applied)
        jobs: List[Tuple[ReplicaSet, str, dict, bool]] = []
        if spatial_mode:
            if op == "upsert":
                try:
                    pts = np.asarray(points, dtype=np.float32)
                except (TypeError, ValueError):
                    count("client_error")
                    return 400, {"error": '"points" must be a [m, d] '
                                          "number array",
                                 "trace_id": trace}
                if pts.shape != (len(ids), grid.dim) or \
                        not bool(np.isfinite(pts).all()):
                    count("client_error")
                    return 400, {"error": f'"points" must be finite '
                                          f"[{len(ids)}, {grid.dim}] "
                                          "to match ids and the "
                                          "fleet's partition grid",
                                 "trace_id": trace}
                # owner_of's searchsorted needs ASCENDING range lows,
                # but self.shard_sets is the operator's --shard flag
                # order — sort, resolve, then map back (the same
                # invariant the id-range path's sorted owner table
                # re-establishes). A point no range covers (a fleet
                # mixing partitions, or a partial topology) must be a
                # crisp refusal, never a guessed owner: a misrouted
                # upsert's stale-delete broadcast would DELETE the id
                # from its real owner while applying it nowhere.
                order = sorted(range(len(ranges)),
                               key=lambda i: ranges[i][0])
                idx = spatial.owner_of(pts, grid,
                                       [ranges[i] for i in order])
                lut = np.asarray(order + [-1], dtype=np.int64)
                owners = lut[idx]  # idx -1 stays -1 via the sentinel
                if bool((owners < 0).any()):
                    count("unavailable")
                    return 503, {
                        "error": "shard code ranges do not cover some "
                                 "points (mixed or partial spatial "
                                 "topology) — refusing to guess a "
                                 "write owner",
                        "trace_id": trace,
                    }
                parts: Dict[int, List[int]] = {}
                for pos, owner in enumerate(owners.tolist()):
                    parts.setdefault(int(owner), []).append(pos)
                for s_idx, sset in enumerate(self.shard_sets):
                    rows = parts.get(s_idx)
                    if rows:
                        sub = {"ids": [ids[i] for i in rows],
                               "points": [points[i] for i in rows]}
                        jobs.append((sset, "upsert", sub, True))
                        # expand the cached box NOW: a query racing the
                        # next health probe must not prune the shard
                        # that just took this point
                        sub_pts = pts[rows]
                        sset.expand_box(sub_pts.min(axis=0),
                                        sub_pts.max(axis=0))
                    stale = [ids[i] for i in range(len(ids))
                             if int(owners[i]) != s_idx]
                    if stale:
                        jobs.append((sset, "delete", {"ids": stale},
                                     False))
            else:
                jobs = [(sset, "delete", {"ids": list(ids)}, True)
                        for sset in self.shard_sets]
        else:
            table = self._owner_table()
            if table is None:
                count("unavailable")
                return 503, {"error": "shard id ranges unknown — health "
                                      "probes have not yet read every "
                                      "shard's id_offset",
                             "trace_id": trace}
            if min(ids) < table[0][0]:
                count("client_error")
                return 400, {"error": f"ids below the first shard's "
                                      f"id_offset {table[0][0]} are owned "
                                      "by no shard", "trace_id": trace}
            offsets = [o for o, _ in table]
            parts = {}
            import bisect

            for pos, gid in enumerate(ids):
                owner = bisect.bisect_right(offsets, gid) - 1
                parts.setdefault(owner, []).append(pos)
            for owner, rows in sorted(parts.items()):
                sub = {"ids": [ids[i] for i in rows]}
                if points is not None:
                    sub["points"] = [points[i] for i in rows]
                    # the box contract is mode-independent: an id-range
                    # fleet's shards publish boxes too, and a selective
                    # read racing the next health probe must not prune
                    # the shard that just took this write (malformed
                    # points skip the expansion — the shard 400s them)
                    try:
                        sub_pts = np.asarray(sub["points"],
                                             dtype=np.float32)
                        if sub_pts.ndim == 2 and \
                                bool(np.isfinite(sub_pts).all()):
                            table[owner][1].expand_box(
                                sub_pts.min(axis=0), sub_pts.max(axis=0))
                    except (TypeError, ValueError):
                        pass
                jobs.append((table[owner][1], op, sub, True))
        deadline = time.monotonic() + self.config.deadline_s
        shard_out: Dict[str, dict] = {}
        applied = 0
        failures = client_error = None
        primary_jobs = sum(1 for j in jobs if j[3])
        for n_done, (sset, job_op, sub, counts) in enumerate(jobs):
            # writes go ONLY to the shard PRIMARY (replica 0): the
            # secondaries are snapshot-following read replicas — they
            # 403 writes, and converge to this write's effect through
            # the primary's next epoch snapshot (blue/green)
            shard = sset.primary
            # a stale-copy delete rides under a namespaced key so it
            # can never collide with the same shard's primary outcome
            out_key = (str(shard.index) if counts or job_op == op
                       else f"{shard.index}:{job_op}")
            # the reads' fail-fast policy applies to writes too: an
            # ejected or breaker-open shard answers immediately instead
            # of burning budget the remaining partitions need
            if not shard.healthy:
                self._count_attempt(shard, "breaker_open")
                shard_out[out_key] = {
                    "error": f"shard {shard.index}: ejected (unhealthy)",
                    "outcome": "breaker_open",
                }
                failures = failures or "breaker_open"
                continue
            if not shard.breaker.allow():
                self._count_attempt(shard, "breaker_open")
                shard_out[out_key] = {
                    "error": f"shard {shard.index}: circuit breaker open",
                    "outcome": "breaker_open",
                }
                failures = failures or "breaker_open"
                continue
            # split the remaining budget evenly over the remaining
            # jobs: one hung shard must not starve the healthy
            # owners behind it into "deadline exhausted"
            budget = (deadline - time.monotonic()) / (len(jobs) - n_done)
            if budget <= 0:
                shard_out[out_key] = {"error": "deadline exhausted"}
                failures = failures or "timeout"
                continue
            # each forwarded partition carries its own child span id, so
            # the owning shard's serve/request parents under this call
            j_ctx = ctx.child() if ctx is not None else None
            t_j0 = time.time()
            try:
                res = self._call_shard(
                    shard, json.dumps(sub).encode("utf-8"), budget,
                    trace, path=f"/v1/{job_op}",
                    tp=trace_mod.outbound_header(j_ctx),
                )
            except ShardError as e:
                if j_ctx is not None:
                    trace_mod.record_span(
                        j_ctx.trace_id, j_ctx.span_id, ctx.span_id,
                        "route/shard", t_j0, time.time(),
                        shard=shard.index, replica=shard.replica,
                        op=job_op, outcome=e.outcome)
                # mirror the read path's breaker contract: a 4xx is the
                # shard ANSWERING (success — and a half-open probe slot
                # claimed by allow() above must be released either way)
                if e.retryable:
                    shard.breaker.record_failure()
                else:
                    shard.breaker.record_success()
                self._count_attempt(shard, e.outcome)
                shard_out[out_key] = {
                    "error": str(e), "outcome": e.outcome,
                    "status": e.status,
                }
                if e.body is not None:
                    shard_out[out_key]["body"] = e.body
                if not e.retryable:
                    client_error = e
                failures = failures or e.outcome
                continue
            shard.breaker.record_success()
            self._count_attempt(shard, "ok")
            if j_ctx is not None:
                trace_mod.record_span(
                    j_ctx.trace_id, j_ctx.span_id, ctx.span_id,
                    "route/shard", t_j0, time.time(),
                    shard=shard.index, replica=shard.replica,
                    op=job_op, outcome="ok")
            if counts:
                applied += int(res.get("applied", 0))
            shard_out[out_key] = {
                "applied": res.get("applied"),
                "delta_rows": res.get("delta_rows"),
                "tombstones": res.get("tombstones"),
                "epoch": res.get("epoch"),
                "rebuilding": res.get("rebuilding"),
            }
            if job_op != op:
                shard_out[out_key]["op"] = job_op
        out = {"op": op, "requested": len(ids), "applied": applied,
               "shards": shard_out, "trace_id": trace}
        if spatial_mode:
            out["routing"] = "spatial"
        flight.record("route.write", op=op, trace=trace, ids=len(ids),
                      applied=applied, failed=failures is not None,
                      routing="spatial" if spatial_mode else "range")
        if failures is None:
            count("ok")
            tfinish("ok")
            return 200, out
        if client_error is not None and len(jobs) == 1 and \
                primary_jobs == 1:
            # the single owning shard rejected the request itself:
            # propagate its verdict verbatim (nothing was applied
            # anywhere, so this is a clean 4xx, not a partial write)
            count("client_error")
            tfinish("client_error")
            out["error"] = str(client_error)
            return client_error.status or 400, out
        count("error")
        tfinish("error")
        out["error"] = "one or more shards failed the write (see shards)"
        return 502, out

    # -- /metrics federation -------------------------------------------------

    _PROM_SERIES = re.compile(
        r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?\s+(.+)$"
    )

    @classmethod
    def _parse_prom_families(cls, text: str) -> dict:
        """Group one exposition into {family: {help, type, series}} —
        ``series`` keeps (name, inner-labels | None, value). Histogram
        ``_bucket``/``_sum``/``_count`` series attach to the family the
        preceding ``# TYPE`` declared, the grouping the text format
        requires."""
        fams: dict = {}
        current = None
        for line in text.splitlines():
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                parts = line.split(" ", 3)
                name = parts[2]
                fam = fams.setdefault(
                    name, {"help": None, "type": None, "series": []}
                )
                fam["help" if parts[1] == "HELP" else "type"] = (
                    parts[3] if len(parts) > 3 else ""
                )
                current = name
                continue
            if not line.strip() or line.startswith("#"):
                continue
            m = cls._PROM_SERIES.match(line)
            if not m:
                continue
            sname = m.group(1)
            fam_name = (
                current
                if current is not None
                and (sname == current or sname.startswith(current + "_"))
                else sname
            )
            fam = fams.setdefault(
                fam_name, {"help": None, "type": None, "series": []}
            )
            fam["series"].append((sname, m.group(2), m.group(3)))
        return fams

    def _scrape_shard(self, shard: ShardState) -> Optional[str]:
        """One shard /metrics fetch for federation; None on any failure
        (the federated exposition reports it, never fails the scrape)."""
        import http.client

        timeout = max(min(self.config.deadline_s, 2.0), 0.5)
        # a parent scrapes its CHILD ROUTERS' federated expositions, so
        # one parent scrape carries the whole two-level fleet
        path = "/metrics?federate=1" if self.config.parent else "/metrics"
        try:
            conn = http.client.HTTPConnection(shard.host, shard.port,
                                              timeout=timeout)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                raw = resp.read()
                if resp.status != 200:
                    return None
                return raw.decode("utf-8", errors="replace")
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            return None

    def federated_metrics_text(self) -> str:
        """``GET /metrics?federate=1``: the router's own exposition plus
        every shard's, shard-labeled, regrouped so each metric family is
        one contiguous block (a format requirement, not cosmetics).
        Unreachable shards become ``kdtree_router_federated_up 0``."""
        from kdtree_tpu_torch.obs.export import METRIC_HELP, prometheus_text

        obs.flush()
        merged: dict = {}

        def absorb(fams: dict, tag: Optional[str]) -> None:
            for name, fam in fams.items():
                tgt = merged.setdefault(
                    name, {"help": None, "type": None, "series": []}
                )
                for key in ("help", "type"):
                    if tgt[key] is None:
                        tgt[key] = fam[key]
                for sname, inner, value in fam["series"]:
                    if tag is not None:
                        inner = f"{tag},{inner}" if inner else tag
                    tgt["series"].append((sname, inner, value))

        def fed_tag(shard: ShardState) -> str:
            # a parent labels each CHILD ROUTER's exposition child="i"
            # — the child's own series already carry shard="j" labels,
            # and reusing the shard key would collide with them
            if self.config.parent:
                return f'child="{shard.index}"'
            # single-replica sets keep their historical shard="i" series
            # identity; replicas add the replica dimension
            if shard.multi:
                return f'shard="{shard.index}",replica="{shard.replica}"'
            return f'shard="{shard.index}"'

        absorb(self._parse_prom_families(prometheus_text()), None)
        # scrape shards CONCURRENTLY: serially, a few hung shards at
        # ~2 s socket timeout each would push the whole federated
        # scrape past a scraper's own timeout and take the entire fleet
        # dark — the exact failure the up-gauge design exists to avoid
        texts: List[Optional[str]] = [None] * len(self.shards)
        scrapers = [
            threading.Thread(
                target=lambda i=i, s=s: texts.__setitem__(
                    i, self._scrape_shard(s)
                ),
                name="kdtree-route-federate",
            )
            for i, s in enumerate(self.shards)
        ]
        for t in scrapers:
            t.start()
        for t in scrapers:
            t.join()
        up: List[Tuple[str, int]] = []
        reg = obs.get_registry()
        for shard, text in zip(self.shards, texts):
            up.append((fed_tag(shard), 1 if text is not None else 0))
            if text is None:
                reg.counter("kdtree_router_federate_errors_total",
                            labels=shard.label()).inc()
                continue
            absorb(self._parse_prom_families(text), fed_tag(shard))
        fam = merged.setdefault(
            "kdtree_router_federated_up",
            {"help": METRIC_HELP.get("kdtree_router_federated_up"),
             "type": "gauge", "series": []},
        )
        for tag, val in up:
            fam["series"].append(
                ("kdtree_router_federated_up", tag, str(val))
            )
        lines: List[str] = []
        for name, fam in merged.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            if fam["type"]:
                lines.append(f"# TYPE {name} {fam['type']}")
            for sname, inner, value in fam["series"]:
                key = f"{sname}{{{inner}}}" if inner else sname
                lines.append(f"{key} {value}")
        return "\n".join(lines) + "\n"

    # -- cost attribution & capacity headroom --------------------------------

    def fleet_headroom(self) -> dict:
        """Fleet capacity-headroom aggregation from the shard
        ``/healthz`` headroom blocks the health loop already collects
        (no extra fan-out on the read path): fleet predicted rate = sum
        of the routable replicas' predicted rates, observed likewise.
        An ejected replica's detail is ``{"ejected": ...}`` — it
        contributes NOTHING to the sums, so losing a shard reads as
        reduced predicted capacity, never as phantom headroom."""
        entries = []
        predicted = 0.0
        observed = 0.0
        reporting = 0
        for shard in self.shards:
            routable = shard.healthy and shard.breaker.state != OPEN
            detail = shard.health_detail
            hr = detail.get("headroom") if isinstance(detail, dict) \
                else None
            ent = {"shard": shard.index, "replica": shard.replica,
                   "url": shard.url, "routable": routable}
            if routable and isinstance(hr, dict):
                ent["headroom"] = hr
                if hr.get("data"):
                    try:
                        p = float(hr["predicted_rate"])
                        o = float(hr["observed_rate"])
                    except (KeyError, TypeError, ValueError):
                        pass  # malformed block reads as absent
                    else:
                        predicted += p
                        observed += o
                        reporting += 1
            entries.append(ent)
        out = {
            "data": reporting > 0,
            "shards_reporting": reporting,
            "shards_total": len(self.shards),
            "shards": entries,
        }
        if reporting:
            frac = (max(0.0, 1.0 - observed / predicted)
                    if predicted > 0 else 0.0)
            out["predicted_rate"] = predicted
            out["observed_rate"] = observed
            out["headroom_frac"] = frac
            # lazy gauge, same idiom as the shard-side ledger: absent
            # until a shard actually reports, never a misleading 0
            obs.get_registry().gauge(
                "kdtree_router_headroom_frac").set(frac)
        return out

    def fleet_costs(self) -> dict:
        """``GET /debug/costs`` at the router: every replica's cost
        report fetched concurrently (an unreachable replica is an
        ``error`` entry, never a failed fan-out), plus the fleet
        headroom aggregation."""
        import http.client

        results: List[Optional[dict]] = [None] * len(self.shards)

        def fetch(i: int, shard: ShardState) -> None:
            timeout = max(min(self.config.deadline_s, 2.0), 0.5)
            try:
                conn = http.client.HTTPConnection(
                    shard.host, shard.port, timeout=timeout)
                try:
                    conn.request("GET", "/debug/costs")
                    resp = conn.getresponse()
                    raw = resp.read()
                    if resp.status == 200:
                        results[i] = json.loads(raw.decode("utf-8"))
                finally:
                    conn.close()
            except (OSError, http.client.HTTPException, ValueError):
                pass

        fetchers = [
            threading.Thread(target=fetch, args=(i, s),
                             name="kdtree-route-costs")
            for i, s in enumerate(self.shards)
        ]
        for t in fetchers:
            t.start()
        for t in fetchers:
            t.join()
        shards_out = []
        for shard, res in zip(self.shards, results):
            ent = {"shard": shard.index, "replica": shard.replica,
                   "url": shard.url}
            if res is None:
                ent["error"] = "unreachable"
            else:
                ent["costs"] = res
            shards_out.append(ent)
        return {"shards": shards_out, "headroom": self.fleet_headroom()}

    # -- health ejection -----------------------------------------------------

    def _probe_health(self, shard: ShardState) -> None:
        """One /healthz probe: a shard is routable only while it answers
        200 AND its SLO block is not PAGE-burning (a burning replica
        wants traffic routed away — obs/slo.py's contract)."""
        import http.client

        timeout = max(min(self.config.health_period_s, 2.0), 0.1)
        healthy = False
        detail: dict = {}
        try:
            conn = http.client.HTTPConnection(shard.host, shard.port,
                                              timeout=timeout)
            try:
                # wall-clock the exchange: the shard stamps server_unix
                # into its /healthz body, and the RTT midpoint gives the
                # per-replica clock-offset estimate the trace assembler
                # joins cross-process spans with (obs/trace.py)
                t0_wall = time.time()
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                raw = resp.read()
                t1_wall = time.time()
                if resp.status == 200:
                    try:
                        detail = json.loads(raw.decode("utf-8"))
                    except (UnicodeDecodeError, ValueError):
                        detail = {}
                    off = detail.get("id_offset")
                    if isinstance(off, int) and not isinstance(off, bool):
                        shard.id_offset = off
                    su = detail.get("server_unix")
                    if isinstance(su, (int, float)) and \
                            not isinstance(su, bool):
                        shard.clock_offset_s = trace_mod.\
                            estimate_clock_offset(t0_wall, t1_wall, su)
                        obs.get_registry().gauge(
                            "kdtree_router_clock_skew_ms",
                            labels=shard.label(),
                        ).set(shard.clock_offset_s * 1e3)
                    self._learn_spatial(shard, detail)
                    healthy = detail.get("slo", {}).get("state") != "PAGE"
                    if not healthy:
                        detail = {"ejected": "slo PAGE"}
                else:
                    detail = {"ejected": f"healthz {resp.status}"}
            finally:
                conn.close()
        except (OSError, http.client.HTTPException) as e:
            # HTTPException covers a DROPPED/garbled probe (BadStatusLine
            # from a connection closed with no status) — miss it and a
            # healthz=drop shard would never eject
            detail = {"ejected": f"unreachable: {e!r}"}
        was = shard.healthy
        shard.healthy = healthy
        shard.health_detail = detail
        obs.get_registry().gauge(
            "kdtree_router_shard_healthy", labels=shard.label()
        ).set(1 if healthy else 0)
        if was != healthy:
            flight.record("route.eject" if not healthy else "route.admit",
                          shard=shard.index, detail=detail)
            if not healthy:
                flight.auto_dump("route-eject")

    @staticmethod
    def _learn_spatial(shard: ShardState, detail: dict) -> None:
        """Absorb the spatial topology a /healthz body publishes: the
        replica's bounding box (pruning input — refreshed every probe,
        so an epoch swap's tightened box takes effect within one health
        period) and, for spatially-partitioned fleets, the shared grid
        + owned Morton code range (write-ownership input — topology,
        kept across later failures like id_offset). Malformed blocks
        read as absent, never as a crash: boxes are advisory for
        SELECTIVITY; correctness never depends on them (a box-less
        shard is simply always contacted)."""
        box = detail.get("box")
        if isinstance(box, dict):
            try:
                lo = np.asarray([float(x) for x in box["lo"]],
                                dtype=np.float32)
                hi = np.asarray([float(x) for x in box["hi"]],
                                dtype=np.float32)
                if lo.shape == hi.shape and lo.size and \
                        bool(np.isfinite(lo).all()
                             and np.isfinite(hi).all()):
                    shard.box = (lo, hi)
            except (KeyError, TypeError, ValueError):
                pass
        sp = detail.get("spatial")
        if isinstance(sp, dict):
            grid = spatial.SpatialGrid.from_json(sp.get("grid"))
            cr = sp.get("code_range")
            try:
                cr = (int(cr[0]), int(cr[1]))
            except (TypeError, ValueError, IndexError):
                cr = None
            if grid is not None and cr is not None and cr[0] < cr[1]:
                shard.grid = grid
                shard.code_range = cr

    def _probe_health_safe(self, shard: ShardState) -> None:
        try:
            self._probe_health(shard)
        except Exception:
            pass  # the loop must outlive any single probe bug

    def _health_loop(self) -> None:
        while not self._stopping.is_set():
            # probe CONCURRENTLY: serially, each unreachable replica
            # costs its full connect timeout, so a few dead replicas
            # would delay every OTHER replica's ejection/readmission by
            # seconds per sweep — the same serial-timeout pileup the
            # federated scrape already fans out to avoid
            probes = [
                threading.Thread(target=self._probe_health_safe,
                                 args=(shard,),
                                 name="kdtree-route-health-probe")
                for shard in self.shards
            ]
            for t in probes:
                t.start()
            for t in probes:
                t.join()
            if self._stopping.is_set():
                return
            self._stopping.wait(self.config.health_period_s)

    def shard_report(self) -> List[dict]:
        """One entry per shard SET. A set is routable while ANY replica
        is (reads load-balance); the top-level url/breaker/detail keys
        describe the primary — identical to the historical per-shard
        shape for single-replica sets — and ``replicas`` carries the
        full per-replica breakdown (each secondary's adopted epoch
        rides in its health detail, so fleet convergence after a
        blue/green swap is one /debug/shards read)."""
        out = []
        for sset in self.shard_sets:
            reps = []
            for r in sset.replicas:
                state = r.breaker.state
                reps.append({
                    "replica": r.replica,
                    "url": r.url,
                    "healthy": r.healthy,
                    "breaker": BREAKER_NAMES[state],
                    "routable": r.healthy and state != OPEN,
                    "detail": r.health_detail,
                })
            out.append({
                "index": sset.index,
                "url": sset.primary.url,
                "healthy": any(x["healthy"] for x in reps),
                "breaker": reps[0]["breaker"],
                # the one definition of set-level routability — the
                # quorum math in _send_health reads this key
                "routable": sset.routable(),
                "detail": reps[0]["detail"],
                "replicas": reps,
            })
        return out

    # -- lifecycle -----------------------------------------------------------

    def start(self, health_loop: bool = True) -> None:
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name="kdtree-route-accept"
        )
        self._serve_thread.start()
        if health_loop:
            self._health_thread = threading.Thread(
                target=self._health_loop, name="kdtree-route-health",
                daemon=True,
            )
            self._health_thread.start()
        if self.slo_engine is not None:
            from kdtree_tpu_torch.obs import history as obs_history

            self._sampler = obs_history.Sampler(
                history=self.slo_engine.history,
                on_sample=self._slo_tick,
            )
            self._sampler.start()

    def _slo_tick(self) -> None:
        if self.slo_engine is not None:
            self.slo_engine.evaluate()

    def stop(self) -> None:
        """Graceful: stop accepting, let in-flight scatters run to their
        own deadlines (handler threads are joined by ``server_close``,
        and every shard connection closes in the attempt that opened
        it), then stop the background loops."""
        self._stopping.set()
        self.shutdown()
        if self._serve_thread is not None:
            self._serve_thread.join()
            self._serve_thread = None
        if self._sampler is not None:
            self._sampler.stop()
            self._sampler = None
        if self._health_thread is not None:
            self._health_thread.join(timeout=2 * self.config.health_period_s
                                     + 2.0)
            self._health_thread = None
        self.server_close()
        if self.pool is not None:
            # after server_close: every handler thread (and so every
            # in-flight lease) has been joined — nothing can release a
            # connection back into a pool we just drained
            self.pool.close_all()
        obs.flush()


def make_router(
    shard_urls: List[str],
    host: str = "127.0.0.1",
    port: int = 0,
    config: Optional[RouterConfig] = None,
    slo_engine=None,
) -> Router:
    """Bind (port 0 = ephemeral) but do not start — same contract as
    :func:`kdtree_tpu_torch.serve.server.make_server`."""
    return Router((host, port), shard_urls, config=config,
                  slo_engine=slo_engine)
