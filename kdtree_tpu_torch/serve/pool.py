"""Per-shard persistent connection pooling for the router hot path.

The port of ``kdtree_tpu/serve/pool.py``, host code copied as it is (the
port's lock factory in place of the lock-order sanitizer's).

A router may open a fresh TCP connection per shard attempt —
correct, orphan-proof, and easy to reason about under hedging — but at
production QPS the handshake tax dominates: every routed request pays
(shards contacted) x (TCP setup + slow-start) before the first useful
byte moves. The shard servers already speak HTTP/1.1 with
``Content-Length`` on every response and a bounded idle keep-alive
window (``JsonRequestHandler.timeout``), so the connections were
reusable all along; this module is the router-side half of that
contract.

Design constraints, in order:

1. **Never a dirty reuse.** A pooled connection returns to the idle
   list only after a FULLY-drained exchange (``resp.read()`` to EOF,
   ``will_close`` false). Anything else — an exception mid-exchange, a
   timeout, a hedge loser whose socket the winner closed, an undrained
   body — is a discard: close, count, drop. A wrong answer served off
   a half-read socket is strictly worse than any number of fresh
   handshakes.
2. **Abort composes with hedging.** The hedge winner closes the
   loser's connection by handle (``PooledConn.close()``); the mark is
   sticky (``dead``), so even if the loser's thread had already
   released the connection back to the idle list, the next lease
   inspects the flag and discards instead of reusing a closed socket.
3. **Bounded staleness.** The shard server hangs up idle connections
   after ``JsonRequestHandler.timeout`` (5 s) — reuse is attempted
   only within ``idle_reuse_s`` (default 2 s) of the last exchange,
   well inside that window (the same bound ``loadgen``'s worker
   connections use). A connection that went stale anyway (shard
   restart, window race) fails the next ``request()``/``getresponse``
   crisply; the router retries that ONE attempt on a fresh connection
   (see ``Router._call_shard``) so a restart costs a round-trip,
   never a wrong answer or a hang.
4. **No I/O under locks**: list surgery happens under the
   pool lock; ``connect()``/``close()``/send/recv always outside it.

Metrics: ``kdtree_router_pool_hits_total`` / ``_misses_total`` (the
loadgen runner turns their deltas into the per-step connection-reuse
fraction) and ``kdtree_router_pool_discards_total{reason}`` with the
bounded reason enum ``("stale", "abort", "error", "full", "undrained",
"shutdown")``.
"""

from __future__ import annotations

import http.client
import time
from typing import Dict, List, Optional, Tuple

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.utils import locks

DEFAULT_MAX_IDLE = 8          # idle connections kept per (host, port)
DEFAULT_IDLE_REUSE_S = 2.0    # reuse window << server's 5 s idle timeout

# bounded discard-reason enum (metric labels must be finite)
DISCARD_REASONS = ("stale", "abort", "error", "full", "undrained",
                   "shutdown")


class PooledConn:
    """One keep-alive connection plus its lease state. The object — not
    the raw ``http.client`` connection — is what hedge ``conn_box``
    registries hold, so an abort marks the pool's bookkeeping and
    closes the socket in one call."""

    __slots__ = ("conn", "host", "port", "reused", "dead", "last_used")

    def __init__(self, host: str, port: int, timeout_s: float) -> None:
        self.host = host
        self.port = int(port)
        self.conn = http.client.HTTPConnection(host, port,
                                               timeout=timeout_s)
        self.reused = False       # True when leased from the idle list
        self.dead = False         # sticky abort/discard mark
        self.last_used = time.monotonic()

    def close(self) -> None:
        """Abort: close the socket and mark the connection dead. Safe
        (and idempotent) from a concurrent thread — the hedge winner's
        loser-close sweep calls this without knowing whether the loser
        is mid-read, already failed, or already released."""
        self.dead = True
        try:
            self.conn.close()
        except Exception:
            pass

    def fresh(self, idle_reuse_s: float,
              now: Optional[float] = None) -> bool:
        """May this idle connection be leased? Only while the socket is
        open, un-aborted, and inside the reuse window — past it the
        server's idle reaper may have hung up already, and leasing a
        probably-dead socket converts a cheap miss into a retry."""
        now = now if now is not None else time.monotonic()
        return (not self.dead
                and self.conn.sock is not None
                and now - self.last_used <= idle_reuse_s)


class ConnectionPool:
    """Bounded keep-alive pools per (host, port).

    ``lease`` never blocks waiting for a connection: an empty (or
    entirely stale) idle list is a miss that opens a fresh connection
    — the pool trades handshakes away, never adds queueing. LIFO
    reuse: the most recently used connection is the one most likely
    still inside the server's idle window.
    """

    def __init__(self, max_idle: int = DEFAULT_MAX_IDLE,
                 idle_reuse_s: float = DEFAULT_IDLE_REUSE_S) -> None:
        if max_idle < 0:
            raise ValueError(f"max_idle must be >= 0, got {max_idle}")
        self.max_idle = int(max_idle)
        self.idle_reuse_s = float(idle_reuse_s)
        self._lock = locks.make_lock("route.pool")
        self._idle: Dict[Tuple[str, int], List[PooledConn]] = {}
        self._closed = False

    # -- telemetry -----------------------------------------------------------

    @staticmethod
    def _count(name: str, reason: Optional[str] = None) -> None:
        labels = {"reason": reason} if reason is not None else None
        obs.get_registry().counter(name, labels=labels).inc()

    # -- lease / release / discard -------------------------------------------

    def lease(self, host: str, port: int,
              timeout_s: float) -> PooledConn:
        """An open-or-openable connection to (host, port): a healthy
        idle one when available (hit), else a fresh one (miss). The
        per-request ``timeout_s`` is (re)applied either way — timeouts
        are a property of the attempt, not the socket."""
        key = (host, int(port))
        candidates: List[PooledConn] = []
        with self._lock:
            bucket = self._idle.get(key)
            while bucket:
                candidates.append(bucket.pop())
        # validate OUTSIDE the lock (close() is socket I/O); the first
        # fresh candidate wins, the rest go straight back
        picked: Optional[PooledConn] = None
        stale: List[PooledConn] = []
        keep: List[PooledConn] = []
        now = time.monotonic()
        for pc in candidates:
            if picked is None and pc.fresh(self.idle_reuse_s, now):
                picked = pc
            elif pc.fresh(self.idle_reuse_s, now):
                keep.append(pc)
            else:
                stale.append(pc)
        if keep:
            with self._lock:
                if not self._closed:
                    self._idle.setdefault(key, []).extend(reversed(keep))
                else:
                    stale.extend(keep)
        for pc in stale:
            reason = "abort" if pc.dead else "stale"
            pc.close()
            self._count("kdtree_router_pool_discards_total", reason)
        if picked is not None:
            picked.reused = True
            picked.conn.timeout = timeout_s
            if picked.conn.sock is not None:
                try:
                    picked.conn.sock.settimeout(timeout_s)
                except OSError:
                    pass  # a racing close: the attempt will fail crisply
            self._count("kdtree_router_pool_hits_total")
            return picked
        self._count("kdtree_router_pool_misses_total")
        return PooledConn(host, port, timeout_s)

    def release(self, pc: PooledConn, drained: bool = True) -> None:
        """Return a connection after a clean, FULLY-drained exchange.
        Anything that disqualifies reuse — an abort mark, a closed
        socket, an undrained body, a full bucket, a stopped pool —
        degrades to a counted discard, never to a dirty idle entry."""
        if pc.dead or pc.conn.sock is None:
            self.discard(pc, "abort")
            return
        if not drained:
            # a body not read to EOF leaves response bytes in the
            # socket: the next exchange would parse them as ITS
            # response — the one corruption worse than any failure
            self.discard(pc, "undrained")
            return
        pc.last_used = time.monotonic()
        pc.reused = False
        with self._lock:
            if not self._closed:
                bucket = self._idle.setdefault((pc.host, pc.port), [])
                if len(bucket) < self.max_idle:
                    bucket.append(pc)
                    return
                reason = "full"
            else:
                reason = "shutdown"
        # close OUTSIDE the lock
        pc.close()
        self._count("kdtree_router_pool_discards_total", reason)

    def discard(self, pc: PooledConn, reason: str = "error") -> None:
        """Close and drop — the only valid disposal after an exception,
        timeout, or hedge abort."""
        if reason not in DISCARD_REASONS:
            reason = "error"
        pc.close()
        self._count("kdtree_router_pool_discards_total", reason)

    # -- lifecycle / introspection -------------------------------------------

    def idle_count(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._idle.values())

    def close_all(self) -> None:
        """Shutdown: close every idle connection; later releases
        discard instead of parking on a dead pool."""
        with self._lock:
            self._closed = True
            drained = [pc for b in self._idle.values() for pc in b]
            self._idle.clear()
        for pc in drained:
            pc.close()
