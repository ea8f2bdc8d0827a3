"""Deterministic fault injection for the serving stack.

The router's whole value is how it behaves when a shard misbehaves — and
"a shard misbehaves" must be something a CPU-only CI job can *cause*, on
demand, repeatably. This module is that cause: named injection sites in
the shard server's request path, armed either by the
``KDTREE_TPU_FAULTS`` spec string at process start or live via
``POST /debug/faults``, firing **deterministically** (no probabilities —
a flaky fault injector is a flaky test suite).

Spec string grammar (comma-separated clauses)::

    site=kind[:param][*count]

    knn=latency:250        every POST /v1/knn sleeps 250 ms first
    knn=error              every POST /v1/knn answers 500
    knn=error:503*2        the next 2 answer 503, then the fault is spent
    knn=hang               handlers block until the fault is cleared
    knn=drop,healthz=error drop /v1/knn connections AND fail /healthz

Kinds:

- ``latency``: sleep ``param`` milliseconds, then continue normally —
  the slow-shard case hedging exists for;
- ``error``: answer HTTP ``param`` (default 500) without touching the
  engine — the crash-loop / bad-deploy case retries and breakers absorb;
- ``hang``: block the handler until the fault is cleared (bounded by an
  optional max-park param in milliseconds, default ``HANG_MAX_S``) —
  the wedged-process case only deadlines catch;
- ``drop``: close the connection without writing any response bytes —
  the network-partition case that surfaces as a protocol error, not a
  status code.

``*count`` bounds how many times a clause fires (unlimited without it);
a spent clause reports ``remaining: 0`` and stops matching, which is how
tests script "fail twice, then recover" without any timing dependence.

Every firing lands in the flight ring (``fault.fire`` events), so an
injected incident's dump reads exactly like a real one — with the cause
named. Sites are per-:class:`FaultSet`, and each server owns its own
set, so an in-process multi-shard test can fault one shard and not its
neighbors.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from kdtree_tpu_torch.utils import locks
from kdtree_tpu_torch.obs import flight

# a hang must still be bounded: an injected fault that outlives its test
# run (or its incident drill) should release itself rather than pin a
# non-daemon handler thread through shutdown forever
HANG_MAX_S = 600.0
_KINDS = ("latency", "error", "hang", "drop")

# the injection-site names the serving stack exposes (docs/SERVING.md):
# the shard request path, the health probe the router's ejection loop
# reads, and the batch worker's dispatch (the site that inflates the
# SERVER-side request histograms — the deterministic overload the
# degradation ladder's drills and tests step down under; an HTTP-layer
# knn=latency only slows the client's view, the batcher never sees it).
# A bounded, documented enum — not an open namespace: a typo'd site
# ("helthz") must be a parse error, or the drill it was meant to arm
# observes zero failures and passes vacuously.
SITE_KNN = "knn"
SITE_HEALTHZ = "healthz"
SITE_BATCH = "batch"
# the verb endpoints (/v1/radius, /v1/range, /v1/count) share one site:
# they share one handler path and one batch-worker dispatch, so a drill
# that faults "verb" faults all three — per-verb granularity would
# triple the enum without a failure mode that distinguishes them
SITE_VERB = "verb"
KNOWN_SITES = (SITE_KNN, SITE_HEALTHZ, SITE_BATCH, SITE_VERB)


class FaultSpecError(ValueError):
    """A malformed fault spec string (bad site/kind/param/count)."""


class Fault:
    """One armed clause: a site, a kind, and a firing budget."""

    __slots__ = ("site", "kind", "param", "remaining", "fired")

    def __init__(self, site: str, kind: str, param: Optional[float],
                 remaining: Optional[int]) -> None:
        self.site = site
        self.kind = kind
        self.param = param
        self.remaining = remaining  # None = unlimited
        self.fired = 0

    def describe(self) -> dict:
        return {
            "site": self.site,
            "kind": self.kind,
            "param": self.param,
            "remaining": self.remaining,
            "fired": self.fired,
        }


def parse_spec(spec: str) -> List[Fault]:
    """Parse a spec string into :class:`Fault` clauses; raises
    :class:`FaultSpecError` naming exactly what was wrong — a typo'd
    fault spec silently injecting nothing would make every "the router
    survives X" test vacuously green."""
    faults: List[Fault] = []
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise FaultSpecError(
                f"bad fault clause {clause!r}: expected site=kind[:param]"
                "[*count]"
            )
        site, rhs = (part.strip() for part in clause.split("=", 1))
        if site not in KNOWN_SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r} in {clause!r}: expected one "
                f"of {', '.join(KNOWN_SITES)} — an armed clause at a site "
                "no code fires would make its drill vacuously green"
            )
        remaining: Optional[int] = None
        if "*" in rhs:
            rhs, raw_count = (part.strip() for part in rhs.rsplit("*", 1))
            try:
                remaining = int(raw_count)
            except ValueError:
                raise FaultSpecError(
                    f"bad fault count {raw_count!r} in {clause!r}: "
                    "*count must be an integer"
                ) from None
            if remaining < 1:
                raise FaultSpecError(
                    f"bad fault count {remaining} in {clause!r}: "
                    "*count must be >= 1"
                )
        param: Optional[float] = None
        kind = rhs
        if ":" in rhs:
            kind, raw_param = (part.strip() for part in rhs.split(":", 1))
            try:
                param = float(raw_param)
            except ValueError:
                raise FaultSpecError(
                    f"bad fault param {raw_param!r} in {clause!r}: "
                    "must be a number"
                ) from None
        if kind not in _KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} in {clause!r}: "
                f"expected one of {', '.join(_KINDS)}"
            )
        if kind == "latency" and (param is None or param < 0):
            raise FaultSpecError(
                f"latency fault in {clause!r} needs a non-negative "
                "milliseconds param (latency:250)"
            )
        if kind == "hang" and param is not None and param < 0:
            raise FaultSpecError(
                f"hang fault max-park in {clause!r} must be non-negative "
                "milliseconds (hang:500)"
            )
        if kind == "error" and param is not None and \
                not (400 <= int(param) <= 599):
            raise FaultSpecError(
                f"error fault status {param:g} in {clause!r} must be an "
                "HTTP 4xx/5xx code"
            )
        faults.append(Fault(site, kind, param, remaining))
    return faults


class FaultSet:
    """The armed faults of one server process (or one in-process shard).

    ``fire(site)`` is the injection point: delay-kinds (latency, hang)
    are served *inside* the call and return None — the caller proceeds
    normally, just late; act-kinds (error, drop) return an action dict
    the caller must honor. Thread-safe; hangs release the moment the
    set is cleared or replaced (``set_spec``/``clear``/``release``), so
    a drained shutdown is never hostage to an injected wedge.
    """

    def __init__(self, spec: str = "") -> None:
        self._lock = locks.make_lock("serve.faults")
        self._faults: List[Fault] = parse_spec(spec)
        # replaced (never just .set()) on clear: a NEW spec arms with a
        # fresh un-set event while threads parked on the OLD one release
        self._unblock = threading.Event()

    # -- arming --------------------------------------------------------------

    def set_spec(self, spec: str) -> List[dict]:
        """Replace every armed fault with the parsed ``spec`` (empty
        string clears). Hangs parked on the previous spec release."""
        faults = parse_spec(spec)
        with self._lock:
            self._faults = faults
            old, self._unblock = self._unblock, threading.Event()
        old.set()
        flight.record("fault.armed", spec=spec,
                      clauses=[f.describe() for f in faults])
        return [f.describe() for f in faults]

    def clear(self) -> None:
        self.set_spec("")

    def release(self) -> None:
        """Release parked hangs WITHOUT disarming (shutdown calls this:
        the drain must complete even mid-incident-drill)."""
        with self._lock:
            old, self._unblock = self._unblock, threading.Event()
        old.set()

    def describe(self) -> List[dict]:
        with self._lock:
            return [f.describe() for f in self._faults]

    # -- firing --------------------------------------------------------------

    def _match(self, site: str):
        """First live clause for ``site`` (decrements its budget), plus
        the unblock event a hang should park on."""
        with self._lock:
            for f in self._faults:
                if f.site != site or f.remaining == 0:
                    continue
                if f.remaining is not None:
                    f.remaining -= 1
                f.fired += 1
                return f, self._unblock
            return None, None

    def fire(self, site: str) -> Optional[dict]:
        """Inject at ``site``. Returns None when the caller should
        proceed (no fault, or a delay-kind already served), or an action
        dict: ``{"kind": "error", "status": int}`` /
        ``{"kind": "drop"}``."""
        fault, unblock = self._match(site)
        if fault is None:
            return None
        flight.record("fault.fire", site=site, fault=fault.kind,
                      param=fault.param, remaining=fault.remaining)
        if fault.kind == "latency":
            time.sleep(float(fault.param) / 1e3)
            return None
        if fault.kind == "hang":
            # parked, not sleeping blind: clearing the set (or shutdown's
            # release()) wakes the handler immediately. The optional
            # param is a max-park bound in MILLISECONDS — same unit as
            # latency, so the grammar has one unit, not two.
            unblock.wait(
                HANG_MAX_S if fault.param is None
                else float(fault.param) / 1e3
            )
            return None
        if fault.kind == "error":
            return {"kind": "error",
                    "status": 500 if fault.param is None else int(fault.param)}
        return {"kind": "drop"}


def from_env() -> FaultSet:
    """The process-start fault set: ``KDTREE_TPU_FAULTS``. A malformed
    value fails crisply at startup (never at first traffic) — an
    injection drill that silently armed nothing is worse than a crash."""
    return FaultSet(os.environ.get("KDTREE_TPU_FAULTS", ""))
