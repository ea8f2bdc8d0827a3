"""Always-on flight recorder: the last N seconds of telemetry, on demand.

A Prometheus scrape is a snapshot of *totals*; when a serving process
sheds a burst or a CLI run dies, the question is "what happened in the
last few seconds, in order" — and by the time anyone scrapes, that order
is gone. This module keeps it: a bounded, thread-safe ring of recent
span completions and domain events (admissions, batch dispatches,
overflow retries, sheds, errors), recorded by host code at ~µs cost (one
dict build + a locked deque append — no device work, no syncs, no I/O),
and dumped atomically as JSON when something goes wrong.

Dump triggers:

- **SIGUSR2** (:func:`install_signal_handler`) — the operator's "what is
  this process doing right now" button; ``python -m kdtree_tpu_torch
  serve`` installs it.
- **Serve errors and shed bursts** — the serving layer calls
  :func:`auto_dump`, which rate-limits per reason (one overwritten file
  per reason, never a flood of files during a sustained incident).
- **``GET /debug/flight``** — the live ring as JSON, no file involved.

The port of ``kdtree_tpu/obs/flight.py``; it reads the same
``KDTREE_TPU_FLIGHT*`` environment names.

Cost model: the recorder sits in the ALWAYS-ON tier of
``docs/OBSERVABILITY.md`` — events are recorded per span / per batch /
per request, never per row, and recording never raises into the caller.
The dump path (file I/O) runs only on the triggers above.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

from kdtree_tpu_torch.utils import locks

DEFAULT_CAPACITY = 1024
# one dump file per reason, overwritten (atomic replace): a sustained
# incident refreshes its timeline instead of carpeting the disk
_MIN_DUMP_INTERVAL_S = 5.0
DUMP_VERSION = 1


def _dump_dir() -> Optional[str]:
    """Where auto-dumps land: ``KDTREE_TPU_FLIGHT_DIR`` (empty/none/off
    disables file dumps entirely), defaulting to the current directory
    for long-lived serving, where an incident artifact is wanted."""
    raw = os.environ.get("KDTREE_TPU_FLIGHT_DIR")
    if raw is None:
        return "."
    return None if raw.lower() in ("", "0", "none", "off") else raw


class FlightRecorder:
    """Bounded ring of recent telemetry events.

    ``capacity`` counts events, not bytes — the recorder's memory is
    bounded by construction (deque maxlen), and the overwrite count is
    reported in every dump so a reader knows how much history fell off
    the front.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        # REENTRANT: the SIGUSR2 handler runs on the main thread between
        # any two bytecodes — including inside record()'s critical
        # section. A plain Lock would deadlock the process right there;
        # with an RLock the handler's snapshot may at worst miss the one
        # event mid-append (reported via `dropped`), which is fine for
        # an incident dump.
        self._lock = locks.make_rlock("obs.flight.ring")
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0  # monotone event id; dropped = seq - len(ring)
        self._last_dump: Dict[str, float] = {}  # reason -> monotonic time

    # -- recording (the hot side) ------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one event. Never raises into the instrumented caller —
        a telemetry bug must not fail the run it observes."""
        try:
            event = {"ts": time.time(), "type": kind}
            event.update(fields)
            with self._lock:
                event["seq"] = self._seq
                self._seq += 1
                self._ring.append(event)
        except Exception:
            pass

    # -- reading / dumping --------------------------------------------------

    def snapshot(self) -> List[dict]:
        """A consistent copy of the ring, oldest first."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            n = len(self._ring)
            return {
                "capacity": self.capacity,
                "events": n,
                "dropped": self._seq - n,
            }

    def report(self, reason: str = "") -> dict:
        """The dump payload: ring contents + enough identity to read one
        in isolation (pid, wall time, overwrite count)."""
        snap = self.snapshot()
        st = self.stats()
        return {
            "flight_version": DUMP_VERSION,
            "generated_unix": time.time(),
            "reason": reason,
            "pid": os.getpid(),
            "capacity": st["capacity"],
            "dropped": st["dropped"],
            "events": snap,
        }

    def dump(self, path: str, reason: str = "") -> str:
        """Atomic write (tmp + ``os.replace``): a dump raced by a crash —
        or by a second signal — must never leave a truncated file where a
        parseable one stood. Returns ``path``."""
        rep = self.report(reason)
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            # default=str: one unserializable event field must not cost
            # the whole (otherwise parseable) incident timeline
            json.dump(rep, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def reset_dump_rate_limit(self) -> None:
        """Forget every per-reason dump timestamp, so the next
        :meth:`auto_dump` of any reason writes immediately. Test
        isolation: the process-wide recorder otherwise couples tests
        that dump the same reason within ``_MIN_DUMP_INTERVAL_S``
        (tests/conftest.py clears it before every test so any
        hand-picked collection order passes)."""
        with self._lock:
            self._last_dump.clear()

    def claim_dump(self, reason: str, force: bool = False) -> bool:
        """Claim the per-reason rate-limit slot (at most one dump per
        reason per ``_MIN_DUMP_INTERVAL_S``; ``force`` always claims).
        Split out from the write so the module-level :func:`auto_dump`
        can claim synchronously and serialize on a background thread."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if not force and last is not None and \
                    now - last < _MIN_DUMP_INTERVAL_S:
                return False
            self._last_dump[reason] = now
            return True

    def auto_dump(self, reason: str, force: bool = False) -> Optional[str]:
        """Rate-limited incident dump to the flight dir (see
        :func:`_dump_dir`): at most one file write per reason per
        ``_MIN_DUMP_INTERVAL_S``, each overwriting ``flight-<reason>.json``
        so the newest incident timeline wins. ``force`` (operator
        triggers: SIGUSR2) skips the rate limit. Never raises — the dump
        observes a failure, it must not compound one. Returns the path
        written, or None (disabled / rate-limited / write failed)."""
        try:
            d = _dump_dir()
            if d is None:
                return None
            if not self.claim_dump(reason, force=force):
                return None
            return self.dump(os.path.join(d, f"flight-{_safe_reason(reason)}.json"),
                             reason=reason)
        except Exception:
            return None


def _safe_reason(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in reason) or "dump"


class BurstDetector:
    """Turns a high-rate event (shed, error) into a low-rate trigger:
    fires when ``threshold`` marks land within ``window_s`` seconds.
    Thread-safe; each firing clears the window so a sustained burst
    re-fires at most once per window rather than per event."""

    def __init__(self, threshold: int = 10, window_s: float = 1.0) -> None:
        self.threshold = max(int(threshold), 1)
        self.window_s = float(window_s)
        self._lock = locks.make_lock("obs.flight.burst")
        self._marks: collections.deque = collections.deque(
            maxlen=self.threshold
        )

    def mark(self) -> bool:
        """Record one event; True when this event completes a burst."""
        now = time.monotonic()
        with self._lock:
            self._marks.append(now)
            if len(self._marks) < self.threshold:
                return False
            if now - self._marks[0] <= self.window_s:
                self._marks.clear()
                return True
            return False


def _env_capacity() -> int:
    """KDTREE_TPU_FLIGHT_EVENTS, defaulting (not crashing) on garbage —
    a malformed env var must not fail every instrumented import."""
    raw = os.environ.get("KDTREE_TPU_FLIGHT_EVENTS", "")
    try:
        v = int(raw) if raw else DEFAULT_CAPACITY
    except ValueError:
        return DEFAULT_CAPACITY
    return v if v >= 1 else DEFAULT_CAPACITY


_recorder = FlightRecorder(capacity=_env_capacity())


# A/B kill switch (read once at import — instrumented hot paths must not
# pay an env lookup per event): KDTREE_TPU_FLIGHT=0/off/none disables
# recording entirely, the measurement partner for the <2% bench-overhead
# check, same idiom as KDTREE_TPU_METRICS_OUT=none
_DISABLED = os.environ.get(
    "KDTREE_TPU_FLIGHT", ""
).lower() in ("0", "off", "none")


def recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, **fields) -> None:
    """Module-level convenience over the process recorder (what library
    instrumentation calls — and where the kill switch applies)."""
    if _DISABLED:
        return
    _recorder.record(kind, **fields)


def _dump_history_companion(reason: str) -> None:
    """Every incident that earned a flight dump gets the metric-history
    ring dumped alongside it (``history-<reason>.json``) AND the pinned
    distributed traces (``trace-<reason>.json``, obs/trace.py): the
    flight ring says what happened in order, the history ring says how
    the totals were trending into it, and the trace companion says where
    each retained slow/errored/degraded request's time went. Piggybacks
    the flight rate limit — this only runs when a flight file was
    claimed."""
    try:
        from kdtree_tpu_torch.obs import history

        history.auto_dump(reason)
    except Exception:
        pass
    try:
        from kdtree_tpu_torch.obs import trace

        trace.auto_dump(reason)
    except Exception:
        pass


def filter_events(events: List[dict], trace: Optional[str] = None,
                  reason: Optional[str] = None) -> List[dict]:
    """Server-side ring filters (``GET /debug/flight?trace=<id>`` /
    ``?reason=<r>``): the rings already carry trace ids on admissions,
    batches, sheds and span completions — filtering HERE spares clients
    fetching and grepping 1024 events, which was the debugging hot
    path. ``trace`` matches an event's ``trace``/``trace_id`` field or
    membership in a batch event's ``traces`` list; ``reason`` matches
    ``reason``/``degraded`` (the two fields incident events name their
    cause in). Both given = both must match."""
    out = []
    for e in events:
        if trace is not None:
            et = e.get("trace") or e.get("trace_id")
            if et != trace and trace not in (e.get("traces") or ()):
                continue
        if reason is not None:
            if str(e.get("reason", "")) != reason and \
                    str(e.get("degraded", "")) != reason:
                continue
        out.append(e)
    return out


def _write_dump(path: str, reason: str) -> None:
    try:
        _recorder.dump(path, reason=reason)
    except Exception:
        return
    _dump_history_companion(reason)


def auto_dump(reason: str, force: bool = False) -> Optional[str]:
    """The incident-dump entry point instrumentation calls.

    ``force=True`` (operator triggers: SIGUSR2, the CLI's exit-time
    dump) writes SYNCHRONOUSLY — those dumps must exist before the
    process moves on or exits. Rate-limited incident dumps
    (``force=False``) claim their per-reason slot synchronously but
    serialize on a short-lived background thread: the callers sit on
    serving threads (batch worker, scatter/gather, the SLO sampler,
    the admission gate), and once a process registry has grown to
    hundreds of series the history companion can take SECONDS to
    serialize — a partial answer must not pay that inline (observed:
    a routed partial stalling ~2.5 s on its own incident dump). The
    writer thread is non-daemon, so a claimed dump is never lost to
    interpreter exit; at most one per reason per rate-limit window
    exists by construction. Returns the path that is (being) written,
    or None (disabled / rate-limited)."""
    if force:
        path = _recorder.auto_dump(reason, force=True)
        if path is not None:
            _dump_history_companion(reason)
        return path
    try:
        d = _dump_dir()
        if d is None:
            return None
        if not _recorder.claim_dump(reason):
            return None
        path = os.path.join(d, f"flight-{_safe_reason(reason)}.json")
        # deliberately non-daemon and unjoined: a claimed incident dump
        # must survive interpreter exit, and the thread ends by itself
        threading.Thread(target=_write_dump, args=(path, reason),
                         name="kdtree-flight-dump").start()
        return path
    except Exception:
        return None


_handler_installed = False


def install_signal_handler() -> bool:
    """Install the SIGUSR2 dump trigger (main thread only — the signal
    module's constraint, not ours). Idempotent; returns whether the
    handler is installed after the call. The handler itself only dumps —
    it must stay safe to run between any two bytecodes of the main
    thread, so no locks beyond the recorder's own."""
    global _handler_installed
    import signal

    if _handler_installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False

    def _on_sigusr2(signum, frame):
        # the module-level auto_dump so the operator's button also drops
        # the metric-history companion next to the flight ring
        path = auto_dump("sigusr2", force=True)
        if path:
            import sys

            print(f"flight recorder dumped to {path}", file=sys.stderr)

    try:
        signal.signal(signal.SIGUSR2, _on_sigusr2)
    except (ValueError, OSError, AttributeError):
        # non-main thread race, or a platform without SIGUSR2
        return False
    _handler_installed = True
    return True
