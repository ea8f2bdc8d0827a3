"""Programmatic ``torch.profiler`` capture windows.

The port of ``kdtree_tpu/obs/profile.py``. The obs spans measure host
wall-clock; a capture window records the other half — the CUDA kernels,
copies and memsets the card ran, beside the ``record_function`` ranges
the spans and the tiled driver open — as a Chrome trace that
:mod:`kdtree_tpu_torch.obs.timeline` joins back to the host spans.

Three properties of ``torch.profiler`` shape this module and its users:

- A profiler started on one thread records only that thread's ranges and
  ops unless it is asked for all threads (``profile_all_threads``), so
  every window here profiles all threads.
- A window opened on one thread while another launches kernels at a
  serving rate can crash the process (a SIGSEGV in a native thread, with
  or without ``profile_all_threads``): on an H100 under 4 clients, 1 of
  21 such windows, and none of 30 opened on the launching thread
  (``chip_smoke.py --profile-stress``). The server therefore has its
  batch worker start and stop its windows (:class:`Window`,
  ``serve/batcher.py::MicroBatcher.capture_for``) and the asking thread
  write the trace; the CLI opens them on the thread that runs the work.
- It is a process singleton: a second start while one is live fails deep
  in the profiler. The non-blocking lock here turns that into a crisp
  :class:`CaptureBusyError` (``POST /debug/profile`` maps it to 409).

A window profiles the CPU always and CUDA when the window's device is a
CUDA card. A capture that cannot start, or writes no trace, raises.
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import os
import time
from typing import Iterator, Optional

from kdtree_tpu_torch.obs.registry import get_registry
from kdtree_tpu_torch.utils import locks

TRACE_SUFFIX = ".pt.trace.json"


class CaptureBusyError(RuntimeError):
    """A capture window is already open in this process."""


_capture_lock = locks.make_lock("obs.profile.capture")


def capture_active() -> bool:
    """Whether a capture window is currently open (lock held)."""
    if _capture_lock.acquire(blocking=False):
        _capture_lock.release()
        return False
    return True


class CaptureResult:
    """Handle yielded by :func:`capture`; the trace location fields are
    filled in when the window closes. ``start_seconds``,
    ``stop_seconds`` and ``export_seconds`` are what the profiler's
    start, stop and trace export each took: the first two run on the
    thread that opened the window, and all three hold the GIL, so they
    are the pause a window puts on the process's Python threads."""

    def __init__(self, log_dir: str) -> None:
        self.log_dir = log_dir
        self.trace_file: Optional[str] = None
        self.begin_unix = time.time()
        self.end_unix: Optional[float] = None
        self.start_seconds = 0.0
        self.stop_seconds = 0.0
        self.export_seconds = 0.0

    @property
    def wall_seconds(self) -> float:
        end = self.end_unix if self.end_unix is not None else time.time()
        return end - self.begin_unix


def latest_trace_file(log_dir: str) -> Optional[str]:
    """Newest Chrome-trace artifact a capture wrote under ``log_dir``
    (``<log_dir>/<pid>-<n>.pt.trace.json``, one per window)."""
    files = glob.glob(os.path.join(log_dir, f"*{TRACE_SUFFIX}"))
    if not files:
        return None
    return max(files, key=os.path.getmtime)


def _cuda_wanted(device) -> bool:
    """Whether the window traces a card: the port's device rule (CUDA
    unless the caller asks for the CPU; no CUDA device raises)."""
    from kdtree_tpu_torch import resolve_device

    return resolve_device(device).type == "cuda"


def _profiler(cuda: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=acts, experimental_config=cfg)


_seq = itertools.count(1)  # window numbers: one trace file each


class Window:
    """One open capture window, in two halves: :meth:`stop` runs on the
    thread that opened it (the thread that launches the kernels, see the
    module docstring), :meth:`export` writes the trace and may run on any
    thread. The process's capture lock is held from the open to the end
    of the export (or :meth:`abort`), so a second window meanwhile gets
    :class:`CaptureBusyError`."""

    def __init__(self, log_dir: str, device=None) -> None:
        from kdtree_tpu_torch.obs import flight

        cuda = _cuda_wanted(device)
        if not _capture_lock.acquire(blocking=False):
            raise CaptureBusyError(
                "a profiler capture is already active in this process "
                "(one capture at a time)"
            )
        self.result = CaptureResult(log_dir)
        self._prof = None
        try:
            os.makedirs(log_dir, exist_ok=True)
            prof = _profiler(cuda)
            t0 = time.perf_counter()
            prof.start()
            self.result.start_seconds = time.perf_counter() - t0
            self._prof = prof
        except BaseException:
            _capture_lock.release()
            raise
        flight.record("profile.capture_start", log_dir=log_dir,
                      start_s=self.result.start_seconds)

    def stop(self) -> None:
        """Stop the profiler (the thread that opened the window)."""
        t0 = time.perf_counter()
        try:
            self._prof.stop()
        except BaseException:
            self.abort()
            raise
        self.result.stop_seconds = time.perf_counter() - t0
        self.result.end_unix = time.time()

    def export(self) -> CaptureResult:
        """Write the stopped window's trace and release the capture lock;
        raises ``RuntimeError`` if no trace was written."""
        from kdtree_tpu_torch.obs import flight

        result = self.result
        try:
            path = os.path.join(
                result.log_dir, f"{os.getpid()}-{next(_seq)}{TRACE_SUFFIX}")
            t0 = time.perf_counter()
            self._prof.export_chrome_trace(path)
            result.export_seconds = time.perf_counter() - t0
            result.trace_file = path if os.path.exists(path) else None
            get_registry().counter("kdtree_profile_captures_total").inc()
            flight.record(
                "profile.capture_stop", log_dir=result.log_dir,
                seconds=result.wall_seconds,
                trace_file=result.trace_file or "",
                start_s=result.start_seconds, stop_s=result.stop_seconds,
                export_s=result.export_seconds,
            )
        finally:
            self._release()
        if result.trace_file is None:
            raise RuntimeError(
                f"the profiler wrote no trace under {result.log_dir}")
        return result

    def abort(self) -> None:
        """Give the window up without a trace (its stop failed, or nobody
        will export it)."""
        self._release()

    def _release(self) -> None:
        if self._prof is not None:
            self._prof = None
            _capture_lock.release()


@contextlib.contextmanager
def capture(log_dir: str, device=None) -> Iterator[CaptureResult]:
    """Open a profiler capture window writing under ``log_dir``, on this
    thread.

    ``device`` picks the activities: a CUDA device (the default; without
    a card it raises) adds CUDA tracing, ``"cpu"`` profiles the CPU alone.
    Raises :class:`CaptureBusyError` (without touching the profiler) if a
    window is already open in this process. On exit the profiler stops
    even if the profiled region raised, and the yielded
    :class:`CaptureResult` carries the written trace file; a window that
    wrote none raises ``RuntimeError``."""
    window = Window(log_dir, device)
    try:
        yield window.result
    finally:
        window.stop()
        window.export()


def capture_for(seconds: float, log_dir: str, device=None) -> CaptureResult:
    """Open a capture window over whatever the process is doing for
    ``seconds`` wall-clock while this thread sleeps inside it. Returns the
    closed :class:`CaptureResult`. (A server asks its batch worker
    instead: see the module docstring.)"""
    with capture(log_dir, device) as result:
        time.sleep(max(float(seconds), 0.0))
    return result
