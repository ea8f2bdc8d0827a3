"""ctypes binding for the native mt19937 replay generator.

Compiled on first use with the system g++ from ``gen.cpp`` beside this
file into the package's ``_build/`` directory; ``available()`` is False
when no toolchain exists. Host-only: the rows come back as numpy arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "gen.cpp"
_SO = _HERE.parent / "_build" / "libkdtgen.so"
_lock = threading.Lock()
_lib = None
_failed = False


def _compile() -> None:
    # compile to a PID-suffixed temp and os.replace() into place so a
    # concurrent process can never CDLL a partially written file
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".so.{os.getpid()}")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
        check=True, capture_output=True,
    )
    os.replace(tmp, _SO)


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _compile()
            try:
                lib = ctypes.CDLL(str(_SO))
            except OSError:
                # stale or wrong-arch binary: force one rebuild before giving up
                _compile()
                lib = ctypes.CDLL(str(_SO))
            lib.kdt_generate_rows.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.kdt_generate_rows.restype = None
            _lib = lib
        except Exception:
            _failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def generate_rows(seed: int, dim: int, row_start: int, row_count: int) -> np.ndarray:
    """Rows [row_start, row_start+row_count) of the reference mt19937 stream
    (std::mt19937 + uniform_real_distribution<float>(-100, 100))."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native generator unavailable (no g++ toolchain?)")
    out = np.empty((row_count, dim), dtype=np.float32)
    lib.kdt_generate_rows(
        seed, dim, row_start, row_count,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def generate_problem_mt19937(seed: int, dim: int, num_points: int, num_queries: int = 10):
    """(points[N, D], queries[Q, D]) in the reference's layout: one stream
    of N+Q rows, queries last."""
    rows = generate_rows(seed, dim, 0, num_points + num_queries)
    return rows[:num_points], rows[num_points:]
