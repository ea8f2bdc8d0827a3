"""Build the port's CUDA kernels with nvcc at first use, and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``_build/lib<name>-<hash>.so``, where the hash covers
the source, the ``.cuh`` headers beside it and the flags: an edited source
builds anew, an unchanged one loads the library already there. Only the
sources in this checkout and ``nvcc`` are used. :func:`build` starts one
``nvcc`` per source, all together, and waits for them; a failed build
raises with nvcc's output. A build is the port's counterpart of an XLA
compile: it runs inside a ``kernel.build`` profiler range (a capture
window that holds one was not measuring steady state,
:mod:`kdtree_tpu_torch.obs.timeline`) and each built source counts in
``kdtree_kernel_builds_total`` with its seconds
(:mod:`kdtree_tpu_torch.obs.torchrt`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # used when nvcc is not on PATH
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: the CUDA kernels build from source "
                       "with the CUDA toolkit's nvcc on PATH")


def lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # headers the sources include
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all) whose library is missing,
    one nvcc each, in parallel. Returns nvcc's output per built source."""
    from kdtree_tpu_torch.obs import torchrt

    names = sources() if names is None else names
    missing = [name for name in names if not lib_path(name).exists()]
    if not missing:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with torch.profiler.record_function("kernel.build"):
        t0 = time.perf_counter()
        procs = {}
        for name in missing:
            out = lib_path(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):"
                              f"\n{log}")
                continue
            os.replace(tmp, out)
        torchrt.record_build(len(missing) - len(failed),
                             time.perf_counter() - t0)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
