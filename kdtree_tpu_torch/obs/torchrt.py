"""PyTorch runtime telemetry: kernel builds, device init, platform, memory.

The counterpart of ``kdtree_tpu/obs/jaxrt.py``. Every report says which
platform actually ran, on which device, how long the device took to come
up, and how much device memory the run holds; and every nvcc build of a
CUDA kernel at first use is counted — the port's counterpart of an XLA
backend compile:

- ``kdtree_kernel_builds_total`` / ``kdtree_kernel_build_seconds_total``
  (recorded by ``kernels/_build.py::build``): a process builds each
  kernel source once, at first use, so growth after warmup means a
  rebuild (an edited source, or a build directory that went away);
- ``torch_platform_info{device, platform}``, ``torch_device_count`` and
  ``torch_device_init_seconds`` (:func:`record_device_init`,
  :func:`probe_devices`);
- ``torch_device_memory_bytes{device, stat}`` (:func:`snapshot_device_memory`):
  ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` /
  ``memory_reserved`` and the driver's ``mem_get_info`` free and total.
  A CPU run records no memory gauges: fabricating host numbers into a
  device metric would mislead.

:func:`install` records the platform facts once per process (the serving
warmup calls it, as the reference's calls ``jaxrt.install``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from kdtree_tpu_torch.obs.registry import MetricsRegistry, get_registry
from kdtree_tpu_torch.utils import locks

_install_lock = locks.make_lock("obs.torchrt.install")
_installed = False
_registry_override: Optional[MetricsRegistry] = None


def _reg() -> MetricsRegistry:
    return _registry_override or get_registry()


def record_build(sources: int, seconds: float) -> None:
    """Count ``sources`` kernel sources built by one parallel nvcc round
    and the round's wall seconds (counted once, however many sources
    overlapped in it). Never raises — telemetry must not fail the build
    it observes."""
    try:
        reg = _reg()
        reg.counter("kdtree_kernel_builds_total").inc(max(int(sources), 0))
        reg.counter("kdtree_kernel_build_seconds_total").inc(
            max(float(seconds), 0.0))
    except Exception:
        pass


def build_count(registry: Optional[MetricsRegistry] = None) -> float:
    """Kernel sources built so far in this process."""
    reg = registry or _reg()
    return reg.counter("kdtree_kernel_builds_total").value


def _device(device) -> "object":
    import torch

    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def record_device_init(
    seconds: float, device=None, registry: Optional[MetricsRegistry] = None,
) -> None:
    """Record the device-init duration plus the platform, device name and
    device count — a CPU run must be distinguishable from a CUDA run by
    its telemetry alone."""
    import torch

    reg = registry or _reg()
    dev = _device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        count = torch.cuda.device_count()
    else:
        name, count = "cpu", 1
    reg.gauge("torch_device_init_seconds").set(seconds)
    reg.gauge("torch_device_count").set(count)
    reg.gauge(
        "torch_platform_info", labels={"device": name, "platform": dev.type}
    ).set(1.0)


def probe_devices(device=None, registry: Optional[MetricsRegistry] = None):
    """Time the device's initialisation (the first CUDA call of a process
    creates the context) and record it. Returns the device."""
    import torch

    dev = _device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.synchronize(dev)
    record_device_init(time.perf_counter() - t0, dev, registry)
    return dev


def install(device=None, registry: Optional[MetricsRegistry] = None) -> None:
    """Record the platform facts once per process (idempotent);
    ``registry`` redirects every later record of this module."""
    global _installed, _registry_override
    if registry is not None:
        _registry_override = registry
    with _install_lock:
        if _installed:
            return
        probe_devices(device)
        _installed = True


def snapshot_device_memory(
    device=None, registry: Optional[MetricsRegistry] = None,
) -> Dict[str, Dict[str, int]]:
    """Device-memory gauges, one per (device, stat), for every visible CUDA
    device (``device`` narrows to one). Returns the raw stats for report
    embedding; empty on a CPU run."""
    import torch

    reg = registry or _reg()
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    idxs = (range(torch.cuda.device_count()) if device is None
            else [_device(device).index or 0])
    for i in idxs:
        free, total = torch.cuda.mem_get_info(i)
        stats = {
            "allocated": torch.cuda.memory_allocated(i),
            "max_allocated": torch.cuda.max_memory_allocated(i),
            "reserved": torch.cuda.memory_reserved(i),
            "free": free,
            "total": total,
        }
        out[str(i)] = {k: int(v) for k, v in stats.items()}
        for key, val in out[str(i)].items():
            reg.gauge("torch_device_memory_bytes",
                      labels={"device": str(i), "stat": key}).set(val)
    return out
