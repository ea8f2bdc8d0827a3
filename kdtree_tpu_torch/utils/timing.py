"""Benchmark timing: named phases, each fenced so asynchronous launches
cannot end its clock early.

The port of ``kdtree_tpu/utils/timing.py``'s ``PhaseTimer``. A phase
yields a list; the code in it appends what the phase produced, and the
clock stops only after :func:`hard_sync` has waited for those outputs:
``torch.cuda.synchronize()`` plus a one-element fetch to the host, a
data-dependent barrier. Warm-up is the caller's: time fresh inputs after
a first run.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif hasattr(obj, "__dict__"):
        for o in vars(obj).values():
            if isinstance(o, torch.Tensor):
                yield o


def hard_sync(outputs) -> None:
    """Wait until every CUDA tensor in ``outputs`` (tensors, nested
    lists/tuples, or objects holding tensors) is computed."""
    cuda = [t for t in _tensors(outputs) if t.device.type == "cuda"]
    if not cuda:
        return
    torch.cuda.synchronize(cuda[0].device)
    for t in cuda:
        if t.numel():
            t.reshape(-1)[:1].cpu()
            break


class PhaseTimer:
    """Collects named phase durations (seconds, host clock)."""

    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        outputs: list = []
        t0 = time.perf_counter()
        yield outputs
        hard_sync(outputs)
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def total(self) -> float:
        return sum(self.phases.values())

    def report(self) -> Dict[str, float]:
        out = dict(self.phases)
        out["total"] = self.total()
        return out
