"""Benchmark timing: named phases, each fenced so asynchronous launches
cannot end its clock early.

The port of ``kdtree_tpu/utils/timing.py``'s ``PhaseTimer``, a thin
wrapper over the obs spans. A phase yields a list; the code in it appends
what the phase produced, and the clock stops only after :func:`hard_sync`
has waited for those outputs:
``torch.cuda.synchronize()`` plus a one-element fetch to the host, a
data-dependent barrier. Warm-up is the caller's: time fresh inputs after
a first run.
"""

from __future__ import annotations

import contextlib
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
            if isinstance(o, (torch.Tensor, list, tuple)):
                yield from _tensors(o)


def hard_sync(outputs) -> None:
    """Wait until every CUDA tensor in ``outputs`` (tensors, nested
    lists/tuples, or objects holding tensors or per-shard lists of them)
    is computed, on every device they live on."""
    cuda = [t for t in _tensors(outputs) if t.device.type == "cuda"]
    if not cuda:
        return
    for dev in {t.device for t in cuda}:
        torch.cuda.synchronize(dev)
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
        """A phase is an obs span (:mod:`kdtree_tpu_torch.obs.spans`): it
        lands in the metrics registry, names itself in a profiler trace,
        and syncs what the caller appends before its clock stops."""
        from kdtree_tpu_torch.obs.spans import span

        sp = None
        try:
            with span(name) as sp:
                yield sp
        finally:
            if sp is not None and sp.duration is not None:
                self.phases[name] = self.phases.get(name, 0.0) + sp.duration

    def total(self) -> float:
        return sum(self.phases.values())

    def report(self) -> Dict[str, float]:
        out = dict(self.phases)
        out["total"] = self.total()
        return out
