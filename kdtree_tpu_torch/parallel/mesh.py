"""The single-controller device mesh and its collectives.

The port of ``kdtree_tpu/parallel/mesh.py``. The reference drives a
``jax.sharding.Mesh`` from one Python process and writes each engine's
per-device body once, under ``shard_map``. Here a :class:`Mesh` is a tuple
of ``torch.device``: one process drives every shard, the per-shard body is
a plain function called once per shard with that shard's tensors on its
mesh device, and the collectives are plain functions over per-shard lists
of tensors, in shard order:

- :func:`all_gather` stacks the shards' values on one device;
- :func:`all_to_all` sends block q of shard p's value to shard q (the
  reference's ``tiled=False`` form);
- :func:`psum` sums the shards' values in shard order;
- :func:`ppermute` moves shard s's value to shard d for each (s, d) pair,
  zeros elsewhere.

A mesh may repeat a device: :func:`make_mesh` on the CPU gives n logical
shards on the one CPU device (the analog of the reference tests' forced
host devices), and a mesh built by hand may put several shards on one
card. Shards on one card run one after another on its stream; nothing
here assumes the devices are distinct.
"""

from __future__ import annotations

from typing import Sequence

import torch

from kdtree_tpu_torch import resolve_device

SHARD_AXIS = "shards"


class Mesh:
    """A 1-D mesh: one ``torch.device`` per shard, in shard order.
    ``mesh.shape[SHARD_AXIS]`` is the shard count, as in the reference."""

    def __init__(self, devices: Sequence, axis: str = SHARD_AXIS):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis = axis

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def available_shards(device) -> int | None:
    """How many shards a mesh made by :func:`make_mesh` can hold on this
    device type: the CUDA device count, or ``None`` (no limit) on the CPU,
    where shards are logical."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return None


def make_mesh(num_devices: int | None = None, axis: str = SHARD_AXIS,
              device=None) -> Mesh:
    """A mesh over the first ``num_devices`` CUDA devices (default: all).
    On the CPU (``device="cpu"``) it holds ``num_devices`` logical shards
    (default 1) on the one CPU device. Raises the reference's
    ``ValueError`` when more CUDA devices are asked for than exist."""
    dev = resolve_device(device)
    have = available_shards(dev)
    if have is None:
        return Mesh([dev] * (1 if num_devices is None else int(num_devices)), axis)
    n = have if num_devices is None else int(num_devices)
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def mesh_for(p: int, device) -> Mesh | None:
    """The mesh an engine takes when the caller passes none: ``p`` shards
    on the device type of ``device`` when that many exist, else ``None``
    (the caller's mesh-free path)."""
    dev = torch.device(device)
    have = available_shards(dev)
    if have is not None and have < p:
        return None
    return make_mesh(p, device=dev.type)


def all_gather(xs: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards' values stacked on ``device``: [P, ...]."""
    return torch.stack([x.to(device) for x in xs])


def all_to_all(xs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """``xs[p]`` is [P, ...] on shard p; shard q receives the stack of
    every shard's block q, in shard order."""
    p = len(xs)
    return [torch.stack([xs[s][q].to(mesh.devices[q]) for s in range(p)])
            for q in range(p)]


def psum(xs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """The sum of the shards' values, added in shard order, on every
    shard's device."""
    total = xs[0].to(mesh.devices[0])
    for x in xs[1:]:
        total = total + x.to(mesh.devices[0])
    return [total.to(d) for d in mesh.devices]


def ppermute(xs: Sequence[torch.Tensor], mesh: Mesh, perm) -> list:
    """Shard d receives shard s's value for each (s, d) in ``perm``;
    a shard that receives nothing gets zeros."""
    out = [torch.zeros_like(x) for x in xs]
    for s, d in perm:
        out[d] = xs[s].to(mesh.devices[d])
    return out
