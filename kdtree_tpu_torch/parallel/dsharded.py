"""Feature-axis (D) sharded brute-force k-NN, the tensor-parallel analog.

The port of ``kdtree_tpu/parallel/dsharded.py``. Squared Euclidean
distance is a sum over coordinates, so it partitions across a mesh: each
shard holds a [N, D/P] column block of the points and the matching query
columns, computes the partial squared distances of its columns tile by
tile, and one psum over the shards completes them. Selection then runs
replicated, as the single-device brute force's streaming top-k: the k
smallest (d2, index) pairs, lowest index first on equal d2.

The psum adds the P partial blocks in shard order, which is the order
XLA:CPU's all-reduce adds them on the reference's test mesh, so d2 is
bit-equal to the reference's there.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kdtree_tpu_torch.ops.bruteforce import _keys, _smallest, _unkey, block_d2_exact

from .mesh import Mesh, make_mesh, psum


def dsharded_knn(
    points, queries, k: int = 1, mesh: Mesh | None = None, tile: int = 1 << 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN with the feature axis sharded over the mesh (default:
    every CUDA device). ``points`` f32[N, D] and ``queries`` f32[Q, D]
    (tensors or arrays) are padded to a multiple of P columns with zeros,
    which add nothing to a distance; ``tile`` point rows per step bound
    the [Q, tile] block. Returns (d2 f32[Q, k], ids i32[Q, k]) ascending
    by (d2, id), on the mesh's first device."""
    mesh = make_mesh() if mesh is None else mesh
    dev0 = mesh.devices[0]
    points = torch.as_tensor(points, dtype=torch.float32, device=dev0)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev0)
    n, d = points.shape
    q = queries.shape[0]
    k = min(k, n)
    tile = min(tile, max(k, ((n + 127) // 128) * 128))
    p = mesh.size
    dpad = (-d) % p
    if dpad:
        points = torch.cat([points, torch.zeros((n, dpad), device=dev0)], dim=1)
        queries = torch.cat([queries, torch.zeros((q, dpad), device=dev0)], dim=1)
    w = (d + dpad) // p
    pcols = [points[:, s * w:(s + 1) * w].to(dv) for s, dv in enumerate(mesh.devices)]
    qcols = [queries[:, s * w:(s + 1) * w].to(dv) for s, dv in enumerate(mesh.devices)]
    best = None
    for base in range(0, n, tile):
        parts = [block_d2_exact(qcols[s], pcols[s][base:base + tile]) for s in range(p)]
        d2 = psum(parts, mesh)[0]
        t = d2.shape[1]
        idx = torch.arange(base, base + t, dtype=torch.int64, device=dev0)
        cand = _smallest(_keys(d2, idx[None, :].expand(q, t)), min(k, t))
        best = _smallest(cand if best is None else torch.cat([best, cand], 1), k)
    return _unkey(best)
