"""Ensemble data parallelism: one independent local tree per shard.

The port of ``kdtree_tpu/parallel/ensemble.py`` (the reference program's
MPI strategy): the points are cut into P contiguous shards, each shard
builds its own classic median-split tree with the single-device build,
every shard answers every query, and one all_gather + top-k merges the P
local k-buffers into the exact global answer, with global ids. Remainder
rows are +inf padding, which can never win.

Dense low-D query batches take :func:`_dense_forest_knn` instead: the same
contiguous shards as per-shard Morton trees, served by the forest's tiled
engine (the CUDA scan kernel on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch

from kdtree_tpu_torch.models.tree import tree_spec
from kdtree_tpu_torch.ops.build import build_impl, spec_arrays
from kdtree_tpu_torch.ops.generate import generate_points_shard
from kdtree_tpu_torch.ops.query import _knn_batch
from kdtree_tpu_torch.utils.guards import check_rows_fit_i32

from .global_morton import _merge_partials
from .mesh import Mesh, all_gather, make_mesh


def _local_knn(points_local, queries, k: int, num_levels: int):
    """One shard's tree over its rows and its answer, local row ids."""
    n, d = points_local.shape
    tree = build_impl(points_local, *spec_arrays(n, d, points_local.device),
                      num_levels=num_levels)
    return _knn_batch(tree.node_point, tree.points, queries, k, num_levels)


def _ensemble_fused(points, queries, k: int, mesh: Mesh):
    """The reference's fused program: shard p holds rows [p * n_local,
    (p + 1) * n_local) of the +inf-padded points, builds and answers
    locally, and the P buffers merge by d2 (lowest shard first on equal
    d2, no id sort). Padding rows' ids read as -1."""
    n, d = points.shape
    p = mesh.size
    n_local = -(-n // p)
    pad = p * n_local - n
    if pad:
        points = torch.cat([points, torch.full((pad, d), float("inf"),
                                               dtype=points.dtype, device=points.device)])
    num_levels = tree_spec(n_local).num_levels
    out = queries.device
    all_d, all_i = [], []
    for s, dev in enumerate(mesh.devices):
        d2, idx = _local_knn(points[s * n_local:(s + 1) * n_local].to(dev),
                             queries.to(dev), k, num_levels)
        all_d.append(d2)
        all_i.append(torch.where(idx >= 0, idx + s * n_local, -1))
    q = queries.shape[0]
    cat_d = all_gather(all_d, out).transpose(0, 1).reshape(q, -1)
    cat_i = all_gather(all_i, out).transpose(0, 1).reshape(q, -1)
    kk = min(k, cat_d.shape[1])
    srt, sel = torch.sort(cat_d, dim=1, stable=True)
    gidx = torch.gather(cat_i, 1, sel[:, :kk])
    return srt[:, :kk], torch.where(gidx < n, gidx, -1).to(torch.int32)


def ensemble_knn_gen(
    seed: int, dim: int, num_points: int, queries, k: int = 1,
    mesh: Mesh | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ensemble mode over the seeded row stream: each shard generates only
    its own rows (``generate_points_rowwise`` is the oracle's view of the
    set), rows past ``num_points`` become +inf padding before the build,
    and the merge is the forest's (a stable (d2, id) sort). Returns (d2
    f32[Q, k], ids i32[Q, k]) ascending."""
    mesh = make_mesh() if mesh is None else mesh
    check_rows_fit_i32(num_points, "generative ensemble problem")
    p = mesh.size
    rows = -(-num_points // p)
    num_levels = tree_spec(rows).num_levels
    k = min(k, num_points)
    out = mesh.devices[0]
    queries = torch.as_tensor(queries, dtype=torch.float32, device=out)
    all_d, all_i = [], []
    for s, dev in enumerate(mesh.devices):
        start = s * rows
        pts = generate_points_shard(seed, dim, start, rows, device=dev)
        valid = start + torch.arange(rows, device=dev) < num_points
        pts = torch.where(valid[:, None], pts, float("inf"))
        d2, idx = _local_knn(pts, queries.to(dev), k, num_levels)
        all_d.append(d2)
        all_i.append(torch.where((idx >= 0) & (idx + start < num_points), idx + start, -1))
    return _merge_partials(all_gather(all_d, out), all_gather(all_i, out), k)


def _dense_forest_knn(points, queries, k: int, mesh: Mesh):
    """The dense-batch route: the same contiguous shards as per-shard
    Morton trees (no exchange: the contiguous split already partitions the
    points, and ``bucket_gid`` holds the original row ids), answered by the
    forest's tiled query on ``mesh``. Raises ``BuildCapacityError`` when a
    shard's tree would not fit its device."""
    from kdtree_tpu_torch.ops.morton import check_build_capacity, default_bits

    from .global_morton import _forest, global_morton_query_tiled, local_forest

    n, d = points.shape
    check_rows_fit_i32(n, "ensemble point set")
    p = mesh.size
    n_local = -(-n // p)
    check_build_capacity(n_local, d, mesh.devices[0])
    gid = torch.arange(n, dtype=torch.int32, device=points.device)
    pad = p * n_local - n
    if pad:
        points = torch.cat([points, torch.full((pad, d), float("inf"),
                                               dtype=points.dtype, device=points.device)])
        gid = torch.cat([gid, torch.full((pad,), -1, dtype=torch.int32,
                                         device=points.device)])
    bits = default_bits(d)
    parts, occ = local_forest(points.reshape(p, n_local, d), gid.reshape(p, n_local),
                              mesh.devices, 128, bits)
    forest = _forest(parts, occ, num_points=n, seed=-1, bucket_cap=128, bits=bits)
    return global_morton_query_tiled(forest, queries, k=k, mesh=mesh)


def ensemble_knn(
    points, queries, k: int = 1, mesh: Mesh | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build-and-query in ensemble mode over a mesh (default: every CUDA
    device). ``points`` f32[N, D] and ``queries`` f32[Q, D] are tensors
    or arrays; they go to the mesh's first device. Dense low-D batches
    take :func:`_dense_forest_knn` (unless a shard's tree would not fit);
    the rest the fused per-shard DFS. Returns (d2 f32[Q, k], global ids
    i32[Q, k]) ascending."""
    from kdtree_tpu_torch.ops.morton import BuildCapacityError
    from kdtree_tpu_torch.ops.tile_query import dense_lowd

    mesh = make_mesh() if mesh is None else mesh
    dev = mesh.devices[0]
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    n, d = points.shape
    k = min(k, n)
    if dense_lowd(queries.shape[0], n, d):
        try:
            return _dense_forest_knn(points, queries, k, mesh)
        except BuildCapacityError:
            pass  # a shard's Morton tree would not fit: the fused path
    return _ensemble_fused(points, queries, k, mesh)
