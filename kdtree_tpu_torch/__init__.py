"""kdtree_tpu_torch — the PyTorch/CUDA port of ``kdtree_tpu``.

The exact k-NN main path over a Morton bucket tree: seeded generation,
the one-sort bucket-tree build, the per-query best-first DFS, the
Hilbert-tiled query engine with its hand-written CUDA scan kernel, the
query verbs (radius, range, count), the recall dial (bounded-visit
approximate k-NN, the recall harness, the degradation ladder), the plan
store with its feedback and ``tune`` sweep, the classic median-split
trees (the level-synchronous build, its presort strategy, the bucketed
tree, and their plane-bound DFS queries), the multi-device engines on a
single-controller mesh (:mod:`kdtree_tpu_torch.parallel`: the global
Morton forest, ensemble, global-exact, global-tree and feature-sharded
k-NN), the serving engine facade and
HTTP front, npz checkpoints, serving snapshots, and the CLI
(``python -m kdtree_tpu_torch``). The JAX
package ``kdtree_tpu`` stays beside this one as the reference it is held
against; this package imports neither jax nor ``kdtree_tpu``.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``): :func:`resolve_device` refuses to fall back silently.
The public surface below loads lazily, so ``import kdtree_tpu_torch``
costs only torch.
"""

from __future__ import annotations

import importlib

import torch

__version__ = "0.1.0"

_LAZY = {
    "MortonTree": "kdtree_tpu_torch.ops.morton",
    "build_morton": "kdtree_tpu_torch.ops.morton",
    "morton_knn": "kdtree_tpu_torch.ops.morton",
    "morton_knn_tiled": "kdtree_tpu_torch.ops.tile_query",
    "generate_problem": "kdtree_tpu_torch.ops.generate",
    "generate_queries": "kdtree_tpu_torch.ops.generate",
    "generate_points_rowwise": "kdtree_tpu_torch.ops.generate",
    "generate_points_shard": "kdtree_tpu_torch.ops.generate",
    "generate_clustered": "kdtree_tpu_torch.ops.generate",
    "generate_points_shard_clustered": "kdtree_tpu_torch.ops.generate",
    "ServeEngine": "kdtree_tpu_torch.serve.engine",
    "tree_from_arrays": "kdtree_tpu_torch.interop",
    "tree_to_arrays": "kdtree_tpu_torch.interop",
    "save_tree": "kdtree_tpu_torch.utils.checkpoint",
    "load_tree": "kdtree_tpu_torch.utils.checkpoint",
    "save_snapshot": "kdtree_tpu_torch.snapshot.store",
    "load_snapshot": "kdtree_tpu_torch.snapshot.store",
    "radius_search": "kdtree_tpu_torch.verbs.device",
    "range_search": "kdtree_tpu_torch.verbs.device",
    "morton_knn_approx": "kdtree_tpu_torch.approx.search",
    "resolve_visit_cap": "kdtree_tpu_torch.approx.search",
    "sweep_recall": "kdtree_tpu_torch.approx.recall",
    "DegradationLadder": "kdtree_tpu_torch.approx.ladder",
    "KDTree": "kdtree_tpu_torch.models.tree",
    "TreeSpec": "kdtree_tpu_torch.models.tree",
    "tree_spec": "kdtree_tpu_torch.models.tree",
    "build": "kdtree_tpu_torch.ops.build",
    "build_jit": "kdtree_tpu_torch.ops.build",
    "validate_invariants": "kdtree_tpu_torch.ops.build",
    "knn": "kdtree_tpu_torch.ops.query",
    "nearest_neighbor": "kdtree_tpu_torch.ops.query",
    "BucketKDTree": "kdtree_tpu_torch.ops.bucket",
    "build_bucket": "kdtree_tpu_torch.ops.bucket",
    "bucket_knn": "kdtree_tpu_torch.ops.bucket",
}
# modules exposed as attributes, imported on first use too
_SUBMODULES = {
    "bruteforce": "kdtree_tpu_torch.ops.bruteforce",
    "approx": "kdtree_tpu_torch.approx",
    "tuning": "kdtree_tpu_torch.tuning",
    "parallel": "kdtree_tpu_torch.parallel",
}

__all__ = ["resolve_device", *_LAZY, *_SUBMODULES]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device exists — a caller that wants the CPU says
    so with ``device="cpu"``; nothing here falls back quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kdtree_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(_SUBMODULES[name])
    if name not in _LAZY:
        raise AttributeError(f"module 'kdtree_tpu_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(_LAZY[name]), name)
