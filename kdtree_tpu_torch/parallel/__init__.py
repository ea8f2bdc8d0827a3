"""kdtree_tpu_torch.parallel — the multi-device engines on a
single-controller mesh (the port of ``kdtree_tpu/parallel``):

- :mod:`~.global_morton` — the scale engine: a sample-sort partitioned
  forest of per-shard Morton trees;
- :mod:`~.ensemble` — one independent local tree per shard (the reference
  program's MPI strategy);
- :mod:`~.global_exact` — the exact median-split tree with radix-selected
  global top levels;
- :mod:`~.global_tree` — one exact tree built with a distributed bitonic
  sort per level (the structural-identity oracle);
- :mod:`~.dsharded` — feature-axis sharded brute force;
- :mod:`~.mesh` — the mesh and its collectives.
"""

from kdtree_tpu_torch.parallel.dsharded import dsharded_knn
from kdtree_tpu_torch.parallel.ensemble import ensemble_knn, ensemble_knn_gen
from kdtree_tpu_torch.parallel.global_exact import (
    GlobalExactTree,
    build_global_exact,
    global_exact_knn,
    global_exact_query,
)
from kdtree_tpu_torch.parallel.global_morton import (
    GlobalMortonForest,
    build_global_morton,
    build_global_morton_from_points,
    build_global_morton_from_shard_files,
    global_morton_knn,
    global_morton_query,
    global_morton_query_tiled,
)
from kdtree_tpu_torch.parallel.global_tree import (
    GlobalKDTree,
    build_global,
    build_global_gen,
    global_build_knn,
    global_knn,
)
from kdtree_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh

__all__ = [
    "dsharded_knn",
    "ensemble_knn",
    "ensemble_knn_gen",
    "make_mesh",
    "SHARD_AXIS",
    "GlobalKDTree",
    "build_global",
    "build_global_gen",
    "global_build_knn",
    "global_knn",
    "GlobalMortonForest",
    "build_global_morton",
    "build_global_morton_from_points",
    "build_global_morton_from_shard_files",
    "global_morton_knn",
    "global_morton_query",
    "global_morton_query_tiled",
    "GlobalExactTree",
    "build_global_exact",
    "global_exact_knn",
    "global_exact_query",
]
