"""The port's ensemble engines against ``kdtree_tpu``'s, on the same
seeded inputs in one process, at P in {1, 2, 4, 8} shards (the reference
on its 8-device CPU mesh, the port on logical CPU shards): the fused
per-shard build-and-DFS path, the generative ``ensemble_knn_gen``, and the
dense route through per-shard Morton trees and the forest's tiled query.

Tolerance: exact. d2 compares as int32 views of its bits and ids exactly.
The batch sizes are ones whose vectorized lanes the port's classic DFS
arithmetic models (``ops/_arith.xla_cpu_vector_rows``): 10, 24 and 40
queries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.parallel import ensemble as je
from kdtree_tpu.parallel import mesh as jmesh
from kdtree_tpu_torch.parallel import ensemble as te
from kdtree_tpu_torch.parallel import mesh as tmesh
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

torch.set_num_threads(1)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


def _same(j, t):
    np.testing.assert_array_equal(_bits(j[0]), _bits(t[0].numpy()))
    np.testing.assert_array_equal(np.asarray(j[1]), t[1].numpy())
    assert t[0].dtype == torch.float32 and t[1].dtype == torch.int32


def _data(n, q, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-100, 100, (n, d)).astype(np.float32),
            rng.uniform(-100, 100, (q, d)).astype(np.float32))


CASES = [(1, 1000, 3), (2, 3001, 2), (4, 5000, 3), (8, 2051, 8), (3, 999, 33)]


@pytest.mark.parametrize("q, k", [(24, 1), (24, 3), (24, 4), (24, 16), (10, 4), (40, 4)])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "P{}-n{}-d{}".format(*c))
def test_fused_route(case, q, k):
    p, n, d = case
    pts, qs = _data(n, q, d, p + q)
    _same(je.ensemble_knn(jnp.asarray(pts), jnp.asarray(qs), k=k, mesh=jmesh.make_mesh(p)),
          te.ensemble_knn(pts, qs, k=k, mesh=tmesh.make_mesh(p, device="cpu")))


@pytest.mark.parametrize("k", (1, 16))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "P{}-n{}-d{}".format(*c))
def test_generative_route(case, k):
    p, n, d = case
    _, qs = _data(1, 24, d, 7)
    _same(je.ensemble_knn_gen(3, d, n, jnp.asarray(qs), k=k, mesh=jmesh.make_mesh(p)),
          te.ensemble_knn_gen(3, d, n, qs, k=k, mesh=tmesh.make_mesh(p, device="cpu")))


@pytest.mark.parametrize("k", (1, 4, 16))
@pytest.mark.parametrize("p", (1, 2, 4, 8))
def test_dense_route(p, k):
    """600 queries over 6000 3-D points: per-shard Morton trees and the
    forest's tiled engine."""
    pts, qs = _data(6000, 600, 3, p)
    _same(je.ensemble_knn(jnp.asarray(pts), jnp.asarray(qs), k=k, mesh=jmesh.make_mesh(p)),
          te.ensemble_knn(pts, qs, k=k, mesh=tmesh.make_mesh(p, device="cpu")))


def test_dense_route_falls_back_when_a_shard_does_not_fit(monkeypatch):
    """A shard's tree over the device budget: the fused path answers, in
    both packages."""
    from kdtree_tpu.ops import morton as jm
    from kdtree_tpu_torch.ops import morton as tm

    def refuse(*a, **kw):
        raise tm.BuildCapacityError("over budget")

    def jrefuse(*a, **kw):
        raise jm.BuildCapacityError("over budget")

    monkeypatch.setattr(tm, "check_build_capacity", refuse)
    monkeypatch.setattr(jm, "check_build_capacity", jrefuse)
    pts, qs = _data(6000, 600, 3, 5)
    _same(je.ensemble_knn(jnp.asarray(pts), jnp.asarray(qs), k=2, mesh=jmesh.make_mesh(2)),
          te.ensemble_knn(pts, qs, k=2, mesh=tmesh.make_mesh(2, device="cpu")))
