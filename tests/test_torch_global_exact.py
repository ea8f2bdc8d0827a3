"""The port's exact-median global tree against ``kdtree_tpu``'s, on the
same seeded inputs in one process, at P in {1, 2, 4, 8} shards (the
reference on its 8-device CPU mesh, the port on logical CPU shards).

Tolerance: exact. The tree's arrays (the replicated top heap, every
shard's local classic tree and global ids) compare as int32 views of their
bits, uniform and clustered; query d2 bit for bit on the per-shard DFS
route, the dense tiled route (a Morton view per shard) and mesh-free, ids
exactly. Also the overflow error, checkpoints across packages, and the
engine counters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu import obs as jobs
from kdtree_tpu.parallel import global_exact as jge
from kdtree_tpu.parallel import mesh as jmesh
from kdtree_tpu.utils import checkpoint as jckpt
from kdtree_tpu_torch import obs as tobs
from kdtree_tpu_torch.parallel import global_exact as tge
from kdtree_tpu_torch.parallel import mesh as tmesh
from kdtree_tpu_torch.parallel.global_morton import stack_shards
from kdtree_tpu_torch.utils import checkpoint as tckpt
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

torch.set_num_threads(1)

CASES = [(1, 1000, 3, "uniform"), (2, 3001, 2, "uniform"), (4, 5000, 3, "clustered"),
         (8, 6000, 8, "uniform"), (4, 2000, 33, "clustered")]


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


def _host(x):
    return (x if isinstance(x, torch.Tensor) else stack_shards(x)).cpu().numpy()


def _same_tree(jt, tt):
    for name in tge.GlobalExactTree.ARRAYS:
        a, b = np.asarray(getattr(jt, name)), _host(getattr(tt, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    assert (jt.num_points, jt.seed) == (tt.num_points, tt.seed)


def _same(j, t):
    np.testing.assert_array_equal(_bits(j[0]), _bits(t[0].numpy()))
    np.testing.assert_array_equal(np.asarray(j[1]), t[1].numpy())


def _queries(q, d, seed):
    return np.random.default_rng(seed).uniform(-100, 100, (q, d)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    return {c: (jge.build_global_exact(3, c[2], c[1], mesh=jmesh.make_mesh(c[0]),
                                       distribution=c[3]),
                tge.build_global_exact(3, c[2], c[1], mesh=tmesh.make_mesh(c[0], device="cpu"),
                                       distribution=c[3]))
            for c in CASES}


IDS = lambda c: "P{}-n{}-d{}-{}".format(*c)  # noqa: E731


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tree_arrays_bit_identical(trees, case):
    _same_tree(*trees[case])


@pytest.mark.parametrize("case, k", [(c, k) for c in CASES for k in (1, 16)]
                         + [(CASES[2], 3), (CASES[3], 4)],
                         ids=lambda x: IDS(x) if isinstance(x, tuple) else str(x))
def test_dfs_route(trees, case, k):
    jt, tt = trees[case]
    q = _queries(24, case[2], k)
    _same(jge.global_exact_query(jt, jnp.asarray(q), k=k, mesh=jmesh.make_mesh(case[0])),
          tge.global_exact_query(tt, q, k=k, mesh=tmesh.make_mesh(case[0], device="cpu")))


@pytest.mark.parametrize("case", [c for c in CASES if c[2] <= 6], ids=IDS)
def test_tiled_route(trees, case):
    jt, tt = trees[case]
    q = _queries(600, case[2], 5)
    _same(jge.global_exact_query(jt, jnp.asarray(q), k=8, mesh=jmesh.make_mesh(case[0])),
          tge.global_exact_query(tt, q, k=8, mesh=tmesh.make_mesh(case[0], device="cpu")))


@pytest.mark.parametrize("q", (10, 600))
def test_meshfree_routes(trees, q):
    """A one-shard mesh for a 4-shard tree: the DFS over every shard in
    turn, or the forest view's mesh-free tiled query."""
    jt, tt = trees[(4, 5000, 3, "clustered")]
    qs = _queries(q, 3, 6)
    _same(jge.global_exact_query(jt, jnp.asarray(qs), k=4, mesh=jmesh.make_mesh(1)),
          tge.global_exact_query(tt, qs, k=4, mesh=tmesh.make_mesh(1, device="cpu")))


def test_overflow_raises_the_reference_error():
    with pytest.raises(RuntimeError) as je:
        jge.build_global_exact(3, 3, 4000, mesh=jmesh.make_mesh(4), slack=0.05)
    with pytest.raises(RuntimeError) as te:
        tge.build_global_exact(3, 3, 4000, mesh=tmesh.make_mesh(4, device="cpu"), slack=0.05)
    assert str(te.value) == str(je.value)


def test_non_power_of_two_mesh_refused():
    with pytest.raises(ValueError, match="power-of-2 device count, got 3"):
        tge.build_global_exact(3, 3, 100, mesh=tmesh.make_mesh(3, device="cpu"))


@pytest.mark.parametrize("writer", ("reference", "port"))
@pytest.mark.parametrize("sharded", (False, True))
def test_checkpoint_across_packages(trees, tmp_path, writer, sharded):
    jt, tt = trees[(4, 5000, 3, "clustered")]
    path = str(tmp_path / "exact.npz")
    if writer == "reference":
        jckpt.save_tree(path, jt, sharded=sharded)
    else:
        tckpt.save_tree(path, tt, sharded=sharded)
    jl, _ = jckpt.load_tree(path)
    tl, _ = tckpt.load_tree(path, device="cpu")
    _same_tree(jl, tl)
    _same_tree(jt, tl)
    # the loaded tree answers as the built one (whose answers equal the
    # reference's, test_dfs_route)
    q = _queries(10, 3, 8)
    a, b = tge.global_exact_query(tl, q, k=4), tge.global_exact_query(tt, q, k=4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_counters_equal_reference():
    def counters(reg):
        return {k: v for k, v in reg.snapshot()["counters"].items()
                if 'engine="global-exact"' in k or k.startswith("kdtree_shard_queries")}

    jreg, treg = jobs.get_registry(), tobs.get_registry()
    j0, t0 = counters(jreg), counters(treg)
    q = _queries(10, 2, 9)
    jt = jge.build_global_exact(4, 2, 1500, mesh=jmesh.make_mesh(2))
    jge.global_exact_query(jt, jnp.asarray(q), k=2, mesh=jmesh.make_mesh(2))
    tt = tge.build_global_exact(4, 2, 1500, mesh=tmesh.make_mesh(2, device="cpu"))
    tge.global_exact_query(tt, q, k=2, mesh=tmesh.make_mesh(2, device="cpu"))
    jd = {k: v - j0.get(k, 0) for k, v in counters(jreg).items() if v != j0.get(k, 0)}
    td = {k: v - t0.get(k, 0) for k, v in counters(treg).items() if v != t0.get(k, 0)}
    assert td == jd and td['kdtree_builds_total{engine="global-exact"}'] == 1


def test_global_exact_knn_convenience():
    q = _queries(12, 3, 10)
    _same(jge.global_exact_knn(2, 3, 2500, jnp.asarray(q), k=3, mesh=jmesh.make_mesh(4)),
          tge.global_exact_knn(2, 3, 2500, q, k=3, mesh=tmesh.make_mesh(4, device="cpu")))
