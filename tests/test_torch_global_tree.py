"""The port's global tree and feature-sharded brute force against
``kdtree_tpu``'s, on the same seeded inputs in one process, at P in
{1, 2, 4, 8} shards (the reference on its 8-device CPU mesh, the port on
logical CPU shards).

Tolerance: exact, for both. The global tree's node heap compares as int32
views of its bits (and equals the single-device ``build_jit``'s nodes,
the module's own contract); ``global_knn`` d2 bit for bit and ids
exactly. ``dsharded_knn`` sums the shards' partial d2 blocks in shard
order, which is the order of XLA:CPU's all-reduce on the reference's
8-device CPU mesh: its d2 is bit-equal too (no ulp bound needed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdtree_tpu as kt
from kdtree_tpu.parallel import dsharded as jds
from kdtree_tpu.parallel import global_tree as jgt
from kdtree_tpu.parallel import mesh as jmesh
from kdtree_tpu.utils import checkpoint as jckpt
from kdtree_tpu_torch.ops import build as tb
from kdtree_tpu_torch.parallel import dsharded as tds
from kdtree_tpu_torch.parallel import global_tree as tgt
from kdtree_tpu_torch.parallel import mesh as tmesh
from kdtree_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

CASES = [(1, 1000, 3), (2, 3001, 2), (4, 5000, 3), (8, 2001, 8), (4, 700, 33)]
IDS = lambda c: "P{}-n{}-d{}".format(*c)  # noqa: E731


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


def _same(j, t):
    np.testing.assert_array_equal(_bits(j[0]), _bits(t[0].numpy()))
    np.testing.assert_array_equal(np.asarray(j[1]), t[1].numpy())


def _same_tree(jt, tt):
    for name in tgt.GlobalKDTree.ARRAYS:
        a, b = np.asarray(getattr(jt, name)), getattr(tt, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.int8) if a.dtype == bool else _bits(a),
                                      b.view(np.int8) if b.dtype == bool else _bits(b))
    assert (jt.n_real, jt.num_levels) == (tt.n_real, tt.num_levels)


def _data(n, d, seed):
    return np.random.default_rng(seed).uniform(-100, 100, (n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for p, n, d in CASES:
        pts = _data(n, d, p)
        out[(p, n, d)] = (pts, jgt.build_global(jnp.asarray(pts), mesh=jmesh.make_mesh(p)),
                          tgt.build_global(pts, mesh=tmesh.make_mesh(p, device="cpu")))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_node_heap_bit_identical(trees, case):
    _, jt, tt = trees[case]
    _same_tree(jt, tt)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tree_is_the_single_device_build(trees, case):
    """Node for node the port's own ``build_jit`` over the same rows,
    +inf-padded to a multiple of P (padding ids read as -1)."""
    pts, _, tt = trees[case]
    n, d = pts.shape
    padded = np.concatenate([pts, np.full(((-n) % case[0], d), np.inf, np.float32)])
    single = tb.build_jit(padded, device="cpu")
    npt = single.node_point.long()
    assert torch.equal(tt.node_gid.long(), torch.where(npt >= n, -1, npt))
    held = npt >= 0
    np.testing.assert_array_equal(_bits(tt.node_coords[held].numpy()),
                                  _bits(padded[npt[held].numpy()]))


@pytest.mark.parametrize("p", (1, 2, 4, 8))
def test_generative_build(p):
    _same_tree(jgt.build_global_gen(4, 3, 3001, mesh=jmesh.make_mesh(p)),
               tgt.build_global_gen(4, 3, 3001, mesh=tmesh.make_mesh(p, device="cpu")))


@pytest.mark.parametrize("q, k", [(10, 1), (24, 3), (24, 4), (40, 16)])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_global_knn(trees, case, q, k):
    _, jt, tt = trees[case]
    qs = _data(q, case[2], 100 + k)
    _same(jgt.global_knn(jt, jnp.asarray(qs), k=k), tgt.global_knn(tt, qs, k=k))


@pytest.mark.parametrize("writer", ("reference", "port"))
def test_checkpoint_across_packages(trees, tmp_path, writer):
    _, jt, tt = trees[(4, 5000, 3)]
    path = str(tmp_path / "g.npz")
    (jckpt if writer == "reference" else tckpt).save_tree(path, jt if writer == "reference" else tt)
    jl, _ = jckpt.load_tree(path)
    tl, _ = tckpt.load_tree(path, device="cpu")
    _same_tree(jl, tl)
    qs = _data(10, 3, 7)
    _same(jgt.global_knn(jl, jnp.asarray(qs), k=2), tgt.global_knn(tl, qs, k=2))


def test_build_knn_convenience():
    pts, qs = _data(900, 3, 11), _data(10, 3, 12)
    _same(jgt.global_build_knn(jnp.asarray(pts), jnp.asarray(qs), k=3, mesh=jmesh.make_mesh(2)),
          tgt.global_build_knn(pts, qs, k=3, mesh=tmesh.make_mesh(2, device="cpu")))
    assert kt.build_jit  # the reference's single-device build stays the oracle


DS_CASES = [(1, 2000, 128, 64, 4), (2, 2000, 128, 64, 4), (4, 2000, 128, 64, 16),
            (8, 2000, 128, 64, 3), (4, 3000, 33, 10, 1), (8, 4096, 16, 32, 4),
            (4, 1000, 300, 20, 4), (8, 1500, 3, 40, 1)]


@pytest.mark.parametrize("case", DS_CASES, ids=lambda c: "P{}-n{}-d{}-q{}-k{}".format(*c))
def test_dsharded_knn(case):
    """Column blocks' partial d2, summed over the shards: bit-equal."""
    p, n, d, q, k = case
    pts, qs = _data(n, d, p + d), _data(q, d, p + d + 1)
    _same(jds.dsharded_knn(jnp.asarray(pts), jnp.asarray(qs), k=k, mesh=jmesh.make_mesh(p)),
          tds.dsharded_knn(pts, qs, k=k, mesh=tmesh.make_mesh(p, device="cpu")))
