"""The port's per-query DFS (``kdtree_tpu_torch.ops.morton.morton_knn``)
against ``kdtree_tpu.morton_knn`` on the same tree: d2 and ids bit-equal
in every case (ties included), and d2 equal to the port's brute-force
oracle. The box bound is also held alone against the jitted reference,
on data where the other ways of summing the squares round differently.

Each distinct (tree shape, k, chunk) is one JAX compile of the DFS; the
cases share shapes where they can to keep that count small."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.ops import morton as jm
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.ops import _arith
from kdtree_tpu_torch.ops import bruteforce as tbf
from kdtree_tpu_torch.ops import morton as tm

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

B = 64


def _trees(p, bucket=B):
    jt = jm.build_morton(jnp.asarray(p), bucket_cap=bucket)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    return jt, tt


def _check(p, q, k, chunk=4096, bucket=B):
    jt, tt = _trees(p, bucket)
    jd, ji = jm.morton_knn(jt, jnp.asarray(q), k=k, chunk=chunk)
    stats = tm.DfsStats()
    td, ti = tm.morton_knn(tt, torch.from_numpy(q), k=k, chunk=chunk, stats=stats)
    kk = min(k, p.shape[0])
    assert td.shape == (q.shape[0], kk) and td.dtype == torch.float32
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    od, _ = tbf.knn(torch.from_numpy(p), torch.from_numpy(q), k=k)
    np.testing.assert_array_equal(od.numpy(), td.numpy())
    assert stats.chunks == -(-q.shape[0] // min(chunk, q.shape[0]))
    assert stats.steps % tm._ROUND_STEPS == 0 and stats.syncs >= stats.chunks
    return td, ti


def _uniform(d, n=5000, nq=150, seed=0):
    rng = np.random.default_rng(seed + d)
    return (rng.uniform(-100, 100, (n, d)).astype(np.float32),
            rng.uniform(-100, 100, (nq, d)).astype(np.float32))


@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_uniform_ragged_chunks(d, k):
    # Q=150 over chunks of 64: two full chunks and a padded tail
    p, q = _uniform(d)
    _check(p, q, k, chunk=64)


def test_one_chunk():
    p, q = _uniform(3)
    _check(p, q[:40], 4)  # Q <= chunk: one chunk of exactly Q lanes


def test_lattice_ties():
    # ~40 copies of each of 125 integer sites: nearly every distance is
    # tied, so ids depend on the exact traversal and pruning order
    rng = np.random.default_rng(7)
    p = rng.integers(-2, 3, (5000, 3)).astype(np.float32)
    q = np.concatenate([rng.integers(-2, 3, (100, 3)),
                        rng.integers(-4, 5, (50, 3)) + 0.5]).astype(np.float32)
    _check(p, q, 16, chunk=64)


def test_duplicates():
    rng = np.random.default_rng(8)
    base = rng.uniform(-100, 100, (60, 3)).astype(np.float32)
    p = np.concatenate([base[rng.integers(0, 60, 4000)],
                        rng.uniform(-100, 100, (1000, 3)).astype(np.float32)])
    q = np.concatenate([base, rng.uniform(-100, 100, (90, 3))]).astype(np.float32)
    _check(p, q, 16, chunk=64)


def test_single_point_and_k_past_n():
    rng = np.random.default_rng(9)
    q = rng.uniform(-100, 100, (20, 3)).astype(np.float32)
    d, i = _check(rng.uniform(-100, 100, (1, 3)).astype(np.float32), q, 4)
    assert d.shape == (20, 1) and (i.numpy() == 0).all()
    d, i = _check(rng.uniform(-100, 100, (37, 3)).astype(np.float32), q, 64, bucket=8)
    assert d.shape == (20, 37) and torch.isfinite(d).all()
    assert all(sorted(row) == list(range(37)) for row in i.tolist())


def test_no_queries():
    p, _ = _uniform(3, n=500)
    _, tt = _trees(p)
    d, i = tm.morton_knn(tt, torch.zeros((0, 3)), k=4)
    assert d.shape == (0, 4) and i.shape == (0, 4)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_box_bound_matches_the_jitted_reference(d):
    rng = np.random.default_rng(d)
    q = rng.uniform(-100, 100, (4000, d)).astype(np.float32)
    lo = rng.uniform(-100, 100, (4000, 2, d)).astype(np.float32)
    hi = lo + rng.uniform(0, 20, (4000, 2, d)).astype(np.float32)
    lo[:5], hi[:5] = np.inf, -np.inf  # empty boxes (padding leaves)
    bound = jax.jit(jax.vmap(lambda qq, lo_, hi_: jax.vmap(
        lambda a, b: jm._bbox_d2(qq, a, b))(lo_, hi_)))
    want = np.asarray(bound(q, lo, hi))
    got = tm._bbox_d2(torch.from_numpy(q)[:, None, :], torch.from_numpy(lo),
                      torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[:5]).all()
    # the data tells the sums apart: the straight-line form rounds
    # differently on some of these boxes
    gap = np.maximum(np.maximum(lo - q[:, None], q[:, None] - hi), 0)
    other = _arith.sq_sum_unrolled([torch.from_numpy(gap[..., a]) for a in range(d)])
    assert (other.numpy() != want).any()
