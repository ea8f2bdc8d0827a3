"""The port's bucketed k-d tree against ``kdtree_tpu``'s, on the same
seeded inputs in one process, with exact tolerance: ``bucket_spec`` and
all five tree arrays bit-identical for both build strategies, and
``bucket_knn``'s d2 bit-equal and ids equal, across dimensions, bucket
caps, k (also k > n), batch sizes on both sides of XLA:CPU's vectorized
lanes, and chunking.

Each distinct (tree shape, batch shape, k) is one JAX compile of the
reference's two-phase DFS; the cases share shapes where they can."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdtree_tpu as kt
from kdtree_tpu.ops import bucket as jbk
from kdtree_tpu_torch.ops import bruteforce as tbf
from kdtree_tpu_torch.ops import bucket as tbk
from kdtree_tpu_torch.ops import morton as tm
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

ARRAYS = ("node_coords", "node_gid", "node_bucket", "bucket_pts", "bucket_gid")


def _uniform(n, d, seed):
    return np.random.default_rng(seed).uniform(-100, 100, (n, d)).astype(np.float32)


def _same_tree(jt, tt):
    for name in ARRAYS:
        a, b = np.asarray(getattr(jt, name)), getattr(tt, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.int32),
                                      np.ascontiguousarray(b).view(np.int32), err_msg=name)
    assert (jt.n_real, jt.num_levels) == (tt.n_real, tt.num_levels)


@pytest.mark.parametrize("n, cap", [(1, 8), (7, 8), (9, 8), (1000, 16), (4096, 128),
                                    (5000, 4)])
def test_bucket_spec_equals_reference(n, cap):
    js, ts = jbk.bucket_spec(n, cap), tbk.bucket_spec(n, cap)
    for f in ("n", "bucket_cap", "num_levels", "heap_size", "num_buckets"):
        assert getattr(js, f) == getattr(ts, f), f
    for f in ("consume_level", "med_nodes", "med_pos", "bucket_node", "bucket_start",
              "bucket_len"):
        a, b = getattr(js, f), getattr(ts, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", ["sort", "presort"])
@pytest.mark.parametrize("cap", [4, 128])
@pytest.mark.parametrize("d", [1, 2, 3, 8, 33])
@pytest.mark.parametrize("n", [7, 100, 1000, 4097])
def test_build_bit_identical(n, d, cap, strategy):
    p = _uniform(n, d, 10 * n + d)
    jt = kt.build_bucket(jnp.asarray(p), bucket_cap=cap, strategy=strategy)
    _same_tree(jt, tbk.build_bucket(p, bucket_cap=cap, strategy=strategy, device="cpu"))


def test_build_bit_identical_under_ties():
    rng = np.random.default_rng(3)
    lattice = rng.integers(0, 4, (700, 3)).astype(np.float32)
    zeros = rng.choice(np.array([0.0, -0.0, 2.0], np.float32), (300, 2))
    for p in (lattice, np.repeat(_uniform(40, 3, 1), 9, axis=0), zeros):
        for strategy in ("sort", "presort"):
            jt = kt.build_bucket(jnp.asarray(p), bucket_cap=8, strategy=strategy)
            _same_tree(jt, tbk.build_bucket(p, bucket_cap=8, strategy=strategy,
                                            device="cpu"))


def test_cap_one_rejected_and_auto_is_sort():
    p = _uniform(64, 3, 2)
    for build in (lambda: kt.build_bucket(jnp.asarray(p), bucket_cap=1),
                  lambda: tbk.build_bucket(p, bucket_cap=1, device="cpu")):
        with pytest.raises(ValueError, match="bucket_cap"):
            build()
    with pytest.raises(ValueError, match="strategy"):
        tbk.build_bucket(p, strategy="radix", device="cpu")
    auto = tbk.build_bucket(p, bucket_cap=8, device="cpu")
    _same_tree(kt.build_bucket(jnp.asarray(p), bucket_cap=8, strategy="sort"), auto)


def _knn_pair(p, q, k, cap, chunk=16384):
    jt = kt.build_bucket(jnp.asarray(p), bucket_cap=cap)
    tt = tbk.build_bucket(p, bucket_cap=cap, device="cpu")
    jd, ji = kt.bucket_knn(jt, jnp.asarray(q), k=k, chunk=chunk)
    st = tm.DfsStats()
    td, ti = tbk.bucket_knn(tt, torch.from_numpy(q), k=k, chunk=chunk, stats=st)
    kk = min(k, p.shape[0])
    assert td.shape == ti.shape == (q.shape[0], kk)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jd).view(np.int32), td.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert st.chunks == -(-q.shape[0] // min(chunk, q.shape[0]))
    return td, ti


@pytest.mark.parametrize("d", [1, 3, 8, 33, 40])
def test_bucket_knn_equals_reference(d):
    p, q = _uniform(2000, d, d), _uniform(40, d, 30 + d)
    for k in (1, 5, 16):
        td, ti = _knn_pair(p, q, k, cap=16)
    _, oi = tbf.knn(torch.from_numpy(p), torch.from_numpy(q), k=16)
    np.testing.assert_array_equal(oi.numpy(), ti.numpy())  # no ties in uniform data
    _knn_pair(_uniform(9, d, 8), q, 16, cap=4)  # k > n


LANE_GRID = [pytest.param(rows, 3, id=str(rows)) for rows in (5, 8, 13, 21, 36)] + \
    [pytest.param(rows, d, id=f"d{d}-{rows}")
     for d in (3, 4, 5, 8) for rows in (32, 36, 37, 44, 63, 64) if (rows, d) != (36, 3)]


@pytest.mark.parametrize("rows,d", LANE_GRID)
def test_bucket_knn_lane_forms(rows, d):
    """Batch sizes on both sides of ``_arith.xla_cpu_vector_rows``'s
    bounds, and at D = 3, 4, 5 and 8 the lane counts where the vector
    lanes depend on D: internal points' distances take the vector or the
    tail form by lane, bucket points' the FMA chain."""
    _knn_pair(_uniform(3000, d, 40), _uniform(rows, d, 41 + rows), 16, cap=8)


def test_bucket_knn_chunked_and_whole_tree_bucket():
    """Chunks of 16 lanes (the tail chunk padded with zero rows, as in the
    reference), a tree that is one bucket, and a tie-heavy lattice."""
    _knn_pair(_uniform(1500, 3, 50), _uniform(37, 3, 51), 8, cap=16, chunk=16)
    _knn_pair(_uniform(50, 3, 52), _uniform(40, 3, 53), 4, cap=128)
    rng = np.random.default_rng(54)
    lat = rng.integers(0, 4, (900, 3)).astype(np.float32)
    _knn_pair(lat, rng.integers(0, 4, (40, 3)).astype(np.float32), 8, cap=8)
