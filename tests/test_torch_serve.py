"""The port's ServeEngine answers the same micro-batches as kdtree_tpu's
on one JAX-built tree carried across with ``tree_from_arrays``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.ops import morton as jmor
from kdtree_tpu.serve import lifecycle as jlife
from kdtree_tpu.serve.batcher import batch_bucket as j_batch_bucket
from kdtree_tpu_torch import tuning
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.serve import engine as tserve
from kdtree_tpu_torch.tuning.store import make_signature
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _engines(k=8):
    rng = np.random.default_rng(11)
    pts = rng.uniform(-100, 100, (6000, 3)).astype(np.float32)
    jt = jmor.build_morton(jnp.asarray(pts), bucket_cap=64)
    tt = tree_from_arrays(
        np.asarray(jt.node_lo), np.asarray(jt.node_hi),
        np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid), jt.n_real,
        jt.num_levels, device="cpu")
    return jlife.ServeEngine(jt, k), tserve.ServeEngine(tt, k)


def _batch(rows, seed):
    q = np.random.default_rng(seed).uniform(-100, 100, (rows, 3)).astype(np.float32)
    bucket = tserve.batch_bucket(rows, 1024)
    return np.concatenate([q, np.broadcast_to(q[-1], (bucket - rows, 3))])


@pytest.mark.parametrize("rows", [1, 7, 64, 300])
def test_knn_batch_matches(rows):
    je, te = _engines()
    q = _batch(rows, rows)
    t = te.tree
    # the plan store answers a shape an earlier batch settled (1 and 7
    # rows share the 8-row bucket): that batch's plan is warm
    settled = tuning.default_store().get(make_signature(
        q.shape[0], 3, t.n_real, te.k, t.bucket_size, t.num_buckets,
        backend="cpu")) is not None
    jd, ji, _ = je.knn_batch(q)
    td, ti, source = te.knn_batch(q)
    np.testing.assert_array_equal(jd, td)
    np.testing.assert_array_equal(ji, ti)
    assert source == ("warm" if settled else "heuristic")
    assert td.dtype == np.float32 and ti.dtype == np.int32


@pytest.mark.parametrize("k", [1, 8, 20])
def test_fallback_matches(k):
    je, te = _engines()
    q = _batch(50, 99)
    jd, ji = je.fallback_knn(q, k)
    td, ti = te.fallback_knn(q, k)
    np.testing.assert_array_equal(jd, td)
    np.testing.assert_array_equal(ji, ti)


def test_bounds_equal():
    je, te = _engines()
    for a, b in zip(je.bounds(), te.bounds()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_batch,min_bucket", [(1024, 8), (8, 8), (100, 4)])
def test_warmup_ladder_and_buckets(max_batch, min_bucket):
    je, te = _engines()
    state = jlife.ServeState(je, max_batch=1 << (max_batch - 1).bit_length(),
                             min_bucket=min_bucket)
    assert tserve.warmup_buckets(max_batch, min_bucket) == state.warmup_buckets()
    for rows in (1, 5, 8, 9, 100, 1000):
        assert tserve.batch_bucket(rows, 1024, min_bucket) == \
            j_batch_bucket(rows, 1024, min_bucket)


def test_warmup_runs_every_bucket():
    _, te = _engines()
    before = te.stats.batches
    te.warmup(tserve.warmup_buckets(64))
    assert te.stats.batches - before == len(tserve.warmup_buckets(64)) == 4
