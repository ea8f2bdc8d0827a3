"""The port's k-buffer merge (``kdtree_tpu_torch/ops/topk.py``) against
``kdtree_tpu/ops/topk.py`` under ``jax.jit``, bit for bit (d2 and ids):
tied distances, +inf lanes, -1 ids, disabled rows, fewer candidates than
k, and k in {1, 4, 16}. The JAX functions are per query; they run
vmapped over the same rows the port takes as one batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.ops import topk as jtopk
from kdtree_tpu_torch.ops import topk as ttopk

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

_jmerge = jax.jit(jax.vmap(jtopk.merge_topk))
_jscan = jax.jit(jax.vmap(jtopk.scan_bucket_block, in_axes=(0, None, None, 0, 0, 0, 0)))


def _buffers(rng, rows, k, ids_from):
    """Sorted (d, i) k-buffers as a merge leaves them: small-integer
    distances (ties), some rows partly or wholly empty (+inf, -1)."""
    d = rng.integers(0, 6, (rows, k)).astype(np.float32)
    i = rng.choice(ids_from, (rows, k), replace=True).astype(np.int32)
    empty = rng.integers(0, k + 1, rows)
    for r in range(rows):
        d[r, k - empty[r]:] = np.inf
        i[r, k - empty[r]:] = -1
    order = np.lexsort((i, d), axis=1)
    return np.take_along_axis(d, order, 1), np.take_along_axis(i, order, 1)


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j[0]), t[0].numpy())
    np.testing.assert_array_equal(np.asarray(j[1]), t[1].numpy())


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("m", [3, 40])
def test_merge_topk_matches(k, m):
    rng = np.random.default_rng(k * 100 + m)
    rows = 64
    bd, bi = _buffers(rng, rows, k, np.arange(1000, 1100))
    cd = rng.integers(0, 6, (rows, m)).astype(np.float32)  # ties with the buffer too
    cg = rng.integers(0, 1000, (rows, m)).astype(np.int32)
    inf_lane = rng.random((rows, m)) < 0.3
    cd[inf_lane] = np.inf
    cg[inf_lane & (rng.random((rows, m)) < 0.5)] = -1  # -1 ids on +inf lanes
    cd[5] = np.inf  # a row of nothing but +inf candidates
    en = rng.random(rows) < 0.8
    en[:2] = False
    j = _jmerge(jnp.asarray(bd), jnp.asarray(bi), jnp.asarray(cd), jnp.asarray(cg),
                jnp.asarray(en))
    t = ttopk.merge_topk(torch.from_numpy(bd), torch.from_numpy(bi), torch.from_numpy(cd),
                         torch.from_numpy(cg), torch.from_numpy(en))
    _same(j, t)
    # disabled rows keep their buffer
    np.testing.assert_array_equal(t[0][:2].numpy(), bd[:2])
    np.testing.assert_array_equal(t[1][:2].numpy(), bi[:2])


def test_merge_topk_tie_order_is_lowest_index_then_lowest_id():
    # candidates all at d=1: the pre-selection keeps the lowest positions,
    # and the merge orders equal distances by id
    bd = torch.tensor([[1.0, np.inf]])
    bi = torch.tensor([[50, -1]], dtype=torch.int32)
    cd = torch.tensor([[1.0, 1.0, 1.0, 0.5]])
    cg = torch.tensor([[70, 10, 30, 90]], dtype=torch.int32)
    d, i = ttopk.merge_topk(bd, bi, cd, cg, torch.tensor([True]))
    assert d.tolist() == [[0.5, 1.0]] and i.tolist() == [[90, 50]]
    d, i = ttopk.merge_topk(bd[:, :1].clone(), bi[:, :1].clone(), cd[:, :3], cg[:, :3],
                            torch.tensor([True]))
    assert d.tolist() == [[1.0]] and i.tolist() == [[50]]


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("data", ["uniform", "lattice"])
def test_scan_bucket_block_matches(k, data):
    rng = np.random.default_rng(k + (0 if data == "uniform" else 50))
    nb, B, D, V, rows = 12, 16, 3, 8, 48
    if data == "uniform":
        pts = rng.uniform(-100, 100, (nb, B, D)).astype(np.float32)
        q = rng.uniform(-100, 100, (rows, D)).astype(np.float32)
    else:  # integer sites: many exactly tied distances
        pts = rng.integers(-2, 3, (nb, B, D)).astype(np.float32)
        q = rng.integers(-2, 3, (rows, D)).astype(np.float32)
    gid = rng.permutation(nb * B).astype(np.int32).reshape(nb, B)
    pts[-2:, B // 2:] = np.inf  # padding rows of the last buckets
    gid[-2:, B // 2:] = -1
    bcnt = rng.integers(0, V + 1, rows).astype(np.int32)
    blist = np.full((rows, V), -1, np.int32)
    for r in range(rows):
        blist[r, :bcnt[r]] = rng.choice(nb, bcnt[r], replace=False)
    blist[3, 1] = -1  # an empty slot inside the list
    bd, bi = _buffers(rng, rows, k, np.arange(5000, 5100))
    j = _jscan(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(gid), jnp.asarray(blist),
               jnp.asarray(bcnt), jnp.asarray(bd), jnp.asarray(bi))
    t = ttopk.scan_bucket_block(torch.from_numpy(q), torch.from_numpy(pts),
                                torch.from_numpy(gid), torch.from_numpy(blist),
                                torch.from_numpy(bcnt), torch.from_numpy(bd),
                                torch.from_numpy(bi))
    _same(j, t)
    assert (t[1].numpy() >= -1).all() and not np.isnan(t[0].numpy()).any()
