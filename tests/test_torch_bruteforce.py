"""The port's brute-force oracle matches kdtree_tpu's: d2 equal, ids equal,
lowest index first on planted ties, at every D. At D=40 (above the 32 axes
where XLA:CPU stops fusing the sum of squares axis by axis) both sum the
rounded squares in windows of 32 (``_arith.sq_sum_windows``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.ops import bruteforce as jbf
from kdtree_tpu_torch.ops import _arith
from kdtree_tpu_torch.ops import bruteforce as tbf

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)


def _problem(d, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-100, 100, (2500, d)).astype(np.float32)
    q = rng.uniform(-100, 100, (40, d)).astype(np.float32)
    p[100:108] = p[7]  # planted duplicates: equal distances to every query
    q[3] = p[7]
    p[2000] = p[1500]
    q[4] = p[1500]
    return p, q


def _compare(jd, ji, td, ti):
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("d", [3, 16, 40])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_knn_matches(d, k):
    p, q = _problem(d)
    jd, ji = jbf.knn(jnp.asarray(p), jnp.asarray(q), k=k, tile=1024)
    td, ti = tbf.knn(torch.from_numpy(p), torch.from_numpy(q), k=k, tile=1024)
    _compare(jd, ji, td, ti)
    # planted ties: the lowest index comes first
    assert ti[3, 0] == 7 and ti[4, 0] == 1500
    if k >= 9:
        np.testing.assert_array_equal(ti[3, 1:9].numpy(), np.arange(100, 108))
    if k >= 2:
        assert ti[4, 1] == 2000  # the tie crosses a point-tile boundary


@pytest.mark.parametrize("d", [3, 16, 40])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_knn_exact_d2_matches(d, k):
    p, q = _problem(d, seed=1)
    jd, ji = jbf.knn_exact_d2(jnp.asarray(p), jnp.asarray(q), k=k)
    td, ti = tbf.knn_exact_d2(torch.from_numpy(p), torch.from_numpy(q), k=k)
    _compare(jd, ji, td, ti)


def test_k_clamped_to_n():
    p, q = _problem(3)
    td, ti = tbf.knn(torch.from_numpy(p[:6]), torch.from_numpy(q), k=10)
    assert td.shape == (40, 6)
    assert (np.sort(ti.numpy(), axis=1) == np.arange(6)).all()


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e5])
@pytest.mark.parametrize("d", [1, 3, 8, 16])
def test_sq_dist_is_the_fused_jit_sum(scale, d):
    """The shared accumulation equals XLA:CPU's jitted sum of squares
    (one fused multiply-add per axis) bit for bit, +inf rows included."""
    import jax

    rng = np.random.default_rng(d)
    q = (rng.uniform(-1, 1, (32, d)) * scale).astype(np.float32)
    p = (rng.uniform(-1, 1, (200, d)) * scale).astype(np.float32)
    p[:2] = np.inf
    want = jax.jit(lambda a, b: jnp.sum((a[:, None] - b[None]) ** 2, -1))(q, p)
    got = _arith.sq_dist(torch.from_numpy(q)[:, None], torch.from_numpy(p)[None])
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
