"""Morton/Hilbert codes and the bucket-tree arrays of the port are
bit-identical to kdtree_tpu's build on the same points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.ops import hilbert as jhil
from kdtree_tpu.ops import morton as jmor
from kdtree_tpu_torch.interop import tree_from_arrays, tree_to_arrays
from kdtree_tpu_torch.ops import hilbert as thil
from kdtree_tpu_torch.ops import morton as tmor

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

_FIELDS = ("node_lo", "node_hi", "bucket_pts", "bucket_gid")


def _cloud(kind, n, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(-100, 100, (n, d)).astype(np.float32)
    if kind == "duplicates":
        base = rng.uniform(-100, 100, (n // 20 + 1, d)).astype(np.float32)
        return base[rng.integers(0, len(base), n)]
    centers = rng.uniform(-80, 80, (4, d))
    return (centers[rng.integers(0, 4, n)]
            + rng.normal(0, 0.5, (n, d))).astype(np.float32)


@pytest.mark.parametrize("d", [2, 3, 8])
@pytest.mark.parametrize("bits", [1, 4, None])
def test_codes_equal(d, bits):
    pts = _cloud("uniform", 999, d, 1)
    pts[5] = np.inf  # non-finite rows go to the top cell
    bits = jmor.default_bits(d) if bits is None else bits
    jm = np.asarray(jmor.morton_codes(jnp.asarray(pts), bits)).astype(np.int64)
    tm = tmor.morton_codes(torch.from_numpy(pts), bits).numpy()
    np.testing.assert_array_equal(jm, tm)
    jh = np.asarray(jhil.hilbert_codes(jnp.asarray(pts), bits)).astype(np.int64)
    th = thil.hilbert_codes(torch.from_numpy(pts), bits).numpy()
    np.testing.assert_array_equal(jh, th)


@pytest.mark.parametrize("kind", ["uniform", "duplicates", "clustered"])
@pytest.mark.parametrize("bucket", [8, 256])
@pytest.mark.parametrize("d", [2, 3, 8])
def test_tree_arrays_bit_identical(kind, bucket, d):
    pts = _cloud(kind, 1000 + 13, d, 7)  # n is not a multiple of B
    jt = jmor.build_morton(jnp.asarray(pts), bucket_cap=bucket)
    tt = tmor.build_morton(torch.from_numpy(pts), bucket_cap=bucket)
    for f in _FIELDS:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert (tt.n_real, tt.num_levels) == (jt.n_real, jt.num_levels)


def test_tree_from_arrays_round_trip():
    pts = _cloud("uniform", 700, 3, 2)
    jt = jmor.build_morton(jnp.asarray(pts), bucket_cap=64)
    carried = tree_from_arrays(
        np.asarray(jt.node_lo), np.asarray(jt.node_hi),
        np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid), jt.n_real,
        jt.num_levels, device="cpu")
    arrays = tree_to_arrays(carried)
    again = tree_from_arrays(**arrays, device="cpu")
    for f in _FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jt, f)))
        assert torch.equal(getattr(again, f), getattr(carried, f))
    assert (again.n_real, again.num_levels) == (jt.n_real, jt.num_levels)
    assert again.dim == 3 and again.bucket_size == 64


def test_build_capacity_checks_only_cuda():
    tmor.check_build_capacity(1 << 40, 3, "cpu")  # the CPU pages; no check
    assert tmor._tree_shape(1000, 256) == jmor._tree_shape(1000, 256)
    assert [tmor.default_bits(d) for d in range(1, 40)] == \
        [jmor.default_bits(d) for d in range(1, 40)]
