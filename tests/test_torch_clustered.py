"""The port's Gaussian-mixture generators against ``kdtree_tpu``'s, bit for
bit: ``generate_clustered`` and the counter-based row stream
``generate_points_shard_clustered`` (shard windows composing across
device counts), their ``randint`` and ``normal`` draws, and XLA's float32
``erf_inv`` over ``normal``'s input grid plus the edge inputs.
Tolerance: exact (int32 views of the float32 bits compared)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from kdtree_tpu.ops import generate as jg
from kdtree_tpu_torch.ops import generate as tg

torch.set_num_threads(1)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


@pytest.mark.parametrize("seed, dim, n, q", [(3, 3, 4000, 17), (7, 8, 1501, 10),
                                             (11, 2, 100, 1), (5, 33, 300, 12)])
def test_generate_clustered_bit_identical(seed, dim, n, q):
    jp, jq = jax.jit(jg.generate_clustered, static_argnums=(1, 2, 3))(seed, dim, n, q)
    tp, tq = tg.generate_clustered(seed, dim, n, q, device="cpu")
    assert tp.dtype == torch.float32 and tp.shape == (n, dim) and tq.shape == (q, dim)
    np.testing.assert_array_equal(_bits(jp), _bits(tp.numpy()))
    np.testing.assert_array_equal(_bits(jq), _bits(tq.numpy()))


@pytest.mark.parametrize("seed, dim", [(3, 3), (9, 2), (42, 8), (5, 33)])
@pytest.mark.parametrize("start, rows", [(0, 2000), (777, 513)])
def test_shard_clustered_bit_identical(seed, dim, start, rows):
    j = jax.jit(jg.generate_points_shard_clustered, static_argnums=(1, 3))(
        seed, dim, start, rows)
    t = tg.generate_points_shard_clustered(seed, dim, start, rows, device="cpu")
    np.testing.assert_array_equal(_bits(j), _bits(t.numpy()))


@pytest.mark.parametrize("windows", [[(0, 100), (100, 1), (101, 299)],
                                     [(0, 250), (250, 150)]])
def test_clustered_windows_compose(windows):
    whole = tg.generate_points_shard_clustered(13, 3, 0, 400, device="cpu")
    parts = torch.cat([tg.generate_points_shard_clustered(13, 3, s, r, device="cpu")
                       for s, r in windows])
    np.testing.assert_array_equal(_bits(whole.numpy()), _bits(parts.numpy()))


@pytest.mark.parametrize("span", [2, 7, 8, 1000])
def test_randint_bit_identical(span):
    key = jax.random.key(21)
    j = jax.jit(lambda k: jax.random.randint(k, (3000,), 0, span))(key)
    t = tg._randint(*tg._key(21, "cpu"), torch.arange(3000), span)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_normal_bit_identical():
    key = jax.random.key(8)
    j = jax.jit(lambda k: jax.random.normal(k, (4096, 3)))(key)
    e = tg._erf_inv_draw(*tg._key(8, "cpu"), torch.arange(4096 * 3)).reshape(4096, 3)
    np.testing.assert_array_equal(_bits(j), _bits((e * tg._SQRT2).numpy()))


def test_erf_inv_over_normal_inputs():
    """``normal``'s uniform draw takes 2^23 values (a 23-bit mantissa grid
    on [nextafter(-1, 0), 1)). The port's erf_inv equals XLA's jitted one
    on every 16th of them and on every one in the polynomial's tail branch
    (|u| > 0.996) and around the log1p branch edge (|u| near 0.6436);
    ``torch.erfinv`` does not (checked alongside)."""
    k = np.arange(1 << 23, dtype=np.uint32)
    f = (k | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.float32(tg._NORMAL_LO)
    u = np.maximum(lo, f * np.float32(2.0) + lo)
    a = np.abs(u)
    pick = (k % 16 == 0) | (a > 0.996) | ((a > 0.6430) & (a < 0.6442))
    u = u[pick]
    j = np.asarray(jax.jit(lax.erf_inv)(jnp.asarray(u)))
    t = tg._erf_inv(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(_bits(j), _bits(t))
    assert (_bits(torch.erfinv(torch.from_numpy(u)).numpy()) != _bits(j)).any()


def test_erf_inv_edge_inputs():
    """Signed zeros, +-1 (+-inf out), the branch boundary near w = 5, the
    smallest normal and subnormal magnitudes, and the ends of the
    rational log1p branch."""
    edge = np.array([0.0, -0.0, 1.0, -1.0, 0.99999994, -0.99999994, 0.5, -0.5,
                     0.9966, -0.9966, 0.99662, 0.9967, 1.1754944e-38, -1.1754944e-38,
                     1e-45, -1e-45, 0.6435942, -0.6435942, 0.64359427, 0.64359415,
                     1e-8, 0.25], np.float32)
    j = np.asarray(jax.jit(lax.erf_inv)(jnp.asarray(edge)))
    t = tg._erf_inv(torch.from_numpy(edge)).numpy()
    np.testing.assert_array_equal(_bits(j), _bits(t))
    assert np.isposinf(t[2]) and np.isneginf(t[3])
