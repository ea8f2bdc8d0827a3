"""The frontier descent: the JAX package's jitted ``_frontier`` against the
port's ``kernels.frontier.frontier`` on CPU tensors (where it runs its
plain version, ``ops/tile_query.py::_frontier``), bucket ids, lower bounds
and overflow flags bit for bit; and the kernel's step-for-step mirror
``frontier_mirror`` against ``_frontier`` on both of its selection paths
(a sort of the level's keys, and the radix passes past ``smem_keys``).

Each tree comes with Hilbert-sorted query tiles and the tile boxes the
verbs give the descent: a range union box infinite on one axis, one
infinite on every axis (against an empty node's [+inf, -inf] box every gap
is inf - inf = NaN, which must leave the node out), an all-padding tile
(lo = +inf, hi = -inf) and a point box. Each is descended at bound +inf
(the seed pass), a finite bound (the collect pass and radius; small caps
overflow at a later level) and bound 0 (range)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.ops import morton as jmor
from kdtree_tpu.ops import tile_query as jtq
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.kernels import frontier as fk
from kdtree_tpu_torch.ops import tile_query as ttq

torch.set_num_threads(1)

_jfrontier = jax.jit(jtq._frontier, static_argnums=(4,))

# name: (D, points, bucket, finite bound). Every point count leaves empty
# buckets (nodes with [+inf, -inf] boxes); "grid" is an integer lattice, two
# copies of each site, whose lower bounds tie at every level.
TREES = {
    "d1": (1, 3000, 16, 40.0),
    "d2": (2, 3001, 16, 300.0),
    "d8": (8, 2000, 16, 6000.0),
    "d47": (47, 200, 16, 90000.0),
    "grid": (3, 2 * 4096 - 700, 8, 4.0),
}
# (tree, cap): caps 1, 3 and 6 (m = 2^s below cap), middle caps, and caps at
# or above 2^L, where the descent starts at the leaves and has no level loop
CASES = [("d1", 1), ("d1", 3), ("d1", 6), ("d1", 256), ("d2", 3), ("d2", 300),
         ("d8", 1), ("d8", 6), ("d47", 8), ("d47", 16), ("grid", 1), ("grid", 3),
         ("grid", 6), ("grid", 64), ("grid", 1024)]


@functools.lru_cache(maxsize=None)
def _setup(name):
    """One tree in both packages, its tiles' boxes and the three bounds."""
    d, n, bucket, finite = TREES[name]
    rng = np.random.default_rng(len(name) * 100 + d)
    if name == "grid":
        g = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1).reshape(-1, 3)
        pts = np.repeat(g, 2, axis=0)[:n].astype(np.float32)
        qs = rng.integers(0, 16, (32, d)).astype(np.float32)
    else:
        pts = rng.uniform(-100, 100, (n, d)).astype(np.float32)
        qs = rng.uniform(-100, 100, (32, d)).astype(np.float32)
    jt = jmor.build_morton(jnp.asarray(pts), bucket_cap=bucket)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    sq, _ = ttq._sort_queries(torch.from_numpy(qs), jmor.default_bits(d), 0)
    tiles = sq.reshape(8, 4, d).numpy()
    lo, hi = tiles.min(1), tiles.max(1)
    one_axis_lo, one_axis_hi = lo[:1].copy(), hi[:1].copy()
    one_axis_lo[0, 0], one_axis_hi[0, 0] = -np.inf, np.inf
    inf = np.full((1, d), np.inf, np.float32)
    lo = np.concatenate([lo, one_axis_lo, -inf, inf, pts[:1]]).astype(np.float32)
    hi = np.concatenate([hi, one_axis_hi, inf, -inf, pts[:1]]).astype(np.float32)
    T = lo.shape[0]
    bounds = {"seed": np.full(T, np.inf, np.float32),
              "finite": np.full(T, finite, np.float32),
              "range": np.zeros(T, np.float32)}
    return jt, tt, lo, hi, bounds


def _torch_args(name, kind):
    _, tt, lo, hi, bounds = _setup(name)
    return (tt, torch.from_numpy(lo), torch.from_numpy(hi),
            torch.from_numpy(bounds[kind]))


@pytest.mark.parametrize("name,cap", CASES)
def test_frontier_equals_the_jax_frontier(name, cap):
    jt, tt, lo, hi, bounds = _setup(name)
    empty = [b for b in range(tt.num_buckets)
             if np.isinf(tt.node_lo[tt.num_buckets - 1 + b, 0].item())]
    assert empty, "the tree should hold empty buckets"
    for kind in ("seed", "finite", "range"):
        jc, jl, jo = _jfrontier(jt, jnp.asarray(lo), jnp.asarray(hi),
                                jnp.asarray(bounds[kind]), cap)
        pc, pl, po = fk.frontier(*_torch_args(name, kind), cap)
        np.testing.assert_array_equal(np.asarray(jc), pc.numpy())
        np.testing.assert_array_equal(np.asarray(jl), pl.numpy())
        np.testing.assert_array_equal(np.asarray(jo), po.numpy())
        # the all-padding tile keeps nothing; the whole-space tile keeps no
        # empty bucket (its gaps are NaN on every axis)
        assert (pc[10] == -1).all() and not np.isin(pc[9].numpy(), empty).any()
        if kind == "finite" and cap in (3, 6):
            assert po.any(), "a small cap should overflow at a later level"
        if kind == "range" and cap >= 1 << tt.num_levels:
            assert not po.any() and (pl[pl < np.inf] == 0).all()


@pytest.mark.parametrize("name,cap", CASES)
def test_mirror_equals_the_plain_frontier(name, cap):
    """The mirror on its shared-memory path (the default ``smem_keys``) and
    forced onto its radix path (``smem_keys`` 2: every level with more than
    two candidates), against ``_frontier``."""
    seen = {"shared": 0, "radix": 0, "passes": 0, "passes_skipped": 0}
    for kind in ("seed", "finite", "range"):
        args = _torch_args(name, kind)
        want = ttq._frontier(*args, cap)
        for sk in (None, 2):
            *got, stats = fk.frontier_mirror(*args, cap, smem_keys=sk)
            for w, g in zip(want, got):
                assert torch.equal(w, g), (kind, sk)
            for key in seen:
                seen[key] += stats[key]
    assert seen["shared"] > 0
    if cap > 1:  # with one slot no level holds more than two candidates
        assert seen["radix"] > 0 and seen["passes"] > 0 and seen["passes_skipped"] > 0


def test_frontier_checks_its_arguments():
    tt, lo, hi, bound = _torch_args("d1", "seed")
    with pytest.raises(ValueError, match="cap"):
        fk.frontier(tt, lo, hi, bound, 0)
    with pytest.raises(ValueError, match="bound"):
        fk.frontier(tt, lo, hi, bound[:-1], 4)
    with pytest.raises(ValueError, match="float32"):
        fk.frontier(tt, lo.double(), hi, bound, 4)
    with pytest.raises(ValueError, match="smem_keys"):
        fk.frontier(tt, lo, hi, bound, 4, smem_keys=6)
    assert fk.frontier.launches == 0  # the CPU path launches nothing
