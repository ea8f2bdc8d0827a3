"""The frontier descent: the JAX package's jitted ``_frontier`` against the
port's ``kernels.frontier.frontier`` on CPU tensors (where it runs its
plain version, ``ops/tile_query.py::_frontier``), bucket ids, lower bounds
and overflow flags bit for bit; and the kernel's step-for-step mirror
``frontier_mirror`` against ``_frontier`` and the jitted JAX ``_frontier``
at every cluster size the wrapper can choose, with its keys in shared
memory, in a slice forced down to the level, and in device memory (the
``smem_keys`` argument), its stats showing each path reached; and the plan
that picks the cluster size from the shapes.

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


@functools.lru_cache(maxsize=None)
def _want(name, kind, cap):
    """``_frontier``'s answer, checked once against the jitted JAX one."""
    jt, _, lo, hi, bounds = _setup(name)
    want = ttq._frontier(*_torch_args(name, kind), cap)
    jax_got = _jfrontier(jt, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(bounds[kind]), cap)
    for w, j in zip(want, jax_got):
        np.testing.assert_array_equal(w.numpy(), np.asarray(j))
    return want


def _mirror_stats(name, cap, cluster, smem_keys_for_slice):
    """The mirror at ``cluster`` (None: the plan's) on every bound kind and
    each ``smem_keys`` of ``smem_keys_for_slice(slice)``, against
    ``_frontier``; the summed stats."""
    seen = {}
    for kind in ("seed", "finite", "range"):
        args = _torch_args(name, kind)
        want = _want(name, kind, cap)
        sl = fk.plan(args[1].shape[0], cap, args[0].num_levels, None, cluster).slice
        for sk in smem_keys_for_slice(sl):
            *got, stats = fk.frontier_mirror(*args, cap, smem_keys=sk, cluster=cluster)
            assert cluster in (None, stats["cluster"])
            for w, g, what in zip(want, got, ("bucket ids", "lower bounds", "overflow")):
                assert torch.equal(w, g), (kind, cluster, sk, what)
            for key, v in stats.items():
                seen[key] = seen.get(key, 0) + v
    return seen


@pytest.mark.parametrize("name,cap", CASES)
def test_mirror_equals_the_plain_frontier(name, cap):
    """The mirror on the wrapper's plan and forced into device memory
    (``smem_keys`` 2: every slice past two keys), against ``_frontier`` and
    the jitted JAX ``_frontier``."""
    seen = _mirror_stats(name, cap, None, lambda sl: (None, 2))
    assert seen["shared"] > 0 and seen["ended"] > 0  # the all-padding tile ends at once
    if fk.level_width(cap, _setup(name)[1].num_levels) > 2 * max(fk.CLUSTERS):
        assert seen["device"] > 0  # no cluster holds the widest level in slices of two


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name,cap", CASES)
def test_mirror_at_every_cluster_size(name, cap, cluster):
    """The mirror at each cluster size the wrapper can choose: its keys in
    shared memory at the default capacity, in a capacity forced down to the
    level's slice, and in device memory, equal to ``_frontier`` (and so to
    the JAX one) bit for bit; each path of the algorithm reached."""
    seen = _mirror_stats(name, cap, cluster, lambda sl: (None, max(sl, 2), 2))
    assert seen["cluster"] == 3 * 3 * cluster
    assert seen["shared"] > 0 and seen["ended"] > 0
    assert seen["uniform"] > 0  # range mode: every live lb is 0
    if fk.plan(1, cap, _setup(name)[1].num_levels, None, cluster).slice > 2:
        assert seen["device"] > 0
    if cap >= 6:
        assert seen["sorted"] > 0
    if cluster > 1 and cap >= 6:
        assert seen["rebalanced"] > 0 and seen["gathered"] > 0
        assert seen["empty_slices"] > 0  # the point box lives in one slice
    if cluster > 1 and cap >= 64:
        assert seen["spread"] > 0 and seen["merge_rounds"] > 0


def test_plan_picks_the_cluster_from_the_shapes():
    """The plan at the main path's shapes (a 2^16-bucket tree): the tiled
    batches' 512 tiles keep one block a tile; the served collects at every
    bucket spread one tile over 16 CTAs and 8 or 128 tiles over 8, with
    their keys in shared memory; the verbs' 16 tiles take 4 CTAs on wide
    levels and one on narrow ones; a level past what 16 CTAs hold goes to
    device memory; ``cluster`` and ``smem_keys`` force it."""
    P = fk.plan
    assert P(512, 8, 16) == fk.Plan(1, 16, True, 32)
    assert P(512, 512, 16) == fk.Plan(1, 1024, True, 512)
    for T, cap, c in ((1, 65536, 16), (8, 65536, 8), (128, 32768, 8), (16, 16384, 4),
                      (16, 1024, 1), (128, 4096, 1), (1, 512, 1)):
        p = P(T, cap, 16)
        assert p.cluster == c and p.on_chip, (T, cap, p)
    assert P(1, 65536, 17) == fk.Plan(16, 8192, True, 1024)  # 2^17 children
    assert not P(1, 1 << 17, 18).on_chip
    assert P(1, 65536, 16, cluster=2) == fk.Plan(2, 32768, False, 1024)
    assert P(16, 64, 16, smem_keys=64) == fk.Plan(2, 64, True, 32)  # the smallest that fits
    assert P(16, 64, 16, smem_keys=64, cluster=1) == fk.Plan(1, 128, False, 64)
    for T in (0, 1, 7, 131, 600):
        for cap in (1, 3, 8, 100, 4096, 65536):
            p = P(T, cap, 16)
            assert p.cluster in fk.CLUSTERS and p.slice * p.cluster >= fk.level_width(cap, 16)
            assert 32 <= p.threads <= (1024 if p.cluster > 1 else 512)
            assert p.on_chip == (p.slice <= fk.SMEM_KEYS_MAX)


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
    with pytest.raises(ValueError, match="cluster"):
        fk.frontier(tt, lo, hi, bound, 4, cluster=3)
    with pytest.raises(ValueError, match="cluster"):
        fk.frontier_mirror(tt, lo, hi, bound, 4, cluster=32)
    assert fk.frontier.launches == 0  # the CPU path launches nothing
