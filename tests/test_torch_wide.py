"""Squared distances above 32 axes: the port against kdtree_tpu, exact.

Above 32 axes XLA:CPU stops fusing ``acc + x * x``: it rounds each square
and sums the row in windows of 32 (``_arith.sq_sum_windows``). These
cases hold every engine of the port to the reference's bits there: the
arithmetic alone (D = 1,100 for the second level of windows), the oracle,
the DFS, the tiled engine and the three query verbs, with radii set to the
reference's own k-th distances so that points lie exactly on the sphere."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu import verbs as jverbs
from kdtree_tpu.ops import bruteforce as jbf
from kdtree_tpu.ops import morton as jm
from kdtree_tpu.ops import tile_query as jtq
from kdtree_tpu.verbs import oracle as jvo
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.ops import _arith
from kdtree_tpu_torch.ops import bruteforce as tbf
from kdtree_tpu_torch.ops import morton as tm
from kdtree_tpu_torch.ops import tile_query as ttq
from kdtree_tpu_torch.verbs import device as tv
from kdtree_tpu_torch.verbs import oracle as tvo
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

torch.set_num_threads(1)

WIDE = [33, 40, 64, 128]
N, NQ, B = 1500, 48, 32

_jsum = jax.jit(lambda a, b: jnp.sum((a - b) * (a - b), -1))


@functools.lru_cache(maxsize=None)
def _setup(d):
    """Clustered points (so the k-th distances are short and the radius
    balls hold a few points each), queries near them, both trees."""
    rng = np.random.default_rng(100 + d)
    centers = rng.uniform(-100, 100, (12, d)).astype(np.float32)
    pts = (centers[rng.integers(0, 12, N)]
           + rng.normal(0, 3, (N, d))).astype(np.float32)
    qs = (pts[rng.integers(0, N, NQ)]
          + rng.normal(0, 1, (NQ, d))).astype(np.float32)
    jt = jm.build_morton(jnp.asarray(pts), bucket_cap=B)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    return pts, qs, jt, tt


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy() if torch.is_tensor(t) else t)


@pytest.mark.parametrize("d", WIDE + [1100])
def test_sq_dist_is_the_jitted_window_sum(d):
    rng = np.random.default_rng(d)
    a = rng.uniform(-100, 100, (200, d)).astype(np.float32)
    b = rng.uniform(-100, 100, (200, d)).astype(np.float32)
    b[:2] = np.inf
    want = np.asarray(_jsum(a, b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _eq(want, _arith.sq_dist(ta, tb))
    diff = ta - tb
    _eq(want, _arith.sq_sum_windows(diff * diff))
    # the form matters: the FMA chain of D <= 32 rounds differently here
    acc = torch.zeros(200)
    for i in range(d):
        acc = _arith.sq_add(acc, diff[:, i])
    assert (acc.numpy()[2:] != want[2:]).any()


@pytest.mark.parametrize("d", WIDE)
def test_box_bound_is_below_every_point_of_the_box(d):
    """The kernel's skip arithmetic: the box bound sums like the point
    distance, so it is never above a point inside the box."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.uniform(-100, 100, (300, d)).astype(np.float32))
    lo = torch.from_numpy(rng.uniform(-100, 100, (300, d)).astype(np.float32))
    hi = lo + torch.from_numpy(rng.uniform(0, 30, (300, d)).astype(np.float32))
    inside = lo + (hi - lo) * torch.rand(300, d, generator=torch.Generator().manual_seed(d))
    inside = torch.minimum(torch.maximum(inside, lo), hi)
    bnd = _arith.sq_dist_to_box(q, lo, hi)
    assert (bnd <= _arith.sq_dist(q, inside)).all()
    # and a point that is its own box's corner nearest q is at the bound
    corner = torch.minimum(torch.maximum(q, lo), hi)
    assert torch.equal(bnd, _arith.sq_dist(q, corner))


@pytest.mark.parametrize("d", WIDE)
def test_oracles_match(d):
    pts, qs, _, _ = _setup(d)
    jp, jq = jnp.asarray(pts), jnp.asarray(qs)
    tp, tq = torch.from_numpy(pts), torch.from_numpy(qs)
    _eq(jax.jit(jbf._block_d2_exact)(jq, jp[:300]), tbf.block_d2_exact(tq, tp[:300]))
    for a, b in zip(jbf.knn_exact_d2(jp, jq, k=8), tbf.knn_exact_d2(tp, tq, k=8)):
        _eq(a, b)
    for method in ("exact", "matmul"):
        for a, b in zip(jbf.knn(jp, jq, k=8, method=method, tile=512),
                        tbf.knn(tp, tq, k=8, method=method, tile=512)):
            _eq(a, b)


@pytest.mark.parametrize("d", WIDE)
def test_dfs_matches(d):
    pts, qs, jt, tt = _setup(d)
    jd, ji = jm.morton_knn(jt, jnp.asarray(qs), k=8, chunk=64)
    td, ti = tm.morton_knn(tt, torch.from_numpy(qs), k=8, chunk=64)
    _eq(jd, td)
    _eq(ji, ti)


@pytest.mark.parametrize("d", WIDE)
def test_dfs_box_bound_matches(d):
    rng = np.random.default_rng(d)
    q = rng.uniform(-100, 100, (500, d)).astype(np.float32)
    lo = rng.uniform(-100, 100, (500, 2, d)).astype(np.float32)
    hi = lo + rng.uniform(0, 20, (500, 2, d)).astype(np.float32)
    lo[:5], hi[:5] = np.inf, -np.inf
    bound = jax.jit(jax.vmap(lambda qq, lo_, hi_: jax.vmap(
        lambda a, b: jm._bbox_d2(qq, a, b))(lo_, hi_)))
    _eq(bound(q, lo, hi), tm._bbox_d2(torch.from_numpy(q)[:, None, :],
                                      torch.from_numpy(lo), torch.from_numpy(hi)))


@pytest.mark.parametrize("d", WIDE)
def test_tiled_matches(d):
    pts, qs, jt, tt = _setup(d)
    kw = dict(tile=16, cmax=16, seeds=4, scan_v=2, scan_tb=2)
    jd, ji = jtq.morton_knn_tiled(jt, jnp.asarray(qs), k=8, use_pallas=False, **kw)
    stats = ttq.TileStats()
    td, ti = ttq.morton_knn_tiled(tt, qs, k=8, use_kernel=False, stats=stats, **kw)
    _eq(jd, td)
    _eq(ji, ti)
    od, oi = tbf.knn(torch.from_numpy(pts), torch.from_numpy(qs), k=8)
    assert torch.equal(od, td) and torch.equal(oi, ti)


def _same(a, b):
    a, b = tv.trim_result(a), tv.trim_result(b)
    assert np.array_equal(a.counts, b.counts)
    for x, y in ((a.ids, b.ids), (a.d2, b.d2)):
        assert (x is None) == (y is None)
        if y is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _radius_for(d2):
    """Per row, the float32 r whose r * r is d2, or else the smallest whose
    r * r is above it (not every float32 is a square)."""
    r = np.sqrt(d2).astype(np.float32)
    for _ in range(4):
        r = np.nextafter(r, np.float32(0))
    cands = [r]
    for _ in range(8):
        cands.append(np.nextafter(cands[-1], np.float32(np.inf)))
    c = np.stack(cands)  # ascending
    r2 = (c * c).astype(np.float32)
    exact, above = r2 == d2, r2 > d2
    assert above.any(axis=0).all()
    pick = np.where(exact.any(axis=0), exact.argmax(axis=0), above.argmax(axis=0))
    return c[pick, np.arange(d2.shape[0])]


@pytest.mark.parametrize("d", WIDE)
def test_verbs_match(d):
    pts, qs, jt, tt = _setup(d)
    # radii at the reference's own 4th-neighbour distances: the 4th point
    # of each query lies exactly on its sphere, so one ulp flips a count
    d2k = np.sort(np.asarray(jax.jit(jbf._block_d2_exact)(jnp.asarray(qs), jnp.asarray(pts))),
                  axis=1)[:, 3]
    r = _radius_for(d2k)
    res = tv.radius_search(tt, qs, r)
    _same(res, jverbs.radius_search(jt, qs, r))
    _same(tvo.radius_oracle(pts, qs, r, device="cpu"), jvo.radius_oracle(pts, qs, r))
    _same(res, tvo.radius_oracle(pts, qs, r, device="cpu"))
    assert (res.counts >= 4).all()
    _same(tv.radius_search(tt, qs, r, with_ids=False),
          jverbs.radius_search(jt, qs, r, with_ids=False))
    assert np.array_equal(tvo.radius_count_oracle(pts, qs, r, device="cpu"),
                          jvo.radius_count_oracle(pts, qs, r))
    lo, hi = (qs - 3.0).astype(np.float32), (qs + 3.0).astype(np.float32)
    _same(tv.range_search(tt, lo, hi), jverbs.range_search(jt, lo, hi))
    _same(tv.range_search(tt, lo, hi, with_ids=False),
          jverbs.range_search(jt, lo, hi, with_ids=False))
