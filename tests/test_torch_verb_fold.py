"""The verbs' fold kernels' plain versions and the oracle's distance block,
held on the CPU against the JAX package: the same seeded tiles go through
the reference's jitted ``_radius_tiles`` / ``_range_tiles`` and through the
port's, whose fold runs :mod:`kdtree_tpu_torch.kernels.verb_fold`'s plain
version here (the kernels run on the card only; ``chip_smoke.py`` holds them
to these plain versions there). Counts must be equal and the canonical rows
bit-equal: at D = 3 and D = 47 (the window sums), with padding rows, the
buckets' gid -1 slots, boxes with infinite faces, the count form, a
``visit_cap`` cut and m below the largest count. ``block_d2_exact`` (the
``pair_d2`` kernel's plain version here) equals the reference's jitted
``_block_d2_exact`` bit for bit, and the wrappers' checks refuse a wrong
dtype, shape or device, the tree's leaf boxes (which the kernels' cull
reads) included."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.ops import bruteforce as jbf
from kdtree_tpu.ops.generate import generate_points_rowwise as jgen
from kdtree_tpu.ops.morton import build_morton as jbuild
from kdtree_tpu.verbs import device as jdev
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.kernels import pair_d2 as tpair
from kdtree_tpu_torch.kernels import verb_fold as tfold
from kdtree_tpu_torch.ops import bruteforce as tbf
from kdtree_tpu_torch.ops._arith import sq_dist
from kdtree_tpu_torch.verbs import device as tdev

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

TQ = 16
BUCKET = 32


@functools.lru_cache(maxsize=None)
def _trees(dim: int, n: int):
    """(reference tree, port tree, host points): n is no multiple of the
    bucket size and the bucket count pads to a power of two, so the buckets
    hold gid -1 slots with +inf coordinates."""
    raw = jgen(5 + dim, dim, n)
    jt = jbuild(raw, bucket_cap=BUCKET)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    assert (np.asarray(jt.bucket_gid) < 0).any()
    return jt, tt, np.array(raw)


def _radius_inputs(dim: int, n: int, tiles: int):
    """Queries near the data, each r2 the exact squared distance (the port's
    arithmetic) to its 12th nearest point, so a one-ulp difference in d2
    would move a hit across the boundary; the last three rows of the last
    tile are padding (r2 = -1)."""
    _, _, pts = _trees(dim, n)
    rng = np.random.default_rng(dim * 100 + tiles)
    q = pts[rng.integers(0, n, tiles * TQ)] + rng.normal(0, 0.5, (tiles * TQ, dim))
    q = q.astype(np.float32)
    d2 = sq_dist(torch.from_numpy(q)[:, None, :], torch.from_numpy(pts)[None, :, :])
    r2 = torch.sort(d2, dim=1).values[:, 11].numpy().copy()
    r2[-3:] = -1.0
    return q.reshape(tiles, TQ, dim), r2.reshape(tiles, TQ)


def _range_inputs(dim: int, n: int, tiles: int):
    """Boxes around data points, some with faces exactly on a point's
    coordinates, some with infinite faces, one inverted (empty), and padding
    rows (lo = +inf, hi = -inf) at the end."""
    _, _, pts = _trees(dim, n)
    rng = np.random.default_rng(dim * 100 + tiles + 1)
    c = pts[rng.integers(0, n, tiles * TQ)]
    half = np.float32(12.0 if dim == 3 else 60.0)
    lo, hi = (c - half).astype(np.float32), (c + half).astype(np.float32)
    lo[::5] = pts[rng.integers(0, n, lo[::5].shape[0])]  # a face on a point
    lo[1::7, 0], hi[1::7, 0] = -np.inf, np.inf  # a slab, infinite on axis 0
    lo[2], hi[2] = -np.inf, np.inf  # every point, and every padding slot's coordinates
    lo[3, 0], hi[3, 0] = hi[3, 0], lo[3, 0]  # inverted: empty
    lo[-2:], hi[-2:] = np.inf, -np.inf
    return lo.reshape(tiles, TQ, dim), hi.reshape(tiles, TQ, dim)


def _cap(tt) -> int:
    return tdev._cap_ceiling(tt)


# (name, dim, n, tiles, m, visit_cap, count_only, cap)
CASES = [
    ("D=3", 3, 4000, 4, 64, None, False, None),
    ("D=3 count form", 3, 4000, 4, 0, None, True, None),
    ("D=3 visit_cap cut", 3, 4000, 4, 64, 3, False, None),
    ("D=3 m below the largest count", 3, 4000, 4, 4, None, False, None),
    ("D=3 overflowing frontier folded", 3, 4000, 4, 64, None, False, 8),
    ("D=47 window sums", 47, 3000, 2, 64, None, False, None),
    ("D=47 count form", 47, 3000, 2, 0, None, True, None),
]


def _counts_and_rows(counts_j, counts_t, rows_j, rows_t, m):
    """Counts equal; canonical rows bit-equal (every row here: the plain
    fold keeps the reference's m smallest even past m); and where the count
    is <= m the kept row is every hit."""
    cj, ct = np.asarray(counts_j), counts_t.numpy()
    assert cj.dtype == ct.dtype and np.array_equal(cj, ct)
    for a, b in zip(rows_j, rows_t):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if m:
        full = ct.reshape(-1) <= m
        kept = (rows_t[-1].reshape(ct.size, -1) >= 0).sum(axis=1)
        assert np.array_equal(kept[full], ct.reshape(-1)[full])
        if m == 4:
            assert (ct > m).any(), "the small-m case must overflow the buffer"


@pytest.mark.parametrize("name,dim,n,tiles,m,visit_cap,count_only,cap", CASES,
                         ids=[c[0] for c in CASES])
def test_radius_tiles_fold_equals_reference(name, dim, n, tiles, m, visit_cap, count_only, cap):
    jt, tt, _ = _trees(dim, n)
    tq, r2 = _radius_inputs(dim, n, tiles)
    c = cap or _cap(tt)
    jc, jd, ji, jovf, jcut = jdev._radius_tiles(jt, jnp.asarray(tq), jnp.asarray(r2), c, m,
                                                visit_cap, count_only, 4)
    tc, td, ti, tovf, tcut = tdev._radius_tiles(tt, torch.from_numpy(tq), torch.from_numpy(r2),
                                                c, m, visit_cap, count_only, False)
    assert bool(jovf) == tovf and bool(jcut) == tcut
    assert tovf == (cap is not None) and tcut == (visit_cap is not None)
    assert int(tc.sum()) > 0 and (tc.numpy()[-1, -3:] == 0).all()
    if count_only:
        assert td.shape == ti.shape == (tiles, TQ, 0)
        _counts_and_rows(jc, tc, [], [], 0)
        return
    rows_j = tdev.canonical_radius_rows(np.asarray(jd).reshape(tiles * TQ, -1),
                                        np.asarray(ji).reshape(tiles * TQ, -1))
    rows_t = tdev.canonical_radius_rows(td.numpy().reshape(tiles * TQ, -1),
                                        ti.numpy().reshape(tiles * TQ, -1))
    _counts_and_rows(jc, tc, rows_j, rows_t, m)


@pytest.mark.parametrize("name,dim,n,tiles,m,visit_cap,count_only,cap", CASES,
                         ids=[c[0] for c in CASES])
def test_range_tiles_fold_equals_reference(name, dim, n, tiles, m, visit_cap, count_only, cap):
    jt, tt, _ = _trees(dim, n)
    lo, hi = _range_inputs(dim, n, tiles)
    c = cap or _cap(tt)
    jc, ji, jovf, jcut = jdev._range_tiles(jt, jnp.asarray(lo), jnp.asarray(hi), c, m,
                                           visit_cap, count_only, 4)
    tc, ti, tovf, tcut = tdev._range_tiles(tt, torch.from_numpy(lo), torch.from_numpy(hi), c, m,
                                           visit_cap, count_only, False)
    assert bool(jovf) == tovf and bool(jcut) == tcut
    flat = tc.numpy().reshape(-1)
    assert flat[-2:].tolist() == [0, 0] and flat[3] == 0
    if visit_cap is None and cap is None:
        assert flat[2] == tt.n_real  # the infinite box holds every real point, no padding slot
    if count_only:
        assert ti.shape == (tiles, TQ, 0)
        _counts_and_rows(jc, tc, [], [], 0)
        return
    rows_j = [tdev.canonical_range_rows(np.asarray(ji).reshape(tiles * TQ, -1))]
    rows_t = [tdev.canonical_range_rows(ti.numpy().reshape(tiles * TQ, -1))]
    _counts_and_rows(jc, tc, rows_j, rows_t, m)


@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5, 6, 7, 8, 32])
def test_block_d2_exact_equals_reference(dim):
    rng = np.random.default_rng(dim)
    q = rng.uniform(-100, 100, (37, dim)).astype(np.float32)
    p = rng.uniform(-100, 100, (300, dim)).astype(np.float32)
    p[:5] = q[:5]  # zero distances
    want = np.asarray(jax.jit(jbf._block_d2_exact)(jnp.asarray(q), jnp.asarray(p)))
    got = tbf.block_d2_exact(torch.from_numpy(q), torch.from_numpy(p))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(tpair.pair_d2(torch.from_numpy(q), torch.from_numpy(p)).numpy(), want)
    # a column slice (the D-sharded oracle's input) is made contiguous first
    wide = np.concatenate([q, q], axis=1)
    assert np.array_equal(tbf.block_d2_exact(torch.from_numpy(wide)[:, dim:],
                                             torch.from_numpy(p)).numpy(), want)


def _fold_args():
    _, tt, _ = _trees(3, 4000)
    tq, r2 = _radius_inputs(3, 4000, 2)
    cand = torch.arange(4, dtype=torch.int32).repeat(2, 1)
    return tt, torch.from_numpy(tq), torch.from_numpy(r2), cand


def _tree_with(tt, **arrays):
    """``tt`` with some of its arrays replaced."""
    from kdtree_tpu_torch.ops.morton import MortonTree

    fields = {k: getattr(tt, k) for k in ("node_lo", "node_hi", "bucket_pts", "bucket_gid")}
    fields.update(arrays)
    return MortonTree(**fields, n_real=tt.n_real, num_levels=tt.num_levels)


_META = torch.device("meta")
FOLD_BAD = [
    ("tq float64", lambda tt, tq, r2, cand: (tt, tq.double(), r2, cand, 8), "tq must be"),
    ("r2 shape", lambda tt, tq, r2, cand: (tt, tq, r2[:, :-1], cand, 8), "r2 must have shape"),
    ("r2 device", lambda tt, tq, r2, cand: (tt, tq, r2.to(_META), cand, 8), "r2 is on meta"),
    ("cand int64", lambda tt, tq, r2, cand: (tt, tq, r2, cand.long(), 8), "cand must be"),
    ("cand rows", lambda tt, tq, r2, cand: (tt, tq, r2, cand[:1], 8), "cand must have shape"),
    ("cand 1-D", lambda tt, tq, r2, cand: (tt, tq, r2, cand[0], 8), r"cand must be \[T, C\]"),
    ("cand non-contiguous", lambda tt, tq, r2, cand: (tt, tq, r2, cand.t().contiguous().t(), 8),
     "cand must be contiguous"),
    ("negative m", lambda tt, tq, r2, cand: (tt, tq, r2, cand, -1), "m must be >= 0"),
    ("tile too wide", lambda tt, tq, r2, cand: (
        tt, tq.repeat(1, 17, 1), r2.repeat(1, 17), cand, 8), "1..256 queries per tile"),
    ("tq on meta", lambda tt, tq, r2, cand: (tt, tq.to(_META), r2.to(_META), cand.to(_META), 8),
     "bucket_pts is on cpu, expected meta"),
    ("node_lo float64", lambda tt, tq, r2, cand: (
        _tree_with(tt, node_lo=tt.node_lo.double()), tq, r2, cand, 8), "node_lo must be"),
    ("node_hi float64", lambda tt, tq, r2, cand: (
        _tree_with(tt, node_hi=tt.node_hi.double()), tq, r2, cand, 8), "node_hi must be"),
    ("node_lo shape", lambda tt, tq, r2, cand: (
        _tree_with(tt, node_lo=tt.node_lo[1:]), tq, r2, cand, 8), "node_lo must have shape"),
    ("node_hi shape", lambda tt, tq, r2, cand: (
        _tree_with(tt, node_hi=tt.node_hi[:, :2]), tq, r2, cand, 8), "node_hi must have shape"),
    ("node_lo device", lambda tt, tq, r2, cand: (
        _tree_with(tt, node_lo=tt.node_lo.to(_META)), tq, r2, cand, 8), "node_lo is on meta"),
    ("node_hi device", lambda tt, tq, r2, cand: (
        _tree_with(tt, node_hi=tt.node_hi.to(_META)), tq, r2, cand, 8), "node_hi is on meta"),
]


@pytest.mark.parametrize("name,bad,match", FOLD_BAD, ids=[b[0] for b in FOLD_BAD])
def test_radius_fold_checks_refuse(name, bad, match):
    with pytest.raises(ValueError, match=match):
        tfold.radius_fold(*bad(*_fold_args()))


@pytest.mark.parametrize("name,bad,match", [
    ("qhi float64", lambda tt, lo, cand: (tt, lo, lo.double(), cand, 8), "qhi must be"),
    ("qhi shape", lambda tt, lo, cand: (tt, lo, lo[:, :-1], cand, 8), "qhi must have shape"),
    ("qhi device", lambda tt, lo, cand: (tt, lo, lo.to(_META), cand, 8), "qhi is on meta"),
    ("qlo 2-D", lambda tt, lo, cand: (tt, lo[0], lo[0], cand, 8), r"qlo must be \[T, TQ, D\]"),
], ids=["qhi float64", "qhi shape", "qhi device", "qlo 2-D"])
def test_range_fold_checks_refuse(name, bad, match):
    tt, tq, _, cand = _fold_args()
    with pytest.raises(ValueError, match=match):
        tfold.range_fold(*bad(tt, tq, cand))


@pytest.mark.parametrize("name,q,p,match", [
    ("float64", torch.zeros(3, 2, dtype=torch.float64), torch.zeros(4, 2), "queries must be"),
    ("axes differ", torch.zeros(3, 2), torch.zeros(4, 3), "ptile must have shape"),
    ("device", torch.zeros(3, 2), torch.zeros(4, 2, device=_META), "ptile is on meta"),
    ("non-contiguous", torch.zeros(2, 3).t(), torch.zeros(4, 2), "queries must be contiguous"),
    ("1-D", torch.zeros(3), torch.zeros(4, 3), r"\[Q, D\] and \[T, D\]"),
], ids=["float64", "axes differ", "device", "non-contiguous", "1-D"])
def test_pair_d2_checks_refuse(name, q, p, match):
    with pytest.raises(ValueError, match=match):
        tpair.pair_d2(q, p)


def test_fold_wrappers_on_cpu_run_the_plain_versions():
    """The CPU path is the plain version itself, and it launches nothing."""
    tt, tq, r2, cand = _fold_args()
    before = (tfold.radius_fold.launches, tfold.range_fold.launches)
    got = tfold.radius_fold(tt, tq, r2, cand, 8)
    want = tdev._radius_fold_plain(tt, tq, r2, cand, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = tfold.range_fold(tt, tq - 5, tq + 5, cand, 0)
    want = tdev._range_fold_plain(tt, tq - 5, tq + 5, cand, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and got[1].shape[-1] == 0
    assert (tfold.radius_fold.launches, tfold.range_fold.launches) == before
