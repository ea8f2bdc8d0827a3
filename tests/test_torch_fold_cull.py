"""The fold kernels' cull, ``kernels/verb_fold.py::leaf_pass_plain``, on the
CPU: the kernels skip a (query, bucket) pair whose leaf box fails it, so it
must pass every pair that holds a hit. Held against the JAX package (every
hit of the reference's jitted ``_radius_tiles`` / ``_range_tiles`` lies in
a passing pair, on ``test_torch_verb_fold``'s D = 3 and D = 47 inputs) and
against the plain folds on integer-grid trees at D = 1, 3, 8, 32, 33 and 47,
where bounds equal a point's d2 exactly and box faces lie on points: the
plain fold with its culled pairs removed equals the plain fold bit for bit.
The kernels themselves run on the card only (``chip_smoke.py`` phase 4b
holds them to the plain folds there, on the same kind of inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.verbs import device as jdev
from kdtree_tpu_torch.kernels import verb_fold as tfold
from kdtree_tpu_torch.ops._arith import sq_dist
from kdtree_tpu_torch.ops.morton import build_morton
from test_torch_verb_fold import CASES, TQ, _cap, _radius_inputs, _range_inputs, _trees

torch.set_num_threads(1)

GRID_DIMS = (1, 3, 8, 32, 33, 47)
GRID_N = 32 * 60 - 5  # 60 buckets of 32, padded to 64: four empty leaves
GRID_BUCKET = 32
GRID_T = 4


def _bucket_of(tt):
    """gid -> the bucket that holds it."""
    gid = tt.bucket_gid.numpy()
    out = np.full(tt.n_real, -1, np.int64)
    b, _ = np.nonzero(gid >= 0)
    out[gid[gid >= 0]] = b
    return out


def _all_buckets(tt, T):
    return torch.arange(tt.num_buckets, dtype=torch.int32).repeat(T, 1).contiguous()


REF_CASES = [c for c in CASES if c[0] in ("D=3", "D=47 window sums")]


@pytest.mark.parametrize("verb", ["radius", "range"])
@pytest.mark.parametrize("name,dim,n,tiles,m,visit_cap,count_only,cap", REF_CASES,
                         ids=[c[0] for c in REF_CASES])
def test_reference_hits_lie_in_passing_pairs(verb, name, dim, n, tiles, m, visit_cap, count_only,
                                             cap):
    """Every hit of the reference's jitted tiles (ids form, the buffer wide
    enough for every hit) lies in a (query, bucket) pair the cull passes,
    with padding rows, infinite and inverted boxes and gid -1 slots."""
    jt, tt, _ = _trees(dim, n)
    if verb == "radius":
        qa, qb = _radius_inputs(dim, n, tiles)
        wide = 64
        jc, _, ji, _, _ = jdev._radius_tiles(jt, jnp.asarray(qa), jnp.asarray(qb), _cap(tt), wide,
                                             None, False, 4)
    else:
        qa, qb = _range_inputs(dim, n, tiles)
        wide = 1 << (tt.n_real - 1).bit_length()  # the infinite box holds every point
        jc, ji, _, _ = jdev._range_tiles(jt, jnp.asarray(qa), jnp.asarray(qb), _cap(tt), wide,
                                         None, False, 4)
    counts, ids = np.asarray(jc), np.asarray(ji)
    assert counts.max() <= wide and (ids >= 0).sum() == counts.sum() > 0
    passed = tfold.leaf_pass_plain(tt, verb, torch.from_numpy(qa), torch.from_numpy(qb),
                                   _all_buckets(tt, tiles)).numpy()
    t, q, _ = np.nonzero(ids >= 0)
    assert passed[t, q, _bucket_of(tt)[ids[ids >= 0]]].all()
    assert passed.mean() < 1, "the cull must cut pairs for the check to mean anything"
    # a padding row passes nothing
    pad = (qb < 0) if verb == "radius" else (qa > qb).any(axis=-1)
    assert pad.any() and not passed[pad].any()


def _grid_tree(dim: int):
    """An integer-grid tree: duplicates, -0.0, points on every leaf face,
    gid -1 slots and four empty leaves."""
    rng = np.random.default_rng(40 + dim)
    span = 40 if dim == 1 else (6 if dim <= 3 else 2)
    pts = rng.integers(-span, span, (GRID_N, dim)).astype(np.float32)
    pts[1::3] = pts[rng.integers(0, GRID_N, pts[1::3].shape[0])]
    fifth = pts[::5]
    fifth[fifth == 0] = -0.0
    tree = build_morton(torch.from_numpy(pts), bucket_cap=GRID_BUCKET)
    leaves = tree.node_lo[-tree.num_buckets:, 0] > tree.node_hi[-tree.num_buckets:, 0]
    assert int(leaves.sum()) == 4 and bool((tree.bucket_gid < 0).any())
    return tree, pts


def _grid_inputs(dim: int):
    """Radius rows centred on points, each r2 the exact d2 of its k-th
    nearest point (one r2 = 0, one +inf, one centre with -0.0, the last
    three padding); range boxes with faces on point coordinates (one of
    zero width with -0.0 faces, a slab infinite on axis 0, one inverted on
    the last axis, one with every upper face +inf, the last two padding);
    candidates every bucket, shuffled, with -1 entries."""
    tree, pts = _grid_tree(dim)
    rng = np.random.default_rng(50 + dim)
    rows = GRID_T * TQ
    c = pts[rng.integers(0, GRID_N, rows)].copy()
    c[1][c[1] == 0] = -0.0
    d2 = sq_dist(torch.from_numpy(c)[:, None, :], torch.from_numpy(pts)[None, :, :])
    k = torch.as_tensor(rng.integers(1, 17, rows))
    r2 = torch.sort(d2, dim=1).values.gather(1, k[:, None] - 1)[:, 0].numpy().copy()
    r2[0], r2[2] = 0.0, np.inf
    r2[-3:] = -1.0
    half = rng.integers(0, 3 if dim < 32 else 2, (rows, dim))
    lo, hi = (c - half).astype(np.float32), (c + half).astype(np.float32)
    lo[0], hi[0] = c[1], c[1]
    lo[1, 0], hi[1, 0] = -np.inf, np.inf
    lo[2, -1], hi[2, -1] = hi[2, -1] + 1, lo[2, -1]
    hi[3] = np.inf
    lo[-2:], hi[-2:] = np.inf, -np.inf
    order = rng.permutation(tree.num_buckets).astype(np.int32)
    cand = np.stack([np.insert(rng.permutation(order), rng.integers(0, order.size, 5), -1)
                     for _ in range(GRID_T)]).astype(np.int32)
    shape = (GRID_T, TQ, dim)
    return (tree, torch.from_numpy(c).reshape(shape), torch.from_numpy(r2).reshape(GRID_T, TQ),
            torch.from_numpy(lo).reshape(shape), torch.from_numpy(hi).reshape(shape),
            torch.from_numpy(cand))


def _masked_fold(plain, tree, qa, qb, cand, m, passed):
    """The plain fold with the culled pairs removed: one query a tile, its
    candidates -1 where the cull fails them (positions kept, so the plain
    fold's (d2, position) order is unchanged)."""
    T, Q, D = qa.shape
    cq = torch.where(passed, cand[:, None, :], -1).reshape(T * Q, -1).contiguous()
    qb1 = qb.reshape(T * Q, 1) if qb.dim() == 2 else qb.reshape(T * Q, 1, D)
    out = plain(tree, qa.reshape(T * Q, 1, D), qb1, cq, m)
    return tuple(x.reshape(T, Q, *x.shape[2:]) for x in out)


@pytest.mark.parametrize("verb", ["radius", "range"])
@pytest.mark.parametrize("dim", GRID_DIMS)
def test_cull_keeps_every_hit_on_grid(verb, dim):
    tree, tq, r2, lo, hi, cand = _grid_inputs(dim)
    qa, qb = (tq, r2) if verb == "radius" else (lo, hi)
    plain = tfold._radius_fold_plain if verb == "radius" else tfold._range_fold_plain
    passed = tfold.leaf_pass_plain(tree, verb, qa, qb, cand)
    assert passed.shape == (GRID_T, TQ, cand.shape[1]) and passed.dtype == torch.bool
    counts = plain(tree, qa, qb, cand, 0)[0]
    top = int(counts.max())
    assert top > 1 and 0 < float(passed.float().mean()) < 1
    for m in (1 << (top - 1).bit_length(), 0, top // 2):
        want = plain(tree, qa, qb, cand, m)
        got = _masked_fold(plain, tree, qa, qb, cand, m, passed)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), f"m={m}"
    if verb == "radius":
        # r2 == the k-th nearest point's d2: the hits on the boundary count
        assert (counts.reshape(-1)[3:-3] >= 1).all()


@pytest.mark.parametrize("verb", ["radius", "range"])
def test_padding_rows_empty_leaves_and_padding_candidates_never_pass(verb):
    tree, tq, r2, lo, hi, cand = _grid_inputs(3)
    if verb == "radius":
        qa, qb = tq, torch.full_like(r2, float("inf"))
        qb[:, -2:] = -1.0
    else:
        qa, qb = torch.full_like(lo, -float("inf")), torch.full_like(hi, float("inf"))
        qa[:, -2:], qb[:, -2:] = float("inf"), -float("inf")
    passed = tfold.leaf_pass_plain(tree, verb, qa, qb, cand)
    leaf = torch.arange(tree.num_buckets) + tree.num_buckets - 1
    empty = tree.node_lo[leaf, 0] > tree.node_hi[leaf, 0]
    real = (cand >= 0) & ~empty[cand.long().clamp_min(0)]
    assert (~real).any() and real.any()
    assert not passed[:, -2:].any()  # padding rows
    assert not passed[:, :-2][~real[:, None, :].expand(-1, TQ - 2, -1)].any()
    # a row that holds every point passes every real leaf
    assert passed[:, :-2][real[:, None, :].expand(-1, TQ - 2, -1)].all()
