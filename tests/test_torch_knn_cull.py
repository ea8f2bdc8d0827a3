"""The D = 3 fused k-NN kernel's cull and small-batch plan, in plain torch
(``kernels/knn_scan.py``; the kernel itself runs only on the card,
``chip_smoke.py`` phase 3c).

The cull skips a stage of rows for a warp of queries when each query's
bound to the stage's box (:func:`~kdtree_tpu_torch.kernels.knn_scan.tile_boxes`,
:func:`~kdtree_tpu_torch.kernels.knn_scan.tile_lb_plain`) is strictly above
a threshold the chunks share. It is exact because every row's d2, in the
port's arithmetic, has bits at or above its stage's bound (a property held
here over D = 1-40, tie lattices, +inf rows and all-+inf stages), and
because the chunk lists built that way and merged still equal the whole
answer, which equals the JAX package's ``_knn_scan`` on Morton-ordered rows
with +inf pads and on random rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kdtree_tpu.ops import bruteforce as jbf
from kdtree_tpu_torch.kernels import knn_scan as ks
from kdtree_tpu_torch.kernels.pair_d2 import pair_d2_plain
from kdtree_tpu_torch.ops import tile_query as ttq
from kdtree_tpu_torch.ops.morton import default_bits, morton_codes

torch.set_num_threads(1)

INF = float("inf")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


@st.composite
def _tiles(draw):
    """Rows f32[n, D] in stages of ``stage`` rows, and queries: uniform or
    integer-lattice values, some rows +inf (whole, or on one axis), and
    maybe a stage of +inf rows alone."""
    d = draw(st.integers(1, 40))
    stage = draw(st.sampled_from([1, 3, 8, 32]))
    n = draw(st.integers(1, 3 * stage + 2))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    if draw(st.booleans()):
        rows = rng.integers(-2, 3, (n, d)).astype(np.float32)
        queries = rng.integers(-2, 3, (5, d)).astype(np.float32)
    else:
        rows = rng.uniform(-100, 100, (n, d)).astype(np.float32)
        queries = rng.uniform(-120, 120, (5, d)).astype(np.float32)
    queries[0] = rows[rng.integers(n)]  # a query on a row: d2 = 0
    inf_rows = rng.random(n) < draw(st.sampled_from([0.0, 0.2, 1.0]))
    rows[inf_rows] = INF
    if d > 1 and draw(st.booleans()):
        rows[rng.integers(n), rng.integers(1, d)] = INF  # finite first axis, one +inf
    if draw(st.booleans()):
        rows[:stage] = INF  # the first stage +inf rows alone
    return torch.from_numpy(rows), torch.from_numpy(queries), stage


@settings(max_examples=150, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_tiles())
def test_every_row_is_at_or_above_its_stage_bound(case):
    rows, queries, stage = case
    lo, hi = ks.tile_boxes(rows, stage)
    lb = ks.tile_lb_plain(queries, lo, hi)  # [Q, G]
    d2 = pair_d2_plain(queries, rows)  # [Q, n], the kernel's arithmetic
    g = torch.arange(rows.shape[0]) // stage
    assert (_bits(d2) >= _bits(lb[:, g])).all()
    # a stage of +inf rows alone bounds at +inf: culled below any finite
    # threshold, never at +inf
    alone = torch.isinf(rows[:, 0]).view(-1)
    for t in range(lo.shape[0]):
        if alone[t * stage: (t + 1) * stage].all():
            assert torch.isinf(lb[:, t]).all()


@pytest.mark.parametrize("d", [1, 3, 33])
def test_bound_is_the_reference_gap_arithmetic(d):
    """The bound is 0 inside the box, and outside it is the FMA chain (the
    windows of 32 above 32 axes) of the per-axis gaps: the distance from
    the query to the box's nearest point when that point is a row."""
    rng = np.random.default_rng(d)
    rows = torch.from_numpy(rng.uniform(-10, 10, (50, d)).astype(np.float32))
    lo, hi = ks.tile_boxes(rows, 50)
    inside = ((lo + hi) / 2)
    assert ks.tile_lb_plain(inside, lo, hi).item() == 0.0
    corner = rows.min(0).values.clone()
    rows[0] = corner  # a row at the box's low corner
    lo, hi = ks.tile_boxes(rows, 50)
    q = (corner - 3.5)[None]
    assert torch.equal(ks.tile_lb_plain(q, lo, hi)[:, 0], pair_d2_plain(q, corner[None])[:, 0])


def _morton_padded(n, d, seed, pad_every=256):
    """Rows in the port's Morton order with a +inf row ending every run of
    ``pad_every``, as padded bucket storage holds them."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.uniform(-100, 100, (n, d)).astype(np.float32))
    p = p[torch.sort(morton_codes(p, default_bits(d)), stable=True).indices]
    per = pad_every - 1
    g = -(-n // per)
    x = torch.full((g * per, d), INF)
    x[:n] = p
    return torch.cat([x.view(g, per, d), torch.full((g, 1, d), INF)], 1).view(-1, d)


def _rows(kind, seed):
    if kind == "morton":
        return _morton_padded(2000, 3, seed)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-100, 100, (2000, 3)).astype(np.float32))


@pytest.mark.parametrize("kind", ["morton", "random"])
@pytest.mark.parametrize("k", [1, 16, 100])
@pytest.mark.parametrize("Q,S,stage", [(1, 5, 64), (8, 3, 128), (37, 7, 32), (64, 1, 512)])
def test_culled_chunk_lists_merge_to_the_reference(kind, k, Q, S, stage):
    """The kernel's schedule and cull (shared thresholds, strict skips,
    short lists padded with (+inf, -1)), merged by the plain merge and the
    merge kernel's mirror, equal the whole answer, and that equals the JAX
    package's exact k-NN, ties and +inf pads included."""
    points = _rows(kind, seed=Q * 7 + k)
    rng = np.random.default_rng(Q + S)
    queries = torch.from_numpy(rng.uniform(-100, 100, (Q, 3)).astype(np.float32))
    queries[0] = points[3]  # a query on a row
    whole = ks.knn_scan_plain(points, queries, k)
    jd, ji = jbf.knn(jnp.asarray(points.numpy()), jnp.asarray(queries.numpy()), k=k,
                     method="exact")
    np.testing.assert_array_equal(np.asarray(jd), whole[0].numpy())
    np.testing.assert_array_equal(np.asarray(ji), whole[1].numpy())
    tq = ks.tile_rows(Q, 3)
    pd, pi, culled, examined = ks.knn_scan_culled_partials_plain(points, queries, k, S, tq,
                                                                 stage)
    assert pd.shape == (-(-Q // tq), S, tq, k)
    md, mi = ttq.merge_partials(pd, pi)
    assert torch.equal(md.reshape(-1, k)[:Q], whole[0])
    assert torch.equal(mi.reshape(-1, k)[:Q], whole[1])
    sd, si, _, _ = ttq.merge_select(pd, pi, 1024)
    assert torch.equal(sd, md) and torch.equal(si, mi)
    assert (pi[torch.isinf(pd)] == -1).all()
    if kind == "random" or Q > 8:
        return
    # a few stages of Morton-ordered rows hold every query's neighbours
    assert culled > 0 and culled <= examined


def test_culled_lists_on_masked_rows_pad_as_the_reference():
    """Fewer finite rows than k (all but 5 masked to +inf): the cull never
    drops them, and the +inf slots come out (+inf, -1)."""
    points = _morton_padded(1500, 3, seed=3)
    finite = torch.isfinite(points[:, 0]).nonzero().squeeze(1)
    points[finite[5:]] = INF
    queries = points[finite[:3]] + 0.25
    whole = ks.knn_scan_plain(points, queries, 16)
    pd, pi, _, _ = ks.knn_scan_culled_partials_plain(points, queries, 16, 4, 8, 64)
    md, mi = ttq.merge_partials(pd, pi)
    assert torch.equal(md.reshape(-1, 16)[:3], whole[0])
    assert torch.equal(mi.reshape(-1, 16)[:3], whole[1])
    assert (whole[1][:, 5:] == -1).all() and torch.isinf(whole[0][:, 5:]).all()


@pytest.mark.parametrize("Q,want", [(1, 8), (7, 8), (8, 8), (9, 16), (33, 40), (56, 56),
                                    (57, 32), (64, 32), (1000, 56), (1024, 56), (100000, 56)])
def test_small_batches_take_one_query_warp_per_8_rows(Q, want):
    """At D = 3 a block takes query warps of 8 rows, at most 7, the
    ceil(Q / 8) warps shared out evenly over as few tiles as hold them: an
    8-row batch is one warp's 8 rows, not a 64-row tile, and 64 rows are
    two tiles of 4 warps, not 7 and 1; other D keep the 64-row tile."""
    tq = ks.tile_rows(Q, 3)
    assert tq == want
    warps = -(-Q // ks.WARP_ROWS)
    assert tq % ks.WARP_ROWS == 0 and tq // ks.WARP_ROWS <= ks.WARPS3
    assert -(-Q // tq) == -(-warps // ks.WARPS3)  # as few tiles as hold them
    assert -(-Q // tq) * tq - Q < ks.WARP_ROWS * -(-Q // tq)  # under a warp a tile idle
    assert ks.tile_rows(Q, 8) == ks.tile_rows(Q, 1) == ks.TILE


@pytest.mark.parametrize("Q,n,k,slots", [(8, 1 << 24, 16, 660), (1, 1 << 24, 1, 660),
                                         (64, 1 << 24, 16, 264), (1000, 1 << 24, 16, 264),
                                         (8, 3000, 100, 660), (1024, 4096, 16, 264)])
def test_small_batch_plan_fills_one_wave_with_chunks(Q, n, k, slots):
    """The plan at the layout's tile: ceil(Q / tile_rows) tiles x S chunks
    within one wave, S as large as that allows, chunks of at least
    max(k, MIN_CHUNK) points; a small batch is one tile, so its chunks
    alone fill the wave."""
    tq = ks.tile_rows(Q, 3)
    S = ks.plan_splits(Q, n, k, slots, tq)
    tiles = -(-Q // tq)
    assert 1 <= S <= ks.MAX_SPLITS
    assert tiles * S <= slots or S == 1
    assert n // S >= max(k, ks.MIN_CHUNK) or S == 1
    assert S == 1 or tiles * (S + 1) > slots or n // (S + 1) < max(k, ks.MIN_CHUNK)
    if Q <= 8 and n >= slots * ks.MIN_CHUNK:
        assert tiles == 1 and S == slots
