"""The exact k-NN oracle of the port (``kernels/knn_scan.py``; on the card
the fused kernel ``csrc/knn_scan.cu``) against kdtree_tpu's
``ops/bruteforce.py::knn(method="exact")``: d2 and ids bit for bit, ties to
the lowest index, a slot at +inf with id -1 (the reference's running top-k
starts from (+inf, -1) entries, which win every tie at +inf; the port gave
the masked row's own index before), k clamped to N, at D = 1, 3, 8 (the
FMA chain) and 33, 40 (windows of 32). Then the kernel's plan in plain
torch: per-chunk k-lists over ascending index ranges, joined by (d2,
chunk, rank in chunk) in the plain merge and in the merge kernel's mirror,
equal the whole answer for every chunk count and query tile, which is why
the kernel's chunks may be merged. The kernel itself runs only on the card
(``chip_smoke.py`` phase 3c)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.ops import bruteforce as jbf
from kdtree_tpu.parallel import dsharded as jds
from kdtree_tpu.parallel import mesh as jmesh
from kdtree_tpu_torch.kernels import knn_scan as ks
from kdtree_tpu_torch.ops import bruteforce as tbf
from kdtree_tpu_torch.ops import tile_query as ttq
from kdtree_tpu_torch.parallel import dsharded as tds
from kdtree_tpu_torch.parallel import mesh as tmesh

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

N, Q = 1200, 23
CAP = 1024  # the merge kernel's least shared capacity in keys


def _uniform(d, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-100, 100, (N, d)).astype(np.float32)
    q = rng.uniform(-100, 100, (Q, d)).astype(np.float32)
    p[300:305] = p[11]  # duplicates: equal distances to every query
    q[2] = p[11]
    return p, q


def _lattice(d, seed):
    """Integer-grid points and queries: many exactly tied distances."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 3, (N, d)).astype(np.float32)
    q = rng.integers(0, 3, (Q, d)).astype(np.float32)
    return p, q


def _masked(d, seed, finite=9):
    """All but ``finite`` rows at +inf, as the tombstone-masked storage."""
    p, q = _uniform(d, seed)
    keep = np.random.default_rng(seed + 1).choice(N, finite, replace=False)
    mask = np.ones(N, bool)
    mask[keep] = False
    p[mask] = np.inf
    return p, q


PROBLEMS = {"uniform": _uniform, "lattice": _lattice, "masked": _masked}


def _jax(p, q, k):
    jd, ji = jbf.knn(jnp.asarray(p), jnp.asarray(q), k=k, method="exact")
    return np.asarray(jd), np.asarray(ji)


def _equal(want, got):
    np.testing.assert_array_equal(want[0], got[0].numpy())
    np.testing.assert_array_equal(want[1], got[1].numpy())


@pytest.mark.parametrize("kind", sorted(PROBLEMS))
@pytest.mark.parametrize("k", [1, 5, 16, N])
@pytest.mark.parametrize("d", [1, 2, 3, 8, 16, 32, 33, 40, 47])
def test_plain_and_knn_match_the_reference(kind, k, d):
    p, q = PROBLEMS[kind](d, seed=d)
    want = _jax(p, q, k)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    _equal(want, ks.knn_scan_plain(tp, tq, k))
    _equal(want, tbf.knn(tp, tq, k=k, method="exact"))
    if kind == "masked" and k > 9:  # past the 9 finite rows: (+inf, -1)
        assert np.isinf(want[0][:, -1]).all()
        assert (want[1][np.isinf(want[0])] == -1).all()
        assert (want[1][np.isfinite(want[0])] >= 0).all()


@pytest.mark.parametrize("tile", [7, 100, 1199, None])
def test_the_answer_ignores_the_tile(tile):
    p, q = _lattice(3, seed=4)
    want = _jax(p, q, 16)
    _equal(want, tbf.knn(torch.from_numpy(p), torch.from_numpy(q), k=16, method="exact",
                         tile=tile))


def test_k_is_clamped_and_k_zero_is_empty():
    p, q = _uniform(3, seed=5)
    tp, tq = torch.from_numpy(p[:6]), torch.from_numpy(q)
    d2, ids = ks.knn_scan(tp, tq, 10)
    assert d2.shape == ids.shape == (Q, 6)
    assert (np.sort(ids.numpy(), axis=1) == np.arange(6)).all()
    d2, ids = ks.knn_scan(tp, tq, 0)
    assert d2.shape == ids.shape == (Q, 0) and ids.dtype == torch.int32


def test_wrapper_checks():
    p = torch.zeros(10, 3)
    with pytest.raises(ValueError, match="float32"):
        ks.knn_scan(p.double(), torch.zeros(2, 3), 1)
    with pytest.raises(ValueError, match="shape"):
        ks.knn_scan(p, torch.zeros(2, 4), 1)
    with pytest.raises(ValueError, match="contiguous"):
        ks.knn_scan(torch.zeros(3, 10).T, torch.zeros(2, 3), 1)
    with pytest.raises(ValueError, match="k must be"):
        ks.knn_scan(p, torch.zeros(2, 3), -1)


@pytest.mark.parametrize("n,S", [(1200, 1), (1200, 7), (1201, 4), (1000, 3)])
def test_chunks_are_ascending_ranges_covering_the_points(n, S):
    bounds = ks.chunk_bounds(n, S)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(hi - lo >= n // S for lo, hi in bounds)


@pytest.mark.parametrize("Q_,n,k,slots", [(1000, 1 << 24, 16, 396), (8, 1 << 24, 16, 396),
                                          (1024, 256, 16, 264), (7, 3000, 2000, 396),
                                          (100000, 1 << 20, 16, 396)])
def test_plan_fills_one_wave_with_chunks_of_at_least_k(Q_, n, k, slots):
    S = ks.plan_splits(Q_, n, k, slots)
    tiles = -(-Q_ // ks.TILE)
    assert 1 <= S <= ks.MAX_SPLITS
    assert S == 1 or tiles * S <= slots
    assert n // S >= k
    assert S == 1 or n // S >= ks.MIN_CHUNK


@pytest.mark.parametrize("kind", sorted(PROBLEMS))
@pytest.mark.parametrize("S,tq", [(1, 32), (2, 5), (3, 32), (7, 8), (11, 23)])
@pytest.mark.parametrize("k", [1, 16, 100])
def test_chunk_lists_merged_by_chunk_equal_the_whole_answer(kind, S, tq, k):
    """The kernel's plan in plain torch: query tiles of tq rows, S chunks
    of floor(N / S) points (the last to N, so N need not divide), each
    chunk's k smallest (d2, index), joined by the plain merge's (d2,
    chunk, rank in chunk) order and by the merge kernel's mirror: both
    equal the whole answer, ties and +inf slots included."""
    p, q = PROBLEMS[kind](3, seed=S + k)
    tp, tq_ = torch.from_numpy(p), torch.from_numpy(q)
    whole = ks.knn_scan_plain(tp, tq_, k)
    pd, pi = ks.knn_scan_partials_plain(tp, tq_, k, S, tq)
    T = pd.shape[0]
    md, mi = ttq.merge_partials(pd, pi)
    assert torch.equal(md.view(T * tq, k)[:Q], whole[0])
    assert torch.equal(mi.view(T * tq, k)[:Q], whole[1])
    sd, si, _, _ = ttq.merge_select(pd, pi, CAP)
    assert torch.equal(sd, md) and torch.equal(si, mi)


def test_masked_rows_answer_as_the_reference_pads():
    """Fewer finite rows than k: the finite ones by (d2, index), then (+inf,
    -1) in every slot, on the whole answer and through chunked partials."""
    p, q = _masked(3, seed=9, finite=4)
    tp, tq_ = torch.from_numpy(p), torch.from_numpy(q)
    want = _jax(p, q, 16)
    d2, ids = ks.knn_scan_plain(tp, tq_, 16)
    _equal(want, (d2, ids))
    assert torch.isfinite(d2[:, :4]).all() and torch.isinf(d2[:, 4:]).all()
    assert (ids[:, 4:] == -1).all()
    pd, pi = ks.knn_scan_partials_plain(tp, tq_, 16, 4)
    assert (pi[torch.isinf(pd)] == -1).all()
    sd, si, _, _ = ttq.merge_select(pd, pi, CAP)
    _equal(want, (sd.view(-1, 16)[:Q], si.view(-1, 16)[:Q]))


def test_partials_refuse_a_chunk_shorter_than_k():
    p, q = _uniform(3, seed=2)
    with pytest.raises(ValueError, match="fewer than k"):
        ks.knn_scan_partials_plain(torch.from_numpy(p[:50]), torch.from_numpy(q), 16, 4)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_dsharded_masked_rows_answer_as_the_reference(p):
    """The D-sharded k-NN runs the reference's same running top-k, so its
    +inf slots carry id -1 too (the port gave the masked row's index)."""
    pts, q = _masked(8, seed=p, finite=4)
    want = jds.dsharded_knn(jnp.asarray(pts), jnp.asarray(q), k=7, mesh=jmesh.make_mesh(p))
    got = tds.dsharded_knn(pts, q, k=7, mesh=tmesh.make_mesh(p, device="cpu"))
    _equal((np.asarray(want[0]), np.asarray(want[1])), got)
    assert (got[1][:, 4:] == -1).all()
