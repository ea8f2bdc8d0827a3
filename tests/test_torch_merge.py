"""The merge kernel's algorithm, held on the CPU by its step-for-step mirror
``ops/tile_query.py::merge_select``: the threshold from the chunks' k-th
entries, the survivors' walk, their sort, the exact overflow path (a radix
select when more keys survive than the shared capacity) and the slabs (k
above the capacity) give the plain merge's answer bit for bit, ties and
(+inf, -1) pads included, and through a split walk JAX's one walk
(``kdtree_tpu/ops/tile_query.py::_scan_tiles``). The kernel itself runs
only on the card (``chip_smoke.py`` phase 3 holds it against both)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.ops import morton as jmor
from kdtree_tpu.ops import tile_query as jtq
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.kernels import scan_knn as tkernel
from kdtree_tpu_torch.ops import tile_query as ttq
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

_jscan = jax.jit(jtq._scan_tiles, static_argnums=(4, 5, 6))

CAP = 1024  # the kernel's least shared capacity in keys (chip_smoke.py prints its own)


def _partials(seed, T, S, TQ, k, full, spread=0.0):
    """Seeded partial buffers pd f32[T, S, TQ, k], pi i32[T, S, TQ, k] as
    the scan kernel leaves them: each chunk's buffer ascending, a ``full``
    share of the chunks holding k entries and the rest 0..k-1, unfilled
    slots (+inf, -1); chunk s's d2 uniform in [s spread, s spread + 10), as
    chunks later in the lb order lie farther, or on the lattice {0, 1, 2,
    3} when ``spread`` is None."""
    rng = np.random.default_rng(seed)
    n = np.where(rng.random((T, S, TQ)) < full, k, rng.integers(0, k, (T, S, TQ)))
    if spread is None:
        v = rng.integers(0, 4, (T, S, TQ, k)).astype(np.float32)
    else:
        v = (rng.random((T, S, TQ, k)) * 10
             + np.arange(S)[:, None, None] * spread).astype(np.float32)
    filled = np.arange(k) < n[..., None]
    d = np.where(filled, np.sort(v, -1), np.inf).astype(np.float32)
    i = np.where(filled, rng.integers(0, 1 << 30, (T, S, TQ, k)), -1).astype(np.int32)
    return torch.from_numpy(d), torch.from_numpy(i)


def _check(pd, pi, cap):
    md, mi = ttq.merge_partials(pd, pi)
    sd, si, surv, over = ttq.merge_select(pd, pi, cap)
    assert torch.equal(sd, md) and torch.equal(si, mi)
    return surv, over


@pytest.mark.parametrize("TQ", [1, 8, 128])
@pytest.mark.parametrize("S", [1, 2, 7, 1024])
def test_mirror_equals_plain_merge_by_shape(S, TQ):
    T = 2 if S * TQ <= 1024 else 1
    for spread in (0.0, 0.05):  # survivors past the capacity, then few
        pd, pi = _partials(S * 1000 + TQ, T, S, TQ, 16, 0.1, spread)
        surv, over = _check(pd, pi, CAP)
        assert over.shape == (T, TQ) and int(surv.max()) <= S * 16
        if S == 1024 and spread == 0.0:  # the overflow path at the serve shape's S
            assert bool((over > 0).any())


@pytest.mark.parametrize("k", [1, 16, 32, 33, 48, 64])
@pytest.mark.parametrize("S,TQ", [(7, 8), (1024, 1)])
def test_mirror_equals_plain_merge_by_k(S, TQ, k):
    pd, pi = _partials(k * 7 + S, 2, S, TQ, k, 0.1, 0.05)
    _check(pd, pi, CAP)


def test_no_full_chunk_takes_every_finite_entry():
    """w = +inf: every chunk's k-th is a pad; the survivors are the finite
    entries, fewer than k in some rows, and the rest of the answer is
    (+inf, -1)."""
    pd, pi = _partials(5, 2, 3, 8, 16, 0.0)
    keys, hi, surv = ttq.merge_survivors(pd)
    assert bool((hi == (ttq._INF_BITS << 32) - 1).all())
    assert torch.equal(surv, torch.isfinite(pd).sum((1, 3)).reshape(-1))
    _check(pd, pi, 1024)
    md, mi = ttq.merge_partials(pd, pi)
    pads = ~torch.isfinite(md)
    assert bool(pads.any()) and bool((mi[pads] == -1).all())


def test_rows_with_fewer_than_k_finite_entries():
    d = torch.full((1, 4, 2, 8), float("inf"))
    i = torch.full((1, 4, 2, 8), -1, dtype=torch.int32)
    d[0, 1, 0, :3] = torch.tensor([1.0, 2.0, 2.0])
    i[0, 1, 0, :3] = torch.tensor([4, 5, 6], dtype=torch.int32)
    d[0, 3, 0, :1], i[0, 3, 0, :1] = 0.5, 9
    for cap in (1, 2, 1024):
        sd, si, surv, _ = ttq.merge_select(d, i, cap)
        assert sd[0, 0].tolist() == [0.5, 1.0, 2.0, 2.0] + [float("inf")] * 4
        assert si[0, 0].tolist() == [9, 4, 5, 6] + [-1] * 4
        assert sd[0, 1].isinf().all() and bool((si[0, 1] == -1).all())
        assert surv.tolist() == [[4, 0]]


@pytest.mark.parametrize("cap", [1, 2, 1024])
def test_earlier_chunk_wins_a_tie(cap):
    d = torch.tensor([[[[1.0, 2.0]], [[1.0, 2.0]], [[0.5, 2.0]]]])  # [T=1, S=3, TQ=1, k=2]
    i = torch.tensor([[[[7, 8]], [[3, 4]], [[1, 2]]]], dtype=torch.int32)
    sd, si, surv, over = ttq.merge_select(d, i, cap)
    assert sd.tolist() == [[[0.5, 1.0]]] and si.tolist() == [[[1, 7]]]
    assert surv.tolist() == [[6]] and bool(over.item()) is (cap < 6)


@pytest.mark.parametrize("cap", [3, 16, 100])
def test_tie_lattice_overflows_a_small_capacity(cap):
    """Every chunk full of d2 in {0..3}: almost every entry survives, past
    the capacity, and the radix select (then slabs, for k=33 > cap) keeps
    the answer exact."""
    for k in (16, 33):
        pd, pi = _partials(cap + k, 2, 12, 4, k, 1.0, None)
        surv, over = _check(pd, pi, cap)
        assert bool((surv > cap).all()) and bool((over >= 1).all())
        if k > cap:
            assert bool((over >= -(-k // cap)).all())


def test_k_above_the_capacity_takes_slabs():
    """k = 1,100 over two full lattice chunks at the least capacity (chip_smoke
    phase 3's slab case): each row answered in two slabs, the second above
    the first."""
    pd, pi = _partials(1100, 1, 2, 8, 1100, 1.0, None)
    surv, over = _check(pd, pi, CAP)
    assert bool((surv > CAP).all()) and bool((over == 2).all())


def test_radix_select_picks_the_ranked_key():
    pd, pi = _partials(11, 1, 9, 1, 8, 1.0, None)
    keys, hi, _ = ttq.merge_survivors(pd)
    walked = ttq._merge_walk(keys[0], 0, int(hi[0]))
    srt = torch.sort(walked).values
    for r in (1, 2, 5, walked.numel()):
        assert ttq._merge_radix_select(keys[0], 0, int(hi[0]), r) == int(srt[r - 1])
    lo = int(srt[3]) + 1  # a later slab: ranks above the keys already taken
    assert ttq._merge_radix_select(keys[0], lo, int(hi[0]), 2) == int(srt[5])


def test_launch_rules_and_checks():
    pd, pi = _partials(1, 1, 2, 1, 4, 1.0)
    md, mi = tkernel.merge_partials(pd, pi)  # a CPU tensor takes the plain merge
    pmd, pmi = ttq.merge_partials(pd, pi)
    assert torch.equal(md, pmd) and torch.equal(mi, pmi)
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        tkernel.merge_partials(pd.to("meta"), pi.to("meta"))
    with pytest.raises(ValueError, match="cap must be >= 1"):
        ttq.merge_select(pd, pi, 0)


# ---------------------------------------------------------------------------
# through a split walk: the mirror equals JAX's one walk
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lattice(TQ: int, k: int):
    """A tie-heavy integer lattice (duplicated rows, queries on sites) and
    its collect-pass candidates for tiles of TQ queries."""
    rng = np.random.default_rng(TQ * 100 + k)
    pts = rng.integers(-2, 3, (600, 3)).astype(np.float32)
    pts = np.concatenate([pts, pts[:200]])
    qs = rng.integers(-2, 3, (max(TQ, 16), 3)).astype(np.float32)
    jt = jmor.build_morton(jnp.asarray(pts), bucket_cap=16)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    sq, _ = ttq._sort_queries(torch.from_numpy(qs), jmor.default_bits(3), 0)
    tiles = sq.reshape(-1, TQ, 3).contiguous()
    inf = torch.full((tiles.shape[0],), float("inf"))
    cand, lb, _ = ttq._frontier(tt, tiles.amin(1), tiles.amax(1), inf, 64)
    return jt, tt, tiles, cand, lb


def _split(tt, tiles, cand, lb, k, S):
    C = cand.shape[1]
    chunk = -(-C // S)
    parts = [ttq._scan_tiles(tt, tiles, cand[:, c:c + chunk].contiguous(),
                             lb[:, c:c + chunk].contiguous(), k, 1, 1)
             for c in range(0, C, chunk)]
    return torch.stack([p[0] for p in parts], 1), torch.stack([p[1] for p in parts], 1)


@pytest.mark.parametrize("cap", [4, None])
@pytest.mark.parametrize("S", [1, 2, 7, 1024])
@pytest.mark.parametrize("TQ,k", [(8, 16), (16, 33)])
def test_split_walk_and_mirror_equal_jax_one_walk(TQ, k, S, cap):
    jt, tt, tiles, cand, lb = _lattice(TQ, k)
    pd, pi = _split(tt, tiles, cand, lb, k, S)
    sd, si, surv, over = ttq.merge_select(pd, pi, cap or CAP)
    jd, ji = _jscan(jt, jnp.asarray(tiles.numpy()), jnp.asarray(cand.numpy()),
                    jnp.asarray(lb.numpy()), k, 1, 1)
    np.testing.assert_array_equal(np.asarray(jd), sd.numpy())
    np.testing.assert_array_equal(np.asarray(ji), si.numpy())
    assert bool((sd[..., 1:] == sd[..., :-1]).any())  # the data really ties
    if cap and pd.shape[1] > 1:
        assert bool((over > 0).any())
