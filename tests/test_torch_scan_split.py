"""The redesigned scan kernel's arithmetic, held on the CPU by its plain
versions: a tile's walk split into contiguous chunks and merged by
``merge_partials`` equals one walk over the whole list (and JAX's
``_scan_tiles``) bit for bit; the per-warp box bound never exceeds a
point's squared distance (a seeded sweep over edge values), so skipping on
it changes nothing; and the wrapper's ``splits`` checks."""

import functools
import importlib.util
from pathlib import Path

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
from kdtree_tpu_torch.ops._arith import sq_dist, sq_dist_to_box
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

_jscan = jax.jit(jtq._scan_tiles, static_argnums=(4, 5, 6))


@functools.lru_cache(maxsize=None)
def _lattice_case(n_sites: int, n: int, k: int):
    """Tie-heavy inputs: integer-lattice points with duplicated rows, queries
    on lattice points, collect-pass candidates with -1 holes inside the
    list. Returns (JAX tree, port tree, tiles, cand, lb, k)."""
    rng = np.random.default_rng(n_sites * 1000 + n)
    pts = rng.integers(-n_sites, n_sites + 1, (n, 3)).astype(np.float32)
    pts = np.concatenate([pts, pts[: n // 3]])  # duplicated rows
    qs = rng.integers(-n_sites, n_sites + 1, (64, 3)).astype(np.float32)
    jt = jmor.build_morton(jnp.asarray(pts), bucket_cap=16)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    sq, _ = ttq._sort_queries(torch.from_numpy(qs), jmor.default_bits(3), 0)
    tiles = sq.reshape(-1, 16, 3).contiguous()
    k = min(k, tt.n_real)
    inf = torch.full((tiles.shape[0],), float("inf"))
    c0, l0, _ = ttq._frontier(tt, tiles.amin(1), tiles.amax(1), inf, 4)
    sd, _ = ttq._scan_tiles(tt, tiles, c0, l0, k, 1, 1)
    cand, lb, _ = ttq._frontier(tt, tiles.amin(1), tiles.amax(1),
                                sd[..., -1].amax(1), 64)
    cand = cand.clone()
    cand[:, 1::4] = -1  # holes inside the list; their lb stays finite
    return jt, tt, tiles, cand, lb, k


_CASES = {"lattice": (2, 600, 16), "k>n_real": (1, 30, 64)}


def _split_scan(tt, tiles, cand, lb, k, S):
    """Chunk s of S scans the s-th contiguous ceil(C / S) positions, as the
    kernel's blocks do; the partials are stacked [T, S, TQ, k]."""
    C = cand.shape[1]
    chunk = -(-C // S)
    parts = [ttq._scan_tiles(tt, tiles, cand[:, c:c + chunk].contiguous(),
                             lb[:, c:c + chunk].contiguous(), k, 1, 1)
             for c in range(0, C, chunk)]
    return torch.stack([p[0] for p in parts], 1), torch.stack([p[1] for p in parts], 1)


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("S", [1, 2, 3, 7])
def test_split_and_merge_equals_one_walk(case, S):
    jt, tt, tiles, cand, lb, k = _lattice_case(*_CASES[case])
    pd, pi = _split_scan(tt, tiles, cand, lb, k, S)
    md, mi = ttq.merge_partials(pd, pi)
    wd, wi = ttq._scan_tiles(tt, tiles, cand, lb, k, 1, 1)
    assert torch.equal(md, wd) and torch.equal(mi, wi)
    jd, ji = _jscan(jt, jnp.asarray(tiles.numpy()), jnp.asarray(cand.numpy()),
                    jnp.asarray(lb.numpy()), k, 1, 1)
    np.testing.assert_array_equal(np.asarray(jd), md.numpy())
    np.testing.assert_array_equal(np.asarray(ji), mi.numpy())
    if case == "lattice":  # the data really ties across chunks
        assert bool((md[..., 1:] == md[..., :-1]).any())


def test_merge_keeps_the_earlier_chunk_on_ties():
    d = torch.tensor([[[[1.0, 2.0]], [[1.0, 2.0]]]])  # [T=1, S=2, TQ=1, k=2]
    i = torch.tensor([[[[7, 8]], [[3, 4]]]], dtype=torch.int32)
    md, mi = ttq.merge_partials(d, i)
    assert md.tolist() == [[[1.0, 1.0]]] and mi.tolist() == [[[7, 3]]]


_EDGES = np.array([0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38], dtype=np.float32)


def _coords(rng, shape):
    """Float32 coordinates, a third each: moderate values, any finite
    float32 (random bit patterns), and the edge values ±0, ±1e-45, ±3.4e38."""
    moderate = rng.uniform(-1e3, 1e3, shape).astype(np.float32)
    anyf = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.float32)
    anyf = np.where(np.isfinite(anyf), anyf, np.float32(1.0))
    edge = _EDGES[rng.integers(0, len(_EDGES), shape)]
    return np.choose(rng.integers(0, 3, shape), [moderate, anyf, edge])


def test_box_bound_never_above_the_point_distance():
    """For a query q, a box [lo, hi] and a point p inside it, on a face, or
    at a corner (per axis: 0 = inside, 1 = on lo, 2 = on hi), the skip's
    bound is <= sq_dist(q, p), ±0 and huge coordinates included; D = 1..4,
    4096 seeded cases each."""
    rng = np.random.default_rng(20261016)
    for D in range(1, 5):
        shape = (4096, D)
        q, b, c, x = (_coords(rng, shape) for _ in range(4))
        lo, hi = np.minimum(b, c), np.maximum(b, c)
        p = np.choose(rng.integers(0, 3, shape), [np.clip(x, lo, hi), lo, hi])
        t = torch.from_numpy
        bound = sq_dist_to_box(t(q), t(lo), t(hi))
        d2 = sq_dist(t(q), t(p))
        bad = ~(bound <= d2)
        assert not bool(bad.any()), (D, q[bad.numpy()][:3], bound[bad][:3], d2[bad][:3])


def test_empty_box_is_at_infinity():
    inf = float("inf")
    b = sq_dist_to_box(torch.zeros(3), torch.full((3,), inf), torch.full((3,), -inf))
    assert bool(torch.isinf(b))


def _scan_with_warp_skip(tt, tiles, cand, k, warp=32):
    """A plain mirror of the kernel's per-warp skip: walk each tile's list
    in order and, for each group of ``warp`` queries, skip a bucket when
    every query's box bound is >= its current k-th."""
    T, TQ, _ = tiles.shape
    first_leaf = tt.num_buckets - 1
    out_d = torch.full((T, TQ, k), float("inf"))
    out_i = torch.full((T, TQ, k), -1, dtype=torch.int32)
    skipped = 0
    for t in range(T):
        for g0 in range(0, TQ, warp):
            q = tiles[t, g0:g0 + warp]
            bd, bi = out_d[t, g0:g0 + warp], out_i[t, g0:g0 + warp]
            for b in cand[t].tolist():
                if b < 0:
                    continue
                bound = sq_dist_to_box(q, tt.node_lo[first_leaf + b], tt.node_hi[first_leaf + b])
                if bool((bound >= bd[:, k - 1]).all()):
                    skipped += 1
                    continue
                d2 = sq_dist(q[:, None, :], tt.bucket_pts[b][None])
                gid = tt.bucket_gid[b][None].expand(q.shape[0], -1)
                bd, bi = ttq._fold_block(bd, bi, d2, gid, k)
            out_d[t, g0:g0 + warp], out_i[t, g0:g0 + warp] = bd, bi
    return out_d, out_i, skipped


@pytest.mark.parametrize("warp", [32, 4])
def test_per_warp_skip_leaves_the_scan_unchanged(warp):
    _, tt, tiles, cand, lb, k = _lattice_case(*_CASES["lattice"])
    sd, si, skipped = _scan_with_warp_skip(tt, tiles[:2], cand[:2], k, warp)
    wd, wi = ttq._scan_tiles(tt, tiles[:2], cand[:2], lb[:2], k, 1, 1)
    assert torch.equal(sd, wd) and torch.equal(si, wi)
    assert skipped > 0


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_input_bound_counts_no_more_than_a_per_query_walk():
    """chip_smoke's bound counts the (query, bucket) pairs whose box bound
    is below the query's final k-th: no more than a walk that skips per
    query (the warp=1 mirror) scans, and no more than the tile-level count."""
    _, tt, tiles, cand, lb, k = _lattice_case(*_CASES["lattice"])
    tiles, cand, lb = tiles[:2], cand[:2], lb[:2]
    wd, _ = ttq._scan_tiles(tt, tiles, cand, lb, k, 1, 1)
    rec = _chip_smoke().input_bound(tt, tiles, cand, lb, wd, k)
    _, _, skipped = _scan_with_warp_skip(tt, tiles, cand, k, warp=1)
    scanned = tiles.shape[1] * int((cand >= 0).sum()) - skipped
    assert 0 < rec["pairs"] <= scanned
    assert rec["pairs"] <= tiles.shape[1] * rec["tile_need"]
    assert rec["need"] <= rec["tile_need"]
    assert rec["bound_ms"] <= rec["tile_bound_ms"]


def test_splits_checks_on_the_wrapper():
    _, tt, tiles, cand, lb, k = _lattice_case(*_CASES["lattice"])
    for bad in (0, -3):
        with pytest.raises(ValueError, match="splits must be >= 1"):
            tkernel.scan_tiles(tt, tiles, cand, lb, k, splits=bad)
    d, i = tkernel.scan_tiles(tt, tiles, cand, lb, k, splits=5)  # CPU: ignored
    wd, wi = ttq._scan_tiles(tt, tiles, cand, lb, k, 1, 1)
    assert torch.equal(d, wd) and torch.equal(i, wi)
    pd, pi = _split_scan(tt, tiles, cand, lb, k, 3)
    md, mi = tkernel.merge_partials(pd, pi)  # CPU: the plain merge
    assert torch.equal(md, wd) and torch.equal(mi, wi)


@pytest.mark.parametrize("T,C,sms,want", [
    (512, 512, 132, 1),      # the tiled run's collect batch: tiles fill the card
    (264, 8, 132, 1),
    (1, 65536, 132, 1024),   # one sparse tile: 64 positions per block
    (8, 65536, 132, 1024),
    (128, 32768, 132, 512),
    (1, 100, 132, 2),
    (1, 8, 132, 1),
])
def test_plan_splits(T, C, sms, want):
    assert tkernel.plan_splits(T, C, sms) == want
