"""The port's tiled engine against kdtree_tpu's on the same tree and plan:
frontier, plain scan, the scan wrapper's CPU path and the whole
``morton_knn_tiled`` — d2 and ids bit for bit — plus the brute-force
oracle."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.ops import morton as jmor
from kdtree_tpu.ops import tile_query as jtq
from kdtree_tpu.pallas.scan_knn import scan_tiles_fused
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.kernels import scan_knn as tkernel
from kdtree_tpu_torch.ops import bruteforce as tbf
from kdtree_tpu_torch.ops import tile_query as ttq
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)


def _carry(jt):
    return tree_from_arrays(
        np.asarray(jt.node_lo), np.asarray(jt.node_hi),
        np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid), jt.n_real,
        jt.num_levels, device="cpu")


@functools.lru_cache(maxsize=None)
def _setup(n=5000, d=3, bucket=64, q=256, tile=16, seed=0):
    """One tree in both packages and Hilbert-sorted query tiles."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-100, 100, (n, d)).astype(np.float32)
    qs = rng.uniform(-100, 100, (q, d)).astype(np.float32)
    jt = jmor.build_morton(jnp.asarray(pts), bucket_cap=bucket)
    sq, _ = ttq._sort_queries(torch.from_numpy(qs), jmor.default_bits(d), 0)
    tiles = sq.reshape(-1, tile, d).numpy()
    return pts, qs, jt, _carry(jt), tiles


_jfrontier = jax.jit(jtq._frontier, static_argnums=(4,))
_jscan = jax.jit(jtq._scan_tiles, static_argnums=(4, 5, 6))


def _port_frontier(tt, tiles, bound, cap):
    t = torch.from_numpy(tiles)
    return ttq._frontier(tt, t.amin(1), t.amax(1), torch.from_numpy(bound), cap)


@pytest.mark.parametrize("cap,bound", [(8, np.inf), (32, 300.0), (4, 900.0),
                                       (128, 50.0)])
def test_frontier_matches(cap, bound):
    _, _, jt, tt, tiles = _setup()
    b = np.full(tiles.shape[0], bound, np.float32)
    jc, jl, jo = _jfrontier(jt, jnp.asarray(tiles.min(1)),
                            jnp.asarray(tiles.max(1)), jnp.asarray(b), cap)
    pc, pl, po = _port_frontier(tt, tiles, b, cap)
    np.testing.assert_array_equal(np.asarray(jc), pc.numpy())
    np.testing.assert_array_equal(np.asarray(jl), pl.numpy())
    np.testing.assert_array_equal(np.asarray(jo), po.numpy())


def _collect(tt, tiles, k, cmax=64):
    inf = np.full(tiles.shape[0], np.inf, np.float32)
    c0, l0, _ = _port_frontier(tt, tiles, inf, 8)
    sd, _ = ttq._scan_tiles(tt, torch.from_numpy(tiles), c0, l0, k, 1, 1)
    return _port_frontier(tt, tiles, sd[..., -1].amax(1).numpy(), cmax)[:2]


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("v,tb", [(1, 1), (2, 3), (8, 8)])
def test_plain_scan_bit_identical(k, v, tb):
    _, _, jt, tt, tiles = _setup()
    cand, lb = _collect(tt, tiles, k)
    jd, ji = _jscan(jt, jnp.asarray(tiles), jnp.asarray(cand.numpy()),
                    jnp.asarray(lb.numpy()), k, v, tb)
    pd, pi = ttq._scan_tiles(tt, torch.from_numpy(tiles), cand, lb, k, v, tb)
    np.testing.assert_array_equal(np.asarray(jd), pd.numpy())
    np.testing.assert_array_equal(np.asarray(ji), pi.numpy())


@pytest.mark.parametrize("k", [4, 16])
def test_plain_scan_matches_pallas_interpret(k):
    """Same check as tests/test_pallas_scan.py: d2 within 1 ulp and ids
    that reproduce their distances. Not rtol 0, because the interpreted
    Pallas body sums ``acc = 0; acc += diff * diff`` in straight-line code,
    which XLA:CPU compiles to ``fma(d0, d0, round(d1 * d1))`` then fused
    adds, while the XLA scan (and the port) fuse every axis onto a running
    sum from zero; the test pins that this is the whole difference. Ids
    may differ on ties: the Pallas kernel lets an equal newcomer win, the
    port keeps the incumbent."""
    from kdtree_tpu_torch.ops._arith import sq_sum_unrolled

    pts, _, jt, tt, tiles = _setup(n=4096, bucket=128, q=128, tile=16, seed=4)
    cand, lb = _collect(tt, tiles, k)
    fd, fi = scan_tiles_fused(jt, jnp.asarray(tiles), jnp.asarray(cand.numpy()),
                              jnp.asarray(lb.numpy()), k, interpret=True)
    fd, fi = np.asarray(fd), np.asarray(fi)
    pd, pi = ttq._scan_tiles(tt, torch.from_numpy(tiles), cand, lb, k, 1, 2)
    np.testing.assert_array_max_ulp(fd, pd.numpy(), maxulp=1)
    q = torch.from_numpy(tiles)[:, :, None, :]
    p = torch.from_numpy(pts[np.maximum(fi, 0)])
    straight = sq_sum_unrolled([q[..., d] - p[..., d] for d in range(3)])
    np.testing.assert_array_equal(straight.numpy(), fd)
    again = ttq.sq_dist(q, torch.from_numpy(pts[np.maximum(pi.numpy(), 0)]))
    np.testing.assert_array_equal(again.numpy(), pd.numpy())


def test_scan_wrapper_cpu_is_the_plain_version():
    _, _, _, tt, tiles = _setup()
    cand, lb = _collect(tt, tiles, 5)
    t = torch.from_numpy(tiles)
    d, i = tkernel.scan_tiles(tt, t, cand, lb, 10**6, v=2, tb=3)
    pd, pi = ttq._scan_tiles(tt, t, cand, lb, tt.n_real, 2, 3)  # k clamped
    assert torch.equal(d, pd) and torch.equal(i, pi)
    with pytest.raises(ValueError, match="CUDA kernel only"):
        tkernel.scan_tiles(tt, t, cand, lb, 5,
                           visited=torch.zeros(t.shape[0], dtype=torch.int32))


def test_plan_matches_reference_knobs():
    for args in [(300, 3, 6000, 128, 64, 5), (1 << 20, 3, 1 << 24, 65536, 256, 16),
                 (1024, 3, 1 << 24, 65536, 256, 16), (50, 8, 40, 1, 256, 64)]:
        jp = jtq.plan_tiled(*args, tile=None, cmax=256, use_pallas=False)
        tp = ttq.plan_tiled(*args, tile=None, cmax=256, use_kernel=False)
        assert tuple(jp[:7]) == tuple(tp[:7])
        jp = jtq.plan_tiled(*args, tile=None, cmax=256, use_pallas=True)
        tp = ttq.plan_tiled(*args, tile=None, cmax=256, use_kernel=True)
        assert tuple(jp[:7]) == tuple(tp[:7])
    assert ttq.plan_tiled(300, 3, 6000, 128, 64, 5, device="cpu").use_kernel is False
    assert ttq.plan_tiled(300, 3, 6000, 128, 64, 5, device="cpu").source == "heuristic"


@pytest.mark.parametrize("k,tile,cmax,nq", [
    (1, 16, 128, 300), (5, 32, 128, 300), (16, 64, 128, 250), (16, 8, 32, 301),
])
def test_morton_knn_tiled_matches_reference_and_oracle(k, tile, cmax, nq):
    pts, qs, jt, tt, _ = _setup(n=6000, bucket=64, q=512, seed=1)
    qs = qs[:nq]  # Q not a multiple of the tile
    kw = dict(tile=tile, cmax=cmax, seeds=4, scan_v=1, scan_tb=8)
    jd, ji = jtq.morton_knn_tiled(jt, jnp.asarray(qs), k=k, use_pallas=False, **kw)
    stats = ttq.TileStats()
    pd, pi = ttq.morton_knn_tiled(tt, qs, k=k, use_kernel=False, stats=stats, **kw)
    np.testing.assert_array_equal(np.asarray(jd), pd.numpy())
    np.testing.assert_array_equal(np.asarray(ji), pi.numpy())
    bd, bi = tbf.knn(torch.from_numpy(pts), torch.from_numpy(qs), k=k)
    assert torch.equal(bd, pd) and torch.equal(bi, pi)
    assert stats.batches == 1
    if cmax < 128:  # an undersized cap for this tree's 128 buckets
        assert stats.retries > 0


def test_k_exceeds_n_real():
    pts, qs, _, _, _ = _setup()
    jt = jmor.build_morton(jnp.asarray(pts[:40]))
    tt = _carry(jt)
    kw = dict(tile=8, cmax=128, seeds=8, scan_v=1, scan_tb=1)
    jd, ji = jtq.morton_knn_tiled(jt, jnp.asarray(qs[:37]), k=64, use_pallas=False, **kw)
    pd, pi = ttq.morton_knn_tiled(tt, qs[:37], k=64, use_kernel=False, **kw)
    assert pd.shape == (37, 40)
    np.testing.assert_array_equal(np.asarray(jd), pd.numpy())
    np.testing.assert_array_equal(np.asarray(ji), pi.numpy())


def test_drive_batches_retries_stale_cap_batches():
    """A batch that overflowed at a stale smaller cap retries even after
    the cap reached its ceiling for others (the per-batch ``caps[i]``
    rule), and the retry count says how many re-dispatches there were."""
    calls = []

    def run(off, cap):
        calls.append((off, cap))
        over = torch.tensor(cap < (8 if off == 0 else 4 if off == 2 else 1))
        return torch.full((1, 1), float(off)), torch.full((1, 1), off), over

    stats = ttq.TileStats()
    d2, gi = ttq.drive_batches(run, [0, 1, 2], 2, 8, lookahead=2, stats=stats)
    assert d2.flatten().tolist() == [0.0, 1.0, 2.0]
    assert calls[:3] == [(0, 2), (0, 4), (0, 8)]
    assert (2, 8) in calls and stats.retries == len(calls) - 3
    assert stats.batches == 3


def test_empty_queries():
    _, _, _, tt, _ = _setup()
    d, i = ttq.morton_knn_tiled(tt, np.zeros((0, 3), np.float32), k=3)
    assert d.shape == (0, 3) and i.shape == (0, 3)
