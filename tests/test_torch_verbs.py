"""The port's query verbs (radius / range / count) against kdtree_tpu's, on
the CPU, on the same trees: counts, ids and d2 bit-equal to
``kdtree_tpu.verbs`` and to both oracles on the reference's test shapes;
the edges (no queries, r = 0, far balls, degenerate and inverted boxes,
tile padding); forced small capacities, so both overflow retries fire and
the answers stay exact; points placed exactly at distance r; writes
interleaved with verb queries against the rebuild oracle; and the server's
verb endpoints byte-identical to a kdtree_tpu server."""

from __future__ import annotations

import contextlib
import json
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu import verbs as jverbs
from kdtree_tpu.mutable.engine import MutableEngine as JMutableEngine
from kdtree_tpu.ops.generate import generate_points_rowwise as jgen
from kdtree_tpu.ops.morton import build_morton as jbuild
from kdtree_tpu.serve import lifecycle as jlife
from kdtree_tpu.serve import server as jsrv
from kdtree_tpu.verbs import oracle as jvo
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.mutable.engine import MutableEngine
from kdtree_tpu_torch.obs import flight as tflight
from kdtree_tpu_torch.ops._arith import sq_dist
from kdtree_tpu_torch.ops.morton import build_morton
from kdtree_tpu_torch.serve import engine as tlife
from kdtree_tpu_torch.serve import server as tsrv
from kdtree_tpu_torch.verbs import device as tv
from kdtree_tpu_torch.verbs import oracle as tvo
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

torch.set_num_threads(1)

DIM, K = 3, 4
SEED = 7


@pytest.fixture(autouse=True)
def _reset_port_flight_rate_limit():
    tflight.recorder().reset_dump_rate_limit()
    yield


def _trees(seed, dim, n):
    """(reference tree, port tree, host points) over one seeded cloud."""
    raw = jgen(seed, dim, n)
    jt = jbuild(raw)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    return jt, tt, np.asarray(raw)


def _data_queries(pts, q, rng, jitter=0.01):
    """Queries near actual data, so no radius assert passes vacuously."""
    scale = float(np.abs(pts).max())
    picks = pts[rng.integers(0, pts.shape[0], q)]
    return (picks + rng.normal(0.0, jitter * scale, picks.shape)).astype(np.float32), scale


def _same(a, b, retries=True):
    """Bit-equal over the valid hit rows (buffers trimmed: a device
    buffer is a pow2 width, an oracle's the largest count)."""
    a, b = tv.trim_result(a), tv.trim_result(b)
    assert a.counts.dtype == np.int64 and np.array_equal(a.counts, b.counts)
    assert (a.ids is None) == (b.ids is None) and (a.d2 is None) == (b.d2 is None)
    if b.ids is not None:
        assert a.ids.dtype == b.ids.dtype and np.array_equal(a.ids, b.ids)
    if b.d2 is not None:
        assert a.d2.dtype == b.d2.dtype and np.array_equal(a.d2, b.d2)
    assert a.truncated == b.truncated
    if retries:
        assert a.retries == b.retries


def _all_forms(jt, tt, pts, queries, r, lo, hi, **kw):
    """Every verb form through both packages and both oracles."""
    _same(tv.radius_search(tt, queries, r, **kw), jverbs.radius_search(jt, queries, r, **kw))
    _same(tvo.radius_oracle(pts, queries, r, device="cpu"), jvo.radius_oracle(pts, queries, r))
    _same(tv.radius_search(tt, queries, r, with_ids=False, **kw),
          jverbs.radius_search(jt, queries, r, with_ids=False, **kw))
    _same(tv.range_search(tt, lo, hi, **kw), jverbs.range_search(jt, lo, hi, **kw))
    _same(tvo.range_oracle(pts, lo, hi, device="cpu"), jvo.range_oracle(pts, lo, hi))
    _same(tv.range_search(tt, lo, hi, with_ids=False, **kw),
          jverbs.range_search(jt, lo, hi, with_ids=False, **kw))
    res = tv.radius_search(tt, queries, r, **kw)
    _same(res, tvo.radius_oracle(pts, queries, r, device="cpu"), retries=False)
    assert np.array_equal(tvo.radius_count_oracle(pts, queries, r, device="cpu"),
                          jvo.radius_count_oracle(pts, queries, r))
    assert np.array_equal(tvo.range_count_oracle(pts, lo, hi, device="cpu"),
                          jvo.range_count_oracle(pts, lo, hi))
    return res


@pytest.mark.parametrize("dim,n", [(2, 512), (3, 2048), (8, 1024)])
def test_verbs_bit_equal_to_reference(dim, n):
    jt, tt, pts = _trees(SEED + dim, dim, n)
    rng = np.random.default_rng(dim)
    queries, scale = _data_queries(pts, 13, rng)
    r = (rng.uniform(0.02, 0.12, 13) * scale).astype(np.float32)
    lo = (queries - 0.05 * scale).astype(np.float32)
    hi = (queries + 0.05 * scale).astype(np.float32)
    res = _all_forms(jt, tt, pts, queries, r, lo, hi)
    assert int(res.counts.sum()) > 0, "vacuous: no radius hits"
    assert int(tv.range_search(tt, lo, hi).counts.sum()) > 0, "vacuous: no range hits"


def test_verb_edges_empty_and_degenerate():
    jt, tt, pts = _trees(SEED, DIM, 1024)
    # no queries: the oracle's empty answer (the reference's device search
    # raises on an empty batch; its oracle answers this)
    empty = np.zeros((0, DIM), np.float32)
    _same(tv.radius_search(tt, empty, 1.0), jvo.radius_oracle(pts, empty, 1.0), retries=False)
    _same(tv.range_search(tt, empty, empty), jvo.range_oracle(pts, empty, empty),
          retries=False)
    assert tv.radius_search(tt, empty, 1.0, with_ids=False).counts.shape == (0,)
    # r = 0 centred ON data points: the point itself is inside
    queries = pts[:5].astype(np.float32)
    zero = np.zeros(5, np.float32)
    _all_forms(jt, tt, pts, queries, zero, queries, queries)
    assert np.all(tv.radius_search(tt, queries, zero).counts >= 1)
    # the degenerate box [p, p] contains p
    assert np.all(tv.range_search(tt, queries, queries).counts >= 1)
    # far away: exactly empty, with empty id rows
    far = np.full((3, DIM), 1e6, np.float32)
    res = tv.radius_search(tt, far, np.ones(3, np.float32))
    assert np.array_equal(res.counts, np.zeros(3, np.int64)) and not np.any(res.ids >= 0)
    _all_forms(jt, tt, pts, far, np.ones(3, np.float32), far, far + 1)
    # inverted boxes (lo > hi on an axis) are legitimately empty
    lo = np.full((2, DIM), 1.0, np.float32)
    hi = np.full((2, DIM), -1.0, np.float32)
    hi[1, 1:] = 50.0  # inverted on one axis only
    lo[1, 1:] = -50.0
    _all_forms(jt, tt, pts, lo, np.ones(2, np.float32), lo, hi)
    assert np.array_equal(tv.range_search(tt, lo, hi).counts, np.zeros(2, np.int64))
    # tile padding: 65 and 130 rows over tiles of 64 (padding rows hit nothing)
    rng = np.random.default_rng(5)
    for q in (65, 130):
        queries, scale = _data_queries(pts, q, rng)
        r = np.full(q, 0.05 * scale, np.float32)
        _all_forms(jt, tt, pts, queries, r, queries - 0.05 * scale, queries + 0.05 * scale)


def test_forced_small_caps_retry_and_stay_exact():
    """Start both capacities at 1: the frontier doubles and the hit buffer
    regrows, the same number of times as the reference, and every answer
    stays bit-equal to it and to the oracle."""
    jt, tt, pts = _trees(SEED + 1, DIM, 2048)
    rng = np.random.default_rng(3)
    queries, scale = _data_queries(pts, 9, rng)
    r = np.full(9, 0.2 * scale, np.float32)
    lo, hi = queries - 0.2 * scale, queries + 0.2 * scale
    res = _all_forms(jt, tt, pts, queries, r, lo, hi, cap=1, max_hits=1)
    # both retries fired: the frontier doublings alone, the hit regrow
    # alone, and the two together
    frontier = tv.radius_search(tt, queries, r, cap=1, max_hits=1 << 12).retries
    hits = tv.radius_search(tt, queries, r, max_hits=1).retries
    assert frontier > 0 and hits == 1 and res.retries == frontier + hits
    assert int(res.counts.max()) > 1
    assert tv.range_search(tt, lo, hi, cap=1, max_hits=1).retries > 1


def test_points_exactly_at_radius():
    """Membership is d2 <= r^2: points whose d2 equals r^2 exactly are
    hits, one ulp further out they are not — in the reference's
    arithmetic, bit for bit."""
    rng = np.random.default_rng(17)
    base = rng.uniform(-50, 50, (600, DIM)).astype(np.float32)
    # integer shells: d2 and r^2 both exact
    q0 = np.zeros(DIM, np.float32)
    shell = np.array([[3, 4, 0], [0, 3, 4], [1, 2, 2], [-2, -1, -2], [0, 0, 5],
                      [3, 4, 0.01]], np.float32)
    # random points and radii with fl(r * r) == d2 in the FMA-chain d2
    q1 = rng.uniform(-5, 5, DIM).astype(np.float32)
    cand = (q1 + rng.uniform(-3, 3, (400, DIM))).astype(np.float32)
    d2 = sq_dist(torch.from_numpy(q1)[None, :], torch.from_numpy(cand)).numpy()
    r = np.sqrt(d2.astype(np.float64)).astype(np.float32)
    exact = np.nonzero((r * r).astype(np.float32) == d2)[0][:8]
    assert exact.size >= 4, "no exactly representable radii found"
    pts = np.concatenate([base, shell, cand[exact]])
    jt = jbuild(jnp.asarray(pts), bucket_cap=16)
    tt = build_morton(torch.from_numpy(pts), bucket_cap=16, device="cpu")
    queries = np.stack([q0, q0, q0] + [q1] * exact.size)
    radii = np.concatenate([[5.0, 3.0, np.nextafter(np.float32(5), np.float32(0))],
                            r[exact]]).astype(np.float32)
    res = _all_forms(jt, tt, pts, queries, radii, queries - radii[:, None],
                     queries + radii[:, None])
    hits = [set(res.ids[i, :res.counts[i]].tolist()) for i in range(len(queries))]
    n0 = base.shape[0]
    assert {n0, n0 + 1, n0 + 4} <= hits[0] and n0 + 5 not in hits[0]
    assert {n0 + 2, n0 + 3} <= hits[1]
    assert not {n0, n0 + 1, n0 + 4} & hits[2]  # one ulp inside r = 5
    for j, e in enumerate(exact):
        assert n0 + len(shell) + j in hits[3 + j]


def test_mutable_interleavings_vs_rebuild_oracle():
    """Writes interleaved with verb queries through both packages' mutable
    engines: deletes inside a ball, upserts crossing a box, a moved point —
    every form bit-equal to the reference's engine and to the oracle over
    the surviving points, the brute-force fallbacks too."""
    jt, tt, pts = _trees(SEED, DIM, 2048)
    teng = MutableEngine(tlife.ServeEngine(tt, K), max_delta_rows=64, requested_k=K)
    jeng = JMutableEngine(jlife.ServeEngine(jt, K), max_delta_rows=64, requested_k=K)
    gid = np.arange(pts.shape[0], dtype=np.int64)
    rng = np.random.default_rng(11)
    queries, scale = _data_queries(pts, 7, rng)
    r = np.full(7, 0.08 * scale, np.float32)
    lo = (queries - 0.06 * scale).astype(np.float32)
    hi = (queries + 0.06 * scale).astype(np.float32)

    def check(live_pts, live_gid):
        g = live_gid.astype(np.int32)
        for with_ids in (True, False):
            for meth, args, ora in (
                ("radius_batch", (queries, r),
                 tvo.radius_oracle(live_pts, queries, r, gid=g, with_ids=with_ids,
                                   device="cpu")),
                ("range_batch", (lo, hi),
                 tvo.range_oracle(live_pts, lo, hi, gid=g, with_ids=with_ids,
                                  device="cpu"))):
                got = getattr(teng, meth)(*args, with_ids=with_ids)
                _same(got, getattr(jeng, meth)(*args, with_ids=with_ids))
                _same(got, ora, retries=False)
                fb = "fallback_radius" if meth == "radius_batch" else "fallback_range"
                _same(getattr(teng, fb)(*args, with_ids=with_ids), ora, retries=False)

    try:
        check(pts, gid)
        ball = tvo.radius_oracle(pts, queries[:1], r[:1], device="cpu")
        assert ball.counts[0] >= 2, "vacuous: ball too small to delete from"
        dead = ball.ids[0, :min(3, int(ball.counts[0]))].astype(np.int64)
        for eng in (teng, jeng):
            eng.delete(dead.copy())
        mask = ~np.isin(gid, dead)
        check(pts[mask], gid[mask])
        new_ids = np.array([pts.shape[0] + 5, pts.shape[0] + 6], np.int64)
        new_pts = np.stack([queries[0] + 0.01, queries[0] - 0.01]).astype(np.float32)
        for eng in (teng, jeng):
            eng.upsert(new_ids.copy(), new_pts.copy())
        check(np.concatenate([pts[mask], new_pts]), np.concatenate([gid[mask], new_ids]))
        far = np.full((1, DIM), 1e6, np.float32)
        for eng in (teng, jeng):
            eng.upsert(new_ids[:1].copy(), far.copy())
        check(np.concatenate([pts[mask], far, new_pts[1:]]),
              np.concatenate([gid[mask], new_ids]))
    finally:
        teng.close()
        jeng.close()


# ---------------------------------------------------------------------------
# the server's verb endpoints against a kdtree_tpu server
# ---------------------------------------------------------------------------

N_SRV, MAX_BATCH = 4096, 64


@contextlib.contextmanager
def _pair(id_offset=0, max_delta_rows=None):
    """A reference and a port server over the same seeded problem."""
    kw = dict(problem=(SEED, DIM, N_SRV), k=K, max_batch=MAX_BATCH, id_offset=id_offset,
              max_delta_rows=max_delta_rows)
    js = jsrv.make_server(jlife.build_state(install_listeners=False, **kw), port=0,
                          max_wait_ms=1.0)
    ts = tsrv.make_server(tlife.build_state(device="cpu", **kw), port=0, max_wait_ms=1.0)
    started = []
    try:
        for s in (js, ts):
            s.start(warmup_buckets=[8, 64])
            started.append(s)
        yield js, ts
    finally:
        for s in started:
            s.stop()


def _post(srv, path, payload, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.server_address[1]}{path}",
        data=raw.encode() if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, body = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    body.pop("trace_id", None)
    return status, body


def _both(p, path, payload=None, raw=None):
    (sj, bj), (st, bt) = (_post(s, path, payload, raw) for s in p)
    assert sj == st, (path, sj, st, bj, bt)
    assert json.dumps(bt) == json.dumps(bj), (path, bj, bt)
    return st, bt


@pytest.fixture(scope="module")
def servers():
    with _pair(id_offset=1000) as p:
        yield p


@pytest.fixture(scope="module")
def cloud():
    pts = np.asarray(jgen(SEED, DIM, N_SRV))
    queries, scale = _data_queries(pts, 9, np.random.default_rng(11))
    return pts, queries, scale


def test_server_verb_endpoints_byte_identical(servers, cloud):
    pts, queries, scale = cloud
    lo = (queries - 0.06 * scale).astype(np.float32)
    hi = (queries + 0.06 * scale).astype(np.float32)
    r = float(0.05 * scale)
    st, body = _both(servers, "/v1/radius", {"queries": queries.tolist(), "r": r})
    assert st == 200 and sum(body["counts"]) > 0 and body["truncated"] is False
    ora = tvo.radius_oracle(pts, queries, r, device="cpu")
    assert body["counts"] == ora.counts.tolist()
    assert body["ids"] == [(ora.ids[q, :ora.counts[q]].astype(np.int64) + 1000).tolist()
                           for q in range(9)]
    per_query = (np.arange(9, dtype=np.float32) * 0.01 * scale).tolist()
    _both(servers, "/v1/radius", {"queries": queries.tolist(), "r": per_query})
    st, body = _both(servers, "/v1/range", {"lo": lo.tolist(), "hi": hi.tolist()})
    assert st == 200 and sum(body["counts"]) > 0
    st, body = _both(servers, "/v1/count", {"queries": queries.tolist(), "r": r})
    assert st == 200 and "ids" not in body and "distances" not in body
    _both(servers, "/v1/count", {"lo": lo.tolist(), "hi": hi.tolist()})
    # an expired deadline degrades to the verb brute force, alike
    st, body = _both(servers, "/v1/radius",
                     {"queries": queries[:3].tolist(), "r": r, "deadline_ms": 1e-6})
    assert body["degraded"] == "deadline"


def test_oversized_verb_request_goes_to_the_oracle_alike(servers, cloud):
    pts, _, scale = cloud
    big, _ = _data_queries(pts, MAX_BATCH + 36, np.random.default_rng(4))
    r = float(0.05 * scale)
    st, body = _both(servers, "/v1/radius", {"queries": big.tolist(), "r": r})
    assert st == 200 and body["degraded"] == "oversized"
    assert body["counts"] == tvo.radius_count_oracle(pts, big, r, device="cpu").tolist()
    _both(servers, "/v1/range", {"lo": (big - 5).tolist(), "hi": (big + 5).tolist()})
    _both(servers, "/v1/count", {"queries": big.tolist(), "r": r})


@pytest.mark.parametrize("path,payload", [
    ("/v1/radius", {"queries": [[0.0, 0.0, 0.0]]}),
    ("/v1/radius", {"queries": [[0.0, 0.0, 0.0]], "r": -1.0}),
    ("/v1/radius", {"queries": [[0.0, 0.0, 0.0]], "r": [1.0, 2.0]}),
    ("/v1/radius", {"queries": [[0.0, 0.0]], "r": 1.0}),
    ("/v1/radius", {"queries": [[0.0, 0.0, float("nan")]], "r": 1.0}),
    ("/v1/range", {"lo": [[0.0, 0.0, 0.0]]}),
    ("/v1/range", {"lo": [[0.0, 0.0, 0.0]], "hi": [[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]}),
    ("/v1/count", {"queries": [[0.0, 0.0, 0.0]], "r": 1.0, "lo": [[0.0] * 3],
                   "hi": [[1.0] * 3]}),
    ("/v1/count", {}),
    ("/v1/radius", {"queries": [[0.0, 0.0, 0.0]], "r": 1.0, "deadline_ms": 0}),
    ("/v1/range", None),
])
def test_verb_rejections_byte_identical(servers, path, payload):
    st, body = _both(servers, path, payload, raw="not json" if payload is None else None)
    assert st == 400 and body["error"]


def test_server_verbs_with_mutation_interleaved(cloud):
    pts, queries, scale = cloud
    r = float(0.05 * scale)
    lo = (queries - 0.04 * scale).astype(np.float32)
    hi = (queries + 0.04 * scale).astype(np.float32)
    with _pair(max_delta_rows=8) as p:
        st, body = _both(p, "/v1/radius", {"queries": queries.tolist(), "r": r})
        dead = body["ids"][0][:3]
        assert dead, "vacuous: nothing inside the ball to delete"
        _both(p, "/v1/delete", {"ids": dead})
        new_pts = np.stack([queries[0] + 0.01, queries[0] - 0.01]).astype(np.float32)
        _both(p, "/v1/upsert", {"ids": [N_SRV + 5, N_SRV + 6], "points": new_pts.tolist()})
        live = np.concatenate([pts, new_pts])
        live_gid = np.concatenate([np.arange(N_SRV), [N_SRV + 5, N_SRV + 6]]).astype(np.int32)
        keep = ~np.isin(live_gid, dead)
        for path, payload in (("/v1/radius", {"queries": queries.tolist(), "r": r}),
                              ("/v1/range", {"lo": lo.tolist(), "hi": hi.tolist()}),
                              ("/v1/count", {"queries": queries.tolist(), "r": r}),
                              ("/v1/count", {"lo": lo.tolist(), "hi": hi.tolist()})):
            st, body = _both(p, path, payload)
            assert st == 200
        assert body["counts"] == tvo.range_count_oracle(live[keep], lo, hi,
                                                        device="cpu").tolist()
        # cross the backlog: an epoch rebuild, then the same bytes again
        _both(p, "/v1/upsert", {"ids": list(range(N_SRV + 10, N_SRV + 16)),
                                "points": (queries[:6] + 0.02).tolist()})
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            eps = [_post(s, "/v1/knn", {"queries": [[0.0] * 3]}) and
                   json.loads(urllib.request.urlopen(
                       f"http://127.0.0.1:{s.server_address[1]}/healthz", timeout=30
                   ).read())["epoch"] for s in p]
            if eps == [1, 1]:
                break
            time.sleep(0.05)
        assert eps == [1, 1]
        st, body = _both(p, "/v1/radius", {"queries": queries.tolist(), "r": r})
        assert N_SRV + 10 in body["ids"][0]
