"""The port's mutable index against kdtree_tpu's and against the rebuild
oracle: the delta buffer, the merge, every write interleaving of
tests/test_mutable.py answered byte for byte like the reference's
MutableEngine and like a fresh index over the surviving points, writes
during a rebuild, queries across an epoch swap, and copy-on-write
tombstones (a snapshot taken before a delete answers as before)."""

from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.mutable import DeltaBuffer as JDelta
from kdtree_tpu.mutable import MutableEngine as JMutable
from kdtree_tpu.mutable import engine as jmeng
from kdtree_tpu.mutable import merge_rows as j_merge_rows
from kdtree_tpu.ops import morton as jmor
from kdtree_tpu.ops.generate import generate_points_rowwise as j_rowwise
from kdtree_tpu.serve.lifecycle import ServeEngine as JServe
from kdtree_tpu_torch.mutable import DeltaBuffer, MutableEngine, merge_rows
from kdtree_tpu_torch.mutable import engine as meng
from kdtree_tpu_torch.obs import flight as tflight
from kdtree_tpu_torch.obs.registry import get_registry
from kdtree_tpu_torch.ops.morton import build_morton, morton_view
from kdtree_tpu_torch.serve.engine import ServeEngine

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

DIM, N, K = 3, 512, 4
SEED = 7


@pytest.fixture(autouse=True)
def _reset_port_flight_rate_limit():
    """The port's process-wide flight recorder rate-limits auto-dumps per
    reason like the reference's; tests/conftest.py resets only the
    reference's, so this file resets the port's before every test."""
    tflight.recorder().reset_dump_rate_limit()
    yield


@pytest.fixture(scope="module")
def base_points():
    return np.array(j_rowwise(SEED, DIM, N))


@pytest.fixture(scope="module")
def queries():
    return np.array(j_rowwise(11, DIM, 8), dtype=np.float32)


def port_engine(points, **kw) -> MutableEngine:
    kw.setdefault("max_delta_rows", 1 << 30)
    kw.setdefault("max_delta_frac", 0.0)
    return MutableEngine(ServeEngine(build_morton(points, device="cpu"), K), **kw)


def ref_engine(points) -> JMutable:
    return JMutable(JServe(jmor.build_morton(jnp.asarray(points)), K),
                    max_delta_rows=1 << 30, max_delta_frac=0.0)


def oracle_answer(model, queries, k=K):
    """The rebuild-from-scratch oracle: a fresh Morton index over the
    surviving points (original ids preserved), queried through the same
    serving facade."""
    ids = np.array(sorted(model), dtype=np.int64)
    pts = np.stack([model[i] for i in ids.tolist()]).astype(np.float32)
    tree = morton_view(pts, gid=ids.astype(np.int32), n_real=int(ids.size),
                       device="cpu")
    d2, gids, _ = ServeEngine(tree, k).knn_batch(queries)
    return d2, gids


def assert_exact(eng, model, queries, tag=""):
    d2, ids, _ = eng.knn_batch(queries)
    # an index smaller than k answers (inf, -1) in the missing columns
    od2, oids = meng._pad_cols(*oracle_answer(model, queries), K)
    np.testing.assert_array_equal(ids, oids, err_msg=f"ids differ ({tag})")
    np.testing.assert_array_equal(d2, od2, err_msg=f"d2 differ ({tag})")


def wait_epoch(eng, epoch=1, timeout=120.0):
    deadline = time.monotonic() + timeout
    while eng.epoch < epoch and time.monotonic() < deadline:
        time.sleep(0.02)
    assert eng.epoch == epoch, eng.stats()


def _counter(key):
    return get_registry().snapshot()["counters"].get(key, 0.0)


# ---------------------------------------------------------------------------
# units: delta buffer, merge, mask ladder, morton_view
# ---------------------------------------------------------------------------


def test_delta_buffer_matches_reference():
    a, b = JDelta(dim=2, min_capacity=2), DeltaBuffer(dim=2, min_capacity=2, device="cpu")
    rng = np.random.default_rng(0)
    ops = [("put", 5, [1.0, 2.0]), ("put", 5, [3.0, 4.0]), ("drop", 5, None),
           ("drop", 5, None)]
    ops += [("put", 100 + i, rng.uniform(-9, 9, 2)) for i in range(70)]
    ops += [("drop", 100 + i, None) for i in range(0, 70, 3)]
    for op, gid, p in ops:
        if op == "put":
            assert a.put(gid, np.asarray(p)) == b.put(gid, np.asarray(p))
        else:
            assert a.drop(gid) == b.drop(gid)
        assert (a.capacity, a.rows, a.holes) == (b.capacity, b.rows, b.holes)
    for x, y in zip(a.items(), b.items()):
        np.testing.assert_array_equal(x, y)
    (ap, ag), (bp, bg) = a.view(), b.view()
    np.testing.assert_array_equal(np.asarray(ap), bp.numpy())
    np.testing.assert_array_equal(ag, bg)
    assert b.get(101) is not None and b.get(100) is None and 102 in b


def test_delta_view_does_not_alias_the_buffer():
    buf = DeltaBuffer(dim=2, device="cpu")
    buf.put(1, np.array([1.0, 1.0]))
    pts_a, gid_a = buf.view()
    buf.put(2, np.array([2.0, 2.0]))
    buf.drop(1)
    buf.refresh()
    pts_b, gid_b = buf.view()
    # the old view still describes the old state: torch.from_numpy would
    # share the master buffer, and the copy before it is what prevents it
    assert gid_a.tolist()[:2] == [1, -1] and gid_b.tolist()[:2] == [-1, 2]
    assert pts_a[0].tolist() == [1.0, 1.0] and torch.isinf(pts_a[1]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_rows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    d2 = rng.integers(0, 6, (9, 12)).astype(np.float32)  # many ties
    d2[rng.random(d2.shape) < 0.2] = np.inf
    ids = rng.permutation(200)[:108].reshape(9, 12).astype(np.int32)
    ids[np.isinf(d2)] = -1
    for k in (1, 5, 12, 20):
        for x, y in zip(j_merge_rows(d2, ids, k), merge_rows(d2, ids, k)):
            np.testing.assert_array_equal(x, y)


def test_mask_ladder_matches_reference():
    assert meng._MASK_PAD_BUCKETS == jmeng._MASK_PAD_BUCKETS
    for n in (1, 7, 8, 9, 64, 65, 512, 513, 4096, 4097, 10000):
        assert meng._mask_bucket(n) == jmeng._mask_bucket(n)


def test_morton_view_matches_reference(base_points):
    rng = np.random.default_rng(5)
    gid = rng.permutation(10 * N)[:N].astype(np.int32)
    jt = jmor.morton_view(jnp.asarray(base_points), gid=jnp.asarray(gid), bucket_cap=32)
    tt = morton_view(base_points, gid=gid, bucket_cap=32, device="cpu")
    assert (tt.n_real, tt.num_levels) == (jt.n_real, jt.num_levels) == (N, tt.num_levels)
    for name in ("node_lo", "node_hi", "bucket_pts", "bucket_gid"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), err_msg=name)


# ---------------------------------------------------------------------------
# exactness: interleavings vs the reference engine and the rebuild oracle
# ---------------------------------------------------------------------------


def _steps(name, points, probe):
    """The write sequence of one scenario: (op, ids, points or None)
    tuples; ``probe`` answers the current top-k of the pristine index."""
    rng = np.random.default_rng(len(name))
    if name == "insert":
        return [("upsert", np.arange(N, N + 24),
                 rng.uniform(-100, 100, (24, DIM)).astype(np.float32))]
    if name == "move":
        return [("upsert", np.array([1, 50, 200]),
                 rng.uniform(-100, 100, (3, DIM)).astype(np.float32))]
    if name == "mixed":
        ins = rng.uniform(-100, 100, (5, DIM)).astype(np.float32)
        return [("upsert", np.arange(N, N + 5), ins),
                ("upsert", np.array([1]), ins[:1] + 1),
                ("delete", np.array([3, N], dtype=np.int64), None),
                ("delete", np.array([1]), None)]
    if name == "delete-kth":
        return [("delete", np.array([probe[0, K - 1]]), None)]
    if name == "delete-first":
        return [("delete", np.array([probe[0, 0]]), None),
                ("delete", np.unique(probe[1:4, 0]), None)]
    if name == "delete-below-k":
        return [("delete", np.arange(N - 2), None)]
    assert name == "churn"
    out = []
    for i in range(8):
        out.append(("upsert", np.array([N + 1000 + i]),
                    rng.uniform(-100, 100, (1, DIM)).astype(np.float32)))
        out.append(("delete", np.array([N + 1000 + i]), None))
    return out


@pytest.mark.parametrize("scenario", ["insert", "move", "mixed", "delete-kth",
                                      "delete-first", "delete-below-k", "churn"])
def test_interleavings_match_reference_and_oracle(scenario, base_points, queries):
    te, je = port_engine(base_points), ref_engine(base_points)
    model = {i: base_points[i].copy() for i in range(N)}
    _, probe, _ = te.knn_batch(queries)
    try:
        for op, ids, pts in _steps(scenario, base_points, probe):
            if op == "upsert":
                assert te.upsert(ids, pts) == je.upsert(ids, pts)
                model.update(zip(ids.tolist(), pts))
            else:
                assert te.delete(ids) == je.delete(ids)
                for i in ids.tolist():
                    model.pop(i, None)
            td, ti, _ = te.knn_batch(queries)
            jd, ji, _ = je.knn_batch(queries)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(td, jd)
            assert_exact(te, model, queries, f"{scenario} after {op}")
            fd, fi = te.fallback_knn(queries, K)
            jfd, jfi = je.fallback_knn(queries, K)
            np.testing.assert_array_equal(fi, jfi)
            np.testing.assert_array_equal(fd, jfd)
            assert te.stats() == je.stats()
            for a, b in zip(te.bounds(), je.bounds()):
                np.testing.assert_array_equal(a, b)
    finally:
        te.close()
        je.close()


def test_tombstone_at_k_boundary_runs_the_correction(base_points, queries):
    eng = port_engine(base_points)
    model = {i: base_points[i].copy() for i in range(N)}
    before = _counter("kdtree_mutable_corrections_total")
    _, ids, _ = eng.knn_batch(queries)
    victim = int(ids[0, K - 1])
    eng.delete(np.array([victim]))
    model.pop(victim)
    assert_exact(eng, model, queries, "k-th hit deleted")
    assert _counter("kdtree_mutable_corrections_total") > before
    eng.close()


def test_snapshot_before_delete_answers_as_before(base_points, queries):
    """Copy-on-write tombstones: the masked storage a query snapshot holds
    never changes under it. An in-place write (index_put_ on the views of
    the tree's own storage) would tombstone the live tree and the old
    snapshot alike, and fail here."""
    eng = port_engine(base_points)
    tree = eng.tree
    pts_before = tree.bucket_pts.clone()
    want = eng._masked_main_knn(queries, eng._snapshot(), K)
    snap0 = eng._snapshot()
    victims = np.unique(want[1][:, 0])
    eng.delete(victims)
    snap1 = eng._snapshot()
    eng.delete(np.unique(want[1][:, 1]))
    for x, y in zip(eng._masked_main_knn(queries, snap0, K), want):
        np.testing.assert_array_equal(x, y)
    # the snapshot taken between the two deletes sees the first one only
    d1, i1 = eng._masked_main_knn(queries, snap1, K)
    assert not np.isin(i1, victims).any() and np.isin(i1, want[1][:, 1]).any()
    assert torch.equal(tree.bucket_pts, pts_before), "the tree's own storage was written"
    eng.close()


def test_delta_padding_never_leaks_a_real_id():
    eng = port_engine(np.arange(30.0).reshape(10, 3).astype(np.float32))
    cap = eng._state.delta.capacity
    ids = np.arange(100, 100 + cap)
    eng.upsert(ids, np.random.default_rng(7).uniform(-100, 100, (cap, 3)).astype(np.float32))
    assert eng._state.delta.capacity == cap
    eng.delete(ids[:-1])
    d2, got = eng._delta_knn(np.zeros((8, 3), np.float32), eng._snapshot(), k=4)
    assert got[0, 0] == ids[-1] and d2[0, 0] < np.inf
    assert got[0, 1:].tolist() == [-1, -1, -1] and np.isinf(d2[0, 1:]).all()
    eng.close()


def test_write_validation():
    eng = port_engine(np.arange(30.0).reshape(10, 3).astype(np.float32))
    with pytest.raises(ValueError, match="duplicate"):
        eng.upsert(np.array([1, 1]), np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="int32"):
        eng.upsert(np.array([2**31]), np.zeros((1, 3), np.float32))
    with pytest.raises(ValueError, match=r"\[0,"):
        eng.delete(np.array([-1]))
    with pytest.raises(ValueError, match="3-D"):
        eng.upsert(np.array([1]), np.zeros((1, 2), np.float32))
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.delete(np.array([1]))


def test_configured_k_survives_deletes_below_k(base_points, queries):
    pts = base_points[:8]
    eng = port_engine(pts)
    eng.delete(np.arange(6))
    assert eng.k == K and eng.k_effective == 2
    d2, ids, _ = eng.knn_batch(queries)
    assert ids.shape[1] == K and (ids[:, 2:] == -1).all() and np.isinf(d2[:, 2:]).all()
    od2, oids = oracle_answer({i: pts[i] for i in (6, 7)}, queries, k=2)
    np.testing.assert_array_equal(ids[:, :2], oids)
    np.testing.assert_array_equal(d2[:, :2], od2)
    fd2, fids = eng.fallback_knn(queries, K)
    np.testing.assert_array_equal(fids, ids)
    np.testing.assert_array_equal(fd2, d2)
    eng.close()


# ---------------------------------------------------------------------------
# epoch rebuild
# ---------------------------------------------------------------------------


def test_backlog_triggers_exactly_one_rebuild(base_points, queries):
    eng = port_engine(base_points, max_delta_rows=16)
    model = {i: base_points[i].copy() for i in range(N)}
    rng = np.random.default_rng(2)
    before = _counter("kdtree_mutable_rebuilds_total")
    ids = np.arange(N, N + 16)
    pts = rng.uniform(-100, 100, (16, DIM)).astype(np.float32)
    eng.upsert(ids, pts)
    model.update(zip(ids.tolist(), pts))
    wait_epoch(eng)
    st = eng.stats()
    assert st["delta_rows"] == 0 and st["tombstones"] == 0 and st["n"] == N + 16
    assert _counter("kdtree_mutable_rebuilds_total") == before + 1
    assert_exact(eng, model, queries, "post-swap")
    eng.upsert(np.array([N + 100]), rng.uniform(-100, 100, (1, DIM)).astype(np.float32))
    time.sleep(0.2)
    assert eng.epoch == 1 and _counter("kdtree_mutable_rebuilds_total") == before + 1
    eng.close()


def test_writes_during_rebuild_replay_onto_new_epoch(base_points, queries):
    eng = port_engine(base_points, max_delta_rows=8)
    model = {i: base_points[i].copy() for i in range(N)}
    rng = np.random.default_rng(3)
    orig = eng._compact
    gate = threading.Event()

    def slow_compact(*a, **kw):
        gate.wait(timeout=30)
        return orig(*a, **kw)

    eng._compact = slow_compact
    ids = np.arange(N, N + 8)
    pts = rng.uniform(-100, 100, (8, DIM)).astype(np.float32)
    eng.upsert(ids, pts)
    model.update(zip(ids.tolist(), pts))
    assert eng.stats()["rebuilding"]
    eng.upsert(np.array([N + 50]), np.array([[55.0, 55.0, 55.0]], np.float32))
    model[N + 50] = np.array([55.0, 55.0, 55.0], np.float32)
    eng.delete(np.array([int(ids[0]), 9]))
    model.pop(int(ids[0])), model.pop(9)
    assert_exact(eng, model, queries, "mid-rebuild (live overlay)")
    gate.set()
    wait_epoch(eng)
    assert_exact(eng, model, queries, "post-swap with journal replay")
    st = eng.stats()
    assert st["delta_rows"] == 1 and st["tombstones"] == 2
    eng.close()


def test_epoch_swap_under_concurrent_queries_every_answer_exact(base_points, queries):
    eng = port_engine(base_points)
    model = {i: base_points[i].copy() for i in range(N)}
    rng = np.random.default_rng(4)
    ids = np.arange(N, N + 12)
    pts = rng.uniform(-100, 100, (12, DIM)).astype(np.float32)
    eng.upsert(ids, pts)
    model.update(zip(ids.tolist(), pts))
    eng.delete(np.array([5, 6]))
    model.pop(5), model.pop(6)
    od2, oids = oracle_answer(model, queries)
    eng.max_delta_rows = eng.stats()["backlog"]
    orig = eng._compact

    def slow_compact(*a, **kw):
        time.sleep(0.3)  # queries overlap the rebuild window
        return orig(*a, **kw)

    eng._compact = slow_compact
    stop = threading.Event()
    failures, counts = [], [0, 0, 0]
    epochs = set()

    def qworker(slot):
        while not stop.is_set():
            d2, rids, _ = eng.knn_batch(queries)
            epochs.add(eng.last_answer_epoch)
            if not (np.array_equal(d2, od2) and np.array_equal(rids, oids)):
                failures.append((slot, rids.tolist()))
                return
            counts[slot] += 1

    threads = [threading.Thread(target=qworker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    eng.upsert(ids[:1], pts[:1])  # a content no-op that crosses the backlog
    wait_epoch(eng)
    time.sleep(0.1)
    stop.set()
    for t in threads:
        t.join()
    assert not failures, failures[:1]
    assert all(c > 0 for c in counts) and epochs == {0, 1}, (counts, epochs)
    assert_exact(eng, model, queries, "steady state after swap")
    eng.close()


def test_churn_holes_count_toward_backlog_and_compact(base_points, queries):
    eng = port_engine(base_points, max_delta_rows=16)
    model = {i: base_points[i].copy() for i in range(N)}
    rng = np.random.default_rng(8)
    for i in range(16):
        gid = N + 1000 + i
        eng.upsert(np.array([gid]), rng.uniform(-100, 100, (1, DIM)).astype(np.float32))
        eng.delete(np.array([gid]))
        if i == 7:
            st = eng.stats()
            assert st["delta_rows"] == 0 and st["backlog"] == 8
    wait_epoch(eng)
    st = eng.stats()
    assert st["delta_rows"] == 0 and st["backlog"] <= 1 and eng._state.delta.holes == 0
    assert_exact(eng, model, queries, "after churn compaction")
    eng.close()


def test_requested_k_survives_growth_past_bootstrap_size():
    seed = np.arange(15.0).reshape(5, 3).astype(np.float32)
    eng = MutableEngine(ServeEngine(build_morton(seed, device="cpu"), 16),
                        max_delta_rows=40, max_delta_frac=0.0, requested_k=16)
    assert eng.k == 16 and eng.k_effective == 5
    q = np.zeros((1, 3), dtype=np.float32)
    d2, ids, _ = eng.knn_batch(q)
    assert d2.shape == (1, 16) and (ids[:, 5:] == -1).all() and np.isinf(d2[:, 5:]).all()
    eng.upsert(np.arange(5, 45),
               np.random.default_rng(6).uniform(-100, 100, (40, 3)).astype(np.float32))
    wait_epoch(eng)
    assert eng.k == 16 and eng.k_effective == 16
    assert (eng.knn_batch(q)[1] >= 0).all()
    eng.close()


def test_rebuild_impact_join_matches_reference():
    from kdtree_tpu.obs.history import MetricHistory as JHistory
    from kdtree_tpu_torch.obs.history import MetricHistory

    key = 'kdtree_serve_request_seconds{phase="total"}'
    uppers = ("0.01", "0.05", "0.1", "0.5", "+Inf")
    hists = (JHistory(), MetricHistory())
    cum = np.zeros(5)
    for step in range(12):
        cum += [3, 1, 0, 0, 0] if step < 6 else [1, 1, 2, 2, 0]
        snap = {"histograms": {key: {"count": float(cum.sum()), "sum": step * 0.3,
                                     "buckets": dict(zip(uppers, np.cumsum(cum).tolist()))}}}
        for h in hists:
            h.record(snap, ts=1000.0 + step)
    for t0, t1 in ((1005.0, 1011.0), (1002.0, 1004.0), (1011.0, 1011.0)):
        assert meng.rebuild_impact(hists[1], t0, t1) == \
            jmeng.rebuild_impact(hists[0], t0, t1)
