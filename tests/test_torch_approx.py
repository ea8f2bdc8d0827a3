"""The recall dial of the port against kdtree_tpu's, on the CPU, on the same
seeded tree: bounded-visit k-NN byte-equal at every cap of the sweep
ladder, monotone recall, the full cap equal to the exact engine, answers
exact over the visited points, recall@k, cap resolution, the harness's
recall column and calibration, the calibration's round trip to every
serving bucket, the ladder, the verbs under a visit cap, and the serving
front: the gear echo, the 400 text, the ladder stepping down and back up,
the SLO gauge, the online recall sampler, and an approximate /v1/knn
answer byte-equal to a kdtree_tpu server's."""

from __future__ import annotations

import functools
import json
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu import approx as japprox
from kdtree_tpu import verbs as jverbs
from kdtree_tpu.approx import recall as jrecall
from kdtree_tpu.ops import tile_query as jtq
from kdtree_tpu.ops.generate import generate_points_rowwise as jgen
from kdtree_tpu.ops.generate import generate_queries as jgenq
from kdtree_tpu.ops.morton import build_morton as jbuild
from kdtree_tpu.serve import lifecycle as jlife
from kdtree_tpu.serve import server as jsrv
from kdtree_tpu_torch import approx as tapprox
from kdtree_tpu_torch import obs as tobs
from kdtree_tpu_torch import tuning as ttuning
from kdtree_tpu_torch.approx import recall as trecall
from kdtree_tpu_torch.approx.ladder import GEARS, DegradationLadder, gear_token
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.obs import flight as tflight
from kdtree_tpu_torch.obs import history as thistory
from kdtree_tpu_torch.obs import slo as tslo
from kdtree_tpu_torch.ops import tile_query as ttq
from kdtree_tpu_torch.ops._arith import sq_dist
from kdtree_tpu_torch.serve import engine as tlife
from kdtree_tpu_torch.serve import server as tsrv
from kdtree_tpu_torch.serve.faults import FaultSet
from kdtree_tpu_torch.verbs import device as tv
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

torch.set_num_threads(1)

SEED, DIM, N, NQ, K = 7, 3, 8000, 512, 8


@functools.lru_cache(maxsize=None)
def _setup():
    """(reference tree, port tree, host points by id, host queries)."""
    raw = jgen(SEED, DIM, N)
    jt = jbuild(raw)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    return jt, tt, np.array(raw), np.array(jgenq(SEED + 1, DIM, NQ))


@pytest.fixture(autouse=True)
def _reset_port_flight_rate_limit():
    tflight.recorder().reset_dump_rate_limit()
    yield


def _plans(jt, q, k):
    """The same explicit plan in both packages (the plain scans)."""
    jp = jtq.plan_tiled(q, DIM, jt.n_real, jt.num_buckets, jt.bucket_size, k,
                        use_pallas=False)
    tp = ttq.plan_tiled(q, DIM, jt.n_real, jt.num_buckets, jt.bucket_size, k,
                        use_kernel=False)
    assert (jp.tile, jp.cmax, jp.seeds, jp.v, jp.tb, jp.qbatch) == \
        (tp.tile, tp.cmax, tp.seeds, tp.v, tp.tb, tp.qbatch)
    assert tp.source == "explicit"
    return jp, tp


def test_approx_byte_equal_at_every_cap_and_exact_at_full_cap():
    jt, tt, _, qs = _setup()
    jp, tp = _plans(jt, NQ, K)
    caps = trecall.default_caps(tt.num_buckets)
    assert caps == jrecall.default_caps(jt.num_buckets) and len(caps) >= 4
    for cap in caps:
        jd, ji = japprox.morton_knn_approx(jt, jnp.asarray(qs), k=K,
                                           visit_cap=cap, plan=jp)
        td, ti = tapprox.morton_knn_approx(tt, qs, k=K, visit_cap=cap, plan=tp)
        assert np.asarray(jd).tobytes() == td.numpy().tobytes(), cap
        assert np.asarray(ji).tobytes() == ti.numpy().tobytes(), cap
    ed, ei = ttq.morton_knn_tiled(tt, qs, k=K, plan=tp)
    assert torch.equal(ed, td) and torch.equal(ei, ti)


def test_recall_monotone_in_visit_cap():
    _, tt, _, qs = _setup()
    _, exact_ids = ttq.morton_knn_tiled(tt, qs, k=K)
    prev = 0.0
    for cap in (1, 2, 4, 8, 16, tt.num_buckets):
        _, ids = tapprox.morton_knn_approx(tt, qs, k=K, visit_cap=cap)
        r = tapprox.recall_at_k(ids, exact_ids)
        assert r >= prev - 1e-12, (cap, r, prev)
        prev = r
    assert prev == 1.0


def test_approx_answers_are_exact_over_visited_points():
    _, tt, pts, qs = _setup()
    d2, ids = tapprox.morton_knn_approx(tt, qs, k=4, visit_cap=2)
    real = ids >= 0
    p = torch.from_numpy(pts)[ids.clamp_min(0).long()]
    want = sq_dist(torch.from_numpy(qs)[:, None, :], p)
    assert torch.equal(d2[real], want[real])
    _, exact_ids = ttq.morton_knn_tiled(tt, qs, k=4)
    assert tapprox.recall_at_k(ids, exact_ids) < 1.0  # the cap did cut


def test_recall_at_k_padding_and_empty_truth():
    exact = np.array([[1, 2, -1], [-1, -1, -1]])
    found = np.array([[1, -1, -1], [-1, -1, -1]])
    got = tapprox.recall_at_k(found, exact)
    assert got == jrecall.recall_at_k(found, exact) == pytest.approx(0.75)
    assert tapprox.recall_at_k(torch.from_numpy(found), torch.from_numpy(exact)) == got
    with pytest.raises(ValueError):
        tapprox.recall_at_k(np.zeros((2, 3)), np.zeros((2, 4)))


@pytest.mark.parametrize("args,profile", [
    ((None, 256, 8, 64), None),                       # exact
    ((1.0, 256, 8, 64), None),                        # 1.0 spells exact
    ((0.9, 256, 8, 64), {"recall_caps": {"0.9": 12, "0.99": 40, "0.5": 4}}),
    ((0.95, 256, 8, 64), {"recall_caps": {"0.9": 12, "0.99": 40, "0.5": 4}}),
    ((0.4, 256, 8, 64), {"recall_caps": {"0.9": 12, "0.99": 40, "0.5": 4}}),
    ((0.99, 256, 8, 64), None),                       # heuristic
    ((0.9, 256, 8, 64), None),
    ((0.5, 256, 200, 16), None),                      # the k floor
    ((0.99, 2, 8, 64), None),                         # a cap of every bucket
    ((0.9, 256, 8, 64), {"recall_caps": {"bogus": 3, "0.95": "x", "0.99": True}}),
    ((0.9, 256, 8, 64), {"recall_caps": {"0.9": 1000}}),
])
def test_resolve_visit_cap_matches_reference(args, profile):
    got = tapprox.resolve_visit_cap(*args, profile=profile)
    assert got == japprox.resolve_visit_cap(*args, profile=profile)


def test_parse_recall_target_shared_wire_contract():
    for raw in (None, 1.0, 1, 0.9, 0.0, -0.5, 1.5, "0.9", True, False):
        assert tapprox.parse_recall_target(raw) == japprox.parse_recall_target(raw), raw
    assert tapprox.RECALL_TARGET_ERROR == japprox.RECALL_TARGET_ERROR
    assert tapprox.DEFAULT_TARGETS == japprox.DEFAULT_TARGETS


def test_sweep_recall_column_and_calibration_match_reference():
    jt, tt, _, qs = _setup()
    caps = (2, 8, 16, tt.num_buckets)
    jb = jrecall.sweep_recall(jt, jnp.asarray(qs), k=K, caps=caps)
    tb = trecall.sweep_recall(tt, qs, k=K, caps=caps)
    assert [r["visit_cap"] for r in tb["curve"]] == list(caps)
    assert [r["recall"] for r in tb["curve"]] == [r["recall"] for r in jb["curve"]]
    recalls = [r["recall"] for r in tb["curve"]]
    assert recalls == sorted(recalls) and recalls[-1] == 1.0 and recalls[0] < 1.0
    for key in ("recall_version", "n", "q", "k", "nbp"):
        assert tb[key] == jb[key], key
    targets = (0.5, 0.9, 0.99, 1.0)
    assert tapprox.calibrate_caps(tb["curve"], targets) == \
        japprox.calibrate_caps(jb["curve"], targets)
    assert tapprox.calibrate_caps([{"visit_cap": 2, "recall": 0.4},
                                   {"visit_cap": 8, "recall": 0.8}],
                                  targets=(0.5, 0.99)) == {"0.5": 8}


def test_calibration_roundtrips_to_serving_buckets(monkeypatch, tmp_path):
    _, tt, _, qs = _setup()
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", str(tmp_path))
    block = trecall.sweep_recall(tt, qs, k=K, caps=(4, 16, tt.num_buckets))
    out = trecall.persist_calibration(tt, NQ, DIM, K, block)
    assert out["persisted"] and out["path"].startswith(str(tmp_path))
    for q in (8, 16, 32, 64, 128, 256, 512):
        sig = ttuning.make_signature(q, DIM, tt.n_real, K, tt.bucket_size,
                                     tt.num_buckets, backend="cpu")
        prof = ttuning.profile_for(sig)
        assert prof is not None and prof["recall_caps"] == out["recall_caps"], q
        # the same JSON profile resolves to the same cap in both packages
        for target in (0.5, 0.9, 0.99):
            got = tapprox.resolve_visit_cap(target, tt.num_buckets, K,
                                            tt.bucket_size, profile=prof)
            assert got == japprox.resolve_visit_cap(
                target, tt.num_buckets, K, tt.bucket_size, profile=prof)
    # a CUDA signature is another profile: nothing resolves across
    cuda_sig = ttuning.make_signature(8, DIM, tt.n_real, K, tt.bucket_size,
                                      tt.num_buckets, backend="cuda")
    assert ttuning.profile_for(cuda_sig) is None
    # later feedback merges over the calibration and keeps it
    ttuning.default_store().record(sig, cmax=64)
    assert ttuning.profile_for(sig)["recall_caps"] == out["recall_caps"]


def test_approx_run_records_no_feedback(monkeypatch, tmp_path):
    _, tt, _, qs = _setup()
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", str(tmp_path))
    tapprox.morton_knn_approx(tt, qs[:64], k=K, visit_cap=2)
    assert list(tmp_path.iterdir()) == []
    ttq.morton_knn_tiled(tt, qs[:64], k=K)  # the exact run does record
    assert len(list(tmp_path.iterdir())) == 1


def test_ladder_steps_down_and_recovers_with_hysteresis():
    lad = DegradationLadder(slo_engine=None, down_after=2, up_after=3)
    assert lad.gear() == 0
    assert lad.tick(burning=True) == 0
    assert lad.tick(burning=True) == 1
    assert lad.tick(burning=True) == 1
    assert lad.tick(burning=True) == 2
    for _ in range(10):
        lad.tick(burning=True)
    assert lad.gear() == len(GEARS) - 1 and lad.spec().brute
    assert lad.tick(burning=False) == len(GEARS) - 1
    assert lad.tick(burning=False) == len(GEARS) - 1
    assert lad.tick(burning=False) == len(GEARS) - 2
    for _ in range(3 * len(GEARS)):
        lad.tick(burning=False)
    assert lad.gear() == 0


def test_ladder_disabled_never_shifts_and_gauges_export():
    reg = tobs.get_registry()
    lad = DegradationLadder(slo_engine=None, enabled=False)
    for _ in range(10):
        assert lad.tick(burning=True) == 0
    on = DegradationLadder(slo_engine=None, down_after=1)
    on.tick(burning=True)
    snap = reg.snapshot()
    assert snap["gauges"]["kdtree_recall_gear"] == 1.0
    assert snap["gauges"]["kdtree_recall_estimate"] == pytest.approx(0.99)
    assert snap["counters"][
        'kdtree_recall_ladder_transitions_total{to="approx-0.99"}'] >= 1


def test_gear_tokens_match_reference():
    from kdtree_tpu.approx import ladder as jladder

    assert [tuple(g) for g in GEARS] == [tuple(g) for g in jladder.GEARS]
    assert [gear_token(g) for g in GEARS] == [jladder.gear_token(g) for g in jladder.GEARS]
    assert [gear_token(g) for g in GEARS] == [None, "approx:0.99", "approx:0.9",
                                              "brute-deadline"]


def _same_verb(a, b):
    a, b = tv.trim_result(a), tv.trim_result(b)
    assert np.array_equal(a.counts, b.counts)
    assert a.truncated == b.truncated
    for x, y in ((a.ids, b.ids), (a.d2, b.d2)):
        assert (x is None) == (y is None)
        if y is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("visit_cap", [1, 2, 4, 1 << 20])
def test_verbs_with_visit_cap_match_reference(visit_cap):
    jt, tt, pts, qs = _setup()
    q = qs[:40]
    r = np.full(40, 12.0, np.float32)
    lo, hi = q - 10.0, q + 10.0
    exact = tv.radius_search(tt, q, r)
    got = tv.radius_search(tt, q, r, visit_cap=visit_cap)
    _same_verb(got, jverbs.radius_search(jt, q, r, visit_cap=visit_cap))
    _same_verb(tv.radius_search(tt, q, r, visit_cap=visit_cap, with_ids=False),
               jverbs.radius_search(jt, q, r, visit_cap=visit_cap, with_ids=False))
    _same_verb(tv.range_search(tt, lo, hi, visit_cap=visit_cap),
               jverbs.range_search(jt, lo, hi, visit_cap=visit_cap))
    _same_verb(tv.range_search(tt, lo, hi, visit_cap=visit_cap, with_ids=False),
               jverbs.range_search(jt, lo, hi, visit_cap=visit_cap, with_ids=False))
    # a sound lower bound, flagged when something was cut
    assert (got.counts <= exact.counts).all() and int(exact.counts.sum()) > 0
    if visit_cap <= 2:
        assert got.truncated and (got.counts < exact.counts).any()
    if visit_cap >= tt.num_buckets:
        assert not got.truncated
        _same_verb(got, exact)


# ---------------------------------------------------------------------------
# the serving front
# ---------------------------------------------------------------------------


def _post(httpd, path, payload, timeout=120.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{httpd.server_address[1]}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(httpd, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{httpd.server_address[1]}{path}", timeout=30) as r:
        return r.read().decode()


def _calibrate(monkeypatch, tmp_path, reference=False):
    """Sweep and persist a calibration (k=4) into a fresh store of the
    port, and of the reference too when asked."""
    jt, tt, _, qs = _setup()
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", str(tmp_path / "port"))
    caps = (2, 4, 8, 16, 24, tt.num_buckets)  # every default target truncates
    tb = trecall.sweep_recall(tt, qs, k=4, caps=caps)
    out = trecall.persist_calibration(tt, NQ, DIM, 4, tb)
    if reference:
        monkeypatch.setenv("KDTREE_TPU_PLAN_CACHE", str(tmp_path / "ref"))
        jb = jrecall.sweep_recall(jt, jnp.asarray(qs), k=4, caps=caps)
        jout = jrecall.persist_calibration(jt, NQ, DIM, 4, jb)
        assert jout["recall_caps"] == out["recall_caps"]
    return out["recall_caps"]


@pytest.fixture()
def dial_server(monkeypatch, tmp_path):
    """A port server with a persisted calibration and the ladder armed;
    the sampler ticks once at start and then not for an hour, so the
    tests drive the ladder themselves."""
    _, tt, _, _ = _setup()
    cal = _calibrate(monkeypatch, tmp_path)
    hist = thistory.MetricHistory()
    engine = tslo.SloEngine(specs=tslo.recall_specs(), history=hist)
    monkeypatch.setenv("KDTREE_TPU_HISTORY_PERIOD_S", "3600")
    state = tlife.build_state(tree=tt, k=4, max_batch=64, ladder_enabled=True)
    state.slo_engine = engine
    faults = FaultSet("")
    httpd = tsrv.make_server(state, port=0, max_wait_ms=1.0, faults=faults)
    httpd.start(warmup_buckets=[8])
    deadline = time.monotonic() + 30
    while not hist.samples() and time.monotonic() < deadline:
        time.sleep(0.01)  # the start tick has run: no other tick races ours
    try:
        yield httpd, faults, cal
    finally:
        httpd.stop()


def test_recall_target_echoes_gear_not_degraded(dial_server):
    httpd, _, cal = dial_server
    q = [[0.5, 0.5, 0.5], [0.1, 0.9, 0.2]]
    assert "0.5" in cal
    st, body = _post(httpd, "/v1/knn", {"queries": q, "k": 4, "recall_target": 0.5})
    assert st == 200 and body["degraded"] is None and body["gear"] == "approx:0.5"
    for payload in ({"queries": q, "k": 4}, {"queries": q, "k": 4, "recall_target": 1.0}):
        st, body = _post(httpd, "/v1/knn", payload)
        assert st == 200 and "gear" not in body
    health = json.loads(_get(httpd, "/healthz"))
    assert health["ladder"] == {"gear": 0, "name": "exact", "recall_target": None}


def test_recall_target_validation_400_reference_text(dial_server):
    httpd, _, _ = dial_server
    for path, base in (("/v1/knn", {"queries": [[0.1, 0.2, 0.3]]}),
                       ("/v1/radius", {"queries": [[0.1, 0.2, 0.3]], "r": 1.0}),
                       ("/v1/count", {"lo": [[0.0] * 3], "hi": [[1.0] * 3]})):
        for bad in (0.0, -0.5, 1.5, "0.9", True):
            st, body = _post(httpd, path, dict(base, recall_target=bad))
            assert st == 400 and body["error"] == japprox.RECALL_TARGET_ERROR, (path, bad)


def test_ladder_steps_down_and_recovers(dial_server):
    """Ticked by hand: two burning ticks per gear down to approx-0.99
    (ladder-forced answers flagged degraded), then brute-deadline, then
    back up one gear per five quiet ticks."""
    httpd, _, _ = dial_server
    lad = httpd.ladder
    q = {"queries": [[0.4, 0.4, 0.4]], "k": 2}
    lad.tick(burning=True)
    assert lad.tick(burning=True) == 1
    st, body = _post(httpd, "/v1/knn", q)
    assert st == 200 and body["degraded"] == "approx:0.99" == body["gear"]
    # a request asking for less than the ladder keeps its own contract
    st, body = _post(httpd, "/v1/knn", dict(q, recall_target=0.5))
    assert body["gear"] == "approx:0.5" and body["degraded"] is None
    for _ in range(4):
        lad.tick(burning=True)
    assert lad.gear() == 3 and lad.spec().brute
    st, body = _post(httpd, "/v1/knn", q)
    assert body["degraded"] == "brute-deadline" == body["gear"]
    st, body = _post(httpd, "/v1/radius", {"queries": [[0.4, 0.4, 0.4]], "r": 5.0})
    assert st == 200 and body["degraded"] == "brute-deadline"
    assert json.loads(_get(httpd, "/healthz"))["ladder"]["name"] == "brute-deadline"
    for _ in range(15):
        lad.tick(burning=False)
    assert lad.gear() == 0
    st, body = _post(httpd, "/v1/knn", q)
    assert body["degraded"] is None and "gear" not in body
    ring = json.loads(_get(httpd, "/debug/flight"))["events"]
    shifts = [e for e in ring if e.get("type") == "ladder.shift"]
    assert [e["to"] for e in shifts][:3] == ["approx-0.99", "approx-0.9", "brute-deadline"]
    assert any(e["reason"] == "recovered" for e in shifts)
    metrics = _get(httpd, "/metrics")
    assert 'kdtree_recall_ladder_transitions_total{to="approx-0.99"}' in metrics
    assert 'kdtree_serve_degraded_total{reason="ladder"}' in metrics


def test_ladder_steps_down_under_injected_batch_latency(monkeypatch, tmp_path):
    """The burn comes from a ``batch=latency`` fault: the watched p99 SLO
    pages on short test windows and the sampler's ticks step the ladder
    down."""
    _, tt, _, _ = _setup()
    spec = tslo.SloSpec(
        name="request-p99-latency", objective="test: p99 within 150 ms",
        target=0.99, kind="latency",
        hist='kdtree_serve_request_seconds{phase="total"}', threshold=0.15,
        fast=tslo.BurnWindow(long_s=1.5, short_s=0.5, max_burn=2.0),
        slow=tslo.BurnWindow(long_s=3.0, short_s=1.0, max_burn=2.0))
    engine = tslo.SloEngine(specs=[spec], history=thistory.MetricHistory())
    monkeypatch.setenv("KDTREE_TPU_HISTORY_PERIOD_S", "0.05")
    state = tlife.build_state(tree=tt, k=4, max_batch=64, ladder_enabled=True)
    state.slo_engine = engine
    faults = FaultSet("")
    httpd = tsrv.make_server(state, port=0, max_wait_ms=1.0, faults=faults)
    httpd.start(warmup_buckets=[8])
    try:
        faults.set_spec("batch=latency:400")
        forced = None
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and forced is None:
            st, body = _post(httpd, "/v1/knn", {"queries": [[0.4, 0.4, 0.4]], "k": 2})
            if st == 200 and body.get("degraded"):
                forced = body
        # the sampler ticks every 50 ms while a faulted batch takes 400,
        # so the ladder may pass its approximate gears within one request
        assert forced is not None and forced["degraded"].startswith(
            ("approx:", "brute-deadline"))
        assert httpd.ladder.gear() >= 1
    finally:
        faults.clear()
        httpd.stop()


def test_client_requested_approx_never_moves_the_slo_gauge(dial_server):
    httpd, _, _ = dial_server
    for _ in range(3):
        st, body = _post(httpd, "/v1/knn", {"queries": [[0.3, 0.3, 0.3]], "k": 2,
                                            "recall_target": 0.5})
        assert st == 200 and body["gear"] == "approx:0.5"
    assert tobs.get_registry().snapshot()["gauges"]["kdtree_recall_estimate"] == 1.0


def test_recall_sampler_measures_approx_batches_only(monkeypatch, tmp_path):
    _, tt, _, _ = _setup()
    _calibrate(monkeypatch, tmp_path)
    state = tlife.build_state(tree=tt, k=4, max_batch=64)
    httpd = tsrv.make_server(state, port=0, max_wait_ms=1.0, recall_sample=1.0)
    httpd.start(warmup_buckets=[8])

    def counters():
        snap = tobs.get_registry().snapshot()
        return (snap["counters"].get("kdtree_recall_samples_total", 0.0),
                snap["gauges"].get("kdtree_recall_sampled"))

    try:
        before, _ = counters()
        st, body = _post(httpd, "/v1/knn", {"queries": [[0.5, 0.5, 0.5]], "k": 2})
        assert st == 200 and "gear" not in body
        assert counters()[0] == before
        for i in range(3):
            st, body = _post(httpd, "/v1/knn", {"queries": [[0.1 * i, 0.2, 0.3]], "k": 4,
                                                "recall_target": 0.5})
            assert st == 200 and body["gear"] == "approx:0.5"
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and counters()[0] < before + 3:
            time.sleep(0.02)
        after, gauge = counters()
        assert after == before + 3 and gauge is not None and 0.0 <= gauge <= 1.0
        ring = json.loads(_get(httpd, "/debug/flight"))["events"]
        samples = [e for e in ring if e.get("type") == "recall.sample"]
        assert samples and all("measured" in e and "estimate" in e for e in samples)
    finally:
        httpd.stop()


def test_recall_sampler_defaults_off():
    from kdtree_tpu_torch.serve.batcher import MicroBatcher

    b = MicroBatcher(None, None)
    assert b.recall_sample == 0.0 and b._sample_every == 0
    assert tsrv.make_server.__defaults__[-1] == 0.0


def test_approx_knn_response_byte_equal_to_reference_server(monkeypatch, tmp_path):
    jt, tt, _, _ = _setup()
    cal = _calibrate(monkeypatch, tmp_path, reference=True)
    js = jsrv.make_server(jlife.build_state(tree=jt, k=4, max_batch=64,
                                            install_listeners=False),
                          port=0, max_wait_ms=1.0)
    ts = tsrv.make_server(tlife.build_state(tree=tt, k=4, max_batch=64),
                          port=0, max_wait_ms=1.0)
    started = []
    try:
        for s in (js, ts):
            s.start(warmup_buckets=[8])
            started.append(s)
        rng = np.random.default_rng(3)
        for rows, target in ((1, 0.5), (5, 0.9), (40, 0.75), (3, 0.99)):
            q = (rng.uniform(-90, 90, (rows, DIM))).astype(np.float32).tolist()
            payload = {"queries": q, "k": 4, "recall_target": target}
            (sj, rj), (st, rt) = (_post(s, "/v1/knn", payload) for s in (js, ts))
            for r in (rj, rt):
                r.pop("trace_id", None)
            assert sj == st == 200 and rt == rj, (rows, target)
            assert rt["gear"] == f"approx:{target:g}"
        assert cal
    finally:
        for s in started:
            s.stop()
