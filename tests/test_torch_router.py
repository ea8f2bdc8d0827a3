"""The port's scatter/gather router (``kdtree_tpu_torch/serve/router.py``)
over in-process CPU shards of the port, held against ``kdtree_tpu``'s
router over the reference's shards on the same seeded points:

- with every shard healthy the two routers answer the same bytes (the
  trace id aside, which both echo from ``X-Request-Id``), and both equal
  the single-index oracle (the reference's tiled engine over all the
  points, distances the float64 sqrt of its f32 d2);
- the mixed fleet: the reference's router over port shards and one
  reference shard answers the oracle's bytes;
- each fault class (a counted error healed by retry, a hang, a dropped
  connection, a sub-quorum fleet) gives both routers the same flagged
  answer; the breaker opens and closes; replica sets, write passthrough
  (id ranges and spatial ownership), ``/metrics?federate=1``, the
  two-level ``parent`` topology, the verbs' merges, selective fan-out and
  the pooled connections behave as the reference's tests pin them.

Faults are counted specs or hangs released on clear, never sleeps;
deadlines are seconds, far above a CPU answer's milliseconds, and no
test asserts a latency. The health period, and with it the probe's
timeout, is 2 s: a shard on a loaded CPU answers /healthz within it,
where a 0.1-0.2 s probe can time out and eject a healthy shard. A test
that asserts a health state probes until that state holds."""

from __future__ import annotations

import contextlib
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kdtree_tpu.obs import slo as jslo
from kdtree_tpu.serve import faults as jfaults
from kdtree_tpu.serve import lifecycle as jlife
from kdtree_tpu.serve import router as jrt
from kdtree_tpu.serve import server as jsrv
from kdtree_tpu_torch import obs as tobs
from kdtree_tpu_torch.obs import slo as tslo
from kdtree_tpu_torch.serve import engine as tlife
from kdtree_tpu_torch.serve import faults as tfaults
from kdtree_tpu_torch.serve import router as trt
from kdtree_tpu_torch.serve import server as tsrv
from kdtree_tpu_torch.serve import spatial as tsp
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

DIM, K = 3, 4
SHARD_N = 1024
N_SHARDS = 3
SP_CENTERS = np.array([[-60.0, -60.0, -60.0], [60.0, 60.0, 60.0],
                       [-60.0, 60.0, 0.0], [60.0, -60.0, 0.0]], dtype=np.float32)
SP_SHARDS = 4
HEALTH_PERIOD_S = 2.0  # the probe's timeout too: max(min(period, 2.0), 0.1)
PROBE_DEADLINE_S = 60.0


def _oracle(points, queries, k, gid=None):
    """The single-index answer over ``points`` (global ids ``gid``): the
    reference's tiled engine, distances as the wire carries them."""
    import jax.numpy as jnp

    from kdtree_tpu.ops.morton import morton_view
    from kdtree_tpu.ops.tile_query import morton_knn_tiled

    gid = np.arange(points.shape[0], dtype=np.int32) if gid is None else gid
    tree = morton_view(jnp.asarray(points), gid=jnp.asarray(gid), n_real=points.shape[0])
    d2, ids = morton_knn_tiled(tree, jnp.asarray(queries), k=min(k, points.shape[0]))
    return np.sqrt(np.asarray(d2).astype(np.float64)).tolist(), np.asarray(ids).tolist()


def _start(pkg, fset=None, **kw):
    if pkg == "port":
        state = tlife.build_state(device="cpu", **kw)
    else:
        state = jlife.build_state(install_listeners=False, **kw)
    # shards in one process share one metrics registry, so each one's SLO
    # engine would judge every shard's requests (a loaded CPU's latencies
    # included) and page them all at once, which a health probe reads as
    # an ejection ({"ejected": "slo PAGE"} on every shard under 6 test
    # workers): in process they run with no SLO specs, as chip_smoke.py
    # phase 13's shards do
    slo = tslo if pkg == "port" else jslo
    state.slo_engine = slo.SloEngine(specs=[], history=state.slo_engine.history)
    make = tsrv.make_server if pkg == "port" else jsrv.make_server
    httpd = make(state, port=0, faults=fset)
    httpd.start(warmup_buckets=[8])
    return httpd


def _url(httpd):
    return f"http://127.0.0.1:{httpd.server_address[1]}"


class Fleet:
    """N shard servers of one package over a contiguous partition, each
    with its own fault set."""

    def __init__(self, pkg, points, n=N_SHARDS, **kw):
        fmod = tfaults if pkg == "port" else jfaults
        self.faults = [fmod.FaultSet() for _ in range(n)]
        self.servers = [
            _start(pkg, self.faults[i], points=points[i * SHARD_N:(i + 1) * SHARD_N], k=K,
                   max_batch=64, id_offset=i * SHARD_N, **kw)
            for i in range(n)]
        self.urls = [_url(h) for h in self.servers]

    def clear(self):
        for f in self.faults:
            f.clear()

    def stop(self):
        self.clear()
        for h in self.servers:
            h.stop()


@pytest.fixture(scope="module")
def points():
    return np.random.default_rng(7).uniform(-100, 100, (N_SHARDS * SHARD_N, DIM)).astype(
        np.float32)


@pytest.fixture(scope="module")
def tfleet(points):
    fleet = Fleet("port", points)
    yield fleet
    fleet.stop()


@pytest.fixture(scope="module")
def jfleet(points):
    fleet = Fleet("ref", points)
    yield fleet
    fleet.stop()


@contextlib.contextmanager
def router_for(rt, urls, health_loop=False, **cfg):
    config = dict(deadline_s=30.0, retries=2, backoff_base_s=0.01, hedge_min_s=0.05,
                  breaker_failures=2, breaker_reset_s=0.3, health_period_s=HEALTH_PERIOD_S)
    config.update(cfg)
    router = rt.make_router(urls, config=rt.RouterConfig(**config))
    router.start(health_loop=health_loop)
    try:
        yield router
    finally:
        router.stop()


def _probe_until(router, routable, shards=None):
    """Probe ``shards`` (indices; default all) by hand until each one's
    routable state is ``routable``: a probe that a loaded CPU answers
    late reads as unhealthy, and the next one sees the shard as it is."""
    idx = range(len(router.shards)) if shards is None else shards
    deadline = time.monotonic() + PROBE_DEADLINE_S
    while True:
        for i in idx:
            router._probe_health(router.shards[i])
        if all(router.shards[i].healthy is routable for i in idx):
            return
        assert time.monotonic() < deadline, [router.shards[i].health_detail for i in idx]


def _health(router):
    """Each replica's routable state and its last probe's detail, for a
    failure's message."""
    return [(r.index, r.replica, r.healthy, r.breaker.state,
             {k: v for k, v in r.health_detail.items() if k in ("ejected", "slo", "ready")})
            for r in router.shards]


def _post(router, payload, path="/v1/knn", headers=None, timeout=120.0):
    req = urllib.request.Request(
        _url(router) + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(router, path, timeout=30.0):
    try:
        with urllib.request.urlopen(_url(router) + path, timeout=timeout) as r:
            body = r.read().decode()
            return r.status, (json.loads(body) if path != "/metrics" and
                              not path.startswith("/metrics?") else body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _queries(rows, seed=0, scale=100.0):
    rng = np.random.default_rng(seed)
    return (rng.random((rows, DIM)) * 2 * scale - scale).astype(np.float32)


def _counter(key):
    return tobs.get_registry().snapshot()["counters"].get(key, 0.0)


def _without_trace(body):
    return {k: v for k, v in body.items() if k != "trace_id"}


# ---------------------------------------------------------------------------
# units: the merges and the breaker
# ---------------------------------------------------------------------------


def test_merges_equal_reference():
    a = {"k": 2, "ids": [[5, 1], [7, -1]], "distances": [[0.5, 1.5], [2.0, float("inf")]],
         "gear": "approx:0.99"}
    b = {"k": 3, "ids": [[2, 0, 9], [3, 4, 8]], "distances": [[1.5, 3.0, 4.0],
                                                                [1.0, 2.0, 2.5]],
         "gear": "approx:0.9"}
    c = {"k": 2, "ids": [[6, 3], [1, 2]], "distances": [[0.25, 1.5], [2.0, 2.0]],
         "gear": "brute-deadline"}
    for group in ([a, b], [a, b, c], [c], [b, c]):
        for k in (None, 1, 2, 3):
            assert trt.merge_topk(group, k) == jrt.merge_topk(group, k)
        assert trt.merge_gear(group) == jrt.merge_gear(group)
    assert trt.merge_topk([a, b], 2)[1] == [[5, 1], [3, 4]]  # the 1.5 tie: lower id
    ra = {"counts": [2, 0], "ids": [[4, 1], []], "distances": [[0.5, 1.0], []],
          "truncated": False}
    rb = {"counts": [2, 1], "ids": [[1, 9], [3]], "distances": [[1.0, 1.0], [2.0]],
          "truncated": True}
    for endpoint in ("radius", "range", "count"):
        assert trt.merge_verb(endpoint, [ra, rb]) == jrt.merge_verb(endpoint, [ra, rb])
    with pytest.raises(ValueError):
        trt.merge_topk([], 1)


def test_breaker_cycle_equals_reference():
    seen = []
    for rt in (trt, jrt):
        b = rt.CircuitBreaker(failures=2, reset_s=0.05)
        trace = [b.allow()]
        b.record_failure()
        trace += [b.state, b.allow()]
        b.record_failure()
        trace += [b.state, b.allow()]
        while b.state == rt.OPEN and not b.allow():
            time.sleep(0.01)
        trace += [b.state, b.allow()]
        b.record_failure()
        trace.append(b.state)
        while not b.allow():
            time.sleep(0.01)
        b.record_success()
        trace += [b.state, b.allow()]
        seen.append(trace)
    assert seen[0] == seen[1] == [True, trt.CLOSED, True, trt.OPEN, False, trt.HALF_OPEN,
                                  False, trt.OPEN, trt.CLOSED, True]


# ---------------------------------------------------------------------------
# exactness: the port's router = the reference's = the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,k,extra", [(1, 4, {}), (7, 2, {}), (64, None, {}),
                                          (5, 4, {"recall_target": 0.9}), (3, 4, {"k": 9})])
def test_routed_bodies_equal_reference(tfleet, jfleet, points, rows, k, extra):
    q = _queries(rows, seed=rows)
    payload = {"queries": q.tolist(), **({"k": k} if k else {}), **extra}
    headers = {"X-Request-Id": f"same-{rows}"}
    # no hedges: a hedge's twin request can join its original in one shard
    # batch, and an approximate (recall_target) answer depends on the
    # batch's tiles, so a hedge under load would change the bytes
    with router_for(trt, tfleet.urls, hedge_min_s=60.0) as tr, \
            router_for(jrt, jfleet.urls, hedge_min_s=60.0) as jr:
        ts, tb = _post(tr, payload, headers=headers)
        js, jb = _post(jr, payload, headers=headers)
    assert (ts, tb) == (js, jb)
    if extra or ts != 200:
        assert extra.get("k") != 9 or ts == 400
        return
    assert tb["degraded"] is None and tb["trace_id"] == f"same-{rows}"
    assert tb["shards"] == {"total": N_SHARDS, "contacted": N_SHARDS, "answered": N_SHARDS,
                            "missing": [], "pruned": 0}
    dist, ids = _oracle(points, q, k or K)
    assert tb["ids"] == ids and tb["distances"] == dist


def test_mixed_fleet_is_byte_identical_to_the_oracle(tfleet, jfleet, points):
    """The reference's router over two port shards and one reference
    shard, and the port's router over the other mix."""
    q = _queries(16, seed=21)
    dist, ids = _oracle(points, q, K)
    for rt, urls in ((jrt, tfleet.urls[:2] + jfleet.urls[2:]),
                     (trt, jfleet.urls[:1] + tfleet.urls[1:2] + jfleet.urls[2:])):
        with router_for(rt, urls) as router:
            status, out = _post(router, {"queries": q.tolist(), "k": K})
        assert status == 200 and out["degraded"] is None
        assert out["ids"] == ids and out["distances"] == dist


@pytest.mark.parametrize("endpoint,payload", [
    ("radius", {"queries": [[1.0, 2.0, 3.0], [50.0, -20.0, 0.0]], "r": 15.0}),
    ("range", {"lo": [[-20.0, -20.0, -20.0]], "hi": [[5.0, 10.0, 0.0]]}),
    ("count", {"queries": [[0.0, 0.0, 0.0]], "r": [30.0]}),
    ("count", {"lo": [[-50.0, -50.0, -50.0]], "hi": [[0.0, 0.0, 0.0]]}),
])
def test_verb_merges_equal_reference(tfleet, jfleet, endpoint, payload):
    headers = {"X-Request-Id": f"verb-{endpoint}"}
    with router_for(trt, tfleet.urls) as tr, router_for(jrt, jfleet.urls) as jr:
        ts, tb = _post(tr, payload, path=f"/v1/{endpoint}", headers=headers)
        js, jb = _post(jr, payload, path=f"/v1/{endpoint}", headers=headers)
    assert ts == js == 200
    assert tb == jb and sum(tb["counts"]) > 0


# ---------------------------------------------------------------------------
# fault classes: the same flagged answer from both routers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,specs,cfg", [
    ("error-healed", {1: "knn=error:503*2"}, dict(retries=2, breaker_failures=5)),
    ("hang", {2: "knn=hang"}, dict(deadline_s=2.0, retries=0)),
    ("drop", {0: "knn=drop"}, dict(deadline_s=5.0, retries=0)),
    ("below-quorum", {0: "knn=error", 1: "knn=error"}, dict(retries=0)),
])
def test_fault_classes_answer_like_reference(tfleet, jfleet, case, specs, cfg):
    q = _queries(4, seed=31)
    bodies = []
    for rt, fleet in ((trt, tfleet), (jrt, jfleet)):
        for i, spec in specs.items():
            fleet.faults[i].set_spec(spec)
        try:
            with router_for(rt, fleet.urls, **cfg) as router:
                bodies.append(_post(router, {"queries": q.tolist(), "k": K}))
        finally:
            fleet.clear()
    (ts, tb), (js, jb) = bodies
    assert ts == js and _without_trace(tb) == _without_trace(jb)
    if case == "error-healed":
        assert ts == 200 and tb["degraded"] is None
    elif case == "below-quorum":
        assert ts == 503 and "quorum" in tb["error"] and tb["shards"]["missing"] == [0, 1]
    else:
        assert ts == 200 and tb["degraded"] == f"partial:2/{N_SHARDS}"
        assert tb["shards"]["missing"] == list(specs)


def test_breaker_opens_then_recovers_half_open_to_closed(tfleet, points):
    tfleet.faults[0].set_spec("knn=error")
    try:
        with router_for(trt, tfleet.urls, retries=0, breaker_reset_s=0.25) as router:
            for i in range(2):
                status, out = _post(router, {"queries": _queries(3, seed=i).tolist()})
                assert status == 200 and out["shards"]["missing"] == [0]
            assert router.shard_report()[0]["breaker"] == "open"
            gauges = tobs.get_registry().snapshot()["gauges"]
            assert gauges['kdtree_router_breaker_state{shard="0"}'] == trt.OPEN
            tfleet.clear()
            q = _queries(5, seed=9)
            deadline = time.monotonic() + 60
            while router.shard_report()[0]["breaker"] != "closed":
                assert time.monotonic() < deadline, "the breaker never closed"
                status, out = _post(router, {"queries": q.tolist(), "k": K})
            status, out = _post(router, {"queries": q.tolist(), "k": K})
            assert status == 200 and out["degraded"] is None
            assert (out["distances"], out["ids"]) == _oracle(points, q, K)
            assert _counter('kdtree_router_breaker_transitions_total'
                            '{shard="0",to="closed"}') >= 1
    finally:
        tfleet.clear()


# ---------------------------------------------------------------------------
# health, federation, traces, pooling
# ---------------------------------------------------------------------------


def test_healthz_ejects_and_federation_labels_shards(tfleet):
    with router_for(trt, tfleet.urls) as router:
        _probe_until(router, True)
        status, body = _get(router, "/healthz")
        assert status == 200 and body["available"] == N_SHARDS and body["quorum"] == 2
        assert "box" in body["shards"][0]["detail"]
        tfleet.faults[1].set_spec("healthz=error:503")
        try:
            _probe_until(router, False, [1])
            assert router.shards[1].health_detail == {"ejected": "healthz 503"}
            status, body = _get(router, "/healthz")
            assert status == 200 and body["available"] == N_SHARDS - 1
            assert body["shards"][1]["routable"] is False
            status, out = _post(router, {"queries": _queries(2).tolist()})
            assert status == 200 and out["degraded"] == f"partial:2/{N_SHARDS}"
        finally:
            tfleet.clear()
        _probe_until(router, True, [1])
        deadline = time.monotonic() + PROBE_DEADLINE_S
        while True:  # a shard's scrape that times out reads as down
            status, text = _get(router, "/metrics?federate=1")
            lines = text.splitlines()
            if all(f'kdtree_router_federated_up{{shard="{i}"}} 1' in lines
                   for i in range(N_SHARDS)) or time.monotonic() > deadline:
                break
        for i in range(N_SHARDS):
            assert any(ln.startswith(f'kdtree_serve_ready{{shard="{i}"}}') for ln in lines)
            assert f'kdtree_router_federated_up{{shard="{i}"}} 1' in lines
        types = [ln.split(" ")[2] for ln in lines if ln.startswith("# TYPE ")]
        assert len(types) == len(set(types))  # each family one contiguous block
        router.shards[2].port, real = 1, router.shards[2].port
        status, text = _get(router, "/metrics?federate=1")
        router.shards[2].port = real
        assert status == 200 and 'kdtree_router_federated_up{shard="2"} 0' in text


def test_trace_context_threads_and_assembles(tfleet):
    tid = "port-route-trace-1"
    with router_for(trt, tfleet.urls, trace_frac=1.0) as router:
        status, out = _post(router, {"queries": _queries(2).tolist()},
                            headers={"X-Request-Id": tid})
        assert status == 200 and out["trace_id"] == tid
        status, asm = _get(router, f"/debug/trace/{tid}?assemble=1")
    assert status == 200
    names = {s["name"] for s in asm["spans"]}
    assert {"route/request", "route/shard", "serve/request"} <= names
    from kdtree_tpu_torch.obs import flight

    mine = [e for e in flight.recorder().snapshot()
            if e.get("type") == "serve.request" and e.get("trace") == tid]
    assert len(mine) >= N_SHARDS


def test_pooled_connections_reused_byte_identical(tfleet, points):
    q = _queries(6, seed=41)
    dist, ids = _oracle(points, q, K)
    with router_for(trt, tfleet.urls) as router:
        h0 = _counter("kdtree_router_pool_hits_total")
        for _ in range(4):
            status, out = _post(router, {"queries": q.tolist(), "k": K})
            assert status == 200 and out["ids"] == ids and out["distances"] == dist
        assert _counter("kdtree_router_pool_hits_total") >= h0 + N_SHARDS
    with router_for(trt, tfleet.urls, pool=False) as router:
        status, out = _post(router, {"queries": q.tolist(), "k": K})
        assert out["ids"] == ids and out["distances"] == dist


# ---------------------------------------------------------------------------
# replica sets and write passthrough
# ---------------------------------------------------------------------------


def test_replica_sets_spread_fail_over_and_write_to_the_primary(points):
    """One shard set of three port replicas (the first the primary):
    reads rotate and stay exact, a failing replica is invisible, writes
    land on the primary only."""
    fsets = [tfaults.FaultSet() for _ in range(3)]
    servers = [_start("port", fsets[j], points=points[:SHARD_N], k=K, max_batch=64,
                      read_only=j > 0) for j in range(3)]
    q = _queries(6, seed=51)
    dist, ids = _oracle(points[:SHARD_N], q, K)
    try:
        with router_for(trt, ["|".join(_url(h) for h in servers)], hedge_min_s=5.0,
                        health_loop=True) as router:
            for _ in range(6):
                status, out = _post(router, {"queries": q.tolist(), "k": K})
                assert status == 200, (out, _health(router))
                assert out["ids"] == ids and out["distances"] == dist
            for j in range(3):
                assert _counter('kdtree_router_replica_requests_total'
                                f'{{replica="{j}",shard="0"}}') > 0
            fsets[1].set_spec("knn=error:500*100")
            for _ in range(4):
                status, out = _post(router, {"queries": q.tolist(), "k": K})
                assert status == 200 and out["degraded"] is None and out["ids"] == ids
            fsets[1].clear()
            deadline = time.monotonic() + 30
            while router._owner_table() is None:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            status, out = _post(router, {"ids": [SHARD_N + 777], "points": [[0.5] * DIM]},
                                path="/v1/upsert")
            assert status == 200 and out["applied"] == 1, (out, _health(router))
        deltas = [h.state.engine.stats()["delta_rows"] for h in servers]
        assert deltas[0] == 1 and deltas[1:] == [0, 0]
    finally:
        for h in servers:
            h.stop()


def test_write_passthrough_partitions_by_id_range(points):
    """Two fresh port shards: a write spanning both applies on each
    owner, reads back with global ids, and a routed delete applies on
    its owner only; the bodies equal the reference router's over
    reference shards."""
    bodies = []
    for pkg, rt in (("port", trt), ("ref", jrt)):
        servers = [_start(pkg, points=points[i * SHARD_N:(i + 1) * SHARD_N], k=K,
                          max_batch=64, id_offset=i * SHARD_N, max_delta_rows=1 << 20)
                   for i in range(2)]
        try:
            with router_for(rt, [_url(h) for h in servers], retries=1) as router:
                _probe_until(router, True)
                ids = [5, SHARD_N + 7, 10 * SHARD_N]
                pts = [[300.0, 300.0, 300.0], [310.0, 310.0, 310.0], [320.0, 320.0, 320.0]]
                seen = [_post(router, {"ids": ids, "points": pts}, path="/v1/upsert"),
                        _post(router, {"queries": [[305.0] * 3], "k": 3}),
                        _post(router, {"ids": [SHARD_N + 7]}, path="/v1/delete"),
                        _post(router, {"queries": [[305.0] * 3], "k": 3}),
                        _post(router, {"ids": [5, 5], "points": [[1.0] * 3] * 2},
                              path="/v1/upsert")]
                bodies.append([(s, _without_trace(b)) for s, b in seen])
        finally:
            for h in servers:
                h.stop()
    assert bodies[0] == bodies[1]
    (s0, up), (_, read), (s2, dele), (_, read2), (s4, dup) = bodies[0]
    assert s0 == 200 and up["applied"] == 3 and set(up["shards"]) == {"0", "1"}
    assert sorted(read["ids"][0]) == sorted([5, SHARD_N + 7, 10 * SHARD_N])
    assert s2 == 200 and dele["applied"] == 1 and list(dele["shards"]) == ["1"]
    assert SHARD_N + 7 not in read2["ids"][0]
    assert s4 == 400 and "duplicate" in dup["error"]


# ---------------------------------------------------------------------------
# spatial fleets: selective fan-out, spatial writes, two-level routing
# ---------------------------------------------------------------------------


class SpatialFleet:
    """Four port shards over a Morton-range partition of a clustered
    cloud, global ids the Morton ranks, each publishing its region on
    /healthz — what ``partition`` + ``serve --snapshot`` make, without
    the disk."""

    def __init__(self):
        from kdtree_tpu_torch.ops.morton import morton_view

        rng = np.random.default_rng(17)
        pts = np.concatenate([c + rng.normal(0.0, 3.0, (400, DIM))
                              for c in SP_CENTERS]).astype(np.float32)
        self.plan = tsp.plan_partition(pts, SP_SHARDS)
        order = self.plan["order"]
        self.cloud = {int(i): pts[order[i]] for i in range(pts.shape[0])}
        self.servers = []
        for i, ((s, e), (c0, c1)) in enumerate(zip(self.plan["bounds"],
                                                   self.plan["code_ranges"])):
            tree = morton_view(torch.from_numpy(pts[order[s:e]]),
                               gid=torch.arange(s, e, dtype=torch.int32), n_real=e - s)
            self.servers.append(_start("port", tree=tree, k=K, max_batch=64,
                                       max_delta_rows=1 << 20, meta={"spatial": {
                                           "grid": self.plan["grid"].to_json(),
                                           "code_range": [int(c0), int(c1)],
                                           "id_range": [int(s), int(e)],
                                           "shard": i, "shards": SP_SHARDS}}))
        self.urls = [_url(h) for h in self.servers]

    def oracle(self, queries, k):
        ids = sorted(self.cloud)
        return _oracle(np.stack([self.cloud[i] for i in ids]), queries, k,
                       gid=np.asarray(ids, dtype=np.int32))

    def stop(self):
        for h in self.servers:
            h.stop()


@pytest.fixture(scope="module")
def spatial_fleet():
    fleet = SpatialFleet()
    yield fleet
    fleet.stop()


@contextlib.contextmanager
def spatial_router(fleet_urls, **cfg):
    with router_for(trt, fleet_urls, health_loop=True, retries=1, **cfg) as router:
        deadline = time.monotonic() + 30.0
        while not all(ss.box() is not None for ss in router.shard_sets):
            assert time.monotonic() < deadline, "fleet topology never learned"
            time.sleep(0.05)
        yield router


def _near(center, seed, rows=1):
    return (center + np.random.default_rng(seed).normal(0.0, 2.0, (rows, DIM))).astype(
        np.float32)


def test_spatial_selective_prunes_byte_identical_and_routes_writes(spatial_fleet):
    fleet = spatial_fleet
    contacted = []
    with spatial_router(fleet.urls, spec_wave=False) as sel, \
            spatial_router(fleet.urls, fanout="full") as full:
        for si, center in enumerate(SP_CENTERS):
            q = _near(center, 40 + si)
            dist, ids = fleet.oracle(q, K)
            for router in (sel, full):
                status, out = _post(router, {"queries": q.tolist(), "k": K})
                assert status == 200 and out["degraded"] is None, (out, _health(router))
                assert out["ids"] == ids and out["distances"] == dist
            assert out["shards"]["contacted"] == SP_SHARDS  # the full router's
            status, out = _post(sel, {"queries": q.tolist(), "k": K})
            contacted.append(out["shards"]["contacted"])
        assert np.mean(contacted) <= SP_SHARDS / 2, contacted
        spread = np.concatenate([_near(SP_CENTERS[0], 50, 2), _near(SP_CENTERS[1], 51, 2),
                                 _queries(2, seed=52, scale=150.0)])
        status, out = _post(sel, {"queries": spread.tolist(), "k": K})
        assert (out["distances"], out["ids"]) == fleet.oracle(spread, K)
        # a spatial upsert lands on the region owner and reads back
        p = _near(SP_CENTERS[2], 53)
        owner = int(tsp.owner_of(p, fleet.plan["grid"], fleet.plan["code_ranges"])[0])
        wid = 90_000
        status, out = _post(sel, {"ids": [wid], "points": p.tolist()}, path="/v1/upsert")
        assert status == 200 and out["routing"] == "spatial", (out, _health(sel))
        assert out["shards"][str(owner)]["applied"] == 1
        fleet.cloud[wid] = p[0]
        status, out = _post(sel, {"queries": p.tolist(), "k": 1})
        assert out["ids"] == [[wid]] and out["distances"] == [[0.0]]
        status, out = _post(sel, {"ids": [wid]}, path="/v1/delete")
        assert status == 200 and out["applied"] == 1
        del fleet.cloud[wid]
    assert _counter("kdtree_router_shards_pruned_total") > 0


def test_two_level_parent_byte_identical_and_refuses_writes(spatial_fleet):
    fleet = spatial_fleet
    q = np.concatenate([_near(SP_CENTERS[0], 70, 2), _near(SP_CENTERS[3], 71, 2)])
    dist, ids = fleet.oracle(q, K)
    half = SP_SHARDS // 2
    with spatial_router(fleet.urls[:half]) as c0, spatial_router(fleet.urls[half:]) as c1, \
            spatial_router([_url(c0), _url(c1)], parent=True) as parent:
        status, out = _post(parent, {"queries": q.tolist(), "k": K})
        assert status == 200 and out["degraded"] is None, \
            (out, _health(parent), _health(c0), _health(c1))
        assert out["ids"] == ids and out["distances"] == dist
        assert out["shards"]["total"] == 2
        status, health = _get(parent, "/healthz")
        assert status == 200 and health["available"] == 2 and "box" in health
        status, text = _get(parent, "/metrics?federate=1")
        assert 'kdtree_router_federated_up{child="0"} 1' in text.splitlines()
        status, out = _post(parent, {"ids": [99999], "points": [[0.0] * DIM]},
                            path="/v1/upsert")
        assert status == 503 and "parent" in out["error"]


# ---------------------------------------------------------------------------
# the user's path: partition, serve x2, route — real processes on the CPU
# ---------------------------------------------------------------------------


def _wait_ready(proc, log, deadline):
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"process died: {log.read_text()[-2000:]}")
        for line in log.read_text().splitlines():
            if line.startswith("ready:"):
                return int(line.rsplit("port", 1)[1].strip())
        time.sleep(0.1)
    raise AssertionError(f"never ready: {log.read_text()[-2000:]}")


def test_cli_partition_serve_route_processes(tmp_path):
    """``partition --device cpu`` into two shard snapshots, a ``serve
    --snapshot`` process per shard, a ``route`` process in front: the
    routed answer over HTTP is the oracle's bytes (global ids are the
    Morton ranks), and every process drains on SIGTERM with exit 0."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from kdtree_tpu_torch.ops.generate import generate_points_rowwise

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    base = [sys.executable, "-m", "kdtree_tpu_torch"]
    out = subprocess.run(base + ["--device", "cpu", "partition", "--seed", "3", "--n", "4096",
                                 "--shards", "2", "--out-dir", str(tmp_path / "fleet"),
                                 "--k", str(K), "--max-batch", "8"],
                         cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    procs, logs = [], []
    try:
        for i in range(2):
            logs.append(tmp_path / f"serve{i}.log")
            procs.append(subprocess.Popen(
                base + ["--device", "cpu", "serve", "--snapshot",
                        str(tmp_path / "fleet" / f"shard-0{i}"), "--port", "0", "--k", str(K),
                        "--max-batch", "8"],
                cwd=repo, env=env, stdout=subprocess.DEVNULL, stderr=logs[-1].open("w")))
        deadline = time.monotonic() + 240
        urls = [f"http://127.0.0.1:{_wait_ready(p, g, deadline)}" for p, g in zip(procs, logs)]
        logs.append(tmp_path / "route.log")
        procs.append(subprocess.Popen(
            base + ["route", "--shard", ",".join(urls), "--port", "0", "--deadline-ms", "30000"],
            cwd=repo, env=env, stdout=subprocess.DEVNULL, stderr=logs[-1].open("w")))
        rport = _wait_ready(procs[-1], logs[-1], deadline)

        class _Router:
            server_address = ("127.0.0.1", rport)

        pts = generate_points_rowwise(3, DIM, 4096, device="cpu").numpy()
        order = tsp.plan_partition(pts, 2)["order"]
        q = _queries(7, seed=61)  # within --max-batch 8
        dist, ids = _oracle(pts[order], q, K)
        while True:
            status, out = _post(_Router, {"queries": q.tolist(), "k": K})
            if status == 200 and out["shards"]["answered"] == 2:
                break
            assert time.monotonic() < deadline, out
            time.sleep(0.2)
        assert out["degraded"] is None and out["ids"] == ids and out["distances"] == dist
        # the manifests' regions reached /healthz: the write routes spatially
        status, out = _post(_Router, {"ids": [70_000], "points": [[1.5, 2.5, 3.5]]},
                            path="/v1/upsert")
        assert status == 200 and out["routing"] == "spatial" and out["applied"] == 1, out
        status, out = _post(_Router, {"queries": [[1.5, 2.5, 3.5]], "k": 1})
        assert out["ids"] == [[70_000]] and out["distances"] == [[0.0]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        codes = [p.wait(timeout=60) for p in procs]
    assert codes == [0, 0, 0], [g.read_text()[-1000:] for g in logs]
    assert all("drained; bye" in g.read_text() for g in logs)
