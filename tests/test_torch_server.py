"""The port's HTTP server against a kdtree_tpu server, both on the CPU on
the same seeded points: the same requests get byte-identical k / ids /
distances / degraded answers (concurrent clients, per-request k,
oversized, an expired deadline, id_offset, writes over HTTP), the same
4xx / 429 / 403 answers, the same /healthz keys, a drained shutdown, and
501s for what the port does not serve yet."""

from __future__ import annotations

import contextlib
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from kdtree_tpu.serve import faults as jfaults
from kdtree_tpu.serve import lifecycle as jlife
from kdtree_tpu.serve import server as jsrv
from kdtree_tpu_torch.obs import flight as tflight
from kdtree_tpu_torch.serve import engine as tlife
from kdtree_tpu_torch.serve import faults as tfaults
from kdtree_tpu_torch.serve import server as tsrv

torch.set_num_threads(1)

SEED, DIM, N, K, MAX_BATCH = 5, 3, 6000, 8, 16
WARM = [8, 16]


@pytest.fixture(autouse=True)
def _reset_port_flight_rate_limit():
    """The port's process-wide flight recorder rate-limits auto-dumps per
    reason like the reference's; tests/conftest.py resets only the
    reference's, so this file resets the port's before every test."""
    tflight.recorder().reset_dump_rate_limit()
    yield


@contextlib.contextmanager
def pair(id_offset=0, queue_rows=None, faults=None, max_delta_rows=None):
    """A reference server and a port server over the same seeded problem
    (the two builds are bit-identical), started on ephemeral ports."""
    kw = dict(problem=(SEED, DIM, N), k=K, max_batch=MAX_BATCH, id_offset=id_offset,
              max_delta_rows=max_delta_rows)
    js = jsrv.make_server(jlife.build_state(install_listeners=False, **kw), port=0,
                          queue_rows=queue_rows,
                          faults=None if faults is None else jfaults.FaultSet(faults))
    ts = tsrv.make_server(tlife.build_state(device="cpu", **kw), port=0,
                          queue_rows=queue_rows,
                          faults=None if faults is None else tfaults.FaultSet(faults))
    started = []
    try:
        for s in (js, ts):
            s.start(warmup_buckets=WARM)
            started.append(s)
        yield js, ts
    finally:
        for s in started:
            s.stop()


@pytest.fixture(scope="module")
def servers():
    """A read-only pair shared by the query tests (no writes land here)."""
    with pair() as p:
        yield p


def call(srv, method, path, body=None, raw=None, headers=None):
    """(status, headers, parsed body) of one request on a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
    try:
        data = raw if raw is not None else (None if body is None else json.dumps(body))
        conn.request(method, path, body=data, headers=headers or {})
        resp = conn.getresponse()
        text = resp.read().decode()
        if resp.getheader("Content-Type", "").startswith("application/json"):
            return resp.status, dict(resp.getheaders()), json.loads(text)
        return resp.status, dict(resp.getheaders()), text
    finally:
        conn.close()


def answer_bytes(resp):
    """The compared bytes of a /v1/knn answer."""
    return json.dumps([resp.get(f) for f in ("k", "ids", "distances", "degraded")])


def both(p, method, path, body=None, **kw):
    out = [call(s, method, path, body, **kw) for s in p]
    return out


def queries(rows, seed):
    return np.random.default_rng(seed).uniform(-100, 100, (rows, DIM)).astype(np.float32)


def assert_same_knn(p, body, status=200):
    (sj, _, rj), (st, _, rt) = both(p, "POST", "/v1/knn", body)
    assert sj == st == status, (sj, st, rj, rt)
    assert answer_bytes(rt) == answer_bytes(rj)
    return rt


@pytest.mark.parametrize("rows,k", [(1, None), (7, 3), (16, 8), (5, 1)])
def test_knn_answers_byte_identical(servers, rows, k):
    body = {"queries": queries(rows, rows * 10 + (k or 0)).tolist()}
    if k is not None:
        body["k"] = k
    rt = assert_same_knn(servers, body)
    assert rt["degraded"] is None and len(rt["ids"]) == rows
    assert len(rt["ids"][0]) == (k or K)


def test_concurrent_clients_byte_identical(servers):
    out = {}

    def client(slot, srv_i):
        for j in range(4):
            rows = (1, 3, 7, 12)[(slot + j) % 4]
            body = {"queries": queries(rows, 1000 + 10 * slot + j).tolist(),
                    "k": 1 + (slot + j) % K}
            out[(slot, j, srv_i)] = call(servers[srv_i], "POST", "/v1/knn", body)

    threads = [threading.Thread(target=client, args=(s, i)) for s in range(6) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == 48
    for (slot, j, srv_i), (st, _, resp) in out.items():
        if srv_i == 1:
            ref = out[(slot, j, 0)]
            assert st == ref[0] == 200
            assert answer_bytes(resp) == answer_bytes(ref[2])


def test_oversized_request_degrades_alike(servers):
    rt = assert_same_knn(servers, {"queries": queries(MAX_BATCH + 9, 3).tolist(), "k": 5})
    assert rt["degraded"] == "oversized"


def test_expired_deadline_degrades_alike(servers):
    rt = assert_same_knn(servers, {"queries": queries(4, 4).tolist(), "deadline_ms": 1e-6})
    assert rt["degraded"] == "deadline"


def test_trace_id_echo(servers):
    for srv in servers:
        st, _, resp = call(srv, "POST", "/v1/knn", {"queries": [[0.0, 0.0, 0.0]]},
                           headers={"X-Request-Id": "abc/def"})
        assert st == 200 and resp["trace_id"] == "abc-def"


@pytest.mark.parametrize("body", [
    "not json", "[1, 2]", {"k": 2}, {"queries": "x"}, {"queries": []},
    {"queries": [[1.0, 2.0]]}, {"queries": [[1.0, 2.0, float("nan")]]},
    {"queries": [[1.0, 2.0, 3.0]], "k": 0}, {"queries": [[1.0, 2.0, 3.0]], "k": K + 1},
    {"queries": [[1.0, 2.0, 3.0]], "k": True},
    {"queries": [[1.0, 2.0, 3.0]], "deadline_ms": -1},
])
def test_rejections_byte_identical(servers, body):
    raw = body if isinstance(body, str) else json.dumps(body)
    (sj, _, rj), (st, _, rt) = both(servers, "POST", "/v1/knn", raw=raw)
    assert sj == st == 400 and rt == rj


def test_shed_429_with_retry_after():
    with pair(queue_rows=4) as p:
        (sj, hj, rj), (st, ht, rt) = both(p, "POST", "/v1/knn",
                                          {"queries": queries(8, 8).tolist()},
                                          headers={"X-Request-Id": "shed-1"})
        assert sj == st == 429 and rt == rj
        assert ht["Retry-After"] == hj["Retry-After"] == "1"
        # an oversized request is charged too, and an idle server admits it
        assert_same_knn(p, {"queries": queries(20, 9).tolist()})


def test_healthz_keys_match(servers):
    (sj, _, hj), (st, _, ht) = both(servers, "GET", "/healthz")
    assert sj == st == 200
    assert set(ht) == set(hj) - {"headroom"}
    for key in ht:
        if key not in ("server_unix", "slo"):
            assert ht[key] == hj[key], key
    assert set(ht["slo"]["slos"]) == set(hj["slo"]["slos"])


def test_debug_endpoints_match(servers):
    for path in ("/debug/faults",):
        (sj, _, rj), (st, _, rt) = both(servers, "GET", path)
        assert sj == st == 200 and rt == rj == {"enabled": False, "active": []}
    (sj, _, rj), (st, _, rt) = both(servers, "POST", "/debug/faults", {"spec": "knn=error"})
    assert sj == st == 403 and rt == rj
    _, _, hist = call(servers[1], "GET", "/debug/history?limit=2")
    _, _, jhist = call(servers[0], "GET", "/debug/history?limit=2")
    assert set(hist) == set(jhist) and hist["samples"] >= 1
    _, _, fl = call(servers[1], "GET", "/debug/flight?reason=oversized")
    assert set(fl) == set(call(servers[0], "GET", "/debug/flight?reason=oversized")[2])
    st, _, text = call(servers[1], "GET", "/metrics")
    assert st == 200 and "kdtree_serve_batches_total" in text and "\nkdtree_epoch 0\n" in text
    assert call(servers[1], "GET", "/nope")[0] == call(servers[0], "GET", "/nope")[0] == 404


def test_fault_drill_matches():
    with pair(faults="") as p:
        (sj, _, rj), (st, _, rt) = both(p, "POST", "/debug/faults", {"spec": "knn=error:503*1"})
        assert sj == st == 200 and rt == rj
        (sj, _, rj), (st, _, rt) = both(p, "POST", "/v1/knn", {"queries": [[0.0, 0.0, 0.0]]})
        assert sj == st == 503 and rt == rj
        assert_same_knn(p, {"queries": [[0.0, 0.0, 0.0]]})  # the clause is spent
        (sj, _, rj), (st, _, rt) = both(p, "POST", "/debug/faults", {"spec": "bogus=error"})
        assert sj == st == 400 and rt == rj


@pytest.mark.parametrize("path,body", [
    ("/v1/radius", {"queries": [[0.0, 0.0, 0.0]], "r": 1.0}),
    ("/v1/range", {"lo": [[0.0, 0.0, 0.0]], "hi": [[1.0, 1.0, 1.0]]}),
    ("/v1/count", {"queries": [[0.0, 0.0, 0.0]], "r": 1.0}),
    ("/v1/knn", {"queries": [[0.0, 0.0, 0.0]], "recall_target": 0.9}),
    ("/debug/profile", {}),
])
def test_unported_endpoints_answer_501_and_keep_the_connection(servers, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", servers[1].server_address[1], timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body))
        resp = conn.getresponse()
        err = json.loads(resp.read())["error"]
        assert resp.status == 501 and "ROADMAP queue 1 item" in err
        # the body was read: the next request on this socket parses cleanly
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
    finally:
        conn.close()
    for get in ("/debug/trace", "/debug/trace/abc", "/debug/costs"):
        assert call(servers[1], "GET", get)[0] == 501


def _write_both(p, op, body):
    (sj, _, rj), (st, _, rt) = both(p, "POST", f"/v1/{op}", body)
    for r in (rj, rt):
        r.pop("trace_id", None)
    assert sj == st and rt == rj, (sj, st, rj, rt)
    return st, rt


def test_writes_over_http_byte_identical():
    rng = np.random.default_rng(12)
    probe = queries(16, 77)
    with pair() as p:
        before = assert_same_knn(p, {"queries": probe.tolist()})
        new = (probe[:4] + 0.01).astype(np.float32)
        st, res = _write_both(p, "upsert", {"ids": [N + i for i in range(4)],
                                            "points": new.tolist()})
        assert st == 200 and res["applied"] == 4 and res["delta_rows"] == 4
        after = assert_same_knn(p, {"queries": probe.tolist()})
        assert [r[0] for r in after["ids"][:4]] == [N + i for i in range(4)]
        moved = [before["ids"][5][0], before["ids"][6][1]]
        _write_both(p, "upsert", {"ids": moved,
                                  "points": rng.uniform(-100, 100, (2, DIM)).tolist()})
        kth = [before["ids"][8][K - 1], before["ids"][9][0], N + 1]
        st, res = _write_both(p, "delete", {"ids": kth})
        assert st == 200 and res["tombstones"] == 4
        assert_same_knn(p, {"queries": probe.tolist()})
        assert_same_knn(p, {"queries": probe.tolist(), "k": 2})
        assert_same_knn(p, {"queries": queries(MAX_BATCH + 3, 78).tolist()})  # oversized
        for bad in ({"ids": []}, {"ids": [1, True]}, {"ids": [1, 1]}, {"ids": "x"},
                    {"ids": [1], "points": [[1.0, 2.0]]}, {"ids": [2**40]},
                    {"ids": [1], "points": [[1.0, float("inf"), 2.0]]}):
            op = "upsert" if "points" in bad else "delete"
            st, _ = _write_both(p, op, bad)
            assert st == 400
        (sj, _, hj), (st, _, ht) = both(p, "GET", "/healthz")
        assert ht["mutable"] == hj["mutable"] and ht["epoch"] == 0


def test_writes_cross_an_epoch_swap_alike():
    probe = queries(12, 91)
    with pair(max_delta_rows=6) as p:
        _write_both(p, "upsert", {"ids": list(range(N, N + 6)),
                                  "points": (probe[:6] + 0.02).tolist()})
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            eps = [call(s, "GET", "/healthz")[2]["epoch"] for s in p]
            if eps == [1, 1]:
                break
            time.sleep(0.05)
        assert eps == [1, 1]
        rt = assert_same_knn(p, {"queries": probe.tolist()})
        assert [r[0] for r in rt["ids"][:6]] == list(range(N, N + 6))
        assert "\nkdtree_epoch 1\n" in call(p[1], "GET", "/metrics")[2]


def test_id_offset_answers_global_ids():
    off = 100_000
    with pair(id_offset=off) as p:
        rt = assert_same_knn(p, {"queries": queries(3, 5).tolist()})
        assert min(min(r) for r in rt["ids"]) >= off
        st, res = _write_both(p, "delete", {"ids": [5]})
        assert st == 400 and "id_offset" in res["error"]
        st, res = _write_both(p, "upsert", {"ids": [off + N], "points": [[1.0, 2.0, 3.0]]})
        assert st == 200
        rt = assert_same_knn(p, {"queries": [[1.0, 2.0, 3.0]], "k": 1})
        assert rt["ids"] == [[off + N]]


def test_shutdown_drains_admitted_requests():
    """A batch fault parks the worker, requests pile up in admission, and
    stop() still answers every one of them exactly."""
    st = tlife.build_state(problem=(SEED, DIM, N), k=K, max_batch=MAX_BATCH, device="cpu")
    srv = tsrv.make_server(st, port=0, faults=tfaults.FaultSet("batch=latency:200*1"))
    srv.start(warmup_buckets=WARM)
    want = st.engine.knn_batch(np.concatenate([queries(4, 50)] * 2))[1][:4]
    got = []

    def send(i):
        got.append(call(srv, "POST", "/v1/knn", {"queries": queries(4, 50).tolist()},
                        headers={"X-Request-Id": f"drain-{i}"}))

    threads = [threading.Thread(target=send, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        seen = {e.get("trace") for e in tflight.recorder().snapshot()
                if e["type"] == "serve.admit"}
        if all(f"drain-{i}" in seen for i in range(4)):
            break
        time.sleep(0.005)
    srv.stop()
    for t in threads:
        t.join()
    assert [g[0] for g in got] == [200] * 4
    for _, _, resp in got:
        assert np.array_equal(np.asarray(resp["ids"]), want)
    assert srv.queue.closed and srv.queue.rows == 0
