"""The port's HTTP server against a kdtree_tpu server, both on the CPU on
the same seeded points: the same requests get byte-identical k / ids /
distances / degraded answers (concurrent clients, per-request k,
oversized, an expired deadline, id_offset, writes over HTTP), the same
4xx / 429 / 403 answers, the same /healthz keys, a drained shutdown, the
same approximate answers under a recall_target on k-NN and the verbs,
and the reference's debug endpoints (profile, trace, costs) with no 501
left."""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import tempfile
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
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

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
    assert set(ht) == set(hj)
    for key in ht:
        if key not in ("server_unix", "slo", "headroom"):
            assert ht[key] == hj[key], key
    assert set(ht["slo"]["slos"]) == set(hj["slo"]["slos"])
    # the capacity verdict: the same block; its numbers are each
    # process's own traffic
    assert ht["headroom"]["data"] in (True, False)
    assert set(ht["headroom"]) <= {"data", "window_s", "busy_frac",
                                   "cost_per_query_ms", "observed_rate",
                                   "predicted_rate", "headroom_frac"}


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
    ("/v1/radius", {"queries": queries(5, 71).tolist(), "r": 30.0, "recall_target": 0.9}),
    ("/v1/range", {"lo": (queries(5, 72) - 20).tolist(),
                   "hi": (queries(5, 72) + 20).tolist(), "recall_target": 0.5}),
    ("/v1/count", {"queries": queries(5, 73).tolist(), "r": 40.0, "recall_target": 0.9}),
    ("/v1/knn", {"queries": queries(7, 74).tolist(), "recall_target": 0.5}),
])
def test_recall_target_answers_byte_identical(servers, path, body):
    """The recall dial over HTTP, uncalibrated on both sides (the
    heuristic caps): the same answer bytes, the same gear echo, and
    degraded stays null — a client-requested approximation is a kept
    contract."""
    (sj, _, rj), (st, _, rt) = both(servers, "POST", path, body)
    assert sj == st == 200, (rj, rt)
    for r in (rj, rt):
        r.pop("trace_id", None)
    assert rt == rj
    assert rt["gear"] == f"approx:{body['recall_target']:g}" and rt["degraded"] is None


@pytest.mark.parametrize("path,body", [
    ("/debug/profile?seconds=0", {}),
])
def test_unported_endpoints_answer_501_and_keep_the_connection(servers, path, body):
    """Every endpoint of the reference's item 15 is served now: a bad
    /debug/profile window answers the reference's 400 (its body read, so
    the keep-alive socket stays in sync), the trace and costs GETs answer
    as the reference's do, and no path answers 501. (The name dates from
    when these paths answered 501; it is kept so the test's history reads
    on.)"""
    conn = http.client.HTTPConnection("127.0.0.1", servers[1].server_address[1], timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body))
        resp = conn.getresponse()
        err = json.loads(resp.read())["error"]
        assert resp.status == 400 and "seconds must be in" in err
        # the body was read: the next request on this socket parses cleanly
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
    finally:
        conn.close()
    for get in ("/debug/trace", "/debug/trace/abc", "/debug/costs"):
        (sj, _, _), (st, _, _) = both(servers, "GET", get)
        assert st == sj != 501, get


def test_capture_window_opens_on_the_batch_worker(tmp_path):
    """The batch worker opens and closes a window between batches on its
    own thread (it launches every kernel); once the server stopped, asking
    for one raises instead of waiting forever."""
    with pair() as p:
        srv = p[1]
        stop = threading.Event()

        def client():
            while not stop.is_set():
                call(srv, "POST", "/v1/knn", {"queries": queries(5, 77).tolist()})

        t = threading.Thread(target=client)
        t.start()
        try:
            res = srv.batcher.capture_for(0.3, str(tmp_path))
        finally:
            stop.set()
            t.join(60)
        from kdtree_tpu_torch.obs import timeline as ttl

        trace = ttl.load_trace(res.trace_file)
        worker = srv.batcher._thread.native_id
        dispatch_tids = {e["tid"] for e in trace["traceEvents"]
                         if e.get("name") == "tile.dispatch"}
        assert dispatch_tids == {worker}, (dispatch_tids, worker)
    with pytest.raises(RuntimeError, match="not running"):
        srv.batcher.capture_for(0.1, str(tmp_path))


def test_capture_window_exports_on_the_asking_thread(tmp_path, monkeypatch):
    """The worker only starts and stops the profiler; the thread that asked
    for the window writes the trace, and the result carries what each step
    took (the pause a window puts on serving)."""
    from kdtree_tpu_torch.obs import profile as tprof

    threads = {}
    for step in ("stop", "export"):
        def wrapped(self, _orig=getattr(tprof.Window, step), _step=step):
            threads[_step] = threading.get_ident()
            return _orig(self)

        monkeypatch.setattr(tprof.Window, step, wrapped)
    with pair() as p:
        srv = p[1]
        st, _, _ = call(srv, "POST", "/v1/knn", {"queries": queries(3, 78).tolist()})
        assert st == 200
        res = srv.batcher.capture_for(0.05, str(tmp_path))
        worker = srv.batcher._thread.ident
    assert threads == {"stop": worker, "export": threading.get_ident()}
    assert res.trace_file and os.path.exists(res.trace_file)
    assert min(res.start_seconds, res.stop_seconds, res.export_seconds) >= 0.0
    assert not tprof.capture_active()


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


def _costs_totals(srv):
    st, _, rep = call(srv, "GET", "/debug/costs?window=30")
    assert st == 200 and rep["costs_version"] == 1
    return rep


def test_debug_costs_count_the_answered_requests(servers):
    """Every answered request lands in the ledger once: the delta of
    /debug/costs requests equals the answers sent, on both servers, and
    the payloads have the same keys and class rows."""
    before = [_costs_totals(s)["totals"] for s in servers]
    sizes = (1, 3, 16, 5)
    for i, rows in enumerate(sizes):
        assert_same_knn(servers, {"queries": queries(rows, 300 + i).tolist()})
    (sj, _, _), (st, _, _) = both(servers, "POST", "/v1/count",
                                  {"queries": queries(2, 310).tolist(), "r": 30.0})
    assert sj == st == 200
    after = [_costs_totals(s) for s in servers]
    for b, a in zip(before, after):
        assert a["totals"]["requests"] - b["requests"] == len(sizes) + 1
        assert a["totals"]["rows"] - b["rows"] == sum(sizes) + 2
        assert a["totals"]["bytes_out"] > b["bytes_out"]
    assert set(after[1]) == set(after[0])
    assert {(c["verb"], c["gear"], c["outcome"]) for c in after[1]["classes"]} >= \
        {("knn", "exact", "ok"), ("count", "exact", "ok")}
    assert after[1]["headroom"]["data"] in (True, False)


def test_debug_trace_holds_the_request_spans(servers):
    rid = "trace-me-42"
    for s in servers:
        st, _, body = call(s, "POST", "/v1/knn", {"queries": queries(3, 320).tolist()},
                           headers={"X-Request-Id": rid})
        assert st == 200 and body["trace_id"] == rid
    (sj, _, tj), (st, _, tt) = both(servers, "GET", f"/debug/trace/{rid}")
    assert sj == st == 200 and tt["trace_id"] == tj["trace_id"] == rid
    names = {s["name"] for s in tt["spans"]}
    assert {"serve/request", "serve/queue", "serve/dispatch"} <= names
    assert {n for n in names if n.startswith("serve/")} == \
        {s["name"] for s in tj["spans"] if s["name"].startswith("serve/")}
    root = next(s for s in tt["spans"] if s["name"] == "serve/request")
    kids = [s for s in tt["spans"] if s["parent_id"] == root["span_id"]]
    assert {s["name"] for s in kids} >= {"serve/queue", "serve/dispatch"}
    (sj, _, ij), (st, _, it) = both(servers, "GET", "/debug/trace")
    assert sj == st == 200 and set(it) == set(ij)
    assert both(servers, "GET", "/debug/trace/never-sent")[1][0] == 404


def test_debug_profile_captures_the_worker_under_load(servers):
    """POST /debug/profile?seconds=0.4 while a client keeps the batch
    worker busy: 200 with a timeline whose dispatches are the worker
    thread's tile.dispatch ranges; a second POST while a capture is open
    gets 409; the busy gauge is on /metrics."""
    from kdtree_tpu_torch.obs import profile as tprof

    srv = servers[1]
    stop = threading.Event()
    answered = []

    def client():
        i = 0
        while not stop.is_set():
            st, _, _ = call(srv, "POST", "/v1/knn", {"queries": queries(9, 400 + i).tolist()})
            answered.append(st)
            i += 1

    t = threading.Thread(target=client)
    t.start()
    try:
        deadline = time.monotonic() + 60
        while not answered and time.monotonic() < deadline:
            time.sleep(0.01)
        st, _, rep = call(srv, "POST", "/debug/profile?seconds=0.4")
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive() and set(answered) == {200}
    assert st == 200, rep
    assert rep["seconds_requested"] == 0.4 and rep["device"]["kind"] == "cpu"
    assert rep["dispatches"]["count"] > 0 and rep["device"]["busy_frac"] > 0
    assert rep["timeline_version"] == 1 and rep["trace_file"]
    # a second window while one is asked of the batch worker, and while
    # another part of the process holds the profiler: 409 both
    first = {}
    t = threading.Thread(target=lambda: first.update(
        r=call(srv, "POST", "/debug/profile?seconds=0.3")))
    t.start()
    while srv.batcher._capture_req is None and t.is_alive():
        time.sleep(0.002)
    st, _, busy = call(srv, "POST", "/debug/profile?seconds=0.1")
    t.join(60)
    assert st == 409 and "already" in busy["error"] and first["r"][0] == 200
    with tprof.capture(tempfile.mkdtemp(), device="cpu"):
        st, _, busy = call(srv, "POST", "/debug/profile?seconds=0.1")
    assert st == 409 and "already" in busy["error"]
    for bad in ("0", "61", "-1", "abc"):
        (sj, _, rj), (st, _, rt) = both(servers, "POST", f"/debug/profile?seconds={bad}")
        assert sj == st == 400 and rt == rj
    _, _, text = call(srv, "GET", "/metrics")
    assert "\nkdtree_device_busy_frac " in text and "kdtree_profile_captures_total" in text
