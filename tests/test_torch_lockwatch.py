"""The port's runtime lock-order sanitizer
(``kdtree_tpu_torch/analysis/lockwatch.py``) held to the contract of the
reference's (``tests/test_lockwatch.py``): factory semantics, the order
graph, cycle and self-deadlock fail-fast, reentrancy, the I/O hold budget
and strict mode, Condition integration, the artifact, and the serving
stack's own locks under instrumentation. The same acquisition scripts run
through both packages' sanitizers give equal graphs (pids, times and
stack paths aside)."""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from kdtree_tpu.analysis import lockwatch as jlw
from kdtree_tpu_torch.analysis import lockwatch
from kdtree_tpu_torch.utils import locks


def _isolated(w):
    """Stash the process watcher's graph, hand out a clean one, merge the
    stash back afterwards (an env-enabled run's evidence must survive)."""
    saved = w.export_state()
    w.reset()
    return saved


@pytest.fixture
def watched(monkeypatch, tmp_path):
    """Lockwatch ON (the environment variable is shared by both packages)
    with an isolated artifact dir and fresh graphs in both watchers."""
    monkeypatch.setenv(lockwatch.ENV_ENABLE, "1")
    monkeypatch.setenv(lockwatch.ENV_DIR, str(tmp_path))
    monkeypatch.delenv(lockwatch.ENV_STRICT, raising=False)
    w, jw = lockwatch.watcher(), jlw.watcher()
    saved, jsaved = _isolated(w), _isolated(jw)
    yield w
    w.reset()
    w.merge_state(saved)
    jw.reset()
    jw.merge_state(jsaved)


# ---------------------------------------------------------------------------
# factory semantics
# ---------------------------------------------------------------------------


def test_disabled_factories_return_plain_stdlib(monkeypatch):
    monkeypatch.delenv(lockwatch.ENV_ENABLE, raising=False)
    for mod in (lockwatch, locks):
        assert type(mod.make_lock("x")) is type(threading.Lock())
        assert isinstance(mod.make_rlock("x"), type(threading.RLock()))
        assert isinstance(mod.make_condition("x"), threading.Condition)


@pytest.mark.parametrize("value,on", [("1", True), ("true", True), ("ON", True),
                                      ("0", False), ("", False), ("yes", False)])
def test_enable_values_as_the_reference(monkeypatch, value, on):
    monkeypatch.setenv(lockwatch.ENV_ENABLE, value)
    assert lockwatch.enabled() is on is jlw.enabled()


def test_enabled_factories_instrument_through_utils_locks(watched):
    lk = locks.make_lock("t.lock")
    assert isinstance(lk, lockwatch.WatchedLock)
    with lk:
        assert lk.locked()
    assert not lk.locked()
    assert isinstance(locks.make_rlock("t.rlock"), lockwatch.WatchedRLock)
    assert isinstance(locks.make_condition("t.cond")._lock, lockwatch.WatchedRLock)


def test_order_graph_records_edges_and_counts(watched):
    a, b = lockwatch.make_lock("t.a"), lockwatch.make_lock("t.b")
    for _ in range(3):
        with a:
            with b:
                pass
    rep = watched.report()
    edges = {(e["from"], e["to"]): e for e in rep["edges"]}
    assert edges[("t.a", "t.b")]["count"] == 3
    assert edges[("t.a", "t.b")]["stack"]
    assert rep["cycles"] == []


def test_lock_order_inversion_raises_and_records(watched):
    a, b = lockwatch.make_lock("t.a"), lockwatch.make_lock("t.b")
    with a:
        with b:
            pass
    err = []

    def inverted():
        try:
            with b:
                with a:
                    pass
        except lockwatch.LockOrderError as e:
            err.append(e)

    t = threading.Thread(target=inverted)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert err and "t.a" in str(err[0]) and "t.b" in str(err[0])
    assert watched.cycles()


def test_nonreentrant_self_reacquire_raises(watched):
    lk = lockwatch.make_lock("t.self")
    lk.acquire()
    with pytest.raises(lockwatch.LockOrderError, match="re-acquired"):
        lk.acquire()
    lk.release()


def test_rlock_reentrancy_is_clean(watched):
    rk = lockwatch.make_rlock("t.ring")
    with rk:
        with rk:
            with rk:
                pass
    assert watched.cycles() == []
    assert all(e["from"] != e["to"] for e in watched.report()["edges"])


def test_nested_rlock_reacquire_with_intervening_lock_is_clean(watched):
    r, a = lockwatch.make_rlock("t.outer"), lockwatch.make_lock("t.mid")
    with r:
        with a:
            with r:
                pass
    assert watched.cycles() == []
    assert ("t.mid", "t.outer") not in {(e["from"], e["to"]) for e in watched.report()["edges"]}


def test_same_name_different_instances_do_not_false_cycle(watched):
    a1, a2 = lockwatch.make_lock("t.shard"), lockwatch.make_lock("t.shard")
    with a1:
        with a2:
            pass
    assert watched.cycles() == []


def test_io_hold_past_budget_is_recorded(watched, monkeypatch, tmp_path):
    monkeypatch.setenv(lockwatch.ENV_HOLD_MS, "1")
    lk = lockwatch.make_lock("t.io")
    with lk:
        (tmp_path / "x").write_text("x")
        time.sleep(0.01)
    v = [x for x in watched.violations() if x["lock"] == "t.io"]
    assert v and v[0]["held_ms"] > 1.0 and v[0]["io"] is True


def test_io_free_hold_is_not_a_violation(watched, monkeypatch):
    monkeypatch.setenv(lockwatch.ENV_HOLD_MS, "1")
    lk = lockwatch.make_lock("t.cpu")
    with lk:
        time.sleep(0.01)
    assert not [x for x in watched.violations() if x["lock"] == "t.cpu"]


def test_strict_mode_raises_deferred_at_next_acquire(watched, monkeypatch, tmp_path):
    monkeypatch.setenv(lockwatch.ENV_HOLD_MS, "1")
    monkeypatch.setenv(lockwatch.ENV_STRICT, "1")
    lk = lockwatch.make_lock("t.strict")
    with lk:
        (tmp_path / "y").write_text("y")
        time.sleep(0.01)
    assert not lk.locked()
    with pytest.raises(lockwatch.LockHoldError, match="while performing"):
        lk.acquire()
    with lk:
        pass


def test_strict_mode_does_not_mask_with_body_exception(watched, monkeypatch, tmp_path):
    monkeypatch.setenv(lockwatch.ENV_HOLD_MS, "1")
    monkeypatch.setenv(lockwatch.ENV_STRICT, "1")
    lk = lockwatch.make_lock("t.strict2")
    with pytest.raises(ValueError, match="the real failure"):
        with lk:
            (tmp_path / "z").write_text("z")
            time.sleep(0.01)
            raise ValueError("the real failure")
    with pytest.raises(lockwatch.LockHoldError):
        lk.acquire()


def test_condition_wait_notify_roundtrip(watched):
    cond = lockwatch.make_condition("t.cond")
    got = []

    def waiter():
        with cond:
            cond.wait(timeout=10)
            got.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join(timeout=10)
    assert got == [1] and watched.cycles() == []


def test_strict_mode_survives_condition_wait(watched, monkeypatch, tmp_path):
    monkeypatch.setenv(lockwatch.ENV_HOLD_MS, "1")
    monkeypatch.setenv(lockwatch.ENV_STRICT, "1")
    cond = lockwatch.make_condition("t.strictcond")
    with cond:
        (tmp_path / "w").write_text("w")
        time.sleep(0.01)
        cond.wait(timeout=0.05)
        assert cond._lock._count == 1
    with pytest.raises(lockwatch.LockHoldError):
        cond.acquire()


def test_condition_wait_releases_recursive_holds(watched):
    cond = lockwatch.make_condition("t.rcond")
    got = []

    def waiter():
        cond.acquire()
        cond.acquire()
        cond.wait(timeout=10)
        got.append(cond._lock._count)
        cond.release()
        cond.release()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join(timeout=10)
    assert got == [2] and watched.cycles() == []


def test_rlock_release_race_leaves_no_stranded_entries(watched):
    shared = lockwatch.make_rlock("t.race")
    probes = [lockwatch.make_lock(f"t.probe{i}") for i in range(2)]

    def churn(i):
        for _ in range(2000):
            with shared:
                pass
        with probes[i]:
            pass

    threads = [threading.Thread(target=churn, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not [e for e in watched.report()["edges"] if e["from"] == "t.race"]


def test_dump_artifact_schema(watched, tmp_path):
    a, b = lockwatch.make_lock("t.a"), lockwatch.make_lock("t.b")
    with a:
        with b:
            pass
    path = lockwatch.dump(str(tmp_path / "graph.json"))
    doc = json.load(open(path))
    assert doc["lockwatch_version"] == lockwatch.LOCKWATCH_VERSION == jlw.LOCKWATCH_VERSION
    assert doc["pid"] == os.getpid() and doc["locks"]["t.a"] >= 1
    assert {"from": "t.a", "to": "t.b"}.items() <= doc["edges"][0].items()
    assert doc["cycles"] == [] and isinstance(doc["violations"], list)


def test_default_dump_path_is_pid_suffixed(watched, tmp_path):
    lk = lockwatch.make_lock("t.a")
    with lk:
        pass
    path = lockwatch.dump()
    assert path == str(tmp_path / f"lockwatch-graph-{os.getpid()}.json")
    assert json.load(open(path))["locks"]


# ---------------------------------------------------------------------------
# the same acquisition scripts through both sanitizers
# ---------------------------------------------------------------------------


def _nested(mod):
    a, b, c = mod.make_lock("s.a"), mod.make_lock("s.b"), mod.make_rlock("s.c")
    d = mod.make_lock("s.d")
    for _ in range(2):
        with a:
            with b:
                with c:
                    with c:
                        pass
    with c:
        with d:
            with c:
                pass


def _inversion(mod):
    a, b = mod.make_lock("s.x"), mod.make_lock("s.y")
    with a:
        with b:
            pass
    with b:
        try:
            with a:
                pass
        except mod.LockOrderError:
            pass


def _self_deadlock(mod):
    lk = mod.make_lock("s.self")
    with lk:
        try:
            lk.acquire()
        except mod.LockOrderError:
            pass


def _io_hold(mod, path):
    lk = mod.make_lock("s.io")
    cond = mod.make_condition("s.cond")
    with lk:
        with open(path, "w") as f:
            f.write("x")
        time.sleep(0.01)
    with cond:
        with lk:
            pass
        cond.notify_all()


def _threads(mod):
    shared, inner = mod.make_rlock("s.shared"), mod.make_lock("s.inner")

    def work():
        for _ in range(50):
            with shared:
                with inner:
                    pass

    ts = [threading.Thread(target=work) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)


SCRIPTS = {"nested": _nested, "inversion": _inversion, "self_deadlock": _self_deadlock,
           "io_hold": _io_hold, "threads": _threads}


def _graph(rep):
    """A report without what differs between processes and packages, and
    without any lock outside the scripts' ``s.`` roles (a thread that an
    earlier test left running may take watched locks of its own)."""
    def mine(name):
        return name.startswith("s.")

    return {
        "locks": {n: c for n, c in rep["locks"].items() if mine(n)},
        "edges": [(e["from"], e["to"], e["count"]) for e in rep["edges"]
                  if mine(e["from"]) and mine(e["to"])],
        "cycles": [c for c in rep["cycles"] if all(mine(n) for n in c)],
        "violations": [(v["lock"], v["io"], v["budget_ms"]) for v in rep["violations"]
                       if mine(v["lock"])],
        "strict": rep["strict"],
        "hold_budget_ms": rep["hold_budget_ms"],
        "keys": sorted(rep),
    }


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_script_gives_equal_graphs(watched, monkeypatch, tmp_path, name):
    # A 1 ms budget for the script that tests it; the others would meet it
    # or not by timing alone, since a cycle's artifact is written under the
    # lock being acquired against (inversion, self_deadlock)
    monkeypatch.setenv(lockwatch.ENV_HOLD_MS, "1" if name == "io_hold" else "60000")
    graphs = []
    for mod, w in ((jlw, jlw.watcher()), (lockwatch, watched)):
        args = (tmp_path / f"{mod.__name__}.txt",) if name == "io_hold" else ()
        SCRIPTS[name](mod, *args)
        path = w.dump(str(tmp_path / f"{mod.__name__}.json"))
        graphs.append(_graph(json.load(open(path))))
    assert graphs[1] == graphs[0], json.dumps(graphs, indent=1)
    assert graphs[1]["locks"]
    assert bool(graphs[1]["cycles"]) is (name in ("inversion", "self_deadlock"))
    assert bool(graphs[1]["violations"]) is (name == "io_hold")


# ---------------------------------------------------------------------------
# the serving stack's own locks under the sanitizer
# ---------------------------------------------------------------------------


@pytest.mark.skipif(not hasattr(signal, "SIGUSR2"), reason="platform has no SIGUSR2")
def test_sigusr2_inside_record_critical_section_under_lockwatch(watched, tmp_path):
    """The signal handler fires while the main thread holds the flight
    ring's lock and dumps the ring: the reentrant acquire succeeds, no
    LockOrderError, and the dump parses."""
    from kdtree_tpu_torch.obs.flight import FlightRecorder

    rec = FlightRecorder(capacity=64)
    assert isinstance(rec._lock, lockwatch.WatchedRLock)
    for i in range(5):
        rec.record("warmup", i=i)
    dump_path = tmp_path / "flight-sig.json"
    fired = []

    def _on_sig(signum, frame):
        fired.append(rec.dump(str(dump_path), reason="in-critical-section"))

    old = signal.signal(signal.SIGUSR2, _on_sig)
    try:
        with rec._lock:
            os.kill(os.getpid(), signal.SIGUSR2)
            for _ in range(1000):
                if fired:
                    break
    finally:
        signal.signal(signal.SIGUSR2, old)
    assert fired
    doc = json.load(open(dump_path))
    assert doc["reason"] == "in-critical-section" and len(doc["events"]) == 5
    assert watched.cycles() == []


def test_breaker_transition_io_runs_outside_lock_under_lockwatch(watched, monkeypatch, tmp_path):
    """The open-transition reporter writes a file past the hold budget
    while threads hammer allow(): no I/O-under-lock violation on
    ``route.breaker`` and no cycle."""
    from kdtree_tpu_torch.serve.router import CircuitBreaker

    monkeypatch.setenv(lockwatch.ENV_HOLD_MS, "5")
    dump_file = tmp_path / "breaker-dump.json"

    def slow_reporter(old, new):
        dump_file.write_text(json.dumps({"from": old, "to": new}))
        time.sleep(0.02)

    br = CircuitBreaker(failures=2, reset_s=0.05, on_transition=slow_reporter)
    assert isinstance(br._lock, lockwatch.WatchedLock)
    stop = threading.Event()
    errors = []

    def hammer():
        try:
            while not stop.is_set():
                br.allow()
        except Exception as e:  # LockOrderError included
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(6):
            br.record_failure()
            br.record_failure()
            time.sleep(0.06)
            br.allow()
            br.record_success()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not errors and dump_file.exists()
    assert not [v for v in watched.violations() if v["lock"] == "route.breaker"]
    assert watched.cycles() == []


def test_admission_queue_under_lockwatch(watched):
    """The admission queue's watched Condition across threads: submit /
    pop_wait with flight events recorded under it stays acyclic."""
    from kdtree_tpu_torch.serve.admission import AdmissionQueue, PendingRequest

    q = AdmissionQueue(max_rows=8)
    popped = []

    def worker():
        while True:
            req = q.pop_wait(2.0)
            if req is None:
                return
            popped.append(req)
            req.fulfill(None, None)

    t = threading.Thread(target=worker)
    t.start()
    reqs = [PendingRequest(np.zeros((1, 3), np.float32), 1) for _ in range(4)]
    for r in reqs:
        q.submit(r)
    for r in reqs:
        assert r.event.wait(5)
    q.close()
    t.join(timeout=10)
    assert not t.is_alive() and len(popped) == 4
    assert watched.cycles() == []
    assert "serve.admission" in watched.report()["locks"]
