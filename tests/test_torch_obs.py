"""The port's telemetry against kdtree_tpu's: the same metric operations
render a byte-equal Prometheus exposition, the history ring's windowed
queries and the SLO verdicts agree on one synthetic ring, the flight
recorder filters alike, and METRIC_HELP covers every family the port
registers."""

from __future__ import annotations

import ast
import pathlib
import time

import pytest
import torch

import kdtree_tpu_torch
from kdtree_tpu.obs import export as jexp
from kdtree_tpu.obs import flight as jflight
from kdtree_tpu.obs import history as jhist
from kdtree_tpu.obs import registry as jreg
from kdtree_tpu.obs import slo as jslo
from kdtree_tpu_torch import obs
from kdtree_tpu_torch.obs import export as texp
from kdtree_tpu_torch.obs import flight as tflight
from kdtree_tpu_torch.obs import history as thist
from kdtree_tpu_torch.obs import registry as treg
from kdtree_tpu_torch.obs import slo as tslo

torch.set_num_threads(1)

_LAT = 'kdtree_serve_request_seconds{phase="total"}'


def _drive(reg, step: int = 0) -> None:
    """One fixed sequence of metric operations (``step`` scales it)."""
    reg.counter("kdtree_serve_requests_total", labels={"status": "ok"}).inc(3 + step)
    reg.counter("kdtree_serve_requests_total", labels={"status": "shed"}).inc(step % 3)
    reg.counter("kdtree_mutable_writes_total", labels={"op": "upsert"}).inc(0.5)
    reg.gauge("kdtree_epoch").set(step // 4)
    reg.gauge("kdtree_mutable_delta_headroom").set(1.0 - 0.1 * (step % 10))
    h = reg.histogram("kdtree_serve_request_seconds",
                      buckets=(0.001, 0.01, 0.1, 0.25, 1.0), labels={"phase": "total"})
    for v in (0.0005, 0.002, 0.05, 0.3 * (step % 4), 3.0):
        h.observe(v, exemplar=f"t{step}")
    h.observe_array([0.001, 0.02, 0.2, 0.9])
    reg.histogram("kdtree_span_seconds", buckets=(0.1, 1.0),
                  labels={"span": 'serve.batch/"x"\\y\nz'}).observe(0.05)
    reg.counter("kdtree_family_without_help_total").inc()


def _pair():
    return jreg.MetricsRegistry(), treg.MetricsRegistry()


@pytest.mark.parametrize("steps", [1, 3])
def test_prometheus_text_byte_equal(steps):
    j, t = _pair()
    for s in range(steps):
        _drive(j, s)
        _drive(t, s)
    assert texp.prometheus_text(t) == jexp.prometheus_text(j)
    assert "# HELP kdtree_serve_requests_total" in texp.prometheus_text(t)
    assert j.snapshot() == t.snapshot()


def test_openmetrics_text_byte_equal(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    j, t = _pair()
    _drive(j, 2)
    _drive(t, 2)
    out = texp.openmetrics_text(t)
    assert out == jexp.openmetrics_text(j)
    assert out.endswith("# EOF\n") and 'trace_id="t2"' in out


def test_metric_help_texts_are_the_references():
    for name, text in texp.METRIC_HELP.items():
        assert jexp.METRIC_HELP.get(name) == text, name


def test_metric_help_covers_every_registered_family():
    """Every family registered anywhere in kdtree_tpu_torch/ has a
    METRIC_HELP entry: the package AST is scanned for literal name
    arguments of counter()/gauge()/histogram() calls."""
    root = pathlib.Path(kdtree_tpu_torch.__file__).parent
    registered = {}
    for py in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(py.read_text(), filename=str(py))):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            leaf = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else "")
            if leaf not in ("counter", "gauge", "histogram"):
                continue
            arg = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "name"), None)
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                registered.setdefault(arg.value, f"{py}:{node.lineno}")
    assert len(registered) >= 20, registered
    missing = {n: at for n, at in registered.items() if n not in texp.METRIC_HELP}
    assert not missing, missing


# ---------------------------------------------------------------------------
# history + SLOs on one synthetic ring
# ---------------------------------------------------------------------------


def _ring(kind: str):
    """The same synthetic ring in both packages: 40 one-second samples of
    a registry driven by ``kind`` traffic."""
    j, t = _pair()
    hj, ht = jhist.MetricHistory(), thist.MetricHistory()
    for s in range(40):
        for reg in (j, t):
            ok = reg.counter("kdtree_serve_requests_total", labels={"status": "ok"})
            lat = reg.histogram("kdtree_serve_request_seconds",
                                buckets=(0.01, 0.1, 0.25, 1.0), labels={"phase": "total"})
            ok.inc(10)
            if kind == "shed" and s > 20:
                reg.counter("kdtree_serve_requests_total",
                            labels={"status": "shed"}).inc(8)
            lat.observe(0.5 if kind == "slow" and s > 10 else 0.005)
            if kind == "backlog":
                reg.gauge("kdtree_mutable_delta_headroom").set(0.05 if s > 5 else 0.9)
        hj.record(j.snapshot(), ts=1000.0 + s)
        ht.record(t.snapshot(), ts=1000.0 + s)
    return hj, ht


@pytest.mark.parametrize("kind", ["idle", "shed", "slow", "backlog"])
def test_history_queries_match(kind):
    hj, ht = _ring(kind)
    now = 1039.0
    for w in (5.0, 10.0, 60.0):
        for q in (0.5, 0.9, 0.99):
            assert ht.quantile(_LAT, q, w, now) == hj.quantile(_LAT, q, w, now)
        assert ht.frac_le(_LAT, 0.25, w, now) == hj.frac_le(_LAT, 0.25, w, now)
        assert ht.hist_delta("kdtree_serve_request_seconds", w, now) == \
            hj.hist_delta("kdtree_serve_request_seconds", w, now)
        for key in ("kdtree_serve_requests_total",
                    'kdtree_serve_requests_total{status="shed"}'):
            assert ht.counter_delta(key, w, now) == hj.counter_delta(key, w, now)
            assert ht.counter_rate(key, w, now) == hj.counter_rate(key, w, now)
        key = "kdtree_mutable_delta_headroom"
        assert ht.gauge_stats(key, w, now) == hj.gauge_stats(key, w, now)
    rt, rj = ht.report(limit=3), hj.report(limit=3)
    for r in (rt, rj):
        r.pop("generated_unix")
    assert rt == rj


@pytest.mark.parametrize("kind", ["idle", "shed", "slow", "backlog"])
def test_slo_verdicts_match(kind):
    hj, ht = _ring(kind)
    rj, rt = _pair()
    ej = jslo.SloEngine(specs=jslo.default_specs() + jslo.mutable_specs()
                        + jslo.recall_specs(), history=hj, registry=rj)
    et = tslo.SloEngine(specs=tslo.default_specs() + tslo.mutable_specs()
                        + tslo.recall_specs(), history=ht, registry=rt)
    assert [s.name for s in et.specs] == [s.name for s in ej.specs]
    for now in (1020.0, 1039.0):
        got = et.evaluate(now=now)
        want = ej.evaluate(now=now)
        for d in list(got.values()) + list(want.values()):
            d.pop("objective")  # prose; the port names its missing feeds
        assert got == want
    assert et.health_block() == ej.health_block()
    blk = et.health_block()["slos"]
    assert blk["device-busy"]["data"] is False and blk["served-recall"]["data"] is False
    expect = {"idle": "OK", "shed": "PAGE", "slow": "PAGE", "backlog": "PAGE"}[kind]
    assert et.health_block()["state"] == expect
    assert texp.prometheus_text(rt) == jexp.prometheus_text(rj)


# ---------------------------------------------------------------------------
# flight recorder + spans
# ---------------------------------------------------------------------------


def test_flight_ring_and_filters_match():
    rj, rt = jflight.FlightRecorder(capacity=8), tflight.FlightRecorder(capacity=8)
    events = [("serve.admit", {"trace": "a", "rows": 3}),
              ("serve.batch", {"traces": ["a", "b"], "rows": 9}),
              ("serve.request", {"trace": "b", "degraded": "deadline"}),
              ("slo.transition", {"reason": "x"})] * 3
    for kind, f in events:
        rj.record(kind, **f)
        rt.record(kind, **f)
    sj, st = rj.snapshot(), rt.snapshot()
    for e in sj + st:
        e.pop("ts")
    assert st == sj and rt.stats() == rj.stats() == {"capacity": 8, "events": 8, "dropped": 4}
    for trace, reason in (("a", None), ("b", None), (None, "deadline"), ("b", "deadline")):
        assert tflight.filter_events(st, trace, reason) == jflight.filter_events(sj, trace, reason)
    bj, bt = jflight.BurstDetector(3, 10.0), tflight.BurstDetector(3, 10.0)
    assert [bt.mark() for _ in range(7)] == [bj.mark() for _ in range(7)]


def test_flight_dump_is_atomic_json(tmp_path):
    import json

    rec = tflight.FlightRecorder(capacity=4)
    rec.record("serve.batch", rows=1, obj=object())  # default=str keeps it
    path = rec.dump(str(tmp_path / "f.json"), reason="test")
    rep = json.loads(pathlib.Path(path).read_text())
    assert rep["reason"] == "test" and rep["events"][0]["rows"] == 1
    assert not list(tmp_path.glob("*.tmp-*"))


def test_span_records_histogram_and_flight_event():
    reg = treg.MetricsRegistry()
    with obs.span("outer", registry=reg, sync=False):
        with obs.span("inner", registry=reg, q=4) as sp:
            sp.append(torch.ones(3))  # a CPU tensor: nothing to wait for
    snap = reg.snapshot()["histograms"]
    assert snap['kdtree_span_seconds{span="outer/inner"}']["count"] == 1
    assert snap['kdtree_span_seconds{span="outer"}']["count"] == 1
    ev = [e for e in tflight.recorder().snapshot()
          if e["type"] == "span" and e.get("span") == "outer/inner"]
    assert ev and ev[-1]["q"] == 4 and ev[-1]["synced"] is True


def test_defer_flush_runs_callbacks_and_survives_errors():
    ran = []
    obs.defer(lambda: ran.append(1))
    obs.defer(lambda: 1 / 0)
    obs.defer(lambda: ran.append(2))
    obs.flush()
    assert ran == [1, 2]
    obs.set_enabled(True)
    assert obs.enabled()
    obs.set_enabled(None)
