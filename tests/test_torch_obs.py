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
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

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


# the port's runtime families: the counterparts of the reference's jax_*
# families (obs/torchrt.py), with help texts of their own
PORT_RUNTIME_FAMILIES = frozenset({
    "kdtree_kernel_builds_total", "kdtree_kernel_build_seconds_total",
    "torch_platform_info", "torch_device_init_seconds", "torch_device_count",
    "torch_device_memory_bytes",
})


def test_metric_help_texts_are_the_references():
    for name, text in texp.METRIC_HELP.items():
        if name in PORT_RUNTIME_FAMILIES:
            assert text and name not in jexp.METRIC_HELP, name
            continue
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


# ---------------------------------------------------------------------------
# the one-shot report, its renderings, the JSONL log, the runtime facts
# ---------------------------------------------------------------------------


def _report(step: int) -> dict:
    """A report dict as the reference writes it, with every optional
    block the renderers read: spans, cost classes, a capacity block (with
    a slowest trace) and a recall block."""
    from kdtree_tpu.obs import costs as jcosts

    reg = jreg.MetricsRegistry()
    _drive(reg, step)
    reg.histogram("kdtree_span_seconds", buckets=(0.1, 1.0),
                  labels={"span": "query"}).observe(0.2 + step)
    led = jcosts.CostLedger(registry=reg)
    led.attribute_batch(verb="knn", gear=None, span_ms=3.5 + step,
                        members=[(4, 0.5, "ok"), (7, 0.25, "ok")])
    led.attribute_batch(verb="radius", gear="approx:0.9", span_ms=9.0,
                        members=[(1 + step, 1.0, "degraded")], retries=2)
    rep = jexp.report(registry=reg, extra={"platform": "cpu", "passes": 1})
    rep["capacity"] = {
        "knee_rate": 120.0 + step, "slo_ms": 50, "max_bad_frac": 0.01,
        "predicted": {"predicted_rate": 130.0, "cost_per_query_ms": 7.5,
                      "within_band": True, "band": 0.25},
        "steps": [{"rate": 50.0, "sent": 100, "goodput_rps": 49.0, "p50_ms": 3.0,
                   "p95_ms": 9.0, "p99_ms": 12.0 + step, "shed_frac": 0.0,
                   "bad_frac": 0.0, "slowest_trace_id": "abc", "slowest_ms": 40.0,
                   "gears": {"exact": 100 - step}}],
    }
    rep["recall"] = {"n": 100, "q": 10, "k": 4, "nbp": 8, "exact_qps": 1000.0,
                     "curve": [{"visit_cap": 2, "recall": 0.9 - 0.1 * step,
                                "qps": 5000.0, "speedup": 5.0},
                               {"visit_cap": 8, "recall": 1.0, "qps": None,
                                "speedup": None}]}
    return rep


def _port_text(text: str) -> str:
    # the capacity block names each package's own CLI for the waterfall
    return text.replace("kdtree-tpu-torch trace", "kdtree-tpu trace")


@pytest.mark.parametrize("step", [0, 1])
def test_render_report_byte_equal(step):
    rep = _report(step)
    text = texp.render_report(rep)
    assert _port_text(text) == jexp.render_report(rep)
    assert "kdtree-tpu-torch trace --id" in text and "== cost per query" in text


def test_render_report_diff_byte_equal():
    old, new = _report(0), _report(1)
    assert texp.render_report_diff(old, new) == jexp.render_report_diff(old, new)
    new["passes"] = 2
    assert texp.render_report_diff(old, new) == jexp.render_report_diff(old, new)


def test_render_report_reads_the_torch_runtime_facts():
    reg = treg.MetricsRegistry()
    from kdtree_tpu_torch.obs import torchrt

    torchrt.record_device_init(0.25, "cpu", registry=reg)
    reg.counter("kdtree_kernel_builds_total").inc(2)
    reg.counter("kdtree_kernel_build_seconds_total").inc(11.5)
    rep = texp.report(registry=reg)
    text = texp.render_report(rep)
    assert "platform:            cpu\n" in text and "device init:         0.250 s" in text
    assert "devices:             1\n" in text
    assert "kernel builds:       2 (11.50 s total)" in text
    old = dict(rep, counters={})
    assert "kernel builds" in texp.render_report_diff(old, rep)


def test_write_report_has_the_reference_keys(tmp_path):
    """The same keys as the reference's report; the runtime facts are each
    package's own families (torch_* / kdtree_kernel_* against jax_*)."""
    j, t = _pair()
    for s in range(2):
        _drive(j, s)
        _drive(t, s)
    jr = jexp.write_report(str(tmp_path / "j.json"), registry=j, extra={"platform": "cpu"})
    tr = texp.write_report(str(tmp_path / "t.json"), registry=t, extra={"platform": "cpu"})
    assert set(tr) == set(jr)
    for key in ("counters", "gauges", "histograms", "spans", "platform", "report_version"):
        assert tr[key] == jr[key], key
    import json as _json

    assert _json.loads((tmp_path / "t.json").read_text()) == _json.loads(
        _json.dumps(tr))
    assert not list(tmp_path.glob("*.tmp-*"))


def test_jsonl_log_rotates_like_the_reference(tmp_path):
    import json as _json

    for mod, name in ((jexp, "j.jsonl"), (texp, "t.jsonl")):
        path = str(tmp_path / name)
        mod.configure_jsonl(path, max_bytes=400)
        try:
            for i in range(12):
                mod.emit_event({"type": "span", "span": f"s{i}", "seconds": 0.5})
        finally:
            mod.configure_jsonl(None)
    lines = {n: [_json.loads(x) for x in (tmp_path / n).read_text().splitlines()]
             for n in ("j.jsonl", "t.jsonl", "j.jsonl.1", "t.jsonl.1")}
    strip = [[{k: v for k, v in e.items() if k != "ts" and k != "previous"} for e in lines[n]]
             for n in lines]
    assert strip[0] == strip[1] and strip[2] == strip[3]
    assert lines["t.jsonl"][0]["type"] == "rotated"


def test_configure_finalize_writes_the_report(tmp_path):
    from kdtree_tpu_torch.obs import torchrt

    path = str(tmp_path / "m.json")
    try:
        obs.configure(metrics_out=path, device="cpu")
        assert obs.enabled()
        with obs.span("configured.run", sync=False):
            pass
        rep = obs.finalize_guarded(extra={"platform": "cpu"})
    finally:
        obs.set_enabled(None)
        obs._metrics_out_path = None
    assert rep is not None and "configured.run" in rep["spans"]
    assert any(k.startswith("torch_platform_info{") for k in rep["gauges"])
    assert torchrt.snapshot_device_memory() == {}  # a CPU run has no device memory
    assert obs.sidecar_path("x.json") in ("x.json", None)


def test_kernel_build_round_counts_each_source_and_its_wall_once(tmp_path, monkeypatch):
    """Sources built by one parallel nvcc round each count a build, and
    the round's wall time counts once however many of them overlapped."""
    from kdtree_tpu_torch.kernels import _build
    from kdtree_tpu_torch.obs import torchrt

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b", "c"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && out=$2; shift; done\n'
                    'sleep 1\n: > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    reg = obs.get_registry()
    builds = torchrt.build_count()
    secs = reg.counter("kdtree_kernel_build_seconds_total").value
    t0 = time.perf_counter()
    assert set(_build.build()) == {"a", "b", "c"}
    wall = time.perf_counter() - t0
    assert torchrt.build_count() - builds == 3
    got = reg.counter("kdtree_kernel_build_seconds_total").value - secs
    assert 1.0 <= got <= wall < 3.0, (got, wall)
    assert _build.build() == {}  # built: nothing counts again
    assert torchrt.build_count() - builds == 3
