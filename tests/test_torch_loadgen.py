"""The port's load harness (``kdtree_tpu_torch/loadgen/``) against
``kdtree_tpu``'s, in one process: the same seed gives the reference's
schedule arrival by arrival (exact: times to 1e-9 s as ``Arrival.key``
rounds them, ops, ids, points, recall targets, verbs), the parsers and
``compute_knee`` agree, and ``run_load`` against an in-process port
server yields a well-formed capacity block whose offered rate reaches
the server's ``kdtree_loadgen_offered_rate`` gauge and flight ring. The
``loadgen`` and ``route`` commands resolve no device."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from kdtree_tpu.loadgen import runner as jrunner
from kdtree_tpu.loadgen import schedule as jsched
from kdtree_tpu_torch import obs as tobs
from kdtree_tpu_torch.loadgen import runner as trunner
from kdtree_tpu_torch.loadgen import schedule as tsched
from kdtree_tpu_torch.obs import flight as tflight
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

SCHEDULES = [
    dict(rates=[20, 40], step_seconds=1.0, seed=7, dim=3),
    dict(rates=[200], step_seconds=2.0, seed=5, dim=2, shape="diurnal", diurnal_amp=0.5),
    dict(rates=[300], step_seconds=2.0, seed=9, dim=3, mix="query:0.4,upsert:0.3,delete:0.3",
         write_base=1000, regions=16, zipf_s=1.5),
    dict(rates=[50, 100], step_seconds=1.0, seed=11, dim=4,
         recall="exact:0.5,0.99:0.3,0.9:0.2", verbs="knn:0.7,radius:0.2,count:0.1"),
    dict(rates=[30], step_seconds=3.0, seed=3, dim=8, verbs="range:1", recall="0.9"),
]


def _build(mod, cfg):
    cfg = dict(cfg)
    mix = cfg.pop("mix", None)
    recall = cfg.pop("recall", None)
    verbs = cfg.pop("verbs", None)
    return mod.build_schedule(
        cfg.pop("rates"), cfg.pop("step_seconds"), cfg.pop("seed"), cfg.pop("dim"),
        mix=mod.parse_mix(mix) if mix else None,
        recall_mix=mod.parse_recall_mix(recall), verb_mix=mod.parse_verb_mix(verbs), **cfg)


@pytest.mark.parametrize("cfg", SCHEDULES, ids=range(len(SCHEDULES)))
def test_same_seed_gives_the_reference_schedule(cfg):
    t, j = _build(tsched, cfg), _build(jsched, cfg)
    assert len(t.arrivals) == len(j.arrivals) > 0
    assert t.keys() == j.keys()
    for a, b in zip(t.arrivals, j.arrivals):
        assert (a.t, a.step, a.op, a.gid, a.recall, a.verb) == \
            (b.t, b.step, b.op, b.gid, b.recall, b.verb)
        assert (a.point is None) == (b.point is None)
        if a.point is not None:
            assert np.asarray(a.point).tobytes() == np.asarray(b.point).tobytes()
    assert t.describe() == j.describe() and t.duration_s == j.duration_s
    assert t.keys() == _build(tsched, cfg).keys()  # and again: seeded
    assert t.keys() != _build(tsched, {**cfg, "seed": cfg["seed"] + 1}).keys()


@pytest.mark.parametrize("parse,raw", [
    ("parse_mix", "query:3,upsert:1"), ("parse_mix", "query:nope"), ("parse_mix", "upsrt:1"),
    ("parse_mix", "query:0,upsert:0"), ("parse_recall_mix", None),
    ("parse_recall_mix", "0.99"), ("parse_recall_mix", "exact:1,0.9:3"),
    ("parse_recall_mix", "1.5"), ("parse_verb_mix", "knn:0.7,radius:0.2,count:0.1"),
    ("parse_verb_mix", "walk:1"), ("parse_verb_mix", None),
])
def test_parsers_equal_reference(parse, raw):
    def run(mod):
        try:
            out = getattr(mod, parse)(raw)
        except ValueError as e:
            return ("error", str(e))
        return out.describe() if isinstance(out, mod.MixSpec) else out

    assert run(tsched) == run(jsched)


def test_compute_knee_equals_reference():
    steps = [
        {"rate": 10, "sent": 20, "p50_ms": 20.0, "p95_ms": 30.0, "p99_ms": 50.0,
         "bad_frac": 0.0},
        {"rate": 20, "sent": 40, "p50_ms": 40.0, "p95_ms": 80.0, "p99_ms": 100.0,
         "bad_frac": 0.01},
        {"rate": 40, "sent": 80, "p50_ms": 300.0, "p95_ms": 350.0, "p99_ms": 400.0,
         "bad_frac": 0.0},
        {"rate": 80, "sent": 80, "p50_ms": 30.0, "p95_ms": 40.0, "p99_ms": 60.0,
         "bad_frac": 0.5},
    ]
    for kw in (dict(slo_ms=250), dict(slo_ms=15), dict(slo_ms=250, slo_quantile=0.5),
               dict(slo_ms=45, slo_quantile=0.95, max_bad_frac=0.6)):
        assert trunner.compute_knee(steps, **kw) == jrunner.compute_knee(steps, **kw)
    assert trunner.compute_knee(steps, slo_ms=250) == 20.0
    with pytest.raises(ValueError):
        trunner.compute_knee(steps, slo_ms=250, slo_quantile=0.9)


@pytest.fixture(scope="module")
def port_server():
    from kdtree_tpu_torch.serve import engine, server

    pts = np.random.default_rng(7).random((4096, 3)).astype(np.float32)
    state = engine.build_state(points=pts, k=4, max_batch=64, max_delta_rows=1 << 20,
                               device="cpu")
    httpd = server.make_server(state, port=0, max_wait_ms=1.0)
    httpd.start(warmup_buckets=[8])
    yield httpd
    httpd.stop()


def _target(httpd):
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def test_run_load_against_a_port_server(port_server):
    """A mixed read/write ladder: every arrival sent and answered, the
    capacity block's steps, knee and server-side write evidence, and the
    step's offered rate on the server's gauge and flight ring."""
    target = _target(port_server)
    facts = trunner.discover(target, retries=10)
    assert facts == jrunner.discover(target, retries=10)
    assert facts["dim"] == 3 and facts["n"] == 4096 and facts["write_base"] >= 4096
    sched = tsched.build_schedule([15, 30], 1.0, 7, 3,
                                  mix=tsched.MixSpec(0.8, 0.15, 0.05),
                                  write_base=facts["write_base"])
    keys = sched.keys()
    rep = trunner.run_load(target, sched, k=4, slo_ms=5000.0, timeout_s=60.0)
    assert sched.keys() == keys  # open loop: the run never touched it
    cap = rep["capacity"]
    assert [s["rate"] for s in cap["steps"]] == [15.0, 30.0]
    for s in cap["steps"]:
        assert s["sent"] == s["intended"] > 0 and s["errors"] == s["timeouts"] == 0
        assert s["shed"] == 0 and s["goodput_rps"] > 0
        assert s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    assert cap["knee_rate"] == trunner.compute_knee(cap["steps"], slo_ms=5000.0) == 30.0
    assert cap["server"]["write_latency_ms"]["upsert"]["count"] > 0
    gauges = tobs.get_registry().snapshot()["gauges"]
    assert gauges["kdtree_loadgen_offered_rate"] == 30.0
    rates = [e["rate"] for e in tflight.recorder().snapshot() if e.get("type") == "loadgen.rate"]
    assert rates[-2:] == [15.0, 30.0]


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, out.getvalue(), err.getvalue()


def test_loadgen_cli_resolves_no_device(port_server, tmp_path, monkeypatch):
    """``loadgen`` (and ``route``) are host code: with the device
    resolver and CUDA's initializer booby-trapped they still run, and the
    ``--metrics-out`` sidecar carries the capacity block."""
    import kdtree_tpu_torch
    from kdtree_tpu_torch.utils import cli as tcli

    def boom(*a, **k):
        raise AssertionError("a host-only command touched the device")

    monkeypatch.setattr(kdtree_tpu_torch, "resolve_device", boom)
    monkeypatch.setattr(torch.cuda, "_lazy_init", boom)
    side, out_json = tmp_path / "side.json", tmp_path / "lg.json"
    code, out, err = _run(tcli.main, [
        "--metrics-out", str(side), "loadgen", "--target", _target(port_server),
        "--rates", "10", "--step-seconds", "1", "--mix", "query:1", "--seed", "3",
        "--slo-ms", "5000", "--out", str(out_json)])
    assert code == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["knee_rate"] == 10.0 and line["steps"] == 1 and line["arrivals"] > 0
    assert "== capacity (open-loop load harness) ==" in err
    assert json.loads(out_json.read_text())["capacity"]["knee_rate"] == 10.0
    assert json.loads(side.read_text())["capacity"]["knee_rate"] == 10.0
    code, _, err = _run(tcli.main, ["loadgen", "--target", _target(port_server),
                                    "--rates", "10", "--slo-quantile", "0.9"])
    assert code == 1 and "--slo-quantile" in err
    code, _, err = _run(tcli.main, ["route", "--port", "0"])
    assert code == 1 and "at least one --shard" in err
    assert not torch.cuda.is_initialized()
