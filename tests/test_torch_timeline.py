"""The port's device timeline (``kdtree_tpu_torch/obs/timeline.py`` and
``obs/profile.py``) against the reference's parser.

The same intervals, laid out once as the reference's trace (a
``/device:*`` process, op slices with ``hlo_module`` args) and once as a
torch.profiler Kineto trace (``cat: kernel`` slices on a GPU stream, host
ranges as ``user_annotation``), must give equal busy/idle µs, dispatch
windows and lag percentiles, compile counts and span correlation. A
``gpu_user_annotation`` never adds to busy time. A real CPU capture of the
tiled engine shows one ``tile.dispatch`` per batch and retry, leaves the
answers bit-identical, and a window opened on one thread sees another
thread's dispatches.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from kdtree_tpu.obs import timeline as jtl
from kdtree_tpu_torch.obs import profile as tprof
from kdtree_tpu_torch.obs import registry as treg
from kdtree_tpu_torch.obs import timeline as ttl
from kdtree_tpu_torch.ops import tile_query as tqm
from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
from kdtree_tpu_torch.ops.morton import build_morton
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

torch.set_num_threads(1)

KERNELS = ("scan_knn_kernel", "scan_knn_merge_kernel", "elementwise_kernel",
           "Memcpy DtoH (Device -> Pinned)")


def _intervals(seed: int) -> dict:
    """One synthetic capture: exec slices on two streams (overlapping
    across streams), host spans, dispatches with retire/drain stages and
    kernel builds, all in µs."""
    rng = np.random.default_rng(seed)
    ex = []
    for stream in (7, 9):
        t = float(rng.uniform(0, 50))
        for _ in range(int(rng.integers(20, 40))):
            t += float(rng.uniform(0, 30))
            dur = float(rng.uniform(1, 40))
            ex.append((KERNELS[int(rng.integers(len(KERNELS)))], t, dur, stream))
            t += dur
    end = max(s + d for _, s, d, _ in ex)
    disp = np.sort(rng.uniform(0, end, int(rng.integers(3, 9))))
    stages = []
    for a, b in zip(disp, list(disp[1:]) + [end]):
        if rng.random() < 0.7:
            s = float(rng.uniform(a, b))
            stages.append(("tile.retire" if rng.random() < 0.6 else "tile.drain",
                           s, float(rng.uniform(0, b - s))))
    spans = [("serve.batch", float(s), float(rng.uniform(5, 200)))
             for s in rng.uniform(0, end, int(rng.integers(2, 6)))]
    spans.append(("profile.query", 0.0, end))
    builds = [(float(s), float(rng.uniform(10, 90)))
              for s in rng.uniform(0, end, int(rng.integers(0, 3)))]
    return {"exec": ex, "disp": [float(d) for d in disp], "stages": stages,
            "spans": spans, "builds": builds}


def _X(name, ts, dur, pid, tid, **kw):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}
    e.update(kw)
    return e


def _reference_layout(iv: dict) -> dict:
    ev = [{"ph": "M", "name": "process_name", "pid": 1,
           "args": {"name": "/device:GPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 2,
           "args": {"name": "/host:CPU"}}]
    for name, s, d, stream in iv["exec"]:
        ev.append(_X(name, s, d, 1, stream, args={"hlo_op": name, "hlo_module": name}))
    for i, s in enumerate(iv["disp"]):
        ev.append(_X("tile.dispatch", s, 3.0, 2, 1, args={"batch": i}))
    for name, s, d in iv["stages"] + iv["spans"]:
        ev.append(_X(name, s, d, 2, 1))
    for s, d in iv["builds"]:
        ev.append(_X("backend_compile", s, d, 2, 1))
    return {"traceEvents": ev}


def _kineto_layout(iv: dict, annotations: bool = True) -> dict:
    """The torch.profiler form of the same intervals, with the events a
    real Kineto trace carries beside them that must count for nothing:
    the host's launch calls, the CPU ops, and the device-side shadows of
    the host ranges."""
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}}]
    cats = {"Memcpy DtoH (Device -> Pinned)": "gpu_memcpy"}
    for name, s, d, stream in iv["exec"]:
        ev.append(_X(name, s, d, 0, stream, cat=cats.get(name, "kernel"),
                     args={"device": 0, "stream": stream}))
        ev.append(_X("cudaLaunchKernel", max(s - 5.0, 0.0), 2.0, 100, 100,
                     cat="cuda_runtime"))
    for i, s in enumerate(iv["disp"]):
        ev.append(_X("tile.dispatch", s, 3.0, 100, 100, cat="user_annotation",
                     args={"batch": i}))
        ev.append(_X("aten::sort", s + 1.0, 1.0, 100, 100, cat="cpu_op"))
    for name, s, d in iv["stages"] + iv["spans"]:
        ev.append(_X(name, s, d, 100, 100, cat="user_annotation"))
        if annotations:
            ev.append(_X(name, s, d, 0, 7, cat="gpu_user_annotation"))
    for s, d in iv["builds"]:
        ev.append(_X("kernel.build", s, d, 100, 100, cat="user_annotation"))
    return {"traceEvents": ev, "deviceProperties": [{"id": 0, "name": "H100"}]}


def _close(a, b, path="report"):
    """Equal structure, equal non-floats, floats to 1e-6 relative."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-6, abs=1e-9), path
    else:
        assert a == b, path


def _comparable(rep: dict) -> dict:
    rep = dict(rep)
    dev = dict(rep["device"])
    dev.pop("kind", None)
    dev.pop("ranges", None)
    rep["device"] = dev
    rep["span_instances"] = [{k: v for k, v in s.items() if k != "args"}
                             for s in rep["span_instances"]]
    disp = dict(rep["dispatches"])
    disp["windows"] = [{k: v for k, v in w.items() if k != "args"}
                       for w in disp["windows"]]
    rep["dispatches"] = disp
    return rep


@pytest.mark.parametrize("seed", range(6))
def test_both_layouts_give_the_same_report(seed):
    iv = _intervals(seed)
    want = jtl.parse_timeline(_reference_layout(iv))
    got = ttl.parse_timeline(_kineto_layout(iv))
    assert got["device"]["kind"] == "cuda"
    assert set(got) == set(want)
    assert set(got["device"]) == set(want["device"]) | {"kind", "ranges"}
    _close(_comparable(got), _comparable(want))
    assert got["dispatches"]["count"] == len(iv["disp"])
    assert got["compile"]["count"] == len(iv["builds"])
    assert got["device"]["n_slices"] == len(iv["exec"])
    launches = {m["module"]: m["n_slices"] for m in got["device"]["modules"]}
    assert sum(launches.values()) == len(iv["exec"])


@pytest.mark.parametrize("seed", range(3))
def test_gpu_user_annotation_adds_nothing(seed):
    """The device-side shadow of a host range spans the kernels launched
    inside it; counting it would count them twice (and fill the gaps
    between them). Busy time is the same with and without the shadows,
    and each range's device time is the exec slices inside it."""
    iv = _intervals(seed)
    with_ann = ttl.parse_timeline(_kineto_layout(iv, annotations=True))
    without = ttl.parse_timeline(_kineto_layout(iv, annotations=False))
    assert with_ann["device"]["busy_us"] == without["device"]["busy_us"]
    assert with_ann["device"]["n_slices"] == without["device"]["n_slices"]
    whole = with_ann["device"]["ranges"]["profile.query"]
    assert whole["busy_us"] == pytest.approx(with_ann["device"]["busy_us"], rel=1e-9)
    assert without["device"]["ranges"] == {}


def test_busy_union_counts_overlapping_streams_once():
    tr = {"traceEvents": [
        _X("a", 0.0, 10.0, 0, 7, cat="kernel"),
        _X("b", 5.0, 10.0, 0, 9, cat="kernel"),
        _X("profile.query", 0.0, 30.0, 100, 100, cat="user_annotation"),
        _X("profile.query", 0.0, 15.0, 0, 7, cat="gpu_user_annotation"),
        _X("aten::mm", 1.0, 20.0, 100, 100, cat="cpu_op"),
    ]}
    rep = ttl.parse_timeline(tr)
    assert rep["device"]["kind"] == "cuda"
    assert rep["device"]["busy_us"] == 15.0 and rep["capture"]["wall_us"] == 30.0
    assert rep["spans"]["profile.query"]["n_slices"] == 2


def test_cpu_trace_uses_top_level_cpu_ops():
    """Without a card the top-level CPU ops are the executed work: nested
    ops count once, and ops of two threads are both work."""
    tr = {"traceEvents": [
        _X("aten::matmul", 0.0, 10.0, 1, 1, cat="cpu_op"),
        _X("aten::mm", 1.0, 8.0, 1, 1, cat="cpu_op"),
        _X("aten::sort", 20.0, 5.0, 1, 2, cat="cpu_op"),
        _X("tile.dispatch", 0.0, 30.0, 1, 1, cat="user_annotation"),
    ]}
    rep = ttl.parse_timeline(tr)
    assert rep["device"]["kind"] == "cpu" and ttl.trace_kind(tr) == "cpu"
    assert rep["device"]["n_slices"] == 2 and rep["device"]["busy_us"] == 15.0
    assert rep["dispatches"]["count"] == 1
    assert rep["dispatches"]["lag_us"]["median"] == 0.0


@pytest.fixture
def small_tree():
    pts = generate_points_rowwise(3, 3, 1 << 12, device="cpu")
    return build_morton(pts, device="cpu"), generate_queries(4, 3, 1 << 11, device="cpu")


def test_cpu_capture_of_the_tiled_engine(small_tree, tmp_path, monkeypatch):
    """A real torch.profiler capture on the CPU: one tile.dispatch per
    batch and per overflow retry, the retire and drain stages present,
    the report published as the two gauges, and the answers the same
    bits as without the window."""
    tree, q = small_tree
    monkeypatch.setattr(tqm, "_BATCH_Q", 128)  # 16 batches: the lookahead retires
    kw = dict(k=4, tile=32, cmax=2)  # a tiny cap overflows: retries
    want = tqm.morton_knn_tiled(tree, q, **kw)
    stats = tqm.TileStats()
    reg = treg.get_registry()
    before = reg.counter("kdtree_profile_captures_total").value
    with tprof.capture(str(tmp_path), device="cpu") as cap:
        got = tqm.morton_knn_tiled(tree, q, stats=stats, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rep = ttl.analyze_trace_file(cap.trace_file)
    assert stats.batches == 16 and stats.retries > 0
    assert rep["dispatches"]["count"] == stats.batches + stats.retries
    assert rep["device"]["kind"] == "cpu" and 0.0 < rep["device"]["busy_frac"] <= 1.0
    assert {"tile.retire", "tile.drain"} <= set(rep["spans"])
    assert rep["dispatches"]["stages"]["retire_us"] > 0
    assert reg.gauge("kdtree_device_busy_frac").value == rep["device"]["busy_frac"]
    assert reg.gauge("kdtree_dispatch_lag_us").value == \
        rep["dispatches"]["lag_us"]["median"]
    assert reg.counter("kdtree_profile_captures_total").value == before + 1
    assert "== batch dispatches ==" in ttl.render_timeline(rep)


def test_capture_on_one_thread_sees_another_threads_dispatches(small_tree, tmp_path):
    tree, q = small_tree
    stop, ran = threading.Event(), threading.Event()

    def worker():
        while not stop.is_set():
            tqm.morton_knn_tiled(tree, q[:256], k=4)
            ran.set()

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert ran.wait(60)
        res = tprof.capture_for(0.5, str(tmp_path), device="cpu")
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive()
    rep = ttl.parse_timeline(ttl.load_trace(res.trace_file))
    assert rep["dispatches"]["count"] > 0 and rep["device"]["n_slices"] > 0


def test_one_capture_at_a_time(tmp_path):
    with tprof.capture(str(tmp_path / "a"), device="cpu"):
        assert tprof.capture_active()
        with pytest.raises(tprof.CaptureBusyError):
            with tprof.capture(str(tmp_path / "b"), device="cpu"):
                pass
    assert not tprof.capture_active()
    assert tprof.latest_trace_file(str(tmp_path / "a")) is not None


def test_window_stops_on_one_thread_and_exports_on_another(tmp_path):
    """A window's halves: the lock is held from its open to the end of its
    export, which may run on another thread; an abort releases it."""
    w = tprof.Window(str(tmp_path / "w"), device="cpu")
    (torch.rand(32, 32) @ torch.rand(32, 32)).sum()
    w.stop()
    assert tprof.capture_active()
    with pytest.raises(tprof.CaptureBusyError):
        tprof.Window(str(tmp_path / "x"), device="cpu")
    out = {}
    t = threading.Thread(target=lambda: out.update(r=w.export()))
    t.start()
    t.join(60)
    res = out["r"]
    assert not tprof.capture_active()
    assert res.trace_file == tprof.latest_trace_file(str(tmp_path / "w"))
    assert min(res.start_seconds, res.stop_seconds, res.export_seconds) >= 0.0
    assert res.end_unix is not None and res.wall_seconds >= 0.0
    a = tprof.Window(str(tmp_path / "a"), device="cpu")
    a.stop()
    a.abort()
    assert not tprof.capture_active()
    assert tprof.latest_trace_file(str(tmp_path / "a")) is None


def test_every_kernel_is_named():
    """The kernel table lists every kernel of the window, the least busy
    too (the reference's keeps its 32 busiest modules)."""
    ev = [_X(f"kernel_{i}", 10.0 * i, 1.0 + i, 0, 7, cat="kernel") for i in range(40)]
    ev.append(_X("kernel_0", 500.0, 0.5, 0, 7, cat="kernel"))
    rep = ttl.parse_timeline({"traceEvents": ev})
    mods = {m["module"]: m["n_slices"] for m in rep["device"]["modules"]}
    assert len(mods) == 40 and mods["kernel_0"] == 2
    assert rep["device"]["modules"][-1]["module"] == "kernel_0"
    assert sum(mods.values()) == rep["device"]["n_slices"] == 41
