"""The port's distributed tracing (``kdtree_tpu_torch/obs/trace.py``)
against the reference's: the wire form parses, formats and adopts alike;
``assemble`` + ``render_waterfall`` give byte-equal text for the same span
lists (clock offsets, orphans, unaccounted gaps, an unreachable source);
the buffers promote, pin and index alike; the slow tracker and head
sampling reach the same verdicts; and a span opened under an active
context lands in the trace buffer with its parent link."""

from __future__ import annotations

import json

import numpy as np
import pytest

from kdtree_tpu.obs import trace as jtr
from kdtree_tpu_torch import obs
from kdtree_tpu_torch.obs import flight as tflight
from kdtree_tpu_torch.obs import registry as treg
from kdtree_tpu_torch.obs import trace as ttr


@pytest.mark.parametrize("value", [
    "00-req-1-abcdef0123456789-01",
    "00-plain-0123456789abcdef-00",
    "00-a-b-c-d-e-0123456789abcdef-01",
    "01-req-0123456789abcdef-01",
    "00-req-XYZ-01",
    "00-req-0123456789abcdef-02",
    "00--0123456789abcdef-01",
    "garbage",
    "",
    None,
    "00-" + "x" * 300 + "-0123456789abcdef-01",
])
def test_parse_fmt_adopt_match(value):
    jc, tc = jtr.parse(value), ttr.parse(value)
    assert (jc is None) == (tc is None)
    if tc is not None:
        assert (tc.trace_id, tc.span_id, tc.sampled) == (jc.trace_id, jc.span_id, jc.sampled)
        assert ttr.fmt(tc) == jtr.fmt(jc) == value
        assert ttr.parse(ttr.fmt(tc)).trace_id == tc.trace_id
    headers = {} if value is None else {ttr.TRACE_HEADER: value}
    ta, ja = ttr.adopt(headers, "minted"), jtr.adopt(headers, "minted")
    assert ta.trace_id == ja.trace_id and ta.sampled == ja.sampled
    assert ttr.TRACE_HEADER == jtr.TRACE_HEADER
    assert ttr.outbound_header(None) == jtr.outbound_header(None) == ""


def _sources(seed: int):
    """Span lists of a root process and two others, with clock offsets,
    an orphan and an unreachable source."""
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    root = {"trace_id": "t", "span_id": "r0", "parent_id": "", "name": "serve/request",
            "start_unix": t0, "end_unix": t0 + float(rng.uniform(0.05, 0.2))}
    spans = [root]
    for i in range(int(rng.integers(2, 8))):
        a = t0 + float(rng.uniform(0, 0.1))
        spans.append({"trace_id": "t", "span_id": f"c{i}",
                      "parent_id": "r0" if rng.random() < 0.7 else f"c{max(i - 1, 0)}",
                      "name": ["serve/queue", "serve/dispatch", "query.tiled"][i % 3],
                      "start_unix": a, "end_unix": a + float(rng.uniform(0.001, 0.05)),
                      "rows": int(rng.integers(1, 100)), "shard": i % 2 or None,
                      "outcome": "ok" if i % 4 else "degraded", "wave": i % 2})
    off = float(rng.uniform(-0.01, 0.01))
    other = [{"trace_id": "t", "span_id": f"o{i}", "parent_id": "c0" if i else "zz",
              "name": "serve/dispatch", "start_unix": t0 + off + 0.01 * i,
              "end_unix": t0 + off + 0.01 * i + 0.004, "hedge": "loser" if i else None}
             for i in range(3)]
    return [
        {"source": "router", "clock_offset_s": 0.0, "spans": spans, "error": None},
        {"source": "shard-1", "clock_offset_s": off, "spans": other, "error": None},
        {"source": "shard-2", "clock_offset_s": 0.0, "spans": [],
         "error": "connection refused"},
    ]


@pytest.mark.parametrize("seed", range(5))
def test_assemble_and_waterfall_byte_equal(seed):
    src = _sources(seed)
    ja, ta = jtr.assemble("t", src), ttr.assemble("t", src)
    assert json.dumps(ta, sort_keys=True) == json.dumps(ja, sort_keys=True)
    assert ta["orphans"] and ta["coverage"] is not None
    for width in (20, 40):
        assert ttr.render_waterfall(ta, width) == jtr.render_waterfall(ja, width)
    empty = {"trace_id": "none", "spans": []}
    assert ttr.render_waterfall(empty) == jtr.render_waterfall(empty)
    assert ttr.estimate_clock_offset(1.0, 3.0, 2.5) == jtr.estimate_clock_offset(1.0, 3.0, 2.5)


def test_buffers_promote_and_index_alike():
    jb, tb = jtr.TraceBuffer(capacity=3, pinned_capacity=2), \
        ttr.TraceBuffer(capacity=3, pinned_capacity=2)
    for b in (jb, tb):
        for i in range(5):
            b.record_span(f"t{i}", f"s{i}", "", "serve/request", 1.0 + i, 2.0 + i, rows=i)
        b.promote("t4", "slow")
        b.promote("t4", "error")
        b.promote("t3", "bogus-reason")  # folds to "manual"
        b.promote("early", "error")  # before any span: pinned empty, spans attach
        b.record_span("early", "s9", "", "late", 9.0, 9.5)
        for i in range(4):
            b.record_span("big", f"b{i}", "", "x", 0.0, 1.0)
    ji, ti = jb.index(), tb.index()
    for idx in (ji, ti):
        for p in idx["pinned"]:
            p.pop("promoted_unix")
        idx.pop("pid")
    assert ti == ji
    for tid in ("t4", "early", "t0", "t1", "big"):
        assert tb.get(tid) == jb.get(tid)
    assert tb.last_promoted("slow") == jb.last_promoted("slow") == "t4"
    assert tb.last_promoted() == jb.last_promoted()


def test_slow_tracker_and_head_sampling_agree():
    js, ts = jtr.SlowTracker(window=64, min_samples=10), ttr.SlowTracker(window=64, min_samples=10)
    lat = np.random.default_rng(3).exponential(0.01, 400)
    lat[::37] *= 40
    assert [ts.note(x) for x in lat] == [js.note(x) for x in lat]
    for tid in ("a", "req-17", "x" * 40):
        for frac in (0.0, 0.1, 0.5, 1.0):
            assert ttr.head_sampled(tid, frac) == jtr.head_sampled(tid, frac)


def test_span_under_active_context_lands_in_the_buffer():
    ttr.reset()
    ctx = ttr.mint("req-span", sampled=False)
    reg = treg.MetricsRegistry()
    with ttr.active(ctx):
        with obs.span("outer", registry=reg, sync=False) as outer:
            with obs.span("inner", registry=reg, sync=False, rows=3) as inner:
                pass
    assert ttr.current() is None
    spans = {s["name"]: s for s in ttr.get_trace("req-span")["spans"]}
    assert spans["outer"]["parent_id"] == ctx.span_id
    assert spans["outer/inner"]["parent_id"] == outer.span_id
    assert spans["outer/inner"]["span_id"] == inner.span_id and spans["outer/inner"]["rows"] == 3
    ev = [e for e in tflight.recorder().snapshot()
          if e["type"] == "span" and e.get("trace_id") == "req-span"]
    assert len(ev) == 2
    # without a context a span carries no ids
    with obs.span("lonely", registry=reg, sync=False) as sp:
        pass
    assert sp.span_id is None


def test_auto_dump_writes_the_pinned_traces(tmp_path, monkeypatch):
    monkeypatch.setenv("KDTREE_TPU_FLIGHT_DIR", str(tmp_path))
    ttr.reset()
    ttr.record_span("dumped", "s1", "", "serve/request", 1.0, 2.0)
    ttr.promote("dumped", "error")
    path = ttr.auto_dump("serve error!")
    assert path is not None and path.endswith("trace-serve-error-.json")
    rep = json.loads(open(path).read())
    assert rep["traces"][0]["trace_id"] == "dumped" and rep["reason"] == "serve error!"
    ttr.reset()
    assert ttr.auto_dump("empty") is None
