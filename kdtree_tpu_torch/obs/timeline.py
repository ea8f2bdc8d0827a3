"""Device-timeline analysis: join a torch.profiler Chrome trace back to the
obs spans.

The port of ``kdtree_tpu/obs/timeline.py``: the same report
(:data:`TIMELINE_VERSION`, its keys, :func:`render_timeline`), parsed from
the Kineto Chrome trace a :mod:`kdtree_tpu_torch.obs.profile` window
writes. It answers the question host spans cannot — *where did the card
actually wait?*

Event taxonomy (Kineto's ``cat`` field):

- **Exec slices** — on a CUDA capture, the events the card executed:
  ``kernel``, ``gpu_memcpy`` and ``gpu_memset``, and only those. A
  ``gpu_user_annotation`` is the device-side shadow of a
  ``record_function`` range: it spans the kernels launched inside the
  range, so counting it would count those kernels twice. ``cuda_runtime``
  (the host's launch calls) and ``cpu_op`` are host work. On a CPU
  capture (no card: the tests), the top-level ``cpu_op`` slices of each
  thread play the executor's role — a CPU op runs where it is called —
  and the report names which in ``device.kind``.
- **Host spans** — ``user_annotation`` ranges (``record_function``: the
  obs spans and the driver's annotations) following the project's
  dotted-lowercase naming (``profile.query``, ``serve.batch``); an
  explicit ``span_names`` set overrides the convention.
- **Dispatches** — ``tile.dispatch`` marks the tiled driver handing one
  batch to the card (:func:`kdtree_tpu_torch.ops.tile_query.
  drive_batches`): the gap to the first exec slice after it is the
  dispatch-to-execution lag, and each dispatch-to-next-dispatch window
  gets a busy/idle breakdown; ``tile.retire`` / ``tile.drain`` split a
  window's host time into its blocking flag fetches and the rest.
- **Compile slices** — ``kernel.build``, the nvcc build of a CUDA kernel
  at first use (``kernels/_build.py``): a window that contains one was
  not measuring steady state.

Per-kernel time (``device.modules``): each kernel name's union of slices
and its launch count, for every kernel of the window (the reference keeps
its 32 busiest modules; a CUDA window holds a few dozen torch kernels
besides the port's own, and a short one such as the merge must still be
named). ``device.ranges``: each ``gpu_user_annotation``
name's device time, the union of the exec slices inside its windows.

Correlation is by TIME OVERLAP within the capture, as in the reference.
"""

from __future__ import annotations

import bisect
import gzip
import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

TIMELINE_VERSION = 1

DISPATCH_ANNOTATION = "tile.dispatch"

# project span naming convention: dotted lowercase tokens
_SPAN_NAME_RE = re.compile(r"^[a-z][a-z0-9_+-]*(\.[a-z0-9_+-]+)+$")

# what the card executed, by Kineto category
EXEC_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
_COMPILE_NAMES = frozenset({"kernel.build"})
# driver-stage annotations inside dispatch windows (drive_batches): the
# blocking overflow-flag fetches whose per-window overlap decomposes host
# time into prep / retire-wait / drain-wait
_STAGE_SPANS = frozenset({"tile.retire", "tile.drain"})
_MAX_LISTED = 200  # cap per-instance listings so the artifact stays small


def load_trace(path: str) -> dict:
    """Load a Chrome trace (.json or .json.gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of [start, end) intervals — overlapping slices (kernels of
    two streams, nested CPU ops) count once."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(
    merged: Sequence[Tuple[float, float]],
    merged_ends: Sequence[float],
    s: float, e: float,
) -> float:
    """Total length of ``merged`` intersected with [s, e] — O(log n + k)
    per call (bisect to the first interval ending after ``s``)."""
    total = 0.0
    i = bisect.bisect_right(merged_ends, s)
    while i < len(merged):
        ms, me = merged[i]
        if ms >= e:
            break
        total += min(me, e) - max(ms, s)
        i += 1
    return total


def _pctl(values: List[float], frac: float) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    idx = min(int(frac * (len(vs) - 1) + 0.5), len(vs) - 1)
    return vs[idx]


def _iv(e: dict) -> Tuple[float, float]:
    return (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))


def trace_kind(trace: dict) -> str:
    """``"cuda"`` for a capture that traced a card (Kineto records its
    ``deviceProperties``, and the card's slices carry the exec
    categories), ``"cpu"`` otherwise."""
    if trace.get("deviceProperties"):
        return "cuda"
    for e in trace.get("traceEvents", []):
        if e.get("cat") in EXEC_CATEGORIES:
            return "cuda"
    return "cpu"


def _top_level(ops: List[dict]) -> List[dict]:
    """The ``cpu_op`` slices no other op of the same thread encloses."""
    out: List[dict] = []
    by_thread: Dict[object, List[dict]] = {}
    for e in ops:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        end = float("-inf")
        for e in evs:
            s, t = _iv(e)
            if s >= end:
                out.append(e)
                end = t
            else:
                end = max(end, t)
    return out


class _Classified:
    """One pass over the trace events, sorted into the taxonomy."""

    def __init__(self, trace: dict, span_names: Optional[Iterable[str]],
                 dispatch_name: str, kind: str) -> None:
        names = set(span_names) if span_names is not None else None
        self.exec_slices: List[dict] = []
        self.spans: List[dict] = []
        self.dispatches: List[dict] = []
        self.compiles: List[dict] = []
        self.annotations: List[dict] = []
        cpu_ops: List[dict] = []
        for e in trace.get("traceEvents", []):
            if e.get("ph") != "X" or "ts" not in e:
                continue
            cat = e.get("cat")
            if cat in EXEC_CATEGORIES:
                if kind == "cuda":
                    self.exec_slices.append(e)
                continue
            if cat == "gpu_user_annotation":
                self.annotations.append(e)
                continue
            if cat == "cpu_op":
                cpu_ops.append(e)
                continue
            if cat != "user_annotation":
                continue
            name = e.get("name", "")
            if name in _COMPILE_NAMES:
                self.compiles.append(e)
                continue
            if name == dispatch_name:
                self.dispatches.append(e)
                continue
            if (name in names) if names is not None \
                    else _SPAN_NAME_RE.match(name):
                self.spans.append(e)
        if kind == "cpu":
            self.exec_slices = _top_level(cpu_ops)
        self.dispatches.sort(key=lambda e: e["ts"])
        self.spans.sort(key=lambda e: e["ts"])


def parse_timeline(
    trace: dict,
    span_names: Optional[Iterable[str]] = None,
    dispatch_name: str = DISPATCH_ANNOTATION,
) -> dict:
    """Analyze one Chrome trace into the timeline report dict.

    ``span_names`` restricts host-span recognition to an explicit set
    (default: the project's dotted-name convention); :func:`trace_kind`
    says whether the card's slices or the CPU's ops are the work. The
    report is self-contained JSON — every duration in microseconds,
    fractions in [0, 1] — rendered for humans by :func:`render_timeline`."""
    kind = trace_kind(trace)
    cls = _Classified(trace, span_names, dispatch_name, kind)

    interesting = cls.exec_slices + cls.spans + cls.dispatches + cls.compiles
    if interesting:
        begin = min(e["ts"] for e in interesting)
        end = max(e["ts"] + float(e.get("dur", 0.0)) for e in interesting)
    else:
        begin = end = 0.0
    wall = end - begin

    exec_iv = [_iv(e) for e in cls.exec_slices]
    merged = _merge(exec_iv)
    merged_ends = [e for _, e in merged]
    busy = sum(e - s for s, e in merged)
    # sorted starts/ends of the RAW slices: overlap counting by bisect
    slice_starts = sorted(a for a, _ in exec_iv)
    slice_ends = sorted(b for _, b in exec_iv)

    # per-kernel busy (union per name) and launches
    by_name: Dict[str, List[Tuple[float, float]]] = {}
    for e in cls.exec_slices:
        by_name.setdefault(e.get("name", "<device>"), []).append(_iv(e))
    modules = sorted(
        (
            (name, sum(e - s for s, e in _merge(iv)), len(iv))
            for name, iv in by_name.items()
        ),
        key=lambda kv: -kv[1],
    )

    # device time of each record_function range: the exec slices inside
    # its gpu_user_annotation windows (never the annotation itself)
    ann: Dict[str, List[Tuple[float, float]]] = {}
    for e in cls.annotations:
        ann.setdefault(e.get("name", ""), []).append(_iv(e))
    ranges = {
        name: {"busy_us": sum(_overlap(merged, merged_ends, s, t)
                              for s, t in _merge(ivs)),
               "count": len(ivs)}
        for name, ivs in sorted(ann.items())
    }

    # host spans: per-instance overlap, aggregated per name
    span_agg: Dict[str, dict] = {}
    instances: List[dict] = []
    correlated_pairs = 0
    for e in cls.spans:
        s, dur = e["ts"], float(e.get("dur", 0.0))
        end_e = s + dur
        dev = _overlap(merged, merged_ends, s, end_e)
        n_sl = max(
            0,
            bisect.bisect_left(slice_starts, end_e)
            - bisect.bisect_right(slice_ends, s),
        )
        correlated_pairs += n_sl
        agg = span_agg.setdefault(e["name"], {
            "count": 0, "wall_us": 0.0, "device_busy_us": 0.0,
            "device_idle_us": 0.0, "n_slices": 0,
        })
        agg["count"] += 1
        agg["wall_us"] += dur
        agg["device_busy_us"] += dev
        agg["device_idle_us"] += max(dur - dev, 0.0)
        agg["n_slices"] += n_sl
        if len(instances) < _MAX_LISTED:
            instances.append({
                "name": e["name"], "ts_us": s, "dur_us": dur,
                "device_busy_us": dev, "n_slices": n_sl,
                "args": {k: str(v) for k, v in (e.get("args") or {}).items()},
            })
    for agg in span_agg.values():
        agg["busy_frac"] = (
            agg["device_busy_us"] / agg["wall_us"] if agg["wall_us"] else 0.0
        )

    # dispatch windows: [dispatch_i, dispatch_{i+1}) busy/idle + lag, with
    # each window's host time split by driver stage (retire / drain wait,
    # prep = the rest: the next batch's host work)
    stage_iv: Dict[str, List[Tuple[float, float]]] = {}
    for e in cls.spans:
        if e["name"] in _STAGE_SPANS:
            stage_iv.setdefault(e["name"], []).append(_iv(e))
    stage_merged = {name: _merge(iv) for name, iv in stage_iv.items()}
    stage_ends = {
        name: [b for _, b in iv] for name, iv in stage_merged.items()
    }
    windows: List[dict] = []
    lags: List[float] = []
    fracs: List[float] = []
    disp_wall = 0.0
    disp_busy = 0.0
    stage_tot: Dict[str, float] = {name: 0.0 for name in stage_merged}
    for i, e in enumerate(cls.dispatches):
        s = e["ts"]
        w_end = cls.dispatches[i + 1]["ts"] if i + 1 < len(cls.dispatches) \
            else end
        w_busy = _overlap(merged, merged_ends, s, w_end)
        lag = None
        lo = bisect.bisect_left(slice_starts, s)
        if lo < len(slice_starts):
            lag = slice_starts[lo] - s
            lags.append(lag)
        disp_wall += max(w_end - s, 0.0)
        disp_busy += w_busy
        if w_end > s:
            fracs.append(w_busy / (w_end - s))
        stages = {}
        for name in sorted(_STAGE_SPANS):
            dur = 0.0
            if name in stage_merged:
                dur = _overlap(stage_merged[name], stage_ends[name], s,
                               w_end)
                stage_tot[name] += dur
            stages[name.split(".", 1)[-1] + "_us"] = dur
        if len(windows) < _MAX_LISTED:
            windows.append({
                "ts_us": s,
                "window_us": max(w_end - s, 0.0),
                "busy_us": w_busy,
                "idle_us": max(w_end - s - w_busy, 0.0),
                "lag_us": lag,
                **stages,
                "args": {k: str(v) for k, v in (e.get("args") or {}).items()},
            })
    stage_wait = sum(stage_tot.values())

    compiles = sorted(cls.compiles, key=lambda e: -float(e.get("dur", 0.0)))
    compile_total = sum(float(e.get("dur", 0.0)) for e in cls.compiles)

    # idle gaps between device work inside the capture
    gaps: List[dict] = []
    prev = begin
    for s, e in merged:
        if s > prev:
            gaps.append({"ts_us": prev, "gap_us": s - prev})
        prev = max(prev, e)
    if end > prev and merged:
        gaps.append({"ts_us": prev, "gap_us": end - prev})
    gaps.sort(key=lambda g: -g["gap_us"])

    return {
        "timeline_version": TIMELINE_VERSION,
        "capture": {"begin_us": begin, "end_us": end, "wall_us": wall},
        "device": {
            "kind": kind,
            "busy_us": busy,
            "idle_us": max(wall - busy, 0.0),
            "busy_frac": (busy / wall) if wall else 0.0,
            "n_slices": len(cls.exec_slices),
            "modules": [
                {"module": m, "busy_us": b, "n_slices": n}
                for m, b, n in modules
            ],
            "ranges": ranges,
            "largest_gaps": gaps[:10],
        },
        "spans": span_agg,
        "span_instances": instances,
        "dispatches": {
            "count": len(cls.dispatches),
            "busy_frac": (disp_busy / disp_wall) if disp_wall else None,
            "busy_frac_median": _pctl(fracs, 0.5),
            "lag_us": {
                "n": len(lags),
                "median": _pctl(lags, 0.5),
                "p90": _pctl(lags, 0.9),
                "max": max(lags) if lags else None,
            },
            "stages": {
                "retire_us": stage_tot.get("tile.retire", 0.0),
                "drain_us": stage_tot.get("tile.drain", 0.0),
                "prep_us": max(disp_wall - stage_wait, 0.0),
            },
            "windows": windows,
        },
        "compile": {
            "count": len(cls.compiles),
            "total_us": compile_total,
            "top": [
                {"ts_us": e["ts"], "dur_us": float(e.get("dur", 0.0))}
                for e in compiles[:10]
            ],
        },
        "correlated_spans": sum(
            1 for a in span_agg.values() if a["n_slices"] > 0
        ),
        "correlated_pairs": correlated_pairs,
    }


def analyze_trace_file(
    path: str,
    span_names: Optional[Iterable[str]] = None,
    dispatch_name: str = DISPATCH_ANNOTATION,
) -> dict:
    """Load + parse; records the source path in the report and publishes
    the capture's headline as two gauges: ``kdtree_device_busy_frac`` (the
    device-busy SLO keys on it) and ``kdtree_dispatch_lag_us`` (the median
    host->device dispatch lag). Last capture wins — manual and duty-cycle
    windows feed the same gauges."""
    from kdtree_tpu_torch.obs.registry import get_registry

    rep = parse_timeline(load_trace(path), span_names, dispatch_name)
    rep["trace_file"] = path
    reg = get_registry()
    busy = rep["device"]["busy_frac"]
    if busy is not None:
        reg.gauge("kdtree_device_busy_frac").set(float(busy))
    lag = rep["dispatches"]["lag_us"]["median"]
    if lag is not None:
        reg.gauge("kdtree_dispatch_lag_us").set(float(lag))
    return rep


def _us(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v >= 1e6:
        return f"{v / 1e6:.3f}s"
    if v >= 1e3:
        return f"{v / 1e3:.2f}ms"
    return f"{v:.0f}us"


_NAME_WIDTH = 60  # CUDA kernel names are long template instantiations


def render_timeline(rep: dict) -> str:
    """Human rendering of a timeline report (the ``profile`` subcommand's
    stdout, style-matched to ``stats``). Leads with the facts that decide
    whether the capture is worth reading (wall, device busy fraction,
    kernel builds in the window), then spans, dispatches, kernels, gaps."""
    out = []
    cap = rep["capture"]
    dev = rep["device"]
    what = "kernel/copy slices" if dev.get("kind") == "cuda" else \
        "CPU op slices"
    out.append("== capture ==")
    out.append(f"wall:                {_us(cap['wall_us'])}")
    out.append(
        f"device busy:         {_us(dev['busy_us'])} "
        f"({dev['busy_frac'] * 100.0:.1f}% of capture; "
        f"{dev['n_slices']} {what})"
    )
    out.append(f"device idle:         {_us(dev['idle_us'])}")
    comp = rep["compile"]
    if comp["count"]:
        out.append(
            f"builds IN WINDOW:    {comp['count']} "
            f"({_us(comp['total_us'])}) — not steady state"
        )
    else:
        out.append("builds in window:    0 (steady state)")

    spans = rep.get("spans", {})
    if spans:
        out.append("")
        out.append("== host spans vs device (by device busy) ==")
        width = max(len(s) for s in spans)
        for name, a in sorted(
            spans.items(), key=lambda kv: -kv[1]["device_busy_us"]
        ):
            out.append(
                f"{name:<{width}}  n={a['count']:<4d} "
                f"wall={_us(a['wall_us']):>9s} "
                f"busy={_us(a['device_busy_us']):>9s} "
                f"({a['busy_frac'] * 100.0:5.1f}%) "
                f"slices={a['n_slices']}"
            )

    disp = rep.get("dispatches", {})
    if disp.get("count"):
        lag = disp["lag_us"]
        out.append("")
        out.append("== batch dispatches ==")
        out.append(f"dispatches:          {disp['count']}")
        if disp.get("busy_frac") is not None:
            med = disp.get("busy_frac_median")
            med_s = f" (median {med * 100.0:.1f}%)" if med is not None \
                else ""
            out.append(
                f"device busy between: {disp['busy_frac'] * 100.0:.1f}%"
                f"{med_s} (idle gap = host/queue/transfer time)"
            )
        out.append(
            f"dispatch->exec lag:  median={_us(lag['median'])} "
            f"p90={_us(lag['p90'])} max={_us(lag['max'])}"
        )
        st = disp.get("stages")
        if st:
            out.append(
                f"host-stage split:    prep={_us(st['prep_us'])} "
                f"retire={_us(st['retire_us'])} "
                f"drain={_us(st['drain_us'])}"
            )

    mods = dev.get("modules", [])
    if mods:
        out.append("")
        out.append("== device kernels (by busy time) ==")
        names = [m["module"][:_NAME_WIDTH] for m in mods[:10]]
        width = max(len(n) for n in names)
        for name, m in zip(names, mods):
            out.append(
                f"{name:<{width}}  busy={_us(m['busy_us']):>9s} "
                f"launches={m['n_slices']}"
            )

    gaps = dev.get("largest_gaps", [])
    if gaps:
        out.append("")
        out.append("== largest device idle gaps ==")
        for g in gaps[:5]:
            out.append(
                f"at +{_us(g['ts_us'] - cap['begin_us']):>9s}: "
                f"{_us(g['gap_us'])}"
            )
    out.append("")
    out.append(
        f"correlated spans:    {rep.get('correlated_spans', 0)} "
        f"({rep.get('correlated_pairs', 0)} span/slice pairs)"
    )
    return "\n".join(out) + "\n"
