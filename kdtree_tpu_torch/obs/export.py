"""Exporters: JSONL event log, one-shot JSON report, Prometheus text.

The port of ``kdtree_tpu/obs/export.py``. Three consumers, three formats:

- **JSONL event log** (``configure_jsonl(path)`` + ``emit_event``): an
  append-only, size-capped stream of timestamped events (span
  completions, run markers). Disabled (a no-op) until configured.
- **JSON report** (``report()`` / ``write_report``): the one-shot summary
  a CLI run leaves behind (``--metrics-out``) — the full registry
  snapshot plus a ``spans`` rollup and any caller-supplied top-level
  facts. ``stats`` renders it (:func:`render_report`), ``stats --diff``
  compares two (:func:`render_report_diff`).
- **Prometheus text exposition** (``prometheus_text``, what ``GET
  /metrics`` serves; ``openmetrics_text`` for ``?openmetrics=1``).

Every rendering is byte-equal to the reference's for the same input,
except where the runtime differs: the run facts read the ``torch_*``
families and the kernel-build count (:mod:`~kdtree_tpu_torch.obs.
torchrt`) where the reference reads ``jax_*`` and its compile count.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from kdtree_tpu_torch.obs.registry import MetricsRegistry, get_registry
from kdtree_tpu_torch.utils import locks

REPORT_VERSION = 1

# event-log byte budget: a long-lived serving process must not grow its
# JSONL unboundedly. At the budget the log rotates ONCE (path -> path.1,
# previous .1 replaced), so disk usage is bounded by ~2x the budget while
# the newest events are always on disk.
DEFAULT_JSONL_MAX_BYTES = 64 << 20

_jsonl_lock = locks.make_lock("obs.jsonl")
_jsonl_path: Optional[str] = None
_jsonl_max_bytes: int = DEFAULT_JSONL_MAX_BYTES
_jsonl_written: int = 0


def _env_jsonl_budget() -> int:
    try:
        return int(os.environ.get("KDTREE_TPU_JSONL_MAX_BYTES",
                                  str(DEFAULT_JSONL_MAX_BYTES)))
    except ValueError:
        return DEFAULT_JSONL_MAX_BYTES


def configure_jsonl(
    path: Optional[str], max_bytes: Optional[int] = None,
) -> None:
    """Set (or clear, with None) the JSONL event-log destination.

    ``max_bytes`` caps the log size (default from
    ``KDTREE_TPU_JSONL_MAX_BYTES``, 64 MiB; <= 0 disables the cap): at
    the budget the current file rotates to ``path.1`` and the log starts
    fresh, so a long-lived serving process cannot fill the disk. An
    existing file's size counts against the budget from the start."""
    global _jsonl_path, _jsonl_max_bytes, _jsonl_written
    with _jsonl_lock:
        _jsonl_path = path
        _jsonl_max_bytes = _env_jsonl_budget() if max_bytes is None \
            else int(max_bytes)
        _jsonl_written = 0
        if path is not None:
            try:
                _jsonl_written = os.path.getsize(path)
            except OSError:
                pass


def jsonl_path() -> Optional[str]:
    return _jsonl_path


def emit_event(event: Dict) -> None:
    """Append one event line to the configured JSONL log; no-op when no
    log is configured, and never raises into the instrumented caller —
    telemetry failures must not fail the run they observe. Rotates at
    the configured byte budget (see :func:`configure_jsonl`)."""
    global _jsonl_written
    with _jsonl_lock:
        path = _jsonl_path
        if path is None:
            return
        try:
            line = json.dumps({"ts": time.time(), **event}) + "\n"
            if _jsonl_max_bytes > 0 and \
                    _jsonl_written + len(line) > _jsonl_max_bytes:
                try:
                    os.replace(path, path + ".1")
                except OSError:
                    # the log was rotated/removed under us (external
                    # logrotate, operator cleanup) or .1 is unwritable:
                    # re-sync the counter from the file's TRUE size so
                    # logging self-heals instead of retrying a failing
                    # rotation (and dropping every event) forever. If
                    # the file genuinely is still over budget, drop this
                    # event — the byte cap outranks completeness.
                    try:
                        _jsonl_written = os.path.getsize(path)
                    except OSError:
                        _jsonl_written = 0
                    if _jsonl_written + len(line) > _jsonl_max_bytes:
                        return
                else:
                    _jsonl_written = 0
                    with open(path, "a") as f:
                        rot = json.dumps({
                            "ts": time.time(), "type": "rotated",
                            "previous": path + ".1",
                            "max_bytes": _jsonl_max_bytes,
                        }) + "\n"
                        f.write(rot)
                        _jsonl_written += len(rot)
            with open(path, "a") as f:
                f.write(line)
            _jsonl_written += len(line)
        except (OSError, TypeError, ValueError):
            pass


def _span_rollup(hists: Dict[str, Dict]) -> Dict[str, Dict[str, float]]:
    """Convenience view of the kdtree_span_seconds histogram family:
    {span_path: {count, total_seconds, mean_seconds}}."""
    out: Dict[str, Dict[str, float]] = {}
    prefix = 'kdtree_span_seconds{span="'
    for key, snap in hists.items():
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):-2]  # strip the '"}' tail
        count = int(snap["count"])
        total = float(snap["sum"])
        out[path] = {
            "count": count,
            "total_seconds": total,
            "mean_seconds": (total / count) if count else 0.0,
        }
    return out


def report(
    registry: Optional[MetricsRegistry] = None,
    extra: Optional[Dict] = None,
) -> Dict:
    """One-shot JSON-ready report: registry snapshot + span rollup +
    caller facts. ``extra`` keys land at the top level (platform,
    device_init_seconds, degraded, ...)."""
    from kdtree_tpu_torch import obs

    obs.flush()  # run pending deferred fetches before snapshotting
    reg = registry or get_registry()
    snap = reg.snapshot()
    rep = {
        "report_version": REPORT_VERSION,
        "generated_unix": time.time(),
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": snap["histograms"],
        "spans": _span_rollup(snap["histograms"]),
    }
    if extra:
        rep.update(extra)
    return rep


def write_report(
    path: str,
    registry: Optional[MetricsRegistry] = None,
    extra: Optional[Dict] = None,
) -> Dict:
    """Write the report atomically (tmp + os.replace — a crashed writer
    must not leave a truncated half-report where a good one stood).
    Returns the report dict."""
    rep = report(registry, extra)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rep, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return rep


# Help strings for EVERY metric family the package registers — the
# catalog is test-enforced (tests/test_obs.py scans the package for
# instrument registrations and fails on any family missing here), so it


# Help strings for EVERY metric family the package registers — the
# catalog is test-enforced (tests/test_torch_obs.py scans the package for
# instrument registrations and fails on any family missing here). The
# texts are the reference's, so the two expositions agree line for line,
# except the torch runtime's own families.
METRIC_HELP = {
    # serving
    "kdtree_serve_requests_total": "k-NN serving requests by outcome",
    "kdtree_serve_request_seconds":
        "per-request latency by phase (queue/dispatch/total)",
    "kdtree_serve_batch_rows": "coalesced rows per dispatched micro-batch",
    "kdtree_serve_batch_requests": "requests coalesced per micro-batch",
    "kdtree_serve_batch_errors_total":
        "micro-batch or fallback dispatches that raised",
    "kdtree_serve_queue_depth": "query rows waiting in the admission queue",
    "kdtree_serve_shed_total": "requests shed (429) at the admission gate",
    "kdtree_serve_deadline_timeouts_total":
        "requests whose deadline expired while queued",
    "kdtree_serve_degraded_total":
        "requests answered by the brute-force degradation path, by reason",
    "kdtree_serve_batches_total":
        "dispatched micro-batches by plan-cache temperature",
    "kdtree_serve_ready": "1 once the index is loaded and warmup compiled",
    "kdtree_serve_warmup_buckets":
        "pow2 row buckets compiled by the warmup ladder",
    # query verbs (docs/SERVING.md "Query verbs")
    "kdtree_verb_requests_total":
        "verb requests dispatched, by verb (radius/range/count)",
    "kdtree_verb_batch_rows":
        "coalesced rows per dispatched verb micro-batch, by verb",
    "kdtree_verb_truncated_total":
        "verb answers flagged truncated (sound lower bound under a "
        "visit cap), by verb",
    "kdtree_verb_overflow_retries_total":
        "verb hit-buffer doubling re-runs (buffer settling)",
    # snapshots & replica fleets (docs/SERVING.md)
    "kdtree_snapshot_saves_total": "serving snapshots written",
    "kdtree_snapshot_loads_total": "serving snapshots loaded",
    "kdtree_snapshot_load_errors_total":
        "snapshot loads refused, by reason (missing/manifest/schema/"
        "checksum/segment) — never served half-read",
    "kdtree_snapshot_sink_errors_total":
        "epoch-swap snapshot emits that failed (the swap itself stood)",
    "kdtree_snapshot_version":
        "manifest version of the last snapshot saved or loaded",
    "kdtree_snapshot_epoch":
        "index epoch of the last snapshot saved or loaded",
    "kdtree_snapshot_bytes": "total segment bytes of the last save",
    "kdtree_snapshot_save_seconds": "duration of the last snapshot save",
    "kdtree_snapshot_load_seconds":
        "duration of the last snapshot load (verify + mmap + device "
        "transfer — the replica cold-start cost the build no longer "
        "pays)",
    "kdtree_snapshot_follow_version":
        "manifest version this follower replica currently serves",
    "kdtree_snapshot_adoptions_total":
        "blue/green snapshot swaps adopted by this follower",
    "kdtree_snapshot_gc_generations_total":
        "retained snapshot generations removed by --snapshot-keep GC",
    "kdtree_snapshot_plan_seeded_total":
        "plan profiles seeded into the local store from a snapshot "
        "manifest's pre-shipped plan_profiles payload",
    "kdtree_plan_cache_hits_total": "tiled-plan store lookups that hit",
    "kdtree_plan_cache_misses_total":
        "tiled-plan store lookups that missed",
    "kdtree_plan_cache_writes_total":
        "tiled-plan profiles written to the store",
    # the recall dial + degradation ladder
    "kdtree_approx_queries_total":
        "query rows answered by the bounded-visit approximate engine",
    "kdtree_approx_visit_cap":
        "visit cap (candidate buckets per tile) of the last "
        "approximate dispatch",
    "kdtree_recall_gear":
        "engaged degradation-ladder gear: 0 exact, 1 approx(0.99), "
        "2 approx(0.9), 3 brute-force-deadline",
    "kdtree_recall_estimate":
        "recall estimate of the engaged gear (measured calibration "
        "value when one exists; 1.0 exact) — the served-recall SLO's "
        "gauge",
    "kdtree_recall_requests_total":
        "requests answered, by gear class (exact / approx / "
        "brute-deadline)",
    "kdtree_recall_ladder_transitions_total":
        "degradation-ladder gear shifts, by destination gear",
    "kdtree_recall_sweeps_total":
        "recall-harness sweeps run (kdtree-tpu recall)",
    "kdtree_recall_sampled":
        "online-sampled MEASURED served recall (EWMA over shadow "
        "re-answered approx batches; serve --recall-sample) — the "
        "sampled-recall SLO's gauge",
    "kdtree_recall_samples_total":
        "approx batches shadow-answered exactly by the online recall "
        "sampler",
    # mutable index (docs/SERVING.md "Mutable index")
    "kdtree_epoch":
        "index epoch generation; increments on each delta compaction "
        "swap",
    "kdtree_mutable_delta_rows":
        "live upserted rows in the exact delta buffer",
    "kdtree_mutable_tombstones":
        "main-tree rows masked out (deleted or superseded by an upsert)",
    "kdtree_mutable_delta_headroom":
        "1 - write backlog / epoch-rebuild threshold (SLO delta-backlog)",
    "kdtree_mutable_writes_total": "mutable-index writes applied, by op",
    "kdtree_mutable_rebuilds_total":
        "epoch compactions completed and swapped in",
    "kdtree_mutable_corrections_total":
        "query rows re-answered over masked flat storage because a "
        "tombstoned id sat inside their main top-k",
    "kdtree_write_latency_ms":
        "mutable-index write apply latency by op (upsert/delete), "
        "engine-lock wait included — the load harness's write-path "
        "timing",
    "kdtree_mutable_rebuild_p99_delta_ms":
        "request-p99 delta (ms) of the last epoch-rebuild window vs "
        "the same-width window before it (history-ring join)",
    # SLOs + metric history (docs/OBSERVABILITY.md "SLOs & burn rates")
    "kdtree_slo_state":
        "SLO state by spec: 0 OK, 1 WARN, 2 PAGE (multi-window burn rate)",
    "kdtree_slo_burn_rate":
        "error-budget burn rate over the tier's long window, by SLO",
    "kdtree_slo_transitions_total":
        "SLO state transitions, by SLO and destination state",
    "kdtree_history_samples_total": "metric-history ring samples taken",
    "kdtree_device_busy_frac":
        "device busy fraction of the last analyzed profiler capture "
        "(fed continuously by the profiling duty cycle when armed)",
    "kdtree_dispatch_lag_us":
        "median host->device dispatch lag of the last analyzed capture",
    # cost accounting & capacity headroom; class labels are the bounded
    # {verb, gear, outcome} enum — unknown values fold to "other"
    "kdtree_cost_requests_total":
        "answered requests, by cost class {verb, gear, outcome}",
    "kdtree_cost_rows_total":
        "query rows answered, by cost class",
    "kdtree_cost_queue_ms_total":
        "admission-queue wait attributed to answered requests, by class",
    "kdtree_cost_device_ms_total":
        "dispatch-span device time amortized to requests by row share "
        "(shares sum exactly to each batch's measured span), by class",
    "kdtree_cost_visits_total":
        "planned candidate-bucket visits (rows x visit cap, or rows x "
        "num_buckets when exact), by class",
    "kdtree_cost_retries_total":
        "verb overflow retries amortized to batch members, by class",
    "kdtree_cost_bytes_in_total":
        "request body bytes attributed at answer time, by class",
    "kdtree_cost_bytes_out_total":
        "response body bytes attributed at answer time, by class",
    "kdtree_cost_correction_ms_total":
        "device time spent on shadow recall-sample re-answers "
        "(maintenance, not charged to any request class)",
    "kdtree_cost_correction_rows_total":
        "rows shadow re-answered by the online recall sampler",
    "kdtree_cost_writes_total":
        "write operations cost-accounted, by op (upsert / delete)",
    "kdtree_cost_write_ms_total":
        "write apply time cost-accounted, by op",
    "kdtree_cost_rebuilds_total":
        "epoch rebuilds cost-accounted as maintenance",
    "kdtree_cost_rebuild_ms_total":
        "epoch-rebuild wall time cost-accounted as maintenance",
    "kdtree_cost_per_query_ms":
        "windowed device cost per answered query over the history ring",
    "kdtree_capacity_predicted_rate":
        "predicted sustainable answer rate (req/s): measured device "
        "budget / current-mix cost-per-query",
    "kdtree_capacity_headroom_frac":
        "1 - observed_rate/predicted_rate, floored at 0 — the shard's "
        "capacity headroom under the current traffic mix",
    "kdtree_profile_duty_windows_total":
        "profiling duty-cycle capture windows completed",
    "kdtree_profile_duty_skipped_total":
        "duty-cycle windows skipped because a capture was already live",
    "kdtree_profile_captures_total": "profiler capture windows opened",
    "kdtree_trace_promoted_total":
        "traces tail-promoted to pinned retention, by reason",
    # engines
    "kdtree_builds_total": "index builds by engine",
    "kdtree_build_points_total": "rows indexed by engine",
    "kdtree_queries_total": "query calls by engine",
    "kdtree_query_rows_total": "query rows by engine",
    "kdtree_shard_queries_total":
        "per-shard query rows absorbed by the forest engines",
    "kdtree_tile_candidates_total":
        "collect-pass candidate buckets actually scanned",
    "kdtree_tile_scan_units_total":
        "(tile x local-tree) frontier descents",
    "kdtree_tile_prune_rate":
        "1 - candidates/(scan_units x buckets) of the last tiled run",
    "kdtree_forest_devices": "device count of the last forest build",
    "kdtree_exchange_slack":
        "sample-sort exchange capacity factor of the last scale build",
    "kdtree_slack_occupancy_sized_total":
        "scale builds whose exchange slack was sized from warm "
        "occupancy profiles",
    # spans
    "kdtree_span_seconds": "duration distribution per host span path",
    # PyTorch runtime (obs/torchrt.py), the counterpart of the
    # reference's jax_* families
    "kdtree_kernel_builds_total":
        "CUDA kernel sources built with nvcc at first use; growth after "
        "warmup means rebuilds",
    "kdtree_kernel_build_seconds_total":
        "wall time of the CUDA kernels' nvcc build rounds (sources built "
        "in parallel counted once), in seconds",
    "torch_platform_info":
        "1 for the platform (and device name) that actually ran",
    "torch_device_init_seconds": "measured device-init duration",
    "torch_device_count": "visible devices of the platform that ran",
    "torch_device_memory_bytes":
        "device memory snapshot: allocated/reserved/max_allocated by the "
        "caching allocator, free/total from the driver",
    # the fleet: the router, its connection pool and the load harness's
    # offered-rate gauge (the reference's help strings)
    "kdtree_router_requests_total":
        "routed k-NN requests by outcome (ok/partial/unavailable/...)",
    "kdtree_router_request_seconds":
        "routed request latency (scatter to merged answer)",
    "kdtree_router_partial_total":
        "requests answered from a shard quorum with the partial flag",
    "kdtree_router_shard_attempts_total":
        "per-shard attempt outcomes (ok/http_error/shed/network/...)",
    "kdtree_router_shard_seconds":
        "per-shard successful-attempt latency (the hedge-delay source)",
    "kdtree_router_retries_total":
        "per-shard backed-off retries",
    "kdtree_router_hedges_total":
        "hedge attempts fired, by shard",
    "kdtree_router_hedge_wins_total":
        "hedge attempts that beat their primary, by shard",
    "kdtree_router_breaker_state":
        "per-shard circuit breaker: 0 closed, 1 open, 2 half-open",
    "kdtree_router_breaker_transitions_total":
        "circuit-breaker transitions, by shard and destination state",
    "kdtree_router_shard_healthy":
        "1 while the shard's /healthz answers 200 without SLO PAGE",
    "kdtree_router_shards":
        "shards this router scatters to",
    "kdtree_router_write_requests_total":
        "routed mutable-index writes by op and outcome",
    "kdtree_router_federate_errors_total":
        "per-shard /metrics federation scrape failures",
    "kdtree_router_federated_up":
        "1 when the shard's /metrics scrape succeeded in the last federated"
        " exposition",
    "kdtree_router_replicas":
        "replicas per shard set",
    "kdtree_router_clock_skew_ms":
        "estimated shard wall-clock offset vs this router (RTT-midpoint "
        "from the health probe; +ve = shard clock ahead)",
    "kdtree_router_replica_requests_total":
        "attempts dispatched per replica (shard x replica) \u2014 the read-"
        "spread evidence for replica sets",
    "kdtree_router_shards_contacted":
        "shard sets contacted per routed knn request (mean = selective fan-"
        "out; equals the shard count under full scatter)",
    "kdtree_router_shards_pruned_total":
        "shard sets skipped because their bounding-box lower bound provably"
        " cleared the running k-th best distance",
    "kdtree_router_pool_hits_total":
        "shard attempts served off a pooled keep-alive connection (the "
        "loadgen reuse-fraction numerator)",
    "kdtree_router_pool_misses_total":
        "shard attempts that opened a fresh connection (empty or stale "
        "pool)",
    "kdtree_router_pool_discards_total":
        "pooled connections closed instead of reused, by reason "
        "(stale/abort/error/full/undrained/shutdown)",
    "kdtree_router_spec_wave_total":
        "speculative wave-2 launches by outcome (needed = the exact widen "
        "decision wanted that shard anyway; wasted = it did not)",
    "kdtree_loadgen_offered_rate":
        "open-loop offered rate (req/s) the load generator most recently "
        "declared via X-Loadgen-Rate",
    "kdtree_router_headroom_frac":
        "fleet capacity headroom aggregated over the routable shards' "
        "reported headroom blocks",
}


def _escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash first, then
    quote and newline (exposition format spec, version 0.0.4)."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _prom_key(name: str, label_items) -> str:
    """``name{k="v",...}`` with label values escaped for the exposition
    format — span paths and reasons are data, and a stray quote or newline
    in one would corrupt every series that follows it in the scrape."""
    if not label_items:
        return name
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in label_items
    )
    return f"{name}{{{inner}}}"


def _family_header(lines: list, name: str, kind: str) -> None:
    help_text = METRIC_HELP.get(name)
    if help_text:
        escaped = help_text.replace("\\", "\\\\").replace("\n", "\\n")
        lines.append(f"# HELP {name} {escaped}")
    lines.append(f"# TYPE {name} {kind}")


def _render(registry: Optional[MetricsRegistry], exemplars: bool) -> list:
    reg = registry or get_registry()
    lines = []
    seen_family = set()
    for name, kind, items, inst in reg.collect():
        if name not in seen_family:
            _family_header(lines, name, kind)
            seen_family.add(name)
        if kind in ("counter", "gauge"):
            lines.append(f"{_prom_key(name, items)} {inst.value:g}")
            continue
        snap = inst.snapshot()
        ex = inst.exemplars() if exemplars else {}
        base = dict(items)
        for upper, cum in snap["buckets"].items():
            le_items = tuple(sorted({**base, "le": upper}.items()))
            line = f"{_prom_key(name + '_bucket', le_items)} {cum}"
            if upper in ex:
                label, value, ts = ex[upper]
                line += (f' # {{trace_id="{_escape_label_value(label)}"}} '
                         f"{value:g} {ts:.3f}")
            lines.append(line)
        lines.append(f"{_prom_key(name + '_sum', items)} {snap['sum']:g}")
        lines.append(f"{_prom_key(name + '_count', items)} {snap['count']}")
    return lines


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus text exposition format (version 0.0.4) of the whole
    registry: histograms emit cumulative ``_bucket{le=...}`` series plus
    ``_sum`` / ``_count``; ``# HELP`` (when the family is in
    :data:`METRIC_HELP`) and ``# TYPE`` appear once per family, before its
    first series; label values are escaped."""
    return "\n".join(_render(registry, exemplars=False)) + "\n"


def openmetrics_text(registry: Optional[MetricsRegistry] = None) -> str:
    """The OpenMetrics-flavoured exposition (``GET /metrics?openmetrics=1``):
    the same families as :func:`prometheus_text` plus the last trace id a
    serving histogram observed into each bucket
    (``# {trace_id="..."} value timestamp``) and the ``# EOF``
    terminator. The default exposition stays exemplar-free."""
    return "\n".join(_render(registry, exemplars=True) + ["# EOF"]) + "\n"


def _capacity_lines(cap: Dict) -> list:
    """Human rendering of a loadgen ``capacity`` block (shared by
    ``stats`` and ``stats --diff`` so the two views cannot drift)."""
    out = ["== capacity (open-loop load harness) =="]
    knee = cap.get("knee_rate")
    knee_s = "?" if knee is None else f"{knee:g}"
    out.append(
        f"knee rate:           {knee_s} req/s  "
        f"(p{int(cap.get('slo_quantile', 0.99) * 100)} <= "
        f"{cap.get('slo_ms', 0):g} ms, bad <= "
        f"{cap.get('max_bad_frac', 0):.0%})"
    )
    pred = cap.get("predicted")
    if isinstance(pred, dict):
        wb = pred.get("within_band")
        verdict = ("within band" if wb
                   else "OUTSIDE band" if wb is not None
                   else "no knee to judge against")
        out.append(
            f"predicted rate:      {pred.get('predicted_rate', 0):g} "
            f"req/s from measured cost/query "
            f"{pred.get('cost_per_query_ms', 0):g} ms — {verdict} "
            f"(band {pred.get('band', 0):.0%} of the knee)"
        )
    steps = cap.get("steps") or []
    if steps:
        out.append(f"{'rate':>8s}  {'sent':>6s}  {'goodput':>8s}  "
                   f"{'p50':>8s}  {'p95':>8s}  {'p99':>8s}  "
                   f"{'shed':>6s}  {'bad':>6s}")
        for s in steps:
            def ms(key, s=s):
                v = s.get(key)
                return f"{v:.1f}ms" if v is not None else "-"

            out.append(
                f"{s.get('rate', 0):>8g}  {s.get('sent', 0):>6d}  "
                f"{s.get('goodput_rps', 0):>8g}  {ms('p50_ms'):>8s}  "
                f"{ms('p95_ms'):>8s}  {ms('p99_ms'):>8s}  "
                f"{(s.get('shed_frac') or 0):>6.1%}  "
                f"{(s.get('bad_frac') or 0):>6.1%}"
            )
    fanout = cap.get("fanout_frac")
    if fanout is not None:
        out.append(f"fan-out fraction:    {fanout:.1%} of shards "
                   "contacted per routed query (selective fan-out)")
    verbs = cap.get("verbs")
    if isinstance(verbs, dict) and verbs:
        knees = "  ".join(
            f"{verb}={info.get('knee_rate', 0):g}"
            for verb, info in sorted(verbs.items())
            if isinstance(info, dict))
        out.append(f"per-verb knees:      {knees} req/s (offered "
                   "ladder rate each verb's own samples cleared)")
    # the run's worst exchange, by trace id: the id a waterfall pull
    # (trace --id <it> --target <server>) starts from
    worst = None
    for s in steps:
        if s.get("slowest_trace_id") and s.get("slowest_ms") is not None:
            if worst is None or s["slowest_ms"] > worst[0]:
                worst = (s["slowest_ms"], s["slowest_trace_id"],
                         s.get("rate"))
    if worst is not None:
        out.append(f"slowest trace:       {worst[1]} "
                   f"({worst[0]:g} ms at {worst[2]:g} req/s) — "
                   "kdtree-tpu-torch trace --id <it> renders the waterfall")
    server = cap.get("server")
    if server:
        for op, stats in (server.get("write_latency_ms") or {}).items():
            out.append(f"write {op:<7s}       n={stats['count']} "
                       f"mean={stats['mean_ms']:g}ms")
        delta = server.get("rebuild_p99_delta_ms")
        if delta is not None:
            out.append(f"rebuild p99 delta:   {delta:+g} ms "
                       f"(epoch {server.get('epoch')})")
    return out


def _cost_classes(counters: Dict) -> Dict:
    """``{(verb, gear, outcome): {field: value}}`` distilled from the
    flat ``kdtree_cost_*`` counter keys of a report snapshot. Class
    labels come from the ledger's bounded enums, so splitting on commas
    is safe — no label value can contain one."""
    fields = {
        "kdtree_cost_requests_total": "requests",
        "kdtree_cost_rows_total": "rows",
        "kdtree_cost_queue_ms_total": "queue_ms",
        "kdtree_cost_device_ms_total": "device_ms",
        "kdtree_cost_visits_total": "visits",
        "kdtree_cost_retries_total": "retries",
        "kdtree_cost_bytes_in_total": "bytes_in",
        "kdtree_cost_bytes_out_total": "bytes_out",
    }
    classes: Dict = {}
    for key, val in (counters or {}).items():
        name = key.split("{", 1)[0]
        field = fields.get(name)
        if field is None or "{" not in key:
            continue
        labels = {}
        for part in key.split("{", 1)[1].rstrip("}").split(","):
            if "=" in part:
                lk, lv = part.split("=", 1)
                labels[lk] = lv.strip('"')
        ck = (labels.get("verb", "?"), labels.get("gear", "?"),
              labels.get("outcome", "?"))
        classes.setdefault(ck, {})[field] = float(val)
    return classes


# relative cost-per-query growth that earns the "<- cost grew" flag in
# stats --diff (display salience only; CI gating is trend's cost-growth
# rule with its own band)
COST_GROWTH_FLAG_FRAC = 0.05


def _cost_lines(counters: Dict, old_counters: Optional[Dict] = None) -> list:
    """Human rendering of the per-class cost table (ONE helper shared by
    ``stats`` and ``stats --diff`` so the two views cannot drift).
    cost/query is device_ms per answered request — the number the
    capacity-headroom model divides the device budget by."""
    classes = _cost_classes(counters)
    old_classes = (_cost_classes(old_counters)
                   if old_counters is not None else None)
    if not classes and not old_classes:
        return []

    def cpq(row):
        if not row or not row.get("requests"):
            return None
        return row.get("device_ms", 0.0) / row["requests"]

    out = ["== cost per query (device_ms, by class) =="]
    if old_classes is None:
        out.append(f"{'class':<34s}  {'req':>7s}  {'cost/q':>9s}  "
                   f"{'queue/q':>9s}  {'visits/q':>9s}  {'retries':>7s}")
        for ck in sorted(classes):
            row = classes[ck]
            n = row.get("requests", 0.0)
            c = cpq(row)
            out.append(
                f"{'/'.join(ck):<34s}  {n:>7g}  "
                f"{f'{c:.3f}ms' if c is not None else '-':>9s}  "
                f"{(row.get('queue_ms', 0.0) / n if n else 0.0):>7.3f}ms  "
                f"{(row.get('visits', 0.0) / n if n else 0.0):>9.1f}  "
                f"{row.get('retries', 0.0):>7g}"
            )
        return out
    out.append(f"{'class':<34s}  {'OLD cost/q':>11s}  {'NEW cost/q':>11s}  "
               f"{'delta':>8s}")
    for ck in sorted(set(classes) | set(old_classes)):
        o, n = cpq(old_classes.get(ck)), cpq(classes.get(ck))
        delta = (_fmt_delta(o, n) if o is not None and n is not None
                 else ("gone" if n is None else "new"))
        flag = ""
        if o is not None and n is not None and o > 0 and \
                (n - o) / o > COST_GROWTH_FLAG_FRAC:
            flag = "   <- cost grew"
        out.append(
            f"{'/'.join(ck):<34s}  "
            f"{f'{o:.3f}ms' if o is not None else '-':>11s}  "
            f"{f'{n:.3f}ms' if n is not None else '-':>11s}  "
            f"{delta:>8s}{flag}"
        )
    return out


def _recall_lines(block: Dict) -> list:
    """Human rendering of a recall-harness ``recall`` block (shared by
    ``stats`` and ``stats --diff`` so the two views cannot drift)."""
    out = ["== recall (bounded-visit vs exact oracle) =="]
    out.append(
        f"shape: n={block.get('n')} q={block.get('q')} "
        f"k={block.get('k')} buckets={block.get('nbp')}  exact "
        f"{block.get('exact_qps') or '?'} q/s"
    )
    curve = block.get("curve") or []
    if curve:
        out.append(f"{'visit_cap':>10s}  {'recall@k':>9s}  "
                   f"{'q/s':>10s}  {'speedup':>8s}")
        for row in curve:
            qps = row.get("qps")
            spd = row.get("speedup")
            out.append(
                f"{row.get('visit_cap', 0):>10d}  "
                f"{row.get('recall', 0.0):>9.4f}  "
                f"{qps if qps is not None else float('nan'):>10g}  "
                f"{spd if spd is not None else float('nan'):>7.2f}x"
            )
    return out


def render_report(rep: Dict) -> str:
    """Human-readable rendering of a report dict (the ``stats``
    subcommand). Leads with the run facts that decide whether the numbers
    are even comparable (platform, degraded, init time), then spans by
    total time, then counters/gauges/histograms."""
    out = []
    plat = rep.get("platform")
    if plat is None:
        for key in rep.get("gauges", {}):
            if key.startswith('torch_platform_info{'):
                plat = key.split('platform="', 1)[1].split('"')[0]
                break
    degraded = rep.get("degraded", False)
    out.append("== run ==")
    out.append(f"platform:            {plat or 'unknown'}"
               + ("   [DEGRADED: fell back from an accelerator]"
                  if degraded else ""))
    g = rep.get("gauges", {})
    if "device_init_seconds" in rep or "torch_device_init_seconds" in g:
        init_s = rep.get("device_init_seconds",
                         g.get("torch_device_init_seconds"))
        out.append(f"device init:         {float(init_s):.3f} s")
    if "torch_device_count" in g:
        out.append(f"devices:             {int(g['torch_device_count'])}")
    c = rep.get("counters", {})
    if "kdtree_kernel_builds_total" in c:
        secs = c.get("kdtree_kernel_build_seconds_total", 0.0)
        out.append(
            f"kernel builds:       {int(c['kdtree_kernel_builds_total'])}"
            f" ({secs:.2f} s total) — growth after warmup = rebuilds"
        )

    spans = rep.get("spans", {})
    if spans:
        out.append("")
        out.append("== spans (by total time) ==")
        width = max(len(p) for p in spans)
        for path, s in sorted(
            spans.items(), key=lambda kv: -kv[1]["total_seconds"]
        ):
            out.append(
                f"{path:<{width}}  n={s['count']:<5d} "
                f"total={s['total_seconds']:9.3f}s "
                f"mean={s['mean_seconds']*1e3:9.2f}ms"
            )

    plain_counters = dict(c)
    if plain_counters:
        out.append("")
        out.append("== counters ==")
        width = max(len(k) for k in plain_counters)
        for key in sorted(plain_counters):
            out.append(f"{key:<{width}}  {plain_counters[key]:g}")

    if g:
        out.append("")
        out.append("== gauges ==")
        width = max(len(k) for k in g)
        for key in sorted(g):
            out.append(f"{key:<{width}}  {g[key]:g}")

    cost_block = _cost_lines(c)
    if cost_block:
        out.append("")
        out.extend(cost_block)

    if isinstance(rep.get("capacity"), dict):
        out.append("")
        out.extend(_capacity_lines(rep["capacity"]))

    if isinstance(rep.get("recall"), dict):
        out.append("")
        out.extend(_recall_lines(rep["recall"]))

    hists = {
        k: v for k, v in rep.get("histograms", {}).items()
        if not k.startswith("kdtree_span_seconds")
    }
    if hists:
        out.append("")
        out.append("== histograms ==")
        for key in sorted(hists):
            snap = hists[key]
            count = int(snap["count"])
            mean = (float(snap["sum"]) / count) if count else 0.0
            out.append(f"{key}: n={count} mean={mean:g}")
            buckets = snap["buckets"]
            prev = 0
            for upper, cum in buckets.items():
                in_bucket = int(cum) - prev
                prev = int(cum)
                if in_bucket:
                    out.append(f"    <= {upper:>8}: {in_bucket}")
    return "\n".join(out) + "\n"


def _fmt_delta(old: float, new: float) -> str:
    """'+12.3%' / '-4.0%' / '  =' — relative change, guarded for zero."""
    if old == new:
        return "="
    if old == 0:
        return "new" if new else "="
    return f"{(new - old) / abs(old) * 100.0:+.1f}%"


def render_report_diff(old: Dict, new: Dict) -> str:
    """Side-by-side rendering of two telemetry reports (``stats --diff
    OLD NEW``) — the bench-regression triage view: spans by
    new total time with old totals and relative deltas, counter deltas
    (compile counts included), and gauges that moved. Rows present in
    only one report are marked rather than dropped — an appearing span
    IS the regression signal half the time."""
    out = []

    def fact(rep, key, default="?"):
        return rep.get(key, default)

    # pair-vs-single footgun: a --pair sidecar aggregates spans/counters
    # over BOTH timed passes (one registry per process). Diffing it
    # against a single-pass report reads as a silent ~2x regression —
    # warn LOUDLY instead of rendering a wrong comparison quietly.
    old_passes = int(old.get("passes", 1) or 1)
    new_passes = int(new.get("passes", 1) or 1)
    if old_passes != new_passes:
        out.append(
            "!! WARNING: pass-count mismatch — OLD aggregates "
            f"{old_passes} timed pass(es), NEW {new_passes}."
        )
        out.append(
            "!! A --pair sidecar sums spans and counters over both "
            "passes; comparing it against a single-pass report "
            "misreads as a ~2x regression. Compare only reports with "
            "matching \"passes\"."
        )
        out.append("")

    out.append("== run ==")
    out.append(f"{'':20s}  {'OLD':>14s}  {'NEW':>14s}")
    for key in ("platform", "device_count", "degraded"):
        ov, nv = fact(old, key), fact(new, key)
        if ov == "?" and nv == "?":
            continue
        flag = "   <- differs" if ov != nv else ""
        out.append(f"{key:20s}  {str(ov):>14s}  {str(nv):>14s}{flag}")
    oc, nc = old.get("counters", {}), new.get("counters", {})
    key = "kdtree_kernel_builds_total"
    if key in oc or key in nc:
        ov, nv = float(oc.get(key, 0)), float(nc.get(key, 0))
        out.append(f"{'kernel builds':20s}  {ov:14g}  {nv:14g}  "
                   f"{_fmt_delta(ov, nv)}")

    ospans, nspans = old.get("spans", {}), new.get("spans", {})
    if ospans or nspans:
        out.append("")
        out.append("== spans (by NEW total time) ==")
        paths = sorted(
            set(ospans) | set(nspans),
            key=lambda p: -nspans.get(p, {}).get("total_seconds", -1.0),
        )
        width = max(len(p) for p in paths)
        out.append(f"{'':{width}s}  {'OLD total':>12s}  {'NEW total':>12s}"
                   f"  {'delta':>8s}  {'OLD mean':>10s}  {'NEW mean':>10s}")
        for p in paths:
            o, n = ospans.get(p), nspans.get(p)
            ot = o["total_seconds"] if o else None
            nt = n["total_seconds"] if n else None
            om = f"{o['mean_seconds'] * 1e3:9.2f}ms" if o else "-"
            nm = f"{n['mean_seconds'] * 1e3:9.2f}ms" if n else "-"
            delta = (_fmt_delta(ot, nt) if o and n
                     else ("gone" if o else "new"))
            out.append(
                f"{p:{width}s}  {ot if ot is not None else float('nan'):11.3f}s"
                f"  {nt if nt is not None else float('nan'):11.3f}s"
                f"  {delta:>8s}  {om:>10s}  {nm:>10s}"
            )

    changed = []
    for key in sorted(set(oc) | set(nc)):
        # show every counter, changed or not: a flat counter between two
        # runs (e.g. zero overflow retries in both) is itself triage info
        changed.append((key, float(oc.get(key, 0)), float(nc.get(key, 0))))
    if changed:
        out.append("")
        out.append("== counters ==")
        width = max(len(k) for k, _, _ in changed)
        for key, ov, nv in changed:
            out.append(f"{key:{width}s}  {ov:14g}  {nv:14g}  "
                       f"{_fmt_delta(ov, nv)}")

    cost_block = _cost_lines(nc, old_counters=oc)
    if cost_block:
        out.append("")
        out.extend(cost_block)

    og, ng = old.get("gauges", {}), new.get("gauges", {})
    moved = [
        (k, float(og.get(k, 0)), float(ng.get(k, 0)))
        for k in sorted(set(og) | set(ng))
        if og.get(k) != ng.get(k)
    ]
    if moved:
        out.append("")
        out.append("== gauges (changed) ==")
        width = max(len(k) for k, _, _ in moved)
        for key, ov, nv in moved:
            out.append(f"{key:{width}s}  {ov:14g}  {nv:14g}")

    ocap, ncap = old.get("capacity"), new.get("capacity")
    if isinstance(ocap, dict) or isinstance(ncap, dict):
        out.append("")
        out.append("== capacity (knee + per-rate p99) ==")
        oknee = (ocap or {}).get("knee_rate")
        nknee = (ncap or {}).get("knee_rate")
        delta = (_fmt_delta(oknee, nknee)
                 if oknee is not None and nknee is not None
                 else ("gone" if oknee is not None else "new"))
        out.append(
            f"{'knee rate (req/s)':20s}  "
            f"{oknee if oknee is not None else float('nan'):>14g}  "
            f"{nknee if nknee is not None else float('nan'):>14g}  "
            f"{delta}"
        )
        osteps = {s.get("rate"): s for s in (ocap or {}).get("steps") or []}
        nsteps = {s.get("rate"): s for s in (ncap or {}).get("steps") or []}
        for rate in sorted(set(osteps) | set(nsteps)):
            op99 = (osteps.get(rate) or {}).get("p99_ms")
            np99 = (nsteps.get(rate) or {}).get("p99_ms")
            delta = (_fmt_delta(op99, np99)
                     if op99 is not None and np99 is not None else "")
            out.append(
                f"{f'p99 @ {rate:g} req/s':20s}  "
                f"{op99 if op99 is not None else float('nan'):>12.1f}ms  "
                f"{np99 if np99 is not None else float('nan'):>12.1f}ms  "
                f"{delta}"
            )
        # gear distributions ride in the steps (loadgen --recall-target):
        # show rates whose served-gear mix CHANGED — a capacity point is
        # only comparable to one measured at the same gears
        for rate in sorted(set(osteps) & set(nsteps)):
            og = (osteps.get(rate) or {}).get("gears") or {}
            ng = (nsteps.get(rate) or {}).get("gears") or {}
            if (og or ng) and og != ng:
                out.append(
                    f"{f'gears @ {rate:g} req/s':20s}  {og}  ->  {ng}"
                )

    orec, nrec = old.get("recall"), new.get("recall")
    if isinstance(orec, dict) or isinstance(nrec, dict):
        out.append("")
        out.append("== recall curve (per visit cap) ==")
        ocurve = {r.get("visit_cap"): r
                  for r in (orec or {}).get("curve") or []}
        ncurve = {r.get("visit_cap"): r
                  for r in (nrec or {}).get("curve") or []}
        out.append(f"{'visit_cap':>10s}  {'OLD recall':>11s}  "
                   f"{'NEW recall':>11s}  {'OLD q/s':>10s}  "
                   f"{'NEW q/s':>10s}")
        for cap in sorted(set(ocurve) | set(ncurve)):
            o, n = ocurve.get(cap), ncurve.get(cap)

            def cell(row, key, fmt):
                v = (row or {}).get(key)
                return format(v, fmt) if v is not None else "-"

            flag = ""
            if o and n and o.get("recall") is not None and \
                    n.get("recall") is not None and \
                    o["recall"] - n["recall"] > 1e-9:
                flag = "   <- recall fell"
            out.append(
                f"{cap:>10d}  {cell(o, 'recall', '11.4f'):>11s}  "
                f"{cell(n, 'recall', '11.4f'):>11s}  "
                f"{cell(o, 'qps', '10g'):>10s}  "
                f"{cell(n, 'qps', '10g'):>10s}{flag}"
            )
    return "\n".join(out) + "\n"
