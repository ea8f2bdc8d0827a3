"""The Prometheus text exposition of the metrics registry.

The port of ``kdtree_tpu/obs/export.py``'s scrape half: ``prometheus_text``
(what ``GET /metrics`` serves), ``openmetrics_text`` (``?openmetrics=1``:
per-bucket exemplars and the ``# EOF`` terminator) and ``METRIC_HELP``
for every family this package registers. Both renderings are byte-equal
to the reference's for the same registry contents, so one scraper reads
a port server and a reference server alike. The JSON report, the JSONL
event log and their renderers are ROADMAP item 15.
"""

from __future__ import annotations

from typing import Optional

from kdtree_tpu_torch.obs.registry import MetricsRegistry, get_registry

# Help strings for EVERY metric family the package registers — the
# catalog is test-enforced (tests/test_torch_obs.py scans the package for
# instrument registrations and fails on any family missing here). The
# texts are the reference's, so the two expositions agree line for line.
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
    # spans
    "kdtree_span_seconds": "duration distribution per host span path",
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
