"""The recall harness: measure the recall dial against the exact engine.

The port of ``kdtree_tpu/approx/recall.py``. The exact answer is always
computable, so recall@k is a measurement. The harness sweeps a ladder of
visit caps over one problem, answers each cap with the bounded-visit
engine (:mod:`kdtree_tpu_torch.approx.search`) and the full cap with the
exact tiled engine, and reports per cap:

- **recall@k** — the fraction of the exact top-k ids the bounded answer
  found (padding-aware; deterministic for a seeded problem);
- **q/s and speedup** — a warmup run, then one timed run that ends in a
  device barrier, the ``tune`` sweep's discipline.

Two artifacts come out: the **curve** (the ``recall`` block,
RECALL_VERSION-stamped) and the **calibration** (``recall_caps``:
recall_target -> smallest cap measured to reach it), which
:func:`persist_calibration` writes into the plan store for serving to
resolve ``recall_target`` through. Calibrations are advisory.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.approx.search import DEFAULT_TARGETS

RECALL_VERSION = 1


def recall_at_k(approx_ids, exact_ids) -> float:
    """Mean per-query recall@k: |approx ∩ exact| / |exact real ids|.

    Both are [Q, k] id arrays (or tensors) with -1 padding; padding never
    counts as a member, and a query whose exact row is all padding (k >
    n) counts 1.0 — there was nothing to find."""
    a = _host(approx_ids)
    e = _host(exact_ids)
    if a.shape != e.shape:
        raise ValueError(
            f"approx ids {a.shape} and oracle ids {e.shape} must match"
        )
    total = 0.0
    rows = a.shape[0]
    for qi in range(rows):
        truth = set(int(x) for x in e[qi] if x >= 0)
        if not truth:
            total += 1.0
            continue
        found = set(int(x) for x in a[qi] if x >= 0)
        total += len(truth & found) / len(truth)
    return total / max(rows, 1)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def default_caps(nbp: int) -> List[int]:
    """The sweep ladder: powers of two up to (and including) the bucket
    count — the full-cap point is what pins recall 1.0 and byte
    identity."""
    caps = []
    c = 2
    while c < int(nbp):
        caps.append(c)
        c *= 2
    caps.append(int(nbp))
    return caps


def _timed(tree, queries, k: int, visit_cap: Optional[int], plan):
    """Warmup + one timed run; returns (seconds, d2, ids) of the timed
    run."""
    from kdtree_tpu_torch.ops.tile_query import morton_knn_tiled

    d2, ids = morton_knn_tiled(tree, queries, k=k, plan=plan,
                               visit_cap=visit_cap)
    obs.hard_sync(d2)  # warmup: kernel build, allocations, cap settling
    t0 = time.perf_counter()
    d2, ids = morton_knn_tiled(tree, queries, k=k, plan=plan,
                               visit_cap=visit_cap)
    obs.hard_sync(d2)
    return time.perf_counter() - t0, d2, ids


def sweep_recall(
    tree,
    queries,
    k: int,
    caps: Optional[Sequence[int]] = None,
    log=None,
) -> Dict:
    """Sweep ``caps`` (default: the pow2 ladder up to the bucket count)
    against the exact engine; returns the ``recall`` block:
    ``{recall_version, n, q, k, nbp, exact_qps, exact_seconds, curve:
    [{visit_cap, recall, seconds, qps, speedup}]}``, the curve ascending
    in ``visit_cap``."""
    from kdtree_tpu_torch.ops.tile_query import plan_tiled

    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=tree.device)
    Q, D = queries.shape
    nbp = int(tree.num_buckets)
    caps = sorted({min(max(int(c), 1), nbp)
                   for c in (caps or default_caps(nbp))})
    # ONE plan for every run, so the sweep compares caps and not plans;
    # the forced engine makes it explicit, so nothing is recorded
    plan = plan_tiled(Q, D, tree.n_real, nbp, tree.bucket_size, k,
                      tile=None, use_kernel=tree.device.type == "cuda",
                      device=tree.device)
    exact_s, _, exact_ids = _timed(tree, queries, k, None, plan)
    exact_ids = exact_ids.cpu().numpy()
    exact_qps = Q / exact_s if exact_s > 0 else None
    curve = []
    for cap in caps:
        dt, _, ids = _timed(tree, queries, k,
                            None if cap >= nbp else cap, plan)
        row = {
            "visit_cap": cap,
            "recall": round(recall_at_k(ids, exact_ids), 6),
            "seconds": round(dt, 6),
            "qps": round(Q / dt, 3) if dt > 0 else None,
            "speedup": round(exact_s / dt, 3) if dt > 0 else None,
        }
        curve.append(row)
        if log is not None:
            log(row)
    obs.get_registry().counter("kdtree_recall_sweeps_total").inc()
    return {
        "recall_version": RECALL_VERSION,
        "n": int(tree.n_real),
        "q": int(Q),
        "k": int(k),
        "nbp": nbp,
        "exact_qps": (round(exact_qps, 3)
                      if exact_qps is not None else None),
        "exact_seconds": round(exact_s, 6),
        "curve": curve,
    }


def calibrate_caps(
    curve: List[dict],
    targets: Sequence[float] = DEFAULT_TARGETS,
) -> Dict[str, int]:
    """recall_target -> smallest measured cap reaching it. Targets that no
    swept cap reached are left out (resolution falls back to the
    heuristic there): a calibration never promises a recall the harness
    did not see."""
    out: Dict[str, int] = {}
    for target in targets:
        for row in sorted(curve, key=lambda r: r["visit_cap"]):
            if row["recall"] >= float(target):
                out[f"{float(target):g}"] = int(row["visit_cap"])
                break
    return out


def persist_calibration(
    tree, Q: int, D: int, k: int, block: Dict,
    targets: Sequence[float] = DEFAULT_TARGETS,
    store=None,
) -> Dict:
    """Write the sweep's calibration into the plan store (merged: launch
    knobs a tuner settled there stay).

    Recorded under every pow2 Q-bucket signature from the serving
    batcher's smallest bucket up to the sweep's own Q, because serving
    resolves a request's target at its batch's signature. The measured
    recall of each calibrated cap rides along, for the served-recall
    gauge. Returns ``{"recall_caps", "persisted", "path", "signature"}``;
    a disabled store persists nothing."""
    from kdtree_tpu_torch import tuning
    from kdtree_tpu_torch.serve.engine import MIN_BUCKET, _pow2_ceil

    store = store if store is not None else tuning.default_store()
    backend = tree.device.type
    caps = calibrate_caps(block["curve"], targets)
    top_sig = tuning.make_signature(Q, D, tree.n_real, k, tree.bucket_size,
                                    tree.num_buckets, devices=1,
                                    backend=backend)
    persisted = False
    if caps and store.enabled:
        measured = {
            t: next((r["recall"] for r in block["curve"]
                     if r["visit_cap"] == cap), None)
            for t, cap in caps.items()
        }
        q = MIN_BUCKET
        buckets = []
        while q < _pow2_ceil(max(Q, 1)):
            buckets.append(q)
            q *= 2
        buckets.append(_pow2_ceil(max(Q, 1)))
        for q in buckets:
            sig = tuning.make_signature(q, D, tree.n_real, k,
                                        tree.bucket_size, tree.num_buckets,
                                        devices=1, backend=backend)
            if store.record(sig, recall_caps=caps, recall_measured=measured):
                persisted = True
    return {
        "recall_caps": caps,
        "persisted": bool(persisted),
        "path": store.path_for(top_sig) if store.enabled else None,
        "signature": top_sig.key,
    }
