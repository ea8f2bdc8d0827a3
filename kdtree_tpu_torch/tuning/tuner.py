"""The ``tune`` sweep: time (tile, cmax) and then block-shape candidates
on a query sample, and persist the winner.

The port of ``kdtree_tpu/tuning/tuner.py``. Every candidate gets a warmup
run (kernel build, allocations and cap settling stay off the clock) and
one timed run that ends in a device barrier (``obs.hard_sync``:
``torch.cuda.synchronize()`` on CUDA). A candidate whose timed run still needed overflow retries is
invalid: its cap does not hold for this geometry. The winner is the
fastest valid candidate, persisted under the sample's signature, so a
later automatic ``plan_tiled`` of the same shape starts there.

Two phases, as in the reference:

1. **(tile, cmax)** — the launch grid, at the heuristic block shape;
2. **(v, tb)** — the plain scan's buckets per fold chunk and tiles per
   block, swept at the phase-1 winner. The CUDA kernel walks one bucket
   at a time and has no tile blocks, so neither knob changes what it
   runs: on the kernel path the sweep keeps one (v, tb) pair, the first
   of each grid.

A profile carries ``v``/``tb`` only when phase 2 measured them.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.tuning.store import PlanStore, default_store, make_signature

DEFAULT_TILES = (64, 128, 256, 512, 1024)
DEFAULT_CMAXS = (32, 64, 128, 256)
# v=None / tb=None rows are the plan heuristic's choice, always measured,
# so the sweep can only confirm or beat it
DEFAULT_VS = (1, 8)
DEFAULT_TBS = (1, 4, 32)


def _measure(tree, queries, k: int, **knobs) -> dict:
    """Warmup + one timed run of the tiled engine at ``knobs``; returns a
    result row with seconds/qps/overflow_retries."""
    from kdtree_tpu_torch.ops.tile_query import TileStats, morton_knn_tiled

    Q = queries.shape[0]
    d2, _ = morton_knn_tiled(tree, queries, k=k, **knobs)
    obs.hard_sync(d2)  # warmup: kernel build + first cap settle
    stats = TileStats()
    t0 = time.perf_counter()
    d2, _ = morton_knn_tiled(tree, queries, k=k, stats=stats, **knobs)
    obs.hard_sync(d2)
    dt = time.perf_counter() - t0
    return {
        "seconds": dt,
        "qps": Q / dt if dt > 0 else None,
        "overflow_retries": int(stats.retries),
    }


def _prev_block_knobs(store, sig, tile: int):
    """The previously persisted swept block shape, or None — only when
    the stored profile's tile matches (knobs measured at one tile width do
    not carry to another). cmax is not matched: feedback rewrites it on
    cap drift and keeps v/tb."""
    from kdtree_tpu_torch.ops.tile_query import _opt_knob

    prev = store.get(sig)
    if prev is None or tile != _opt_knob(prev.get("tile")):
        return None
    pv, ptb = _opt_knob(prev.get("v")), _opt_knob(prev.get("tb"))
    if pv is None or ptb is None:
        return None
    return pv, ptb


def sweep(
    tree,
    queries,
    k: int,
    tiles: Optional[Sequence[int]] = None,
    cmaxs: Optional[Sequence[int]] = None,
    vs: Optional[Sequence[int]] = None,
    tbs: Optional[Sequence[int]] = None,
    sweep_blocks: bool = True,
    store: Optional[PlanStore] = None,
    log=None,
) -> dict:
    """Time each (tile, cmax) candidate on ``queries`` (a tensor on the
    tree's device) against ``tree``, sweep the block shape at the winner,
    persist the overall winner, and return the result table.

    Returns ``{"results": [...], "block_results": [...], "winner": {...},
    "persisted": bool, "path": str | None}``; each row carries tile,
    cmax, v, tb, seconds, qps and the overflow retries of its timed run.
    """
    from kdtree_tpu_torch.ops.tile_query import DEFAULT_SEEDS

    use_kernel = tree.device.type == "cuda"
    Q = queries.shape[0]
    nbp = tree.num_buckets
    tiles = [t for t in (tiles or DEFAULT_TILES) if t <= max(Q, 1)] or [
        max(Q, 1)
    ]
    cmaxs = [c for c in (cmaxs or DEFAULT_CMAXS) if c <= nbp] or [nbp]

    results = []
    for tile in tiles:
        for cmax in cmaxs:
            row = {"tile": tile, "cmax": cmax, "v": None, "tb": None}
            row.update(_measure(tree, queries, k, tile=tile, cmax=cmax))
            results.append(row)
            if log is not None:
                log(row)

    valid = [r for r in results if r["overflow_retries"] == 0]
    store = store if store is not None else default_store()
    sig = make_signature(Q, queries.shape[1], tree.n_real, k,
                         tree.bucket_size, nbp, devices=1,
                         backend=tree.device.type)
    if not valid:
        # every candidate's cap overflowed: the settled cap cannot be
        # recovered from the retry count, so nothing is persisted
        winner = min(results, key=lambda r: r["seconds"])
        return {
            "results": results,
            "block_results": [],
            "winner": winner,
            "persisted": False,
            "path": store.path_for(sig) if store.enabled else None,
            "reason": "every candidate overflowed its cap; re-run with "
                      "larger --cmax values",
        }
    winner = min(valid, key=lambda r: r["seconds"])

    block_results = []
    if sweep_blocks:
        vs_eff = list(vs or DEFAULT_VS)
        tbs_eff = list(tbs or DEFAULT_TBS)
        if use_kernel:
            # the kernel reads neither knob: distinct values would time
            # identical configurations
            vs_eff, tbs_eff = vs_eff[:1], tbs_eff[:1]
        pairs = [(int(v), int(tb)) for v in vs_eff for tb in tbs_eff]
        # a previously swept block shape at the same launch config defends
        # its slot on the clock
        prev_knobs = _prev_block_knobs(store, sig, winner["tile"])
        if prev_knobs is not None and use_kernel:
            prev_knobs = (vs_eff[0], tbs_eff[0])
        if prev_knobs is not None and prev_knobs not in pairs:
            pairs.append(prev_knobs)
        for v, tb in pairs:
            row = {"tile": winner["tile"], "cmax": winner["cmax"],
                   "v": v, "tb": tb}
            row.update(_measure(
                tree, queries, k, tile=winner["tile"],
                cmax=winner["cmax"], scan_v=v, scan_tb=tb,
            ))
            block_results.append(row)
            if log is not None:
                log(row)
        block_valid = [r for r in block_results
                       if r["overflow_retries"] == 0]
        winner = min([winner, *block_valid], key=lambda r: r["seconds"])

    profile = {
        "tile": int(winner["tile"]),
        "cmax": int(winner["cmax"]),
        "seeds": DEFAULT_SEEDS,
        "use_kernel": use_kernel,
        "source": "tune",
        "tune_qps": winner["qps"],
        "tune_seconds": winner["seconds"],
        "overflow_retries": 0,
    }
    if winner["v"] is not None:
        profile["v"] = int(winner["v"])
        profile["tb"] = int(winner["tb"])
    elif not sweep_blocks:
        # a sweep that measured no block shape keeps the earlier swept
        # knobs instead of erasing them
        prev_knobs = _prev_block_knobs(store, sig, profile["tile"])
        if prev_knobs is not None:
            profile["v"], profile["tb"] = prev_knobs
    persisted = store.put(sig, profile)
    return {
        "results": results,
        "block_results": block_results,
        "winner": winner,
        "persisted": persisted,
        "path": store.path_for(sig) if store.enabled else None,
    }
