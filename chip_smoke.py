#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py [--dfs-round-sweep]

``--dfs-round-sweep`` adds to phase 6 the DFS timed at 4, 8, 16 and 32
steps per host look on 16,384 of the sparse lane's queries: the run that
chose ``_ROUND_STEPS`` in ``kdtree_tpu_torch/ops/morton.py``, for when the
DFS changes.

Phases, one line each (any failure raises and exits non-zero):

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds every kernel source of the port, in parallel;
3. kernel  — the CUDA scan kernel, and the merge kernel that joins a tile's
             walk when it is split over several blocks, against their plain
             PyTorch versions on the card, bit for bit (d2 and ids): D, k,
             k > n_real, ragged tiles, -1 candidate padding, a clustered
             cloud, a tie-heavy lattice, two row chunks per bucket, 4-byte
             copies (B % 4 != 0), k > 32 and D > 8, each at 1 block per tile,
             the planned count, and forced to 2 and 7;
4. main    — 2^24 x 3-D points (seed 42) -> Morton build (B=256) ->
             ServeEngine(k=16) with its warmup ladder 8..1024 -> served
             requests of 1, 7, 64, 1000 and 1024 rows and one brute-force
             fallback batch, each checked against the brute-force oracle ->
             one morton_knn_tiled run of 2^20 queries, checked on a sample.
             Both kernels' launch counts are zeroed just before this phase
             and must be > 0 after it. Then the served 7-, 64- and 1000-row
             requests once more under torch.profiler: device time by kernel;
5. shapes  — on the 2^24 tree, the kernels against the plain version and
             timed (CUDA events) at the tiled run's collect shape and at the
             final collect dispatch of the 8-, 64- and 1024-row serve
             batches, each beside the bound its inputs define (per
             query, and the coarser tile-level count); at the serve
             shapes also swept over blocks per tile, each count checked
             bit for bit;
6. cli     — the DFS engine and the one-shot CLI, with both kernels' launch
             counts zeroed just before and read just after: the headline
             (generate_problem + build_morton + morton_knn, 10 queries, k=1,
             at 2^24 x 3-D; minimum of 5 fresh seeds after a warm-up) and
             the sparse-DFS lane (65,536 queries, k=16, on phase 4's tree),
             both exact against the oracle, with their DFS steps and host
             syncs; the same queries through morton_knn_tiled beside
             dense_lowd's choice, every answer held against the DFS's;
             ``python -m kdtree_tpu_torch harness`` on both golden
             configurations, stdout byte-equal to tests/golden/; then in
             process ``bench --engine morton`` at 2^24 x 3-D, ``build
             --out`` at 2^20 -> ``query`` (each line against the oracle),
             and ``query --queries`` with 2^16 dense rows, which must
             launch the scan kernel. After the counts are read: the kernels
             against the plain version, timed beside their bound, at the
             final collect dispatch of both tiled runs (the sparse lane's
             and ``query --queries``'s), and the device launches of one DFS
             step under torch.profiler.
7. serve   — the HTTP front over the mutable index, with both kernels' launch
             counts zeroed after the in-process server's warmup and read
             after its stop: build_state over phase 4's tree (k=16,
             max_batch 1024, epoch rebuild at a backlog of 256) and
             make_server(port=0).start() (the warmup ladder 8..1024); 8
             client threads send requests of 1, 7, 64 and 1000 rows (some
             with k < 16); one 1025-row oversized request, with a 1-row
             request sent while it runs; each size 5 times alone, split
             into HTTP round trip, the server's admission-to-answer and
             batch-dispatch ms (flight ring), beside the same batch
             through the engine directly (timed before the counts are
             zeroed, so they hold the server's launches alone; the scan
             kernel's must be > 0 over these requests); then 64 new
             ids beside query points, 32 moved and 32 deleted (among them
             1st and 16th hits); then 100 more cross the backlog and an
             epoch rebuild runs while 4 readers keep querying, /healthz
             polled until epoch 1. Every answer, before and after the
             writes and across the swap, is held against the brute-force
             oracle over the surviving points. /metrics must show the
             serving, epoch and write families; stop() must answer 4
             admitted requests. Then ``python -m kdtree_tpu_torch serve``
             at 2^20 points as a subprocess: its ready line, one answer
             against the oracle, SIGTERM -> exit 0 and "drained; bye".
             Prints HTTP ms by row count (concurrent, and one request at
             a time), the writes' ms and the rebuild's s.

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 42
N_POINTS = 1 << 24
DIM = 3
BUCKET = 256
K = 16
MAX_BATCH = 1024
REQUEST_ROWS = (1, 7, 64, 1000, 1024)
TILED_QUERIES = 1 << 20
SAMPLE = 2048
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
FP32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
SPARSE_Q = 1 << 16  # the sparse-DFS lane's queries (the JAX bench's shape)
HEADLINE_QUERIES = 10
CLI_BUILD_N = 1 << 20
CLI_DENSE_Q = 1 << 16
GOLDEN_SEEDS = (7, 42)
SPLITS = (1, None, 2, 7)  # blocks per tile in phase 3: one, the planned count, forced
MERGE_ERR = [0.0]  # the merge kernel's largest difference from the plain merge
SERVE_CLIENTS = 8  # phase 7's concurrent HTTP clients
SERVE_DELTA_ROWS = 256  # phase 7's epoch-rebuild backlog
SERVE_NEW = 164  # new ids phase 7 upserts: 64 beside queries, 100 to cross the backlog
SERVE_CLI_N = 1 << 20  # points of phase 7's CLI server


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_answer(points, queries, d2, ids, k, what, want=None):
    """d2 must equal the brute-force oracle's bit for bit; ids must equal
    its ids wherever the distance is not tied with a neighbouring rank,
    and every returned id must reproduce its distance (so ties may pick
    either of the equal points, never a wrong one). ``want`` = (d2, ids)
    of another exact engine takes the oracle's place."""
    import torch

    from kdtree_tpu_torch.ops import bruteforce
    from kdtree_tpu_torch.ops._arith import sq_dist

    q = torch.as_tensor(queries, device=points.device)
    if want is None:
        od, oi = bruteforce.knn(points, q, k=k)
    else:
        od, oi = (torch.as_tensor(w, device=points.device) for w in want)
    d2 = torch.as_tensor(d2, device=points.device)
    ids = torch.as_tensor(ids, device=points.device)
    assert d2.shape == od.shape and ids.shape == oi.shape, what
    assert torch.isfinite(d2).all(), f"{what}: non-finite distances"
    assert torch.equal(d2, od), f"{what}: d2 differs from the oracle"
    tied = torch.zeros_like(od, dtype=torch.bool)
    tied[:, 1:] |= od[:, 1:] == od[:, :-1]
    tied[:, :-1] |= od[:, :-1] == od[:, 1:]
    assert torch.equal(ids[~tied], oi[~tied]), f"{what}: ids differ"
    again = sq_dist(q[:, None, :], points[ids.long()])
    assert torch.equal(again, d2), f"{what}: ids do not reproduce d2"
    assert (ids.sort(dim=1).values.diff(dim=1) != 0).all(), f"{what}: dup ids"
    return int(tied.sum())


def kernel_run(tree, tq, cand, lb, k, splits, visited=None):
    """The main path's kernels on one batch: the scan kernel, then (when the
    walk was split) the merge kernel, which is also held against the plain
    merge on the same partial buffers. Returns (d2, ids, blocks per tile)."""
    import torch

    from kdtree_tpu_torch.kernels.scan_knn import merge_partials, scan_partials
    from kdtree_tpu_torch.ops import tile_query as tqm

    pd, pi = scan_partials(tree, tq, cand, lb, k, visited=visited, splits=splits)
    T, S, TQ, _ = pd.shape
    if S == 1:
        return pd.view(T, TQ, k), pi.view(T, TQ, k), 1
    kd, ki = merge_partials(pd, pi)
    md, mi = tqm.merge_partials(pd, pi)
    torch.cuda.synchronize()
    assert torch.equal(kd, md) and torch.equal(ki, mi), "merge kernel != plain merge"
    fin = torch.isfinite(md)
    if fin.any():
        MERGE_ERR[0] = max(MERGE_ERR[0], float((kd[fin] - md[fin]).abs().max()))
    return kd, ki, S


def collect_inputs(tree, tq, kk, seeds, cap, grow=False):
    """The collect pass's inputs for tiles tq, bounded by a plain seed pass.
    ``grow`` doubles the cap until the frontier holds every candidate, as
    ``drive_batches`` does for a served batch."""
    import torch

    from kdtree_tpu_torch.ops import tile_query as tqm

    T = tq.shape[0]
    blo, bhi = tq.amin(1), tq.amax(1)
    inf = torch.full((T,), float("inf"), device=tq.device)
    c0, l0, _ = tqm._frontier(tree, blo, bhi, inf, seeds)
    sd, _ = tqm._scan_tiles(tree, tq, c0, l0, kk, 1, T)
    bound = sd[..., -1].amax(1)
    while True:
        cand, lb, over = tqm._frontier(tree, blo, bhi, bound, cap)
        if not grow or cap >= tree.num_buckets or not bool(over.any()):
            return cand, lb
        cap = min(cap * 2, tree.num_buckets)


def sorted_tiles(queries, tile):
    from kdtree_tpu_torch.ops import tile_query as tqm

    T = queries.shape[0] // tile
    sq, _ = tqm._sort_queries(queries[: T * tile], tqm.default_bits(queries.shape[1]), 0)
    return sq.reshape(T, tile, -1).contiguous()


def phase_kernel(dev):
    import torch

    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.ops.morton import build_morton

    rng = np.random.default_rng(SEED)
    cases = []  # name, points, queries, tile, k, cmax, holes, bucket, splits
    for d in (2, 3, 8):
        for k in (1, 5, 16):
            cases.append((f"uniform D={d} k={k}", generate_points_rowwise(d, d, 20000, device=dev),
                          generate_queries(d + 10, d, 8 * 64, device=dev), 64, k, 64, False, 64,
                          SPLITS))
    cases.append(("k>n_real", generate_points_rowwise(5, 3, 50, device=dev),
                  generate_queries(6, 3, 40, device=dev), 20, 64, 128, False, 64, SPLITS))
    cases.append(("TQ=37", generate_points_rowwise(7, 3, 20000, device=dev),
                  generate_queries(8, 3, 6 * 37, device=dev), 37, 5, 64, False, 64, SPLITS))
    cases.append(("-1 padding", generate_points_rowwise(9, 3, 20000, device=dev),
                  generate_queries(10, 3, 8 * 32, device=dev), 32, 7, 128, True, 64, SPLITS))
    centers = rng.uniform(-80, 80, (6, 3))
    cl = centers[rng.integers(0, 6, 50000)] + rng.normal(0, 0.5, (50000, 3))
    clq = centers[rng.integers(0, 6, 512)] + rng.normal(0, 0.5, (512, 3))
    cases.append(("clustered", torch.tensor(cl, dtype=torch.float32, device=dev),
                  torch.tensor(clq, dtype=torch.float32, device=dev), 32, 8, 1024, False, 64,
                  SPLITS))
    # tie-heavy: ~160 copies of each of 125 lattice sites, queries on sites;
    # chunks split the copies of one site, so a later chunk can hold k
    # entries at a distance an earlier chunk also reaches
    lat = rng.integers(-2, 3, (20000, 3)).astype(np.float32)
    latq = rng.integers(-2, 3, (256, 3)).astype(np.float32)
    cases.append(("lattice ties", torch.tensor(lat, device=dev), torch.tensor(latq, device=dev),
                  8, 16, 1024, False, 16, SPLITS + (64,)))
    cases.append(("two row chunks per bucket (D=8, B=256)",
                  generate_points_rowwise(11, 8, 20000, device=dev),
                  generate_queries(12, 8, 4 * 64, device=dev), 64, 5, 64, False, 256, SPLITS))
    cases.append(("4-byte copies (B=50)", generate_points_rowwise(13, 3, 20000, device=dev),
                  generate_queries(14, 3, 4 * 32, device=dev), 32, 5, 128, True, 50, SPLITS))
    cases.append(("k=40, buffer in device memory", generate_points_rowwise(15, 3, 20000, device=dev),
                  generate_queries(16, 3, 4 * 32, device=dev), 32, 40, 128, False, 64, SPLITS))
    cases.append(("D=13, query in device memory", generate_points_rowwise(17, 13, 5000, device=dev),
                  generate_queries(18, 13, 4 * 32, device=dev), 32, 5, 128, False, 64, SPLITS))
    max_err = 0.0
    for name, pts, qs, tile, k, cmax, holes, bucket, splits in cases:
        tree = build_morton(pts, bucket_cap=bucket)
        tq = sorted_tiles(qs, tile)
        kk = min(k, tree.n_real)
        cand, lb = collect_inputs(tree, tq, kk, tqm.DEFAULT_SEEDS, cmax)
        if holes:
            cand = cand.clone()
            cand[:, 1::3] = -1  # -1 padding inside the list; its lb stays finite
        T = tq.shape[0]
        pd, pi = tqm._scan_tiles(tree, tq, cand, lb, kk, 1, T)
        ncand = (cand >= 0).sum(1)
        for sp in splits:
            visited = torch.empty(T, dtype=torch.int32, device=dev)
            kd, ki, S = kernel_run(tree, tq, cand, lb, kk, sp, visited)
            torch.cuda.synchronize()
            assert torch.equal(kd, pd) and torch.equal(ki, pi), f"kernel != plain: {name}, splits {sp}"
            fin = torch.isfinite(pd)
            max_err = max(max_err, float((kd[fin] - pd[fin]).abs().max()) if fin.any() else 0.0)
            exits = int((visited < ncand).sum())
            say("kernel", f"{name}, {S} block(s)/tile: bit-equal (k={kk}, tiles={T}, "
                          f"B={tree.bucket_size}, early exits in {exits} tiles)")
            if name == "clustered" and S == 1:
                assert exits > 0, "the clustered case never took the early exit"
    return max_err


def _roofline(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops


def input_bound(tree, tq, cand, lb, pd, kk):
    """The least time the card needs for this scan, counted from its inputs
    query by query: each query must meet every real candidate bucket whose
    leaf box lies strictly closer than its own final k-th distance (the
    plain version's output; ``sq_dist_to_box`` is the skip's arithmetic),
    doing 3 D flops (a subtract and an FMA per axis) per point of it; each
    bucket that at least one query of its tile needs is read once, B x
    (D + 1) words and its cand/lb entry. Bytes also count the queries and
    the outputs. The ``tile_`` keys keep the coarser tile-level count: every
    query of a tile against each real candidate whose lb is below the
    tile's final worst k-th."""
    from kdtree_tpu_torch.ops._arith import sq_dist_to_box

    T, TQ, D = tq.shape
    C, B = cand.shape[1], tree.bucket_size
    qk = pd[..., kk - 1]
    first_leaf = tree.num_buckets - 1
    pairs = buckets = 0
    step = max(1, (1 << 22) // (TQ * max(C, 1)))  # tiles per slice: ~4M (query, bucket) pairs
    for t0 in range(0, T, step):
        c = cand[t0:t0 + step]
        leaf = c.clamp(min=0).long() + first_leaf
        bd = sq_dist_to_box(tq[t0:t0 + step, :, None, :], tree.node_lo[leaf][:, None],
                            tree.node_hi[leaf][:, None])
        need = (bd < qk[t0:t0 + step, :, None]) & (c >= 0)[:, None, :]
        pairs += int(need.sum())
        buckets += int(need.any(1).sum())
    bound_ms, bound_by, t_bytes, t_ops = _roofline(
        buckets * (B * (D + 1) * 4 + 8) + T * TQ * D * 4 + T * TQ * kk * 8,
        pairs * B * 3 * D)

    below = lb < qk.amax(1)[:, None]
    tile_need = int(((cand >= 0) & below).sum())
    tile_ms, tile_by, _, _ = _roofline(
        tile_need * B * (D + 1) * 4 + (int(below.sum()) + T) * 8 + T * TQ * D * 4
        + T * TQ * kk * 8, tile_need * B * TQ * 3 * D)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "pairs": pairs, "need": buckets, "tile_bound_ms": tile_ms,
            "tile_bound_by": tile_by, "tile_need": tile_need}


def sweep_splits(tree, tq, cand, lb, kk, planned, want, reps):
    """The scan and merge at blocks-per-tile counts around the planned one,
    each checked bit for bit against ``want`` and timed. Returns
    {blocks per tile: ms}."""
    import torch

    from kdtree_tpu_torch.kernels.scan_knn import scan_partials, scan_tiles

    C = cand.shape[1]
    out = {}
    for f in (0, 1 / 64, 1 / 16, 1 / 4, 1 / 2, 1, 2, 4, 8):
        sp = max(1, min(C, round(planned * f)))
        S = scan_partials(tree, tq, cand, lb, kk, splits=sp)[0].shape[1]
        if S in out:
            continue
        d, i = scan_tiles(tree, tq, cand, lb, kk, splits=sp)
        torch.cuda.synchronize()
        assert torch.equal(d, want[0]) and torch.equal(i, want[1]), f"kernel != plain at S={S}"
        out[S] = cuda_ms(lambda: scan_tiles(tree, tq, cand, lb, kk, splits=sp), reps)
    return out


def time_shape(name, tree, tq, cand, lb, kk, plain_v, reps, plain_reps=0, sweep=False):
    """Kernel(s) vs plain version on one collect-pass batch, bit for bit,
    then timed (CUDA events), beside the input-defined bound; ``sweep``
    also times the kernels at other blocks-per-tile counts."""
    import torch

    from kdtree_tpu_torch.kernels.scan_knn import merge_partials, scan_partials, scan_tiles
    from kdtree_tpu_torch.ops import tile_query as tqm

    T = tq.shape[0]
    pd, pi = tqm._scan_tiles(tree, tq, cand, lb, kk, plain_v, T)
    kd, ki, S = kernel_run(tree, tq, cand, lb, kk, None)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi), f"kernel != plain at {name}"
    rec = input_bound(tree, tq, cand, lb, pd, kk)
    rec.update(name=name, shape=f"T={T} TQ={tq.shape[1]} C={cand.shape[1]} k={kk}", splits=S)
    rec["ms"] = cuda_ms(lambda: scan_tiles(tree, tq, cand, lb, kk), reps)
    rec["scan_ms"] = cuda_ms(lambda: scan_partials(tree, tq, cand, lb, kk), reps)
    if S > 1:
        parts = scan_partials(tree, tq, cand, lb, kk)
        rec["merge_ms"] = cuda_ms(lambda: merge_partials(*parts), reps)
        rec["merge_plain_ms"] = cuda_ms(lambda: tqm.merge_partials(*parts), reps)
        # the merge reads every partial buffer once and writes the answer
        rec["merge_bound_ms"] = (parts[0].numel() * 8 + T * tq.shape[1] * kk * 8) \
            / HBM_BYTES_PER_S * 1e3
    if plain_reps:
        rec["plain_ms"] = cuda_ms(lambda: tqm._scan_tiles(tree, tq, cand, lb, kk, plain_v, T),
                                  plain_reps)
    say("kernel", f"{name} ({rec['shape']}, {S} block(s)/tile): bit-equal; "
                  f"{rec['ms']:.4f} ms (scan {rec['scan_ms']:.4f}"
                  + (f", merge {rec['merge_ms']:.4f}" if S > 1 else "")
                  + f"), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; bytes "
                  f"{rec['bytes_ms']:.4f}, operations {rec['ops_ms']:.4f}; "
                  f"{rec['pairs']} (query, bucket) pairs, {rec['need']} (tile, bucket) "
                  f"reads needed); tile-level bound {rec['tile_bound_ms']:.4f} ms "
                  f"({rec['tile_bound_by']}, {rec['tile_need']} buckets)"
                  + (f", plain {rec['plain_ms']:.2f} ms" if plain_reps else ""))
    if sweep:
        rec["sweep"] = sweep_splits(tree, tq, cand, lb, kk, S, (pd, pi), 5)
        say("kernel", f"{name}: ms by blocks per tile (planned {S}): "
                      + ", ".join(f"{s} {t:.4f}" for s, t in sorted(rec["sweep"].items())))
    return rec


def phase_shapes(tree, sq, plan):
    """The kernels at the main path's shapes on the 2^24 tree: one collect
    batch of the tiled run (the plan's tile and cap, as in its first
    dispatch), and the final collect dispatch of the 8-, 64- and 1024-row
    serve batches (the requests of phase 4, caps grown until the frontier
    holds). Returns the records by shape."""
    import torch

    from kdtree_tpu_torch.kernels.scan_knn import scan_tiles
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops.generate import generate_queries
    from kdtree_tpu_torch.serve.engine import batch_bucket

    dev = sq.device
    kk = min(K, tree.n_real)
    tq = sq[: plan.qbatch].reshape(-1, plan.tile, DIM).contiguous()
    cand, lb = collect_inputs(tree, tq, kk, plan.seeds, plan.cmax)
    recs = {"main": time_shape("main collect shape", tree, tq, cand, lb, kk, 1, 20, 1)}
    for sp in (2, 4):
        ms = cuda_ms(lambda: scan_tiles(tree, tq, cand, lb, kk, splits=sp), 20)
        say("kernel", f"main collect shape forced to {sp} blocks/tile: {ms:.4f} ms")

    # the batch's stages, for the breakdown
    T = tq.shape[0]
    blo, bhi = tq.amin(1), tq.amax(1)
    inf = torch.full((T,), float("inf"), device=dev)
    c0, l0, _ = tqm._frontier(tree, blo, bhi, inf, plan.seeds)
    sd, _ = scan_tiles(tree, tq, c0, l0, kk)
    bound = sd[..., -1].amax(1)
    recs["stages"] = {
        "hilbert sort": cuda_ms(lambda: tqm._sort_queries(sq[: plan.qbatch], plan.bits, 0), 5),
        "seed frontier": cuda_ms(lambda: tqm._frontier(tree, blo, bhi, inf, plan.seeds), 5),
        "seed scan": cuda_ms(lambda: scan_tiles(tree, tq, c0, l0, kk), 5),
        "collect frontier": cuda_ms(lambda: tqm._frontier(tree, blo, bhi, bound, plan.cmax), 5),
        "collect scan": recs["main"]["ms"],
    }

    for i, rows in enumerate(REQUEST_ROWS):
        if rows not in (7, 64, 1000):
            continue
        bucket = batch_bucket(rows, MAX_BATCH)
        q = generate_queries(SEED + 1 + i, DIM, rows, device=dev)
        q = torch.cat([q, q[-1:].expand(bucket - rows, DIM)])
        p = tqm.plan_tiled(bucket, DIM, tree.n_real, tree.num_buckets, tree.bucket_size, K,
                           device=dev)
        s, _ = tqm._sort_queries(q, p.bits, (-bucket) % p.qbatch)
        stq = s.reshape(-1, p.tile, DIM).contiguous()
        c, l = collect_inputs(tree, stq, kk, p.seeds, p.cmax, grow=True)
        recs[rows] = time_shape(f"serve {rows} rows (bucket {bucket})", tree, stq, c, l, kk,
                                64, 20, sweep=True)
    return recs


def _start_profiler():
    """A started torch.profiler over CPU and CUDA, or (None, why not)."""
    from torch.profiler import ProfilerActivity, profile

    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:  # CUPTI tracing may be unavailable; the request still runs
        return None, f"{type(e).__name__}: {e}"
    return prof, None


def serve_profile(engine, served):
    """Serve the 7-, 64- and 1000-row requests once more, each under
    torch.profiler, and split its device time by kernel family: the scan
    kernels against the rest, which is the frontier's torch ops. Only the
    profiler may fail quietly; a failed request raises, and each answer
    must equal the one served before. Returns one line per request."""
    import torch

    lines = []
    for q, d2, ids, rows, bucket, _, _ in served:
        if rows not in (7, 64, 1000):
            continue
        qp = np.concatenate([q, np.broadcast_to(q[-1], (bucket - rows, DIM))])
        prof, why = _start_profiler()
        t0 = time.perf_counter()
        pd2, pids, _ = engine.knn_batch(qp)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        assert np.array_equal(np.asarray(pd2)[:rows], np.asarray(d2)) and \
            np.array_equal(np.asarray(pids)[:rows], np.asarray(ids)), \
            f"request of {rows} rows answered differently under the profiler"
        events = []
        if prof is not None:
            try:
                prof.stop()
                events = prof.key_averages()
            except Exception as e:  # the trace, not the request, failed
                why = f"{type(e).__name__}: {e}"
        if why is not None:
            lines.append(f"request {rows} rows: {wall:.2f} ms; device time not measured "
                         f"(profiler: {why})")
            continue
        scan = merge = other = 0.0
        for e in events:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if "scan_knn_merge" in e.key:
                merge += us
            elif "scan_knn" in e.key:
                scan += us
            else:
                other += us
        if scan + merge + other == 0:
            lines.append(f"request {rows} rows: {wall:.2f} ms under the profiler; device time "
                         f"not measured (the trace holds no device events)")
        else:
            lines.append(f"request {rows} rows: {wall:.2f} ms under the profiler; device ms: "
                         f"scan kernel {scan / 1e3:.3f}, merge kernel {merge / 1e3:.3f}, "
                         f"other (frontier, sort, copies) {other / 1e3:.3f}")
    return lines


def tiled_dispatch(name, tree, queries, plain_v):
    """The kernels at the final collect dispatch that ``morton_knn_tiled``
    plans for ``queries`` on ``tree`` (one batch; the cap grown until the
    frontier holds, as its overflow retries do), through ``time_shape``."""
    from kdtree_tpu_torch.ops import tile_query as tqm

    Q = queries.shape[0]
    kk = min(K, tree.n_real)
    p = tqm.plan_tiled(Q, DIM, tree.n_real, tree.num_buckets, tree.bucket_size, K,
                       device=queries.device)
    assert p.qbatch >= Q, f"{name}: more than one batch"
    s, _ = tqm._sort_queries(queries, p.bits, (-Q) % p.qbatch)
    stq = s.reshape(-1, p.tile, DIM).contiguous()
    c, l = collect_inputs(tree, stq, kk, p.seeds, p.cmax, grow=True)
    return time_shape(name, tree, stq, c, l, kk, plain_v, 20)


def dfs_launches_per_step(tree, queries, want):
    """Device launches (kernels, copies, fills) of one DFS step on the
    card: torch.profiler over one extra eager round of the engine's steps,
    run just before the engine captures its round as a CUDA graph, divided
    by the steps of a round. An extra round is a valid schedule (each lane
    goes on with its own pops), so the answer must still equal ``want``.
    Returns (launches per step or None, note)."""
    import torch

    import kdtree_tpu_torch.ops.morton as morton_mod

    original = morton_mod._round_runner
    seen = []

    def counted(steps, dev, st):
        if not seen:
            prof, why = _start_profiler()
            steps()
            torch.cuda.synchronize()
            n = 0
            if prof is not None:
                try:
                    prof.stop()
                    n = sum(1 for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA)
                except Exception as e:  # the trace, not the DFS, failed
                    why = f"{type(e).__name__}: {e}"
            seen.append((n, why))
        return original(steps, dev, st)

    morton_mod._round_runner = counted
    try:
        d, i = morton_mod.morton_knn(tree, queries, k=K)
    finally:
        morton_mod._round_runner = original
    assert torch.equal(d, want[0]) and torch.equal(i, want[1]), \
        "an extra DFS round changed the answer"
    n, why = seen[0]
    if why is not None or n == 0:
        return None, why or "the trace holds no device events"
    return n / morton_mod._ROUND_STEPS, f"{n} in one round of {morton_mod._ROUND_STEPS} steps"


def dfs_round_sweep(tree, queries, want):
    """The DFS at 4, 8, 16 and 32 steps per host look (the engine's
    ``_ROUND_STEPS``, restored after), each answer held against ``want``.
    Returns the line to print. A run for when the DFS changes
    (``--dfs-round-sweep``), not part of the default smoke."""
    import torch

    import kdtree_tpu_torch.ops.morton as morton_mod

    out = {}
    saved = morton_mod._ROUND_STEPS
    try:
        for rs in (4, 8, 16, 32):
            morton_mod._ROUND_STEPS = rs
            st = morton_mod.DfsStats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, i = morton_mod.morton_knn(tree, queries, k=K, stats=st)
            d[:1].cpu()
            out[rs] = (time.perf_counter() - t0, st)
            assert torch.equal(d, want[0]) and torch.equal(i, want[1]), \
                f"DFS answer changed with {rs} steps per round"
    finally:
        morton_mod._ROUND_STEPS = saved
    return (f"sparse DFS, first {queries.shape[0]} queries, by steps per round (s; steps, "
            "host syncs): " + "; ".join(f"{rs}: {t:.4f} ({w.steps}, {w.syncs})"
                                        for rs, (t, w) in out.items()))


def run_cli(argv):
    """(stdout, stderr) of the port's CLI ``main(argv)``, in process; a
    non-zero exit raises."""
    import contextlib
    import io

    from kdtree_tpu_torch.utils import cli

    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(argv)
    except SystemExit as e:
        if e.code not in (0, None):
            raise AssertionError(f"cli {argv} exited {e.code}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def phase_cli(dev, points, tree, here, round_sweep=False):
    """Phase 6: the DFS engine and the CLI's one-shot path (see the module
    docstring); ``round_sweep`` adds :func:`dfs_round_sweep`. Returns the
    lines to print and the launch counts."""
    import shutil

    import torch

    import kdtree_tpu_torch.kernels.scan_knn as scan_mod
    from kdtree_tpu_torch import native
    from kdtree_tpu_torch.ops import bruteforce
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops.generate import generate_problem, generate_queries
    from kdtree_tpu_torch.ops.morton import DfsStats, build_morton, morton_knn
    from kdtree_tpu_torch.utils.checkpoint import load_tree

    on_card = dev.type == "cuda"
    dev_args = [] if on_card else ["--device", str(dev)]
    lines = []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    scan_mod.scan_tiles.launches = 0
    scan_mod.merge_partials.launches = 0

    # the headline: gen + build + 10 x 1-NN, min of 5 fresh seeds
    def headline(seed, stats=None):
        pts, qs = generate_problem(seed, DIM, N_POINTS, HEADLINE_QUERIES, device=dev)
        t = build_morton(pts, bucket_cap=BUCKET)
        d2, ids = morton_knn(t, qs, k=1, stats=stats)
        d2[:1].cpu()
        return pts, qs, d2, ids

    headline(999)
    times, last, hstats = [], None, None
    for seed in (1, 2, 3, 4, 5):
        st = DfsStats()
        sync()
        t0 = time.perf_counter()
        out = headline(seed, st)
        times.append(time.perf_counter() - t0)
        last, hstats = out, st
    check_answer(last[0], last[1], last[2], last[3], 1, "headline")
    del last
    lines.append(f"headline gen+build+{HEADLINE_QUERIES}x1-NN at {N_POINTS} x {DIM}: "
                 f"min {min(times):.4f} s over seeds 1-5 ({N_POINTS / min(times):.0f} pts/s; "
                 f"runs " + ", ".join(f"{t:.4f}" for t in times) + f"); exact vs oracle; "
                 f"DFS {hstats.steps} steps, {hstats.scans} scan rounds, {hstats.syncs} host "
                 f"syncs, {hstats.graphs} graph(s) in {hstats.chunks} chunk(s)")

    # the sparse-DFS lane on phase 4's tree, then the same queries tiled
    morton_knn(tree, generate_queries(54, DIM, SPARSE_Q, device=dev), k=K)[0][:1].cpu()
    qs = generate_queries(55, DIM, SPARSE_Q, device=dev)
    st = DfsStats()
    sync()
    t0 = time.perf_counter()
    sd, si = morton_knn(tree, qs, k=K, stats=st)
    sd[:1].cpu()
    dfs_s = time.perf_counter() - t0
    ties = check_answer(points, qs[:256], sd[:256], si[:256], K, "sparse DFS")
    tqm.morton_knn_tiled(tree, generate_queries(54, DIM, SPARSE_Q, device=dev), k=K)
    sync()
    t0 = time.perf_counter()
    td, ti = tqm.morton_knn_tiled(tree, qs, k=K)
    td[:1].cpu()
    tiled_s = time.perf_counter() - t0
    # every query: the tiled answer held against the DFS's by the oracle's rule
    tiled_ties = check_answer(points, qs, td, ti, K, "tiled vs DFS", want=(sd, si))
    choice = "tiled" if tqm.dense_lowd(SPARSE_Q, tree.n_real, DIM) else "DFS"
    lines.append(f"sparse DFS Q={SPARSE_Q} k={K} on the {tree.n_real}-point tree: "
                 f"{dfs_s:.4f} s ({SPARSE_Q / dfs_s:.0f} q/s), 256-query sample exact vs "
                 f"oracle ({ties} tied slots); {st.chunks} chunks, {st.steps} steps "
                 f"({st.steps / st.chunks:.1f} per chunk), {st.scans} scan rounds, "
                 f"{st.syncs} host syncs ({st.syncs / st.chunks:.1f} per chunk), "
                 f"{st.graphs} graphs")
    lines.append(f"same queries tiled: {tiled_s:.4f} s ({SPARSE_Q / tiled_s:.0f} q/s), "
                 f"d2 equal to the DFS on all {SPARSE_Q} queries and ids equal but for "
                 f"ties ({tiled_ties} tied slots); dense_lowd picks {choice}; tiled/DFS "
                 f"time {tiled_s / dfs_s:.4f}")

    # the golden grading configurations through the CLI, one process each
    for seed in GOLDEN_SEEDS:
        want = (here / "tests" / "golden" / f"ref_seed{seed}_128d_500k.txt").read_text()
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "kdtree_tpu_torch", *dev_args, "harness"],
                             input=f"{seed}\n", capture_output=True, text=True, timeout=600,
                             cwd=here)
        wall = time.perf_counter() - t0
        assert res.returncode == 0, res.stderr[-2000:]
        assert res.stdout == want, f"golden seed {seed}: stdout differs\n{res.stdout}"
        lines.append(f"golden harness seed {seed} (128-D, 500,000 points, mt19937, auto -> "
                     f"bruteforce): stdout byte-equal, {wall:.2f} s in a new process")

    # the CLI in process: bench, build -> query, query --queries
    bench = json.loads(run_cli([*dev_args, "--engine", "morton", "bench", "--n",
                                str(N_POINTS), "--dim", str(DIM)])[0])
    lines.append(f"cli bench --engine morton --n {N_POINTS} --dim {DIM} (mt19937): "
                 + json.dumps(bench))
    assert bench["pts_per_sec"] > 0 and bench["engine"] == "morton"
    work = here / "kdtree_tpu_torch" / "_build" / "chip_smoke_cli"  # git-ignored
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        ckpt = str(work / "tree.npz")
        t0 = time.perf_counter()
        out, _ = run_cli([*dev_args, "build", "--n", str(CLI_BUILD_N), "--out", ckpt])
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, _ = run_cli([*dev_args, "query", "--tree", ckpt])
        query_s = time.perf_counter() - t0
        cpts, cqs = native.generate_problem_mt19937(42, DIM, CLI_BUILD_N, HEADLINE_QUERIES)
        cpts = torch.from_numpy(cpts).to(dev)
        ctree, _ = load_tree(ckpt, device=dev)
        od, _ = bruteforce.knn(cpts, torch.from_numpy(cqs).to(dev), k=1)
        od = od.cpu().numpy()
        want = "".join(f"ID: {CLI_BUILD_N + q} \t DISTANCE: {float(np.sqrt(od[q, 0])):g}\n"
                       for q in range(HEADLINE_QUERIES)) + "DONE\n"
        assert out == want, f"query protocol lines differ from the oracle\n{out}"
        lines.append(f"cli build --out at {CLI_BUILD_N} x {DIM} (mt19937) {build_s:.3f} s, "
                     f"query {query_s:.3f} s: 10 protocol lines equal to the oracle's")
        qfile = work / "queries.npy"
        dq = generate_queries(77, DIM, CLI_DENSE_Q, device=dev)
        np.save(qfile, dq.cpu().numpy())
        before = scan_mod.scan_tiles.launches
        t0 = time.perf_counter()
        run_cli([*dev_args, "query", "--tree", ckpt, "--queries", str(qfile), "--k", str(K),
                 "--out", str(work / "answer.npz")])
        dense_s = time.perf_counter() - t0
        with np.load(work / "answer.npz") as z:
            ad, ai = z["d2"], z["ids"]
        assert ad.shape == (CLI_DENSE_Q, K)
        ties = check_answer(cpts, dq[:256], torch.from_numpy(ad[:256]),
                            torch.from_numpy(ai[:256]), K, "query --queries")
        raised = scan_mod.scan_tiles.launches - before
        if on_card:
            assert raised > 0, "query --queries did not launch the scan kernel"
        lines.append(f"cli query --queries {CLI_DENSE_Q} dense rows k={K}: {dense_s:.3f} s, "
                     f"256-row sample exact vs oracle ({ties} tied slots), {raised} scan "
                     f"kernel launches")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = (scan_mod.scan_tiles.launches, scan_mod.merge_partials.launches)
    lines.append(f"over phase 6 scan_tiles.launches={launches[0]}, "
                 f"merge_partials.launches={launches[1]}")

    # outside the counted window: the kernels against the plain scan at the
    # two tiled dispatches phase 6 ran, and the launches of one DFS step
    tiled_dispatch(f"sparse lane tiled ({SPARSE_Q} queries, {N_POINTS} points)", tree, qs, 8)
    tiled_dispatch(f"query --queries ({CLI_DENSE_Q} rows, {CLI_BUILD_N} points)", ctree, dq, 1)
    per_step, note = dfs_launches_per_step(tree, qs[:4096], (sd[:4096], si[:4096]))
    lines.append("DFS device launches per step: "
                 + (f"{per_step:.2f} ({note}; torch.profiler)" if per_step is not None
                    else f"not measured (profiler: {note})"))
    if round_sweep:
        lines.append(dfs_round_sweep(tree, qs[:4 * 4096], (sd[:4 * 4096], si[:4 * 4096])))
    return lines, launches


def _http(port, method, path, body=None, headers=None):
    """(status, headers, parsed JSON or text) of one request on a fresh
    connection."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        data = None if body is None else json.dumps(body)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read().decode()
        ctype = resp.getheader("Content-Type", "")
        return resp.status, dict(resp.getheaders()), (
            json.loads(raw) if ctype.startswith("application/json") else raw)
    finally:
        conn.close()


class Oracle:
    """The brute-force answer (k=K) for a fixed pool of query rows over one
    state of the point set: ``ext`` holds every id's current coordinates at
    its id's row (deleted ids at +inf), so oracle ids are point ids."""

    def __init__(self, ext, pool):
        import torch

        from kdtree_tpu_torch.ops import bruteforce

        self.ext = ext
        self.pool = pool
        q = torch.as_tensor(pool, device=ext.device)
        d, i = bruteforce.knn(ext, q, k=K)
        self.d2, self.ids = d.cpu().numpy(), i.cpu().numpy()
        tied = np.zeros(self.d2.shape, dtype=bool)
        tied[:, 1:] |= self.d2[:, 1:] == self.d2[:, :-1]
        tied[:, :-1] |= self.d2[:, :-1] == self.d2[:, 1:]
        self.tied = tied

    def check(self, rows, resp, k, what):
        """An HTTP /v1/knn answer for pool rows ``rows`` at ``k``: the d2
        behind every distance equal to the oracle's (distances are the
        float64 sqrt of f32 d2, so squaring and rounding to f32 recovers
        it exactly), ids equal except between exactly tied distances, and
        every id reproducing its d2. Returns the tied slots."""
        import torch

        from kdtree_tpu_torch.ops._arith import sq_dist

        dist = np.asarray(resp["distances"], dtype=np.float64)
        ids = np.asarray(resp["ids"], dtype=np.int64)
        assert resp["k"] == k and dist.shape == (len(rows), k) == ids.shape, what
        assert np.isfinite(dist).all(), f"{what}: non-finite distances"
        d2 = (dist * dist).astype(np.float32)
        assert np.array_equal(np.sqrt(d2.astype(np.float64)), dist), \
            f"{what}: distances are not sqrt of f32 d2"
        assert np.array_equal(d2, self.d2[rows, :k]), f"{what}: d2 differs from the oracle"
        tied = self.tied[rows, :k]
        assert np.array_equal(ids[~tied], self.ids[rows, :k][~tied]), f"{what}: ids differ"
        q = torch.as_tensor(self.pool[rows], device=self.ext.device)
        again = sq_dist(q[:, None, :], self.ext[torch.as_tensor(ids, device=q.device)])
        assert np.array_equal(again.cpu().numpy(), d2), f"{what}: ids do not reproduce d2"
        return int(tied.sum())


def _ms_line(name, by_rows):
    return f"{name}: " + ", ".join(
        f"{rows} rows median {np.median(t):.2f} max {max(t):.2f} (n={len(t)})"
        for rows, t in sorted(by_rows.items()))


def phase_serve(dev, points, tree, here, smi):
    """Phase 7: the HTTP front over the mutable index (see the module
    docstring). Returns the lines to print and the launch counts of the
    in-process server's run."""
    import signal
    import threading

    import torch

    import kdtree_tpu_torch.kernels.scan_knn as scan_mod
    from kdtree_tpu_torch.obs import flight
    from kdtree_tpu_torch.obs.registry import get_registry
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.serve.engine import build_state
    from kdtree_tpu_torch.serve.server import make_server

    lines = []
    rng = np.random.default_rng(SEED + 7)
    t0 = time.perf_counter()
    state = build_state(tree=tree, k=K, max_batch=MAX_BATCH, max_delta_rows=SERVE_DELTA_ROWS)
    # deep enough that 8 clients' concurrent 1000-row requests are admitted,
    # not shed: the phase checks answers, the 429 path has its CPU tests
    srv = make_server(state, port=0, queue_rows=16 * MAX_BATCH)
    srv.start()
    port = srv.server_address[1]
    lines.append(f"in-process server on port {port}: build_state + warmup ladder "
                 f"{state.warmup_buckets()} in {time.perf_counter() - t0:.3f} s")
    stopped = False
    try:
        from kdtree_tpu_torch.serve.engine import batch_bucket

        pool = generate_queries(SEED + 700, DIM, 1100, device=dev).cpu().numpy()
        o1 = Oracle(points, pool)
        # the padded batches of the one-at-a-time requests below, through
        # the engine on this thread: before the counts are zeroed, so the
        # phase's launch counts are the HTTP server's own
        seq = {rows: {"http": [], "server": [], "dispatch": [], "engine": []}
               for rows in (1, 7, 64, 1000)}
        for rows in seq:
            b = batch_bucket(rows, MAX_BATCH)
            for j in range(5):
                off = min(40 * j, len(pool) - rows)
                q = pool[off:off + rows]
                q = np.concatenate([q, np.broadcast_to(q[-1], (b - rows, DIM))])
                t = time.perf_counter()
                state.engine.knn_batch(q)
                seq[rows]["engine"].append((time.perf_counter() - t) * 1e3)

        scan_mod.scan_tiles.launches = 0
        scan_mod.merge_partials.launches = 0

        # 1. concurrent traffic, every answer against the oracle
        plan = []  # (thread, rows, k)
        for i in range(SERVE_CLIENTS):
            for rows in (1, 7, 64) + ((1000,) if i < 2 else ()):
                plan.append((i, rows, K if (i + rows) % 3 else 3 + i))
        results, errors = [], []

        def client(i):
            try:
                for j, (ti, rows, k) in enumerate(p for p in plan if p[0] == i):
                    off = (i * 131 + j * 17) % (len(pool) - rows)
                    body = {"queries": pool[off:off + rows].tolist(), "k": k}
                    t = time.perf_counter()
                    st, _, resp = _http(port, "POST", "/v1/knn", body)
                    results.append((rows, k, off, st, resp, (time.perf_counter() - t) * 1e3))
            except Exception as e:  # re-raised below, on the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        ties = 0
        concurrent = {}
        for rows, k, off, st, resp, ms in results:
            assert st == 200 and resp["degraded"] is None, (rows, st, resp.get("error"))
            ties += o1.check(np.arange(off, off + rows), resp, k, f"{rows}-row request k={k}")
            concurrent.setdefault(rows, []).append(ms)
        lines.append(f"{len(results)} requests from {SERVE_CLIENTS} client threads at once: "
                     f"every answer exact vs oracle ({ties} tied slots)")
        lines.append(_ms_line("concurrent HTTP request ms", concurrent))

        # the oversized request (brute force in its handler thread), and one
        # 1-row request sent while it runs: both use the card's one stream
        big = {}

        def oversized():
            t = time.perf_counter()
            big["resp"] = _http(port, "POST", "/v1/knn",
                                {"queries": pool[:MAX_BATCH + 1].tolist()},
                                headers={"X-Request-Id": "oversized"})
            big["ms"] = (time.perf_counter() - t) * 1e3

        ot = threading.Thread(target=oversized)
        ot.start()
        while not any(e["type"] == "serve.oversized" and e.get("trace") == "oversized"
                      for e in flight.recorder().snapshot()):
            time.sleep(0.01)
        time.sleep(0.5)
        t = time.perf_counter()
        st, _, resp = _http(port, "POST", "/v1/knn", {"queries": pool[:1].tolist()})
        behind_ms = (time.perf_counter() - t) * 1e3
        assert st == 200
        o1.check(np.arange(1), resp, K, "1-row request behind the oversized one")
        ot.join()
        st, _, resp = big["resp"]
        assert st == 200 and resp["degraded"] == "oversized", (st, resp.get("error"))
        ties = o1.check(np.arange(MAX_BATCH + 1), resp, K, "oversized request")
        lines.append(f"one {MAX_BATCH + 1}-row oversized request: {big['ms']:.2f} ms (brute "
                     f"force in its handler thread), exact vs oracle ({ties} tied slots); a "
                     f"1-row request sent 0.5 s into it: {behind_ms:.2f} ms")

        # one request at a time: the client's HTTP ms, the server's own
        # total (admission to answer, flight ring) and device-dispatch ms,
        # beside the same padded batch through the engine (timed above)
        for rows in seq:
            for j in range(5):
                off = min(40 * j, len(pool) - rows)
                t = time.perf_counter()
                st, _, resp = _http(port, "POST", "/v1/knn",
                                    {"queries": pool[off:off + rows].tolist()},
                                    headers={"X-Request-Id": f"seq-{rows}-{j}"})
                seq[rows]["http"].append((time.perf_counter() - t) * 1e3)
                assert st == 200
                o1.check(np.arange(off, off + rows), resp, K, f"sequential {rows} rows")
        for e in flight.recorder().snapshot():
            if e["type"] == "serve.request" and str(e.get("trace", "")).startswith("seq-"):
                rows = int(e["trace"].split("-")[1])
                seq[rows]["server"].append(e["total_ms"])
                seq[rows]["dispatch"].append(e["device_ms"])
        # the HTTP requests alone, before any write or epoch rebuild
        http_launches = (scan_mod.scan_tiles.launches, scan_mod.merge_partials.launches)
        if dev.type == "cuda":
            assert http_launches[0] > 0, "the HTTP requests never launched the scan kernel"
        lines.append("one request at a time (exact), median (max) ms of HTTP round trip / "
                     "server admission-to-answer / its batch dispatch / the same batch "
                     "through the engine on the main thread (outside the counted window): " + "; ".join(
                         f"{rows} rows " + " / ".join(
                             f"{np.median(v[key]):.2f} ({max(v[key]):.2f})"
                             for key in ("http", "server", "dispatch", "engine"))
                         for rows, v in sorted(seq.items())))

        # 2. writes: 64 new ids beside query points, 32 moved, 32 deleted
        # (among them the 1st and the 16th hit of some queries)
        n = points.shape[0]
        ext = torch.cat([points, torch.full((SERVE_NEW, DIM), float("inf"), device=dev)])
        near = pool[:64] + np.float32(0.01)
        moved_to = pool[64:96] + np.float32(0.02)
        new_ids = np.arange(n, n + 64)
        moved = o1.ids[200:232, 1].astype(np.int64)  # 2nd hits of other queries
        deleted = list(dict.fromkeys([int(x) for x in o1.ids[300:316, 0]]
                                     + [int(x) for x in o1.ids[316:332, K - 1]]))
        deleted = [x for x in deleted if x not in set(moved.tolist())][:32]
        assert len(deleted) == 32 and len(set(moved.tolist())) == 32
        write_ms = {}
        for op, body in (("upsert", {"ids": new_ids.tolist(), "points": near.tolist()}),
                         ("upsert", {"ids": moved.tolist(), "points": moved_to.tolist()}),
                         ("delete", {"ids": deleted})):
            t = time.perf_counter()
            st, _, resp = _http(port, "POST", f"/v1/{op}", body)
            write_ms.setdefault(op, []).append((time.perf_counter() - t) * 1e3)
            assert st == 200 and resp["applied"] == len(body["ids"]), (op, st, resp)
        ext[torch.as_tensor(new_ids, device=dev)] = torch.as_tensor(near, device=dev)
        ext[torch.as_tensor(moved, device=dev)] = torch.as_tensor(moved_to, device=dev)
        ext[torch.as_tensor(deleted, device=dev)] = float("inf")
        assert resp["tombstones"] == 64 and resp["delta_rows"] == 96, resp
        pool2 = np.concatenate([pool[:96], pool[300:332], pool[500:700]])
        o2 = Oracle(ext, pool2)
        st, _, resp = _http(port, "POST", "/v1/knn", {"queries": pool2[:64].tolist()})
        assert st == 200 and resp["ids"] and all(r[0] == n + j for j, r in enumerate(resp["ids"])), \
            "an upserted point is not its query's nearest neighbour"
        ties = 0
        for off in range(0, len(pool2), 64):
            rows = np.arange(off, min(off + 64, len(pool2)))
            for k in (K, 1):
                st, _, resp = _http(port, "POST", "/v1/knn",
                                    {"queries": pool2[rows].tolist(), "k": k})
                assert st == 200
                ties += o2.check(rows, resp, k, f"after writes, rows {off}+ k={k}")
        hist = srv.write_latency
        lines.append("writes over HTTP (64 new ids, 32 moved, 32 deleted incl. 1st and 16th "
                     "hits): client ms " + ", ".join(f"{op} {', '.join(f'{x:.2f}' for x in v)}"
                                                     for op, v in write_ms.items())
                     + "; server apply ms (mean) " + ", ".join(
                         f"{op} {hist[op].sum / max(hist[op].count, 1):.3f}" for op in hist)
                     + f"; {len(pool2)} queries after the writes exact vs oracle over the "
                     f"surviving points ({ties} tied slots)")

        # 3. cross the backlog: an epoch rebuild while queries continue
        extra_ids = np.arange(n + 64, n + SERVE_NEW)
        extra_pts = rng.uniform(-100, 100, (len(extra_ids), DIM)).astype(np.float32)
        ext[torch.as_tensor(extra_ids, device=dev)] = torch.as_tensor(extra_pts, device=dev)
        o3 = Oracle(ext, pool2)
        stop_q = threading.Event()
        during, errors = [], []

        def reader(i):
            j = 0
            try:
                while not stop_q.is_set():
                    off = (i * 29 + j * 8) % (len(pool2) - 8)
                    t = time.perf_counter()
                    st, _, resp = _http(port, "POST", "/v1/knn",
                                        {"queries": pool2[off:off + 8].tolist()})
                    during.append((off, st, resp, (time.perf_counter() - t) * 1e3,
                                   t - t_w))
                    j += 1
            except Exception as e:
                errors.append(e)

        t_w = time.perf_counter()
        st, _, resp = _http(port, "POST", "/v1/upsert",
                            {"ids": extra_ids.tolist(), "points": extra_pts.tolist()})
        assert st == 200 and resp["backlog"] >= SERVE_DELTA_ROWS, resp
        backlog = resp["backlog"]
        # the readers start after the write, so every answer they get is
        # held against the same final point set, before and after the swap
        readers = [threading.Thread(target=reader, args=(i,)) for i in range(4)]
        for t in readers:
            t.start()
        epoch = 0
        while epoch != 1:
            assert time.perf_counter() - t_w < 300, "the epoch rebuild did not land in 300 s"
            time.sleep(0.05)
            st, _, h = _http(port, "GET", "/healthz")
            assert st == 200, st
            epoch = h["epoch"]
        swap_s = time.perf_counter() - t_w
        time.sleep(0.5)  # queries keep running on the new epoch
        stop_q.set()
        for t in readers:
            t.join()
        assert not errors, errors
        ties = 0
        before_swap = sum(1 for d in during if d[4] < swap_s)
        for off, st, resp, _, _ in during:
            assert st == 200, (st, resp)
            ties += o3.check(np.arange(off, off + 8), resp, K, "query across the epoch swap")
        for off in range(0, len(pool2), 64):
            rows = np.arange(off, min(off + 64, len(pool2)))
            st, _, resp = _http(port, "POST", "/v1/knn", {"queries": pool2[rows].tolist()})
            assert st == 200
            ties += o3.check(rows, resp, K, "after the swap")
        ev = flight.recorder().snapshot()
        t_start = [e["ts"] for e in ev if e["type"] == "mutable.rebuild_start"]
        t_swap = [e["ts"] for e in ev if e["type"] == "mutable.epoch_swap"]
        span = [e["seconds"] for e in ev if e["type"] == "span"
                and e.get("span") == "mutable.rebuild"]
        lines.append(f"epoch rebuild at backlog {backlog}: /healthz epoch 1 "
                     f"after {swap_s:.3f} s; rebuild_start -> epoch_swap "
                     f"{(t_swap[-1] - t_start[-1]) if t_swap and t_start else float('nan'):.3f} s "
                     f"(flight ring), rebuild span {span[-1] if span else float('nan'):.3f} s; "
                     f"{len(during)} queries during and after it ({before_swap} sent before "
                     f"/healthz showed the swap), all 200 and exact "
                     f"({ties} tied slots); their HTTP ms median "
                     f"{np.median([d[3] for d in during]):.2f} max "
                     f"{max(d[3] for d in during):.2f}")

        # 4. the scrape
        st, _, text = _http(port, "GET", "/metrics")
        assert st == 200
        for want in ("kdtree_serve_batches_total", "\nkdtree_epoch 1\n",
                     "kdtree_mutable_writes_total"):
            assert want in text, f"/metrics lacks {want.strip()!r}"
        lines.append("/metrics shows kdtree_serve_batches_total, kdtree_epoch 1, "
                     "kdtree_mutable_writes_total")

        # 5. stop with requests admitted: each must still be answered
        done = []

        def late(i):
            st, _, resp = _http(port, "POST", "/v1/knn",
                                {"queries": pool2[i * 8:i * 8 + 300].tolist()},
                                headers={"X-Request-Id": f"drain-{i}"})
            done.append((i, st, resp))

        drainers = [threading.Thread(target=late, args=(i,)) for i in range(4)]
        for t in drainers:
            t.start()
        t = time.perf_counter()
        while True:
            admitted = {e.get("trace") for e in flight.recorder().snapshot()
                        if e["type"] == "serve.admit"}
            if all(f"drain-{i}" in admitted for i in range(4)):
                break
            assert time.perf_counter() - t < 60, "drain requests were never admitted"
            time.sleep(0.002)
        srv.stop()
        stopped = True
        for t in drainers:
            t.join()
        assert sorted(st for _, st, _ in done) == [200] * 4, [d[:2] for d in done]
        for i, _, resp in done:
            o3.check(np.arange(i * 8, i * 8 + 300), resp, K, "drained request")
        launches = (scan_mod.scan_tiles.launches, scan_mod.merge_partials.launches)
        lines.append(f"stop(): 4 admitted 300-row requests drained, all 200 and exact; "
                     f"launches by the server from the zeroed counts to stop(): "
                     f"scan_tiles.launches={launches[0]}, "
                     f"merge_partials.launches={launches[1]}, of which the "
                     f"{len(results) + 2 + 5 * len(seq)} requests before any write: "
                     f"{http_launches[0]} and {http_launches[1]} (the rest: the "
                     f"requests after the writes, the epoch rebuild's prewarm "
                     f"ladder and the drain)")
        reg = get_registry()
        swaps = reg.counter("kdtree_mutable_rebuilds_total").value
        assert swaps == 1, swaps
    finally:
        if not stopped:
            srv.stop()

    # 6. the CLI entry point in a subprocess
    n_cli = SERVE_CLI_N
    dev_args = [] if dev.type == "cuda" else ["--device", str(dev)]
    cmd = [sys.executable, "-m", "kdtree_tpu_torch", *dev_args, "serve", "--seed", str(SEED), "--dim",
           str(DIM), "--n", str(n_cli), "--k", str(K), "--max-batch", "64", "--port", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
                            text=True)
    try:
        err = []
        port = None
        while port is None:
            line = proc.stderr.readline()
            if not line:
                raise AssertionError(f"serve exited {proc.wait()} before ready: {''.join(err)}")
            err.append(line)
            if line.startswith("ready:"):
                port = int(line.rsplit(" ", 1)[1])
        ready_s = time.perf_counter() - t0
        cpts = generate_points_rowwise(SEED, DIM, n_cli, device=dev)
        cq = generate_queries(SEED + 800, DIM, 5, device=dev).cpu().numpy()
        st, _, resp = _http(port, "POST", "/v1/knn", {"queries": cq.tolist(), "k": 4})
        assert st == 200, (st, resp)
        Oracle(cpts, cq).check(np.arange(5), resp, 4, "cli serve answer")
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=120)[1]
        err.append(rest)
        assert proc.returncode == 0 and "drained; bye" in rest, (proc.returncode, "".join(err))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines.append(f"python -m kdtree_tpu_torch serve --n {n_cli} --max-batch 64: ready in "
                 f"{ready_s:.2f} s, one 5-row k=4 answer exact vs oracle, SIGTERM -> exit 0 "
                 f"with 'drained; bye'")
    lines = [f"{line} [{smi}]" if "ms" in line or " s" in line else line for line in lines]
    return lines, launches


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "CUDA card only", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if not (here / "kdtree_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: kdtree_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    say("device", f"{kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    from kdtree_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    say("build", f"{len(_build.sources())} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")

    # 3. kernel vs plain
    import kdtree_tpu_torch.kernels.scan_knn as scan_mod

    max_err = phase_kernel(dev)

    # 4. main path
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.ops.morton import build_morton
    from kdtree_tpu_torch.serve.engine import ServeEngine, batch_bucket, warmup_buckets

    t0 = time.perf_counter()
    points = generate_points_rowwise(SEED, DIM, N_POINTS, device=dev)
    torch.cuda.synchronize()
    say("main", f"generated {N_POINTS} x {DIM} points in {time.perf_counter() - t0:.3f} s")

    scan_mod.scan_tiles.launches = 0
    scan_mod.merge_partials.launches = 0
    t0 = time.perf_counter()
    tree = build_morton(points, bucket_cap=BUCKET)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    say("main", f"build {build_s:.3f} s ({N_POINTS / build_s:.0f} pts/s), {tree}")

    engine = ServeEngine(tree, K)
    buckets = warmup_buckets(MAX_BATCH)
    t0 = time.perf_counter()
    engine.warmup(buckets)
    torch.cuda.synchronize()
    say("main", f"warmup ladder {buckets} in {time.perf_counter() - t0:.3f} s")

    served = []
    for i, rows in enumerate(REQUEST_ROWS):
        q = generate_queries(SEED + 1 + i, DIM, rows, device=dev).cpu().numpy()
        bucket = batch_bucket(rows, MAX_BATCH)
        qp = np.concatenate([q, np.broadcast_to(q[-1], (bucket - rows, DIM))])
        t0 = time.perf_counter()
        d2, ids, source = engine.knn_batch(qp)
        ms = (time.perf_counter() - t0) * 1e3
        served.append((q, d2[:rows], ids[:rows], rows, bucket, ms, source))
    fq = generate_queries(SEED + 99, DIM, 1000, device=dev).cpu().numpy()
    t0 = time.perf_counter()
    fd2, fids = engine.fallback_knn(fq, K)
    fallback_ms = (time.perf_counter() - t0) * 1e3

    tq_all = generate_queries(SEED, DIM, TILED_QUERIES, device=dev)
    stats = tqm.TileStats()
    before = scan_mod.scan_tiles.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    td2, tids = tqm.morton_knn_tiled(tree, tq_all, k=K, stats=stats)
    torch.cuda.synchronize()
    tiled_s = time.perf_counter() - t0
    launches = scan_mod.scan_tiles.launches
    merges = scan_mod.merge_partials.launches
    say("main", f"tiled {TILED_QUERIES} queries k={K}: {tiled_s:.3f} s "
                f"({TILED_QUERIES / tiled_s:.0f} q/s), {stats.batches} batches, "
                f"{stats.retries} overflow retries, {launches - before} scan kernel "
                f"launches; over the main path scan_tiles.launches={launches}, "
                f"merge_partials.launches={merges}")
    assert launches > 0, "the main path never launched the scan kernel"
    assert merges > 0, "the main path never launched the merge kernel"

    # checks against the brute-force oracle (outside the counted window)
    for q, d2, ids, rows, bucket, ms, source in served:
        ties = check_answer(points, q, d2, ids, K, f"request of {rows} rows")
        say("main", f"request {rows} rows (bucket {bucket}, plan {source}): "
                    f"{ms:.2f} ms, exact vs oracle ({ties} tied slots)")
    ties = check_answer(points, fq, fd2, fids, K, "fallback batch")
    say("main", f"fallback 1000 rows: {fallback_ms:.2f} ms, exact vs oracle ({ties} tied slots)")
    sample = torch.as_tensor(np.random.default_rng(SEED).choice(TILED_QUERIES, SAMPLE, replace=False),
                             device=dev)
    ties = check_answer(points, tq_all[sample], td2[sample], tids[sample], K, "tiled sample")
    assert td2.shape == (TILED_QUERIES, K) and torch.isfinite(td2).all()
    say("main", f"tiled run: {SAMPLE}-query sample exact vs oracle ({ties} tied slots)")
    for line in serve_profile(engine, served):
        say("main", line)

    # 5. the kernels at the main path's shapes
    plan = tqm.plan_tiled(TILED_QUERIES, DIM, tree.n_real, tree.num_buckets,
                          tree.bucket_size, K, device=dev)
    sq, _ = tqm._sort_queries(tq_all, plan.bits, (-TILED_QUERIES) % plan.qbatch)
    recs = phase_shapes(tree, sq, plan)
    say("main", f"one tiled batch (plan tile={plan.tile} cmax={plan.cmax} "
                f"seeds={plan.seeds} qbatch={plan.qbatch}), ms by stage: "
                + ", ".join(f"{n} {t:.3f}" for n, t in recs["stages"].items()))
    main_rec, sparse = recs["main"], recs[7]

    # 6. the DFS engine and the CLI
    cli_lines, _ = phase_cli(dev, points, tree, here, "--dfs-round-sweep" in argv)
    for line in cli_lines:
        say("cli", line)

    # 7. the HTTP front over the mutable index, in process and as the CLI
    serve_lines, _ = phase_serve(dev, points, tree, here, smi)
    for line in serve_lines:
        say("serve", line)

    record = {"kernels": [{
        "name": "scan_knn",
        "route": "cuda",
        "source": "kdtree_tpu_torch/csrc/scan_knn.cu",
        "replaces": "kdtree_tpu/pallas/scan_knn.py:46",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
    }, {
        "name": "scan_knn_merge",
        "route": "cuda",
        "source": "kdtree_tpu_torch/csrc/scan_knn.cu",
        "replaces": "kdtree_tpu/pallas/scan_knn.py:46",
        "launches": merges,
        "max_abs_err": MERGE_ERR[0],
        "ms": sparse["merge_ms"],
        "plain_ms": sparse["merge_plain_ms"],
        "bound_ms": sparse["merge_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
