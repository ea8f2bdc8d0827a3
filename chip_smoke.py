#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py [--dfs-round-sweep]
    python3 chip_smoke.py --profile-stress N
    python3 chip_smoke.py --forest-only
    python3 chip_smoke.py --fleet-only

``--dfs-round-sweep`` adds to phase 6 the DFS timed at 4, 8, 16 and 32
steps per host look on 16,384 of the sparse lane's queries: the run that
chose ``_ROUND_STEPS`` in ``kdtree_tpu_torch/ops/morton.py``, for when the
DFS changes.

``--profile-stress N`` runs only this: a server on the 2^24 tree under 4
clients at 1-1,000 rows, and N 2 s capture windows over it, in four
processes one after another: windows opened by a thread of their own,
then by the batch worker (``MicroBatcher.capture_for``, what ``POST
/debug/profile`` does), twice each. A process that dies is counted, not fatal, where the windows were
opened off the worker; the mode fails if a batch-worker window crashes.
It is the run that chose to open server windows on the batch worker.

``--forest-only`` runs phases 1-3c and 12 alone
(no kernels record), for work on the multi-device engines;
``--fleet-only`` runs phases 1-3c and 13 alone,
for work on the fleet.

Phases, one line each (any failure raises and exits non-zero):

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds every kernel source of the port, in parallel;
3. kernel  — the CUDA scan kernel, and the merge kernel that joins a tile's
             walk when it is split over several blocks, against their plain
             PyTorch versions on the card, bit for bit (d2 and ids): D, k,
             k > n_real, ragged tiles, -1 candidate padding, a clustered
             cloud, a tie-heavy lattice, two row chunks per bucket, 4-byte
             copies (B % 4 != 0), k > 32, D > 8, D = 40 (window sums) and
             D = 1,100 (two levels of windows), each at 1 block per tile,
             the planned count, and forced to 2 and 7; then the merge alone
             on seeded partial buffers: S = 1,024 at TQ = 8, k = 64 at
             S = 256, a tie lattice whose survivors overflow the kernel's
             shared capacity (the survivor count printed), slabs (a lattice
             at k = 1,100, above the capacity) and rows with no full chunk,
             each also held against the step-for-step mirror
             ``merge_select``;
3b. pair   — ``pair_d2`` (the oracle's distance block, a kernel for an XLA
             program of the reference; the verb oracle's blocks and the
             D-sharded partial sums run it) against its plain PyTorch
             version on the card, bit-equal to ``sq_dist`` at D = 1, 2, 3,
             8, 32 and 47, each at 37 x 300 and 5 x 100 rows and at the
             fallback batch's shapes before the fused k-NN took it (1,000
             rows, 256 at D = 47, against ``bruteforce.knn``'s point tile,
             the last 128-point block partial), and at its callers' shapes:
             phase 8's oversized radius oracle (1,025 rows x its block at
             D = 3) and phase 12's dsharded shard (1,024 x 65,536 at D =
             32); each timed through the wrapper, a launch in a CUDA graph,
             the plain version and the library's two ways (``_matmul_d2``,
             ``torch.cdist`` squared) beside its bound;
3c. knn    — ``knn_scan`` (the exact k-NN oracle as one fused kernel, for
             the reference's XLA program ``_knn_scan``; the fallback batch,
             the mutable index's overlay and every oracle check below run
             it) bit-equal to its plain version ``knn_scan_plain`` (d2 and
             ids) at D = 1, 3, 8, 32, 33 and 47, k = 1, 16 and 100 (above
             the 64 a shared-memory list holds), Q = 1, 7 and 1,000, at the
             planned chunks; on tie lattices, +inf rows (fewer finite than
             k, and none finite), k = N, N below a chunk's minimum; on
             Morton-ordered rows with a +inf pad every 256 at Q = 1, 8, 64
             and 1,000 x k = 1, 16 and 100, and from rows 1-3 of them (bases
             not 16-byte aligned); and at the fallback shape (1,000 x 2^24 x
             3-D, k = 16) in random and in Morton order. Then timed at 8,
             64, 1,000 and 1,024 rows over 2^24 x 3-D in both orders,
             through the wrapper and in a CUDA graph, each with the share of
             (warp, stage) pairs the kernel's cull skipped and its bound
             three ways (operations, issue slots, what the inputs need);
4. main    — 2^24 x 3-D points (seed 42) -> Morton build (B=256) ->
             ServeEngine(k=16) with its warmup ladder 8..1024 -> served
             requests of 1, 7, 64, 1000 and 1024 rows and one brute-force
             fallback batch, each checked against the brute-force oracle ->
             one morton_knn_tiled run of 2^20 queries, checked on a sample;
             the fallback batch's kernel then timed alone on the tree's
             flat storage (its cull share and bounds, as in phase 3c).
             Both kernels' launch counts, knn_scan's, pair_d2's and the
             frontier's are zeroed just before this phase; all but
             pair_d2's must be > 0 after it (knn_scan: the fallback batch)
             and pair_d2's 0 (the k-NN oracle no longer writes the block). Then the served 7-, 64- and
             1000-row requests once more, each in a capture window of the
             package's profiler: device time by kernel (the scan, merge and
             frontier kernels) and the card's idle share, from
             kdtree_tpu_torch.obs.timeline (as every device-time sum below);
4b. fold   — the verbs' fold kernels (kernels for the reference's XLA
             programs) against their plain PyTorch versions. First the
             adversarial check: integer-grid trees of 2^16 - 700 points at
             D = 3, 8 and 47 (duplicates, -0.0, points on the leaf faces,
             two empty leaves), radius rows whose r2 is the exact d2 of a
             point, range boxes with faces on points, infinite, inverted
             and padding rows, every bucket a candidate; at m above the
             largest count, m = 0 and m below it. Then on phase 4's
             tree: the last fold pass of ``radius_search`` (r = 1.5) and
             ``range_search`` (cubes of side 3) at 1 and 1,000 of
             phase 8's query rows, counts bit-equal and the canonical rows
             bit-equal in the ids form, counts in the count form, and at
             1,000 rows once with m below the largest count, that plain
             fold's device time split into gather, d2, test and sort (a
             capture window); each timed (the wrapper, a launch in a CUDA
             graph, the plain fold) beside its bound (what the inputs
             need: the box tests, then the point tests of the pairs
             ``leaf_pass_plain`` passes), the all-pairs bound (every
             point of every candidate) and ``kept_frac``. Phase 9a makes the
             same checks at 1 and 64 rows (a graph at 64, no split) on its
             D = 47 tree, with phase 9's queries shrunk toward the centre
             (r = 290, side 162);
4c. frontier — the frontier kernel (a kernel for the reference's XLA
             program ``_frontier``) against ``_frontier`` run on the card,
             bucket ids, lower bounds and overflow flags bit for bit. First
             the adversarial check on phase 4b's integer-grid tree at D = 3
             (lower bounds tied at every level): radius tiles, range union
             boxes, a box infinite on axis 0, one infinite on every axis
             (NaN gaps against the empty leaves), an all-padding tile and a
             point box, at caps 1, 3, 6, 64 and 256, bound +inf, 0 and the
             rows' r2, the shared keys a CTA at the default, 2 and 64 (the
             device-memory path), then each case again at every cluster
             size (1, 2, 4, 8, 16 CTAs a tile) in shared and in device
             memory. Then on phase 4's tree the main tiled
             batch's seed (cap 8) and collect (the plan's cmax) descents,
             every descent of the 7-, 64- and 1000-row served batches, every
             pass of ``radius_search`` and ``range_search`` at 1, 64 and
             1,000 of phase 8's rows (the retry ladder from cap 64), and
             the 1,000-row radius at the cap ceiling (pow2ceil of the
             buckets); the last of each timed (the wrapper, a launch in a
             CUDA graph, the plain version, the memory the call allocates
             at its peak) beside its bound (one lower bound per node the
             descent evaluates, 6 D flops, against each distinct node box,
             the tiles' boxes and bounds and the outputs; no selection
             counted), with the cluster size the plan chose; and every one
             of these descents also checked and timed at every cluster size
             (the sweep that chose ``kernels/frontier.py::_spread``). Phase
             9a makes the same checks on its D = 47 tree, phase 12 at a
             P = 4 shard;
5. shapes  — on the 2^24 tree, the kernels against the plain version and
             timed (CUDA events) at the tiled run's collect shape and at the
             final collect dispatch of the 8-, 64- and 1024-row serve
             batches, each beside the bound its inputs define (per
             query, and the coarser tile-level count); at the serve
             shapes also swept over blocks per tile, each count checked
             bit for bit; one tiled batch by stage (the frontier kernel,
             the plain frontier beside it) and in a capture window (its
             device launches, the frontier kernel's two);
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
             polled until epoch 1 (knn_scan's launches are zeroed before
             the requests after the writes, whose rows the delta overlay
             answers, and must be > 0 after them). Every answer, before
             and after the writes and across the swap, is held against
             the brute-force
             oracle over the surviving points. /metrics must show the
             serving, epoch and write families; stop() must answer 4
             admitted requests. Then ``python -m kdtree_tpu_torch serve``
             at 2^20 points as a subprocess: its ready line, one answer
             against the oracle, SIGTERM -> exit 0 and "drained; bye".
             Prints HTTP ms by row count (concurrent, and one request at
             a time), the writes' ms and the rebuild's s.
8. snapshot — on phase 4's tree: save_snapshot (timed, bytes) and
             load_snapshot (timed; the sha256 pass and the
             host-to-device copies apart), arrays torch.equal to the built
             ones, 1/7/64/1000-row requests the same from both; load s beside
             phase 4's build s. Blue/green: an in-process primary over the
             loaded tree with a snapshot sink (bootstrap emit v1, epoch
             rebuild at a backlog of 64) and a read-only secondary loaded
             from its directory with a follower (poll 0.2 s); a write to the
             secondary gets 403; 64 writes to the primary -> epoch 1 -> the
             sink writes v2 -> the secondary adopts it (its /healthz shows
             version 2), while 4 readers query the secondary, each answer
             held against the oracle over the epoch that answered it (the
             batch's flight event). The verbs over HTTP on the secondary:
             /v1/radius (r=1.5), /v1/range (cubes of side 3), /v1/count in
             both forms at 1, 64 and 1000 rows, and one 1025-row radius
             request (the oracle in its handler thread), every answer equal
             to verbs/oracle.py on the card; HTTP ms and engine ms by verb and
             rows, overflow retries, and the frontier/fold split of a
             1000-row radius batch under torch.profiler. The fold kernels',
             pair_d2's and the frontier's launch counts are zeroed just
             before these verb requests and read just after them; each must
             be > 0. Scan-kernel
             launches are counted from the end of the secondary's warmup to
             its stop and over its k-NN requests alone; both must be > 0.
             Then ``build --save`` at 2^20 points in process and ``python -m
             kdtree_tpu_torch serve --snapshot`` as a subprocess: its ready
             line, one /v1/knn and one /v1/radius answer against the oracle,
             SIGTERM -> exit 0.
9. recall  — (a) distances above 32 axes: 2^19-point trees at D = 47 and
             D = 64, morton_knn_tiled at k=16 over 4,096 queries, the scan
             kernel against the plain scan bit for bit at its final collect
             dispatch and a query sample against the exact brute-force
             oracle (the largest difference joins the scan kernel's
             max_abs_err), and at D = 47 phase 4b's fold checks; (b) the
             recall harness on phase 4's tree:
             sweep_recall over 65,536 queries at k=16 and every cap of
             default_caps, recall monotone, the full cap byte-identical to
             the exact run, the kernel against the plain scan at one
             truncated cap, the curve printed and the calibration persisted
             into this run's plan store; (c) a server over that tree and
             store with the ladder armed and the recall sampler at 1.0:
             /v1/knn at recall_target 0.9 and 0.99 and 1, 64 and 1,000 rows
             (gear echoed, every returned (id, d2) true, recall against the
             oracle printed), radius and count under a target (counts at
             most the exact ones, ``truncated`` set wherever one is short),
             the ladder ticked down to approx-0.99 and brute-deadline and
             back up (answers flagged degraded), kdtree_recall_sampled set,
             and the scan-kernel launches over the approximate requests
             (> 0); (d) ``tune`` on a 2^16-query sample with small grids,
             its winner, and the next plan_tiled "warm" with exact answers.
10. classic — the classic median-split trees on phase 4's points:
             build_jit and build_bucket (B=128, sort) at 2^24 x 3-D, timed
             (first call with the host TreeSpec, then warm), and
             validate_invariants; at 2^20 (cut so the CPU builds stay
             short) build_presort and the bucket presort bit-identical to
             their sort builds and the card's builds bit-identical to the
             CPU's; nearest_neighbor on the headline's 10 queries, knn
             k=16 on 4,096 of the sparse lane's queries and bucket_knn
             k=16 on all 65,536, each with its wall s, DFS steps and
             device launches per step, and a sample exact against the
             brute-force oracle in the engine's arithmetic (a tree node's
             squares rounded in XLA:CPU's vector lanes); then, with both
             kernels' launch counts zeroed just before and read just
             after, ``build --engine tree|bucket --out`` at 2^20 and
             ``query --queries`` with 2^16 dense rows through the tree's
             Morton view (scan kernel launches > 0; afterwards the kernel
             against the plain scan at each run's final collect dispatch,
             timed beside its bound), ``serve --index`` on the classic
             checkpoint answering /v1/knn at 1 and 64 rows against the
             oracle, ``harness --engine bucket`` on both golden
             configurations (stdout byte-equal to tests/golden/), and
             ``harness --engine tree`` at 2^20 x 3-D byte-equal to the
             bruteforce engine's stdout.
11. obs     — device observability through the package's own telemetry:
             ``python -m kdtree_tpu_torch profile`` at 2^24 x 3-D, 2^20
             queries, k=16 (its answers under the window bit-equal to the
             warm run's outside it; the timeline's busy µs within 0.1% of
             this script's own union of the raw trace's kernel/memcpy/memset
             slices; its kernel table naming scan_knn_kernel with the scan
             launches of the captured run); the tiled run's wall time with
             and without a window (plain, captured, captured, plain); a
             server on phase 4's tree with 4 clients at 1-1,000 rows during
             POST /debug/profile?seconds=2 (200 with the batch worker's
             tile.dispatch ranges and busy_frac > 0; a concurrent POST 409;
             kdtree_device_busy_frac on /metrics; /debug/costs requests =
             the answered count; /healthz headroom with data; ``trace --id``
             and ``costs`` against it; every answer against the oracle);
             served latency (median, p99, max) under the same 4 clients
             with the duty cycle off, on (KDTREE_TPU_PROFILE_DUTY=1 at
             KDTREE_TPU_PROFILE_DUTY_PERIOD_S=5: at least one window, the
             gauge set, each window's profiler start, stop and export
             seconds) and off; ``--metrics-out`` on ``bench`` (one with
             ``--trace``), then ``stats`` and ``stats --diff``.

12. forest — the multi-device engines (``kdtree_tpu_torch.parallel``) on a
             single-controller mesh, with both kernels' launch counts and
             the frontier's zeroed just before and read just after (scan
             and frontier launches > 0): (a) bench.py's scale
             lane, build_global_morton at 2^26 x 3-D on a one-shard mesh
             (slack 1.05; generation and build, warm, best of 2, pts/s) and
             10 queries at k=1 by the per-shard DFS, d2 bit-equal to
             morton_knn over the same rows and ids to the oracle; (b) its
             SPMD tiled lane, 2^22 points, 2^16 queries at k=16 (q/s), 512
             queries against the oracle; (c) four shards on the one card
             (a Mesh of cuda:0 four times), 2^24 x 3-D uniform and then
             clustered (the --distribution clustered stream) at the default
             slack, 2^20 queries at k=16 through global_morton_query_tiled:
             d2 bit-equal to the single tree's morton_knn_tiled over the
             same rows, ids equal except between tied distances, per-shard
             occupancy, occ_max, the slack, overflow retries and scan
             launches per shard; (d) ensemble_knn's dense route (2^20
             queries over 2^24 points, equal to the single tree's) and
             fused route (10 queries), global-exact at 2^22 (tiled; its
             DFS lane at 2^18, cut so the classic DFS's launches per step
             stay near 5 s), the global tree at 2^20 (node for node build_jit's),
             dsharded_knn at 2^16 x 128-D with 1,024 queries (equal to its
             column-block oracle; within 1e-5 relative of float64), each on
             four shards; (e) the CLI: ``--engine global-morton --devices 1
             build --n 2^24 --sharded`` then ``query`` (stdout = the
             oracle's lines), and a ``--device cpu --devices 8`` checkpoint
             at 2^16 queried on the card through the mesh-free Morton view
             (4,096 queries, k=8: scan kernel launches > 0, exact). After
             the counts are read: the scan kernel against the plain scan at
             the P=1 and P=4 forest shapes (one shard's collect batch), timed
             beside its bound, and at the P=4 shard phase 4c's frontier check
             on that batch's seed and collect descents.
13. fleet  — README "Serving"'s shape as a fleet: ``partition --shards 4
             --n 2^24`` (seed 42, threefry; its seconds and each shard's n,
             id range, code range and box), ``morton_codes_np`` equal to
             the device coder over the whole cloud, every shard snapshot
             equal to a Morton view of its slice of the device order; then
             the four snapshots in four ServeStates on the card behind
             ``make_router`` (selective and full fan-out): requests of 1, 7,
             64 and 1,000 rows byte-identical to the single index over the
             same points (distances, and ids up to exact ties), with the
             router ms, the shards contacted, overflow retries per shard
             and scan launches per request (both kernels' launch counts
             and the frontier's zeroed just before these requests and read
             just after; scan and frontier launches > 0), the 64 rows sent to each shard directly, and
             shard 0's scan at its 64-row serving shape against the plain
             scan; then the user's path: four ``serve --snapshot``
             processes and a ``--snapshot-follow`` read replica of shard 0
             behind ``route`` (``primary|replica``): the 64-row answer equal
             to the in-process fleet's, 16 upserts (spatially routed) and 8
             deletes read back through the router, a ``knn=hang`` drill on
             shard 3 answering ``partial:3/4`` inside ``--deadline-ms``,
             ``loadgen --rates 10,20,40 --step-seconds 3`` with its capacity
             block (knee; p50/p95/p99, goodput and fan-out per step) and the
             router's ``kdtree_loadgen_offered_rate``; the route and loadgen
             processes hold no CUDA context (nvidia-smi's compute apps, and
             no /dev/nvidia* open, where every shard process has one); every
             child drains on SIGTERM with exit 0.
14. tools  — the last modules: (a) ``serve --snapshot --no-ladder`` of
             phase 13's shard 0 under ``KDTREE_TPU_LOCKWATCH=1``, 8 client
             threads for 10 s (1-, 64- and 1,000-row /v1/knn, 64-row
             /v1/radius, 16 upserts then 8 deletes), every answer 200;
             after the load the answers against the oracle over the
             written point set; SIGTERM drains with exit 0 and no
             LockOrderError, and its ``lockwatch-graph-<pid>.json`` has 0
             cycles and names the serve.* and mutable.engine roles;
             p50/p99 by path and rows beside phase 13's shard-alone ms;
             (b) ``trend`` over phase 11's two ``bench --metrics-out``
             sidecars and phase 13's loadgen report: every file parsed,
             the bench runs' platform cuda, exit 0 or 1; (c) ``lint``
             exit 0 against ``kdtree_tpu_torch/lint_baseline.json``; (d)
             with the gated metrics on, build_morton at 2^24 and one
             2^20-query morton_knn_tiled: ``kdtree_bucket_occupancy`` up
             by the tree's buckets (sum 2^24), ``kdtree_tile_batches_total``
             by the run's batches (16), ``kdtree_tile_overflow_retries_total``
             by its ``stats.retries``, the plan profile's ``occupancy_p90``,
             both kernels' launch counts and the frontier's zeroed just
             before the build and read just after the run (scan launches >
             0), the run's seconds
             beside phase 4's with the metrics off and then off, on, on,
             off. In (a) the same load then runs on a plain server, for the
             sanitizer's cost.

Every phase runs on a plan store of this run's own (a temporary
directory). The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import re
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
MERGE_CASES = (  # phase 3's merge-only cases: name, T, S, TQ, k, full share, spread
    ("S=1024 at TQ=8 (the 7-row serve shape)", 1, 1024, 8, 16, 0.05, 0.05),
    ("k=64 at S=256", 1, 256, 8, 64, 0.1, 0.1),
    ("tie lattice past the shared capacity", 1, 512, 2, 16, 1.0, None),
    ("tie lattice at k=1100, above the capacity (slabs)", 1, 2, 8, 1100, 1.0, None),
    ("no full chunk (w = +inf), rows with fewer than k finite", 2, 2, 8, 32, 0.0, 0.0),
)
MERGE_GRAPH_LAUNCHES = 20  # merge launches per captured CUDA graph in time_shape
SERVE_CLIENTS = 8  # phase 7's concurrent HTTP clients
SERVE_DELTA_ROWS = 256  # phase 7's epoch-rebuild backlog
SERVE_NEW = 164  # new ids phase 7 upserts: 64 beside queries, 100 to cross the backlog
SERVE_CLI_N = 1 << 20  # points of phase 7's CLI server
SNAP_DELTA_ROWS = 64  # phase 8's primary: epoch-rebuild backlog
SNAP_READERS = 4  # phase 8's reader threads on the secondary
VERB_R = 1.5  # phase 8's radius: about 30 hits per query at 2^24 points
VERB_SIDE = 3.0  # phase 8's range cubes
VERB_ROWS = (1, 64, 1000)
FOLD_ROWS = {True: (1, 1000), False: (1, 64)}  # phase 4b's and 9a's fold checks
SNAP_CLI_N = 1 << 20  # points of phase 8's `build --save` / `serve --snapshot`
SNAP_CLI_R = 4.0  # its radius: about 35 hits per query at 2^20 points
WIDE_DIMS = (47, 64)  # phase 9a: 47 pads each row with 8 zeros in front, 9 behind
WIDE_N = 1 << 19  # cut from 2^20 to keep the whole run near 600 s
WIDE_Q = 4096
WIDE_SAMPLE = 256
RECALL_Q = 1 << 16  # phase 9b's sweep sample
RECALL_ROWS = (1, 64, 1000)
TUNE_Q = 1 << 16
CLASSIC_CUT_N = 1 << 20  # phase 10's equality builds (sort vs presort, card vs CPU)
CLASSIC_BUCKET = 128  # the bucketed tree's default cap
CLASSIC_KNN_Q = 4096  # phase 10's classic knn lane: the first of the sparse lane's queries
CLASSIC_SAMPLE = 256  # rows of each phase 10 lane held against the brute-force oracle
CLASSIC_HARNESS_N = 1 << 20  # phase 10's 3-D `harness --engine tree` configuration
OBS_CLIENTS = 4  # phase 11's concurrent HTTP clients
OBS_ROWS = (1, 7, 64, 1000)
OBS_PROFILE_S = 2.0  # the /debug/profile window under load
OBS_DUTY_PERIOD_S = "5"  # KDTREE_TPU_PROFILE_DUTY_PERIOD_S of the duty-cycle run
OBS_BLOCK_S = 4.0  # each block of phase 11's served-overhead measurement
SCALE_N = 1 << 26  # phase 12a: bench.py's scale lane, one shard
SCALE_Q = 10
SPMD_N = 1 << 22  # phase 12b: bench.py's SPMD tiled lane, one shard
SPMD_Q = 1 << 16
SPMD_SAMPLE = 512
FOREST_N = 1 << 24  # phase 12c: four shards on one card
FOREST_Q = 1 << 20
FOREST_SHARDS = 4
EXACT_N = 1 << 22  # phase 12d: global-exact (build and tiled lane)
EXACT_DFS_N = 1 << 18  # its DFS lane: launches per step cost ~75 s at 2^22, ~21 s at 2^20
GTREE_N = 1 << 20  # global-tree
DSHARD_N, DSHARD_D, DSHARD_Q = 1 << 16, 128, 1024  # dsharded_knn
FOREST_CPU_N = 1 << 16  # 12e: the CPU-built 8-shard checkpoint
FOREST_CPU_Q = 4096
FLEET_N = 1 << 24  # phase 13: README "Serving"'s shape cut into 4 Morton-range shards
FLEET_SHARDS = 4
FLEET_ROWS = (1, 7, 64, 1000)
FLEET_DEADLINE_MS = 3000
FLEET_RATES = "10,20,40"  # the loadgen ladder (req/s), FLEET_STEP_S seconds a step
FLEET_STEP_S = 3
FLEET_READY_S = 300  # the CLI fleet's start-up budget
TOOLS_CLIENTS = 8  # phase 14a: client threads against each of its two servers
TOOLS_LOAD_S = 10.0  # phase 14a: seconds of that load
TOOLS_UPSERTS, TOOLS_DELETES = 16, 8


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


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def form_d2(q, pts, rounded):
    """Squared distances from rows ``q`` [Q, D] to ``pts`` [Q, M, D] as the
    classic and bucketed DFS compute them in XLA:CPU's vector lanes
    (``_arith.sq_dist_rows``): each square rounded and added in order for
    the points where ``rounded`` [Q, M] holds, the FMA chain elsewhere."""
    import torch

    from kdtree_tpu_torch.ops._arith import sq_dist, sq_sum_windows

    diff = q[:, None, :] - pts
    return torch.where(rounded, sq_sum_windows(diff * diff), sq_dist(q[:, None, :], pts))


def form_oracle(points, queries, k, rounded):
    """Brute-force k-NN with each point's distance in :func:`form_d2`'s
    form (``rounded`` bool[N] per point), ties to the lower id."""
    import torch

    from kdtree_tpu_torch.ops import bruteforce as bf

    n, d = points.shape
    Q = queries.shape[0]
    tile = max(bf._TILE_ELEMS // (Q * d), k)
    best = None
    for base in range(0, n, tile):
        pt = points[base: base + tile]
        t = pt.shape[0]
        d2 = form_d2(queries, pt[None].expand(Q, t, d),
                     rounded[base: base + tile][None].expand(Q, t))
        idx = torch.arange(base, base + t, dtype=torch.int64, device=points.device)
        cand = bf._smallest(bf._keys(d2, idx[None, :].expand(Q, t)), min(k, t))
        best = cand if best is None else bf._smallest(torch.cat([best, cand], 1), k)
    return bf._unkey(best)


def check_answer(points, queries, d2, ids, k, what, want=None, rounded=None):
    """d2 must equal the brute-force oracle's bit for bit; ids must equal
    its ids wherever the distance is not tied with a neighbouring rank,
    and every returned id must reproduce its distance (so ties may pick
    either of the equal points, never a wrong one). ``want`` = (d2, ids)
    of another exact engine takes the oracle's place; ``rounded`` (bool
    per point) makes the oracle and the check :func:`form_oracle`'s."""
    import torch

    from kdtree_tpu_torch.ops import bruteforce
    from kdtree_tpu_torch.ops._arith import sq_dist

    q = torch.as_tensor(queries, device=points.device)
    if want is None and rounded is not None:
        od, oi = form_oracle(points, q, k, rounded)
    elif want is None:
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
    if rounded is None:
        again = sq_dist(q[:, None, :], points[ids.long()])
    else:
        again = form_d2(q, points[ids.long()], rounded[ids.long()])
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


def synthetic_partials(rng, T, S, TQ, k, full, spread, dev):
    """Seeded partial buffers pd f32[T, S, TQ, k], pi i32[T, S, TQ, k] as
    the scan kernel leaves them: each chunk's buffer ascending, a ``full``
    share of the chunks holding k entries and the rest 0..k-1, unfilled
    slots (+inf, -1); chunk s's d2 uniform in [s spread, s spread + 10), as
    chunks later in the lb order lie farther, or on the lattice {0, 1, 2,
    3} when ``spread`` is None."""
    import torch

    n = np.where(rng.random((T, S, TQ)) < full, k, rng.integers(0, k, (T, S, TQ)))
    if spread is None:
        v = rng.integers(0, 4, (T, S, TQ, k)).astype(np.float32)
    else:
        v = (rng.random((T, S, TQ, k)) * 10
             + np.arange(S)[:, None, None] * spread).astype(np.float32)
    filled = np.arange(k) < n[..., None]
    d = np.where(filled, np.sort(v, -1), np.inf).astype(np.float32)
    i = np.where(filled, rng.integers(0, 1 << 30, (T, S, TQ, k)), -1).astype(np.int32)
    return torch.from_numpy(d).to(dev), torch.from_numpy(i).to(dev)


def merge_only(dev):
    """The merge kernel alone on ``MERGE_CASES``, bit for bit against the
    plain merge and the mirror at the kernel's capacity (its launches
    count, but phase 3 runs before the counts are zeroed). Returns the
    lines to print."""
    import torch

    from kdtree_tpu_torch.kernels.scan_knn import merge_capacity, merge_partials
    from kdtree_tpu_torch.ops import tile_query as tqm

    rng = np.random.default_rng(SEED)
    lines = []
    for name, T, S, TQ, k, full, spread in MERGE_CASES:
        pd, pi = synthetic_partials(rng, T, S, TQ, k, full, spread, dev)
        kd, ki = merge_partials(pd, pi)
        md, mi = tqm.merge_partials(pd, pi)
        used = merge_capacity(S)
        # the mirror's many small steps run on the host copy
        sd, si, surv, over = tqm.merge_select(pd.cpu(), pi.cpu(), used)
        torch.cuda.synchronize()
        assert torch.equal(kd, md) and torch.equal(ki, mi), f"merge kernel != plain: {name}"
        assert torch.equal(sd, md.cpu()) and torch.equal(si, mi.cpu()), f"mirror != plain: {name}"
        fin = torch.isfinite(md)
        if fin.any():
            MERGE_ERR[0] = max(MERGE_ERR[0], float((kd[fin] - md[fin]).abs().max()))
        rows_over = int((surv > used).sum())
        if spread is None:
            assert rows_over > 0, f"{name}: the survivors never passed the capacity"
        if k > used:
            assert bool((over >= 2).all()), f"{name}: a row was answered in one slab"
        if full == 0.0:
            assert not torch.isfinite(md).all(), f"{name}: no row came out short of k"
        lines.append(f"merge only, {name} (T={T} S={S} TQ={TQ} k={k}): bit-equal to the plain "
                     f"merge and the mirror; survivors per row {int(surv.min())}-"
                     f"{int(surv.max())} against a capacity of {used} keys, {rows_over} of "
                     f"{T * TQ} rows past it, {int(over.sum())} radix-select slabs; pads "
                     f"{int((~fin).sum())}")
    return lines


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
    # above 32 axes the squares are rounded and summed in windows of 32;
    # past 1,024 axes the window sums take a second level
    cases.append(("D=40, window sums", generate_points_rowwise(19, 40, 5000, device=dev),
                  generate_queries(20, 40, 4 * 32, device=dev), 32, 5, 128, False, 64, SPLITS))
    cases.append(("D=1100, two window levels", generate_points_rowwise(21, 1100, 2000, device=dev),
                  generate_queries(22, 1100, 2 * 16, device=dev), 16, 3, 128, False, 16, SPLITS))
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
    for line in merge_only(dev):
        say("kernel", line)
    return max_err


PAIR_DIMS = (1, 2, 3, 8, 32, 47)  # phase 3b's ladder; 47 is phase 9's oracle at D = 47
PAIR_Q = 1000  # phase 4's fallback batch (phase 9's oracle takes WIDE_SAMPLE rows)
PAIR_RAGGED = ((37, 300), (5, 100))  # (Q, T): a partial query block and point block
PAIR_GRAPH_LAUNCHES = 10
FOLD_GRAPH_LAUNCHES = 10
WIDE_VERB_SCALE = 0.1  # phase 9a's fold queries at D = 47: phase 9's, shrunk toward the centre
WIDE_VERB_R = 290.0  # their radius: ~35 hits a query at 2^19 points
WIDE_VERB_SIDE = 162.0  # their cubes: ~25 hits
FOLD_RECS = {}  # kernel name -> its record at the main path's shape (3b, 3c, 4b)
FOLD_LAUNCHES = {"verb_radius_fold": 0, "verb_range_fold": 0, "pair_d2": 0}  # main-path runs
KNN_LAUNCHES = {}  # phase -> knn_scan.launches over its driven window (4: fallback, 7: overlay)
KNN_DIMS = (1, 3, 8, 32, 33, 47)  # phase 3c
KNN_KS = (1, 16, 100)  # 100: above the 64 entries a shared-memory list holds
KNN_ROWS = (1, 7, 1000)
KNN_N = 20011  # phase 3c's point count: no multiple of a chunk or a stage
KNN_MORTON_N = (1 << 16) + 77  # 3c's Morton-ordered storage, a +inf pad row ending every 256
KNN_MORTON_ROWS = (1, 8, 64, 1000)
KNN_TIMED_ROWS = (8, 64, 1000, 1024)  # the correction bucket, an overlay, the fallback, its cap
KNN_ISSUE_SLOTS = 7  # instructions a (query, point) pair at D = 3: 3 FSUB, 3 FFMA, a compare
KNN_RECS = {}  # "fallback": phase 4's fallback batch kernel on the tree's storage


def event_ms(fn):
    """``fn()`` once between two CUDA events: (its result, device ms)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def pair_ladder_shape(d):
    """(Q, T) of phase 3b's ``pair_d2`` ladder at D = d: phase 4's fallback
    batch (phase 9's oracle sample above 32 axes) against a point tile of
    ``bruteforce.knn``'s plain version, the fallback's block before the
    fused k-NN took it."""
    from kdtree_tpu_torch.ops.bruteforce import _TILE_ELEMS, REFINE_SLACK

    q = WIDE_SAMPLE if d > 32 else PAIR_Q
    return q, max(_TILE_ELEMS // (q * d), K + REFINE_SLACK, 1)


def pair_shape():
    """``pair_d2``'s calls on the main path, (name, D, Q, T): phase 8's
    oversized radius request answered by the verb oracle (its 1,025 rows
    against one block of the 2^24 points) and a shard of phase 12's
    dsharded run (1,024 rows against a 65,536-point tile of its D / 4
    columns)."""
    from kdtree_tpu_torch.verbs.oracle import _block

    return (("verb oracle", DIM, MAX_BATCH + 1, _block(MAX_BATCH + 1, N_POINTS)),
            ("dsharded shard", DSHARD_D // FOREST_SHARDS, DSHARD_Q, min(1 << 16, DSHARD_N)))


def pair_only(dev):
    """Phase 3b: the ``pair_d2`` kernel against its plain version
    (``sq_dist`` over the broadcast rows) bit for bit at every D of
    ``PAIR_DIMS``, at the ladder's shape (:func:`pair_ladder_shape`) and
    the ragged ones of ``PAIR_RAGGED``, and at its callers' shapes
    (:func:`pair_shape`); at each of those timed through the wrapper, a
    launch in a CUDA graph, the plain version and the library's two ways
    (``_matmul_d2``: cuBLAS, TF32 off; ``torch.cdist`` squared), beside the
    input-defined bound. Returns the lines to print."""
    import torch

    from kdtree_tpu_torch.kernels.pair_d2 import pair_d2, pair_d2_plain
    from kdtree_tpu_torch.ops.bruteforce import _matmul_d2

    rng = np.random.default_rng(SEED + 3)

    def rows(n, d):
        return torch.from_numpy(rng.uniform(-100, 100, (n, d)).astype(np.float32)).to(dev)

    def timed(name, d, Q, T):
        q, p = rows(Q, d), rows(T, d)
        p[:8] = q[:8]
        got = pair_d2(q, p)
        want, plain_ms = event_ms(lambda: pair_d2_plain(q, p))
        assert torch.equal(got, want), f"pair_d2 != sq_dist at D={d}, {Q} x {T} ({name})"
        del got, want
        bound_ms, bound_by, _, _ = _roofline((Q * d + T * d + Q * T) * 4, Q * T * 3 * d)
        rec = {"ms": cuda_ms(lambda: pair_d2(q, p), 20), "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0,
               "graph_ms": graph_ms(lambda: pair_d2(q, p), PAIR_GRAPH_LAUNCHES, 5),
               "matmul_ms": cuda_ms(lambda: _matmul_d2(q, p), 20),
               "library_ms": cuda_ms(lambda: torch.cdist(q, p).square_(), 20)}
        line = (f"{Q} x {T} ({T % 128} points in the last block): {rec['ms']:.4f} ms "
                f"({rec['graph_ms']:.4f} a launch in a CUDA graph), plain "
                f"{rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.4f} ms ({bound_by}); library: "
                f"_matmul_d2 {rec['matmul_ms']:.4f} ms, torch.cdist squared "
                f"{rec['library_ms']:.4f} ms")
        return rec, line

    lines = []
    for d in PAIR_DIMS:
        for nq, nt in PAIR_RAGGED:
            q, p = rows(nq, d), rows(nt, d)
            p[:2] = q[:2]  # zero distances
            assert torch.equal(pair_d2(q, p), pair_d2_plain(q, p)), \
                f"pair_d2 != sq_dist at D={d}, {nq} x {nt}"
        _, line = timed("ladder", d, *pair_ladder_shape(d))
        lines.append(f"pair_d2 D={d}: bit-equal to sq_dist at "
                     + ", ".join(f"{nq} x {nt}" for nq, nt in PAIR_RAGGED)
                     + f" and the ladder's shape {line}")
    for name, d, Q, T in pair_shape():
        rec, line = timed(name, d, Q, T)
        if name == "verb oracle":
            FOLD_RECS["pair_d2"] = rec
        lines.append(f"pair_d2 at the {name}'s shape, D={d}: bit-equal to sq_dist, {line}")
    return lines


def morton_sorted(rows, pad_every=0):
    """``rows`` in the port's Morton order (``morton_codes`` at the build's
    default bits, stably sorted), and with ``pad_every`` a +inf row ending
    every run of that many rows (the last run filled up with them), as
    padded bucket storage holds its pads."""
    import torch

    from kdtree_tpu_torch.ops.morton import default_bits, morton_codes

    n, d = rows.shape
    out = rows[torch.sort(morton_codes(rows, default_bits(d)), stable=True).indices]
    if not pad_every:
        return out
    per = pad_every - 1
    g = -(-n // per)
    x = out.new_full((g * per, d), float("inf"))
    x[:n] = out
    return torch.cat([x.view(g, per, d), out.new_full((g, 1, d), float("inf"))], 1).view(-1, d)


def sm_clock_mhz():
    """The card's highest SM clock in MHz (nvidia-smi), for the issue-slot
    bound."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0])


def knn_bounds(points, queries, d2, clock_mhz):
    """The fused k-NN's bound in three forms, ms: every pair's 3 D flops
    over the FP32 rate (against the rows, queries and answer moved once),
    every pair's KNN_ISSUE_SLOTS instructions over the SMs' issue rate at
    ``clock_mhz``, and what these inputs need: 3 D flops for each pair in
    a stage tile (the kernel's ``kernel_stage()`` rows) whose box bound the query's final k-th
    (``d2[:, -1]``) does not strictly exceed (``tile_boxes`` /
    ``tile_lb_plain``, the kernel's cull), with the same bytes."""
    import torch

    from kdtree_tpu_torch.kernels import knn_scan as ks

    n, d = points.shape
    Q, k = d2.shape
    nbytes = (n * d + Q * d + Q * k * 2) * 4
    ops_ms, ops_by, _, _ = _roofline(nbytes, Q * n * 3 * d)
    sms = torch.cuda.get_device_properties(points.device).multi_processor_count
    issue_ms = Q * n * KNN_ISSUE_SLOTS / (sms * 128 * clock_mhz * 1e6) * 1e3
    stage = ks.kernel_stage()
    lo, hi = ks.tile_boxes(points, stage)
    sizes = torch.full((lo.shape[0],), stage, dtype=torch.int64, device=points.device)
    sizes[-1] = n - (lo.shape[0] - 1) * stage
    kept = ks.tile_lb_plain(queries, lo, hi) <= d2[:, -1:]
    pairs = int((kept * sizes).sum())
    need_ms, need_by, _, _ = _roofline(nbytes, pairs * 3 * d)
    return {"bound_ms": ops_ms, "bound_by": ops_by, "issue_ms": issue_ms,
            "need_ms": need_ms, "need_by": need_by, "need_frac": pairs / (Q * n)}


def knn_timed(points, queries, clock_mhz):
    """The fused k-NN on one shape: the chunk count, ms through the wrapper
    and a launch in a CUDA graph, the share of (warp, stage) pairs the cull
    skipped (the kernel's own count) and :func:`knn_bounds`."""
    import torch

    from kdtree_tpu_torch.kernels import knn_scan as ks

    counts = torch.zeros(2, dtype=torch.int64, device=points.device)
    d2, _ = ks.knn_scan(points, queries, K, counts=counts)
    culled, seen = counts.tolist()
    n, d = points.shape
    Q = queries.shape[0]
    rec = {"S": ks.plan(points.device.index or 0, Q, n, d, K)[1],
           "ms": cuda_ms(lambda: ks.knn_scan(points, queries, K), 5),
           "graph_ms": graph_ms(lambda: ks.knn_scan(points, queries, K), 3, 3),
           "culled_frac": culled / max(seen, 1), "max_abs_err": 0.0, "library_ms": None,
           **knn_bounds(points, queries, d2, clock_mhz)}
    return rec


def knn_line(what, rec):
    return (f"{what}: S={rec['S']} chunks, {rec['ms']:.4f} ms through the wrapper, "
            f"{rec['graph_ms']:.4f} a launch in a CUDA graph; {rec['culled_frac']:.4f} of the "
            f"(warp, stage) pairs culled; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
            f"issue slots ({KNN_ISSUE_SLOTS} a pair) {rec['issue_ms']:.4f} ms, what the inputs "
            f"need ({rec['need_frac']:.6f} of the pairs) {rec['need_ms']:.4f} ms "
            f"({rec['need_by']})")


def knn_only(dev):
    """Phase 3c: the fused k-NN kernel against its plain version
    (``knn_scan_plain``) bit for bit, d2 and ids, then timed at the
    serving shapes in random and Morton order (see the module docstring).
    Returns the lines to print; the fallback shape's record (random order)
    goes to ``FOLD_RECS["knn_scan"]``. Its launches here are not the main
    path's (phase 4 zeroes them)."""
    import torch

    from kdtree_tpu_torch.kernels import knn_scan as ks

    assert max(KNN_KS) > ks.SMEM_K, "phase 3c must reach the lists in device memory"
    rng = np.random.default_rng(SEED + 4)

    def rows(n, d, lattice=False):
        x = rng.integers(0, 3, (n, d)) if lattice else rng.uniform(-100, 100, (n, d))
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    cases = [(f"D={d} k={k} Q={nq}", rows(KNN_N, d), rows(nq, d), k)
             for d in KNN_DIMS for k in KNN_KS for nq in KNN_ROWS]
    for d in (3, 8):
        for k in (16, 100):
            cases.append((f"tie lattice D={d} k={k}", rows(KNN_N, d, True),
                          rows(1000, d, True), k))
    masked = rows(KNN_N, 3)
    masked[torch.as_tensor(rng.permutation(KNN_N)[:KNN_N - 9], device=dev)] = float("inf")
    cases += [("9 finite rows, k=16", masked, rows(64, 3), 16),
              ("no finite row, k=100", torch.full((KNN_N, 3), float("inf"), device=dev),
               rows(7, 3), 100),
              ("k = N = 700", rows(700, 3), rows(33, 3), 700),
              ("N = 300, below a chunk's minimum", rows(300, 8), rows(40, 8), 16)]
    morton = morton_sorted(rows(KNN_MORTON_N, 3), BUCKET)
    cases += [(f"Morton order, a pad every {BUCKET} rows, k={k} Q={nq}", morton, rows(nq, 3), k)
              for k in KNN_KS for nq in KNN_MORTON_ROWS]
    cases += [(f"Morton order from row {off} ({12 * off % 16} bytes past a 16-byte boundary), "
               f"k=16 Q={nq}", morton[off:], rows(nq, 3), 16)
              for off in (1, 2, 3) for nq in (8, 1000)]
    chunks = set()
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    for what, p, q, k in cases:
        want = ks.knn_scan_plain(p, q, min(k, p.shape[0]))
        got = ks.knn_scan(p, q, k, counts=counts)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            f"knn_scan != knn_scan_plain at {what}"
        chunks.add(ks.plan(dev.index or 0, q.shape[0], p.shape[0], q.shape[1],
                           min(k, p.shape[0]))[1])
    culled, seen = counts.tolist()
    lines = [f"knn_scan bit-equal to knn_scan_plain (d2 and ids) in {len(cases)} cases: D = "
             f"{', '.join(map(str, KNN_DIMS))} x k = {', '.join(map(str, KNN_KS))} x Q = "
             f"{', '.join(map(str, KNN_ROWS))} over {KNN_N} points, tie lattices at D = 3 and 8 "
             f"(k = 16, 100), 9 finite rows, none finite, k = N = 700, N = 300; "
             f"{KNN_MORTON_N} Morton-ordered rows with a +inf pad every {BUCKET} at k = "
             f"{', '.join(map(str, KNN_KS))} x Q = {', '.join(map(str, KNN_MORTON_ROWS))}, and "
             f"from rows 1, 2 and 3 (bases 12, 8 and 4 bytes past a 16-byte boundary) at Q = 8 "
             f"and 1,000; at the planned chunks (S in {sorted(chunks)}, the merge kernel "
             f"joining them where S > 1); the D = 3 cases culled {culled} of {seen} "
             f"(warp, stage) pairs"]

    clock = sm_clock_mhz()
    pts = rows(N_POINTS, DIM)
    mpts = morton_sorted(pts)
    fq = rows(PAIR_Q, DIM)
    got = ks.knn_scan(pts, fq, K)
    want, plain_ms = event_ms(lambda: ks.knn_scan_plain(pts, fq, K))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
        "knn_scan != knn_scan_plain at the fallback shape"
    got = ks.knn_scan(mpts, fq, K)
    want = ks.knn_scan_plain(mpts, fq, K)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
        "knn_scan != knn_scan_plain at the fallback shape in Morton order"
    del got, want
    lines.append(f"knn_scan bit-equal to knn_scan_plain at the fallback shape ({PAIR_Q} x "
                 f"2^{N_POINTS.bit_length() - 1} x {DIM}-D, k={K}) in random and in Morton "
                 f"order; plain {plain_ms:.1f} ms (random order); library: none (no single "
                 f"PyTorch call computes k-NN); max SM clock {clock:.0f} MHz")
    for name, P in (("random", pts), ("Morton", mpts)):
        for nq in KNN_TIMED_ROWS:
            q = fq if nq == PAIR_Q else rows(nq, DIM)
            rec = knn_timed(P, q, clock)
            if name == "random" and nq == PAIR_Q:
                FOLD_RECS["knn_scan"] = {**rec, "plain_ms": plain_ms}
            lines.append(knn_line(f"knn_scan, {nq} rows over 2^{N_POINTS.bit_length() - 1} x "
                                  f"{DIM}-D in {name} order, k={K}", rec))
    del pts, mpts
    return lines


@contextlib.contextmanager
def fold_calls():
    """Keep the arguments of every fold call ``verbs/device.py`` makes
    (the wrappers themselves run as ever, so their launches count)."""
    import types

    from kdtree_tpu_torch.kernels import verb_fold as vf
    from kdtree_tpu_torch.verbs import device as vd

    seen = {"radius": [], "range": []}

    def spy(kind, fn):
        def call(*args):
            seen[kind].append(args)
            return fn(*args)
        return call

    vd.verb_fold = types.SimpleNamespace(radius_fold=spy("radius", vf.radius_fold),
                                         range_fold=spy("range", vf.range_fold))
    try:
        yield seen
    finally:
        vd.verb_fold = vf


def fold_bound(verb, tree, a, b, cand, m):
    """The least time the card needs for one fold, from what its inputs
    need: the box test of every (query, real candidate), 3 D flops a radius
    pair (a gap and an FMA an axis) and 2 D compares a box, then the point
    tests of the (query, bucket) pairs that ``leaf_pass_plain`` passes, x
    that bucket's real points (3 D flops or 2 D compares each); against the
    candidate ids, each distinct leaf box once, each distinct bucket some
    query passes once (B x (D + 1) words), the queries read and the counts
    and buffers written once. Beside it the all-pairs figure (every real
    (query, point) test, each (tile, candidate bucket) read once: the most
    these inputs could need) and ``kept_frac``, the passing pairs over all
    (query, real candidate) pairs. Returns a dict."""
    import torch

    from kdtree_tpu_torch.kernels.verb_fold import leaf_pass_plain

    T, TQ, D = a.shape
    B = tree.bucket_size
    per_op = 3 if verb == "radius" else 2
    real_c = cand >= 0
    real = int(real_c.sum())
    sel = cand.long().clamp_min(0)
    npts = (tree.bucket_gid >= 0).sum(dim=1)[sel] * real_c  # real points a candidate
    passed = leaf_pass_plain(tree, verb, a, b, cand)  # [T, TQ, C]
    tests = int((passed.sum(dim=1) * npts).sum())
    leaves = int(torch.unique(cand[real_c]).numel())
    buckets = int(torch.unique(cand[passed.any(dim=1)]).numel())
    q_bytes = T * TQ * ((D + 1) if verb == "radius" else 2 * D) * 4
    out_bytes = T * TQ * 4 + T * TQ * m * (8 if verb == "radius" else 4)
    rec = {}
    rec["bound_ms"], rec["bound_by"], _, _ = _roofline(
        cand.numel() * 4 + leaves * 2 * D * 4 + buckets * B * (D + 1) * 4 + q_bytes + out_bytes,
        (real * TQ + tests) * per_op * D)
    all_tests = real * TQ * B
    rec["all_pairs_bound_ms"], rec["all_pairs_bound_by"], _, _ = _roofline(
        real * (B * (D + 1) * 4 + 4) + q_bytes + out_bytes, all_tests * per_op * D)
    rec["kept_frac"] = int(passed.sum()) / max(real * TQ, 1)
    rec["tests"], rec["all_tests"] = tests, all_tests
    return rec


def _rows_equal(verb, kern, plain, m):
    """The fold's contract on one call: counts bit-equal; where a count is
    <= m, the canonical rows (d2 and ids) bit-equal. Returns (rows
    compared, rows past m, largest |d2| difference)."""
    import torch

    from kdtree_tpu_torch.verbs import device as vd

    assert torch.equal(kern[0], plain[0]), f"{verb} fold counts differ from the plain fold"
    counts = plain[0].reshape(-1).cpu().numpy()
    ok = counts <= m
    if m == 0:
        return 0, int((~ok).sum()), 0.0
    n = counts.size
    if verb == "radius":
        kd, ki = vd.canonical_radius_rows(kern[1].reshape(n, -1).cpu().numpy(),
                                          kern[2].reshape(n, -1).cpu().numpy())
        pd, pi = vd.canonical_radius_rows(plain[1].reshape(n, -1).cpu().numpy(),
                                          plain[2].reshape(n, -1).cpu().numpy())
        assert np.array_equal(kd[ok], pd[ok]) and np.array_equal(ki[ok], pi[ok]), \
            f"{verb} fold rows differ from the plain fold"
        fin = np.isfinite(pd[ok])
        err = float(np.abs(kd[ok][fin] - pd[ok][fin]).max()) if fin.any() else 0.0
    else:
        ki = vd.canonical_range_rows(kern[1].reshape(n, -1).cpu().numpy())
        pi = vd.canonical_range_rows(plain[1].reshape(n, -1).cpu().numpy())
        assert np.array_equal(ki[ok], pi[ok]), f"{verb} fold rows differ from the plain fold"
        err = 0.0
    return int(ok.sum()), int((~ok).sum()), err


def fold_case(what, tree, verb, call, graph, split=False, chunks=()):
    """One verb call's last fold (its final pass, after any retry): the
    kernel against the plain fold in the ids form, the count form and, with
    ``split``, at m below the largest count; both timed beside the bound.
    ``split`` also takes the plain fold's device time by range
    (``verbs.fold.gather`` / ``.d2`` / ``.test`` / ``.sort``) from a
    capture of that last comparison's plain run. ``chunks`` times the
    kernel again at each of those candidate positions a block (the sweep
    behind ``verb_fold._WIDE_CHUNK``). Returns (lines, record)."""
    import torch

    from kdtree_tpu_torch.kernels import verb_fold as vf

    kern_fn = vf.radius_fold if verb == "radius" else vf.range_fold
    plain_fn = vf._radius_fold_plain if verb == "radius" else vf._range_fold_plain
    with fold_calls() as seen:
        res = call()
    t_, a, b, cand, m = seen[verb][-1]
    T, TQ, D = a.shape
    lines = []
    kern = kern_fn(t_, a, b, cand, m)
    plain, plain_ms = event_ms(lambda: plain_fn(t_, a, b, cand, m))
    n_ok, n_over, err = _rows_equal(verb, kern, plain, m)
    assert n_over == 0, f"{what}: the verb's last fold left a count above m={m}"
    hits = int(plain[0].sum())
    assert hits == int(res.counts.sum()), f"{what}: the verb's counts differ from its fold's"
    # the count form against the plain fold's counts, which do not depend on m
    kc = kern_fn(t_, a, b, cand, 0)
    _rows_equal(verb, kc, plain, 0)
    assert kc[-1].shape[-1] == 0, f"{what}: the count form has a buffer"
    rec = {"ms": cuda_ms(lambda: kern_fn(t_, a, b, cand, m), 20), "plain_ms": plain_ms,
           "count_ms": cuda_ms(lambda: kern_fn(t_, a, b, cand, 0), 20), "max_abs_err": err}
    rec["graph_ms"] = (graph_ms(lambda: kern_fn(t_, a, b, cand, m), FOLD_GRAPH_LAUNCHES, 5)
                       if graph else None)
    rec.update(fold_bound(verb, t_, a, b, cand, m))
    C = cand.shape[1]
    lines.append(
        f"{what}: T={T} TQ={TQ} D={D} C={C} m={m}, {hits} hits, {rec['tests']} (query, point) "
        f"tests after the cull, {rec['all_tests']} without (kept_frac {rec['kept_frac']:.6f}): "
        f"counts bit-equal, canonical rows bit-equal ({n_ok} rows); count form counts "
        f"bit-equal; kernel {rec['ms']:.4f} ms"
        + (f" ({rec['graph_ms']:.4f} a launch in a CUDA graph)" if graph else "")
        + f", count form {rec['count_ms']:.4f} ms; plain {rec['plain_ms']:.2f} ms; bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
        f"all-pairs bound {rec['all_pairs_bound_ms']:.4f} ms ({rec['all_pairs_bound_by']})")
    if chunks:
        blocks = vf._blocks
        ms = []
        try:
            for c in chunks:
                vf._blocks = lambda dev, T, C, D, c=c: vf.blocks_per_tile(dev, T, C, -(-C // c))
                ms.append(cuda_ms(lambda: kern_fn(t_, a, b, cand, m), 20))
        finally:
            vf._blocks = blocks
        lines.append(f"{what}, the kernel by candidate positions a block: " + ", ".join(
            f"{c} {t:.4f} ms" for c, t in zip(chunks, ms)))
    if split:
        counts = plain[0]
        small = max(1, int(counts.max()) // 2)
        ks = kern_fn(t_, a, b, cand, small)
        ps, rep = captured(lambda: plain_fn(t_, a, b, cand, small), t_.device)
        n_ok, n_over, _ = _rows_equal(verb, ks, ps, small)
        assert n_over > 0, f"{what}: m={small} is not below the largest count"
        lines.append(f"{what} at m={small}, below the largest count {int(counts.max())}: counts "
                     f"bit-equal, rows bit-equal where count <= m ({n_ok} rows; {n_over} past m)")
        ranges = rep["device"]["ranges"]
        names = ("gather", "d2", "test", "sort") if verb == "radius" else ("gather", "test", "sort")
        part = {k: ranges.get(f"verbs.fold.{k}", {}).get("busy_us", 0.0) / 1e3 for k in names}
        whole = rep["device"]["busy_us"] / 1e3
        assert min(part.values()) > 0 and sum(part.values()) <= whole * 1.02, \
            f"{what}: the plain fold's ranges do not split its device time: {part}, {whole}"
        lines.append(f"{what}, that plain fold at m={small} in a capture window: device "
                     f"{whole:.3f} ms: " + ", ".join(f"{k} {v:.3f} ms" for k, v in part.items())
                     + " (obs.timeline ranges verbs.fold." + " / .".join(names) + ")")
    return lines, rec


def phase_fold(tree, vq, r, side, smi, main):
    """The verbs' fold kernels against the plain folds on the card, at the
    shapes ``radius_search`` / ``range_search`` give them on ``tree`` for
    the first rows of the host queries ``vq`` that ``FOLD_ROWS`` gives
    (radius ``r``, cubes of side ``side``): phase 4b on phase 4's tree and
    phase 8's queries at 1 and 1,000 rows (``main``: its 1,000-row records
    go to the kernels line, with the m-below case and the plain folds'
    split), phase 9a on the D = 47 tree at 1 and 64. Prints its lines."""
    from kdtree_tpu_torch.verbs import device as vd

    t0 = time.perf_counter()
    half = np.float32(side / 2)
    tag = f"2^{tree.n_real.bit_length() - 1} x {tree.dim}-D"
    for rows in FOLD_ROWS[main]:
        q = vq[:rows]
        top = main and rows == max(VERB_ROWS)
        for verb, call in (("radius", lambda: vd.radius_search(tree, q, r)),
                           ("range", lambda: vd.range_search(tree, q - half, q + half))):
            lines, rec = fold_case(f"{verb} fold, {rows} rows, {tag}", tree, verb, call,
                                   graph=main or rows == max(FOLD_ROWS[main]), split=top,
                                   chunks=(8, 64) if not main and rows == max(FOLD_ROWS[main])
                                   else ())
            for line in lines:
                say("fold", f"{line} [{smi}]")
            if top:
                FOLD_RECS[f"verb_{verb}_fold"] = rec
    say("fold", f"the folds on the {tag} tree in {time.perf_counter() - t0:.1f} s")


ADV_N = (1 << 16) - 700  # the adversarial trees: 254 buckets of 256, padded to 256 (2 empty leaves)
ADV_DIMS = (3, 8, 47)
ADV_SHAPES = ((16, 64), (1, 1), (3, 37))  # (tiles, queries a tile)


def adversarial_inputs(d, dev, seed):
    """Phase 4b's adversarial fold inputs at D = d. The tree: ``ADV_N``
    integer grid points (a third of them copies of others, every zero of
    every fifth point -0.0; the leaf boxes' faces lie on points), B = 256,
    two empty leaves. For each shape of ``ADV_SHAPES``: radius rows centred
    on points, each r2 the exact squared distance (the fold's arithmetic)
    to its k-th nearest point, k in 1..64, so hits land at d2 == r2 and on
    the leaf boxes' bounds, one row at r2 = 0, one centred with -0.0 for
    each zero, the last rows padding (r2 = -1); range boxes with faces on
    point coordinates, one of zero width with -0.0 faces, a slab infinite
    on axis 0, one inverted on the last axis, one with every upper face
    +inf, the last rows padding (lo = +inf, hi = -inf); the candidates every
    bucket, empty leaves included, in a shuffled order with -1 entries.
    Returns (tree, [(tq, r2, lo, hi, cand)])."""
    import torch

    from kdtree_tpu_torch.ops._arith import sq_dist
    from kdtree_tpu_torch.ops.morton import build_morton

    rng = np.random.default_rng(seed)
    span = 8 if d == 3 else 3
    pts = rng.integers(-span, span, (ADV_N, d)).astype(np.float32)
    pts[1::3] = pts[rng.integers(0, ADV_N, pts[1::3].shape[0])]
    fifth = pts[::5]
    fifth[fifth == 0] = -0.0
    points = torch.from_numpy(pts).to(dev)
    tree = build_morton(points, bucket_cap=BUCKET)
    assert bool((tree.node_lo[-tree.num_buckets:, 0] > tree.node_hi[-tree.num_buckets:, 0]).any())
    cases = []
    for T, TQ in ADV_SHAPES:
        rows = T * TQ
        c = pts[rng.integers(0, ADV_N, rows)].copy()
        c[min(1, rows - 1)][c[min(1, rows - 1)] == 0] = -0.0
        q = torch.from_numpy(c).to(dev)
        k = torch.as_tensor(rng.integers(1, 65, rows), device=dev)
        r2 = torch.empty(rows, dtype=torch.float32, device=dev)
        for s in range(0, rows, 16):  # [16, N, D] of differences at a time
            d2 = sq_dist(q[s:s + 16, None, :], points[None, :, :])
            r2[s:s + 16] = torch.sort(d2, dim=1).values.gather(1, k[s:s + 16, None] - 1)[:, 0]
        if rows > 2:
            r2[0] = 0.0
            r2[-min(3, rows - 2):] = -1.0
        half = rng.integers(0, 3, (rows, d)) if d < 47 else rng.integers(2, 4, (rows, d))
        lo, hi = (c - half).astype(np.float32), (c + half).astype(np.float32)
        if rows > 6:
            lo[0], hi[0] = c[1], c[1]  # zero width, -0.0 faces
            lo[1, 0], hi[1, 0] = -np.inf, np.inf
            lo[2, -1], hi[2, -1] = hi[2, -1] + 1, lo[2, -1]
            hi[3] = np.inf
            lo[-2:], hi[-2:] = np.inf, -np.inf
        order = rng.permutation(tree.num_buckets).astype(np.int32)
        cand = np.stack([np.insert(rng.permutation(order), rng.integers(0, order.size, 8), -1)
                         for _ in range(T)]).astype(np.int32)
        cases.append((q.reshape(T, TQ, d), r2.reshape(T, TQ),
                      torch.from_numpy(lo).to(dev).reshape(T, TQ, d),
                      torch.from_numpy(hi).to(dev).reshape(T, TQ, d),
                      torch.from_numpy(cand).to(dev)))
    return tree, cases


def adversarial_folds(dev):
    """Phase 4b's adversarial check: at every D of ``ADV_DIMS`` and shape of
    ``ADV_SHAPES`` (:func:`adversarial_inputs`), both fold kernels against
    their plain folds under :func:`_rows_equal`'s rules, at m above the
    largest count, m = 0 and m below the largest count. Returns its lines."""
    from kdtree_tpu_torch.kernels import verb_fold as vf

    lines = []
    for d in ADV_DIMS:
        t0 = time.perf_counter()
        tree, cases = adversarial_inputs(d, dev, SEED + 14 + d)
        parts = []
        for tq, r2, lo, hi, cand in cases:
            T, TQ, _ = tq.shape
            for verb, kern_fn, plain_fn, qa, qb in (
                    ("radius", vf.radius_fold, vf._radius_fold_plain, tq, r2),
                    ("range", vf.range_fold, vf._range_fold_plain, lo, hi)):
                top = int(plain_fn(tree, qa, qb, cand, 0)[0].max())
                kept = vf.leaf_pass_plain(tree, verb, qa, qb, cand)
                frac = int(kept.sum()) / max(int((cand >= 0).sum()) * TQ, 1)
                small = max(1, top // 2)
                for m in (1 << max(top - 1, 0).bit_length(), 0, small):
                    _, n_over, _ = _rows_equal(verb, kern_fn(tree, qa, qb, cand, m),
                                               plain_fn(tree, qa, qb, cand, m), m)
                    assert m != small or top < 2 or n_over > 0, \
                        f"adversarial {verb} D={d}: m={m} is not below the largest count {top}"
                parts.append(f"{verb} {T}x{TQ} (largest count {top}, kept_frac {frac:.4f})")
        lines.append(f"adversarial folds D={d} ({tree}, C={cases[0][4].shape[1]}): both kernels "
                     f"== the plain folds (counts bit-equal, canonical rows bit-equal where "
                     f"count <= m) at m above the largest count, m = 0 and m below it: "
                     + ", ".join(parts) + f"; {time.perf_counter() - t0:.1f} s")
    return lines


FRONTIER_REPS = 10
FRONTIER_GRAPH_LAUNCHES = 10
FRONTIER_PLAIN_REPS = 3
BATCH_SPINS = 16  # spin kernels ahead of phase 5's captured batch
FRONTIER_LAUNCHES = {}  # phase -> frontier.launches over its driven window
FRONTIER_RECS = {}  # "main": the record at the main collect shape (the kernels line)


@contextlib.contextmanager
def frontier_calls():
    """Keep the arguments of every frontier call the port makes. The tiled
    batch imports the wrapper when it runs and the verbs hold it from their
    import, so both names are swapped for a spy that calls the wrapper; the
    wrapper counts its launches on the name it runs under, so the spy
    carries the count and hands it back."""
    from kdtree_tpu_torch.kernels import frontier as fmod
    from kdtree_tpu_torch.verbs import device as vd

    real, seen = fmod.frontier, []

    def spy(tree, box_lo, box_hi, bound, cap, smem_keys=None, cluster=None):
        seen.append((tree, box_lo, box_hi, bound, cap))
        return real(tree, box_lo, box_hi, bound, cap, smem_keys, cluster)

    spy.launches = real.launches
    fmod.frontier = vd.frontier = spy
    try:
        yield seen
    finally:
        real.launches = spy.launches
        fmod.frontier = vd.frontier = real


def frontier_bound(tree, blo, bhi, bound, cap):
    """The least time the card needs for this descent, from what its inputs
    need: one lower bound per node the descent evaluates (the start level's
    2^s, then both children of each live slot), 6 D flops each (per axis 2
    subtractions, 2 maxima and an FMA) over 67 TFLOP/s, against each
    distinct node box read once, the tile boxes and bounds, and the outputs
    written, over 3.35 TB/s. It counts no selection. The walk is
    ``_frontier``'s, counted."""
    import torch

    from kdtree_tpu_torch.kernels.frontier import start_level
    from kdtree_tpu_torch.ops import tile_query as tqm

    T, D = blo.shape
    L = tree.num_levels
    s = start_level(cap, L)
    m = 1 << s
    inf = torch.tensor(float("inf"), device=blo.device)
    ids = (torch.arange(m, dtype=torch.int64, device=blo.device) + (m - 1)).expand(T, m)
    evals, nodes = T * m, m
    lb = tqm._gathered_box_lb(tree, blo, bhi, ids)
    lb = torch.where(lb <= bound[:, None], lb, inf)
    if m < cap:
        ids = torch.cat([ids, torch.zeros((T, cap - m), dtype=torch.int64, device=blo.device)], 1)
        lb = torch.cat([lb, torch.full((T, cap - m), float("inf"), device=blo.device)], 1)
    lb, ids = tqm._keep_smallest(lb, ids, cap)
    for _ in range(s, L):
        alive = torch.isfinite(lb)
        cids = torch.cat([2 * ids + 1, 2 * ids + 2], dim=1)
        calive = torch.cat([alive, alive], dim=1)
        evals += int(calive.sum())
        nodes += int(torch.unique(cids[calive]).numel())
        clb = tqm._gathered_box_lb(tree, blo, bhi, cids.clamp(0, tree.heap_size - 1))
        clb = torch.where(calive & (clb <= bound[:, None]), clb, inf)
        lb, ids = tqm._keep_smallest(clb, cids, cap)
    bound_ms, bound_by, t_bytes, t_ops = _roofline(
        nodes * 2 * D * 4 + T * (2 * D * 4 + 4) + T * cap * 8 + T, evals * 6 * D)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "evals": evals, "nodes": nodes}


def frontier_case(name, tree, blo, bhi, bound, cap, timed=False, smem_keys=None, cluster=None,
                  want=None):
    """The frontier kernel against ``_frontier`` on the card, bucket ids,
    lower bounds and overflow flags bit for bit, on the wrapper's plan or
    the forced ``cluster``/``smem_keys`` (``want``: ``_frontier``'s answer,
    when the caller has it); ``timed`` adds its time through the wrapper,
    as a launch in a CUDA graph, the plain version's, the bound and the
    memory the call allocates at its peak. Returns its record."""
    import torch

    from kdtree_tpu_torch.kernels.frontier import frontier, plan
    from kdtree_tpu_torch.ops import tile_query as tqm

    blo, bhi, bound = blo.contiguous(), bhi.contiguous(), bound.contiguous()
    got = frontier(tree, blo, bhi, bound, cap, smem_keys, cluster)
    if want is None:
        want = tqm._frontier(tree, blo, bhi, bound, cap)
    torch.cuda.synchronize()
    p = plan(blo.shape[0], cap, tree.num_levels, smem_keys, cluster)
    for g, w, what in zip(got, want, ("bucket ids", "lower bounds", "overflow flags")):
        assert torch.equal(g, w), (f"frontier kernel != _frontier at {name}, cap {cap}, "
                                   f"{p}: {what}")
    rec = {"name": name, "T": blo.shape[0], "cap": cap, "kept": int((want[0] >= 0).sum()),
           "overflow": int(want[2].sum()), "cluster": p.cluster, "slice": p.slice,
           "path": "shared" if p.on_chip else "device"}
    if timed:
        def call():
            return frontier(tree, blo, bhi, bound, cap, smem_keys, cluster)

        rec["ms"] = cuda_ms(call, FRONTIER_REPS)
        rec["graph_ms"] = graph_ms(call, FRONTIER_GRAPH_LAUNCHES, FRONTIER_REPS)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        rec["plain_ms"] = cuda_ms(lambda: tqm._frontier(tree, blo, bhi, bound, cap),
                                  FRONTIER_PLAIN_REPS)
        rec.update(frontier_bound(tree, blo, bhi, bound, cap))
    return rec


def frontier_line(rec):
    head = (f"frontier {rec['name']} (T={rec['T']}, cap {rec['cap']}; {rec['cluster']} CTAs a "
            f"tile, {rec['slice']} keys each in {rec['path']} memory): bit-equal to _frontier "
            f"({rec['kept']} buckets kept, {rec['overflow']} tiles overflowed)")
    if "ms" not in rec:
        return head
    return (f"{head}; {rec['ms']:.4f} ms ({rec['graph_ms']:.4f} a launch in a CUDA graph), "
            f"plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}; "
            f"bytes {rec['bytes_ms']:.6f}, operations {rec['ops_ms']:.6f}; {rec['evals']} lower "
            f"bounds, {rec['nodes']} distinct nodes; no selection counted); max_memory_allocated "
            f"over the call {rec['peak_bytes'] / 1e6:.3f} MB (outputs and scratch)")


def cluster_sweep(name, tree, blo, bhi, bound, cap):
    """One descent at every cluster size the kernel takes, each checked
    against ``_frontier`` and timed (the wrapper, a launch in a CUDA
    graph): what the plan's choice is worth. Returns the line."""
    from kdtree_tpu_torch.kernels.frontier import CLUSTERS, frontier
    from kdtree_tpu_torch.ops import tile_query as tqm

    want = tqm._frontier(tree, blo, bhi, bound, cap)
    parts = []
    for c in CLUSTERS:
        rec = frontier_case(name, tree, blo, bhi, bound, cap, cluster=c, want=want)

        def call():
            return frontier(tree, blo, bhi, bound, cap, cluster=c)

        ms = cuda_ms(call, FRONTIER_REPS)
        g_ms = graph_ms(call, FRONTIER_GRAPH_LAUNCHES, FRONTIER_REPS)
        parts.append(f"c={c} ({rec['path']}, {rec['slice']} keys) {ms:.4f} / {g_ms:.4f}")
    return (f"frontier {name} (T={blo.shape[0]}, cap {cap}) by cluster size, bit-equal at each, "
            f"ms through the wrapper / a launch in a CUDA graph: " + ", ".join(parts))


def frontier_tiled(name, tree, tq, kk, seeds, cap, sweep=False):
    """The seed and collect descents of one tiled batch of tiles ``tq``:
    the seed at bound +inf and cap ``seeds``, the collect at the bound the
    seed's scan gives and cap ``cap``; both checked and timed (``sweep``:
    and at every cluster size, the line under "sweep"). Returns their
    records."""
    import torch

    from kdtree_tpu_torch.kernels.frontier import frontier
    from kdtree_tpu_torch.kernels.scan_knn import scan_tiles

    T = tq.shape[0]
    blo, bhi = tq.amin(1), tq.amax(1)
    inf = torch.full((T,), float("inf"), device=tq.device)
    seed = frontier_case(f"{name} seed", tree, blo, bhi, inf, seeds, timed=True)
    c0, l0, _ = frontier(tree, blo, bhi, inf, seeds)
    sd, _ = scan_tiles(tree, tq, c0, l0, kk)
    bound = sd[..., -1].amax(1).contiguous()
    collect = frontier_case(f"{name} collect", tree, blo, bhi, bound, cap, timed=True)
    if sweep:
        seed["sweep"] = cluster_sweep(seed["name"], tree, blo, bhi, inf, seeds)
        collect["sweep"] = cluster_sweep(collect["name"], tree, blo, bhi, bound, cap)
    return seed, collect


def adversarial_frontier(dev):
    """Phase 4c's adversarial check: on the integer-grid tree of phase 4b's
    adversarial folds at D = 3 (2^16 - 700 points, duplicates and -0.0,
    two empty leaves, lower bounds tied at every level), tile boxes of
    radius tiles and range union boxes, a range box infinite on one axis,
    one infinite on every axis (NaN gaps against the empty leaves), an
    all-padding tile and a point box, at bound +inf, 0 and the radius
    rows' r2, caps 1, 3, 6, 64 and the leaf count, each also with the
    shared-memory sort forced down to 2 and 64 keys (the radix path).
    Returns its lines."""
    import torch

    t0 = time.perf_counter()
    tree, cases = adversarial_inputs(3, dev, SEED + 15)
    tq, r2, lo, hi, _ = cases[0]
    inf = torch.tensor(float("inf"), device=dev)
    one_lo, one_hi = lo.amin(1)[:1].clone(), hi.amax(1)[:1].clone()
    one_lo[0, 0], one_hi[0, 0] = -inf, inf
    pt = tq[0, :1, :]
    blo = torch.cat([tq.amin(1), lo.amin(1), one_lo, -inf.expand(1, 3), inf.expand(1, 3), pt])
    bhi = torch.cat([tq.amax(1), hi.amax(1), one_hi, inf.expand(1, 3), -inf.expand(1, 3), pt])
    T = blo.shape[0]
    bounds = {"+inf": torch.full((T,), float("inf"), device=dev),
              "0": torch.zeros(T, device=dev),
              "r2": torch.cat([r2.amax(1), r2.amax(1), torch.full((T - 32,), 4.0, device=dev)])}
    from kdtree_tpu_torch.kernels.frontier import CLUSTERS
    from kdtree_tpu_torch.ops import tile_query as tqm

    n, forced, paths = 0, 0, set()
    for cap in (1, 3, 6, 64, tree.num_buckets):
        for bname, bound in bounds.items():
            want = tqm._frontier(tree, blo, bhi, bound, cap)
            for sk in (None, 2, 64):
                if sk is not None and 2 * cap <= sk:
                    continue
                frontier_case(f"adversarial bound {bname}", tree, blo, bhi, bound, cap,
                              smem_keys=sk, want=want)
                n += 1
            # the same case at every cluster size, in shared memory and
            # forced into device memory
            for c in CLUSTERS:
                for sk in (None, 2):
                    rec = frontier_case(f"adversarial bound {bname}", tree, blo, bhi, bound,
                                        cap, smem_keys=sk, cluster=c, want=want)
                    paths.add((rec["cluster"], rec["path"]))
                    forced += 1
    return [f"adversarial frontier ({tree}, T={T}: 16 radius tiles, 16 range union boxes, "
            f"one infinite on axis 0, one infinite on every axis, an all-padding tile, a point "
            f"box): kernel == _frontier bit for bit in {n} cases on the plan (caps 1, 3, 6, 64, "
            f"{tree.num_buckets}; bound +inf, 0 and the rows' r2; shared keys a CTA at the "
            f"default, 2 and 64), and in {forced} more at every cluster size, in shared and in "
            f"device memory ({sorted(paths)}); {time.perf_counter() - t0:.1f} s"]


def phase_frontier(tree, sq, plan, engine, served, vq, smi):
    """Phase 4c: the frontier kernel against ``_frontier`` on the card (see
    the module docstring). Prints its lines; returns the record at the main
    collect shape."""
    from kdtree_tpu_torch.verbs import device as vd

    t0 = time.perf_counter()
    for line in adversarial_frontier(sq.device):
        say("frontier", line)
    kk = min(K, tree.n_real)
    tq = sq[: plan.qbatch].reshape(-1, plan.tile, DIM).contiguous()
    seed, main = frontier_tiled("main tiled batch", tree, tq, kk, plan.seeds, plan.cmax,
                                sweep=True)
    for rec in (seed, main):
        say("frontier", f"{frontier_line(rec)} [{smi}]")
        say("frontier", f"{rec['sweep']} [{smi}]")

    # the serve batches and the verbs, every call they make (overflow
    # retries included); the last call of each timed
    def check_calls(what, calls):
        assert calls, f"{what} made no frontier call"
        for i, (tr, blo, bhi, bound, cap) in enumerate(calls):
            rec = frontier_case(what, tr, blo, bhi, bound, cap, timed=i == len(calls) - 1)
            say("frontier", f"{cluster_sweep(f'{what}, call {i}', tr, blo, bhi, bound, cap)}"
                            f" [{smi}]")
        say("frontier", f"{frontier_line(rec)}; caps of its {len(calls)} calls "
                        f"{[c[4] for c in calls]} all bit-equal [{smi}]")
        return rec

    for q, _, _, rows, bucket, _, _ in served:
        if rows not in (7, 64, 1000):
            continue
        qp = np.concatenate([q, np.broadcast_to(q[-1], (bucket - rows, DIM))])
        with frontier_calls() as calls:
            engine.knn_batch(qp)
        check_calls(f"serve {rows} rows (bucket {bucket})", calls)
    half = np.float32(VERB_SIDE / 2)
    last = {}
    for rows in VERB_ROWS:
        q = vq[:rows]
        for verb, call in (("radius", lambda: vd.radius_search(tree, q, VERB_R)),
                           ("range", lambda: vd.range_search(tree, q - half, q + half))):
            with frontier_calls() as calls:
                call()
            last[verb] = calls[-1]
            check_calls(f"{verb} {rows} rows", calls)
    ceiling = vd._cap_ceiling(tree)
    for verb, (tr, blo, bhi, bound, cap) in last.items():
        if cap < ceiling:
            rec = frontier_case(f"{verb} 1000 rows at the cap ceiling", tr, blo, bhi, bound,
                                ceiling, timed=True)
            say("frontier", f"{frontier_line(rec)} [{smi}]")
    say("frontier", f"phase 4c in {time.perf_counter() - t0:.1f} s")
    return main


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


def topk_merge(pd, pi):
    """The merge as one library call: ``torch.topk(largest=False)`` over the
    same [T, TQ, S k] view as the plain merge, and a gather of the ids (the
    same k distances; ties may take other ids). Timed, never called by the
    port."""
    import torch

    T, S, TQ, k = pd.shape
    dd = pd.permute(0, 2, 1, 3).reshape(T, TQ, S * k)
    ii = pi.permute(0, 2, 1, 3).reshape(T, TQ, S * k)
    v, idx = torch.topk(dd, k, dim=-1, largest=False, sorted=True)
    return v, torch.gather(ii, -1, idx)


def graph_ms(fn, launches, reps):
    """Device ms of one ``fn()``: ``launches`` calls captured in one CUDA
    graph, replayed ``reps`` times (no host work between the launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    ms = cuda_ms(g.replay, reps) / launches
    del g
    return ms


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
        rec["merge_topk_ms"] = cuda_ms(lambda: topk_merge(*parts), reps)
        rec["merge_graph_ms"] = graph_ms(lambda: merge_partials(*parts), MERGE_GRAPH_LAUNCHES,
                                         reps)
        rec["merge_topk_graph_ms"] = graph_ms(lambda: topk_merge(*parts), MERGE_GRAPH_LAUNCHES,
                                              reps)
        tv, _ = topk_merge(*parts)
        assert torch.equal(tv, kd), f"torch.topk's distances differ from the merge at {name}"
        keys, hi, surv = tqm.merge_survivors(parts[0])
        rec["merge_survivors_max"] = int(surv.max())
        # what this data needs: each chunk's k-th word, the other survivors'
        # d2 (a surviving k-th is one of those words), the winners' ids and
        # the answer written
        kth_surv = int((keys[..., -1] <= hi[:, None]).sum())
        words = keys.shape[0] * keys.shape[1] + int(surv.sum()) - kth_surv \
            + int(torch.isfinite(kd).sum()) + 2 * kd.numel()
        rec["merge_bound_ms"] = words * 4 / HBM_BYTES_PER_S * 1e3
        # every partial buffer read once and the answer written
        rec["merge_bound_all_bytes_ms"] = (parts[0].numel() * 8 + kd.numel() * 8) \
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
    if S > 1:
        say("kernel", f"{name}: merge {rec['merge_ms']:.4f} ms ({rec['merge_graph_ms']:.4f} "
                      f"a launch in a CUDA graph), torch.topk + gather {rec['merge_topk_ms']:.4f} "
                      f"ms ({rec['merge_topk_graph_ms']:.4f} in a graph), plain stable sort "
                      f"{rec['merge_plain_ms']:.4f} ms, bound {rec['merge_bound_ms']:.6f} ms "
                      f"(bytes the data needs; {rec['merge_bound_all_bytes_ms']:.4f} with every "
                      f"partial buffer read once), up to {rec['merge_survivors_max']} survivors "
                      f"a row")
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

    from kdtree_tpu_torch.kernels.frontier import frontier
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

    # the batch's stages, for the breakdown (the plain frontier beside the
    # kernel), then the whole batch in a capture window
    T = tq.shape[0]
    blo, bhi = tq.amin(1), tq.amax(1)
    inf = torch.full((T,), float("inf"), device=dev)
    c0, l0, _ = frontier(tree, blo, bhi, inf, plan.seeds)
    sd, _ = scan_tiles(tree, tq, c0, l0, kk)
    bound = sd[..., -1].amax(1)
    recs["stages"] = {
        "hilbert sort": cuda_ms(lambda: tqm._sort_queries(sq[: plan.qbatch], plan.bits, 0), 5),
        "seed frontier": cuda_ms(lambda: frontier(tree, blo, bhi, inf, plan.seeds), 5),
        "seed scan": cuda_ms(lambda: scan_tiles(tree, tq, c0, l0, kk), 5),
        "collect frontier": cuda_ms(lambda: frontier(tree, blo, bhi, bound, plan.cmax), 5),
        "collect scan": recs["main"]["ms"],
    }
    recs["graph stages"] = {
        "seed frontier": graph_ms(lambda: frontier(tree, blo, bhi, inf, plan.seeds),
                                  FRONTIER_GRAPH_LAUNCHES, 5),
        "collect frontier": graph_ms(lambda: frontier(tree, blo, bhi, bound, plan.cmax),
                                     FRONTIER_GRAPH_LAUNCHES, 5),
    }
    recs["plain stages"] = {
        "seed frontier": cuda_ms(lambda: tqm._frontier(tree, blo, bhi, inf, plan.seeds), 5),
        "collect frontier": cuda_ms(lambda: tqm._frontier(tree, blo, bhi, bound, plan.cmax), 5),
    }

    def batch():
        # a window missed the first device work of a batch that began it (4
        # of its ~13 launches, one a frontier launch, on the card), so spin
        # kernels go first and are taken out of the count
        for _ in range(BATCH_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return tqm._tiled_batch_core(tree, sq[: plan.qbatch], K, plan.tile, plan.cmax,
                                     plan.seeds, plan.v, plan.tb, use_kernel=True)

    n0 = frontier.launches
    _, rep = captured(batch, dev)
    FRONTIER_LAUNCHES["5"] = frontier.launches - n0
    f_us, f_n = kernel_us(rep, "frontier_kernel")
    assert FRONTIER_LAUNCHES["5"] == 2 and f_n > 0, \
        f"one tiled batch: the timeline's frontier launches {f_n}, the wrapper's " \
        f"{FRONTIER_LAUNCHES['5']} (want 2: the seed and the collect pass)"
    spin_us, spins = kernel_us(rep, "spin_kernel")
    recs["batch"] = {"slices": rep["device"]["n_slices"] - spins, "spins": spins,
                     "busy_ms": (rep["device"]["busy_us"] - spin_us) / 1e3,
                     "frontier_ms": f_us / 1e3, "frontier_launches": f_n,
                     "top": [(m["module"][:40], m["n_slices"]) for m in rep["device"]["modules"]
                             if "spin_kernel" not in m["module"]][:8]}

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


def captured(fn, dev):
    """``fn()`` inside a capture window of the package's profiler
    (``kdtree_tpu_torch.obs.profile``, every thread and the card), the card
    synchronized before the window closes; returns (its result, the
    window's timeline report from ``kdtree_tpu_torch.obs.timeline``: each
    kernel, copy and memset counted once, never a range's device-side
    annotation; ``window_s`` added, the window's whole wall time). A
    capture that fails raises."""
    import shutil
    import tempfile

    from kdtree_tpu_torch.obs import profile, timeline

    log_dir = tempfile.mkdtemp(prefix="chip-smoke-trace-")
    try:
        t0 = time.perf_counter()
        with profile.capture(log_dir, dev) as cap:
            out = fn()
            _sync(dev)
        window_s = time.perf_counter() - t0  # start, fn, stop and export
        rep = timeline.parse_timeline(timeline.load_trace(cap.trace_file))
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    rep["window_s"] = window_s
    return out, rep


def kernel_us(rep, name):
    """(device µs, launches) of the kernels whose name holds ``name`` in a
    timeline report's per-kernel table."""
    rows = [m for m in rep["device"]["modules"] if name in m["module"]]
    return sum(m["busy_us"] for m in rows), sum(m["n_slices"] for m in rows)


def serve_profile(engine, served, dev):
    """Serve the 7-, 64- and 1000-row requests once more, each in a capture
    window, and split its device time by kernel: the scan kernels, the
    frontier kernel and the rest (the query sort, copies). Each answer must equal
    the one served before, and the timeline must name each kernel with
    the launches its wrapper counted in the window: the merge kernel too,
    on the 7- and 64-row requests, whose tiles are split. Returns one line
    per request."""
    import kdtree_tpu_torch.kernels.scan_knn as scan_mod

    lines = []
    for q, d2, ids, rows, bucket, _, _ in served:
        if rows not in (7, 64, 1000):
            continue
        qp = np.concatenate([q, np.broadcast_to(q[-1], (bucket - rows, DIM))])

        def request():
            t0 = time.perf_counter()
            out = engine.knn_batch(qp)
            _sync(dev)
            return out, (time.perf_counter() - t0) * 1e3

        s0, m0 = scan_mod.scan_tiles.launches, scan_mod.merge_partials.launches
        ((pd2, pids, _), wall), rep = captured(request, dev)
        counted = (scan_mod.scan_tiles.launches - s0, scan_mod.merge_partials.launches - m0)
        assert np.array_equal(np.asarray(pd2)[:rows], np.asarray(d2)) and \
            np.array_equal(np.asarray(pids)[:rows], np.asarray(ids)), \
            f"request of {rows} rows answered differently under the profiler"
        dev_us = rep["device"]["busy_us"]
        assert dev_us > 0, f"the capture of a {rows}-row request holds no device slices"
        scan, n_scan = kernel_us(rep, "scan_knn_kernel")
        merge, n_merge = kernel_us(rep, "scan_knn_merge_kernel")
        front, n_front = kernel_us(rep, "frontier_kernel")
        assert n_front > 0, f"{rows}-row request: the timeline does not name frontier_kernel"
        assert (n_scan, n_merge) == counted, \
            f"{rows}-row request: the timeline's scan/merge launches {(n_scan, n_merge)} " \
            f"!= the wrappers' {counted}"
        assert n_scan > 0 and (rows == 1000 or n_merge > 0), \
            f"{rows}-row request: the timeline does not name scan_knn_kernel and " \
            f"scan_knn_merge_kernel ({n_scan}, {n_merge} launches)"
        lines.append(f"request {rows} rows: {wall:.2f} ms in a capture window; device ms "
                     f"{dev_us / 1e3:.3f} (scan kernel {scan / 1e3:.3f} over {n_scan} and "
                     f"merge kernel {merge / 1e3:.3f} over {n_merge} launches, each = its "
                     f"wrapper's count; frontier kernel {front / 1e3:.3f} over {n_front} "
                     f"launches; other (sort, copies) {(dev_us - scan - merge - front) / 1e3:.3f}"
                     f"); the card idle "
                     f"{100 * (1 - dev_us / 1e3 / wall):.1f}% of the request (obs.timeline); "
                     f"the window with start, stop and export {rep['window_s']:.2f} s")
    return lines


def tiled_dispatch(name, tree, queries, plain_v, plain_reps=0):
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
    return time_shape(name, tree, stq, c, l, kk, plain_v, 20, plain_reps)


def dfs_launches_per_step(run, mod, want):
    """Device launches (kernels, copies, fills) of one DFS step on the
    card: torch.profiler over one extra eager round of the engine's steps,
    run just before the engine captures its round as a CUDA graph, divided
    by the steps of a round. ``run()`` answers the query through a DFS
    engine whose module ``mod`` calls ``_round_runner`` (the Morton, the
    classic or the bucketed DFS). An extra round is a valid schedule (each
    lane goes on with its own pops), so the answer must still equal
    ``want``. Returns (launches per step, note)."""
    import torch

    import kdtree_tpu_torch.ops.morton as morton_mod

    original = mod._round_runner
    seen = []

    def counted(steps, dev, st):
        if not seen:
            _, rep = captured(steps, dev)
            seen.append(rep["device"]["n_slices"])
        return original(steps, dev, st)

    mod._round_runner = counted
    try:
        d, i = run()
    finally:
        mod._round_runner = original
    assert torch.equal(d, want[0]) and torch.equal(i, want[1]), \
        "an extra DFS round changed the answer"
    n = seen[0]
    assert n > 0, "the capture of one DFS round holds no device slices"
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
    import kdtree_tpu_torch.ops.morton as morton_mod
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
    per_step, note = dfs_launches_per_step(lambda: morton_knn(tree, qs[:4096], k=K),
                                           morton_mod, (sd[:4096], si[:4096]))
    lines.append(f"DFS device launches per step: {per_step:.2f} ({note}; obs.timeline)")
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

    import kdtree_tpu_torch.kernels.knn_scan as knn_mod
    import kdtree_tpu_torch.kernels.scan_knn as scan_mod
    from kdtree_tpu_torch.obs import flight
    from kdtree_tpu_torch.obs.registry import get_registry
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.serve.engine import build_state
    from kdtree_tpu_torch.serve.server import make_server

    on_card = dev.type == "cuda"
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
        knn_mod.knn_scan.launches = 0  # the overlay's k-NN over the delta rows runs it
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
        KNN_LAUNCHES["7"] = knn_mod.knn_scan.launches
        if on_card:
            assert KNN_LAUNCHES["7"] > 0, "the served overlay rows never launched knn_scan"
        hist = srv.write_latency
        lines.append("writes over HTTP (64 new ids, 32 moved, 32 deleted incl. 1st and 16th "
                     "hits): client ms " + ", ".join(f"{op} {', '.join(f'{x:.2f}' for x in v)}"
                                                     for op, v in write_ms.items())
                     + "; server apply ms (mean) " + ", ".join(
                         f"{op} {hist[op].sum / max(hist[op].count, 1):.3f}" for op in hist)
                     + f"; {len(pool2)} queries after the writes exact vs oracle over the "
                     f"surviving points ({ties} tied slots); over those requests, whose delta "
                     f"overlay and masked rows the fused k-NN answers, knn_scan.launches="
                     f"{KNN_LAUNCHES['7']}")

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


def verb_split(tree, queries, r):
    """The frontier/fold split of one radius_search call in a capture
    window, read from the device time inside the ``verbs.frontier`` and
    ``verbs.fold`` ranges that verbs/device.py opens on every pass
    (overflow retries included; ``device.ranges`` of the timeline
    report). Returns one line."""
    from kdtree_tpu_torch.verbs import device as vd

    Q = queries.shape[0]

    def call():
        t0 = time.perf_counter()
        res = vd.radius_search(tree, queries, r)
        _sync(tree.device)
        return res, (time.perf_counter() - t0) * 1e3

    (res, wall), rep = captured(call, tree.device)
    ranges = rep["device"]["ranges"]
    front, fold = ranges.get("verbs.frontier"), ranges.get("verbs.fold")
    assert rep["device"]["busy_us"] > 0 and front and fold, \
        f"the capture holds no device time in the verbs' ranges: {sorted(ranges)}"
    whole = rep["device"]["busy_us"] / 1e3
    f_ms, d_ms = front["busy_us"] / 1e3, fold["busy_us"] / 1e3
    nf, nd = (rep["spans"][n]["count"] for n in ("verbs.frontier", "verbs.fold"))
    return (f"{Q}-row radius batch (r={r}, {int(res.counts.sum())} hits) in a capture window: "
            f"{wall:.2f} ms wall, {res.retries} overflow retries; device {whole:.3f} ms: "
            f"verbs.frontier {f_ms:.3f} ms over {nf} passes, verbs.fold {d_ms:.3f} ms over "
            f"{nd} passes, the rest (query sort, padding, copies) {whole - f_ms - d_ms:.3f} ms "
            f"(obs.timeline)")


def _check_verb(what, resp, ora, verb, degraded=None):
    """A verb answer against its oracle: counts equal; ids (and the
    distances, float64 sqrt of the f32 d2) equal row by row, in the
    canonical order; nothing truncated."""
    assert resp["truncated"] is False and resp["degraded"] == degraded, (what, resp.get("error"))
    assert resp["counts"] == ora.counts.astype(np.int64).tolist(), f"{what}: counts differ"
    rows = range(len(resp["counts"]))
    if verb == "radius":
        assert resp["ids"] == [ora.ids[q, :ora.counts[q]].astype(np.int64).tolist()
                               for q in rows], f"{what}: ids differ"
        assert resp["distances"] == [np.sqrt(ora.d2[q, :ora.counts[q]].astype(np.float64))
                                     .tolist() for q in rows], f"{what}: distances differ"
    elif verb == "range":
        assert resp["ids"] == [ora.ids[q, :ora.counts[q]].astype(np.int64).tolist()
                               for q in rows], f"{what}: ids differ"
    else:
        assert "ids" not in resp and "distances" not in resp, what


def phase_snapshot(dev, points, tree, here, smi, build_s):
    """Phase 8: snapshots, the blue/green follower and the query verbs (see
    the module docstring). Returns the lines to print."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    import torch

    import kdtree_tpu_torch.kernels.frontier as frontier_mod
    import kdtree_tpu_torch.kernels.pair_d2 as pair_mod
    import kdtree_tpu_torch.kernels.scan_knn as scan_mod
    import kdtree_tpu_torch.kernels.verb_fold as fold_mod
    from kdtree_tpu_torch import snapshot as snap
    from kdtree_tpu_torch.obs import flight
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.serve.engine import ServeEngine, batch_bucket, build_state
    from kdtree_tpu_torch.serve.server import make_server
    from kdtree_tpu_torch.verbs import oracle as vo

    on_card = dev.type == "cuda"
    dev_args = [] if on_card else ["--device", str(dev)]
    lines = []
    tmp = tempfile.mkdtemp(prefix="chip-smoke-snapshots-")
    # the port's plan store for this run (and the serve subprocess) only
    os.environ["KDTREE_TPU_TORCH_PLAN_CACHE"] = os.path.join(tmp, "plans")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def last_event(kind):
        ev = [e for e in flight.recorder().snapshot() if e["type"] == kind]
        return ev[-1] if ev else {}

    servers = []
    follower = None
    try:
        # 1. the round trip: save, load with the checksum pass, same arrays
        # and the same answers as the built tree
        d = os.path.join(tmp, "roundtrip")
        sync()
        t0 = time.perf_counter()
        man = snap.save_snapshot(d, tree, plan_keys=snap.plan_keys_for(tree, K, MAX_BATCH))
        save_s = time.perf_counter() - t0
        nbytes = sum(seg["bytes"] for seg in man["segments"].values())
        t0 = time.perf_counter()
        loaded, man2 = snap.load_snapshot(d, device=dev)
        sync()
        load_s = time.perf_counter() - t0
        ev = last_event("snapshot.load")
        for name in ("node_lo", "node_hi", "bucket_pts", "bucket_gid"):
            assert torch.equal(getattr(tree, name), getattr(loaded, name)), name
        assert (loaded.n_real, loaded.num_levels) == (tree.n_real, tree.num_levels)
        built, from_snap = ServeEngine(tree, K), ServeEngine(loaded, K)
        for rows in (1, 7, 64, 1000):
            q = generate_queries(SEED + 810 + rows, DIM, rows, device=dev).cpu().numpy()
            b = batch_bucket(rows, MAX_BATCH)
            qp = np.concatenate([q, np.broadcast_to(q[-1], (b - rows, DIM))])
            a, c = built.knn_batch(qp), from_snap.knn_batch(qp)
            assert np.array_equal(a[0], c[0]) and np.array_equal(a[1], c[1]), rows
        lines.append(f"snapshot of the 2^{N_POINTS.bit_length() - 1}-point tree: save "
                     f"{save_s:.3f} s ({nbytes} bytes in 4 segments, each array fetched once, "
                     f"sha256 while writing); load_snapshot {load_s:.3f} s "
                     f"(sha256 pass {ev.get('verify_seconds', float('nan')):.3f} s, "
                     f"host-to-device copies {ev.get('copy_seconds', float('nan')):.3f} s) "
                     f"beside phase 4's build {build_s:.3f} s; loaded arrays torch.equal to the "
                     "built ones; 1-, 7-, 64- and 1000-row requests answer the same from both")
        del built, from_snap

        # 2. blue/green: a primary that emits on every epoch swap, and a
        # read-only secondary that follows its directory
        bg = os.path.join(tmp, "bluegreen")

        def sink(t, epoch):
            keys = snap.plan_keys_for(t, K, MAX_BATCH)
            snap.save_snapshot(bg, t, epoch=epoch, plan_keys=keys,
                               plan_profiles=snap.collect_plan_profiles(keys))

        t0 = time.perf_counter()
        pstate = build_state(tree=loaded, k=K, max_batch=MAX_BATCH,
                             max_delta_rows=SNAP_DELTA_ROWS, snapshot_sink=sink,
                             meta={"snapshot": {"dir": bg, "version": 1, "epoch": 0,
                                                "role": "primary"}})
        sink(pstate.engine.tree, pstate.engine.epoch)  # the bootstrap emit
        psrv = make_server(pstate, port=0)
        psrv.start()
        servers.append(psrv)
        stree, sman = snap.load_snapshot(bg, device=dev)
        blk = {"dir": bg, "version": sman["version"], "epoch": sman["epoch"],
               "role": "secondary"}
        sstate = build_state(tree=stree, k=K, max_batch=MAX_BATCH, read_only=True,
                             epoch0=sman["epoch"], meta={"snapshot": blk})
        ssrv = make_server(sstate, port=0, queue_rows=16 * MAX_BATCH)
        ssrv.start()
        servers.append(ssrv)
        up_s = time.perf_counter() - t0
        pport, sport = psrv.server_address[1], ssrv.server_address[1]

        def on_adopt(m, _blk=blk):
            _blk["version"] = int(m.get("version", 0))
            _blk["epoch"] = int(m.get("epoch", 0))

        from kdtree_tpu_torch.snapshot import SnapshotFollower

        follower = SnapshotFollower(sstate.engine, bg, poll_s=0.2,
                                    start_version=sman["version"], on_adopt=on_adopt)
        follower.start()
        # the secondary's warmup is over: its launches are counted from here
        scan_mod.scan_tiles.launches = 0
        scan_mod.merge_partials.launches = 0
        st, _, resp = _http(sport, "POST", "/v1/upsert",
                            {"ids": [0], "points": [[0.0] * DIM]})
        assert st == 403 and "primary" in resp["error"], (st, resp)
        lines.append(f"primary (snapshot_save, bootstrap emit v1) and read-only secondary "
                     f"(load_snapshot + follower, poll 0.2 s) up with their warmup ladders "
                     f"in {up_s:.3f} s; a write to the secondary: 403")

        n = points.shape[0]
        pool = generate_queries(SEED + 900, DIM, 256, device=dev).cpu().numpy()
        new_pts = (pool[:SNAP_DELTA_ROWS] + np.float32(0.01)).astype(np.float32)
        ext = torch.cat([points, torch.as_tensor(new_pts, device=dev)])
        o0, o1 = Oracle(points, pool), Oracle(ext, pool)
        stop_q = threading.Event()
        during, errors = [], []

        def reader(i):
            j = 0
            try:
                while not stop_q.is_set():
                    off = (i * 37 + j * 8) % (len(pool) - 8)
                    trace = f"bg-{i}-{j}"
                    t = time.perf_counter()
                    st, _, resp = _http(sport, "POST", "/v1/knn",
                                        {"queries": pool[off:off + 8].tolist()},
                                        headers={"X-Request-Id": trace})
                    ms = (time.perf_counter() - t) * 1e3
                    # the epoch that answered: the batch event names its
                    # traces, and is recorded before the answer leaves
                    epochs = [e["epoch"] for e in flight.recorder().snapshot()
                              if e["type"] == "serve.batch" and trace in e.get("traces", ())]
                    during.append((off, st, resp, ms, epochs[-1] if epochs else None))
                    j += 1
            except Exception as e:  # re-raised below, on the main thread
                errors.append(e)

        readers = [threading.Thread(target=reader, args=(i,)) for i in range(SNAP_READERS)]
        for t in readers:
            t.start()
        time.sleep(0.2)
        t_w = time.perf_counter()
        st, _, resp = _http(pport, "POST", "/v1/upsert",
                            {"ids": list(range(n, n + SNAP_DELTA_ROWS)),
                             "points": new_pts.tolist()})
        assert st == 200 and resp["backlog"] >= SNAP_DELTA_ROWS, (st, resp)
        version = 1
        while version != 2:
            assert time.perf_counter() - t_w < 300, "the secondary did not adopt v2 in 300 s"
            time.sleep(0.05)
            st, _, h = _http(sport, "GET", "/healthz")
            assert st == 200, st
            version = h["snapshot"]["version"]
        adopt_s = time.perf_counter() - t_w
        assert h["epoch"] == 1 and h["snapshot"]["epoch"] == 1 and h["read_only"] is True, h
        time.sleep(0.5)  # the readers go on over the adopted epoch
        stop_q.set()
        for t in readers:
            t.join()
        assert not errors, errors
        ties, by_epoch = 0, {0: 0, 1: 0}
        for off, st, resp, _, epoch in during:
            assert st == 200 and epoch in (0, 1), (st, epoch, resp.get("error"))
            by_epoch[epoch] += 1
            ties += (o0 if epoch == 0 else o1).check(np.arange(off, off + 8), resp, K,
                                                    f"secondary answer at epoch {epoch}")
        assert by_epoch[1] > 0, "no answer came from the adopted epoch"
        sv = last_event("snapshot.save")
        ld = last_event("snapshot.load")
        sw = last_event("snapshot.follow_swap")
        lines.append(f"64 writes to the primary -> epoch rebuild -> sink v2 -> the secondary's "
                     f"/healthz shows version 2, epoch 1 after {adopt_s:.3f} s (v2 save "
                     f"{sv.get('seconds', float('nan')):.3f} s, its load "
                     f"{ld.get('seconds', float('nan')):.3f} s, follow_swap at "
                     f"{sw.get('ts', float('nan')) - sv.get('ts', float('nan')):.3f} s after "
                     f"the save, flight ring); {len(during)} reader requests of 8 rows "
                     f"through the adoption ({by_epoch[0]} answered by epoch 0, {by_epoch[1]} "
                     f"by epoch 1), each exact vs the oracle over its epoch ({ties} tied slots); "
                     f"HTTP ms median {np.median([x[3] for x in during]):.2f} max "
                     f"{max(x[3] for x in during):.2f}")

        # 3. the verbs over HTTP on the secondary (epoch 1: the 2^24 points
        # and the 64 written ones), every answer against verbs/oracle.py.
        # Each request's queries are the first rows of one query set, so
        # one oracle answer per verb serves every size (rows are
        # independent, and an answer is checked by its counts' prefix)
        vq = generate_queries(SEED + 950, DIM, MAX_BATCH + 1, device=dev).cpu().numpy()
        half = np.float32(VERB_SIDE / 2)
        t = time.perf_counter()
        rad_all = vo.radius_oracle(ext, vq, VERB_R)
        box_all = vo.range_oracle(ext, vq - half, vq + half)
        oracle_s = time.perf_counter() - t

        def head(res, rows):
            return res._replace(counts=res.counts[:rows],
                                d2=None if res.d2 is None else res.d2[:rows],
                                ids=res.ids[:rows])

        http_ms, eng_ms, retries = {}, {}, {}
        fold_mod.radius_fold.launches = fold_mod.range_fold.launches = 0
        pair_mod.pair_d2.launches = 0
        frontier_mod.frontier.launches = 0
        for rows in VERB_ROWS:
            q = vq[:rows]
            lo, hi = q - half, q + half
            rad, box = head(rad_all, rows), head(box_all, rows)
            assert int(rad.counts.sum()) > 0 and int(box.counts.sum()) > 0, "vacuous verbs"
            b = batch_bucket(rows, MAX_BATCH)
            qp = np.concatenate([q, np.broadcast_to(q[-1], (b - rows, DIM))])
            lop = np.concatenate([lo, np.broadcast_to(lo[-1], (b - rows, DIM))])
            hip = np.concatenate([hi, np.broadcast_to(hi[-1], (b - rows, DIM))])
            rp = np.full(b, VERB_R, np.float32)
            for verb, path, body, ora, call in (
                ("radius", "/v1/radius", {"queries": q.tolist(), "r": VERB_R}, rad,
                 lambda: sstate.engine.radius_batch(qp, rp)),
                ("range", "/v1/range", {"lo": lo.tolist(), "hi": hi.tolist()}, box,
                 lambda: sstate.engine.range_batch(lop, hip)),
                ("count (radius)", "/v1/count", {"queries": q.tolist(), "r": VERB_R}, rad,
                 lambda: sstate.engine.radius_batch(qp, rp, with_ids=False)),
                ("count (box)", "/v1/count", {"lo": lo.tolist(), "hi": hi.tolist()}, box,
                 lambda: sstate.engine.range_batch(lop, hip, with_ids=False)),
            ):
                t = time.perf_counter()
                st, _, resp = _http(sport, "POST", path, body)
                http_ms[(verb, rows)] = (time.perf_counter() - t) * 1e3
                assert st == 200, (verb, rows, st, resp)
                _check_verb(f"{verb} {rows} rows", resp, ora, verb.split()[0])
                t = time.perf_counter()
                res = call()
                eng_ms[(verb, rows)] = (time.perf_counter() - t) * 1e3
                retries[(verb, rows)] = res.retries
                assert res.counts[:rows].tolist() == resp["counts"], (verb, rows)
        big = vq[:MAX_BATCH + 1]
        t = time.perf_counter()
        st, _, resp = _http(sport, "POST", "/v1/radius", {"queries": big.tolist(), "r": VERB_R})
        big_ms = (time.perf_counter() - t) * 1e3
        assert st == 200, (st, resp)
        _check_verb("oversized radius", resp, rad_all, "radius", degraded="oversized")
        verb_launches = (fold_mod.radius_fold.launches, fold_mod.range_fold.launches,
                         pair_mod.pair_d2.launches, frontier_mod.frontier.launches)
        FOLD_LAUNCHES["verb_radius_fold"], FOLD_LAUNCHES["verb_range_fold"] = verb_launches[:2]
        FOLD_LAUNCHES["pair_d2"] += verb_launches[2]
        FRONTIER_LAUNCHES["8"] = verb_launches[3]
        if on_card:
            assert min(verb_launches) > 0, f"a verb kernel never launched: {verb_launches}"
        verbs_seen = sorted({v for v, _ in http_ms}, key=[
            "radius", "range", "count (radius)", "count (box)"].index)
        lines.append("verbs over HTTP on the secondary, every answer equal to verbs/oracle.py "
                     "on the same device (counts, ids, distances); HTTP ms / engine ms (overflow "
                     "retries) by verb and rows: " + "; ".join(
                         f"{v} " + ", ".join(
                             f"{rows}: {http_ms[(v, rows)]:.2f} / {eng_ms[(v, rows)]:.2f} "
                             f"({retries[(v, rows)]})" for rows in VERB_ROWS)
                         for v in verbs_seen)
                     + f"; one {MAX_BATCH + 1}-row radius request (the oracle in its handler "
                     f"thread): {big_ms:.2f} ms, exact; the checks' radius and range oracles "
                     f"over {MAX_BATCH + 1} rows: {oracle_s:.2f} s; over these requests "
                     f"radius_fold.launches={verb_launches[0]}, range_fold.launches="
                     f"{verb_launches[1]}, pair_d2.launches={verb_launches[2]}, "
                     f"frontier.launches={verb_launches[3]}")

        # the snapshot-served path alone: the secondary's k-NN requests
        before = scan_mod.scan_tiles.launches
        for rows in (1, 64, len(pool)):
            st, _, resp = _http(sport, "POST", "/v1/knn", {"queries": pool[:rows].tolist()})
            assert st == 200
            o1.check(np.arange(rows), resp, K, f"secondary {rows}-row k-NN")
        served_launches = scan_mod.scan_tiles.launches - before
        follower.stop()
        follower = None
        ssrv.stop()
        servers.remove(ssrv)
        launches = (scan_mod.scan_tiles.launches, scan_mod.merge_partials.launches)
        psrv.stop()
        servers.remove(psrv)
        if on_card:
            assert served_launches > 0, "the snapshot-served k-NN never launched the scan kernel"
            assert launches[0] > 0, "no scan kernel launch after the secondary's warmup"
        lines.append(f"scan kernel launches from the end of the secondary's warmup to its "
                     f"stop: scan_tiles.launches={launches[0]}, "
                     f"merge_partials.launches={launches[1]} (the secondary's requests and "
                     f"adoption prewarm, and the primary's epoch-rebuild prewarm); of which "
                     f"the secondary's three k-NN requests after the adoption: "
                     f"{served_launches}")
        lines.append(verb_split(sstate.engine.tree, vq[:1000], VERB_R))

        # 4. the CLI: build --save, then serve --snapshot as a subprocess
        cd = os.path.join(tmp, "cli")
        n_cli = SNAP_CLI_N
        t0 = time.perf_counter()
        out, _ = run_cli([*dev_args, "--generator", "threefry", "--engine", "morton", "build",
                          "--seed", str(SEED), "--dim", str(DIM), "--n", str(n_cli),
                          "--save", cd])
        cli_build_s = time.perf_counter() - t0
        assert out.startswith("serving snapshot v1 (epoch 0, n="), out
        cmd = [sys.executable, "-m", "kdtree_tpu_torch", *dev_args, "serve", "--snapshot", cd,
               "--k", str(K), "--max-batch", "64", "--port", "0"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=here, stderr=subprocess.PIPE,
                                stdout=subprocess.DEVNULL, text=True)
        try:
            err, port = [], None
            while port is None:
                line = proc.stderr.readline()
                if not line:
                    raise AssertionError(f"serve exited {proc.wait()} before ready: "
                                         f"{''.join(err)}")
                err.append(line)
                if line.startswith("ready:"):
                    port = int(line.rsplit(" ", 1)[1])
            ready_s = time.perf_counter() - t0
            assert any(x.startswith("snapshot loaded: v1 epoch 0") for x in err), err
            cpts = generate_points_rowwise(SEED, DIM, n_cli, device=dev)
            cq = generate_queries(SEED + 960, DIM, 5, device=dev).cpu().numpy()
            st, _, resp = _http(port, "POST", "/v1/knn", {"queries": cq.tolist(), "k": 4})
            assert st == 200, (st, resp)
            Oracle(cpts, cq).check(np.arange(5), resp, 4, "serve --snapshot k-NN answer")
            st, _, resp = _http(port, "POST", "/v1/radius",
                                {"queries": cq.tolist(), "r": SNAP_CLI_R})
            assert st == 200, (st, resp)
            ora = vo.radius_oracle(cpts, cq, SNAP_CLI_R)
            assert int(ora.counts.sum()) > 0, "vacuous CLI radius"
            _check_verb("serve --snapshot radius answer", resp, ora, "radius")
            proc.send_signal(signal.SIGTERM)
            rest = proc.communicate(timeout=120)[1]
            err.append(rest)
            assert proc.returncode == 0 and "drained; bye" in rest, (proc.returncode,
                                                                      "".join(err))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        lines.append(f"build --save at 2^{n_cli.bit_length() - 1} points in {cli_build_s:.2f} s, "
                     f"then python -m kdtree_tpu_torch serve --snapshot: 'snapshot loaded: v1 "
                     f"epoch 0' and ready in {ready_s:.2f} s; one 5-row k=4 /v1/knn and one "
                     f"5-row /v1/radius (r={SNAP_CLI_R}, {int(ora.counts.sum())} hits) answer "
                     f"exact vs the oracle; SIGTERM -> exit 0 with 'drained; bye'")
    finally:
        if follower is not None:
            follower.stop()
        for srv in servers:
            srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return [f"{line} [{smi}]" if "ms" in line or " s" in line else line for line in lines]


def phase_wide(dev, smi):
    """Phase 9a: the D > 32 arithmetic on the card. Prints its lines as it
    goes; returns the largest kernel-vs-plain and tiled-vs-oracle
    difference."""
    import torch

    import kdtree_tpu_torch.kernels.scan_knn as scan_mod
    from kdtree_tpu_torch.ops import bruteforce
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.ops.morton import build_morton

    max_err = 0.0
    rng = np.random.default_rng(SEED + 9)
    for d in WIDE_DIMS:
        t0 = time.perf_counter()
        pts = generate_points_rowwise(SEED + d, d, WIDE_N, device=dev)
        tree = build_morton(pts, bucket_cap=BUCKET)
        qs = generate_queries(SEED + d + 1, d, WIDE_Q, device=dev)
        _sync(dev)
        build_s = time.perf_counter() - t0
        # the plan the timed run uses, resolved once: its source is printed
        p = tqm.plan_tiled(WIDE_Q, d, tree.n_real, tree.num_buckets, tree.bucket_size, K,
                           device=dev)
        assert p.qbatch >= WIDE_Q, f"D={d}: more than one batch"
        before = scan_mod.scan_tiles.launches
        t0 = time.perf_counter()
        d2, ids = tqm.morton_knn_tiled(tree, qs, k=K, plan=p)
        _sync(dev)
        run_s = time.perf_counter() - t0
        launches = scan_mod.scan_tiles.launches - before
        assert launches > 0, f"D={d}: the tiled run never launched the scan kernel"
        # the final collect dispatch (the cap grown as the run's overflow
        # retry grows it): kernel against the plain scan
        s, _ = tqm._sort_queries(qs, p.bits, (-WIDE_Q) % p.qbatch)
        stq = s.reshape(-1, p.tile, d).contiguous()
        kk = min(K, tree.n_real)
        cand, lb = collect_inputs(tree, stq, kk, p.seeds, p.cmax, grow=True)
        kd, ki, S = kernel_run(tree, stq, cand, lb, kk, None)
        t0 = time.perf_counter()
        pd, pi = tqm._scan_tiles(tree, stq, cand, lb, kk, 1, stq.shape[0])
        _sync(dev)
        plain_s = time.perf_counter() - t0
        assert torch.equal(kd, pd) and torch.equal(ki, pi), f"D={d}: kernel != plain"
        fin = torch.isfinite(pd)
        max_err = max(max_err, float((kd[fin] - pd[fin]).abs().max()) if fin.any() else 0.0)
        sample = torch.as_tensor(rng.choice(WIDE_Q, WIDE_SAMPLE, replace=False), device=dev)
        od, oi = bruteforce.knn(pts, qs[sample], k=K, method="exact")
        ties = check_answer(pts, qs[sample], d2[sample], ids[sample], K, f"D={d} tiled sample",
                            want=(od, oi))
        max_err = max(max_err, float((d2[sample] - od).abs().max()))
        if d == WIDE_DIMS[0]:
            vq = (qs[:max(VERB_ROWS)] * WIDE_VERB_SCALE).cpu().numpy()
            phase_fold(tree, vq, WIDE_VERB_R, WIDE_VERB_SIDE, smi, main=False)
            wide_frontier(tree, stq, kk, p.seeds, cand.shape[1], vq, smi)
        say("recall",
            f"D={d}: 2^{WIDE_N.bit_length() - 1} points built in {build_s:.3f} s; "
            f"morton_knn_tiled {WIDE_Q} queries "
            f"k={K} in {run_s:.3f} s ({launches} scan launches, plan tile={p.tile} "
            f"cmax={p.cmax} {p.source}); final collect dispatch (T={stq.shape[0]} "
            f"C={cand.shape[1]}, {S} block(s)/tile) kernel == plain scan bit for bit (plain "
            f"{plain_s:.2f} s); {WIDE_SAMPLE}-query sample exact vs the oracle ({ties} tied "
            f"slots) [{smi}]")
        del pts, tree, qs, d2, ids, cand, lb, kd, ki, pd, pi
    return max_err


def wide_frontier(tree, stq, kk, seeds, cap, vq, smi):
    """Phase 9a's frontier check on the D = 47 tree: the tiled run's seed
    and final collect descents, and every call of a 1,000-row radius and
    range search (``vq``, ``WIDE_VERB_R``, cubes of ``WIDE_VERB_SIDE``),
    the last of each timed."""
    from kdtree_tpu_torch.verbs import device as vd

    tag = f"2^{tree.n_real.bit_length() - 1} x {tree.dim}-D"
    for rec in frontier_tiled(f"tiled batch, {tag}", tree, stq, kk, seeds, cap):
        say("recall", f"{frontier_line(rec)} [{smi}]")
    half = np.float32(WIDE_VERB_SIDE / 2)
    q = vq[:max(VERB_ROWS)]
    for verb, call in (("radius", lambda: vd.radius_search(tree, q, WIDE_VERB_R)),
                       ("range", lambda: vd.range_search(tree, q - half, q + half))):
        with frontier_calls() as calls:
            call()
        for i, (tr, blo, bhi, bound, c) in enumerate(calls):
            rec = frontier_case(f"{verb} {len(q)} rows, {tag}", tr, blo, bhi, bound, c,
                                timed=i == len(calls) - 1)
        say("recall", f"{frontier_line(rec)}; caps of its {len(calls)} calls "
                      f"{[c[4] for c in calls]} all bit-equal [{smi}]")


def phase_recall(dev, points, tree, smi):
    """Phase 9b-d: the recall harness, the dial over HTTP with the ladder,
    and ``tune``, on phase 4's tree (see the module docstring). Prints its
    lines as it goes."""
    import os
    import shutil
    import tempfile

    import torch

    import kdtree_tpu_torch.kernels.scan_knn as scan_mod
    from kdtree_tpu_torch import approx, tuning
    from kdtree_tpu_torch.approx import recall as rc
    from kdtree_tpu_torch.obs.registry import get_registry
    from kdtree_tpu_torch.ops import bruteforce
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops._arith import sq_dist
    from kdtree_tpu_torch.ops.generate import generate_queries
    from kdtree_tpu_torch.serve.engine import build_state
    from kdtree_tpu_torch.serve.server import make_server
    from kdtree_tpu_torch.tuning import tuner

    def note(line):
        say("recall", f"{line} [{smi}]" if "ms" in line or " s" in line else line)

    # the calibration and tune's winner go to a store of their own, and the
    # run's store is back in place for the phases after this one
    tmp = tempfile.mkdtemp(prefix="chip-smoke-recall-")
    run_store = os.environ.get("KDTREE_TPU_TORCH_PLAN_CACHE")
    os.environ["KDTREE_TPU_TORCH_PLAN_CACHE"] = tmp
    kk = min(K, tree.n_real)
    try:
        # (b) the recall harness
        queries = generate_queries(SEED + 900, DIM, RECALL_Q, device=dev)
        t0 = time.perf_counter()
        block = rc.sweep_recall(tree, queries, k=K)
        sweep_s = time.perf_counter() - t0
        curve = block["curve"]
        recalls = [r["recall"] for r in curve]
        assert recalls == sorted(recalls), f"recall not monotone in the cap: {recalls}"
        assert recalls[-1] == 1.0 and curve[-1]["visit_cap"] == tree.num_buckets
        plan = tqm.plan_tiled(RECALL_Q, DIM, tree.n_real, tree.num_buckets,
                              tree.bucket_size, K, use_kernel=True, device=dev)
        ed, ei = tqm.morton_knn_tiled(tree, queries, k=K, plan=plan)
        fd, fi = approx.morton_knn_approx(tree, queries, k=K, visit_cap=tree.num_buckets,
                                          plan=plan)
        _sync(dev)
        assert torch.equal(ed, fd) and torch.equal(ei, fi), "full cap != exact run"
        cal = rc.persist_calibration(tree, RECALL_Q, DIM, K, block)
        caps = cal["recall_caps"]
        assert cal["persisted"] and "0.9" in caps, cal
        note(f"sweep_recall {RECALL_Q} queries k={K} over {len(curve)} caps in "
                     f"{sweep_s:.2f} s (plan tile={plan.tile} cmax={plan.cmax}), exact "
                     f"{block['exact_qps']:.0f} q/s; recall monotone, full cap byte-identical "
                     f"to the exact run; calibration {caps}")
        note("curve (cap recall q/s speedup): " + "; ".join(
            f"{r['visit_cap']} {r['recall']:.6f} {r['qps']:.0f} {r['speedup']:.3f}x"
            for r in curve))
        # the kernel against the plain scan at a truncated cap, one batch
        cap = int(caps["0.9"])
        sq, _ = tqm._sort_queries(queries, plan.bits, (-RECALL_Q) % plan.qbatch)
        stq = sq[:plan.qbatch].reshape(-1, plan.tile, DIM).contiguous()
        cand, lb = collect_inputs(tree, stq, kk, plan.seeds, plan.cmax, grow=True)
        assert cap < cand.shape[1], (cap, cand.shape)
        cand, lb = cand[:, :cap].contiguous(), lb[:, :cap].contiguous()
        kd, ki, S = kernel_run(tree, stq, cand, lb, kk, None)
        pd, pi = tqm._scan_tiles(tree, stq, cand, lb, kk, 1, stq.shape[0])
        _sync(dev)
        assert torch.equal(kd, pd) and torch.equal(ki, pi), "kernel != plain at a truncated cap"
        note(f"truncated cap {cap} (the 0.9 calibration; T={stq.shape[0]}, "
                     f"{S} block(s)/tile): kernel == plain scan bit for bit")

        # (c) the dial over HTTP with the ladder and the sampler
        pool = generate_queries(SEED + 901, DIM, max(RECALL_ROWS), device=dev)
        od, oi = bruteforce.knn(points, pool, k=K)
        pool_h, od_h, oi_h = pool.cpu().numpy(), od.cpu().numpy(), oi.cpu().numpy()
        # the sampler ticks once at start, then not for an hour: the ladder
        # is stepped by hand below
        period = os.environ.get("KDTREE_TPU_HISTORY_PERIOD_S")
        os.environ["KDTREE_TPU_HISTORY_PERIOD_S"] = "3600"
        state = build_state(tree=tree, k=K, max_batch=MAX_BATCH, ladder_enabled=True)
        hist = state.slo_engine.history
        ticks0 = len(hist.samples())
        srv = make_server(state, port=0, recall_sample=1.0)
        try:
            srv.start(warmup_buckets=[8, 64, 1024])
        finally:
            if period is None:
                os.environ.pop("KDTREE_TPU_HISTORY_PERIOD_S", None)
            else:
                os.environ["KDTREE_TPU_HISTORY_PERIOD_S"] = period
        port = srv.server_address[1]
        try:
            deadline = time.monotonic() + 60
            while len(hist.samples()) <= ticks0 and time.monotonic() < deadline:
                time.sleep(0.01)  # the start tick: no other tick races ours

            def knn(rows, **extra):
                st, _, resp = _http(port, "POST", "/v1/knn",
                                    {"queries": pool_h[:rows].tolist(), "k": K, **extra})
                assert st == 200, resp
                dist = np.asarray(resp["distances"], dtype=np.float64)
                d2 = (dist * dist).astype(np.float32)
                ids = np.asarray(resp["ids"], dtype=np.int64)
                again = sq_dist(pool[:rows, None, :], points[torch.as_tensor(ids, device=dev)])
                assert np.array_equal(again.cpu().numpy(), d2), "a returned (id, d2) is not true"
                return resp, rc.recall_at_k(ids, oi_h[:rows]), d2

            # the sampler re-answers every approximate batch exactly on the
            # batch worker, launching the kernel too: its launches are
            # counted apart and taken off, so what is asserted is the
            # approximate dispatches' own
            shadow = {"calls": 0, "scan": 0, "merge": 0}
            sample_batch = srv.batcher._shadow_sample

            def counted_sample(*a, **kw):
                s0 = scan_mod.scan_tiles.launches
                m0 = scan_mod.merge_partials.launches
                try:
                    return sample_batch(*a, **kw)
                finally:
                    shadow["scan"] += scan_mod.scan_tiles.launches - s0
                    shadow["merge"] += scan_mod.merge_partials.launches - m0
                    shadow["calls"] += 1

            srv.batcher._shadow_sample = counted_sample
            scan_mod.scan_tiles.launches = 0
            scan_mod.merge_partials.launches = 0
            out = []
            for target in (0.9, 0.99):
                for rows in RECALL_ROWS:
                    t = time.perf_counter()
                    resp, rec, _ = knn(rows, recall_target=target)
                    ms = (time.perf_counter() - t) * 1e3
                    assert resp["gear"] == f"approx:{target:g}" and resp["degraded"] is None
                    out.append(f"{target:g}/{rows} rows recall {rec:.4f} {ms:.2f} ms")
            # one batch per request, each sampled after its answer left
            deadline = time.monotonic() + 60
            while shadow["calls"] < len(out) and time.monotonic() < deadline:
                time.sleep(0.01)
            assert shadow["calls"] == len(out), shadow
            approx_launches = scan_mod.scan_tiles.launches - shadow["scan"]
            approx_merges = scan_mod.merge_partials.launches - shadow["merge"]
            assert approx_launches > 0, "no scan launch over the approximate requests"
            note(f"/v1/knn under recall_target (target/rows): " + ", ".join(out)
                         + f"; gear echoed, every (id, d2) true; scan launches of these "
                         f"{len(out)} approximate dispatches: {approx_launches} (merge "
                         f"{approx_merges}); of their {shadow['calls']} exact shadow "
                         f"samples: {shadow['scan']} (merge {shadow['merge']})")
            vq = pool_h[:64]
            for verb, body in (("radius", {"queries": vq.tolist(), "r": VERB_R}),
                               ("count", {"queries": vq.tolist(), "r": VERB_R}),
                               ("range", {"lo": (vq - VERB_SIDE / 2).tolist(),
                                          "hi": (vq + VERB_SIDE / 2).tolist()})):
                st, _, ex = _http(port, "POST", f"/v1/{verb}", body)
                st2, _, ap = _http(port, "POST", f"/v1/{verb}", dict(body, recall_target=0.5))
                assert st == st2 == 200 and ap["gear"] == "approx:0.5", ap
                ec, ac = np.asarray(ex["counts"]), np.asarray(ap["counts"])
                assert (ac <= ec).all() and not ex["truncated"], verb
                assert ap["truncated"] or (ac == ec).all(), f"{verb}: short and not truncated"
                note(f"/v1/{verb} 64 rows at recall_target 0.5: {int(ac.sum())} of "
                             f"{int(ec.sum())} exact hits, truncated={ap['truncated']}")
            lad = srv.ladder
            lad.tick(burning=True)
            assert lad.tick(burning=True) == 1
            resp, rec, _ = knn(64)
            assert resp["degraded"] == "approx:0.99" == resp["gear"], resp["degraded"]
            for _ in range(4):
                lad.tick(burning=True)
            assert lad.spec().brute
            t = time.perf_counter()
            resp, _, d2 = knn(7)
            brute_ms = (time.perf_counter() - t) * 1e3
            assert resp["degraded"] == "brute-deadline" and np.array_equal(
                d2, od_h[:7]), "brute-deadline answer"
            for _ in range(15):
                lad.tick(burning=False)
            assert lad.gear() == 0
            resp, _, d2 = knn(64)
            assert resp["degraded"] is None and "gear" not in resp
            assert np.array_equal(d2, od_h[:64]), "the exact gear's answer"
            deadline = time.monotonic() + 60
            while get_registry().snapshot()["gauges"].get("kdtree_recall_sampled") is None \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            sampled = get_registry().snapshot()["gauges"].get("kdtree_recall_sampled")
            assert sampled is not None, "kdtree_recall_sampled never set"
            note(f"ladder: two burning ticks -> approx-0.99 (64 rows flagged degraded, "
                         f"recall {rec:.4f}), four more -> brute-deadline (7 rows {brute_ms:.2f} "
                         f"ms, exact), fifteen quiet ticks -> exact again; "
                         f"kdtree_recall_sampled={sampled}")
        finally:
            srv.stop()

        # (d) tune
        tq = generate_queries(SEED + 902, DIM, TUNE_Q, device=dev)
        t0 = time.perf_counter()
        # around the density plan of 2^16 queries on this tree (tile 32,
        # cmax 1,024)
        res = tuner.sweep(tree, tq, k=K, tiles=(16, 32), cmaxs=(1024, 4096))
        tune_s = time.perf_counter() - t0
        assert res["persisted"], res.get("reason")
        w = res["winner"]
        warm = tqm.plan_tiled(TUNE_Q, DIM, tree.n_real, tree.num_buckets, tree.bucket_size, K,
                              device=dev)
        assert warm.source == "warm" and (warm.tile, warm.cmax) == (w["tile"], w["cmax"])
        stats = tqm.TileStats()
        d2, ids = tqm.morton_knn_tiled(tree, tq, k=K, stats=stats)
        sample = torch.arange(0, TUNE_Q, TUNE_Q // 512, device=dev)
        ties = check_answer(points, tq[sample], d2[sample], ids[sample], K, "tuned run")
        note(f"tune {TUNE_Q} queries: {len(res['results']) + len(res['block_results'])} "
                     f"candidates in {tune_s:.2f} s, winner tile={w['tile']} cmax={w['cmax']} "
                     f"{w['seconds'] * 1e3:.2f} ms ({w['qps']:.0f} q/s); next plan warm, "
                     f"{stats.retries} retries, a 512-query sample exact vs the oracle "
                     f"({ties} tied slots)")
    finally:
        if run_store is None:
            os.environ.pop("KDTREE_TPU_TORCH_PLAN_CACHE", None)
        else:
            os.environ["KDTREE_TPU_TORCH_PLAN_CACHE"] = run_store
        shutil.rmtree(tmp, ignore_errors=True)


def _timed(dev, fn):
    """(result, wall s) of ``fn()`` with the card synchronized around it."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _dfs_lane(dev, name, run, mod, points, queries, k, rounded, profile_rows=None):
    """One DFS query lane of phase 10: ``run(stats)`` timed (wall s) with
    its steps and host syncs, its first CLASSIC_SAMPLE rows held against
    the oracle in the engine's arithmetic, and the device launches of one
    step (``run(None)`` answers the first ``profile_rows`` rows)."""
    from kdtree_tpu_torch.ops.morton import DfsStats

    st = DfsStats()
    (d2, ids), wall = _timed(dev, lambda: run(st))
    n = min(CLASSIC_SAMPLE, queries.shape[0])
    ties = check_answer(points, queries[:n], d2[:n].reshape(n, -1), ids[:n].reshape(n, -1), k,
                        name, rounded=rounded)
    line = (f"{name}: {wall:.4f} s ({queries.shape[0] / wall:.0f} q/s), {n}-row sample exact vs "
            f"oracle ({ties} tied slots); {st.chunks} chunk(s), {st.steps} steps, "
            f"{st.scans} scan rounds, {st.syncs} host syncs, {st.graphs} graph(s)")
    if dev.type == "cuda":
        r = profile_rows or queries.shape[0]
        per_step, note = dfs_launches_per_step(lambda: run(None), mod, (d2[:r], ids[:r]))
        line += f"; device launches per step: {per_step:.2f} ({note}; obs.timeline)"
    return line


def phase_classic(dev, points, here, smi):
    """Phase 10: the classic median-split trees (see the module
    docstring). Returns the lines to print and the scan and merge kernels'
    launches over the CLI runs."""
    import shutil
    import signal

    import torch

    import kdtree_tpu_torch.kernels.scan_knn as scan_mod
    import kdtree_tpu_torch.ops.bucket as bucket_mod
    import kdtree_tpu_torch.ops.query as query_mod
    from kdtree_tpu_torch import native
    from kdtree_tpu_torch.ops import bruteforce
    from kdtree_tpu_torch.ops.build import build_jit, validate_invariants
    from kdtree_tpu_torch.ops.build_presort import build_presort
    from kdtree_tpu_torch.ops.generate import generate_queries
    from kdtree_tpu_torch.ops.morton import morton_view
    from kdtree_tpu_torch.utils import cli
    from kdtree_tpu_torch.utils.checkpoint import load_tree

    on_card = dev.type == "cuda"
    dev_args = [] if on_card else ["--device", str(dev)]
    n = points.shape[0]
    lines = []

    # (a) the builds at full width on phase 4's points; the first classic
    # build also computes the host-side TreeSpec (cached per N after)
    ctree, c_first = _timed(dev, lambda: build_jit(points))
    ctree, c_s = _timed(dev, lambda: build_jit(points))
    btree, b_first = _timed(dev, lambda: bucket_mod.build_bucket(
        points, bucket_cap=CLASSIC_BUCKET, strategy="sort"))
    btree, b_s = _timed(dev, lambda: bucket_mod.build_bucket(
        points, bucket_cap=CLASSIC_BUCKET, strategy="sort"))
    _, val_s = _timed(dev, lambda: validate_invariants(ctree))
    lines.append(f"build_jit at {n} x {DIM}: {c_s:.4f} s ({n / c_s:.0f} pts/s; first call "
                 f"{c_first:.4f} s with the host TreeSpec), {ctree}; build_bucket B="
                 f"{CLASSIC_BUCKET} sort: {b_s:.4f} s ({n / b_s:.0f} pts/s; first {b_first:.4f} s), "
                 f"{btree}; validate_invariants (host numpy) {val_s:.2f} s: held")

    # (b) at 2^20: presort == sort, and the card's builds == the CPU's
    cut = points[:CLASSIC_CUT_N].contiguous()
    cpu = cut.cpu()

    def same(a, b, names, what):
        for name in names:
            x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
            assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                               y.view(torch.int32) if y.is_floating_point() else y), \
                f"{what}: {name} differs"

    classic_names = ("node_point", "split_val")
    bucket_names = ("node_coords", "node_gid", "node_bucket", "bucket_pts", "bucket_gid")
    c20, c20_s = _timed(dev, lambda: build_jit(cut))
    p20, p20_s = _timed(dev, lambda: build_presort(cut))
    same(c20, p20, classic_names, "build_presort vs build_jit")
    same(c20, build_jit(cpu, device="cpu"), classic_names, "build_jit card vs CPU")
    b20, b20_s = _timed(dev, lambda: bucket_mod.build_bucket(cut, bucket_cap=CLASSIC_BUCKET))
    bp20, bp20_s = _timed(dev, lambda: bucket_mod.build_bucket(
        cut, bucket_cap=CLASSIC_BUCKET, strategy="presort"))
    same(b20, bp20, bucket_names, "bucket presort vs sort")
    same(b20, bucket_mod.build_bucket(cpu, bucket_cap=CLASSIC_BUCKET, device="cpu"),
         bucket_names, "build_bucket card vs CPU")
    validate_invariants(p20)
    lines.append(f"at {CLASSIC_CUT_N} x {DIM}: build_jit {c20_s:.4f} s, build_presort "
                 f"{p20_s:.4f} s (bit-identical), bucket sort {b20_s:.4f} s, presort "
                 f"{bp20_s:.4f} s (bit-identical); both builds bit-identical to the same "
                 "build on the CPU")
    del c20, p20, b20, bp20, cpu

    # (c) the query lanes, each exact against the oracle in its arithmetic:
    # 10 lanes run as XLA:CPU's scalar tail (the FMA chain, bruteforce.knn's);
    # 4,096 and the bucket's 16,384-lane chunks are vector lanes, where a
    # tree node's point has its squares rounded
    every = torch.ones(n, dtype=torch.bool, device=dev)
    internal = torch.zeros(n, dtype=torch.bool, device=dev)
    internal[btree.node_gid[btree.node_gid >= 0].long()] = True
    hq = generate_queries(SEED, DIM, HEADLINE_QUERIES, device=dev)
    sq = generate_queries(55, DIM, SPARSE_Q, device=dev)  # phase 6's sparse lane
    kq = sq[:CLASSIC_KNN_Q].contiguous()
    chunk = bucket_mod._CHUNK
    query_mod.nearest_neighbor(ctree, generate_queries(999, DIM, HEADLINE_QUERIES, device=dev))
    lines.append(_dfs_lane(
        dev, f"nearest_neighbor, the headline's {HEADLINE_QUERIES} queries (seed {SEED})",
        lambda st: query_mod.knn(ctree, hq, k=1, stats=st), query_mod, points, hq, 1, None))
    lines.append(_dfs_lane(
        dev, f"knn k={K}, {CLASSIC_KNN_Q} of the sparse lane's queries",
        lambda st: query_mod.knn(ctree, kq, k=K, stats=st), query_mod, points, kq, K, every))
    lines.append(_dfs_lane(
        dev, f"bucket_knn k={K}, the sparse lane's {SPARSE_Q} queries",
        lambda st: bucket_mod.bucket_knn(btree, sq if st is not None else sq[:chunk], k=K,
                                         stats=st),
        bucket_mod, points, sq, K, internal, profile_rows=chunk))
    del ctree, btree, every, internal

    # (d) the CLI, with both kernels' launch counts zeroed just before
    work = here / "kdtree_tpu_torch" / "_build" / "chip_smoke_classic"  # git-ignored
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cpts, _ = native.generate_problem_mt19937(SEED, DIM, CLI_BUILD_N, HEADLINE_QUERIES)
    cpts = torch.from_numpy(cpts).to(dev)
    dq = generate_queries(77, DIM, CLI_DENSE_Q, device=dev)
    qfile = work / "queries.npy"
    np.save(qfile, dq.cpu().numpy())
    scan_mod.scan_tiles.launches = 0
    scan_mod.merge_partials.launches = 0
    try:
        for engine in ("tree", "bucket"):
            ckpt = str(work / f"{engine}.npz")
            _, build_s = _timed(dev, lambda: run_cli(
                [*dev_args, "--engine", engine, "build", "--n", str(CLI_BUILD_N), "--out", ckpt]))
            before = scan_mod.scan_tiles.launches
            _, dense_s = _timed(dev, lambda: run_cli(
                [*dev_args, "query", "--tree", ckpt, "--queries", str(qfile), "--k", str(K),
                 "--out", str(work / "answer.npz")]))
            raised = scan_mod.scan_tiles.launches - before
            if on_card:
                assert raised > 0, f"query --queries on a {engine} checkpoint did not launch " \
                                   "the scan kernel"
            with np.load(work / "answer.npz") as z:
                ad, ai = z["d2"], z["ids"]
            assert ad.shape == (CLI_DENSE_Q, K)
            ties = check_answer(cpts, dq[:CLASSIC_SAMPLE], torch.from_numpy(ad[:CLASSIC_SAMPLE]),
                                torch.from_numpy(ai[:CLASSIC_SAMPLE]), K,
                                f"query --queries on {engine}")
            lines.append(f"cli --engine {engine} build --out at {CLI_BUILD_N} x {DIM} "
                         f"(mt19937) {build_s:.3f} s; query --queries {CLI_DENSE_Q} dense rows "
                         f"k={K} {dense_s:.3f} s through the Morton view, {CLASSIC_SAMPLE}-row "
                         f"sample exact vs oracle ({ties} tied slots), {raised} scan kernel "
                         "launches")

        # serve --index on the classic checkpoint, answering /v1/knn at 1 and 64 rows
        cmd = [sys.executable, "-m", "kdtree_tpu_torch", *dev_args, "serve", "--index",
               str(work / "tree.npz"), "--k", str(K), "--max-batch", "64", "--port", "0"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=here, stderr=subprocess.PIPE,
                                stdout=subprocess.DEVNULL, text=True)
        try:
            err, port = [], None
            while port is None:
                line = proc.stderr.readline()
                if not line:
                    raise AssertionError(f"serve exited {proc.wait()} before ready: "
                                         f"{''.join(err)}")
                err.append(line)
                if line.startswith("ready:"):
                    port = int(line.rsplit(" ", 1)[1])
            ready_s = time.perf_counter() - t0
            pool = generate_queries(SEED + 900, DIM, 65, device=dev).cpu().numpy()
            ora = Oracle(cpts, pool)
            ms = {}
            for rows in (np.arange(1), np.arange(1, 65)):
                t0 = time.perf_counter()
                st, _, resp = _http(port, "POST", "/v1/knn",
                                    {"queries": pool[rows].tolist(), "k": K})
                ms[len(rows)] = (time.perf_counter() - t0) * 1e3
                assert st == 200, (st, resp)
                ora.check(rows, resp, K, f"serve --index classic, {len(rows)} rows")
            proc.send_signal(signal.SIGTERM)
            rest = proc.communicate(timeout=120)[1]
            assert proc.returncode == 0 and "drained; bye" in rest, (proc.returncode, rest)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        lines.append(f"python -m kdtree_tpu_torch serve --index <classic npz>: ready in "
                     f"{ready_s:.2f} s (the Morton view built at start), /v1/knn 1 row "
                     f"{ms[1]:.2f} ms and 64 rows {ms[64]:.2f} ms, exact vs oracle; SIGTERM -> "
                     "exit 0")

        # the golden configurations with the bucketed tree, and a 3-D classic harness
        for seed in GOLDEN_SEEDS:
            want = (here / "tests" / "golden" / f"ref_seed{seed}_128d_500k.txt").read_text()
            (out, _), wall = _timed(dev, lambda: run_cli(
                [*dev_args, "--engine", "bucket", "harness", str(seed), str(cli.HARNESS_DIM),
                 str(cli.HARNESS_NUM_POINTS)]))
            assert out == want, f"bucket harness seed {seed}: stdout differs\n{out}"
            lines.append(f"harness --engine bucket, golden seed {seed} ({cli.HARNESS_DIM}-D, "
                         f"{cli.HARNESS_NUM_POINTS} points, mt19937): stdout byte-equal, "
                         f"{wall:.2f} s")
        spec = [str(SEED), str(DIM), str(CLASSIC_HARNESS_N)]
        (tree_out, _), wall = _timed(dev, lambda: run_cli(
            [*dev_args, "--engine", "tree", "harness", *spec]))
        brute_out, _ = run_cli([*dev_args, "--engine", "bruteforce", "harness", *spec])
        assert tree_out == brute_out and tree_out.count("DISTANCE") == HEADLINE_QUERIES, \
            f"harness --engine tree differs from bruteforce\n{tree_out}\n{brute_out}"
        lines.append(f"harness --engine tree {' '.join(spec)}: stdout byte-equal to "
                     f"--engine bruteforce's, {wall:.2f} s")
        launches = (scan_mod.scan_tiles.launches, scan_mod.merge_partials.launches)
        lines.append(f"over phase 10's CLI runs scan_tiles.launches={launches[0]}, "
                     f"merge_partials.launches={launches[1]}")

        # outside the counted window: the kernels against the plain scan at
        # the final collect dispatch of both query --queries runs
        if on_card:
            ct, _ = load_tree(str(work / "tree.npz"), device=dev)
            bt, _ = load_tree(str(work / "bucket.npz"), device=dev)
            for engine, view in (("tree", morton_view(points=ct.points)),
                                 ("bucket", morton_view(**cli.bucket_view_inputs(bt)))):
                rec = tiled_dispatch(f"query --queries on a {engine} checkpoint's Morton view "
                                     f"({CLI_DENSE_Q} rows, {CLI_BUILD_N} points)", view, dq, 1,
                                     plain_reps=1)
                lines.append(f"scan kernel at that dispatch ({engine}): {rec['ms']:.4f} ms, "
                             f"plain {rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.4f} ms "
                             f"({rec['bound_by']}), bit-equal")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lines = [f"{line} [{smi}]" if " s" in line or "ms" in line else line for line in lines]
    return lines, launches


def raw_exec_union_us(path):
    """(µs, slices) of the union of a Chrome trace's kernel, memcpy and
    memset slices, read from the raw file by this script's own code: the
    independent count phase 11 holds the package's timeline against."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                for e in events if e.get("ph") == "X"
                and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    total, cur = 0.0, None
    for a, b in iv:
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, len(iv)


def _kernel_name(name):
    """A kernel's trace name without its return type, namespace wrapper,
    template arguments and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0]
    return name[5:] if name.startswith("void ") else name


def _timeline_line(what, rep):
    """One line of a timeline report's headline numbers."""
    disp, lag = rep["dispatches"], rep["dispatches"]["lag_us"]
    st = disp["stages"]
    kernels = ", ".join(f"{_kernel_name(m['module'])} {m['busy_us'] / 1e3:.3f} ms x"
                        f"{m['n_slices']}" for m in rep["device"]["modules"][:5])
    frac = disp["busy_frac"]
    return (f"{what}: capture {rep['capture']['wall_us'] / 1e3:.2f} ms, card busy "
            f"{rep['device']['busy_us'] / 1e3:.3f} ms ({100 * rep['device']['busy_frac']:.2f}%, "
            f"{rep['device']['n_slices']} kernel/copy slices), {disp['count']} tile.dispatch "
            f"(busy between dispatches {'-' if frac is None else f'{100 * frac:.2f}%'}; lag "
            f"median {lag['median'] if lag['median'] is None else round(lag['median'], 1)} us p90 "
            f"{lag['p90'] if lag['p90'] is None else round(lag['p90'], 1)} us; host split prep "
            f"{st['prep_us'] / 1e3:.2f} retire {st['retire_us'] / 1e3:.2f} drain "
            f"{st['drain_us'] / 1e3:.2f} ms), kernel builds in window "
            f"{rep['compile']['count']}; top kernels: {kernels}")


def phase_obs(dev, points, tree, here, smi, keep):
    """Phase 11: device observability on the card (see the module
    docstring). Prints its lines as it goes. Leaves its two ``bench
    --metrics-out`` sidecars in ``keep`` for phase 14's ``trend``, each
    with the headline block a bench harness adds (the CLI's own sidecar
    carries none, in the JAX package too), built from the bench's line."""
    import os
    import shutil
    import tempfile
    import threading

    import torch

    import kdtree_tpu_torch.kernels.scan_knn as scan_mod
    from kdtree_tpu_torch.obs import costs as costs_mod
    from kdtree_tpu_torch.obs import flight
    from kdtree_tpu_torch.obs import profile as obs_profile
    from kdtree_tpu_torch.obs.registry import get_registry
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops.generate import generate_queries
    from kdtree_tpu_torch.serve.engine import build_state
    from kdtree_tpu_torch.serve.server import make_server

    reg = get_registry()
    cuda = dev.type == "cuda"
    devflag = [] if cuda else ["--device", "cpu"]  # the CPU rehearsal's
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-obs-"))
    try:
        # 1. `profile` at full width: the answers under the window bit-equal
        # to the warm run's outside it, and each call's scan launches
        calls = []
        original = tqm.morton_knn_tiled

        def recorded(*a, **kw):
            before = scan_mod.scan_tiles.launches
            out = original(*a, **kw)
            _sync(dev)
            calls.append((out[0].clone(), out[1].clone(), scan_mod.scan_tiles.launches - before))
            return out

        tqm.morton_knn_tiled = recorded
        t0 = time.perf_counter()
        try:
            out, _ = run_cli([*devflag, "profile", "--n", str(N_POINTS), "--q", str(TILED_QUERIES),
                              "--k", str(K), "--format", "json", "--out",
                              str(work / "timeline.json"), "--trace-dir", str(work / "trace")])
        finally:
            tqm.morton_knn_tiled = original
        cli_s = time.perf_counter() - t0
        summary = json.loads(out)
        with open(work / "timeline.json") as f:
            rep = json.load(f)
        assert len(calls) == 2, "profile ran the tiled engine other than twice"
        assert torch.equal(calls[0][0], calls[1][0]) and torch.equal(calls[0][1], calls[1][1]), \
            "the tiled run answered differently inside the capture window"
        raw_us, raw_n = raw_exec_union_us(summary["trace_file"])
        busy = rep["device"]["busy_us"]
        scan = [m for m in rep["device"]["modules"] if "scan_knn_kernel" in m["module"]]
        if cuda:
            assert rep["device"]["kind"] == "cuda" and raw_us > 0
            assert abs(busy - raw_us) <= 1e-3 * raw_us, (busy, raw_us)
            assert rep["device"]["n_slices"] == raw_n, (rep["device"]["n_slices"], raw_n)
            assert scan, "the timeline's kernel table does not name scan_knn_kernel"
            assert scan[0]["n_slices"] == calls[1][2] > 0, (scan[0]["n_slices"], calls[1][2])
        else:  # the CPU rehearsal: no card, so no kernel slices
            raw_us, scan = max(raw_us, busy), [{"busy_us": 0.0, "n_slices": 0}]
        assert rep["dispatches"]["count"] > 0 and summary["correlated_spans"] > 0
        q_wall = rep["spans"]["profile.query"]["wall_us"]
        say("obs", f"profile --n {N_POINTS} --q {TILED_QUERIES} --k {K} ({cli_s:.1f} s in all): "
                     f"answers bit-equal to the warm run outside the window; card busy "
                     f"{busy:.1f} us vs {raw_us:.1f} us from the raw trace ({raw_n} slices, "
                     f"{abs(busy - raw_us) / raw_us:.2e} apart); scan_knn_kernel "
                     f"{scan[0]['busy_us'] / 1e3:.3f} ms over {scan[0]['n_slices']} launches = "
                     f"scan_tiles.launches of the captured run; profile.query span "
                     f"{q_wall / 1e3:.2f} ms")
        say("obs", _timeline_line("tiled run (profile)", rep))
        del calls

        # 5a. the capture's cost on the tiled run: plain, captured,
        # captured, plain; the run alone and the whole window
        tq = generate_queries(SEED, DIM, TILED_QUERIES, device=dev)
        runs = {"plain": [], "captured": [], "window": []}
        for mode in ("plain", "captured", "captured", "plain"):
            if mode == "plain":
                _, s_ = _timed(dev, lambda: tqm.morton_knn_tiled(tree, tq, k=K))
                runs["plain"].append(s_)
                continue
            t0 = time.perf_counter()
            with obs_profile.capture(str(work / "overhead"), dev):
                _, s_ = _timed(dev, lambda: tqm.morton_knn_tiled(tree, tq, k=K))
            runs["window"].append(time.perf_counter() - t0)
            runs["captured"].append(s_)
        plain, capt = min(runs["plain"]), min(runs["captured"])
        say("obs", f"capture overhead on the tiled run ({TILED_QUERIES} queries, plain, "
                     f"captured, captured, plain): plain {', '.join(f'{x:.4f}' for x in runs['plain'])} s; "
                     f"in a window {', '.join(f'{x:.4f}' for x in runs['captured'])} s "
                     f"({100 * (capt / plain - 1):+.2f}% best to best); the whole window with "
                     f"start, stop and export {', '.join(f'{x:.2f}' for x in runs['window'])} s [{smi}]")
        shutil.rmtree(work / "overhead", ignore_errors=True)
        del tq

        # 2. a server on the 2^24 tree, 4 clients at 1-1,000 rows, and
        # POST /debug/profile under that load
        state = build_state(tree=tree, k=K, max_batch=MAX_BATCH)
        srv = make_server(state, port=0, queue_rows=16 * MAX_BATCH)
        srv.start()
        port = srv.server_address[1]
        base = f"http://127.0.0.1:{port}"
        try:
            pool = generate_queries(SEED + 1100, DIM, 1100, device=dev).cpu().numpy()
            ora = Oracle(points, pool)
            _, _, c0 = _http(port, "GET", "/debug/costs")
            req0 = c0["totals"]["requests"]
            stop = threading.Event()
            results, errors = [], []

            def client(i):
                try:
                    j = 0
                    while not stop.is_set():
                        rows = OBS_ROWS[(i + j) % len(OBS_ROWS)]
                        off = (i * 131 + j * 17) % (len(pool) - rows)
                        st, _, resp = _http(port, "POST", "/v1/knn",
                                            {"queries": pool[off:off + rows].tolist()})
                        results.append((rows, off, st, resp))
                        j += 1
                except Exception as e:  # re-raised below, on the main thread
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(OBS_CLIENTS)]
            for t in threads:
                t.start()
            while len(results) < 2 * OBS_CLIENTS and not errors:
                time.sleep(0.01)
            prof = {}
            pt = threading.Thread(target=lambda: prof.update(r=_http(
                port, "POST", f"/debug/profile?seconds={OBS_PROFILE_S:g}")))
            pt.start()
            while srv.batcher._capture_req is None:  # the window is asked for
                time.sleep(0.005)
            st409, _, busy409 = _http(port, "POST", "/debug/profile?seconds=1")
            st, _, tresp = _http(port, "POST", "/v1/knn", {"queries": pool[:7].tolist()},
                                 headers={"X-Request-Id": "obs-trace-7"})
            assert st == 200
            pt.join()
            time.sleep(1.0)
            stop.set()
            for t in threads:
                t.join()
            assert not errors, errors
            assert st409 == 409, (st409, busy409)
            st, _, prep = prof["r"]
            assert st == 200, (st, prep)
            assert prep["device"]["kind"] == dev.type and prep["device"]["busy_frac"] > 0
            assert prep["dispatches"]["count"] > 0, "no tile.dispatch of the batch worker"
            assert not cuda or any("scan_knn_kernel" in m["module"]
                                   for m in prep["device"]["modules"]), \
                "the served window's kernel table does not name scan_knn_kernel"
            ties = 0
            for rows, off, st, resp in results:
                assert st == 200 and resp["degraded"] is None, (rows, st, resp.get("error"))
                ties += ora.check(np.arange(off, off + rows), resp, K, f"{rows}-row request")
            ora.check(np.arange(7), tresp, K, "the traced request")
            answered = len(results) + 1
            say("obs", f"{answered} requests from {OBS_CLIENTS} clients at 1-1000 rows plus one "
                         f"traced, every answer exact vs oracle ({ties} tied slots); POST "
                         f"/debug/profile?seconds={OBS_PROFILE_S:g} under load: 200, a second "
                         f"POST while it ran: {st409}")
            say("obs", _timeline_line("served window (/debug/profile)", prep))
            time.sleep(1.5)  # one more history tick after the last answer
            _, _, metrics = _http(port, "GET", "/metrics")
            assert "\nkdtree_device_busy_frac " in metrics, "no busy gauge on /metrics"
            _, _, costs = _http(port, "GET", "/debug/costs")
            got = costs["totals"]["requests"] - req0
            assert got == answered, (got, answered)
            _, _, health = _http(port, "GET", "/healthz")
            hr = health["headroom"]
            assert hr["data"] is True, hr
            tr_out, _ = run_cli(["trace", "--target", base, "--id", "obs-trace-7"])
            assert tr_out.startswith("trace obs-trace-7") and "serve/dispatch" in tr_out, tr_out
            co_out, _ = run_cli(["costs", "--target", base])
            assert "knn/exact/ok" in co_out and "headroom:" in co_out, co_out
            say("obs", f"/debug/costs: {got:g} requests = the answered count, cost/query "
                         f"{costs['totals']['cost_ms']} ms; /healthz headroom {hr['headroom_frac']:.4f} "
                         f"(observed {hr['observed_rate']:.1f} vs predicted "
                         f"{hr['predicted_rate']:.1f} req/s, busy {hr['busy_frac']}); "
                         f"kdtree_device_busy_frac on /metrics; `trace --id obs-trace-7` renders "
                         f"{len(tr_out.splitlines())} lines, `costs` renders "
                         f"{len(co_out.splitlines())}")
            say("obs", "trace obs-trace-7: " + " | ".join(tr_out.splitlines()[1:6]))

            # 3 + 5b. the duty cycle at KDTREE_TPU_PROFILE_DUTY_PERIOD_S=5
            # (KDTREE_TPU_PROFILE_DUTY=1: it is off by default), under 4
            # clients at 1-1,000 rows: blocks with it off, on, off; each
            # window's profiler start and stop (on the batch worker) and
            # export (on the duty thread, holding the GIL)
            windows_log = []

            def duty_capture(seconds, log_dir):
                t0 = time.perf_counter()
                res = srv.batcher.capture_for(seconds, log_dir)
                windows_log.append((t0, time.perf_counter(), res))
                return res

            def load_block(seconds, until=None):
                lat, errs, stop_b = [], [], threading.Event()

                def client_b(i):
                    try:
                        j = 0
                        while not stop_b.is_set():
                            rows = OBS_ROWS[(i + j) % len(OBS_ROWS)]
                            off = (i * 131 + j * 17) % (len(pool) - rows)
                            t = time.perf_counter()
                            st, _, resp = _http(port, "POST", "/v1/knn",
                                                {"queries": pool[off:off + rows].tolist()})
                            assert st == 200 and resp["degraded"] is None, (st, resp)
                            lat.append((t, time.perf_counter()))
                            j += 1
                    except Exception as e:  # re-raised below, on the main thread
                        errs.append(e)

                ths = [threading.Thread(target=client_b, args=(i,)) for i in range(OBS_CLIENTS)]
                for t in ths:
                    t.start()
                t_end = time.perf_counter() + seconds
                while not errs and (time.perf_counter() < t_end or (
                        until is not None and not until() and time.perf_counter() < t_end + 60)):
                    time.sleep(0.05)
                stop_b.set()
                for t in ths:
                    t.join()
                assert not errs, errs
                return lat

            def pct(lat):
                ms = np.array([(t1 - t0) * 1e3 for t0, t1 in lat])
                return (f"n {len(ms)}, median {np.median(ms):.2f}, p99 "
                        f"{np.percentile(ms, 99):.2f}, max {ms.max():.2f} ms") if len(ms) else "n 0"

            blocks = []
            windows0 = reg.counter("kdtree_profile_duty_windows_total").value
            for block in ("off", "on", "off"):
                srv.duty.stop()
                if block == "on":
                    saved = {k: os.environ.get(k) for k in (
                        "KDTREE_TPU_PROFILE_DUTY", "KDTREE_TPU_PROFILE_DUTY_PERIOD_S")}
                    os.environ["KDTREE_TPU_PROFILE_DUTY"] = "1"
                    os.environ["KDTREE_TPU_PROFILE_DUTY_PERIOD_S"] = OBS_DUTY_PERIOD_S
                    try:
                        srv.duty = costs_mod.ProfileDutyCycle(capture_for=duty_capture)
                        srv.duty.start()
                    finally:
                        for k, v in saved.items():
                            if v is None:
                                os.environ.pop(k, None)
                            else:
                                os.environ[k] = v
                    assert srv.duty.running and srv.duty.period_s == float(OBS_DUTY_PERIOD_S)
                    lat = load_block(1.5 * OBS_BLOCK_S, until=lambda: len(windows_log) >= 2)
                    srv.duty.stop()
                    # read before the next block's requests push the
                    # window's events out of the bounded flight ring
                    duty_ev = [e for e in flight.recorder().snapshot()
                               if e["type"] == "profile.duty_window"
                               and e.get("busy_frac") is not None]
                else:
                    lat = load_block(OBS_BLOCK_S)
                blocks.append((block, lat))
            windows = reg.counter("kdtree_profile_duty_windows_total").value - windows0
            assert windows >= 1 and windows_log, "the duty cycle closed no window"
            assert duty_ev, "no duty window published a busy fraction"
            gauge = reg.gauge("kdtree_device_busy_frac").value
            say("obs", f"duty cycle (period {OBS_DUTY_PERIOD_S} s, window "
                         f"{srv.duty.window_s:g} s): {windows:g} window(s), the last busy_frac "
                         f"{duty_ev[-1]['busy_frac']:.4f}, lag median "
                         f"{duty_ev[-1]['lag_us_median']} us; kdtree_device_busy_frac = {gauge:.4f}")
            say("obs", "each duty window's pause, s: " + "; ".join(
                f"profiler start {r.start_seconds:.4f} + stop {r.stop_seconds:.4f} on the "
                f"batch worker, export {r.export_seconds:.4f} holding the GIL (asked to "
                f"returned {t1 - t0:.3f})" for t0, t1, r in windows_log) + f" [{smi}]")
            on_lat = blocks[1][1]
            inside = [x for x in on_lat if any(x[0] < w1 and x[1] > w0 for w0, w1, _ in windows_log)]
            outside = [x for x in on_lat if x not in inside]
            say("obs", f"served under {OBS_CLIENTS} clients at 1-1000 rows, request ms: "
                         + "; ".join(f"duty {b} {pct(lat)}" for b, lat in blocks)
                         + f"; duty on, requests overlapping a window {pct(inside)}, the rest "
                         f"{pct(outside)} [{smi}]")
        finally:
            srv.stop()

        # 4. --metrics-out on bench, then stats and stats --diff
        reps = []
        for i in range(2):
            path = str(work / f"bench-{i}.json")
            argv = [*devflag, "--metrics-out", path, "bench"] + (
                ["--trace", str(work / "bench-trace")] if i == 0 else [])
            out, _ = run_cli(argv)
            reps.append((path, json.loads(out)))
        st_out, _ = run_cli(["stats", reps[0][0]])
        diff_out, _ = run_cli(["stats", "--diff", reps[0][0], reps[1][0]])
        assert "== spans (by total time) ==" in st_out and \
            f"platform:            {dev.type}" in st_out
        assert "== spans (by NEW total time) ==" in diff_out
        assert list((work / "bench-trace").glob("*.pt.trace.json")), "bench --trace wrote nothing"
        say("obs", f"--metrics-out on bench (engine {reps[0][1]['engine']}, "
                     f"{reps[0][1]['pts_per_sec']:.0f} / {reps[1][1]['pts_per_sec']:.0f} pts/s): "
                     f"`stats` renders {len(st_out.splitlines())} lines, `stats --diff` "
                     f"{len(diff_out.splitlines())}; bench --trace wrote its trace")
        say("obs", "stats: " + " | ".join(x for x in st_out.splitlines()[:5] if x))
        for i, (path, line) in enumerate(reps):
            with open(path) as f:
                side = json.load(f)
            side["headline"] = {
                "metric": f"k-d tree gen+build+10xNN points/sec ({line['n']} x "
                          f"{line['dim']}D, {line['platform']})",
                "value": line["pts_per_sec"], "unit": "pts/s", "platform": line["platform"]}
            with open(keep / f"bench-{i}.json", "w") as f:
                json.dump(side, f)
    finally:
        from kdtree_tpu_torch import obs

        obs.set_enabled(None)  # --metrics-out turned the gated metrics on
        obs._metrics_out_path = None
        shutil.rmtree(work, ignore_errors=True)


def _ties_ok(points, queries, d2, ids, want, what):
    """d2 equal to ``want``'s bit for bit; where the ids differ, each of
    ours must be a distinct point at exactly that distance (a tie that
    the two engines broke differently, with a neighbouring rank or with a
    point past the k-th). Returns the count of such slots."""
    import torch

    from kdtree_tpu_torch.ops._arith import sq_dist

    want_d2, want_ids = want
    assert d2.shape == want_d2.shape and ids.shape == want_ids.shape, what
    assert torch.equal(d2, want_d2), f"{what}: d2 differs"
    rows = (ids != want_ids).any(1).nonzero()[:, 0]
    if rows.numel():
        r_ids = ids[rows].long()
        again = sq_dist(queries[rows][:, None, :], points[r_ids])
        assert torch.equal(again, d2[rows]), f"{what}: a differing id is not at its d2"
        assert (r_ids.sort(dim=1).values.diff(dim=1) != 0).all(), f"{what}: dup ids"
    return int((ids != want_ids).sum())


class _SayList(list):
    """Phase 12's lines, each printed the moment it is added, so that a
    later failure keeps what came before."""

    def append(self, line):
        say("forest", line)
        super().append(line)


def _forest_shape(name, forest, queries, k, dev):
    """The scan kernel against the plain scan on shard 0's tree at the
    forest's per-shard plan (the plan its SPMD query takes, the kernel
    forced), one collect batch, timed beside its bound."""
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.parallel.global_morton import _shard_n_real

    n_shard = _shard_n_real(forest, k)
    plan = tqm.plan_tiled(queries.shape[0], queries.shape[1], n_shard, forest.num_buckets,
                          forest.bucket_size, k, use_kernel=True, device=dev,
                          devices=forest.devices)
    sq, _ = tqm._sort_queries(queries, plan.bits, (-queries.shape[0]) % plan.qbatch)
    tq = sq[: plan.qbatch].reshape(-1, plan.tile, queries.shape[1]).contiguous()
    tree = forest.shard(0, n_shard)
    cand, lb = collect_inputs(tree, tq, k, plan.seeds, plan.cmax, grow=True)
    if forest.devices > 1:  # the frontier kernel at a P = 4 shard's seed and collect
        for rec in frontier_tiled(name, tree, tq, k, plan.seeds, cand.shape[1]):
            say("forest", frontier_line(rec))
    return time_shape(name, tree, tq, cand, lb, k, 1, 20, 1)


def phase_forest(dev, here, smi):
    """Phase 12: the multi-device engines (see the module docstring).
    Returns the lines to print, the scan and merge kernels' launches over
    the phase's driven path, and the kernel records at the forest shapes."""
    import shutil
    import tempfile

    import torch

    import kdtree_tpu_torch.kernels.scan_knn as scan_mod
    from kdtree_tpu_torch import obs
    from kdtree_tpu_torch.kernels.frontier import frontier
    from kdtree_tpu_torch.ops import bruteforce
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops.build import build_jit
    from kdtree_tpu_torch.ops.generate import (
        generate_points_rowwise, generate_points_shard_clustered, generate_queries,
    )
    from kdtree_tpu_torch.ops.morton import build_morton, morton_knn
    from kdtree_tpu_torch.parallel import (
        build_global, build_global_exact, build_global_morton, dsharded_knn, ensemble_knn,
        global_exact_query, global_knn, global_morton_query, global_morton_query_tiled,
    )
    from kdtree_tpu_torch.parallel.mesh import Mesh, make_mesh

    lines = _SayList()
    on_card = dev.type == "cuda"
    dev_args = [] if on_card else ["--device", str(dev)]
    one = make_mesh(1, device=dev)
    four = Mesh([dev] * FOREST_SHARDS)  # four shards on the one card
    keep = {}

    def timed(fn):
        return _timed(dev, fn)

    scan_mod.scan_tiles.launches = 0
    scan_mod.merge_partials.launches = 0
    frontier.launches = 0

    # (a) bench.py's scale lane: gen + build at 2^26 on one shard, 10 queries
    q10 = generate_queries(77, DIM, SCALE_Q, device=dev)
    timed(lambda: build_global_morton(999, DIM, SCALE_N, mesh=one, slack=1.05))  # warm-up
    torch.cuda.empty_cache()
    builds = []
    for seed in (1, 2):
        f, s_ = timed(lambda: build_global_morton(seed, DIM, SCALE_N, mesh=one, slack=1.05))
        builds.append(s_)
    (d2, ids), q_s = timed(lambda: global_morton_query(f, q10, k=1, mesh=one))
    del f
    torch.cuda.empty_cache()
    pts = generate_points_rowwise(2, DIM, SCALE_N, device=dev)
    sd, si = morton_knn(build_morton(pts, bucket_cap=128), q10, k=1)
    assert torch.equal(d2, sd), "scale lane: d2 differs from the single tree's DFS"
    ties = check_answer(pts, q10, d2, ids, 1, "scale lane")
    lines.append(f"(a) scale lane, {SCALE_N} x {DIM}-D on one shard (slack 1.05): gen+build "
                 f"{min(builds):.3f} s best of 2 ({builds[0]:.3f} / {builds[1]:.3f}; "
                 f"{SCALE_N / min(builds):.0f} pts/s), {SCALE_Q} queries k=1 by the per-shard "
                 f"DFS {q_s * 1e3:.2f} ms; d2 bit-equal to morton_knn over the same rows, ids "
                 f"to the oracle ({ties} tied slots) [{smi}]")
    del pts, sd, si
    torch.cuda.empty_cache()

    # (b) bench.py's SPMD tiled lane: 2^22 on one shard, 2^16 queries, k=16
    f1 = build_global_morton(21, DIM, SPMD_N, mesh=one, slack=1.05)
    global_morton_query(f1, generate_queries(77, DIM, SPMD_Q, device=dev), k=K, mesh=one)
    qs = generate_queries(78, DIM, SPMD_Q, device=dev)
    before = scan_mod.scan_tiles.launches
    (d2, ids), spmd_s = timed(lambda: global_morton_query(f1, qs, k=K, mesh=one))
    spmd_launch = scan_mod.scan_tiles.launches - before
    pts = generate_points_rowwise(21, DIM, SPMD_N, device=dev)
    ties = check_answer(pts, qs[:SPMD_SAMPLE], d2[:SPMD_SAMPLE], ids[:SPMD_SAMPLE], K,
                        "SPMD tiled lane")
    lines.append(f"(b) SPMD tiled lane, {SPMD_N} x {DIM}-D, one shard, {SPMD_Q} queries k={K}: "
                 f"{spmd_s:.4f} s ({SPMD_Q / spmd_s:.0f} q/s), {spmd_launch} scan kernel "
                 f"launches; {SPMD_SAMPLE} queries exact vs oracle ({ties} tied slots)")
    keep["p1"] = (f1, qs)
    del pts

    # (c) four shards on one card, uniform then clustered, default slack
    for dist in ("uniform", "clustered"):
        reg = obs.get_registry()
        f4, b_s = timed(lambda: build_global_morton(SEED, DIM, FOREST_N, mesh=four,
                                                    distribution=dist))
        slack = reg.snapshot()["gauges"]["kdtree_exchange_slack"]
        occ = [int((g >= 0).sum()) for g in f4.bucket_gid]
        if dist == "uniform":
            pts = generate_points_rowwise(SEED, DIM, FOREST_N, device=dev)
            q = generate_queries(SEED + 12, DIM, FOREST_Q, device=dev)
        else:
            rows = generate_points_shard_clustered(SEED, DIM, 0, FOREST_N + FOREST_Q, device=dev)
            pts, q = rows[:FOREST_N], rows[FOREST_N:]
        stats = tqm.TileStats()
        before = scan_mod.scan_tiles.launches
        (d2, ids), q_s = timed(lambda: global_morton_query_tiled(f4, q, k=K, mesh=four,
                                                                 stats=stats))
        launched = scan_mod.scan_tiles.launches - before
        assert launched % FOREST_SHARDS == 0, launched
        single = build_morton(pts, bucket_cap=BUCKET)
        (sd, si), s_s = timed(lambda: tqm.morton_knn_tiled(single, q, k=K))
        ties = _ties_ok(pts, q, d2, ids, (sd, si), f"4 shards, {dist}")
        sample = torch.arange(0, FOREST_Q, FOREST_Q // SAMPLE, device=dev)
        check_answer(pts, q[sample], d2[sample], ids[sample], K, f"4 shards, {dist}")
        lines.append(
            f"(c) {FOREST_SHARDS} shards on one card, {FOREST_N} x {DIM}-D {dist}: build "
            f"{b_s:.3f} s ({FOREST_N / b_s:.0f} pts/s), slack {slack:g}, per-shard occupancy "
            f"{occ} (occ_max {f4.occ_max}); {FOREST_Q} queries k={K}: {q_s:.3f} s "
            f"({FOREST_Q / q_s:.0f} q/s; the single tree's tiled run {s_s:.3f} s), "
            f"{stats.batches} batches, {stats.retries} overflow retries, "
            f"{launched // FOREST_SHARDS} scan launches per shard; d2 bit-equal to the single "
            f"tree's morton_knn_tiled, ids equal but {ties} slots tied otherwise; {SAMPLE}-query sample "
            f"exact vs oracle")
        if dist == "uniform":
            keep["p4"] = (f4, q)
            upts, uq, utree, uans = pts, q, single, (sd, si)
        del single
    del pts, q, d2, ids, sd, si
    torch.cuda.empty_cache()

    # (d) the other engines
    (d2, ids), e_s = timed(lambda: ensemble_knn(upts, uq, k=K, mesh=four))
    ties = _ties_ok(upts, uq, d2, ids, uans, "ensemble dense route")
    e10 = generate_queries(SEED + 13, DIM, SCALE_Q, device=dev)
    (fd, fi), ef_s = timed(lambda: ensemble_knn(upts, e10, k=K, mesh=four))
    check_answer(upts, e10, fd, fi, K, "ensemble fused route")
    lines.append(f"(d) ensemble_knn on {FOREST_SHARDS} shards, {FOREST_N} points: dense route "
                 f"{FOREST_Q} queries {e_s:.3f} s ({FOREST_Q / e_s:.0f} q/s), equal to the "
                 f"single tree's but {ties} slots tied otherwise; fused route {SCALE_Q} queries "
                 f"{ef_s:.3f} s, exact vs oracle")
    del upts, uq, utree, uans, d2, ids
    torch.cuda.empty_cache()

    gd = build_global_exact(SEED, DIM, EXACT_DFS_N, mesh=four)
    (d2, ids), xd_s = timed(lambda: global_exact_query(gd, e10, k=K, mesh=four))
    check_answer(generate_points_rowwise(SEED, DIM, EXACT_DFS_N, device=dev), e10, d2, ids, K,
                 "global-exact DFS")
    del gd
    gx, gx_s = timed(lambda: build_global_exact(SEED, DIM, EXACT_N, mesh=four))
    xpts = generate_points_rowwise(SEED, DIM, EXACT_N, device=dev)
    xq = generate_queries(SEED + 14, DIM, SPMD_Q, device=dev)
    (d2, ids), xt_s = timed(lambda: global_exact_query(gx, xq, k=K, mesh=four))
    check_answer(xpts, xq[:SPMD_SAMPLE], d2[:SPMD_SAMPLE], ids[:SPMD_SAMPLE], K,
                 "global-exact tiled")
    lines.append(f"(d) global-exact, {EXACT_N} points on {FOREST_SHARDS} shards: build "
                 f"{gx_s:.3f} s; DFS {SCALE_Q} queries {xd_s:.3f} s (on {EXACT_DFS_N} "
                 f"points), tiled {SPMD_Q} queries "
                 f"{xt_s:.3f} s ({SPMD_Q / xt_s:.0f} q/s); both exact vs oracle (tiled on "
                 f"{SPMD_SAMPLE})")
    del gx, xpts, d2, ids

    gpts = generate_points_rowwise(SEED, DIM, GTREE_N, device=dev)
    gt, gt_s = timed(lambda: build_global(gpts, mesh=four))
    single = build_jit(gpts)
    npt = single.node_point.long()
    assert torch.equal(gt.node_gid.long(), npt), "global tree: node ids != build_jit's"
    held = npt >= 0
    assert torch.equal(gt.node_coords[held], gpts[npt[held]]), "global tree: node points"
    (d2, ids), gq_s = timed(lambda: global_knn(gt, e10, k=K))
    check_answer(gpts, e10, d2, ids, K, "global tree")
    lines.append(f"(d) global tree, {GTREE_N} points on {FOREST_SHARDS} shards: build "
                 f"{gt_s:.3f} s, node for node build_jit's; {SCALE_Q} queries {gq_s:.3f} s, "
                 f"exact vs oracle")
    del gt, gpts, single

    dpts = generate_points_rowwise(SEED, DSHARD_D, DSHARD_N, device=dev)
    dq = generate_queries(SEED + 15, DSHARD_D, DSHARD_Q, device=dev)
    (d2, ids), ds_s = timed(lambda: dsharded_knn(dpts, dq, k=K, mesh=four))
    w = DSHARD_D // FOREST_SHARDS
    full = bruteforce.block_d2_exact(dq[:, :w], dpts[:, :w])
    for s_ in range(1, FOREST_SHARDS):
        full = full + bruteforce.block_d2_exact(dq[:, s_ * w:(s_ + 1) * w],
                                                dpts[:, s_ * w:(s_ + 1) * w])
    idx = torch.arange(DSHARD_N, dtype=torch.int64, device=dev)
    od, oi = bruteforce._unkey(bruteforce._smallest(
        bruteforce._keys(full, idx[None].expand_as(full)), K))
    assert torch.equal(d2, od) and torch.equal(ids, oi), "dsharded != its column-block oracle"
    exact64 = ((dq.double()[:, None, :] - dpts.double()[ids.long()]) ** 2).sum(-1)
    rel = float(((d2.double() - exact64).abs() / exact64.clamp_min(1e-30)).max())
    assert rel < 1e-5, rel
    lines.append(f"(d) dsharded_knn, {DSHARD_N} x {DSHARD_D}-D on {FOREST_SHARDS} shards, "
                 f"{DSHARD_Q} queries k={K}: {ds_s:.3f} s; equal to the column-block oracle, "
                 f"within {rel:.2e} relative of float64")
    del dpts, dq, full, d2, ids
    torch.cuda.empty_cache()

    # (e) the CLI: a sharded forest checkpoint built and queried on the
    # card; an 8-shard checkpoint built on the CPU, served on the card
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-forest-"))
    ck = str(work / "forest.npz")
    (out, _), cb_s = timed(lambda: run_cli([*dev_args, "--engine", "global-morton", "--devices", "1",
                                            "build", "--n", str(FOREST_N), "--sharded",
                                            "--out", ck]))
    assert "per-device shard files" in out, out
    (out, _), cq_s = timed(lambda: run_cli([*dev_args, "query", "--tree", ck]))
    pts = generate_points_rowwise(42, DIM, FOREST_N, device=dev)
    od, _ = bruteforce.knn(pts, generate_queries(42, DIM, 10, device=dev), k=1)
    want = "".join(f"ID: {FOREST_N + i} \t DISTANCE: {float(np.sqrt(v)):g}\n"
                   for i, v in enumerate(od[:, 0].cpu().numpy())) + "DONE\n"
    assert out == want, (out, want)
    del pts
    cpu_ck = str(work / "cpu8.npz")
    run_cli(["--device", "cpu", "--engine", "global-morton", "--devices", "8", "build",
             "--n", str(FOREST_CPU_N), "--out", cpu_ck])
    qf = str(work / "q.npy")
    cq = generate_queries(SEED + 16, DIM, FOREST_CPU_Q, device=dev)
    np.save(qf, cq.cpu().numpy())
    before = scan_mod.scan_tiles.launches
    (out, _), cv_s = timed(lambda: run_cli([*dev_args, "query", "--tree", cpu_ck, "--queries", qf,
                                            "--k", "8", "--out", str(work / "ans.npz")]))
    view_launch = scan_mod.scan_tiles.launches - before
    assert view_launch > 0 or not on_card, "the mesh-free view never launched the scan kernel"
    with np.load(work / "ans.npz") as z:
        ans = (torch.from_numpy(z["d2"]).to(dev), torch.from_numpy(z["ids"]).to(dev))
    ties = check_answer(generate_points_rowwise(42, DIM, FOREST_CPU_N, device=dev), cq, *ans,
                        8, "CPU-built 8-shard checkpoint on the card")
    lines.append(f"(e) CLI: `--engine global-morton --devices 1 build --n {FOREST_N} --sharded` "
                 f"{cb_s:.2f} s, `query` {cq_s:.2f} s, stdout = the oracle's lines; a "
                 f"`--device cpu --devices 8` checkpoint at {FOREST_CPU_N} queried on the card "
                 f"through the mesh-free view: {FOREST_CPU_Q} queries k=8 {cv_s:.2f} s, "
                 f"{view_launch} scan launches, exact vs oracle ({ties} tied slots)")
    shutil.rmtree(work, ignore_errors=True)

    launches = scan_mod.scan_tiles.launches
    merges = scan_mod.merge_partials.launches
    FRONTIER_LAUNCHES["12"] = frontier.launches
    assert launches > 0 or not on_card, "phase 12 never launched the scan kernel"
    assert frontier.launches > 0 or not on_card, "phase 12 never launched the frontier kernel"
    lines.append(f"phase 12's path: scan_tiles.launches={launches}, "
                 f"merge_partials.launches={merges}, frontier.launches={frontier.launches}")

    # the kernel against the plain scan at the forest shapes (after the
    # counts were read)
    if not on_card:
        return lines, launches, merges, {}
    recs = {"p1": _forest_shape(f"forest P=1 ({SPMD_N} points) shard collect shape",
                                *keep["p1"][:2], K, dev),
            "p4": _forest_shape(f"forest P=4 ({FOREST_N} points) shard 0 collect shape",
                                *keep["p4"][:2], K, dev)}
    return lines, launches, merges, recs


def main(argv=None) -> int:
    import faulthandler

    faulthandler.enable()  # a crash in native code prints the Python stack
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
    import os
    import shutil
    import tempfile

    t_run = time.perf_counter()
    plans = tempfile.mkdtemp(prefix="chip-smoke-plans-")
    os.environ["KDTREE_TPU_TORCH_PLAN_CACHE"] = plans
    try:
        if "--profile-stress-child" in argv:
            i = argv.index("--profile-stress-child")
            return profile_stress_child(argv[i + 1], int(argv[i + 2]))
        if "--profile-stress" in argv:
            return profile_stress(int(argv[argv.index("--profile-stress") + 1]))
        return _run(argv, here, t_run)
    finally:
        shutil.rmtree(plans, ignore_errors=True)


def profile_stress(n):
    """``--profile-stress N``: see the module docstring."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    tally = {}
    for mode in ("thread", "worker", "thread", "worker"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--profile-stress-child", mode, str(n)],
                              capture_output=True, text=True, timeout=60 * n + 300)
        done = [ln for ln in proc.stdout.splitlines() if ln.startswith("window ")]
        for ln in done:
            say("stress", f"{mode}: {ln}")
        crashed = proc.returncode != 0
        if crashed:
            tail = [ln for ln in proc.stderr.splitlines()
                    if "Fatal" in ln or "Current thread" in ln or "File " in ln][:12]
            say("stress", f"{mode}: the process died (exit {proc.returncode}) after "
                          f"{len(done)} windows: " + " | ".join(tail))
        t = tally.setdefault(mode, [0, 0])
        t[0] += len(done) + crashed
        t[1] += crashed
        say("stress", f"{mode}: {len(done)} windows in {time.perf_counter() - t0:.1f} s")
    say("stress", "windows under load opened by a thread of their own: "
                  f"{tally['thread'][1]} of {tally['thread'][0]} crashed the process; by the "
                  f"batch worker: {tally['worker'][1]} of {tally['worker'][0]} [{smi}]")
    return 1 if tally["worker"][1] else 0


def profile_stress_child(mode, n):
    """One process of ``--profile-stress``: ``n`` windows opened by
    ``mode`` ("thread": ``obs.profile.capture_for`` on a thread of its
    own; "worker": ``POST /debug/profile``) under 4 clients."""
    import os
    import tempfile
    import threading

    import torch

    from kdtree_tpu_torch.kernels import _build
    from kdtree_tpu_torch.obs import profile as obs_profile
    from kdtree_tpu_torch.obs import timeline
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.ops.morton import build_morton
    from kdtree_tpu_torch.serve.engine import build_state
    from kdtree_tpu_torch.serve.server import make_server

    dev = torch.device("cuda")
    _build.build()
    tree = build_morton(generate_points_rowwise(SEED, DIM, N_POINTS, device=dev),
                        bucket_cap=BUCKET)
    srv = make_server(build_state(tree=tree, k=K, max_batch=MAX_BATCH), port=0,
                      queue_rows=16 * MAX_BATCH)
    srv.start()
    port = srv.server_address[1]
    pool = generate_queries(SEED + 1100, DIM, 1100, device=dev).cpu().numpy()
    stop = threading.Event()

    def client(i):
        j = 0
        while not stop.is_set():
            rows = OBS_ROWS[(i + j) % len(OBS_ROWS)]
            off = (i * 131 + j * 17) % (len(pool) - rows)
            st, _, _ = _http(port, "POST", "/v1/knn", {"queries": pool[off:off + rows].tolist()})
            assert st == 200
            j += 1

    threads = [threading.Thread(target=client, args=(i,)) for i in range(OBS_CLIENTS)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    log_dir = tempfile.mkdtemp(prefix="chip-smoke-stress-")
    try:
        for w in range(n):
            if mode == "worker":
                st, _, rep = _http(port, "POST", f"/debug/profile?seconds={OBS_PROFILE_S:g}")
                assert st == 200, rep
            else:
                out = {}
                t = threading.Thread(target=lambda: out.update(
                    r=obs_profile.capture_for(OBS_PROFILE_S, log_dir, dev)))
                t.start()
                t.join()
                rep = timeline.analyze_trace_file(out["r"].trace_file)
            os.remove(rep["trace_file"])
            print(f"window {w}: busy {rep['device']['busy_frac']:.4f}, "
                  f"{rep['dispatches']['count']} tile.dispatch, {rep['device']['n_slices']} "
                  f"slices", flush=True)
    finally:
        stop.set()
        for t in threads:
            t.join()
        srv.stop()
    return 0


def _run(argv, here, t_run) -> int:
    import shutil
    import tempfile

    keep = Path(tempfile.mkdtemp(prefix="chip-smoke-keep-"))
    try:
        return _run_phases(argv, here, t_run, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)


def _run_phases(argv, here, t_run, keep) -> int:
    """Phases 1-14; ``keep`` carries artifacts from phases 11 and 13 to 14."""
    import torch

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

    # 3b. the oracle's distance block (the verb oracle and dsharded run it)
    # against its plain version
    for line in pair_only(dev):
        say("fold", f"{line} [{smi}]")
    # 3c. the fused k-NN oracle (every k-NN oracle check below runs it)
    t0 = time.perf_counter()
    for line in knn_only(dev):
        say("knn", f"{line} [{smi}]")
    say("knn", f"phase 3c in {time.perf_counter() - t0:.1f} s")
    if "--forest-only" in argv or "--fleet-only" in argv:
        if "--forest-only" in argv:
            _phase12(dev, here, smi, t_run)
        else:
            _phase13(dev, here, smi, t_run, keep)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0

    # 4. main path
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.ops.morton import build_morton
    from kdtree_tpu_torch.serve.engine import ServeEngine, batch_bucket, warmup_buckets

    t0 = time.perf_counter()
    points = generate_points_rowwise(SEED, DIM, N_POINTS, device=dev)
    torch.cuda.synchronize()
    say("main", f"generated {N_POINTS} x {DIM} points in {time.perf_counter() - t0:.3f} s")

    import kdtree_tpu_torch.kernels.frontier as frontier_mod
    import kdtree_tpu_torch.kernels.knn_scan as knn_mod
    import kdtree_tpu_torch.kernels.pair_d2 as pair_mod

    scan_mod.scan_tiles.launches = 0
    scan_mod.merge_partials.launches = 0
    knn_mod.knn_scan.launches = 0
    pair_mod.pair_d2.launches = 0
    frontier_mod.frontier.launches = 0
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
    KNN_LAUNCHES["4"] = knn_mod.knn_scan.launches
    pair_launches = pair_mod.pair_d2.launches
    FRONTIER_LAUNCHES["4"] = frontier_mod.frontier.launches
    say("main", f"tiled {TILED_QUERIES} queries k={K}: {tiled_s:.3f} s "
                f"({TILED_QUERIES / tiled_s:.0f} q/s), {stats.batches} batches, "
                f"{stats.retries} overflow retries, {launches - before} scan kernel "
                f"launches; over the main path scan_tiles.launches={launches}, "
                f"merge_partials.launches={merges}, knn_scan.launches="
                f"{KNN_LAUNCHES['4']} (the fallback batch), pair_d2.launches={pair_launches}, "
                f"frontier.launches={FRONTIER_LAUNCHES['4']}")
    assert launches > 0, "the main path never launched the scan kernel"
    assert merges > 0, "the main path never launched the merge kernel"
    assert KNN_LAUNCHES["4"] > 0, "the fallback batch never launched knn_scan"
    assert pair_launches == 0, "the k-NN oracle launched pair_d2: it should not write the block"
    assert FRONTIER_LAUNCHES["4"] > 0, "the main path never launched the frontier kernel"

    # checks against the brute-force oracle (outside the counted window)
    for q, d2, ids, rows, bucket, ms, source in served:
        ties = check_answer(points, q, d2, ids, K, f"request of {rows} rows")
        say("main", f"request {rows} rows (bucket {bucket}, plan {source}): "
                    f"{ms:.2f} ms, exact vs oracle ({ties} tied slots)")
    ties = check_answer(points, fq, fd2, fids, K, "fallback batch")
    say("main", f"fallback 1000 rows: {fallback_ms:.2f} ms, exact vs oracle ({ties} tied slots)")
    KNN_RECS["fallback"] = knn_timed(engine._flat_pts, torch.as_tensor(fq, device=dev),
                                     sm_clock_mhz())
    say("main", knn_line("knn_scan at the fallback batch over the tree's Morton-ordered flat "
                         "storage", KNN_RECS["fallback"]) + f" [{smi}]")
    sample = torch.as_tensor(np.random.default_rng(SEED).choice(TILED_QUERIES, SAMPLE, replace=False),
                             device=dev)
    ties = check_answer(points, tq_all[sample], td2[sample], tids[sample], K, "tiled sample")
    assert td2.shape == (TILED_QUERIES, K) and torch.isfinite(td2).all()
    say("main", f"tiled run: {SAMPLE}-query sample exact vs oracle ({ties} tied slots)")
    for line in serve_profile(engine, served, dev):
        say("main", line)

    # 4b. the verbs' folds against their plain versions, on phase 4's tree
    # and phase 8's queries (phase 8 drives the verbs themselves)
    for line in adversarial_folds(dev):
        say("fold", line)
    vq = generate_queries(SEED + 950, DIM, MAX_BATCH + 1, device=dev).cpu().numpy()
    phase_fold(tree, vq, VERB_R, VERB_SIDE, smi, main=True)

    # 4c. the frontier kernel against its plain version, at the main path's
    # shapes. The forced engine bypasses the plan store, so the shape is the
    # density heuristic's whatever the phases before recorded (phase 4's
    # overflow retry records a larger cmax)
    plan = tqm.plan_tiled(TILED_QUERIES, DIM, tree.n_real, tree.num_buckets,
                          tree.bucket_size, K, use_kernel=True, device=dev)
    sq, _ = tqm._sort_queries(tq_all, plan.bits, (-TILED_QUERIES) % plan.qbatch)
    FRONTIER_RECS["main"] = phase_frontier(tree, sq, plan, engine, served, vq, smi)

    # 5. the kernels at the main path's shapes
    recs = phase_shapes(tree, sq, plan)
    say("main", f"one tiled batch (plan tile={plan.tile} cmax={plan.cmax} "
                f"seeds={plan.seeds} qbatch={plan.qbatch}), ms by stage: "
                + ", ".join(f"{n} {t:.3f}" for n, t in recs["stages"].items())
                + " (the frontier kernel through its wrapper; a launch in a CUDA graph: "
                + ", ".join(f"{n} {t:.3f}" for n, t in recs["graph stages"].items())
                + "; the plain frontier: "
                + ", ".join(f"{n} {t:.3f}" for n, t in recs["plain stages"].items())
                + f"); the batch in a capture window after {recs['batch']['spins']} spin "
                f"kernels (taken out): {recs['batch']['slices']} device launches (kernels, "
                f"copies, fills), busy {recs['batch']['busy_ms']:.3f} ms, frontier_kernel "
                f"{recs['batch']['frontier_ms']:.3f} ms over {recs['batch']['frontier_launches']} "
                f"launches in the timeline (frontier.launches over the batch "
                f"{FRONTIER_LAUNCHES['5']}); launches by kernel {recs['batch']['top']} [{smi}]")
    main_rec, sparse = recs["main"], recs[7]

    # 6. the DFS engine and the CLI
    cli_lines, _ = phase_cli(dev, points, tree, here, "--dfs-round-sweep" in argv)
    for line in cli_lines:
        say("cli", line)

    # 7. the HTTP front over the mutable index, in process and as the CLI
    serve_lines, _ = phase_serve(dev, points, tree, here, smi)
    for line in serve_lines:
        say("serve", line)

    # 8. snapshots, the blue/green follower and the query verbs
    for line in phase_snapshot(dev, points, tree, here, smi, build_s):
        say("snapshot", line)

    # 9. distances above 32 axes, the recall dial, the ladder and tune
    t0 = time.perf_counter()
    phase_recall(dev, points, tree, smi)
    del engine
    torch.cuda.empty_cache()
    wide_err = phase_wide(dev, smi)
    assert wide_err == 0.0, f"D > 32: kernel or tiled run differs by {wide_err}"
    max_err = max(max_err, wide_err)
    say("recall", f"phase 9 in {time.perf_counter() - t0:.1f} s; the whole run "
                  f"{time.perf_counter() - t_run:.1f} s [{smi}]")

    # 10. the classic median-split trees
    t0 = time.perf_counter()
    classic_lines, _ = phase_classic(dev, points, here, smi)
    for line in classic_lines:
        say("classic", line)
    say("classic", f"phase 10 in {time.perf_counter() - t0:.1f} s; the whole run "
                   f"{time.perf_counter() - t_run:.1f} s [{smi}]")

    # 11. device observability: profile, the served window, costs, traces,
    # the duty cycle, --metrics-out
    t0 = time.perf_counter()
    phase_obs(dev, points, tree, here, smi, keep)
    del points, tree
    say("obs", f"phase 11 in {time.perf_counter() - t0:.1f} s; the whole run "
               f"{time.perf_counter() - t_run:.1f} s [{smi}]")
    torch.cuda.empty_cache()

    # 12. the multi-device engines
    f_launches, f_merges, _ = _phase12(dev, here, smi, t_run)
    launches += f_launches
    merges += f_merges
    torch.cuda.empty_cache()

    # 13. the serving fleet: partition, routed shards in process, the CLI fleet
    f_launches, f_merges, alone = _phase13(dev, here, smi, t_run, keep)
    launches += f_launches
    merges += f_merges
    torch.cuda.empty_cache()

    # 14. the sanitizer on a served shard, trend, lint, the metric families
    t0 = time.perf_counter()
    tool_lines, t_launches, t_merges = phase_tools(dev, here, smi, keep, tiled_s, alone)
    for line in tool_lines:
        say("tools", line)
    launches += t_launches
    merges += t_merges
    say("tools", f"phase 14 in {time.perf_counter() - t0:.1f} s; the whole run "
                 f"{time.perf_counter() - t_run:.1f} s [{smi}]")

    print_record(kind, smi, launches, merges, max_err, main_rec, sparse)
    return 0


def _phase12(dev, here, smi, t_run):
    """Phase 12 with its lines printed; returns its launch counts and its
    kernel records."""
    t0 = time.perf_counter()
    _, launches, merges, recs = phase_forest(dev, here, smi)
    say("forest", f"phase 12 in {time.perf_counter() - t0:.1f} s; the whole run "
                  f"{time.perf_counter() - t_run:.1f} s [{smi}]")
    return launches, merges, recs


# ---------------------------------------------------------------------------
# 13. the fleet
# ---------------------------------------------------------------------------


def _spawn(cmd, here, log, env=None):
    """A child process of the fleet, its stderr to ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen(cmd, cwd=here, stdout=subprocess.DEVNULL, stderr=f, env=env)


def _ready_port(proc, log, deadline):
    """The port of a child's ``ready: ... on port N`` line."""
    while True:
        text = Path(log).read_text()
        for line in text.splitlines():
            if line.startswith("ready:"):
                return int(line.rsplit(" ", 1)[1])
        if proc.poll() is not None:
            raise AssertionError(f"{log} exited {proc.returncode} before ready: {text[-2000:]}")
        if time.perf_counter() > deadline:
            raise AssertionError(f"{log} not ready in time: {text[-2000:]}")
        time.sleep(0.1)


def _cuda_holders(pids):
    """Which of ``pids`` hold a CUDA context: listed by ``nvidia-smi
    --query-compute-apps`` (when it sees this namespace's pids) or holding
    a /dev/nvidia* file open (a CUDA context opens the device files;
    importing torch does not)."""
    import os

    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    listed = {int(x) for x in out.split() if x.strip().isdigit()}
    held = {}
    for pid in pids:
        fds = Path(f"/proc/{pid}/fd")
        opened = False
        for fd in (fds.iterdir() if fds.exists() else ()):
            try:
                opened = opened or os.readlink(fd).startswith("/dev/nvidia")
            except OSError:
                pass
        held[pid] = (pid in listed, opened)
    return held


def _same_answer(routed, d2, ids, what):
    """A routed /v1/knn body against the single index's (d2, ids): the
    distances byte-equal (float64 sqrt of the f32 d2), the ids equal except
    between exactly tied distances. Returns the differing tied slots."""
    dist = np.sqrt(d2.astype(np.float64))
    got_d = np.asarray(routed["distances"], dtype=np.float64)
    got_i = np.asarray(routed["ids"], dtype=np.int64)
    assert routed["degraded"] is None, f"{what}: degraded {routed['degraded']}"
    assert got_d.shape == dist.shape and np.array_equal(got_d, dist), f"{what}: distances differ"
    diff = got_i != ids
    tied = np.zeros_like(diff)
    tied[:, 1:] |= dist[:, 1:] == dist[:, :-1]
    tied[:, :-1] |= dist[:, :-1] == dist[:, 1:]
    assert not (diff & ~tied).any(), f"{what}: ids differ outside ties"
    return int(diff.sum())


def phase_fleet(dev, here, smi, keep):
    """Phase 13: the serving fleet (see the module docstring). Returns its
    lines, the scan and merge launches of the in-process fleet's routed
    requests, and shard 0's ms by request rows when sent directly. Leaves
    shard 0's snapshot and the loadgen report in ``keep`` for phase 14."""
    import os
    import shutil
    import signal
    import tempfile

    import torch

    from kdtree_tpu_torch import snapshot
    from kdtree_tpu_torch.kernels import scan_knn as scan_mod
    from kdtree_tpu_torch.kernels.frontier import frontier
    from kdtree_tpu_torch.obs import slo as obs_slo
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.ops.morton import morton_codes, morton_view
    from kdtree_tpu_torch.serve import engine as lifecycle
    from kdtree_tpu_torch.serve import router as rt
    from kdtree_tpu_torch.serve import server as srv
    from kdtree_tpu_torch.serve import spatial as sp
    from kdtree_tpu_torch.serve.engine import batch_bucket

    lines = []
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    fleet_dir = os.path.join(tmp, "fleet")
    dev_args = [] if dev.type == "cuda" else ["--device", str(dev)]
    base = [sys.executable, "-m", "kdtree_tpu_torch"]
    servers, routers, procs = [], [], []
    try:
        # 1. partition: the CLI in a subprocess, then the coder check
        t0 = time.perf_counter()
        out = subprocess.run(base + dev_args + [
            "--generator", "threefry", "partition", "--seed", str(SEED), "--dim", str(DIM),
            "--n", str(FLEET_N), "--shards", str(FLEET_SHARDS), "--k", str(K),
            "--max-batch", str(MAX_BATCH), "--out-dir", fleet_dir],
            cwd=here, capture_output=True, text=True, timeout=600)
        part_s = time.perf_counter() - t0
        assert out.returncode == 0, out.stderr[-3000:]
        lines.append(f"partition --n {FLEET_N} --shards {FLEET_SHARDS}: {part_s:.2f} s "
                     "(a subprocess: device init, generation, host Morton cut, 4 shard "
                     "builds and snapshot saves)")
        lines += [ln for ln in out.stdout.splitlines() if ln.startswith("shard ")]
        with open(os.path.join(fleet_dir, sp.PARTITION_MANIFEST)) as f:
            pman = json.load(f)
        grid = sp.SpatialGrid.from_json(pman["grid"])
        pts = generate_points_rowwise(SEED, DIM, FLEET_N, device=dev)
        t0 = time.perf_counter()
        dcodes = morton_codes(pts, grid.bits, lo=torch.as_tensor(grid.lo, device=dev),
                              hi=torch.as_tensor(grid.hi, device=dev))
        hcodes = sp.morton_codes_np(pts.cpu().numpy(), grid)
        assert np.array_equal(dcodes.cpu().numpy(), hcodes.astype(np.int64)), \
            "morton_codes_np differs from the device coder"
        order = torch.sort(dcodes, stable=True).indices
        lines.append(f"morton_codes_np == morton_codes on the card, bit for bit, over all "
                     f"{FLEET_N} points ({time.perf_counter() - t0:.2f} s)")
        gid_all = torch.arange(FLEET_N, dtype=torch.int32, device=dev)
        single = morton_view(pts[order], gid=gid_all, n_real=FLEET_N)
        shard_trees = []
        for i, ent in enumerate(pman["entries"]):
            s, e = ent["id_range"]
            tree, man = snapshot.load_snapshot(os.path.join(fleet_dir, f"shard-{i:02d}"),
                                               device=dev)
            want = morton_view(pts[order[s:e]], gid=gid_all[s:e], n_real=e - s)
            for name in ("node_lo", "node_hi", "bucket_pts", "bucket_gid"):
                assert torch.equal(getattr(tree, name), getattr(want, name)), (i, name)
            assert man["meta"]["spatial"]["code_range"] == ent["code_range"]
            shard_trees.append((tree, man))
        lines.append("each shard's snapshot arrays equal a Morton view of its slice of the "
                     "device coder's stable order (global ids = Morton ranks)")

        # 2. the in-process fleet: four servers on the card behind make_router
        t0 = time.perf_counter()
        for tree, man in shard_trees:
            state = lifecycle.build_state(tree=tree, k=K, max_batch=MAX_BATCH,
                                          meta={"spatial": man["meta"]["spatial"]})
            # four servers in one process share one registry, so each SLO
            # engine would judge the four's requests together (and page the
            # router into ejecting shards for the others' 1,000-row
            # batches): in process they run with no SLO specs
            state.slo_engine = obs_slo.SloEngine(specs=[], history=state.slo_engine.history)
            httpd = srv.make_server(state, port=0)
            httpd.start()
            servers.append(httpd)
        urls = [f"http://127.0.0.1:{h.server_address[1]}" for h in servers]
        warm_s = time.perf_counter() - t0
        for fanout in ("selective", "full"):
            router = rt.make_router(urls, config=rt.RouterConfig(deadline_s=120.0,
                                                                 fanout=fanout))
            router.start(health_loop=True)
            routers.append(router)
        deadline = time.perf_counter() + 120
        while not all(ss.box() is not None and ss.code_range_known() is not None
                      for r in routers for ss in r.shard_sets):
            assert time.perf_counter() < deadline, "the routers never learned the boxes"
            time.sleep(0.05)
        lines.append(f"in-process fleet: {FLEET_SHARDS} ServeStates on {dev} warmed "
                     f"(ladder 8..{MAX_BATCH}) in {warm_s:.2f} s, selective and full routers")
        reqs = []
        for i, rows in enumerate(FLEET_ROWS):
            q = generate_queries(SEED + 300 + i, DIM, rows, device=dev)
            d2, ids = tqm.morton_knn_tiled(single, q, k=K)
            reqs.append((rows, q.cpu().numpy(), d2.cpu().numpy(), ids.cpu().numpy()))
        inner = [h.state.engine for h in servers]
        scan_mod.scan_tiles.launches = 0
        scan_mod.merge_partials.launches = 0
        frontier.launches = 0
        answers = {}
        ties = 0
        for router, fanout in zip(routers, ("selective", "full")):
            for rows, q, d2, ids in reqs:
                r0 = [e._state.inner.stats.retries for e in inner]
                l0 = scan_mod.scan_tiles.launches
                t0 = time.perf_counter()
                st, _, body = _http(router.server_address[1], "POST", "/v1/knn",
                                    {"queries": q.tolist(), "k": K})
                ms = (time.perf_counter() - t0) * 1e3
                assert st == 200, (st, body)
                ties += _same_answer(body, d2, ids, f"{fanout} {rows} rows")
                answers[(fanout, rows)] = body
                sh = body["shards"]
                lines.append(
                    f"{fanout} {rows} rows: router {ms:.2f} ms, contacted {sh['contacted']}/"
                    f"{sh['total']} (fan-out {sh['contacted'] / sh['total']:.2f}, pruned "
                    f"{sh['pruned']}), overflow retries by shard "
                    f"{[e._state.inner.stats.retries - r for e, r in zip(inner, r0)]}, "
                    f"{scan_mod.scan_tiles.launches - l0} scan launches; byte-identical to "
                    "the single index")
        launches = scan_mod.scan_tiles.launches
        merges = scan_mod.merge_partials.launches
        FRONTIER_LAUNCHES["13"] = frontier.launches
        assert launches > 0, "the fleet's shards never launched the scan kernel"
        assert frontier.launches > 0, "the fleet's shards never launched the frontier kernel"
        lines.append(f"in-process fleet: scan_tiles.launches={launches}, "
                     f"merge_partials.launches={merges}, frontier.launches="
                     f"{frontier.launches} over the {2 * len(FLEET_ROWS)} routed "
                     f"requests; {ties} id slots differ from the single index, each a tie")
        for rows, q, _, _ in reqs:
            if rows != 64:
                continue
            shard_ms = []
            for url in urls:
                t0 = time.perf_counter()
                st, _, _ = _http(int(url.rsplit(":", 1)[1]), "POST", "/v1/knn",
                                 {"queries": q.tolist(), "k": K})
                shard_ms.append((time.perf_counter() - t0) * 1e3)
                assert st == 200
            lines.append(f"64 rows sent to each shard directly: "
                         + ", ".join(f"{m:.2f}" for m in shard_ms) + " ms")
        # one shard's scan at its serving shape, against the plain scan
        tree0 = shard_trees[0][0]
        q = torch.as_tensor(reqs[2][1], device=dev)
        bucket = batch_bucket(q.shape[0], MAX_BATCH)
        q = torch.cat([q, q[-1:].expand(bucket - q.shape[0], DIM)])
        plan = tqm.plan_tiled(bucket, DIM, tree0.n_real, tree0.num_buckets, tree0.bucket_size,
                              K, device=dev)
        sq, _ = tqm._sort_queries(q, plan.bits, (-bucket) % plan.qbatch)
        stq = sq.reshape(-1, plan.tile, DIM).contiguous()
        c, lb = collect_inputs(tree0, stq, K, plan.seeds, plan.cmax, grow=True)
        time_shape("fleet shard 0, serve 64 rows", tree0, stq, c, lb, K, 64, 20, 3)
        for r in routers:
            r.stop()
        routers.clear()
        for h in servers:
            h.stop()
        servers.clear()
        del single, pts, order, dcodes, shard_trees
        torch.cuda.empty_cache()

        # 3. the user's path: serve x4 + a read replica of shard 0, route, loadgen
        t0 = time.perf_counter()
        deadline = t0 + FLEET_READY_S
        snaps = [os.path.join(fleet_dir, f"shard-{i:02d}") for i in range(FLEET_SHARDS)]
        for i, sdir in enumerate(snaps):
            procs.append(("serve", _spawn(base + dev_args + [
                "serve", "--snapshot", sdir, "--port", "0", "--k", str(K), "--debug-faults"],
                here, os.path.join(tmp, f"serve{i}.log"))))
        procs.append(("replica", _spawn(base + dev_args + [
            "serve", "--snapshot", snaps[0], "--snapshot-follow", "1.0", "--port", "0",
            "--k", str(K)], here, os.path.join(tmp, "replica.log"))))
        logs = [os.path.join(tmp, f"serve{i}.log") for i in range(FLEET_SHARDS)] + \
            [os.path.join(tmp, "replica.log")]
        ports = [_ready_port(p, g, deadline) for (_, p), g in zip(procs, logs)]
        entries = [f"http://127.0.0.1:{ports[0]}|http://127.0.0.1:{ports[-1]}"] + \
            [f"http://127.0.0.1:{p}" for p in ports[1:FLEET_SHARDS]]
        rlog = os.path.join(tmp, "route.log")
        rproc = _spawn(base + ["route", *sum((["--shard", e] for e in entries), []),
                               "--port", "0", "--deadline-ms", str(FLEET_DEADLINE_MS)],
                       here, rlog)
        procs.append(("route", rproc))
        rport = _ready_port(rproc, rlog, deadline)
        while True:
            st, _, health = _http(rport, "GET", "/healthz")
            if st == 200 and health.get("available") == FLEET_SHARDS and all(
                    s.get("routable") for s in health["shards"]):
                break
            assert time.perf_counter() < deadline, health
            time.sleep(0.2)
        lines.append(f"CLI fleet: {FLEET_SHARDS} `serve --snapshot` + 1 `--snapshot-follow` "
                     f"replica of shard 0 + `route` ready, every shard routable, in "
                     f"{time.perf_counter() - t0:.2f} s")
        # each request size through the router (twice: the second is timed)
        # beside the same rows sent to each shard process directly
        alone = {}
        for rows, q, d2, ids in reqs:
            for _ in range(2):
                t0 = time.perf_counter()
                st, _, body = _http(rport, "POST", "/v1/knn", {"queries": q.tolist(), "k": K})
                ms = (time.perf_counter() - t0) * 1e3
                assert st == 200, body
            want = answers[("selective", rows)]
            assert (body["ids"], body["distances"]) == (want["ids"], want["distances"]), \
                f"the CLI fleet's {rows}-row answer differs from the in-process fleet's"
            shard_ms = []
            for port in ports[:FLEET_SHARDS]:
                t0 = time.perf_counter()
                st, _, _ = _http(port, "POST", "/v1/knn", {"queries": q.tolist(), "k": K})
                shard_ms.append((time.perf_counter() - t0) * 1e3)
                assert st == 200
            alone[rows] = shard_ms[0]
            sh = body["shards"]
            lines.append(f"CLI fleet {rows} rows: router {ms:.2f} ms, contacted "
                         f"{sh['contacted']}/{sh['total']}; the shards directly "
                         + ", ".join(f"{m:.2f}" for m in shard_ms)
                         + " ms; byte-identical to the in-process fleet's answer")
        # writes: 16 upserts owned by shards 1-3 (shard 0 has a read replica,
        # which serves its snapshot's epoch), then 8 deletes
        cr = [tuple(e["code_range"]) for e in pman["entries"]]
        rng = np.random.default_rng(SEED)
        cand = (rng.random((512, DIM)) * 200.0 - 100.0).astype(np.float32)
        cand = cand[sp.owner_of(cand, grid, cr) > 0][:16]
        new_ids = list(range(FLEET_N + 1000, FLEET_N + 1016))
        st, _, up = _http(rport, "POST", "/v1/upsert",
                          {"ids": new_ids, "points": cand.tolist()})
        assert st == 200 and up["applied"] == 16 and up["routing"] == "spatial", up
        st, _, back = _http(rport, "POST", "/v1/knn", {"queries": cand.tolist(), "k": 1})
        assert st == 200 and back["ids"] == [[i] for i in new_ids], back
        assert back["distances"] == [[0.0]] * 16
        st, _, de = _http(rport, "POST", "/v1/delete", {"ids": new_ids[:8]})
        assert st == 200 and de["applied"] == 8, de
        st, _, back = _http(rport, "POST", "/v1/knn", {"queries": cand.tolist(), "k": 1})
        got = [r[0] for r in back["ids"]]
        assert got[8:] == new_ids[8:] and not set(got[:8]) & set(new_ids[:8]), got
        lines.append("16 upserts (spatial routing) and 8 deletes through the router, read "
                     "back through it")
        lg_out = os.path.join(tmp, "loadgen.json")
        lgproc = _spawn(base + ["loadgen", "--target", f"http://127.0.0.1:{rport}",
                                "--rates", FLEET_RATES, "--step-seconds", str(FLEET_STEP_S),
                                "--seed", str(SEED), "--out", lg_out],
                        here, os.path.join(tmp, "loadgen.log"))
        procs.append(("loadgen", lgproc))
        time.sleep(FLEET_STEP_S)
        shard_pids = [p.pid for name, p in procs if name in ("serve", "replica")]
        held = _cuda_holders(shard_pids + [rproc.pid, lgproc.pid])
        assert lgproc.wait(timeout=300) == 0, Path(tmp, "loadgen.log").read_text()[-3000:]
        assert all(held[p][0] or held[p][1] for p in shard_pids), \
            f"the check sees no CUDA context even in the shards: {held}"
        for name, pid in (("route", rproc.pid), ("loadgen", lgproc.pid)):
            assert held[pid] == (False, False), f"{name} holds a CUDA context: {held[pid]}"
        listed = sum(held[p][0] for p in shard_pids)
        lines.append(f"CUDA contexts: the 5 shard processes hold one each (nvidia-smi lists "
                     f"{listed} of them; all hold /dev/nvidia* open); route and loadgen "
                     "hold none")
        with open(lg_out) as f:
            cap = json.load(f)["capacity"]
        lines.append(f"loadgen --rates {FLEET_RATES} --step-seconds {FLEET_STEP_S}: knee "
                     f"{cap['knee_rate']} req/s (slo {cap['slo_ms']} ms at p"
                     f"{int(round(cap.get('slo_quantile', 0.99) * 100))})")
        for s in cap["steps"]:
            lines.append(f"  rate {s['rate']:g}: p50 {s['p50_ms']} p95 {s['p95_ms']} p99 "
                         f"{s['p99_ms']} ms, goodput {s['goodput_rps']} req/s, bad "
                         f"{s['bad_frac']}, fanout_frac {s['fanout_frac']}")
        st, _, text = _http(rport, "GET", "/metrics")
        rate = [ln for ln in text.splitlines() if ln.startswith("kdtree_loadgen_offered_rate ")]
        assert rate and float(rate[0].split()[1]) == float(FLEET_RATES.split(",")[-1]), rate
        lines.append(f"router /metrics: {rate[0]}")
        # the fault drill, last: a hang on shard 3 (its SLO may page after it,
        # and the router would eject the shard for the burn window)
        st, _, _ = _http(ports[3], "POST", "/debug/faults", {"spec": "knn=hang"})
        assert st == 200
        spread = (np.random.default_rng(SEED + 5).random((64, DIM)) * 200.0 - 100.0)
        t0 = time.perf_counter()
        st, _, body = _http(rport, "POST", "/v1/knn",
                            {"queries": spread.astype(np.float32).tolist(), "k": K})
        drill_ms = (time.perf_counter() - t0) * 1e3
        _http(ports[3], "POST", "/debug/faults", {"clear": True})
        assert st == 200 and body["degraded"] == f"partial:3/{FLEET_SHARDS}", body
        assert body["shards"]["missing"] == [3], body["shards"]
        assert drill_ms < FLEET_DEADLINE_MS + 1000, drill_ms
        lines.append(f"fault drill (knn=hang on shard 3): degraded "
                     f"{body['degraded']!r} in {drill_ms:.1f} ms (--deadline-ms "
                     f"{FLEET_DEADLINE_MS})")
        for name, p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for (name, p), log in zip(procs, logs + [rlog]):
            assert p.wait(timeout=120) == 0 and "drained; bye" in Path(log).read_text(), \
                (name, Path(log).read_text()[-2000:])
        lines.append("SIGTERM: route and every serve process drained, exit 0")
        shutil.copytree(snaps[0], keep / "shard-00")
        shutil.copy(lg_out, keep / "loadgen.json")
    finally:
        for r in routers:
            r.stop()
        for h in servers:
            h.stop()
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    timed = re.compile(r"\d (ms|s)\b")
    lines = [f"{line} [{smi}]" if timed.search(line) else line for line in lines]
    return lines, launches, merges, alone


def _phase13(dev, here, smi, t_run, keep):
    """Phase 13 with its lines printed; returns its launch counts and shard
    0's ms by rows."""
    t0 = time.perf_counter()
    lines, launches, merges, alone = phase_fleet(dev, here, smi, keep)
    for line in lines:
        say("fleet", line)
    say("fleet", f"phase 13 in {time.perf_counter() - t0:.1f} s; the whole run "
                 f"{time.perf_counter() - t_run:.1f} s [{smi}]")
    return launches, merges, alone


# ---------------------------------------------------------------------------
# 14. the sanitizer, trend, lint and the tiled engine's metric families
# ---------------------------------------------------------------------------


def _tools_load(port, pool, new_ids, new_pts):
    """TOOLS_CLIENTS threads against one server for TOOLS_LOAD_S: 1-, 64-
    and 1,000-row /v1/knn, 64-row /v1/radius, and one thread writing
    TOOLS_UPSERTS upserts then TOOLS_DELETES deletes, spaced over the
    window. Returns the ms of every request by (path, rows); any non-200
    answer fails."""
    import collections
    import threading

    kinds = [("knn", 1), ("knn", 1), ("knn", 64), ("knn", 64), ("knn", 1000),
             ("radius", 64), ("writes", 1), ("knn", 1)][:TOOLS_CLIENTS]
    lat = collections.defaultdict(list)
    errors = []
    stop = time.perf_counter() + TOOLS_LOAD_S

    def timed(path, body, key):
        t0 = time.perf_counter()
        st, _, resp = _http(port, "POST", path, body)
        assert st == 200, (path, st, resp)
        lat[key].append((time.perf_counter() - t0) * 1e3)

    def client(i, kind, rows):
        try:
            if kind == "writes":
                gap = TOOLS_LOAD_S / (TOOLS_UPSERTS + TOOLS_DELETES + 1)
                for j, pid in enumerate(new_ids):
                    time.sleep(gap)
                    timed("/v1/upsert", {"ids": [pid], "points": [new_pts[j].tolist()]},
                          ("upsert", 1))
                for pid in new_ids[:TOOLS_DELETES]:
                    time.sleep(gap)
                    timed("/v1/delete", {"ids": [pid]}, ("delete", 1))
                return
            rs = np.random.default_rng(SEED + i)
            while time.perf_counter() < stop:
                a = int(rs.integers(0, len(pool) - rows + 1))
                q = pool[a:a + rows].tolist()
                if kind == "knn":
                    timed("/v1/knn", {"queries": q, "k": K}, ("knn", rows))
                else:
                    timed("/v1/radius", {"queries": q, "r": VERB_R}, ("radius", rows))
        except Exception as e:  # reported by the caller, which fails the phase
            errors.append(f"{kind} {rows}: {e!r}")

    threads = [threading.Thread(target=client, args=(i, k, r)) for i, (k, r) in enumerate(kinds)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TOOLS_LOAD_S + 600)
    assert not any(t.is_alive() for t in threads), "a client thread never finished"
    assert not errors, errors
    return lat


def phase_tools(dev, here, smi, keep, tiled_s, alone):
    """Phase 14 (see the module docstring): the sanitizer on a served
    shard, ``trend`` over this run's bench and loadgen artifacts, ``lint``,
    and the three metric families of a full-width build and tiled run.
    Returns its lines and the scan and merge launches of that tiled run."""
    import os
    import shutil
    import signal
    import tempfile

    import torch

    from kdtree_tpu_torch import obs, snapshot
    from kdtree_tpu_torch.kernels import scan_knn as scan_mod
    from kdtree_tpu_torch.kernels.frontier import frontier
    from kdtree_tpu_torch.obs.registry import get_registry
    from kdtree_tpu_torch.ops import tile_query as tqm
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.ops.morton import build_morton
    from kdtree_tpu_torch.tuning.store import default_store
    from kdtree_tpu_torch.verbs import oracle as vo

    lines = []
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-tools-"))
    base = [sys.executable, "-m", "kdtree_tpu_torch"]
    dev_args = [] if dev.type == "cuda" else ["--device", str(dev)]
    proc = None
    try:
        # (a) the lock-order sanitizer in a served shard under load
        t_a = time.perf_counter()
        snap = str(keep / "shard-00")
        tree, _ = snapshot.load_snapshot(snap, device=dev)
        gid = tree.bucket_gid.reshape(-1).long()
        real = gid >= 0
        n0 = int(gid.max()) + 1
        new_ids = list(range(n0 + 1000, n0 + 1000 + TOOLS_UPSERTS))
        ext = torch.full((new_ids[-1] + 1, DIM), float("inf"), device=dev)
        ext[gid[real]] = tree.bucket_pts.reshape(-1, DIM)[real]
        del tree, gid, real
        new_pts = (np.random.default_rng(SEED + 14).random((TOOLS_UPSERTS, DIM)) * 200.0
                   - 100.0).astype(np.float32)
        pool = generate_queries(SEED + 140, DIM, 1000, device=dev).cpu().numpy()
        ext[new_ids] = torch.as_tensor(new_pts, device=dev)
        ext[new_ids[:TOOLS_DELETES]] = float("inf")
        ora = Oracle(ext, pool)  # the point set after the load's writes
        rad = vo.radius_oracle(ext, pool[:64], VERB_R)
        lats = {}
        # the same load on the sanitized server, then on a plain one: the
        # difference is the sanitizer's cost under this load
        for sanitized in (True, False):
            env = dict(os.environ, KDTREE_TPU_LOCKWATCH_DIR=str(work))
            env.pop("KDTREE_TPU_LOCKWATCH", None)
            if sanitized:
                env["KDTREE_TPU_LOCKWATCH"] = "1"
            what = "sanitized" if sanitized else "plain"
            log = str(work / f"serve-{what}.log")
            t0 = time.perf_counter()
            # the ladder disarmed: under this load it may step to the
            # approximate gear (phase 9 checks it), and the answers here
            # are held to the oracle
            proc = _spawn(base + dev_args + ["serve", "--snapshot", snap, "--port", "0",
                                             "--k", str(K), "--no-ladder"], here, log, env=env)
            port = _ready_port(proc, log, t0 + FLEET_READY_S)
            ready_s = time.perf_counter() - t0
            lats[what] = lat = _tools_load(port, pool, new_ids, new_pts)
            lines.append(f"(a) {what} `serve --snapshot --no-ladder` of phase 13's shard 0 "
                         f"({n0} points) ready in {ready_s:.2f} s; {TOOLS_CLIENTS} clients for "
                         f"{TOOLS_LOAD_S:g} s: {sum(len(v) for v in lat.values())} requests, all "
                         f"200 ({TOOLS_UPSERTS} upserts, {TOOLS_DELETES} deletes among them)")
            # answers after the writes settled, against the oracle
            ties = 0
            for rows in (1, 64, 1000):
                st, _, resp = _http(port, "POST", "/v1/knn",
                                    {"queries": pool[:rows].tolist(), "k": K})
                assert st == 200 and resp["degraded"] is None, resp
                ties += ora.check(list(range(rows)), resp, K, f"{what} {rows} rows")
            st, _, back = _http(port, "POST", "/v1/knn", {"queries": new_pts.tolist(), "k": 1})
            got = [r[0] for r in back["ids"]]
            assert got[TOOLS_DELETES:] == new_ids[TOOLS_DELETES:] and \
                not set(got[:TOOLS_DELETES]) & set(new_ids[:TOOLS_DELETES]), got
            st, _, resp = _http(port, "POST", "/v1/radius",
                                {"queries": pool[:64].tolist(), "r": VERB_R})
            assert st == 200, resp
            _check_verb(f"{what} radius", resp, rad, "radius")
            lines.append(f"(a) {what}, after the load: 1-, 64- and 1,000-row answers equal the "
                         f"oracle over the written point set ({ties} tied slots), the upserts "
                         "read back and the deletes gone, 64-row radius equal to its oracle")
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=120) == 0, Path(log).read_text()[-3000:]
            text = Path(log).read_text()
            assert "drained; bye" in text and "LockOrderError" not in text, text[-3000:]
            graph = work / f"lockwatch-graph-{proc.pid}.json"
            pid, proc = proc.pid, None
            if not sanitized:
                assert not graph.exists(), "a plain server dumped a lock graph"
                continue
            assert graph.exists(), sorted(p.name for p in work.iterdir())
            doc = json.loads(graph.read_text())
            assert doc["cycles"] == [], doc["cycles"]
            roles = sorted(doc["locks"])
            assert "mutable.engine" in roles and any(r.startswith("serve.") for r in roles), roles
            holds = [(v["lock"], v["held_ms"]) for v in doc["violations"]]
            lines.append(f"(a) SIGTERM: drained, exit 0, no LockOrderError; "
                         f"lockwatch-graph-{pid}.json: {len(roles)} roles ({', '.join(roles)}), "
                         f"{len(doc['edges'])} order edges, 0 cycles; I/O holds past "
                         f"{doc['hold_budget_ms']:g} ms (lock, ms): {holds}")
        for key in sorted(lats["sanitized"]):
            path, rows = key
            on, off = lats["sanitized"][key], lats["plain"].get(key, [float("nan")])
            extra = (f"; phase 13's shard 0 alone {alone[rows]:.2f} ms"
                     if path == "knn" and rows in alone else "")
            lines.append(f"(a) {path} {rows} rows, p50 / p99 ms: sanitized "
                         f"{np.percentile(on, 50):.2f} / {np.percentile(on, 99):.2f} (n={len(on)}), "
                         f"plain {np.percentile(off, 50):.2f} / {np.percentile(off, 99):.2f} "
                         f"(n={len(off)}){extra}")
        lines.append(f"(a) in {time.perf_counter() - t_a:.1f} s")
        del ext, ora

        # (b) trend over this run's own bench sidecars and loadgen report
        t0 = time.perf_counter()
        series = [str(keep / f) for f in ("bench-0.json", "bench-1.json", "loadgen.json")]
        argv = base + ["trend", *series, "--baseline", str(work / "trend_baseline.json")]
        out = subprocess.run(argv + ["--format", "json"], cwd=here, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode in (0, 1), out.stderr[-3000:]
        rep = json.loads(out.stdout)
        assert [r["label"] for r in rep["runs"]] == ["bench-0", "bench-1", "loadgen"], rep
        plats = [r["platform"] for r in rep["runs"]]
        assert set(plats[:2]) <= ({"cuda", "gpu"} if dev.type == "cuda" else {dev.type}), plats
        human = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=300)
        assert human.returncode == out.returncode, human.stderr[-3000:]
        lines.append(f"(b) trend over bench-0, bench-1 and loadgen: exit {out.returncode}, "
                     f"platforms {plats}, band {rep['band']:g}, {len(rep['findings'])} "
                     f"finding(s) in {time.perf_counter() - t0:.2f} s")
        lines += [f"(b)   {ln}" for ln in human.stdout.splitlines() if ln.strip()]

        # (c) lint on the port's tree against its baseline
        t0 = time.perf_counter()
        out = subprocess.run(base + ["lint"], cwd=here, capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
        lines.append(f"(c) lint: exit 0 in {time.perf_counter() - t0:.2f} s: "
                     + out.stdout.strip().splitlines()[-1])

        # (d) the metric families at full width, in process
        reg = get_registry()

        def families():
            snap_ = reg.snapshot()
            h = snap_["histograms"].get("kdtree_bucket_occupancy") or {"count": 0, "sum": 0.0}
            c = snap_["counters"]
            return (h["count"], h["sum"], c.get("kdtree_tile_batches_total", 0.0),
                    c.get("kdtree_tile_overflow_retries_total", 0.0))

        obs.flush()
        obs.set_enabled(True)
        scan_mod.scan_tiles.launches = 0
        scan_mod.merge_partials.launches = 0
        frontier.launches = 0
        try:
            before = families()
            points = generate_points_rowwise(SEED, DIM, N_POINTS, device=dev)
            t0 = time.perf_counter()
            tree = build_morton(points, bucket_cap=BUCKET)
            _sync(dev)
            build_s = time.perf_counter() - t0
            tq_all = generate_queries(SEED, DIM, TILED_QUERIES, device=dev)
            stats = tqm.TileStats()
            _sync(dev)
            t0 = time.perf_counter()
            td2, tids = tqm.morton_knn_tiled(tree, tq_all, k=K, stats=stats)
            _sync(dev)
            on_s = time.perf_counter() - t0
            launches = scan_mod.scan_tiles.launches
            merges = scan_mod.merge_partials.launches
            FRONTIER_LAUNCHES["14"] = frontier.launches
            t0 = time.perf_counter()
            obs.flush()
            flush_s = time.perf_counter() - t0
            after = families()
        finally:
            obs.set_enabled(None)
        nb = tree.bucket_gid.shape[0]
        assert launches > 0, "phase 14's tiled run never launched the scan kernel"
        d = [a - b for a, b in zip(after, before)]
        assert d[0] == nb and d[1] == N_POINTS, (d, nb)
        assert d[2] == stats.batches == TILED_QUERIES // tqm._BATCH_Q, (d, stats.batches)
        assert d[3] == stats.retries, (d, stats.retries)
        sample = torch.as_tensor(np.random.default_rng(SEED + 14).choice(
            TILED_QUERIES, SAMPLE, replace=False), device=dev)
        ties = check_answer(points, tq_all[sample], td2[sample], tids[sample], K,
                            "metrics-on tiled sample")
        plan = tqm.plan_tiled(TILED_QUERIES, DIM, tree.n_real, tree.num_buckets,
                              tree.bucket_size, K, device=dev)
        prof = default_store().get(plan.sig) or {}
        # the gated metrics' cost: the same run off, on, on, off
        ab = {False: [], True: []}
        try:
            for on in (False, True, True, False):
                obs.set_enabled(on)
                _sync(dev)
                t0 = time.perf_counter()
                tqm.morton_knn_tiled(tree, tq_all, k=K)
                _sync(dev)
                ab[on].append(time.perf_counter() - t0)
                obs.flush()
        finally:
            obs.set_enabled(None)
        lines.append(f"(d) build_morton {N_POINTS} x {DIM} (B={BUCKET}) with the gated "
                     f"metrics on: {build_s:.3f} s; kdtree_bucket_occupancy count +{d[0]:g} "
                     f"(= {nb} buckets), sum +{d[1]:g} (= {N_POINTS} points)")
        lines.append(f"(d) morton_knn_tiled {TILED_QUERIES} queries k={K}, metrics on: "
                     f"{on_s:.3f} s beside phase 4's {tiled_s:.3f} s with them off; then "
                     f"off, on, on, off: {ab[False][0]:.3f}, {ab[True][0]:.3f}, "
                     f"{ab[True][1]:.3f}, {ab[False][1]:.3f} s; "
                     f"kdtree_tile_batches_total +{d[2]:g} (= {stats.batches} batches), "
                     f"kdtree_tile_overflow_retries_total +{d[3]:g} (= stats.retries "
                     f"{stats.retries}); {launches} scan / {merges} merge launches; "
                     f"deferred fetches {flush_s * 1e3:.1f} ms; sample exact "
                     f"vs oracle ({ties} tied slots); plan profile occupancy_p90 "
                     f"{prof.get('occupancy_p90')}, prune_rate {prof.get('prune_rate')}")
        assert prof.get("occupancy_p90") is not None, prof
        del points, tree, tq_all, td2, tids
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    timed = re.compile(r"\d (ms|s)\b")
    return [f"{line} [{smi}]" if timed.search(line) else line for line in lines], launches, merges


def print_record(kind, smi, launches, merges, max_err, main_rec, sparse):
    """The kernels' JSON line, the nvidia-smi line and the result line."""
    import torch

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
        "library_ms": sparse["merge_topk_ms"],
        "bound_all_bytes_ms": sparse["merge_bound_all_bytes_ms"],
    }]}
    for name, source, replaces in (
            ("verb_radius_fold", "kdtree_tpu_torch/csrc/verb_fold.cu",
             "kdtree_tpu/verbs/device.py:172"),
            ("verb_range_fold", "kdtree_tpu_torch/csrc/verb_fold.cu",
             "kdtree_tpu/verbs/device.py:219"),
            ("pair_d2", "kdtree_tpu_torch/csrc/pair_d2.cu", "kdtree_tpu/ops/bruteforce.py:44")):
        rec = FOLD_RECS[name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": FOLD_LAUNCHES[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec.get("library_ms"),
            "graph_ms": rec["graph_ms"],
            **({"all_pairs_bound_ms": rec["all_pairs_bound_ms"], "kept_frac": rec["kept_frac"]}
               if "kept_frac" in rec else {})})
    rec = FOLD_RECS["knn_scan"]  # the fallback shape
    record["kernels"].append({
        "name": "knn_scan", "route": "cuda", "source": "kdtree_tpu_torch/csrc/knn_scan.cu",
        "replaces": "kdtree_tpu/ops/bruteforce.py:59",
        "launches": sum(KNN_LAUNCHES.values()), "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None, "graph_ms": rec["graph_ms"],
        "issue_ms": rec["issue_ms"], "launches_by_phase": KNN_LAUNCHES,
        **({"fallback_batch_ms": KNN_RECS["fallback"]["ms"],
            "fallback_batch_culled_frac": KNN_RECS["fallback"]["culled_frac"],
            "fallback_batch_need_ms": KNN_RECS["fallback"]["need_ms"]}
           if "fallback" in KNN_RECS else {})})
    rec = FRONTIER_RECS["main"]  # the main tiled batch's collect descent
    record["kernels"].append({
        "name": "frontier", "route": "cuda", "source": "kdtree_tpu_torch/csrc/frontier.cu",
        "replaces": "kdtree_tpu/ops/tile_query.py:113",
        "launches": sum(FRONTIER_LAUNCHES.get(p, 0) for p in ("4", "8", "12", "13", "14")),
        "max_abs_err": 0.0, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        "graph_ms": rec["graph_ms"], "cluster": rec["cluster"],
        "launches_by_phase": FRONTIER_LAUNCHES})
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
