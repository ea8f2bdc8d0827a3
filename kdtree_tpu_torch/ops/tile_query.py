"""Tiled batched k-NN: Hilbert-sorted query tiles and dense bucket scans.

The port of ``kdtree_tpu/ops/tile_query.py``:

1. sort the queries by Hilbert code, so consecutive queries are spatial
   neighbours, and cut them into tiles of TQ with tight boxes;
2. **seed pass**: a best-``seeds`` beam descent of the bucket-AABB heap per
   tile, whose buckets are scanned to give every query an upper bound on
   its k-th distance;
3. **collect pass**: re-descend keeping EVERY node whose box-to-box lower
   bound is <= the tile's largest k-th bound (capacity ``cmax``,
   overflow-flagged — :func:`drive_batches` retries the batch with a
   doubled cap);
4. **dense scan** of each tile's candidate buckets, lb-ascending, into
   per-query ascending k-buffers with an early exit once the next bucket's
   bound cannot beat the tile's worst k-th distance.

Auto plans come from the plan store (:mod:`kdtree_tpu_torch.tuning`) when
an earlier run settled the shape (``"warm"``), from the density model
otherwise, and every auto run records its settled cap back. A
``visit_cap`` (the approximate mode, :mod:`kdtree_tpu_torch.approx`) cuts
the collect pass's lb-ascending list to its first ``visit_cap`` buckets
before the scan.

Step 4 is the hand-written CUDA kernel on a CUDA device
(:mod:`kdtree_tpu_torch.kernels.scan_knn`); :func:`_scan_tiles` here is its
plain PyTorch version, the port of the JAX XLA scan. Results are exact:
the same d2 and ids as the JAX engine on the same tree and plan.

Ties: a query's buffer keeps the incumbent on equal distance (the
candidate is placed after held entries of the same distance), so the ids
never depend on where an early exit stopped.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, NamedTuple, Sequence, Tuple

import torch
from torch.profiler import record_function

from kdtree_tpu_torch import obs, resolve_device
from kdtree_tpu_torch.ops._arith import sq_dist, sq_sum_unrolled
from kdtree_tpu_torch.ops.hilbert import hilbert_codes
from kdtree_tpu_torch.ops.morton import MortonTree, default_bits

DEFAULT_CMAX = 128
DEFAULT_SEEDS = 8
DEFAULT_LOOKAHEAD = 8  # batches in flight before the oldest flag is read
_SCAN_V = 8  # buckets per plain-scan fold on the wide path
_KERNEL_V = 1  # the kernel walks one bucket at a time
_SCAN_ROWS = 8192  # queries per plain-scan block on the wide path
_SCAN_ELEMS = 1 << 16  # fold-op element target on the narrow path
_NARROW_TILE_MIN = 64  # tiles this wide take the narrow plain path (v=1)
_EXTRACT_K_MAX = 32
_EXTRACT_W_MAX = 640
_BATCH_Q = 1 << 16  # queries per batch


@dataclasses.dataclass
class TileStats:
    """What a tiled run did, for the caller that passes one in: batches
    dispatched and overflow retries (re-dispatches at a grown cap)."""

    batches: int = 0
    retries: int = 0


def _gathered_box_lb(tree: MortonTree, box_lo, box_hi, ids):
    """Exact lower bound of |q - p|^2 over q in a tile box and p in node
    ``ids``' box. box_lo/box_hi f32[T, D]; ids i64[T, C] -> f32[T, C]."""
    gaps = []
    for d in range(box_lo.shape[1]):
        lo_d = tree.node_lo[:, d][ids]
        hi_d = tree.node_hi[:, d][ids]
        gaps.append(torch.clamp_min(torch.maximum(lo_d - box_hi[:, d:d + 1],
                                                  box_lo[:, d:d + 1] - hi_d), 0.0))
    return sq_sum_unrolled(gaps)


def _keep_smallest(lb, ids, cap: int):
    """The cap smallest lbs per row, ascending, lowest position first on
    ties (the order of ``lax.top_k(-lb, cap)``)."""
    lb, sel = torch.sort(lb, dim=1, stable=True)
    return lb[:, :cap], torch.gather(ids, 1, sel[:, :cap])


def _frontier(tree: MortonTree, box_lo, box_hi, bound, cap: int):
    """Level-synchronous frontier descent over the implicit AABB heap.

    Keeps the <= cap nodes with smallest box lower bound at every level,
    pruning nodes with lb > bound. ``bound = +inf`` is a best-cap beam
    (seed mode); a finite bound collects exactly, and ``overflow[t]`` says
    more than cap nodes passed the bound at some level for tile t.

    Returns (bucket ids i32[T, cap] lb-ascending with -1 padding, their
    lower bounds f32[T, cap] (+inf at padding), overflow bool[T]).
    """
    T = box_lo.shape[0]
    L = tree.num_levels
    first_leaf = tree.num_buckets - 1
    dev = box_lo.device
    s = min(max(cap.bit_length() - 1, 0), L)
    m = 1 << s
    inf = torch.tensor(float("inf"), device=dev)

    ids = (torch.arange(m, dtype=torch.int64, device=dev) + (m - 1)).expand(T, m)
    lb = _gathered_box_lb(tree, box_lo, box_hi, ids)
    lb = torch.where(lb <= bound[:, None], lb, inf)
    overflow = torch.isfinite(lb).sum(dim=1) > cap
    if m < cap:
        ids = torch.cat([ids, torch.zeros((T, cap - m), dtype=torch.int64,
                                          device=dev)], dim=1)
        lb = torch.cat([lb, torch.full((T, cap - m), float("inf"),
                                       device=dev)], dim=1)
    lb, ids = _keep_smallest(lb, ids, cap)

    for _ in range(s, L):
        alive = torch.isfinite(lb)
        cids = torch.cat([2 * ids + 1, 2 * ids + 2], dim=1)
        calive = torch.cat([alive, alive], dim=1)
        safe = cids.clamp(0, tree.heap_size - 1)
        clb = _gathered_box_lb(tree, box_lo, box_hi, safe)
        clb = torch.where(calive & (clb <= bound[:, None]), clb, inf)
        overflow = overflow | (torch.isfinite(clb).sum(dim=1) > cap)
        lb, ids = _keep_smallest(clb, cids, cap)

    bucket = torch.where(torch.isfinite(lb), ids - first_leaf, -1)
    return bucket.to(torch.int32).contiguous(), lb.contiguous(), overflow


def _fold_block(best_d, best_i, d2, gids, k: int):
    """Merge a [..., W] candidate block into the ascending [..., k]
    buffers: the k smallest of carry ∪ block by (distance, lane), the carry
    in the leading lanes — so an incumbent beats an equal newcomer."""
    all_d = torch.cat([best_d, d2], dim=-1)
    all_i = torch.cat([best_i, gids], dim=-1)
    srt, order = torch.sort(all_d, dim=-1, stable=True)
    return srt[..., :k], torch.gather(all_i, -1, order[..., :k])


def _scan_tiles(tree: MortonTree, tq, cand, cand_lb, k: int, v: int, tb: int):
    """Dense-scan each tile's candidate buckets into per-query k-buffers:
    the plain version of the CUDA scan kernel.

    tq f32[T, TQ, D]; cand i32[T, C] lb-ascending (-1 pad); cand_lb
    f32[T, C] (+inf at pad). Returns (d2 f32[T, TQ, k], gid i32[T, TQ, k])
    ascending. Tiles go in blocks of ``tb`` and buckets in chunks of ``v``;
    a chunk is skipped when its first lower bound cannot beat any query's
    k-th in any of the block's tiles (exact: lb <= d2 holds in float
    arithmetic too, and equal distances keep the incumbent).
    """
    T, TQ, D = tq.shape
    C = cand.shape[1]
    B = tree.bucket_size
    dev = tq.device
    cpad = (-C) % v
    if cpad:
        cand = torch.cat([cand, torch.full((T, cpad), -1, dtype=torch.int32,
                                           device=dev)], dim=1)
        cand_lb = torch.cat([cand_lb, torch.full((T, cpad), float("inf"),
                                                 device=dev)], dim=1)
        C += cpad
    tpad = (-T) % tb
    if tpad:
        tq = torch.cat([tq, torch.zeros((tpad, TQ, D), dtype=tq.dtype,
                                        device=dev)])
        cand = torch.cat([cand, torch.full((tpad, C), -1, dtype=torch.int32,
                                           device=dev)])
        cand_lb = torch.cat([cand_lb, torch.full((tpad, C), float("inf"),
                                                 device=dev)])
    nchunk = C // v
    out_d, out_i = [], []
    for t0 in range(0, T + tpad, tb):
        tqb = tq[t0:t0 + tb]
        candb = cand[t0:t0 + tb].reshape(tb, nchunk, v)
        lbb = cand_lb[t0:t0 + tb].reshape(tb, nchunk, v)[..., 0]
        bd = torch.full((tb, TQ, k), float("inf"), device=dev)
        bi = torch.full((tb, TQ, k), -1, dtype=torch.int32, device=dev)
        for c in range(nchunk):
            alive = lbb[:, c] < bd[..., k - 1].amax(dim=1)
            if not bool(alive.any()):
                continue
            cb = candb[:, c].long()
            sel = cb.clamp_min(0)
            pts = tree.bucket_pts[sel].reshape(tb, 1, v * B, D)
            gids = torch.where((cb >= 0)[:, :, None], tree.bucket_gid[sel], -1)
            d2 = sq_dist(tqb[:, :, None, :], pts)  # [tb, TQ, v*B]
            # invalid buckets -> inf rows; padding rows inside real buckets
            # are +inf coords and come out inf on their own
            bad = (cb < 0).repeat_interleave(B, dim=1)[:, None, :]
            d2 = torch.where(bad, float("inf"), d2)
            gids = gids.reshape(tb, 1, v * B).expand(tb, TQ, v * B)
            bd, bi = _fold_block(bd, bi, d2, gids, k)
        out_d.append(bd)
        out_i.append(bi)
    return torch.cat(out_d)[:T], torch.cat(out_i)[:T]


def merge_partials(d, i):
    """The k smallest entries of per-chunk partial buffers by (d2, chunk):
    the plain version of the CUDA merge kernel.

    d f32[T, S, TQ, k] and i i32[T, S, TQ, k] hold chunk s's ascending
    buffer for each query, chunk s having scanned the s-th contiguous range
    of the tile's candidate list. Laid out chunk-major, one stable sort by
    d2 orders the entries by (d2, chunk, rank in chunk), which is (d2,
    position in the list): the order of one walk over the whole list, so
    the result equals :func:`_scan_tiles` on it. Returns (f32[T, TQ, k],
    i32[T, TQ, k])."""
    T, S, TQ, k = d.shape
    dd = d.permute(0, 2, 1, 3).reshape(T, TQ, S * k)
    ii = i.permute(0, 2, 1, 3).reshape(T, TQ, S * k)
    srt, order = torch.sort(dd, dim=-1, stable=True)
    return (srt[..., :k].contiguous(),
            torch.gather(ii, -1, order[..., :k]).contiguous())


def _sort_queries(queries, bits: int, qpad: int):
    """Hilbert-sort the (padded) query set once; padding duplicates the
    last query. Returns (sorted queries, order)."""
    if qpad:
        queries = torch.cat([queries, queries[-1:].expand(qpad, -1)])
    order = torch.sort(hilbert_codes(queries, bits), stable=True).indices
    return queries[order], order


def _tiled_batch_core(tree, sq, k: int, tile: int, cmax: int, seeds: int,
                      v: int, tb: int, use_kernel: bool = False,
                      visit_cap: int | None = None):
    """Seed + collect + scan for ONE batch of sorted queries. Returns
    (d2 f32[q, k], ids i32[q, k], overflow bool scalar tensor, candidate
    buckets collected: an int scalar tensor).

    ``visit_cap`` keeps only the first ``visit_cap`` buckets of each
    tile's lb-ascending collect list (the seed pass and the overflow flag
    are unchanged). Truncations of one ranking are nested, so recall is
    monotone in the cap, and a cap at least as wide as the list changes
    nothing: the run is the exact one."""
    tq = sq.reshape(-1, tile, sq.shape[1])
    box_lo = tq.amin(dim=1)
    box_hi = tq.amax(dim=1)
    T = tq.shape[0]
    if use_kernel:
        from kdtree_tpu_torch.kernels.scan_knn import scan_tiles

        def scan(cand, lb):
            return scan_tiles(tree, tq, cand, lb, k, v=v, tb=tb)
    else:
        def scan(cand, lb):
            return _scan_tiles(tree, tq, cand, lb, k, v, tb)

    inf_bound = torch.full((T,), float("inf"), device=sq.device)
    seed_cand, seed_lb, _ = _frontier(tree, box_lo, box_hi, inf_bound, seeds)
    sd, _ = scan(seed_cand, seed_lb)
    tile_bound = sd[..., k - 1].amax(dim=1)
    cand, cand_lb, overflow = _frontier(tree, box_lo, box_hi, tile_bound, cmax)
    if visit_cap is not None and visit_cap < cand.shape[1]:
        # a column slice is not contiguous, and the kernel takes only
        # contiguous lists
        cand = cand[:, :visit_cap].contiguous()
        cand_lb = cand_lb[:, :visit_cap].contiguous()
    ncand = (cand >= 0).sum()
    fd, fi = scan(cand, cand_lb)
    q = T * tile
    return fd.reshape(q, k), fi.reshape(q, k), overflow.any(), ncand


def _unsort(order, d2, gi, qreal: int):
    out_d = torch.empty_like(d2)
    out_i = torch.empty_like(gi)
    out_d[order] = d2
    out_i[order] = gi
    return out_d[:qreal], out_i[:qreal]


def _auto_tile(Q, n, k, D, nbp, B, cmax, use_kernel=False):
    """Density-sized tiles: expected candidate buckets per tile is
    ``((TQ/Q)^(1/D) + 2 (k/n)^(1/D))^D * nbp`` with an x8 safety factor.

    Plain path: the largest power-of-2 tile whose estimate fits cmax.
    Kernel path: the early exit makes extra candidate slots cheap, so
    tiles are as wide as 128 while the estimate stays under 768 slots, and
    cmax is twice the estimate. These are the JAX package's rules,
    unmeasured on the card."""
    def est(tq):
        return (((tq / Q) ** (1.0 / D) + 2.0 * (k / max(n, 1)) ** (1.0 / D))
                ** D * nbp * 8.0)

    if use_kernel:
        tq = 128
        while tq > 8 and est(tq) > 768:
            tq //= 2
        need = max(cmax, est(tq) * 2.0)
        c = 128
        while c < min(4096, nbp) and c < need:
            c *= 2
        return tq, min(c, nbp)
    tq = 1024
    while tq > 4 and est(tq) > 0.75 * cmax:
        tq //= 2
    if est(tq) > 0.75 * cmax:
        need = est(tq) * 1.5
        while cmax < min(4096, nbp) and cmax < need:
            cmax *= 2
    return tq, min(cmax, nbp)


def dense_lowd(q: int, n: int, dim: int) -> bool:
    """The JAX package's tiled-engine crossover rule: dense low-D batches
    take the tiled engine."""
    return q >= 512 and q * 64 >= n and dim <= 6


class TiledPlan(NamedTuple):
    """Static launch configuration of a tiled run. ``source`` is
    ``"warm"`` (a plan-store hit: ``drive_batches`` skips the first batch's
    cap-settling probe), ``"heuristic"`` (the density model) or
    ``"explicit"`` (caller-forced knobs; never recorded). ``sig`` is the
    plan-store signature an auto plan was looked up under, so feedback
    records under exactly that key (None for explicit plans)."""

    tile: int
    cmax: int
    seeds: int
    v: int
    tb: int
    bits: int
    qbatch: int
    use_kernel: bool
    source: str = "heuristic"
    sig: object = None


def _opt_knob(x) -> int | None:
    """A block-shape knob read from a plan profile: anything but a
    positive int reads as 'not recorded' (profiles are advisory)."""
    if isinstance(x, int) and not isinstance(x, bool) and x >= 1:
        return x
    return None


def plan_tiled(
    Q: int, D: int, n_real: int, nbp: int, B: int, k: int,
    tile: int | None = None, cmax: int = DEFAULT_CMAX,
    seeds: int = DEFAULT_SEEDS, use_kernel: bool | None = None,
    device=None, scan_v: int | None = None, scan_tb: int | None = None,
    devices: int = 1,
) -> TiledPlan:
    """Resolve the static knobs of a tiled run from the problem shape.

    A fully automatic plan (no knob forced, ``use_kernel=None``) comes
    from the plan store (:mod:`kdtree_tpu_torch.tuning`) when an earlier
    run settled this problem signature — its tile, cmax and seeds, and
    ``v``/``tb`` when a sweep recorded them — and from the density
    heuristic on a miss. A forced knob or engine is a one-off override:
    the store is neither read nor written for it.

    ``use_kernel=None`` takes the CUDA scan kernel on a CUDA ``device``
    (``None`` means CUDA) and the plain scan on the CPU; a profile
    recorded for the other engine reads as a miss. ``scan_v`` /
    ``scan_tb`` force the plain scan's block shape; exactness never
    depends on either. ``devices`` is the per-shard plan context: a
    forest's shard count, so that a shard plan never collides with a
    single-device plan of the same shape."""
    forced_engine = use_kernel is not None
    if use_kernel is None:
        backend = resolve_device(device).type
        use_kernel = backend == "cuda"
    auto = (tile is None and cmax == DEFAULT_CMAX and seeds == DEFAULT_SEEDS
            and not forced_engine and scan_v is None and scan_tb is None)
    source = "explicit"
    sig = None
    v, tb = scan_v, scan_tb
    if auto:
        from kdtree_tpu_torch import tuning

        sig = tuning.make_signature(Q, D, n_real, k, B, nbp, devices=devices,
                                    backend=backend)
        prof = tuning.lookup(sig, use_kernel=use_kernel)
        if prof is not None:
            tile, cmax = int(prof["tile"]), int(prof["cmax"])
            seeds = int(prof.get("seeds", seeds))
            v = _opt_knob(prof.get("v"))
            tb = _opt_knob(prof.get("tb"))
            source = "warm"
        else:
            tile, cmax = _auto_tile(Q, n_real, k, D, nbp, B, cmax, use_kernel)
            source = "heuristic"
    elif tile is None:
        tile, cmax = _auto_tile(Q, n_real, k, D, nbp, B, cmax, use_kernel)
    if min(tile, max(Q, 1)) != tile and source == "warm":
        # block knobs swept at one tile width do not carry to another
        v, tb = scan_v, scan_tb
    tile = min(tile, max(Q, 1))
    seeds = min(seeds, nbp)
    if k > (seeds * B) // 2:
        cmax = nbp
    cmax = min(cmax, nbp)
    bits = default_bits(D)
    if v is None:
        if use_kernel:
            v = _KERNEL_V
        elif tile >= _NARROW_TILE_MIN and k <= _EXTRACT_K_MAX \
                and B + k <= _EXTRACT_W_MAX:
            v = 1
        else:
            v = _SCAN_V
            while v * B + k <= _EXTRACT_W_MAX:
                v *= 2
    v = max(int(v), 1)
    qbatch = max(_BATCH_Q // tile, 1) * tile
    qbatch = min(qbatch, -(-max(Q, 1) // tile) * tile)
    if tb is None:
        if k <= _EXTRACT_K_MAX and v * B + k <= _EXTRACT_W_MAX:
            tb = max(1, _SCAN_ELEMS // max(tile * (v * B + k), 1))
        else:
            tb = max(1, _SCAN_ROWS // tile)
    tb = max(1, min(int(tb), -(-qbatch // tile)))
    return TiledPlan(tile, cmax, seeds, v, tb, bits, qbatch, use_kernel,
                     source, sig)


def drive_batches(
    run_batch: Callable[[int, int], tuple],
    offsets: Sequence[int],
    cmax: int,
    nbp: int,
    settle_first: bool = True,
    lookahead: int = DEFAULT_LOOKAHEAD,
    stats: TileStats | None = None,
    feedback=None,
    scan_units_per_batch: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipelined batch dispatch with overflow retry.

    ``run_batch(offset, cap) -> (d2, gid, overflow[, ncand])``. The first batch
    settles the cap synchronously (``settle_first``); then up to
    ``lookahead`` batches stay queued on the device, and retiring the
    oldest reads its one overflow flag (``.item()``-style host fetch) while
    the rest run. An overflowing batch retries alone at the grown cap. The
    tail window drains with one stacked flag fetch plus doubling rounds. A
    batch whose last dispatch already ran at ``nbp`` is final
    (``caps[i] >= nbp``): nothing can overflow there. A warm plan passes
    ``settle_first=False``: its cap settled in an earlier run. With a
    ``feedback`` handle (:mod:`kdtree_tpu_torch.tuning.feedback`), the
    settled cap and the retry count are recorded once every flag is clean.

    Three profiler ranges anchor the device timeline
    (:mod:`kdtree_tpu_torch.obs.timeline`): ``tile.dispatch`` around each
    ``run_batch`` (the lag to the card's first slice after it, and each
    dispatch window's busy/idle), ``tile.retire`` around the blocking flag
    fetch of a retire, ``tile.drain`` around the stacked fetch. Outside a
    capture they cost about a microsecond each.

    With device metrics enabled (``obs.enabled()``) and a 4th output (the
    batch's candidate-bucket count), the counts are stacked on the device
    and fetched at report time: ``kdtree_tile_candidates_total``, and with
    ``scan_units_per_batch`` (tiles per batch x shards, the (tile, tree)
    pairs that could each have kept ``nbp`` buckets)
    ``kdtree_tile_scan_units_total`` and the prune rate
    ``kdtree_tile_prune_rate = 1 - candidates / (units * nbp)``, which the
    feedback handle records into the plan profile too.
    """
    nretries = 0
    bcmax = cmax
    n = len(offsets)
    window = max(int(lookahead), 1)
    batches: list = [None] * n
    caps = [0] * n

    def dispatch(i: int, cap: int):
        with record_function("tile.dispatch", f"batch={i} cap={cap}"):
            batches[i] = run_batch(offsets[i], cap)
            caps[i] = cap

    def retire(i: int) -> None:
        nonlocal bcmax, nretries
        while True:
            # the range wraps only the blocking flag fetch; a retry's
            # re-dispatch is its own tile.dispatch
            with record_function("tile.retire", f"batch={i}"):
                done = not bool(batches[i][2]) or caps[i] >= nbp
            if done:
                return
            if caps[i] >= bcmax:
                bcmax = min(bcmax * 2, nbp)
            nretries += 1
            dispatch(i, bcmax)

    start = 0
    inflight: collections.deque = collections.deque()
    if settle_first:
        dispatch(0, bcmax)
        while bool(batches[0][2]) and bcmax < nbp:
            bcmax = min(bcmax * 2, nbp)
            nretries += 1
            dispatch(0, bcmax)
        start = 1
        inflight.append(0)
    for i in range(start, n):
        if len(inflight) >= window:
            retire(inflight.popleft())
        dispatch(i, bcmax)
        inflight.append(i)
    while inflight:
        idx = list(inflight)
        inflight.clear()
        with record_function("tile.drain", f"batches={len(idx)}"):
            flags = torch.stack([batches[i][2] for i in idx]).cpu().tolist()
        bad = [i for i, f in zip(idx, flags) if f and caps[i] < nbp]
        if not bad:
            break
        if max(caps[i] for i in bad) >= bcmax:
            bcmax = min(bcmax * 2, nbp)
        for i in bad:
            nretries += 1
            dispatch(i, bcmax)
            inflight.append(i)
    if stats is not None:
        stats.batches += n
        stats.retries += nretries
    if feedback is not None:
        feedback.settled(cmax=bcmax, retries=nretries)
    if obs.enabled() and len(batches[0]) > 3:
        _defer_candidates(torch.stack([b[3] for b in batches]),
                          (scan_units_per_batch or 0) * n, nbp, feedback)
    d2 = torch.cat([b[0] for b in batches]) if n > 1 else batches[0][0]
    gi = torch.cat([b[1] for b in batches]) if n > 1 else batches[0][1]
    return d2, gi


def _defer_candidates(ncand_dev, units: int, nbp: int, feedback) -> None:
    """Record a run's candidate counts at report time (one fetch then)."""
    reg = obs.get_registry()

    def flush():
        ncand = int(ncand_dev.sum())
        reg.counter("kdtree_tile_candidates_total").inc(ncand)
        if units:
            reg.counter("kdtree_tile_scan_units_total").inc(units)
            rate = 1.0 - ncand / (units * nbp)
            reg.gauge("kdtree_tile_prune_rate").set(rate)
            if feedback is not None:
                feedback.record_stats(prune_rate=rate)

    obs.defer(flush)


def morton_knn_tiled(
    tree: MortonTree,
    queries,
    k: int = 1,
    tile: int | None = None,
    cmax: int = DEFAULT_CMAX,
    seeds: int = DEFAULT_SEEDS,
    use_kernel: bool | None = None,
    plan: TiledPlan | None = None,
    scan_v: int | None = None,
    scan_tb: int | None = None,
    stats: TileStats | None = None,
    visit_cap: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched k-NN via Hilbert-sorted query tiles and dense scans,
    on the tree's device.

    Returns (d2 f32[Q, k], ids i32[Q, k]) ascending — the same answer as
    ``kdtree_tpu.ops.tile_query.morton_knn_tiled`` on the same tree.
    ``queries`` is a tensor or array [Q, D]. ``tile=None`` plans
    automatically (the plan store, then the query/point density) and
    records the settled plan back; ``cmax`` doubles on overflow up to the
    bucket count. A resolved ``plan`` overrides the knob arguments.
    ``stats``, if given, accumulates the batch and retry counts.

    ``visit_cap`` bounds the dense scan to the ``visit_cap`` nearest
    candidate buckets per tile (by box lower bound): the approximate mode
    that :mod:`kdtree_tpu_torch.approx` resolves from a recall target. Its
    answers are exact over the visited points; a cap at least as wide as
    the collected list is the exact run, byte for byte. A capped run
    records nothing in the plan store."""
    queries = torch.as_tensor(queries, dtype=torch.float32, device=tree.device)
    Q, D = queries.shape
    k = min(k, tree.n_real)
    if Q == 0:
        return (torch.zeros((0, k), device=tree.device),
                torch.zeros((0, k), dtype=torch.int32, device=tree.device))
    obs.count_query("tiled", Q)
    if plan is None:
        plan = plan_tiled(Q, D, tree.n_real, tree.num_buckets,
                          tree.bucket_size, k, tile, cmax, seeds, use_kernel,
                          device=tree.device, scan_v=scan_v, scan_tb=scan_tb)
    from kdtree_tpu_torch import tuning

    # a truncated run's settled cap describes a deliberately cut scan, and
    # recording it would warm-start the exact path from approximate evidence
    feedback = None if visit_cap is not None else tuning.feedback_for(plan)
    if visit_cap is not None:
        visit_cap = max(int(visit_cap), 1)
        obs.get_registry().counter("kdtree_approx_queries_total").inc(Q)
    qpad = (-Q) % plan.qbatch
    sq, order = _sort_queries(queries, plan.bits, qpad)

    def run_batch(b0: int, cap: int):
        return _tiled_batch_core(tree, sq[b0:b0 + plan.qbatch], k, plan.tile,
                                 cap, plan.seeds, plan.v, plan.tb,
                                 plan.use_kernel, visit_cap)

    d2, gi = drive_batches(run_batch, list(range(0, sq.shape[0], plan.qbatch)),
                           plan.cmax, tree.num_buckets,
                           settle_first=plan.source != "warm", stats=stats,
                           feedback=feedback,
                           scan_units_per_batch=plan.qbatch // plan.tile)
    return _unsort(order, d2, gi, Q)
