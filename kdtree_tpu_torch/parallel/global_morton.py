"""The scale engine: a sample-sort partitioned forest of Morton trees.

The port of ``kdtree_tpu/parallel/global_morton.py``. Every shard ends up
owning one contiguous Morton-code range of the points (~N/P rows) and
builds a local Morton bucket tree over just those:

1. each shard generates only its own rows (the counter-based row stream,
   so no [N, D] array exists anywhere) and quantizes them on the fixed
   generator grid;
2. a regular sample of 256 sorted codes per shard is all-gathered and
   P-1 splitters chosen from it, identically for every shard;
3. each shard stable-sorts its rows by (destination, code) and sends
   fixed-capacity slots (``slack`` x the even share) in one all_to_all;
   overflowing rows are counted and refuse the build rather than vanish;
4. each shard re-sorts what it received (padding last) and builds its
   local tree with the single-device build.

Queries are replicated: every shard answers exact k-NN over its own range
and one all_gather + top-k merges the P partial buffers, exact because the
ranges partition the point set. Dense low-D batches take the tiled engine
per shard (its scan is the CUDA kernel on the card); a forest on hardware
that does not match its shard count is served mesh-free, through one
flattened Morton view (or shard by shard when the view does not fit).

The mesh is the port's single-controller :class:`~.mesh.Mesh`: the
per-shard bodies run in shard order with each shard's tensors on its mesh
device. Every array is bit-identical to the reference's on the same
inputs, and query d2 is bit-equal on every route.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.ops.generate import (
    COORD_MAX, COORD_MIN, generate_points_shard, generate_points_shard_clustered,
)
from kdtree_tpu_torch.ops.morton import (
    MortonTree, build_morton_impl, default_bits, morton_codes, morton_knn_chunks,
)
from kdtree_tpu_torch.ops.topk import sort_pairs
from kdtree_tpu_torch.utils.guards import check_rows_fit_i32

from .mesh import SHARD_AXIS, Mesh, all_gather, all_to_all, make_mesh, mesh_for, psum

DEFAULT_SAMPLES = 256
DEFAULT_SLACK = 2.0
_PAD_KEY = 0xFFFFFFFF


def _count_build(num_points: int, devices: int) -> None:
    obs.count_build("global-morton", num_points)
    obs.get_registry().gauge("kdtree_forest_devices").set(devices)


def _count_sharded_query(engine: str, q: int, devices: int) -> None:
    """Per-shard query load: queries are replicated and every shard's tree
    answers them, so each shard's ``kdtree_shard_queries_total`` advances
    by q (shared by the two forest engines)."""
    obs.count_query(engine, q)
    reg = obs.get_registry()
    for shard in range(devices):
        reg.counter("kdtree_shard_queries_total",
                    labels={"shard": str(shard)}).inc(q)


def _resolve_slack(slack: float | None, dim: int, n: int, bucket_cap: int,
                   p: int, device) -> float:
    """The exchange's capacity factor. An explicit ``slack`` wins.
    Otherwise the plan store's ``occupancy_p90`` for this build shape
    (:func:`kdtree_tpu_torch.tuning.occupancy_p90_hint`) scales the
    ``DEFAULT_SLACK`` floor up to 2x as the observed occupancy nears the
    bucket capacity, capped at ``max(P, floor)``; each such sizing counts
    in ``kdtree_slack_occupancy_sized_total``, and the factor used is the
    ``kdtree_exchange_slack`` gauge."""
    if slack is not None:
        return float(slack)
    from kdtree_tpu_torch import tuning

    sized = DEFAULT_SLACK
    occ = tuning.occupancy_p90_hint(dim, n, bucket_cap, p,
                                    backend=torch.device(device).type)
    if occ is not None:
        sized = max(DEFAULT_SLACK, DEFAULT_SLACK * 2.0 * float(occ) / float(bucket_cap))
        sized = min(sized, max(float(p), DEFAULT_SLACK))
        if sized > DEFAULT_SLACK:
            obs.get_registry().counter("kdtree_slack_occupancy_sized_total").inc()
    obs.get_registry().gauge("kdtree_exchange_slack").set(sized)
    return sized


def _shards(x) -> list:
    """A per-shard list from a stacked [P, ...] tensor (views) or a
    sequence of per-shard tensors."""
    if isinstance(x, torch.Tensor):
        return [x[i] for i in range(x.shape[0])]
    return list(x)


def stack_shards(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The per-shard tensors stacked on ``device`` (default: shard 0's)."""
    dev = xs[0].device if device is None else device
    return torch.stack([x.to(dev) for x in xs])


class GlobalMortonForest:
    """P per-shard Morton bucket trees over one partition of the points.

    Each array is a list of P per-shard tensors (each on its shard's
    device): ``node_lo``/``node_hi`` [H, D], ``bucket_pts`` [NBP, B, D],
    ``bucket_gid`` [NBP, B] holding GLOBAL point ids (-1 padding). Every
    shard has the same shapes. A stacked [P, ...] tensor is accepted too.
    Plain ints: ``num_points``, the provenance (``seed``, ``bucket_cap``,
    ``bits``), and ``occ_max``, the largest real-row count of a shard (0
    when unknown), which tile planning sizes for."""

    def __init__(self, node_lo, node_hi, bucket_pts, bucket_gid, num_points,
                 seed, bucket_cap, bits, occ_max=0):
        self.node_lo = _shards(node_lo)
        self.node_hi = _shards(node_hi)
        self.bucket_pts = _shards(bucket_pts)
        self.bucket_gid = _shards(bucket_gid)
        self.num_points = int(num_points)
        self.seed = int(seed)
        self.bucket_cap = int(bucket_cap)
        self.bits = int(bits)
        self.occ_max = int(occ_max)

    ARRAYS = ("node_lo", "node_hi", "bucket_pts", "bucket_gid")
    AUX = ("num_points", "seed", "bucket_cap", "bits", "occ_max")

    @property
    def devices(self) -> int:
        return len(self.node_lo)

    @property
    def device(self) -> torch.device:
        return self.bucket_pts[0].device

    @property
    def dim(self) -> int:
        return self.bucket_pts[0].shape[2]

    @property
    def n_real(self) -> int:
        return self.num_points

    @property
    def num_buckets(self) -> int:
        return self.bucket_pts[0].shape[0]

    @property
    def bucket_size(self) -> int:
        return self.bucket_pts[0].shape[1]

    @property
    def num_levels(self) -> int:
        return self.num_buckets.bit_length() - 1

    def shard(self, p: int, n_real: int, device=None) -> MortonTree:
        """Shard p's tree, on ``device`` (default: where it lives)."""
        dev = self.bucket_pts[p].device if device is None else device
        return MortonTree(self.node_lo[p].to(dev), self.node_hi[p].to(dev),
                          self.bucket_pts[p].to(dev), self.bucket_gid[p].to(dev),
                          n_real, self.num_levels)

    def __repr__(self):
        return (f"GlobalMortonForest(n={self.num_points}, devices={self.devices}, "
                f"dim={self.dim})")


def _merge_partials(all_d: torch.Tensor, all_i: torch.Tensor, k: int):
    """Merge P per-shard buffers [P, Q, k] into the exact global (d2, ids):
    the k smallest of each query's P*k candidates, lowest candidate first
    on equal d2 (the order of ``lax.top_k``), then a stable (d2, id)
    sort."""
    q = all_d.shape[1]
    cat_d = all_d.transpose(0, 1).reshape(q, -1)
    cat_i = all_i.transpose(0, 1).reshape(q, -1)
    kk = min(k, cat_d.shape[1])
    srt, sel = torch.sort(cat_d, dim=1, stable=True)
    return sort_pairs(srt[:, :kk], torch.gather(cat_i, 1, sel[:, :kk]))


def _gen_shard(distribution: str, seed: int, dim: int, start: int, rows: int,
               device) -> torch.Tensor:
    """Rows [start, start + rows) of the named row stream ("uniform" or
    "clustered"), on ``device``."""
    if distribution == "clustered":
        return generate_points_shard_clustered(seed, dim, start, rows, device=device)
    return generate_points_shard(seed, dim, start, rows, device=device)


def _sample_splitters(codes: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """P-1 splitter codes from a regular sample of each shard's sorted
    codes, all-gathered and sorted (on shard 0's device)."""
    samples = []
    for code in codes:
        ln = code.shape[0]
        idx = (torch.arange(DEFAULT_SAMPLES, device=code.device) * ln) // DEFAULT_SAMPLES
        samples.append(torch.sort(code).values[idx])
    ss = torch.sort(all_gather(samples, mesh.devices[0]).reshape(-1)).values
    p, m = mesh.size, ss.shape[0]
    return ss[(torch.arange(1, p, device=ss.device) * m) // p]


def _send_slots(pts, gid, code, splitters, p: int, cap: int):
    """One shard's send buffers [P, cap, ...]: rows stable-sorted by
    (destination, code), each destination's first ``cap`` real rows in its
    slots. Returns (pts, gid, code, overflow count). Rows past a
    destination's capacity are masked out, never written: padding rows
    (gid -1) are droppable, real ones count as overflow."""
    ln, d = pts.shape
    dev = pts.device
    dest = torch.searchsorted(splitters.to(dev), code, right=True)
    order = torch.sort((dest << 32) | code, stable=True).indices
    dest_s, pts_s, gid_s, code_s = dest[order], pts[order], gid[order], code[order]
    rank = torch.arange(ln, device=dev) - torch.searchsorted(dest_s, dest_s)
    real = gid_s >= 0
    overflow = ((rank >= cap) & real).sum()
    ok = (rank < cap) & real
    slot = (dest_s * cap + rank)[ok]
    send_pts = torch.full((p * cap, d), float("inf"), dtype=pts.dtype, device=dev)
    send_gid = torch.full((p * cap,), -1, dtype=torch.int32, device=dev)
    send_code = torch.zeros((p * cap,), dtype=code.dtype, device=dev)
    send_pts[slot] = pts_s[ok]
    send_gid[slot] = gid_s[ok]
    send_code[slot] = code_s[ok]
    return (send_pts.reshape(p, cap, d), send_gid.reshape(p, cap),
            send_code.reshape(p, cap), overflow)


def _partition_exchange(pts, gid, code, mesh: Mesh, cap: int):
    """Route every shard's rows to the shard owning their code range in one
    all_to_all. Per-shard lists in and out; received padding rows (gid
    -1, +inf coordinates) sort to the end. Returns (pts, gid, the
    overflow total on every shard)."""
    p = mesh.size
    splitters = _sample_splitters(code, mesh)
    sends = [_send_slots(pts[i], gid[i], code[i], splitters, p, cap) for i in range(p)]
    recv_pts = all_to_all([s[0] for s in sends], mesh)
    recv_gid = all_to_all([s[1] for s in sends], mesh)
    recv_code = all_to_all([s[2] for s in sends], mesh)
    overflow = psum([s[3] for s in sends], mesh)
    out_pts, out_gid = [], []
    for i in range(p):
        rp = recv_pts[i].reshape(p * cap, -1)
        rg = recv_gid[i].reshape(p * cap)
        rc = recv_code[i].reshape(p * cap)
        pad_key = torch.where(rg < 0, _PAD_KEY, rc)
        # (pad_key, gid) stable: by gid first, then stably by pad_key
        o1 = torch.sort(rg, stable=True).indices
        o2 = o1[torch.sort(pad_key[o1], stable=True).indices]
        out_pts.append(rp[o2])
        out_gid.append(rg[o2])
    return out_pts, out_gid, overflow


def _local_tree(pts, gid, bucket_cap: int, bits: int):
    """One shard's Morton tree over its rows, storing GLOBAL ids, and its
    real-row count."""
    tree = build_morton_impl(pts, bucket_cap=bucket_cap, bits=bits)
    bg = torch.where(tree.bucket_gid >= 0,
                     gid[tree.bucket_gid.long().clamp_min(0)], -1)
    return tree.node_lo, tree.node_hi, tree.bucket_pts, bg, (gid >= 0).sum()


def _exchange_and_build(pts, gid, code, mesh: Mesh, cap: int, bucket_cap: int,
                        bits: int):
    """The shared tail of every exchanged build: sample-sort exchange, then
    each shard's local tree. Returns (per-shard tree parts, overflow,
    per-shard occupancy)."""
    pts, gid, overflow = _partition_exchange(pts, gid, code, mesh, cap)
    parts = [_local_tree(pts[i], gid[i], bucket_cap, bits) for i in range(mesh.size)]
    return parts, overflow[0], [pt[4] for pt in parts]


def _forest(parts, occ, *, num_points, seed, bucket_cap, bits):
    """The forest from per-shard tree parts and occupancies (one host
    read: the largest occupancy)."""
    occ_max = int(torch.stack([o.cpu() for o in occ]).max())
    return GlobalMortonForest(
        [pt[0] for pt in parts], [pt[1] for pt in parts],
        [pt[2] for pt in parts], [pt[3] for pt in parts],
        num_points=num_points, seed=seed, bucket_cap=bucket_cap, bits=bits,
        occ_max=occ_max)


def _default_mesh(mesh):
    return make_mesh() if mesh is None else mesh


def build_global_morton(
    seed: int,
    dim: int,
    num_points: int,
    mesh: Mesh | None = None,
    bucket_cap: int = 128,
    slack: float | None = None,
    distribution: str = "uniform",
) -> GlobalMortonForest:
    """Build the forest from the seeded row stream: each shard generates
    its own rows, one all_to_all partitions them by code range, and each
    shard builds its local tree. ``distribution`` is "uniform" or
    "clustered" (the oracle's view of the rows is
    ``generate_points_shard_clustered(seed, dim, 0, n)``).

    ``slack=None`` sizes the exchange from the plan store
    (:func:`_resolve_slack`); an explicit value wins. Raises RuntimeError
    on exchange capacity overflow (retry with a higher ``slack``). The
    mesh defaults to every CUDA device."""
    check_rows_fit_i32(num_points, "generative problem")
    mesh = _default_mesh(mesh)
    p = mesh.size
    slack = _resolve_slack(slack, dim, num_points, bucket_cap, p, mesh.devices[0])
    rows = -(-num_points // p)  # ceil; the rows past N are masked below
    bits = default_bits(dim)
    cap = max(1, int(rows / p * slack))
    with obs.span("build.global-morton", n=num_points, devices=p) as sp:
        pts, gid, codes = [], [], []
        for i, dev in enumerate(mesh.devices):
            x = _gen_shard(distribution, seed, dim, i * rows, rows, dev)
            g = (i * rows + torch.arange(rows, device=dev)).to(torch.int32)
            # rows past num_points are phantoms: the padding encoding
            # (+inf, id -1) before the exchange, so they never compete
            valid = g < num_points
            x = torch.where(valid[:, None], x, float("inf"))
            pts.append(x)
            gid.append(torch.where(valid, g, -1))
            # the fixed generator grid: every shard's codes compare against
            # the shared splitters
            codes.append(morton_codes(x, bits, lo=COORD_MIN, hi=COORD_MAX))
        parts, overflow, occ = _exchange_and_build(pts, gid, codes, mesh, cap,
                                                   bucket_cap, bits)
        sp.append(overflow)
        _count_build(num_points, p)
    ov = int(overflow)
    if ov > 0:
        raise RuntimeError(f"sample-sort capacity overflow ({ov} rows); "
                           f"retry with slack > {slack}")
    forest = _forest(parts, occ, num_points=num_points, seed=seed,
                     bucket_cap=bucket_cap, bits=bits)
    from kdtree_tpu_torch.obs import flight

    flight.record("build.global-morton", n=num_points, devices=p,
                  slack=round(float(slack), 4), occ_max=forest.occ_max)
    return forest


def _host_block(points, s: int, b: int) -> np.ndarray:
    blk = points[s:s + b]
    if isinstance(blk, torch.Tensor):
        blk = blk.detach().cpu().numpy()
    return np.asarray(blk, dtype=np.float32)


def _stream_rows_to_mesh(points, mesh: Mesh, rows: int):
    """Place user rows on the shards block-cyclically (block j to shard
    j mod P), one block at a time, so that every shard holds a uniform
    sample of the file whatever its sort order, and host memory peaks at
    about one shard. ``points`` is an [N, D] array, memmap or tensor.
    Returns (per-shard pts, per-shard gid, grid lo f32[D], grid hi
    f32[D]); each shard pads to whole blocks with (+inf, -1) rows."""
    n, d = points.shape
    p = mesh.size
    b = max(1, min(rows // (8 * p) or 1, 1 << 20))
    nb = -(-n // b)
    rows_buf = -(-nb // p) * b
    lo = np.full(d, np.inf, np.float32)
    hi = np.full(d, -np.inf, np.float32)
    pts, gid = [], []
    for i, dev in enumerate(mesh.devices):
        chunks, gchunks = [], []
        for j in range(i, nb, p):
            s = j * b
            blk = _host_block(points, s, b)
            if not np.isfinite(blk).all():
                raise ValueError(f"points rows [{s}, {s + blk.shape[0]}) contain "
                                 "non-finite values")
            np.minimum(lo, blk.min(axis=0), out=lo)
            np.maximum(hi, blk.max(axis=0), out=hi)
            chunks.append(blk)
            gchunks.append(np.arange(s, s + blk.shape[0], dtype=np.int32))
        pad = rows_buf - sum(c.shape[0] for c in chunks)
        if pad:
            chunks.append(np.full((pad, d), np.inf, np.float32))
            gchunks.append(np.full(pad, -1, np.int32))
        pts.append(torch.from_numpy(np.concatenate(chunks)).to(dev))
        gid.append(torch.from_numpy(np.concatenate(gchunks)).to(dev))
    return pts, gid, torch.from_numpy(lo), torch.from_numpy(hi)


def build_global_morton_from_points(
    points,
    mesh: Mesh | None = None,
    bucket_cap: int = 128,
    slack: float | None = None,
) -> GlobalMortonForest:
    """Build the forest over user data: rows stream onto the shards block
    by block (``points`` may be a memmap), are quantized on the data's own
    per-axis bounds, and go through the same exchange and local builds as
    :func:`build_global_morton`. Raises RuntimeError on exchange overflow
    and ValueError on non-finite rows."""
    n, dim = points.shape
    if n < 1:
        raise ValueError("points must be a non-empty [N, D] array")
    check_rows_fit_i32(n, "points array")
    mesh = _default_mesh(mesh)
    p = mesh.size
    slack = _resolve_slack(slack, dim, n, bucket_cap, p, mesh.devices[0])
    rows = -(-n // p)
    bits = default_bits(dim)
    pts, gid, lo, hi = _stream_rows_to_mesh(points, mesh, rows)
    cap = max(1, int(pts[0].shape[0] / p * slack))
    codes = [morton_codes(x, bits, lo=lo.to(x.device), hi=hi.to(x.device)) for x in pts]
    parts, overflow, occ = _exchange_and_build(pts, gid, codes, mesh, cap,
                                               bucket_cap, bits)
    ov = int(overflow)
    if ov > 0:
        raise RuntimeError(f"sample-sort capacity overflow ({ov} rows); "
                           f"retry with slack > {slack}")
    _count_build(n, p)
    return _forest(parts, occ, num_points=n, seed=-1, bucket_cap=bucket_cap, bits=bits)


def local_forest(pts, gid, mesh_devices, bucket_cap: int, bits: int):
    """Per-shard Morton trees over rows already on their shards (no
    exchange); padding rows (+inf, id -1) build into +inf leaves. Returns
    (tree parts, occupancies). Shared by the shard-file ingest, the
    ensemble's dense route and the exact tree's forest view."""
    parts = [_local_tree(pts[i].to(d), gid[i].to(d), bucket_cap, bits)
             for i, d in enumerate(mesh_devices)]
    return parts, [pt[4] for pt in parts]


def build_global_morton_from_shard_files(
    paths: Sequence[str],
    mesh: Mesh | None = None,
    bucket_cap: int = 128,
) -> GlobalMortonForest:
    """Build the forest over pre-sharded files: file i becomes shard i as
    it is, with no exchange (exactness needs only that the shards
    partition the points). Global ids are row offsets into the files'
    concatenation, in argument order."""
    if not paths:
        raise ValueError("need at least one shard file")
    arrs = []
    dim = None
    for path in paths:
        a = np.load(path, mmap_mode="r", allow_pickle=False)
        if a.ndim != 2 or a.shape[0] < 1 or a.shape[1] < 1:
            raise ValueError(f"shard file {path} must be non-empty [N, D], got shape "
                             f"{a.shape}")
        if dim is None:
            dim = int(a.shape[1])
        elif int(a.shape[1]) != dim:
            raise ValueError(f"shard file {path} is {a.shape[1]}-D but earlier shards "
                             f"are {dim}-D")
        arrs.append(a)
    p = len(arrs)
    if mesh is None:
        mesh = make_mesh(p)
    if mesh.size != p:
        raise ValueError(f"{p} shard files need a {p}-device mesh, got {mesh.size}")
    width = max(a.shape[0] for a in arrs)
    from kdtree_tpu_torch.ops.morton import check_build_capacity

    check_build_capacity(width, dim, mesh.devices[0])
    offsets = np.concatenate([[0], np.cumsum([a.shape[0] for a in arrs])])
    n = int(offsets[-1])
    check_rows_fit_i32(n, "shard-file set")
    pts, gid = [], []
    for i, a in enumerate(arrs):
        block = np.array(a, dtype=np.float32)  # a copy: the file is mmapped
        if not np.isfinite(block).all():
            raise ValueError(f"shard file {paths[i]} contains non-finite values")
        gblock = np.arange(offsets[i], offsets[i + 1], dtype=np.int32)
        pad = width - block.shape[0]
        if pad:
            block = np.concatenate([block, np.full((pad, dim), np.inf, np.float32)])
            gblock = np.concatenate([gblock, np.full(pad, -1, np.int32)])
        pts.append(torch.from_numpy(block))
        gid.append(torch.from_numpy(gblock))
    bits = default_bits(dim)
    parts, occ = local_forest(pts, gid, mesh.devices, bucket_cap, bits)
    _count_build(n, p)
    return _forest(parts, occ, num_points=n, seed=-1, bucket_cap=bucket_cap, bits=bits)


def _as_queries(forest: GlobalMortonForest, queries) -> torch.Tensor:
    return torch.as_tensor(queries, dtype=torch.float32, device=forest.device)


def _query_dfs(forest: GlobalMortonForest, queries: torch.Tensor, k: int,
               devices) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every shard's per-query DFS over its own tree, then the merge. The
    SPMD form passes the mesh's devices; the mesh-free form each shard's
    own."""
    d, i = [], []
    for p, dev in enumerate(devices):
        tree = forest.shard(p, forest.num_points, dev)
        sd, si = morton_knn_chunks(tree, queries.to(dev), k)
        d.append(sd)
        i.append(si)
    out = queries.device
    return _merge_partials(all_gather(d, out), all_gather(i, out), k)


def global_morton_query(
    forest: GlobalMortonForest,
    queries,
    k: int = 1,
    mesh: Mesh | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN against a forest: replicated queries, every shard's
    answer over its own range, one merge. Returns (d2 f32[Q, k], global
    ids i32[Q, k]) ascending.

    Dense low-D batches take the tiled engine
    (:func:`global_morton_query_tiled`). Without a ``mesh``, one of
    ``forest.devices`` shards is made when the hardware has that many
    devices; otherwise (a checkpoint loaded elsewhere) the query runs
    mesh-free, with the same answers."""
    queries = _as_queries(forest, queries)
    if mesh is None:
        mesh = mesh_for(forest.devices, forest.device)
    k = min(k, forest.num_points)
    _count_sharded_query("global-morton", queries.shape[0], forest.devices)
    from kdtree_tpu_torch.ops.tile_query import dense_lowd

    if dense_lowd(queries.shape[0], forest.num_points, forest.dim):
        return global_morton_query_tiled(forest, queries, k=k, mesh=mesh)
    if mesh is not None and mesh.size == forest.devices:
        return _query_dfs(forest, queries, k, mesh.devices)
    return _query_dfs(forest, queries, k, [b.device for b in forest.bucket_pts])


def _shard_n_real(forest: GlobalMortonForest, k: int) -> int:
    """Per-shard real-point count for tile planning, floored at k: the
    build's ``occ_max`` quantized up to steps of 1/16 of the even share
    (so that same-shaped rebuilds plan alike), or the even share when the
    occupancy is unknown (0)."""
    est = -(-forest.num_points // forest.devices)
    occ = getattr(forest, "occ_max", 0)
    if occ > 0:
        step = max(1, est // 16)
        occ = -(-occ // step) * step
    return max(occ if occ > 0 else est, k)


def _query_tiled_spmd(forest: GlobalMortonForest, queries: torch.Tensor, k: int,
                      mesh: Mesh, stats=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tiled engine on every shard: Hilbert-sort the queries once,
    then per batch one tiled run per shard (the scan kernel on the card)
    and one merge, under the shared overflow-retry driver. The per-shard
    plan is signed with ``devices=P`` and the shard's real-row count."""
    from kdtree_tpu_torch import tuning
    from kdtree_tpu_torch.ops.tile_query import (
        _sort_queries, _tiled_batch_core, _unsort, drive_batches, plan_tiled,
    )

    Q, D = queries.shape
    P = forest.devices
    nbp, B = forest.num_buckets, forest.bucket_size
    dev0 = mesh.devices[0]
    n_shard = _shard_n_real(forest, k)
    plan = plan_tiled(Q, D, n_shard, nbp, B, k, device=dev0, devices=P)
    feedback = tuning.feedback_for(plan)
    sq, order = _sort_queries(queries.to(dev0), plan.bits, (-Q) % plan.qbatch)
    sqs = [sq.to(d) for d in mesh.devices]  # replicated
    trees = [forest.shard(p, n_shard, d) for p, d in enumerate(mesh.devices)]

    def run_batch(b0: int, cap: int):
        outs = [_tiled_batch_core(trees[p], sqs[p][b0:b0 + plan.qbatch], k,
                                  plan.tile, cap, plan.seeds, plan.v, plan.tb,
                                  plan.use_kernel)
                for p in range(P)]
        md, mi = _merge_partials(all_gather([o[0] for o in outs], dev0),
                                 all_gather([o[1] for o in outs], dev0), k)
        ov = psum([o[2].to(torch.int32) for o in outs], mesh)[0] > 0
        nc = psum([o[3] for o in outs], mesh)[0]
        return md, mi, ov, nc

    d2, gi = drive_batches(
        run_batch, list(range(0, sq.shape[0], plan.qbatch)), plan.cmax, nbp,
        settle_first=plan.source != "warm", feedback=feedback, stats=stats,
        scan_units_per_batch=(plan.qbatch // plan.tile) * P)
    return _unsort(order, d2, gi, Q)


def _forest_view_inputs(forest: GlobalMortonForest) -> dict:
    """``morton_view``'s arguments for ONE view over every shard's rows
    (padding rows keep their +inf / -1 encoding), on shard 0's device.
    The device-memory guard runs before the flattened copy is made."""
    from kdtree_tpu_torch.ops.morton import check_build_capacity

    p, nbp, B, d = forest.devices, forest.num_buckets, forest.bucket_size, forest.dim
    dev = forest.device
    check_build_capacity(p * nbp * B, d, dev)
    return dict(
        points=torch.cat([bp.to(dev).reshape(nbp * B, d) for bp in forest.bucket_pts]),
        gid=torch.cat([bg.to(dev).reshape(nbp * B) for bg in forest.bucket_gid]),
        n_real=forest.num_points,
        bucket_cap=forest.bucket_cap,
        bits=forest.bits,
    )


def _query_tiled_meshfree(forest: GlobalMortonForest, queries: torch.Tensor,
                          k: int, stats=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tiled engine without a mesh: one run over a flattened Morton
    view of every shard's rows (built once, cached on the forest), or,
    when the view does not fit the device, the shards one after another
    (peak memory one shard's tree) and the merge."""
    from kdtree_tpu_torch.ops.morton import serving_view
    from kdtree_tpu_torch.ops.tile_query import morton_knn_tiled

    view = serving_view(forest, lambda: _forest_view_inputs(forest),
                        cache_attr="_dense_view")
    if view is not None:
        return morton_knn_tiled(view, queries, k=k, stats=stats)
    n_shard = _shard_n_real(forest, k)
    d, i = [], []
    for p in range(forest.devices):
        sd, si = morton_knn_tiled(forest.shard(p, n_shard), queries, k=k, stats=stats)
        d.append(sd)
        i.append(si)
    return _merge_partials(all_gather(d, queries.device),
                           all_gather(i, queries.device), k)


def global_morton_query_tiled(
    forest: GlobalMortonForest,
    queries,
    k: int = 1,
    mesh: Mesh | None = None,
    stats=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense-batch serving path of a forest: on a mesh of
    ``forest.devices`` shards, the tiled engine on every shard and one
    merge per batch; otherwise mesh-free (:func:`_query_tiled_meshfree`).
    Exact on both; returns (d2 f32[Q, k], global ids i32[Q, k]). A
    ``TileStats`` in ``stats`` accumulates the batches and overflow
    retries."""
    queries = _as_queries(forest, queries)
    k = min(k, forest.num_points)
    Q = queries.shape[0]
    if Q == 0:
        return (torch.zeros((0, k), device=queries.device),
                torch.zeros((0, k), dtype=torch.int32, device=queries.device))
    if mesh is None:
        mesh = mesh_for(forest.devices, forest.device)
    if mesh is not None and mesh.size == forest.devices:
        return _query_tiled_spmd(forest, queries, k, mesh, stats)
    return _query_tiled_meshfree(forest, queries, k, stats)


def global_morton_knn(
    seed: int,
    dim: int,
    num_points: int,
    queries,
    k: int = 1,
    mesh: Mesh | None = None,
    bucket_cap: int = 128,
    slack: float | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the forest from (seed, dim, num_points) and answer
    ``queries``: exact k-NN over a problem whose [N, D] array never
    exists on one device. Raises RuntimeError on exchange overflow."""
    mesh = _default_mesh(mesh)
    forest = build_global_morton(seed, dim, num_points, mesh=mesh,
                                 bucket_cap=bucket_cap, slack=slack)
    return global_morton_query(forest, queries, k=k, mesh=mesh)


__all__ = [
    "DEFAULT_SLACK",
    "GlobalMortonForest",
    "SHARD_AXIS",
    "build_global_morton",
    "build_global_morton_from_points",
    "build_global_morton_from_shard_files",
    "global_morton_knn",
    "global_morton_query",
    "global_morton_query_tiled",
]
