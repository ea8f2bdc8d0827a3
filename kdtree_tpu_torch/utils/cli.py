"""Command-line interface of the port: the one-shot subcommands and the
online server.

The port of ``kdtree_tpu/utils/cli.py``'s ``harness``, ``bench``, ``build``,
``query`` and ``serve``, for the ``auto``, ``morton``, ``tiled``, ``tree``
(the classic median-split tree), ``bucket``, ``bruteforce`` and the
multi-device engines (``ensemble``, ``global``, ``global-morton``,
``global-exact``, over ``--devices`` shards) and the ``threefry`` and
``mt19937`` generators.
Output bytes and exit codes are the reference's:

- ``harness``: the course grading protocol — ``READY`` on stdout, seed
  from stdin (interactive; dim=128, n=500000) or ``SEED DIM NUM_POINTS``
  argv mode, result lines ``ID: <id> \\t DISTANCE: <d>``, then ``DONE``;
- ``bench``: per-phase timing (generate, build, query) after a warm-up
  run on another seed, as one JSON line;
- ``build`` / ``query``: build and save / load and query (npz
  checkpoint, readable by both packages); ``build --save DIR`` also
  writes a serving snapshot (``snapshot/store.py``);
- ``serve``: the long-lived HTTP server (``serve/server.py``) over a
  serving snapshot, a Morton or classic checkpoint (a classic tree serves
  through its Morton view), a points file or the seeded
  threefry problem, until SIGTERM/SIGINT drains it; a primary emits
  snapshots on every epoch swap (``--snapshot-save``), a read-only
  secondary follows them (``--snapshot-follow``); the degradation ladder
  is armed (``--no-ladder`` disarms it) and the online recall sampler
  re-answers ``--recall-sample`` of the approximate batches exactly;
- ``recall``: the recall harness — sweep visit caps against the exact
  engine, print the recall@k-vs-speedup curve and persist the
  recall_target -> visit_cap calibration into the plan store;
- ``tune``: sweep (tile, cmax) and then (v, tb) candidates of the tiled
  engine and persist the winner into the plan store;
- ``profile``: a tiled k-NN workload under a ``torch.profiler`` capture
  window, analyzed into the device timeline (busy/idle per batch
  dispatch, dispatch lag, time and launches per kernel);
- ``stats``: render a ``--metrics-out`` report (``--diff OLD NEW``
  compares two);
- ``trace`` / ``costs``: fetch a live server's distributed trace (the
  ASCII waterfall) or its cost ledger (cost per query, headroom);
- ``partition``: cut one point cloud into N Morton-range shard snapshots
  (global ids are the Morton ranks; each manifest carries its region);
- ``route``: the scatter/gather router over shard (or child router)
  processes (``serve/router.py``);
- ``loadgen``: the open-loop load harness against a live serve or route
  process, with its capacity block (``loadgen/``).

``--metrics-out PATH`` (before the subcommand) writes the one-shot JSON
telemetry report of any run on exit, failed runs included.

Everything runs on the CUDA device unless ``--device cpu`` asks for the
CPU. ``auto`` picks an engine by the reference's crossovers
(:func:`_resolve_engine`). The multi-device engines run on a mesh of
``--devices`` CUDA devices (default: all), or of that many logical shards
with ``--device cpu`` (default 1). ``route``, ``loadgen``, ``stats``,
``trace`` and ``costs`` are host code and resolve no device. The
reference's ``lint`` and ``trend`` subcommands exit with code 1 and name
the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from kdtree_tpu_torch.ops.tile_query import dense_lowd

# the reference's subcommands this port does not serve yet, by the ROADMAP
# queue 1 item that brings them
UNPORTED_COMMANDS = {"lint": 18, "trend": 18}

NUM_QUERIES = 10  # the reference program's fixed query count
HARNESS_DIM = 128
HARNESS_NUM_POINTS = 500000
AUTO_TREE_DIM_MAX = 16

ENGINES = ("auto", "morton", "tiled", "tree", "bucket", "bruteforce", "ensemble",
           "global", "global-morton", "global-exact")
# engines whose build draws the seeded row stream shard by shard
SCALE_ENGINES = ("global-morton", "global-exact")


def _validate_input(seed: int, dim: int, num_points: int) -> None:
    """The reference program's input checks, with its exit codes."""
    if seed == 0:
        print("Warning: default value 0 used as seed.", file=sys.stderr)
    if seed < 0:
        print("Seed has to be larger than 0!", file=sys.stderr)
        sys.exit(1)
    if dim <= 0:
        print("Dimension has to be larger than 0!", file=sys.stderr)
        sys.exit(1)
    if num_points <= 0:
        print("Number of points has to be larger than 0!", file=sys.stderr)
        sys.exit(1)
    print(f"\tUsing seed {seed}", file=sys.stderr)
    print(f"\tUsing point dimensions {dim}", file=sys.stderr)
    print(f"\tUsing number of points {num_points}\n", file=sys.stderr)


def _format_distance(d: float) -> str:
    """C++ ``std::cout << float`` default formatting (6 significant digits)."""
    return f"{d:g}"


def print_result_line(point_id: int, distance: float, file=None) -> None:
    # "ID: <id> \t DISTANCE: <d>"; file=None resolves to sys.stdout at CALL
    # time, so contextlib.redirect_stdout reaches in-process callers of main()
    print(f"ID: {point_id} \t DISTANCE: {_format_distance(distance)}", file=file)


def _generate(seed: int, dim: int, num_points: int, generator: str, device):
    """(points, queries, generator_used) on ``device``. mt19937 replays the
    reference program's stream bit for bit (native C++, on the host);
    threefry is the row stream of ``generate_points_rowwise`` plus
    ``generate_queries``. Without a g++ toolchain mt19937 falls back to
    threefry with a note, and the name returned is the one that ran."""
    if generator == "mt19937":
        from kdtree_tpu_torch import native

        if not native.available():
            print("native generator unavailable; falling back to threefry", file=sys.stderr)
            generator = "threefry"
        else:
            pts, qs = native.generate_problem_mt19937(seed, dim, num_points, NUM_QUERIES)
            return (torch.from_numpy(pts).to(device), torch.from_numpy(qs).to(device),
                    "mt19937")
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries

    pts = generate_points_rowwise(seed, dim, num_points, device=device)
    qs = generate_queries(seed, dim, NUM_QUERIES, device=device)
    return pts, qs, "threefry"


def _generate_queries(seed: int, dim: int, num_points: int, generator: str, device):
    """Only the NUM_QUERIES query rows, never the N points: mt19937 rows
    [N, N+10) straight off the stream, or threefry's query block. No
    fallback here: a checkpoint's points are fixed, so queries from
    another generator would answer a problem that never existed."""
    if generator == "mt19937":
        from kdtree_tpu_torch import native

        if not native.available():
            raise SystemExit(
                "checkpoint was built with the mt19937 generator but the "
                "native generator is unavailable here (no g++ toolchain); "
                "refusing to answer queries from a different problem"
            )
        return torch.from_numpy(native.generate_rows(seed, dim, num_points, NUM_QUERIES)).to(device)
    from kdtree_tpu_torch.ops.generate import generate_queries

    return generate_queries(seed, dim, NUM_QUERIES, device=device)


def _resolve_engine(engine: str, dim: int, q: int | None = None,
                    n: int | None = None) -> str:
    """The reference's Q-aware engine choice, thresholds unchanged (they
    were measured on a TPU; the H100 reports its own crossover, see
    PERF.md): brute force in high D and for small scan jobs, the tiled
    engine for dense low-D batches, the Morton DFS otherwise."""
    if engine != "auto":
        return engine
    if dim > AUTO_TREE_DIM_MAX:
        return "bruteforce"
    if q is not None and n is not None:
        if dense_lowd(q, n, dim):
            return "tiled"
        if q * n * dim <= 2e13:
            return "bruteforce"
    return "morton"


def _mesh(mesh_devices, dev):
    from kdtree_tpu_torch.parallel import make_mesh

    return make_mesh(mesh_devices, device=dev)


def _build_index(points, engine: str, mesh_devices: int | None = None,
                 problem=None, slack: float | None = None, dev=None):
    """Build phase: the index object for an engine. ``problem`` = (seed,
    dim, n[, distribution]) is what the scale engines build from (they
    never materialize [N, D]; ``points`` may be None there); ``slack``
    overrides their exchange capacity factor."""
    if engine in ("morton", "tiled"):
        from kdtree_tpu_torch.ops.morton import build_morton

        return build_morton(points)
    if engine == "tree":
        from kdtree_tpu_torch.ops.build import build_jit

        return build_jit(points)
    if engine == "bucket":
        from kdtree_tpu_torch.ops.bucket import build_bucket

        return build_bucket(points)
    if engine == "bruteforce":
        return points  # the index IS the point array
    if engine == "global":
        from kdtree_tpu_torch.parallel.global_tree import build_global

        return build_global(points, mesh=_mesh(mesh_devices, dev))
    if engine in SCALE_ENGINES:
        from kdtree_tpu_torch.parallel import build_global_exact, build_global_morton

        build = build_global_morton if engine == "global-morton" else build_global_exact
        seed, dim, num_points = problem[:3]
        kw = {} if slack is None else {"slack": slack}
        return build(seed, dim, num_points, mesh=_mesh(mesh_devices, dev),
                     distribution=_problem_distribution(problem), **kw)
    raise SystemExit(f"engine {engine!r} has no split build phase")


def _problem_distribution(problem) -> str:
    """problem is (seed, dim, n) or (seed, dim, n, distribution)."""
    return problem[3] if len(problem) > 3 else "uniform"


def _check_distribution(engine: str, dist: str) -> None:
    """Non-uniform row streams exist only for the scale engines (shared by
    bench and build)."""
    if dist != "uniform" and engine not in SCALE_ENGINES:
        print(f"--distribution {dist} needs a generative scale engine "
              "(global-morton / global-exact); other engines define their "
              "problems by the uniform stream or user --points data",
              file=sys.stderr)
        sys.exit(1)


def _query_index(index, queries, k: int, engine: str,
                 mesh_devices: int | None = None, dev=None):
    """Query phase against the object _build_index returned."""
    if engine == "morton":
        from kdtree_tpu_torch.ops.morton import morton_knn

        return morton_knn(index, queries, k=k)
    if engine == "tiled":
        from kdtree_tpu_torch.ops.tile_query import morton_knn_tiled

        return morton_knn_tiled(index, queries, k=k)
    if engine == "tree":
        from kdtree_tpu_torch.ops.query import knn

        return knn(index, queries, k=k)
    if engine == "bucket":
        from kdtree_tpu_torch.ops.bucket import bucket_knn

        return bucket_knn(index, queries, k=k)
    if engine == "bruteforce":
        from kdtree_tpu_torch.ops import bruteforce

        return bruteforce.knn(index, queries, k=k)
    if engine == "global":
        from kdtree_tpu_torch.parallel.global_tree import global_knn

        return global_knn(index, queries, k=k)
    if engine == "global-morton":
        from kdtree_tpu_torch.parallel.global_morton import global_morton_query

        return global_morton_query(index, queries, k=k, mesh=_mesh(mesh_devices, dev))
    if engine == "global-exact":
        from kdtree_tpu_torch.parallel.global_exact import global_exact_query

        return global_exact_query(index, queries, k=k, mesh=_mesh(mesh_devices, dev))
    raise SystemExit(f"engine {engine!r} has no split query phase")


def _solve(points, queries, k: int, engine: str, mesh_devices: int | None = None,
           problem=None, dev=None):
    """Returns (d2[Q,k], idx[Q,k]) by the chosen engine."""
    dim = queries.shape[1]
    n = points.shape[0] if points is not None else (problem[2] if problem else None)
    engine = _resolve_engine(engine, dim, q=queries.shape[0], n=n)
    if engine == "ensemble":
        # one build-and-query per shard by design
        from kdtree_tpu_torch.parallel import ensemble_knn, ensemble_knn_gen

        mesh = _mesh(mesh_devices, dev)
        if points is None:
            seed, pdim, num_points = problem[:3]
            return ensemble_knn_gen(seed, pdim, num_points, queries, k=k, mesh=mesh)
        return ensemble_knn(points, queries, k=k, mesh=mesh)
    index = _build_index(points, engine, mesh_devices, problem=problem, dev=dev)
    return _query_index(index, queries, k, engine, mesh_devices, dev)


def _generative(engine: str, generator: str) -> bool:
    """Engines whose build draws the seeded row stream shard by shard and
    never materializes [N, D]: the scale engines always, ensemble under
    the threefry generator (the mt19937 replay needs the sequential
    stream)."""
    return engine in SCALE_ENGINES or (engine == "ensemble" and generator == "threefry")


def cmd_harness(args) -> None:
    if args.spec:
        # argv mode: READY after the argument count check
        print("READY", flush=True)
        try:
            seed, dim, num_points = (int(x) for x in args.spec)
        except ValueError:
            print(f"Invalid problem spec {args.spec!r}: SEED DIM_POINTS "
                  "NUM_POINTS must be integers", file=sys.stderr)
            sys.exit(1)
    else:
        # interactive mode
        print("READY", flush=True)
        print("Specify seed ", file=sys.stderr, end="", flush=True)
        try:
            seed = int(sys.stdin.readline())
        except ValueError:
            # the reference's failed `cin >>` leaves the seed at 0
            print("Invalid seed input; using default seed 0", file=sys.stderr)
            seed = 0
        dim, num_points = HARNESS_DIM, HARNESS_NUM_POINTS
    _validate_input(seed, dim, num_points)

    engine = _resolve_engine(args.engine, dim, q=NUM_QUERIES, n=num_points)
    if _generative(engine, args.generator):
        if args.generator != "threefry":
            print(f"note: {engine} defines its points by the threefry "
                  "row stream (shard-local generation); using threefry "
                  "queries", file=sys.stderr)
        from kdtree_tpu_torch.ops.generate import generate_queries

        queries = generate_queries(seed, dim, NUM_QUERIES, device=args.dev)
        d2, _ = _solve(None, queries, k=1, engine=engine, mesh_devices=args.devices,
                       problem=(seed, dim, num_points), dev=args.dev)
    else:
        points, queries, _ = _generate(seed, dim, num_points, args.generator, args.dev)
        d2, _ = _solve(points, queries, k=1, engine=engine, mesh_devices=args.devices,
                       dev=args.dev)
    dists = np.sqrt(d2[:, 0].cpu().numpy().astype(np.float64))
    for q in range(NUM_QUERIES):
        # query ids are num_points + q, as in the reference program
        print_result_line(num_points + q, float(dists[q]))
    print("DONE", flush=True)


def cmd_bench(args) -> None:
    import contextlib

    from kdtree_tpu_torch.obs import torchrt
    from kdtree_tpu_torch.utils.timing import PhaseTimer

    engine = _resolve_engine(args.engine, args.dim, q=NUM_QUERIES, n=args.n)
    fused_gen = _generative(engine, args.generator)  # generation inside the build
    fused_bq = engine == "ensemble"  # one build-and-query per shard
    dist = args.distribution
    _check_distribution(engine, dist)

    def run(seed: int, timer: PhaseTimer | None):
        t = timer or PhaseTimer()
        problem = (seed, args.dim, args.n, dist)
        points = None
        with t.phase("generate") as h:
            if fused_gen:
                from kdtree_tpu_torch.ops.generate import generate_queries

                queries = generate_queries(seed, args.dim, NUM_QUERIES, device=args.dev)
                h += [queries]
            else:
                points, queries, _ = _generate(seed, args.dim, args.n, args.generator,
                                               args.dev)
                h += [points, queries]
        if fused_bq:
            with t.phase("build+query") as h:
                d2, idx = _solve(points, queries, k=args.k, engine=engine,
                                 mesh_devices=args.devices, problem=problem, dev=args.dev)
                h += [d2, idx]
            return d2
        with t.phase("build") as h:
            index = _build_index(points, engine, args.devices, problem=problem,
                                 dev=args.dev)
            h += [index]
        with t.phase("query") as h:
            d2, idx = _query_index(index, queries, args.k, engine, args.devices, args.dev)
            h += [d2, idx]
        return d2

    dev = args.dev
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    # device init + platform/device facts land in the registry (and so in
    # any --metrics-out report) before the first kernel runs
    torchrt.probe_devices(dev)
    # warm-up on a distinct seed (kernel builds, allocator growth), excluded
    # from timing; the timed run uses fresh inputs
    run(args.seed + 1000, None).cpu()

    timer = PhaseTimer()
    if args.trace:
        from kdtree_tpu_torch.obs import profile as obs_profile

        window = obs_profile.capture(args.trace, dev)
    else:
        window = contextlib.nullcontext()
    with window as cap:
        run(args.seed, timer)
    if cap is not None:
        print(f"profiler trace written to {cap.trace_file}", file=sys.stderr)
    rep = timer.report()
    # pts/s excludes generation
    solve_s = rep["total"] - rep["generate"]
    rep.update(
        n=args.n, dim=args.dim, k=args.k, engine=engine,
        pts_per_sec=(args.n / solve_s) if solve_s > 0 else None,
        platform=dev.type, device_count=count,
    )
    print(json.dumps(rep))


def _build_tree_for_engine(points, engine: str, mesh_devices: int | None = None,
                           problem=None, slack: float | None = None, dev=None):
    """The tree to checkpoint for an engine choice: ``auto``, ``morton``
    and ``tiled`` share the Morton tree (tiled is a query strategy, not an
    index); the others build their own."""
    if engine in ("auto", "morton", "tiled"):
        from kdtree_tpu_torch.ops.morton import build_morton

        return build_morton(points)
    if engine in ("tree", "bucket", "global", *SCALE_ENGINES):
        return _build_index(points, engine, mesh_devices, problem=problem, slack=slack,
                            dev=dev)
    raise SystemExit(f"engine {engine!r} does not produce a checkpointable tree")


def _tree_knn(tree, queries, k: int):
    """k-NN on whichever tree a checkpoint held. Dense low-D batches take
    the tiled engine (the same crossover as :func:`_resolve_engine`):
    directly on a Morton tree or a forest, through a cached Morton view on
    a classic or bucketed tree; the rest take the tree's own DFS."""
    from kdtree_tpu_torch.models.tree import KDTree
    from kdtree_tpu_torch.ops.bucket import BucketKDTree, bucket_knn
    from kdtree_tpu_torch.ops.morton import MortonTree, morton_knn
    from kdtree_tpu_torch.parallel import (
        GlobalExactTree, GlobalKDTree, GlobalMortonForest, global_exact_query,
        global_knn, global_morton_query,
    )

    q, dim = queries.shape
    if isinstance(tree, GlobalMortonForest):
        # routes dense batches to the tiled engine itself, and runs
        # mesh-free when the hardware does not match the forest
        return global_morton_query(tree, queries, k=k)
    if isinstance(tree, GlobalExactTree):
        return global_exact_query(tree, queries, k=k)
    if isinstance(tree, GlobalKDTree):
        return global_knn(tree, queries, k=k)
    if isinstance(tree, MortonTree):
        if dense_lowd(q, tree.n_real, dim):
            from kdtree_tpu_torch.ops.tile_query import morton_knn_tiled

            return morton_knn_tiled(tree, queries, k=k)
        return morton_knn(tree, queries, k=k)
    if isinstance(tree, BucketKDTree):
        if dense_lowd(q, tree.n_real, dim):
            out = _serve_dense_via_view(tree, queries, k,
                                        lambda: bucket_view_inputs(tree))
            if out is not None:
                return out
        return bucket_knn(tree, queries, k=k)
    assert isinstance(tree, KDTree)
    if dense_lowd(q, tree.n, dim):
        # the classic tree keeps the original [N, D] array, so its view
        # answers with ids that are already original rows
        out = _serve_dense_via_view(tree, queries, k, lambda: dict(points=tree.points))
        if out is not None:
            return out
    from kdtree_tpu_torch.ops.query import knn

    return knn(tree, queries, k=k)


def bucket_view_inputs(tree) -> dict:
    """``morton_view``'s arguments for a bucketed tree: its split points
    live in the internal nodes, not in any bucket, so the view holds both
    (absent node slots as the inf / -1 padding), answering with the
    tree's ids."""
    node_pts = torch.where((tree.node_gid >= 0)[:, None], tree.node_coords, float("inf"))
    flat = torch.cat([tree.bucket_pts.reshape(-1, tree.dim), node_pts])
    gids = torch.cat([tree.bucket_gid.reshape(-1), tree.node_gid])
    return dict(points=flat, gid=gids, n_real=tree.n_real)


def _serve_dense_via_view(tree, queries, k: int, make_flat):
    """A dense batch on a classic or bucketed tree, by the tiled engine
    over the tree's cached Morton view; None (the caller falls back to its
    own DFS) when the view does not fit the device."""
    from kdtree_tpu_torch.ops.morton import serving_view
    from kdtree_tpu_torch.ops.tile_query import morton_knn_tiled

    view = serving_view(tree, make_flat)
    if view is None:
        return None
    return morton_knn_tiled(view, queries, k=k)


def _load_array(path: str, what: str) -> "np.ndarray":
    """Load a user-supplied [N, D] f32 array (.npy, or .npz key 'points'/
    'queries'/first array). Rejects non-finite values loudly."""
    import zipfile

    try:
        arr = np.load(path, allow_pickle=False)
        if hasattr(arr, "files"):  # npz
            for key in (what, "points", "queries"):
                if key in arr.files:
                    arr = arr[key]
                    break
            else:
                arr = arr[arr.files[0]]
        arr = np.asarray(arr, dtype=np.float32)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        print(f"cannot load {what} file {path}: {e}", file=sys.stderr)
        sys.exit(1)
    if arr.ndim != 2:
        print(f"{what} file {path} must be [N, D], got shape {arr.shape}",
              file=sys.stderr)
        sys.exit(1)
    if arr.shape[0] < 1 or arr.shape[1] < 1:
        print(f"{what} file {path} must be non-empty [N, D], got shape "
              f"{arr.shape}", file=sys.stderr)
        sys.exit(1)
    if not np.isfinite(arr).all():
        print(f"{what} file {path} contains non-finite values", file=sys.stderr)
        sys.exit(1)
    return arr


def _shard_file_paths(pattern: str) -> list:
    """The contiguous ``{i}``-numbered files of a pre-sharded --points
    pattern, from i = 0; exits crisply on a malformed pattern, on no
    match, or on a gap in the sequence."""
    import glob as globmod
    import os

    if "{" in pattern.replace("{i}", "") or "}" in pattern.replace("{i}", ""):
        print(f"bad --points pattern {pattern}: only the literal {{i}} placeholder "
              "is supported (no format specs like {i:02d}, no other fields)",
              file=sys.stderr)
        sys.exit(1)
    paths = []
    while os.path.exists(pattern.format(i=len(paths))):
        paths.append(pattern.format(i=len(paths)))
    if not paths:
        print(f"no shard files match {pattern} (i=0...)", file=sys.stderr)
        sys.exit(1)
    stray = set(globmod.glob("*".join(globmod.escape(part)
                                      for part in pattern.split("{i}")))) - set(paths)
    if stray:
        print(f"shard sequence has a gap: {len(paths)} contiguous file(s) from i=0, "
              f"but also found {sorted(stray)[:3]}... — refusing to build a "
              "partial index", file=sys.stderr)
        sys.exit(1)
    return paths


def _open_points_streaming(path: str):
    """A user point file for block-streamed ingest: a ``.npy`` opens as a
    memmap (per-block checks happen as blocks are read); anything else
    takes the validating in-memory loader."""
    if path.endswith(".npy"):
        try:
            arr = np.load(path, mmap_mode="r", allow_pickle=False)
        except (OSError, ValueError) as e:
            print(f"cannot load points file {path}: {e}", file=sys.stderr)
            sys.exit(1)
        if arr.ndim != 2 or arr.shape[0] < 1 or arr.shape[1] < 1:
            print(f"points file {path} must be non-empty [N, D], got shape "
                  f"{arr.shape}", file=sys.stderr)
            sys.exit(1)
        if not np.issubdtype(arr.dtype, np.number):
            print(f"points file {path} must be numeric, got dtype {arr.dtype}",
                  file=sys.stderr)
            sys.exit(1)
        return arr
    return _load_array(path, "points")


def _build_forest_from_points(args):
    """``build --points`` with the scale engine: a ``{i}`` pattern maps
    pre-sharded files onto shards as they are; one file streams block by
    block through the exchange. Returns (forest, n, dim)."""
    import os

    from kdtree_tpu_torch.parallel import make_mesh
    from kdtree_tpu_torch.parallel.global_morton import (
        build_global_morton_from_points, build_global_morton_from_shard_files,
    )

    if "{i}" in args.points or (("{" in args.points or "}" in args.points)
                                and not os.path.exists(args.points)):
        paths = _shard_file_paths(args.points)
        if args.devices is not None and args.devices != len(paths):
            print(f"--devices {args.devices} conflicts with {len(paths)} shard "
                  "files (file i maps to device i verbatim)", file=sys.stderr)
            sys.exit(1)
        try:
            tree = build_global_morton_from_shard_files(
                paths, mesh=make_mesh(len(paths), device=args.dev))
        except (OSError, ValueError) as e:
            print(f"cannot build from {args.points}: {e}", file=sys.stderr)
            sys.exit(1)
        return tree, tree.num_points, tree.dim
    arr = _open_points_streaming(args.points)
    skw = {} if args.slack is None else {"slack": args.slack}
    try:
        tree = build_global_morton_from_points(
            arr, mesh=make_mesh(args.devices, device=args.dev), **skw)
    except (ValueError, RuntimeError) as e:
        print(f"cannot build from {args.points}: {e}", file=sys.stderr)
        sys.exit(1)
    return tree, arr.shape[0], arr.shape[1]


def cmd_build(args) -> None:
    from kdtree_tpu_torch.utils.checkpoint import save_tree

    dist = args.distribution
    _check_distribution(args.engine, dist)
    if not args.out and not args.save:
        print("build needs --out FILE (npz checkpoint) and/or --save DIR "
              "(serving snapshot)", file=sys.stderr)
        sys.exit(1)
    if args.points:
        # user data, not a seeded problem
        if args.engine == "global-exact":
            print("engine global-exact is generative (exact-median row "
                  "streams); use global-morton for scale-tier --points "
                  "ingest, or a materialized engine", file=sys.stderr)
            sys.exit(1)
        if args.engine == "global-morton":
            tree, n, dim = _build_forest_from_points(args)
        else:
            points = torch.from_numpy(_load_array(args.points, "points")).to(args.dev)
            tree = _build_tree_for_engine(points, args.engine, args.devices, dev=args.dev)
            n, dim = points.shape
        meta = {"generator": "file"}
    elif args.engine in SCALE_ENGINES:
        # generative: the [N, D] array never exists
        if args.generator != "threefry":
            print(f"note: {args.engine} defines its points by the threefry "
                  "row stream (shard-local generation); --generator "
                  f"{args.generator} does not apply", file=sys.stderr)
        try:
            tree = _build_tree_for_engine(None, args.engine, args.devices,
                                          problem=(args.seed, args.dim, args.n, dist),
                                          slack=args.slack, dev=args.dev)
        except RuntimeError as e:
            # exchange capacity overflow: crisp stderr + exit code
            print(f"cannot build: {e}", file=sys.stderr)
            sys.exit(1)
        n, dim = args.n, args.dim
        meta = {"seed": args.seed, "generator": "threefry", "distribution": dist}
    else:
        points, _, gen_used = _generate(args.seed, args.dim, args.n, args.generator, args.dev)
        tree = _build_tree_for_engine(points, args.engine, args.devices, dev=args.dev)
        n, dim = points.shape
        meta = {"seed": args.seed, "generator": gen_used}
    if args.out:
        try:
            fmt = save_tree(args.out, tree, meta=meta, sharded=True if args.sharded else None)
        except TypeError as e:
            print(f"cannot save sharded: {e}", file=sys.stderr)
            sys.exit(1)
        # a sharded checkpoint is NOT one self-contained file: say so
        suffix = (f" (+ per-device shard files {args.out}.shard*.npz)"
                  if fmt == "sharded" else "")
        print(f"saved {type(tree).__name__} (n={n}, dim={dim}) to {args.out}{suffix}")
    if args.save:
        # serving snapshot: the built index's arrays as checksummed flat
        # .npy segments + a versioned manifest, so `serve --snapshot`
        # replicas start without re-running the build
        from kdtree_tpu_torch import snapshot as snap
        from kdtree_tpu_torch.serve.engine import tree_for_serving

        try:
            serving = tree_for_serving(tree)
        except TypeError as e:
            print(f"cannot snapshot: {e}", file=sys.stderr)
            sys.exit(1)
        keys = snap.plan_keys_for(serving, k=16)
        man = snap.save_snapshot(
            args.save, serving, epoch=0, plan_keys=keys,
            plan_profiles=snap.collect_plan_profiles(keys),
            meta=dict(meta), keep=max(args.snapshot_keep or 1, 1),
        )
        print(f"serving snapshot v{man['version']} (epoch "
              f"{man['epoch']}, n={man['signature']['n_real']}) saved "
              f"to {snap.resolve_dir(args.save)}")


def cmd_partition(args) -> None:
    """Spatial partitioner: cut one point cloud into N contiguous
    Morton-range shards, each written as a ready-to-serve snapshot whose
    manifest carries the shard's region (grid + code range) and whose
    global ids are the Morton ranks, so the shard's id set AND its region
    are both contiguous. A fleet served from these shards gives the router
    disjoint, tight bounding boxes to prune against. The cut is host numpy
    (``serve/spatial.py``); each shard's Morton view is built on
    ``--device``."""
    import os

    from kdtree_tpu_torch import snapshot as snap
    from kdtree_tpu_torch.ops.morton import morton_view
    from kdtree_tpu_torch.serve import spatial as sp

    if args.shards < 2:
        print(f"--shards must be >= 2 (got {args.shards}); one shard "
              "needs no partition", file=sys.stderr)
        sys.exit(1)
    if args.points:
        pts = _load_array(args.points, "points")
        src_meta = {"generator": "file", "points": args.points}
    else:
        if args.generator != "threefry":
            print("note: partition's seeded problem is the threefry "
                  f"row stream; --generator {args.generator} does not "
                  "apply", file=sys.stderr)
        from kdtree_tpu_torch.ops.generate import generate_points_rowwise

        pts = generate_points_rowwise(args.seed, args.dim, args.n,
                                      device=args.dev).cpu().numpy()
        src_meta = {"seed": args.seed, "generator": "threefry"}
    try:
        plan = sp.plan_partition(pts, args.shards, bits=args.bits)
    except ValueError as e:
        print(f"cannot partition: {e}", file=sys.stderr)
        sys.exit(1)
    base = snap.resolve_dir(args.out_dir)
    os.makedirs(base, exist_ok=True)
    keep = max(args.snapshot_keep or 1, 1)
    shard_dirs = []
    for i, ((s, e), (c0, c1), (blo, bhi)) in enumerate(
        zip(plan["bounds"], plan["code_ranges"], plan["boxes"])
    ):
        rows = plan["order"][s:e]
        # global ids ARE the Morton ranks: shard i owns ids [s, e) —
        # contiguous ids and a contiguous code range, by construction
        tree = morton_view(
            torch.from_numpy(pts[rows]).to(args.dev),
            gid=torch.arange(s, e, dtype=torch.int32, device=args.dev),
            n_real=int(e - s),
        )
        sdir = os.path.join(base, f"shard-{i:02d}")
        plan_keys = snap.plan_keys_for(tree, k=args.k, max_batch=args.max_batch)
        snap.save_snapshot(
            sdir, tree, epoch=0, id_offset=0,
            plan_keys=plan_keys,
            plan_profiles=snap.collect_plan_profiles(plan_keys),
            meta={**src_meta, "spatial": {
                "grid": plan["grid"].to_json(),
                "code_range": [int(c0), int(c1)],
                "id_range": [int(s), int(e)],
                "shard": i,
                "shards": int(args.shards),
            }},
            keep=keep,
        )
        shard_dirs.append(sdir)
        box = ", ".join(f"[{float(a):g}, {float(b):g}]" for a, b in zip(blo, bhi))
        print(f"shard {i}: n={e - s} ids [{s}, {e}) code [{c0}, {c1})  box {box}")
    man_path = sp.write_fleet_manifest(base, plan, shard_dirs)
    print(f"partitioned {pts.shape[0]} points into {args.shards} "
          f"Morton-range shards under {base} ({man_path})")
    print("serve each with: kdtree-tpu-torch serve --snapshot "
          f"{shard_dirs[0]} --port 0 ...  (id_offset stays 0 — shard "
          "trees answer GLOBAL morton-rank ids directly); then route "
          "them and the router prunes by their /healthz boxes",
          file=sys.stderr)


def cmd_query(args) -> None:
    import zipfile

    from kdtree_tpu_torch.utils.checkpoint import load_tree

    try:
        tree, meta = load_tree(args.tree, device=args.dev,
                               allow_host_materialize=args.allow_host_materialize)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        print(f"cannot load tree {args.tree}: {e}", file=sys.stderr)
        sys.exit(1)
    n = tree.n if hasattr(tree, "n") else tree.n_real
    if args.queries:
        # user query set; results to --out (npz: d2, ids) or protocol lines
        qarr = _load_array(args.queries, "queries")
        if qarr.shape[1] != tree.dim:
            print(f"queries are {qarr.shape[1]}-D but the tree is "
                  f"{tree.dim}-D", file=sys.stderr)
            sys.exit(1)
        if args.k > n:
            print(f"note: k={args.k} exceeds the tree's {n} points; "
                  f"returning k={n} neighbors", file=sys.stderr)
        if args.k > 1 and not args.out:
            print("k > 1 results need --out FILE (npz with d2[Q, k] and "
                  "ids[Q, k]); protocol lines only carry the nearest "
                  "distance", file=sys.stderr)
            sys.exit(1)
        d2, ids = _tree_knn(tree, torch.from_numpy(qarr).to(args.dev), k=args.k)
        if args.out:
            np.savez(args.out, d2=d2.cpu().numpy(), ids=ids.cpu().numpy())
            print(f"saved d2[{d2.shape[0]}, {d2.shape[1]}] + ids to {args.out}")
            return
        dists = np.sqrt(d2[:, 0].cpu().numpy().astype(np.float64))
        for q in range(qarr.shape[0]):
            print_result_line(n + q, float(dists[q]))
        print("DONE")
        return
    # the checkpoint's provenance wins over CLI defaults
    if "seed" in meta:
        seed = int(meta["seed"])
    else:
        seed = args.seed if args.seed is not None else 42
    generator = str(meta.get("generator", args.generator))
    if generator == "file":
        print("checkpoint was built from --points data; protocol queries "
              "need --queries FILE", file=sys.stderr)
        sys.exit(1)
    if args.seed is not None and args.seed != seed:
        print(f"note: using checkpoint seed {seed} (ignoring --seed {args.seed})",
              file=sys.stderr)
    queries = _generate_queries(seed, tree.dim, n, generator, args.dev)
    d2, _ = _tree_knn(tree, queries, k=args.k)
    d2 = d2.cpu().numpy()
    for q in range(queries.shape[0]):
        # float32 square root, as the reference prints this path
        print_result_line(n + q, float(np.sqrt(d2[q, 0])))
    print("DONE")


def cmd_serve(args) -> None:
    """Long-lived online serving: micro-batched ``POST /v1/knn`` and the
    verbs, the write path, ``GET /healthz`` readiness and the Prometheus
    ``GET /metrics``, over a snapshot, a checkpoint, a points file or the
    seeded problem, with the degradation ladder (``--no-ladder`` off) and
    the online recall sampler (``--recall-sample``)."""
    import signal
    import threading
    import zipfile

    from kdtree_tpu_torch.obs import flight
    from kdtree_tpu_torch.obs import history as obs_history
    from kdtree_tpu_torch.serve import engine as lifecycle
    from kdtree_tpu_torch.serve import server as srv

    snap_dir = args.snapshot
    follow_s = args.snapshot_follow
    save_dir = args.snapshot_save
    snap_version = args.snapshot_version
    if (args.index and args.points) or (args.index and snap_dir):
        print("serve needs ONE index source: --snapshot, --index, "
              "--points, or the seeded --seed/--dim/--n problem "
              "(--snapshot may pair with --points as the corruption "
              "fallback)", file=sys.stderr)
        sys.exit(1)
    if follow_s is not None and not snap_dir:
        print("--snapshot-follow needs --snapshot DIR (the manifest the "
              "secondary polls)", file=sys.stderr)
        sys.exit(1)
    if follow_s is not None and save_dir:
        print("--snapshot-follow and --snapshot-save are exclusive: a "
              "secondary adopts snapshots, only the shard primary emits "
              "them", file=sys.stderr)
        sys.exit(1)
    if snap_version is not None and not snap_dir:
        print("--snapshot-version needs --snapshot DIR (the retained "
              "generation to roll back to)", file=sys.stderr)
        sys.exit(1)
    if snap_version is not None and follow_s is not None:
        print("--snapshot-version and --snapshot-follow are exclusive: "
              "a follower converges to the LIVE manifest, which would "
              "immediately replace the pinned generation",
              file=sys.stderr)
        sys.exit(1)
    tree = points = problem = None
    meta = {}
    epoch0 = 0
    loaded_version = 0
    loaded_from_snapshot = False
    # an explicit --id-offset always wins; a snapshot of a non-zero-offset
    # shard carries its partition start in the manifest, and a replica
    # started without the flag inherits it
    id_offset = args.id_offset if args.id_offset is not None else 0
    if snap_dir:
        from kdtree_tpu_torch import snapshot as snap

        try:
            tree, man = snap.load_snapshot(snap_dir, version=snap_version,
                                           device=args.device)
            epoch0 = int(man.get("epoch", 0))
            loaded_version = int(man.get("version", 0))
            loaded_from_snapshot = True
            if args.id_offset is None and man.get("id_offset"):
                id_offset = int(man["id_offset"])
                print(f"id_offset {id_offset} inherited from the "
                      "snapshot manifest (pass --id-offset to "
                      "override)", file=sys.stderr)
            meta = {"snapshot": {
                "dir": snap.resolve_dir(snap_dir),
                "version": loaded_version,
                "epoch": epoch0,
                "role": ("secondary" if follow_s is not None
                         else "primary" if save_dir else "static"),
            }}
            if isinstance(man.get("meta"), dict) and "spatial" in man["meta"]:
                # a spatially-partitioned shard (`partition`): surface the
                # region contract (grid + owned Morton code range) on
                # /healthz so the router learns write ownership
                meta["spatial"] = man["meta"]["spatial"]
            seeded = snap.seed_plan_store(man)
            if seeded:
                print(f"plan store seeded with {seeded} pre-shipped "
                      "profile(s) from the snapshot manifest",
                      file=sys.stderr)
            print(f"snapshot loaded: v{loaded_version} epoch {epoch0} "
                  f"(n={tree.n_real}) from {snap.resolve_dir(snap_dir)}",
                  file=sys.stderr)
        except snap.SnapshotError as e:
            # named failure (schema skew / checksum mismatch / missing
            # segment — never a half-read snapshot), already counted in
            # kdtree_snapshot_load_errors_total by the store. Fall back to
            # a from-source rebuild when one was provided; otherwise fail
            # crisply.
            if args.points or args.snapshot_fallback:
                src = "--points" if args.points else "the seeded problem"
                print(f"snapshot load failed: {e}", file=sys.stderr)
                print(f"falling back to a from-scratch rebuild from "
                      f"{src} (--snapshot-fallback contract)",
                      file=sys.stderr)
                meta = {"snapshot": {
                    "dir": snap.resolve_dir(snap_dir),
                    "role": "fallback-rebuild",
                    "error": str(e)[:200],
                    # pre-seed the keys the follower's on-adopt hook
                    # updates: this dict is shared with the /healthz body,
                    # and ADDING keys during a concurrent json.dumps
                    # raises; overwriting existing values does not
                    "version": 0,
                    "epoch": 0,
                }}
                if args.points:
                    points = _load_array(args.points, "points")
                    meta["points"] = args.points
                else:
                    problem = (args.seed, args.dim, args.n)
                    meta.update(seed=args.seed, generator="threefry")
            else:
                print(f"cannot load snapshot {snap_dir}: {e}",
                      file=sys.stderr)
                print("hint: pass --points FILE (or --snapshot-fallback "
                      "with the seeded --seed/--dim/--n) to rebuild "
                      "from source when the snapshot is unusable",
                      file=sys.stderr)
                sys.exit(1)
    elif args.index:
        from kdtree_tpu_torch.utils.checkpoint import load_tree

        try:
            tree, meta = load_tree(args.index, device=args.device)
        except (OSError, ValueError, zipfile.BadZipFile) as e:
            print(f"cannot load tree {args.index}: {e}", file=sys.stderr)
            sys.exit(1)
    elif args.points:
        points = _load_array(args.points, "points")
        meta = {"points": args.points}
    else:
        if args.generator != "threefry":
            print("note: serve's seeded problem is the threefry row "
                  f"stream; --generator {args.generator} does not apply",
                  file=sys.stderr)
        problem = (args.seed, args.dim, args.n)
        meta = {"seed": args.seed, "generator": "threefry"}
    snapshot_sink = None
    if save_dir:
        from kdtree_tpu_torch import snapshot as snap

        def snapshot_sink(tree_, epoch, _dir=save_dir, _off=id_offset,
                          _k=args.k, _mb=args.max_batch,
                          _keep=max(args.snapshot_keep or 1, 1),
                          _spatial=meta.get("spatial")):
            keys = snap.plan_keys_for(tree_, _k, _mb)
            snap.save_snapshot(
                _dir, tree_, epoch=epoch, id_offset=_off, plan_keys=keys,
                plan_profiles=snap.collect_plan_profiles(keys), keep=_keep,
                meta={"spatial": _spatial} if _spatial else None,
            )
    try:
        state = lifecycle.build_state(
            tree=tree, points=points, problem=problem, k=args.k,
            max_batch=args.max_batch, meta=meta,
            id_offset=id_offset,
            max_delta_rows=args.max_delta_rows,
            max_delta_frac=args.max_delta_frac,
            device=args.device,
            read_only=follow_s is not None,
            epoch0=epoch0,
            snapshot_sink=snapshot_sink,
            ladder_enabled=not args.no_ladder,
        )
    except TypeError as e:
        # un-servable checkpoint kind — crisp stderr + exit code
        print(f"cannot serve: {e}", file=sys.stderr)
        sys.exit(1)
    if save_dir:
        # primary bootstrap emit: make the save dir's artifact match the
        # epoch this process serves, so secondaries can start from it at
        # once. Skipped only when this process just loaded the identical
        # content from the same dir.
        from kdtree_tpu_torch import snapshot as snap

        same = (loaded_from_snapshot and snap_dir
                and snap.resolve_dir(snap_dir) == snap.resolve_dir(save_dir))
        if not same or snap.read_manifest(snap.resolve_dir(save_dir)) is None:
            snapshot_sink(state.engine.tree, state.engine.epoch)
            print(f"serving snapshot emitted to "
                  f"{snap.resolve_dir(save_dir)} (epoch "
                  f"{state.engine.epoch}); epoch rebuilds re-emit on "
                  "every swap", file=sys.stderr)
    try:
        httpd = srv.make_server(
            state, host=args.host, port=args.port,
            max_wait_ms=args.max_wait_ms, queue_rows=args.queue_depth,
            debug_faults=args.debug_faults,
            recall_sample=max(args.recall_sample or 0.0, 0.0),
        )
    except srv.FaultSpecError as e:
        # a typo'd KDTREE_TPU_FAULTS must fail the drill at startup
        print(f"bad KDTREE_TPU_FAULTS: {e}", file=sys.stderr)
        sys.exit(1)
    host, port = httpd.server_address[:2]
    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)
    # SIGUSR2 -> atomic flight-recorder dump: the operator's "what is this
    # process doing" button, no restart needed
    if flight.install_signal_handler():
        print("flight recorder armed: kill -USR2 this pid dumps the "
              "recent-event ring", file=sys.stderr)
    print(f"slo engine armed: {len(state.slo_engine.specs)} SLOs over a "
          f"{obs_history.default_period():g}s-period metric-history ring "
          "(GET /debug/history; burn-rate verdicts in /healthz and "
          "kdtree_slo_* on /metrics)", file=sys.stderr)
    thr = state.engine.rebuild_threshold()
    print("mutable index armed: POST /v1/upsert + /v1/delete, epoch "
          "rebuild at backlog >= "
          f"{'disabled' if thr is None else thr} rows", file=sys.stderr)
    if state.ladder_enabled:
        print("degradation ladder armed: exact -> approx(0.99) -> "
              "approx(0.9) -> brute-force-deadline under sustained "
              "burn; per-request recall_target on /v1/knn and the verbs",
              file=sys.stderr)
    print(f"kdtree-tpu-torch serve: binding http://{host}:{port} "
          f"(n={state.engine.tree.n_real}, dim={state.engine.tree.dim}, "
          f"k<={state.engine.k}, device {state.engine.tree.device}); "
          "warming up...", file=sys.stderr)
    try:
        httpd.start()  # returns once the warmup ladder has run
    except Exception:
        # a failed warmup must not leave the non-daemon accept thread
        # holding the process open with /healthz stuck at 503 forever
        httpd.stop()
        raise
    follower = None
    if follow_s is not None:
        # blue/green secondary: poll the snapshot manifest, adopt new
        # versions (load -> pre-warm -> atomic engine swap), report the
        # adopted epoch on /healthz. Started AFTER warmup so the adoption
        # pre-warms exactly the batch shapes serving ran.
        from kdtree_tpu_torch.snapshot import SnapshotFollower

        snap_block = state.meta.setdefault("snapshot", {})

        def _on_adopt(man, _blk=snap_block):
            _blk["version"] = int(man.get("version", 0))
            _blk["epoch"] = int(man.get("epoch", 0))

        follower = SnapshotFollower(
            state.engine, snap_dir, poll_s=follow_s,
            start_version=loaded_version, on_adopt=_on_adopt,
        )
        follower.start()
        print(f"snapshot follower armed: polling {follower.dir} every "
              f"{follower.poll_s:g}s for blue/green epoch swaps "
              "(this replica is read-only — writes 403)",
              file=sys.stderr)
    print(f"ready: POST /v1/knn, GET /healthz, GET /metrics on port "
          f"{port}", file=sys.stderr, flush=True)
    stop.wait()
    print("shutting down: draining in-flight requests...", file=sys.stderr)
    if follower is not None:
        follower.stop()
    httpd.stop()
    print("drained; bye", file=sys.stderr, flush=True)


def cmd_route(args) -> None:
    """Scatter/gather routing over per-shard serve processes: fan each
    request out to the shards, merge per-shard top-k by (distance, id),
    and keep the service available through shard failure — deadlines,
    bounded retry with jittered backoff, p95 hedging, per-shard circuit
    breakers, health ejection, and exact partial-result degradation.
    Host code: it resolves no device."""
    import signal
    import threading

    from kdtree_tpu_torch.obs import flight
    from kdtree_tpu_torch.serve import faults as faults_mod
    from kdtree_tpu_torch.serve import router as rt

    urls = []
    for chunk in args.shard or []:
        urls.extend(u.strip() for u in chunk.split(",") if u.strip())
    if not urls:
        print("route needs at least one --shard http://host:port "
              "(repeat the flag or comma-separate)", file=sys.stderr)
        sys.exit(1)
    # fail a typo'd KDTREE_TPU_FAULTS crisply here too: the router does
    # not inject faults itself, but a drill operator exporting the spec
    # into the wrong process should hear about it
    try:
        faults_mod.from_env()
    except faults_mod.FaultSpecError as e:
        print(f"bad KDTREE_TPU_FAULTS: {e}", file=sys.stderr)
        sys.exit(1)
    try:
        config = rt.RouterConfig(
            deadline_s=args.deadline_ms / 1e3,
            retries=args.retries,
            hedge_min_s=args.hedge_ms / 1e3,
            quorum=args.quorum,
            breaker_failures=args.breaker_failures,
            breaker_reset_s=args.breaker_reset_s,
            health_period_s=args.health_period_s,
            fanout=args.fanout,
            trace_frac=args.trace_frac,
            pool=args.pool,
            pool_max_idle=args.pool_max_idle,
            spec_wave=args.spec_wave,
            parent=args.parent,
        )
        engine = None
        if args.slo:
            from kdtree_tpu_torch.obs import slo as obs_slo

            engine = obs_slo.SloEngine(specs=obs_slo.router_specs())
        httpd = rt.make_router(urls, host=args.host, port=args.port,
                               config=config, slo_engine=engine)
    except ValueError as e:
        print(f"cannot route: {e}", file=sys.stderr)
        sys.exit(1)
    port = httpd.server_address[1]
    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)
    if flight.install_signal_handler():
        print("flight recorder armed: kill -USR2 this pid dumps the "
              "recent-event ring", file=sys.stderr)
    kind = "child router(s)" if config.parent else "shard(s)"
    print(f"kdtree-tpu-torch route: {len(urls)} {kind}, quorum "
          f"{httpd.quorum}, deadline {config.deadline_s * 1e3:g} ms, "
          f"retries {config.retries}, breaker "
          f"{config.breaker_failures}x/{config.breaker_reset_s:g}s, "
          f"pool {'on' if config.pool else 'off'}, spec-wave "
          f"{'on' if config.spec_wave else 'off'}",
          file=sys.stderr)
    httpd.start()
    print(f"ready: routing POST /v1/knn, GET /healthz, GET /metrics on "
          f"port {port}", file=sys.stderr, flush=True)
    stop.wait()
    print("shutting down: draining in-flight scatters...", file=sys.stderr)
    httpd.stop()
    print("drained; bye", file=sys.stderr, flush=True)


def cmd_loadgen(args) -> None:
    """Open-loop load harness: drive a live serve/route process with
    seeded Poisson arrivals at a rate ladder and a query/upsert/delete
    mix, measure latency from INTENDED send times (coordinated omission
    cannot hide queueing), and emit a capacity block — per-step
    quantiles, goodput, shed/degraded fractions, and the knee rate.
    Host code: it resolves no device."""
    import os

    from kdtree_tpu_torch.loadgen import runner as lg_runner
    from kdtree_tpu_torch.loadgen import schedule as lg_schedule
    from kdtree_tpu_torch.obs.export import _capacity_lines

    try:
        rates = [float(x) for x in args.rates.split(",") if x.strip()]
    except ValueError:
        print(f"--rates must be a comma-separated number list, got "
              f"{args.rates!r}", file=sys.stderr)
        sys.exit(1)
    if not rates or any(r <= 0 for r in rates):
        print(f"--rates values must be positive, got {args.rates!r}",
              file=sys.stderr)
        sys.exit(1)
    parsed = []
    for flag, parse, raw in (("--mix", lg_schedule.parse_mix, args.mix),
                             ("--recall-target", lg_schedule.parse_recall_mix,
                              args.recall_target),
                             ("--verb-mix", lg_schedule.parse_verb_mix, args.verb_mix)):
        try:
            parsed.append(parse(raw))
        except ValueError as e:
            print(f"bad {flag}: {e}", file=sys.stderr)
            sys.exit(1)
    mix, recall_mix, verb_mix = parsed
    if round(args.slo_quantile, 4) not in (0.5, 0.95, 0.99):
        # fail BEFORE the sweep runs: the knee must be judged at a
        # quantile the steps actually report, never silently at p99
        print(f"--slo-quantile must be 0.5, 0.95, or 0.99 (the reported "
              f"step quantiles), got {args.slo_quantile}",
              file=sys.stderr)
        sys.exit(1)
    ab_base = None
    if args.ab_baseline:
        # read + validate the baseline BEFORE the sweep runs
        try:
            with open(args.ab_baseline) as f:
                base_rep = json.load(f)
        except (OSError, ValueError) as e:
            print(f"cannot read --ab-baseline {args.ab_baseline}: {e}",
                  file=sys.stderr)
            sys.exit(1)
        base_cap = (base_rep or {}).get("capacity") \
            if isinstance(base_rep, dict) else None
        if not isinstance(base_cap, dict) or "knee_rate" not in base_cap:
            print(f"{args.ab_baseline} is not a loadgen capacity "
                  "report (missing capacity.knee_rate); was it written "
                  "by loadgen --out?", file=sys.stderr)
            sys.exit(1)
        ab_base = base_cap
    try:
        facts = lg_runner.discover(args.target, retries=args.ready_retries)
    except (RuntimeError, ValueError) as e:
        print(f"cannot reach target: {e}", file=sys.stderr)
        sys.exit(1)
    dim = args.dim if args.dim is not None else facts["dim"]
    k = min(args.k, facts["k_max"])
    write_base = (args.write_base if args.write_base is not None
                  else facts["write_base"])
    try:
        sched = lg_schedule.build_schedule(
            rates, args.step_seconds, args.seed, dim, mix=mix,
            regions=args.regions, zipf_s=args.zipf_s, shape=args.shape,
            diurnal_amp=args.diurnal_amp, write_base=write_base,
            recall_mix=recall_mix, verb_mix=verb_mix,
        )
    except ValueError as e:
        print(f"cannot build schedule: {e}", file=sys.stderr)
        sys.exit(1)
    desc = sched.describe()
    print(f"loadgen: target {args.target} (n={facts['n']}, dim={dim}, "
          f"k={k}); {desc['arrivals']} arrivals over "
          f"{sched.duration_s:g}s, mix {desc['ops']}, seed {args.seed}",
          file=sys.stderr)

    def on_step(step, rate):
        print(f"  step {step}: offering {rate:g} req/s for "
              f"{args.step_seconds:g}s", file=sys.stderr)

    report = lg_runner.run_load(
        args.target, sched, k=k, slo_ms=args.slo_ms,
        slo_quantile=args.slo_quantile, max_bad_frac=args.max_bad_frac,
        max_inflight=args.max_inflight, timeout_s=args.timeout_ms / 1e3,
        on_step=on_step, verb_radius=args.verb_radius,
        knee_band=args.knee_band,
    )
    cap = report["capacity"]
    if args.variant:
        cap["variant"] = args.variant
    if ab_base is not None:
        # the A/B block the trend knee-drop rule judges: this run is the
        # CANDIDATE, the embedded knee is the bar it must clear
        base_p99 = next(
            (s.get("p99_ms") for s in ab_base.get("steps") or []
             if isinstance(s, dict)
             and s.get("rate") == ab_base["knee_rate"]), None)
        cap["ab"] = {
            "baseline_file": os.path.basename(args.ab_baseline),
            "baseline_variant": ab_base.get("variant"),
            "baseline_knee_rate": float(ab_base["knee_rate"]),
            "baseline_p99_ms_at_knee": base_p99,
            "knee_delta": round(
                float(cap["knee_rate"]) - float(ab_base["knee_rate"]), 3),
        }
    if args.out:
        tmp = f"{args.out}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, args.out)
        print(f"capacity report written to {args.out}", file=sys.stderr)
    # the telemetry sidecar (--metrics-out) carries the same capacity
    # block, so one artifact is a self-contained trend input
    args._telemetry_extra = {"capacity": cap}
    print("\n".join(_capacity_lines(cap)), file=sys.stderr)
    print(json.dumps({
        "knee_rate": cap["knee_rate"],
        "slo_ms": cap["slo_ms"],
        "steps": len(cap["steps"]),
        "arrivals": desc["arrivals"],
        "out": args.out,
        # the capacity-headroom model's verdict (None when the target
        # exported no cost counters)
        "predicted_rate": (cap.get("predicted") or {}).get("predicted_rate"),
        "predicted_within_band": (cap.get("predicted")
                                  or {}).get("within_band"),
    }))


def _parse_int_list(raw: str | None, what: str):
    """Comma-separated positive ints for the sweep grids."""
    if raw is None:
        return None
    try:
        vals = [int(x) for x in raw.split(",") if x.strip()]
    except ValueError:
        print(f"--{what} must be a comma-separated int list, got {raw!r}",
              file=sys.stderr)
        sys.exit(1)
    if not vals or any(v < 1 for v in vals):
        print(f"--{what} values must be positive, got {raw!r}",
              file=sys.stderr)
        sys.exit(1)
    return vals


def _sweep_problem(args, what: str):
    """The seeded threefry tree and a query sample of another seed
    (measuring on query == point geometry would flatter every plan),
    on the run's device."""
    from kdtree_tpu_torch.ops.generate import (generate_points_rowwise,
                                               generate_queries)
    from kdtree_tpu_torch.ops.morton import build_morton

    if args.generator != "threefry":
        print(f"note: {what} defines its points by the threefry row "
              f"stream; --generator {args.generator} does not apply",
              file=sys.stderr)
    pts = generate_points_rowwise(args.seed, args.dim, args.n, device=args.dev)
    queries = generate_queries(args.seed + 1, args.dim, args.q, device=args.dev)
    return build_morton(pts, device=args.dev), queries


def cmd_tune(args) -> None:
    """Sweep (tile, cmax) candidates of the tiled engine on a query sample
    and persist the winner into the plan store, so every later automatic
    run of the same problem signature starts there (``"warm"``)."""
    from kdtree_tpu_torch import tuning
    from kdtree_tpu_torch.tuning import tuner

    store = tuning.default_store()
    if not store.enabled:
        print("plan store is disabled (KDTREE_TPU_TORCH_PLAN_CACHE is set "
              "to none/off); nothing to persist a winner into",
              file=sys.stderr)
        sys.exit(1)
    tiles = _parse_int_list(args.tiles, "tiles")
    cmaxs = _parse_int_list(args.cmax, "cmax")
    vs = _parse_int_list(args.scan_v, "scan-v")
    tbs = _parse_int_list(args.scan_tb, "scan-tb")
    tree, queries = _sweep_problem(args, "tune")

    def log(row):
        block = ""
        if row.get("v") is not None:
            block = f" v={row['v']:<3d} tb={row['tb']:<5d}"
        print(f"  tile={row['tile']:<5d} cmax={row['cmax']:<5d}{block} "
              f"{row['seconds']*1e3:9.1f} ms  "
              f"{row['qps']:>10.0f} q/s  retries={row['overflow_retries']}",
              file=sys.stderr)

    print(f"sweeping tiled plans: n={args.n} dim={args.dim} q={args.q} "
          f"k={args.k}", file=sys.stderr)
    out = tuner.sweep(tree, queries, k=args.k, tiles=tiles, cmaxs=cmaxs,
                      vs=vs, tbs=tbs, sweep_blocks=not args.no_block_sweep,
                      store=store, log=log)
    if out["persisted"]:
        print(f"persisted winner to {out['path']}", file=sys.stderr)
    elif "reason" in out:
        print(f"warning: nothing persisted — {out['reason']}",
              file=sys.stderr)
    else:
        print("warning: winner could not be persisted (cache dir not "
              "writable?)", file=sys.stderr)
    print(json.dumps({
        "winner": out["winner"],
        "persisted": out["persisted"],
        "path": out["path"],
        "candidates": len(out["results"]) + len(out["block_results"]),
        "block_candidates": len(out["block_results"]),
    }))


def cmd_recall(args) -> None:
    """The recall harness: sweep bounded-visit caps over a seeded problem
    against the exact engine, print the recall@k-vs-speedup curve, and
    persist the measured recall_target -> visit_cap calibration into the
    plan store (unless ``--no-calibrate``)."""
    import os

    from kdtree_tpu_torch import approx, tuning
    from kdtree_tpu_torch.approx.recall import persist_calibration

    caps = _parse_int_list(args.caps, "caps")
    tree, queries = _sweep_problem(args, "recall")
    print(f"recall sweep: n={args.n} dim={args.dim} q={args.q} "
          f"k={args.k} buckets={tree.num_buckets}", file=sys.stderr)

    def log(row):
        print(f"  cap={row['visit_cap']:<6d} recall={row['recall']:.4f} "
              f"{row['qps']:>10.0f} q/s  {row['speedup']:>6.2f}x",
              file=sys.stderr)

    block = approx.sweep_recall(tree, queries, k=args.k, caps=caps, log=log)
    cal = {"recall_caps": {}, "persisted": False, "path": None}
    if not args.no_calibrate:
        cal = persist_calibration(tree, args.q, args.dim, args.k, block,
                                  store=tuning.default_store())
        if cal["persisted"]:
            print(f"calibration persisted to {cal['path']}: "
                  f"{cal['recall_caps']}", file=sys.stderr)
        elif cal["path"] is None:
            print("plan store disabled (KDTREE_TPU_TORCH_PLAN_CACHE=none); "
                  "calibration not persisted", file=sys.stderr)
    if args.out:
        report = {
            "recall_report_version": 1,
            "recall": block,
            "calibration": cal["recall_caps"],
        }
        tmp = f"{args.out}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, args.out)
        print(f"recall report written to {args.out}", file=sys.stderr)
    # the telemetry sidecar carries the same block (like the reference's)
    args._telemetry_extra = {"recall": block}
    print(json.dumps({
        "exact_qps": block["exact_qps"],
        "caps": len(block["curve"]),
        "calibration": cal["recall_caps"],
        "persisted": cal["persisted"],
        "out": args.out,
    }))


def _load_report(path: str) -> dict:
    """Load + validate one --metrics-out telemetry report (shared by
    ``stats`` and ``stats --diff`` so both reject garbage identically)."""
    try:
        with open(path) as f:
            rep = json.load(f)
    except (OSError, ValueError) as e:
        print(f"cannot read telemetry report {path}: {e}", file=sys.stderr)
        sys.exit(1)
    if not isinstance(rep, dict) or "counters" not in rep:
        print(f"{path} is not a kdtree-tpu telemetry report "
              "(missing 'counters'); was it written by --metrics-out?",
              file=sys.stderr)
        sys.exit(1)
    return rep


def cmd_stats(args) -> None:
    """Render a --metrics-out JSON telemetry report human-readably (the
    registry snapshot is machine-first; this is the operator view).
    ``--diff OLD NEW`` renders two reports side-by-side with deltas —
    the bench-regression triage view."""
    from kdtree_tpu_torch.obs import export

    if args.diff:
        if len(args.report) != 2:
            print("stats --diff needs exactly two reports: OLD NEW",
                  file=sys.stderr)
            sys.exit(1)
        old, new = (_load_report(p) for p in args.report)
        sys.stdout.write(export.render_report_diff(old, new))
        return
    if len(args.report) != 1:
        print("stats renders one report (use --diff OLD NEW to compare "
              "two)", file=sys.stderr)
        sys.exit(1)
    sys.stdout.write(export.render_report(_load_report(args.report[0])))


def cmd_profile(args) -> None:
    """Device-timeline profiling: run a representative tiled-query
    workload under a ``torch.profiler`` capture window (every thread, and
    the card on CUDA), join the card's kernel slices back to the host spans
    by time overlap, and report where the card was busy vs waiting — per
    batch dispatch, with dispatch-to-execution lag, time and launches per
    kernel, and any kernel builds that polluted the window. Writes the
    timeline report JSON to --out and renders it human-readably."""
    import os
    import tempfile

    from kdtree_tpu_torch import obs
    from kdtree_tpu_torch.obs import profile as obs_profile
    from kdtree_tpu_torch.obs import timeline as obs_timeline
    from kdtree_tpu_torch.ops.generate import (generate_points_rowwise,
                                               generate_queries)
    from kdtree_tpu_torch.ops.morton import build_morton
    from kdtree_tpu_torch.ops.tile_query import morton_knn_tiled

    trace_dir = args.trace_dir or tempfile.mkdtemp(
        prefix="kdtree-tpu-profile-"
    )
    print(f"profiling: n={args.n} dim={args.dim} q={args.q} k={args.k} "
          f"(trace dir {trace_dir})", file=sys.stderr)
    pts = generate_points_rowwise(args.seed, args.dim, args.n, device=args.dev)
    # a distinct seed for the query sample — profiling query==point
    # geometry would overstate the prune rate (same idiom as tune)
    queries = generate_queries(args.seed + 1, args.dim, args.q,
                               device=args.dev)
    with obs.span("profile.build") as h:
        tree = build_morton(pts, device=args.dev)
        h += [tree]
    if not args.cold:
        # warmup OUTSIDE the window: kernel builds and first-use costs
        # would otherwise dominate the capture (--cold keeps them in)
        d2, ids = morton_knn_tiled(tree, queries, k=args.k)
        obs.hard_sync([d2, ids])
    try:
        with obs_profile.capture(trace_dir, args.dev) as cap:
            with obs.span("profile.query") as h:
                d2, ids = morton_knn_tiled(tree, queries, k=args.k)
                h += [d2, ids]
    except RuntimeError as e:
        print(f"profiler capture failed: {e}", file=sys.stderr)
        sys.exit(1)
    try:
        rep = obs_timeline.analyze_trace_file(cap.trace_file)
    except (OSError, ValueError) as e:
        print(f"cannot parse trace {cap.trace_file}: {e}", file=sys.stderr)
        sys.exit(1)
    rep["workload"] = {
        "seed": args.seed, "dim": args.dim, "n": args.n, "q": args.q,
        "k": args.k, "cold": bool(args.cold),
    }
    tmp = f"{args.out}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rep, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, args.out)
    if args.format == "json":
        print(json.dumps({
            "out": args.out,
            "trace_file": cap.trace_file,
            "correlated_spans": rep["correlated_spans"],
            "device_busy_frac": rep["device"]["busy_frac"],
            "dispatches": rep["dispatches"]["count"],
            "compiles_in_window": rep["compile"]["count"],
        }))
    else:
        sys.stdout.write(obs_timeline.render_timeline(rep))
    print(f"timeline report written to {args.out}; raw trace: "
          f"{cap.trace_file}", file=sys.stderr)


def cmd_trace(args) -> None:
    """Fetch one distributed trace from a live server and render the ASCII
    waterfall: ``--id T`` names the trace, ``--last-slow`` asks the
    target's pinned-trace index for the most recent slow-promoted id. A
    server renders its local spans (a reference router target assembles
    across its shards, ``?assemble=1``). ``--out`` keeps the JSON
    artifact the waterfall was rendered from."""
    import urllib.error
    import urllib.request

    from kdtree_tpu_torch.obs import trace as trace_mod

    base = args.target.rstrip("/")

    def fetch(path: str) -> dict:
        with urllib.request.urlopen(f"{base}{path}",
                                    timeout=args.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    try:
        tid = args.id
        if tid is None:
            idx = fetch("/debug/trace")
            tid = (idx.get("last_promoted") or {}).get("slow")
            if not tid:
                # no slow promotion yet: fall back to the newest pinned
                # trace — an errored/hedged waterfall beats "nothing"
                pinned = idx.get("pinned") or []
                tid = pinned[-1]["trace_id"] if pinned else None
            if not tid:
                print("no promoted traces at the target yet (nothing "
                      "slow/errored/degraded so far)", file=sys.stderr)
                sys.exit(1)
        try:
            payload = fetch(f"/debug/trace/{tid}?assemble=1")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                print(f"no such trace at {base}: {tid} (aged out or "
                      "never recorded)", file=sys.stderr)
                sys.exit(1)
            raise
    except (OSError, ValueError) as e:
        print(f"cannot fetch trace from {base}: {e}", file=sys.stderr)
        sys.exit(1)
    if payload.get("assembled"):
        assembled = payload
    else:
        # a shard target ignores ?assemble=1 and answers its local span
        # list — assemble the single-source forest client-side so the
        # rendering path is one shape
        assembled = trace_mod.assemble(tid, [{
            "source": f"pid{payload.get('pid', '?')}",
            "clock_offset_s": 0.0,
            "spans": payload.get("spans") or [],
            "error": None,
        }])
        assembled["reasons"] = payload.get("reasons", [])
        assembled["pinned"] = payload.get("pinned", False)
    sys.stdout.write(trace_mod.render_waterfall(assembled) + "\n")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(assembled, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
        print(f"trace artifact written to {args.out}", file=sys.stderr)


def _render_cost_report(rep: dict, indent: str = "") -> list:
    """Human lines for one shard's ``/debug/costs`` payload: the
    per-class cost table, the windowed cost-per-query, the headroom
    verdict, and the maintenance (unattributed) spend."""
    lines = []
    classes = rep.get("classes") or []
    if classes:
        lines.append(f"{indent}{'class':<34s}  {'req':>8s}  "
                     f"{'cost/q':>10s}  {'rows':>8s}  {'retries':>7s}  "
                     f"{'bytes out':>10s}")
        for row in classes:
            ck = "/".join((str(row.get("verb", "?")),
                           str(row.get("gear", "?")),
                           str(row.get("outcome", "?"))))
            cm = row.get("cost_ms")
            lines.append(
                f"{indent}{ck:<34s}  {row.get('requests', 0):>8g}  "
                f"{f'{cm:.3f}ms' if cm is not None else '-':>10s}  "
                f"{row.get('rows', 0):>8g}  {row.get('retries', 0):>7g}  "
                f"{row.get('bytes_out', 0):>10g}"
            )
    else:
        lines.append(f"{indent}no answered requests yet")
    window = rep.get("window")
    if isinstance(window, dict):
        lines.append(
            f"{indent}window ({window.get('window_s', 0):g}s): "
            f"{window.get('requests', 0):g} req at "
            f"{window.get('observed_rate', 0):g} req/s, cost/query "
            f"{window.get('cost_per_query_ms', 0):g} ms"
        )
    hr = rep.get("headroom")
    if isinstance(hr, dict):
        if hr.get("data"):
            lines.append(
                f"{indent}headroom: {hr.get('headroom_frac', 0):.1%} "
                f"(observed {hr.get('observed_rate', 0):g} vs predicted "
                f"{hr.get('predicted_rate', 0):g} req/s"
                + (f", busy {hr['busy_frac']:.2f}"
                   if hr.get("busy_frac") is not None else "")
                + ")"
            )
        else:
            lines.append(f"{indent}headroom: no data (no answered "
                         "requests in the window)")
    maint = rep.get("maintenance")
    if isinstance(maint, dict) and any(maint.values()):
        lines.append(
            f"{indent}maintenance: corrections "
            f"{maint.get('correction_ms', 0):g} ms / "
            f"{maint.get('correction_rows', 0):g} rows, writes "
            f"{maint.get('write_ms', 0):g} ms, rebuilds "
            f"{maint.get('rebuilds', 0):g} ({maint.get('rebuild_ms', 0):g}"
            " ms) — device/wall time no request class is charged for"
        )
    return lines


def cmd_costs(args) -> None:
    """Fetch ``/debug/costs`` from a live server and render the
    cost-attribution view: the per-class cost/query table, the windowed
    cost-per-query, and the capacity-headroom verdict (a reference router
    target renders every shard's ledger plus the fleet aggregation).
    ``--json`` emits the raw payload for scripting."""
    import urllib.request

    base = args.target.rstrip("/")
    url = f"{base}/debug/costs?window={args.window_s:g}"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout_s) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
    except (OSError, ValueError) as e:
        print(f"cannot fetch costs from {base}: {e}", file=sys.stderr)
        sys.exit(1)
    if args.json:
        json.dump(payload, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
        return
    lines = []
    if "shards" in payload and "classes" not in payload:
        # router payload: per-shard ledgers + the fleet headroom block
        for ent in payload.get("shards") or []:
            tag = (f"shard {ent.get('shard', '?')}"
                   + (f"/r{ent['replica']}" if ent.get("replica") else "")
                   + f" ({ent.get('url', '?')})")
            if "error" in ent:
                lines.append(f"== {tag}: {ent['error']} ==")
                continue
            lines.append(f"== {tag} ==")
            lines.extend(_render_cost_report(ent.get("costs") or {},
                                             indent="  "))
        fleet = payload.get("headroom") or {}
        lines.append("== fleet ==")
        if fleet.get("data"):
            lines.append(
                f"  headroom: {fleet.get('headroom_frac', 0):.1%} "
                f"(observed {fleet.get('observed_rate', 0):g} vs "
                f"predicted {fleet.get('predicted_rate', 0):g} req/s "
                f"over {fleet.get('shards_reporting', 0)}/"
                f"{fleet.get('shards_total', 0)} shards)"
            )
        else:
            lines.append(
                f"  headroom: no data "
                f"({fleet.get('shards_reporting', 0)}/"
                f"{fleet.get('shards_total', 0)} shards reporting)"
            )
    else:
        lines.extend(_render_cost_report(payload))
    sys.stdout.write("\n".join(lines) + "\n")


def cmd_unported(args) -> None:
    print(f"{args.cmd!r} is not ported to kdtree_tpu_torch yet "
          f"(ROADMAP queue 1 item {UNPORTED_COMMANDS[args.cmd]})",
          file=sys.stderr)
    sys.exit(1)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser (``main`` parses with it)."""
    p = argparse.ArgumentParser(prog="kdtree-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write a one-shot JSON telemetry report (metrics "
                        "registry + spans + the torch runtime's facts) on "
                        "exit; also enables the device-side metrics that "
                        "cost a fetch. Render it with the 'stats' subcommand")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; 'cpu' on request)")
    p.add_argument("--generator", choices=["threefry", "mt19937"], default="mt19937",
                   help="problem generator (mt19937 = bit-exact reference replay)")
    p.add_argument("--engine", choices=ENGINES, default="auto",
                   help="tiled = Morton tree + Hilbert-tiled batched scan (large "
                        "query counts); tree = classic median-split tree; bucket = "
                        "median-split tree with leaf buckets; ensemble = one local "
                        "tree per shard; global = one tree built across the "
                        "shards; global-morton = the scale engine (shard-local "
                        "generation + one all_to_all sample-sort partition); "
                        "global-exact = the exact-median tree (radix-selected "
                        "medians for the top log2 P levels, shard-local below)")
    p.add_argument("--devices", type=int, default=None,
                   help="shard count of the multi-device engines (default: every "
                        "CUDA device; with --device cpu, that many logical shards, "
                        "default 1)")
    sub = p.add_subparsers(dest="cmd", required=True)

    h = sub.add_parser("harness", help="course grading protocol (READY/DONE)")
    h.add_argument("spec", nargs="*", metavar="SEED DIM NUM_POINTS",
                   help="argv mode; omit for interactive stdin mode")
    h.set_defaults(fn=cmd_harness)

    b = sub.add_parser("bench", help="per-phase timing")
    b.add_argument("--seed", type=int, default=42)
    b.add_argument("--dim", type=int, default=3)
    b.add_argument("--n", type=int, default=1 << 20)
    b.add_argument("--k", type=int, default=1)
    b.add_argument("--distribution", choices=["uniform", "clustered"], default="uniform",
                   help="generative row stream for the scale engines (clustered = "
                        "Gaussian-mixture load-imbalance stress)")
    b.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace (Perfetto) of "
                        "the timed run into DIR; the phases appear as named "
                        "ranges")
    b.set_defaults(fn=cmd_bench)

    bu = sub.add_parser("build", help="build a tree and save to npz")
    bu.add_argument("--seed", type=int, default=42)
    bu.add_argument("--dim", type=int, default=3)
    bu.add_argument("--n", type=int, default=1 << 20)
    bu.add_argument("--points", default=None, metavar="FILE",
                    help="build over user data ([N, D] .npy/.npz) instead of a "
                         "seeded problem; with --engine global-morton a '{i}' "
                         "placeholder (e.g. part-{i}.npy) maps pre-sharded files "
                         "onto shards verbatim")
    bu.add_argument("--distribution", choices=["uniform", "clustered"],
                    default="uniform",
                    help="generative row stream for the scale engines")
    bu.add_argument("--slack", type=float, default=None,
                    help="scale-engine exchange capacity factor (the 'capacity "
                         "overflow ... retry with slack > X' errors name this as "
                         "the remedy)")
    bu.add_argument("--out", default=None,
                    help="npz checkpoint path (required unless --save "
                         "is given)")
    bu.add_argument("--save", default=None, metavar="DIR",
                    help="also write a versioned SERVING snapshot "
                         "(checksummed flat .npy segments + manifest) "
                         "that `serve --snapshot DIR` replicas load "
                         "without a build")
    bu.add_argument("--snapshot-keep", type=int, default=1, metavar="N",
                    help="with --save: retain the last N snapshot "
                         "generations (segments refcounted by manifest; "
                         "older generations GC'd) — `serve --snapshot "
                         "DIR --snapshot-version V` rolls back to a "
                         "retained one (default 1)")
    bu.add_argument("--sharded", action="store_true",
                    help="force the per-device shard checkpoint format (forest "
                         "engines auto-shard above 1 GiB)")
    bu.set_defaults(fn=cmd_build)

    pa = sub.add_parser(
        "partition",
        help="spatial partitioner: cut one point cloud into N "
             "contiguous Morton-range shard snapshots (global ids = "
             "morton ranks; each manifest carries the shard's region) "
             "for the router's selective fan-out (docs/SERVING.md "
             "\"Spatial sharding & selective fan-out\")",
    )
    pa.add_argument("--points", default=None, metavar="FILE",
                    help="partition user data ([N, D] .npy/.npz) "
                         "instead of a seeded problem")
    pa.add_argument("--seed", type=int, default=42)
    pa.add_argument("--dim", type=int, default=3)
    pa.add_argument("--n", type=int, default=1 << 20)
    pa.add_argument("--shards", type=int, required=True,
                    help="how many Morton-range shards to cut (>= 2)")
    pa.add_argument("--out-dir", required=True, metavar="DIR",
                    help="output directory: one serving snapshot per "
                         "shard (shard-00/, shard-01/, ...) plus a "
                         "PARTITION.json fleet summary (relative paths "
                         "resolve under KDTREE_TPU_SNAPSHOT_DIR)")
    pa.add_argument("--bits", type=int, default=None,
                    help="Morton quantization bits per axis (default: "
                         "the shared default_bits rule for this D)")
    pa.add_argument("--k", type=int, default=16,
                    help="the k the shard servers will serve at (plan "
                         "keys/profiles in each manifest are computed "
                         "for it)")
    pa.add_argument("--max-batch", type=int, default=1024,
                    help="the serve --max-batch the plan keys cover")
    pa.add_argument("--snapshot-keep", type=int, default=1, metavar="N",
                    help="snapshot generations each shard dir retains")
    pa.set_defaults(fn=cmd_partition)

    q = sub.add_parser("query", help="load a tree and run the 10 protocol queries")
    q.add_argument("--tree", required=True)
    q.add_argument("--seed", type=int, default=None,
                   help="override checkpoint seed (normally read from the npz)")
    q.add_argument("--k", type=int, default=1)
    q.add_argument("--queries", default=None, metavar="FILE",
                   help="user query set ([Q, D] .npy/.npz) instead of the 10 "
                        "protocol queries")
    q.add_argument("--out", default=None, metavar="FILE",
                   help="with --queries: save (d2, ids) npz instead of printing "
                        "protocol lines")
    q.add_argument("--allow-host-materialize", action="store_true",
                   help="load a sharded forest checkpoint onto one device even "
                        "above the budget when fewer devices than its shards "
                        "exist")
    q.set_defaults(fn=cmd_query)

    sv = sub.add_parser(
        "serve",
        help="online k-NN serving: micro-batched POST /v1/knn + writes + "
             "/healthz + Prometheus /metrics (docs/SERVING.md)",
    )
    sv.add_argument("--index", default=None, metavar="FILE",
                    help="serve a checkpoint (a `build --out` npz of a "
                         "Morton tree, or of a classic tree, served "
                         "through its Morton view)")
    sv.add_argument("--points", default=None, metavar="FILE",
                    help="build a Morton index over user data ([N, D] "
                         ".npy/.npz) at startup and serve it")
    sv.add_argument("--seed", type=int, default=42,
                    help="seeded threefry problem (with --dim/--n) when no "
                         "--index/--points is given")
    sv.add_argument("--dim", type=int, default=3)
    sv.add_argument("--n", type=int, default=1 << 20)
    sv.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback; 0.0.0.0 exposes "
                         "the server)")
    sv.add_argument("--port", type=int, default=8080,
                    help="TCP port (0 = ephemeral, printed on stderr)")
    sv.add_argument("--k", type=int, default=16,
                    help="max neighbors per query; batches run at this k "
                         "and per-request k<=K slices the result")
    sv.add_argument("--max-batch", type=int, default=1024,
                    help="micro-batch row cap (rounded up to a power of two)")
    sv.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="how long the batcher holds the first request of "
                         "a batch to coalesce arrivals")
    sv.add_argument("--queue-depth", type=int, default=None, metavar="ROWS",
                    help="admission budget in query rows; beyond it "
                         "requests shed with 429 (default 4x max-batch)")
    sv.add_argument("--id-offset", type=int, default=None, metavar="ROWS",
                    help="sharded serving: this process holds rows "
                         "[offset, offset+n) of a partitioned point set "
                         "and answers GLOBAL ids (local id + offset); "
                         "default 0")
    sv.add_argument("--max-delta-rows", type=int, default=None,
                    metavar="ROWS",
                    help="mutable index: epoch rebuild triggers when the "
                         "write backlog (delta rows + tombstones) reaches "
                         "this many rows (default 4096; <= 0 disables "
                         "this bound)")
    sv.add_argument("--max-delta-frac", type=float, default=None,
                    metavar="FRAC",
                    help="mutable index: epoch rebuild triggers when the "
                         "write backlog reaches this fraction of the "
                         "main tree (default 0.25; <= 0 disables this "
                         "bound; the tighter of the two bounds wins)")
    sv.add_argument("--snapshot", default=None, metavar="DIR",
                    help="load the index from a serving snapshot "
                         "(`build --save` / a primary's epoch emits): "
                         "checksum-verified, mmap-read, one device copy "
                         "per segment — no rebuild. Pairs with --points "
                         "or --snapshot-fallback as the corruption "
                         "fallback")
    sv.add_argument("--snapshot-save", default=None, metavar="DIR",
                    help="shard PRIMARY: emit a snapshot at startup and "
                         "re-emit on every epoch rebuild swap — the "
                         "blue/green artifact secondaries adopt")
    sv.add_argument("--snapshot-follow", type=float, default=None,
                    metavar="SECONDS",
                    help="read SECONDARY: poll --snapshot DIR's manifest "
                         "at this period and blue/green-swap new "
                         "versions in (load -> warm -> atomic engine "
                         "swap; /healthz reports the adopted epoch). "
                         "Implies read-only — writes 403")
    sv.add_argument("--snapshot-fallback", action="store_true",
                    help="on snapshot load failure (checksum/schema), "
                         "rebuild from the seeded --seed/--dim/--n "
                         "problem instead of exiting (--points falls "
                         "back automatically)")
    sv.add_argument("--snapshot-keep", type=int, default=1, metavar="N",
                    help="with --snapshot-save: retain the last N "
                         "snapshot generations across epoch emits "
                         "(rollback-by-version; default 1)")
    sv.add_argument("--snapshot-version", type=int, default=None,
                    metavar="V",
                    help="with --snapshot: load a RETAINED generation V "
                         "instead of the live manifest — the rollback "
                         "button --snapshot-keep enables")
    sv.add_argument("--recall-sample", type=float, default=0.02,
                    metavar="FRAC",
                    help="online recall sampler: re-answer this fraction "
                         "of approximate batches exactly and publish the "
                         "MEASURED served recall (kdtree_recall_sampled, "
                         "which the sampled-recall SLO watches); 0 "
                         "disables (default 0.02)")
    sv.add_argument("--no-ladder", action="store_true",
                    help="disable the degradation ladder (exact -> "
                         "approx(0.99) -> approx(0.9) -> brute-force-"
                         "deadline under sustained SLO burn)")
    sv.add_argument("--debug-faults", action="store_true",
                    help="arm POST /debug/faults (live fault injection) — "
                         "a remote wedge-this-process button, so it is "
                         "opt-in; setting KDTREE_TPU_FAULTS also arms it")
    sv.set_defaults(fn=cmd_serve)

    ro = sub.add_parser(
        "route",
        help="fault-tolerant scatter/gather router over per-shard serve "
             "processes: merged exact top-k, deadlines, retries, "
             "hedging, circuit breakers, partial results "
             "",
    )
    ro.add_argument("--shard", action="append", metavar="URL",
                    help="shard serve process base url (http://host:port); "
                         "repeat the flag or comma-separate. A shard "
                         "entry may be a REPLICA SET — "
                         "'primary|replica1|replica2' — reads "
                         "load-balance across replicas, writes go to "
                         "the first (primary) url "
                         "(docs/SERVING.md \"Snapshots & replica "
                         "fleets\")")
    ro.add_argument("--host", default="127.0.0.1")
    ro.add_argument("--port", type=int, default=8081,
                    help="TCP port (0 = ephemeral, printed on stderr)")
    ro.add_argument("--deadline-ms", type=float, default=2000.0,
                    help="scatter/gather budget per request; a shard "
                         "that cannot answer inside it goes missing, "
                         "never blocking")
    ro.add_argument("--retries", type=int, default=2,
                    help="bounded per-shard retries (jittered exponential "
                         "backoff; shard Retry-After honored)")
    ro.add_argument("--hedge-ms", type=float, default=50.0,
                    help="hedge-delay floor: a second attempt fires when "
                         "a shard call outlives max(its p95, this)")
    ro.add_argument("--quorum", type=int, default=None,
                    help="shards that must answer for a (partial) 200 "
                         "(default: majority)")
    ro.add_argument("--breaker-failures", type=int, default=3,
                    help="consecutive failures that open a shard's "
                         "circuit breaker")
    ro.add_argument("--breaker-reset-s", type=float, default=2.0,
                    help="open-breaker cooldown before the half-open "
                         "probe")
    ro.add_argument("--health-period-s", type=float, default=1.0,
                    help="per-shard /healthz poll period for ejection")
    ro.add_argument("--fanout", choices=["selective", "full"],
                    default="selective",
                    help="selective (default) prunes shards whose "
                         "/healthz bounding box provably cannot hold a "
                         "top-k member (byte-identical answers, fewer "
                         "contacts — docs/SERVING.md \"Spatial "
                         "sharding & selective fan-out\"); full "
                         "restores the contact-every-shard scatter "
                         "(the A/B baseline)")
    ro.add_argument("--trace-frac", type=float, default=0.0,
                    help="head-sampling fraction for distributed "
                         "tracing: deterministically pin this slice of "
                         "BORING requests' traces (tail promotion — "
                         "slow/error/partial/hedged — is always on; "
                         "docs/OBSERVABILITY.md \"Distributed "
                         "tracing\")")
    ro.add_argument("--no-pool", dest="pool", action="store_false",
                    help="open a fresh connection per shard attempt "
                         "instead of pooling keep-alive connections "
                         "(the pooled-vs-fresh A/B baseline — "
                         "docs/SERVING.md \"Scaling the router\")")
    ro.add_argument("--pool-max-idle", type=int, default=8,
                    help="idle keep-alive connections kept per shard "
                         "replica (host, port)")
    ro.add_argument("--no-spec-wave", dest="spec_wave",
                    action="store_false",
                    help="disable speculative overlapped wave 2: wait "
                         "for every wave-1 response before widening "
                         "(answers identical either way; this is the "
                         "latency A/B baseline)")
    ro.add_argument("--no-slo", dest="slo", action="store_false",
                    help="serve without the router SLO ladder: no "
                         "burn-rate pages, no slo block on /healthz — "
                         "so an upstream parent router never ejects "
                         "this router for paging. For benches and "
                         "fleets where paging is handled out-of-band; "
                         "a PAGE is sticky for the burn window, which "
                         "turns a transient overload into minutes of "
                         "ejection")
    ro.add_argument("--parent", action="store_true",
                    help="two-level mode: --shard urls are CHILD "
                         "ROUTERS, not serve shards — prune/scatter/"
                         "merge recurses through them with the same "
                         "exact-merge byte-identity "
                         "(docs/SERVING.md \"Scaling the router\")")
    ro.set_defaults(fn=cmd_route, pool=True, spec_wave=True, slo=True)

    lg = sub.add_parser(
        "loadgen",
        help="open-loop production load harness: seeded Poisson "
             "arrivals at a rate ladder with a query/upsert/delete "
             "mix against a live serve/route process; emits a "
             "capacity block (latency-vs-offered-load curve + knee) "
             "the trend gate diffs",
    )
    lg.add_argument("--target", required=True, metavar="URL",
                    help="base url of a live serve or route process "
                         "(http://host:port)")
    lg.add_argument("--rates", required=True, metavar="R1,R2,...",
                    help="offered-rate ladder in requests/sec, one "
                         "capacity curve point per step")
    lg.add_argument("--step-seconds", type=float, default=10.0,
                    help="how long each ladder step offers its rate")
    lg.add_argument("--mix", default="query:0.9,upsert:0.08,delete:0.02",
                    help="op mix weights (normalized); deletes target "
                         "ids upserted earlier in the schedule")
    lg.add_argument("--seed", type=int, default=42,
                    help="schedule seed: same seed = identical arrival "
                         "times, ops, and payloads")
    lg.add_argument("--recall-target", default=None, metavar="MIX",
                    help="recall dial for the QUERY share of the mix: "
                         "a single target ('0.99'), or a weighted mix "
                         "('exact:0.5,0.99:0.3,0.9:0.2') so capacity "
                         "curves are driven per serving gear; each "
                         "step records the gear distribution it was "
                         "answered at (default: all exact)")
    lg.add_argument("--verb-mix", default=None, metavar="MIX",
                    help="read-verb mix for the QUERY share of the "
                         "schedule ('knn:0.7,radius:0.2,count:0.1'; "
                         "verbs: knn/radius/range/count, weights "
                         "normalized): each query arrival draws its "
                         "verb seeded and response-blind, per-step "
                         "rows and the capacity block gain per-verb "
                         "latency/goodput columns and knees, and "
                         "trend treats runs at differing mixes as "
                         "incommensurable (default: pure knn, "
                         "schedule byte-identical to pre-verb "
                         "loadgen)")
    lg.add_argument("--verb-radius", type=float, default=0.1,
                    help="search radius (and range half-width) non-knn "
                         "verbs carry, in the unit-cube query space — "
                         "pins verb selectivity so runs at the same "
                         "mix measure the same work")
    lg.add_argument("--k", type=int, default=4,
                    help="neighbors per query (clamped to the target's "
                         "k_max)")
    lg.add_argument("--shape", choices=["steps", "diurnal"],
                    default="steps",
                    help="steps = flat rate per rung; diurnal = "
                         "sinusoidally modulated within each rung "
                         "(Lewis-Shedler thinning, still seeded)")
    lg.add_argument("--diurnal-amp", type=float, default=0.3,
                    help="diurnal modulation amplitude in [0, 1)")
    lg.add_argument("--regions", type=int, default=64,
                    help="spatial regions the Zipf query skew draws "
                         "over")
    lg.add_argument("--zipf-s", type=float, default=1.1,
                    help="Zipf exponent of the region skew (higher = "
                         "hotter hot spots)")
    lg.add_argument("--slo-ms", type=float, default=250.0,
                    help="latency SLO bound the knee is judged against "
                         "(matches the serving request-p99 SLO)")
    lg.add_argument("--slo-quantile", type=float, default=0.99,
                    help="which intended-latency quantile must meet "
                         "--slo-ms (0.5/0.95/0.99)")
    lg.add_argument("--max-bad-frac", type=float, default=0.05,
                    help="max (shed+error+timeout)/sent fraction a "
                         "step may have and still count toward the "
                         "knee")
    lg.add_argument("--max-inflight", type=int, default=64,
                    help="client worker pool size; arrivals beyond it "
                         "queue client-side but latency is measured "
                         "from INTENDED send time either way")
    lg.add_argument("--timeout-ms", type=float, default=10000.0,
                    help="per-request client timeout")
    lg.add_argument("--dim", type=int, default=None,
                    help="query dimensionality (default: discovered "
                         "from the target's /healthz)")
    lg.add_argument("--write-base", type=int, default=None,
                    help="first id upserts mint (default: past the "
                         "target's served id range, from /healthz)")
    lg.add_argument("--ready-retries", type=int, default=60,
                    help="how many times to poll /healthz for "
                         "readiness before giving up")
    lg.add_argument("--out", default="loadgen_report.json",
                    metavar="FILE",
                    help="standalone capacity report artifact (a "
                         "trend input); '' disables")
    lg.add_argument("--variant", default=None,
                    help="label for this arm of an A/B (e.g. 'pooled', "
                         "'fresh', 'hier'); recorded in the capacity "
                         "block")
    lg.add_argument("--ab-baseline", default=None, metavar="FILE",
                    help="a previous loadgen report to A/B against: "
                         "embeds its knee in this report's "
                         "capacity.ab block, and the trend knee-drop "
                         "rule fails any run whose knee is not "
                         "strictly better than its baseline")
    lg.add_argument("--knee-band", type=float, default=0.5,
                    help="relative band the cost ledger's predicted "
                         "sustainable rate must land within of the "
                         "measured knee (the capacity.predicted "
                         "within_band verdict)")
    lg.set_defaults(fn=cmd_loadgen)

    tu = sub.add_parser(
        "tune",
        help="sweep (tile, cmax) candidates for the tiled engine and "
             "persist the winner to the plan store",
    )
    tu.add_argument("--seed", type=int, default=42)
    tu.add_argument("--dim", type=int, default=3)
    tu.add_argument("--n", type=int, default=1 << 20,
                    help="point count of the seeded problem to tune on")
    tu.add_argument("--q", type=int, default=16384,
                    help="query-sample size — plans are keyed by the "
                         "quantized Q bucket, so tune at the Q you serve")
    tu.add_argument("--k", type=int, default=16)
    tu.add_argument("--tiles", default=None, metavar="T1,T2,...",
                    help="candidate tile sizes (default 64..1024 pow2)")
    tu.add_argument("--cmax", default=None, metavar="C1,C2,...",
                    help="candidate candidate-bucket caps (default "
                         "32..256 pow2)")
    tu.add_argument("--scan-v", default=None, metavar="V1,V2,...",
                    help="candidate fold-chunk widths (buckets per scan "
                         "chunk) for the block-shape phase (default 1,8)")
    tu.add_argument("--scan-tb", default=None, metavar="T1,T2,...",
                    help="candidate tiles-per-scan-block for the "
                         "block-shape phase (default 1,4,32)")
    tu.add_argument("--no-block-sweep", action="store_true",
                    help="skip the block-shape phase (sweep only the "
                         "(tile, cmax) launch grid)")
    tu.set_defaults(fn=cmd_tune)

    rc = sub.add_parser(
        "recall",
        help="recall harness: sweep bounded-visit caps against the exact "
             "engine, print the recall@k-vs-speedup curve, and persist "
             "the recall_target -> visit_cap calibration to the plan store",
    )
    rc.add_argument("--seed", type=int, default=42)
    rc.add_argument("--dim", type=int, default=3)
    rc.add_argument("--n", type=int, default=1 << 20,
                    help="point count of the seeded problem to measure")
    rc.add_argument("--q", type=int, default=16384,
                    help="query-sample size; the calibration persists "
                         "for every serve batch bucket up to this Q")
    rc.add_argument("--k", type=int, default=16)
    rc.add_argument("--caps", default=None, metavar="C1,C2,...",
                    help="visit caps to sweep (default: powers of two "
                         "up to the bucket count; the full-cap point "
                         "pins recall 1.0)")
    rc.add_argument("--no-calibrate", action="store_true",
                    help="measure only; do not persist the "
                         "recall_target -> visit_cap table")
    rc.add_argument("--out", default="recall_report.json", metavar="FILE",
                    help="standalone recall report artifact; '' disables")
    rc.set_defaults(fn=cmd_recall)

    st = sub.add_parser(
        "stats", help="render a --metrics-out telemetry report "
                      "(--diff OLD NEW compares two)"
    )
    st.add_argument("report", nargs="+", metavar="REPORT.json",
                    help="path a previous run's --metrics-out wrote "
                         "(two paths with --diff)")
    st.add_argument("--diff", action="store_true",
                    help="render two reports side-by-side with deltas "
                         "(spans, counters, compile counts) — the "
                         "bench-regression triage view")
    st.set_defaults(fn=cmd_stats)

    pr = sub.add_parser(
        "profile",
        help="device-timeline profiling: capture a torch.profiler trace "
             "of a tiled-query workload and report device busy/idle per "
             "batch dispatch and time and launches per kernel",
    )
    pr.add_argument("--seed", type=int, default=42)
    pr.add_argument("--dim", type=int, default=3)
    pr.add_argument("--n", type=int, default=1 << 16,
                    help="point count of the seeded problem to profile")
    pr.add_argument("--q", type=int, default=1 << 13,
                    help="query-batch size (the dense tiled shape)")
    pr.add_argument("--k", type=int, default=8)
    pr.add_argument("--cold", action="store_true",
                    help="skip the warmup run so the capture includes "
                         "kernel builds and first-use costs (default: "
                         "profile steady state)")
    pr.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="where the raw profiler trace lands (default: a "
                         "temp dir, path printed on stderr); open it in "
                         "Perfetto for the full picture")
    pr.add_argument("--out", default="timeline.json", metavar="FILE",
                    help="timeline report JSON artifact")
    pr.add_argument("--format", choices=["human", "json"], default="human",
                    help="stdout format (the JSON artifact is always "
                         "written to --out)")
    pr.set_defaults(fn=cmd_profile)

    tw = sub.add_parser(
        "trace",
        help="fetch a distributed trace from a live server and render "
             "the ASCII waterfall; writes the JSON artifact with --out",
    )
    tw.add_argument("--target", default="http://127.0.0.1:8080",
                    metavar="URL",
                    help="server base url (its local spans; a reference "
                         "router target assembles across its shards)")
    tw_which = tw.add_mutually_exclusive_group(required=True)
    tw_which.add_argument("--id", default=None, metavar="TRACE_ID",
                          help="trace id to fetch (a request's "
                               "trace_id / X-Request-Id)")
    tw_which.add_argument("--last-slow", action="store_true",
                          help="render the target's most recently "
                               "slow-promoted trace (falls back to "
                               "the newest pinned one)")
    tw.add_argument("--out", default=None, metavar="PATH",
                    help="also write the assembled trace JSON here")
    tw.add_argument("--timeout-s", type=float, default=5.0,
                    help="per-fetch HTTP timeout")
    tw.set_defaults(fn=cmd_trace)

    co = sub.add_parser(
        "costs",
        help="fetch /debug/costs from a live server and render "
             "per-class cost/query + the capacity-headroom verdict",
    )
    co.add_argument("--target", default="http://127.0.0.1:8080",
                    metavar="URL",
                    help="server base url (one ledger; a reference "
                         "router answers per-shard ledgers + the fleet "
                         "aggregation)")
    co.add_argument("--window-s", type=float, default=60.0,
                    help="history window the cost-per-query and "
                         "headroom verdicts are computed over")
    co.add_argument("--json", action="store_true",
                    help="emit the raw /debug/costs payload instead of "
                         "the rendered table")
    co.add_argument("--timeout-s", type=float, default=5.0,
                    help="HTTP timeout")
    co.set_defaults(fn=cmd_costs)

    for name, item in UNPORTED_COMMANDS.items():
        un = sub.add_parser(name, help=f"not ported yet (ROADMAP queue 1 "
                                       f"item {item})", add_help=False)
        un.set_defaults(fn=cmd_unported)
    return p


def main(argv=None) -> None:
    p = build_parser()
    # an unported subcommand takes the reference's arguments: name its item
    # whatever they are
    args, extra = p.parse_known_args(argv)
    if extra and args.cmd not in UNPORTED_COMMANDS:
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd == "harness" and args.spec and len(args.spec) != 3:
        print(f"Usage: {p.prog} harness SEED DIM_POINTS  NUM_POINTS", file=sys.stderr)
        sys.exit(1)
    if args.cmd in ("stats", "trace", "costs", *UNPORTED_COMMANDS):
        # host-only paths: no device, no telemetry framing
        args.fn(args)
        return
    from kdtree_tpu_torch import obs

    if args.cmd in ("route", "loadgen"):
        # host code: no device is resolved, so these never open a CUDA
        # context; a --metrics-out report carries the registry and spans
        # but not the runtime's facts (reading those would open one)
        if args.metrics_out:
            obs.configure(metrics_out=args.metrics_out, install_runtime=False)
        try:
            args.fn(args)
        finally:
            if args.metrics_out:
                try:
                    obs.finalize(extra=getattr(args, "_telemetry_extra", None))
                except OSError as e:
                    print(f"cannot write telemetry report {args.metrics_out}: "
                          f"{e}", file=sys.stderr)
        return
    from kdtree_tpu_torch import resolve_device
    from kdtree_tpu_torch.ops.morton import BuildCapacityError

    try:
        args.dev = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e).replace("device='cpu'", "--device cpu"), file=sys.stderr)
        sys.exit(1)
    if args.metrics_out:
        obs.configure(metrics_out=args.metrics_out, device=args.dev)
    try:
        args.fn(args)
    except BuildCapacityError as e:
        # the device-memory guard of the build: crisp stderr + exit code
        print(str(e), file=sys.stderr)
        sys.exit(1)
    finally:
        # write the report even on failed exits — a degraded run's
        # telemetry is the part worth keeping — and never let a failed
        # WRITE replace the run's own exit
        if args.metrics_out:
            try:
                obs.finalize(extra=getattr(args, "_telemetry_extra", None))
            except OSError as e:
                print(f"cannot write telemetry report {args.metrics_out}: "
                      f"{e}", file=sys.stderr)


if __name__ == "__main__":
    main()
