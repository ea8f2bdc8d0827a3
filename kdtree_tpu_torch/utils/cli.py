"""Command-line interface of the port: the one-shot subcommands and the
online server.

The port of ``kdtree_tpu/utils/cli.py``'s ``harness``, ``bench``, ``build``,
``query`` and ``serve``, for the ``auto``, ``morton``, ``tiled`` and
``bruteforce`` engines and the ``threefry`` and ``mt19937`` generators.
Output bytes and exit codes are the reference's:

- ``harness``: the course grading protocol — ``READY`` on stdout, seed
  from stdin (interactive; dim=128, n=500000) or ``SEED DIM NUM_POINTS``
  argv mode, result lines ``ID: <id> \\t DISTANCE: <d>``, then ``DONE``;
- ``bench``: per-phase timing (generate, build, query) after a warm-up
  run on another seed, as one JSON line;
- ``build`` / ``query``: build and save / load and query (npz
  checkpoint, readable by both packages);
- ``serve``: the long-lived HTTP server (``serve/server.py``) over a
  Morton checkpoint, a points file or the seeded threefry problem, until
  SIGTERM/SIGINT drains it.

Everything runs on the CUDA device unless ``--device cpu`` asks for the
CPU. ``auto`` picks an engine by the reference's crossovers
(:func:`_resolve_engine`). The reference's other engines exit with code
1 and name the ROADMAP item that brings them; its other subcommands and
flags are not here yet.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from kdtree_tpu_torch.ops.tile_query import dense_lowd
from kdtree_tpu_torch.utils.checkpoint import UNPORTED_ENGINES

NUM_QUERIES = 10  # the reference program's fixed query count
HARNESS_DIM = 128
HARNESS_NUM_POINTS = 500000
AUTO_TREE_DIM_MAX = 16

ENGINES = ("auto", "morton", "tiled", "bruteforce")


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


def _build_index(points, engine: str):
    """Build phase: the index object for an engine."""
    if engine in ("morton", "tiled"):
        from kdtree_tpu_torch.ops.morton import build_morton

        return build_morton(points)
    if engine == "bruteforce":
        return points  # the index IS the point array
    raise SystemExit(f"engine {engine!r} has no split build phase")


def _query_index(index, queries, k: int, engine: str):
    """Query phase against the object _build_index returned."""
    if engine == "morton":
        from kdtree_tpu_torch.ops.morton import morton_knn

        return morton_knn(index, queries, k=k)
    if engine == "tiled":
        from kdtree_tpu_torch.ops.tile_query import morton_knn_tiled

        return morton_knn_tiled(index, queries, k=k)
    if engine == "bruteforce":
        from kdtree_tpu_torch.ops import bruteforce

        return bruteforce.knn(index, queries, k=k)
    raise SystemExit(f"engine {engine!r} has no split query phase")


def _solve(points, queries, k: int, engine: str):
    """Returns (d2[Q,k], idx[Q,k]) by the chosen engine."""
    engine = _resolve_engine(engine, queries.shape[1], q=queries.shape[0], n=points.shape[0])
    return _query_index(_build_index(points, engine), queries, k, engine)


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
    points, queries, _ = _generate(seed, dim, num_points, args.generator, args.dev)
    d2, _ = _solve(points, queries, k=1, engine=engine)
    dists = np.sqrt(d2[:, 0].cpu().numpy().astype(np.float64))
    for q in range(NUM_QUERIES):
        # query ids are num_points + q, as in the reference program
        print_result_line(num_points + q, float(dists[q]))
    print("DONE", flush=True)


def cmd_bench(args) -> None:
    from kdtree_tpu_torch.utils.timing import PhaseTimer

    engine = _resolve_engine(args.engine, args.dim, q=NUM_QUERIES, n=args.n)

    def run(seed: int, timer: PhaseTimer | None):
        t = timer or PhaseTimer()
        with t.phase("generate") as h:
            points, queries, _ = _generate(seed, args.dim, args.n, args.generator, args.dev)
            h += [points, queries]
        with t.phase("build") as h:
            index = _build_index(points, engine)
            h += [index]
        with t.phase("query") as h:
            d2, idx = _query_index(index, queries, args.k, engine)
            h += [d2, idx]
        return d2

    dev = args.dev
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    # warm-up on a distinct seed (kernel builds, allocator growth), excluded
    # from timing; the timed run uses fresh inputs
    run(args.seed + 1000, None).cpu()

    timer = PhaseTimer()
    run(args.seed, timer)
    rep = timer.report()
    # pts/s excludes generation
    solve_s = rep["total"] - rep["generate"]
    rep.update(
        n=args.n, dim=args.dim, k=args.k, engine=engine,
        pts_per_sec=(args.n / solve_s) if solve_s > 0 else None,
        platform=dev.type, device_count=count,
    )
    print(json.dumps(rep))


def _build_tree_for_engine(points, engine: str):
    """The tree to checkpoint for an engine choice: ``auto``, ``morton``
    and ``tiled`` share the Morton tree (tiled is a query strategy, not an
    index)."""
    if engine in ("auto", "morton", "tiled"):
        from kdtree_tpu_torch.ops.morton import build_morton

        return build_morton(points)
    raise SystemExit(f"engine {engine!r} does not produce a checkpointable tree")


def _tree_knn(tree, queries, k: int):
    """k-NN on a loaded Morton tree: dense low-D batches take the tiled
    engine (the same crossover as :func:`_resolve_engine`), the rest the
    per-query DFS."""
    q, dim = queries.shape
    if dense_lowd(q, tree.n_real, dim):
        from kdtree_tpu_torch.ops.tile_query import morton_knn_tiled

        return morton_knn_tiled(tree, queries, k=k)
    from kdtree_tpu_torch.ops.morton import morton_knn

    return morton_knn(tree, queries, k=k)


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


def cmd_build(args) -> None:
    from kdtree_tpu_torch.utils.checkpoint import save_tree

    if not args.out:
        print("build needs --out FILE (npz checkpoint)", file=sys.stderr)
        sys.exit(1)
    if args.points:
        # user data, not a seeded problem
        points = torch.from_numpy(_load_array(args.points, "points")).to(args.dev)
        meta = {"generator": "file"}
    else:
        points, _, gen_used = _generate(args.seed, args.dim, args.n, args.generator, args.dev)
        meta = {"seed": args.seed, "generator": gen_used}
    tree = _build_tree_for_engine(points, args.engine)
    n, dim = points.shape
    save_tree(args.out, tree, meta=meta)
    print(f"saved {type(tree).__name__} (n={n}, dim={dim}) to {args.out}")


def cmd_query(args) -> None:
    import zipfile

    from kdtree_tpu_torch.utils.checkpoint import load_tree

    try:
        tree, meta = load_tree(args.tree, device=args.dev)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        print(f"cannot load tree {args.tree}: {e}", file=sys.stderr)
        sys.exit(1)
    n = tree.n_real
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
    """Long-lived online k-NN serving: micro-batched ``POST /v1/knn``, the
    write path, ``GET /healthz`` readiness and the Prometheus ``GET
    /metrics``. The snapshot flags, ``--recall-sample`` and ``--no-ladder``
    of the reference are not here yet (ROADMAP items 10 and 12)."""
    import signal
    import threading
    import zipfile

    from kdtree_tpu_torch.obs import flight
    from kdtree_tpu_torch.obs import history as obs_history
    from kdtree_tpu_torch.serve import engine as lifecycle
    from kdtree_tpu_torch.serve import server as srv

    if args.index and args.points:
        print("serve needs ONE index source: --index, --points, or the "
              "seeded --seed/--dim/--n problem", file=sys.stderr)
        sys.exit(1)
    tree = points = problem = None
    if args.index:
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
    try:
        state = lifecycle.build_state(
            tree=tree, points=points, problem=problem, k=args.k,
            max_batch=args.max_batch, meta=meta,
            id_offset=args.id_offset or 0,
            max_delta_rows=args.max_delta_rows,
            max_delta_frac=args.max_delta_frac,
            device=args.device,
        )
    except TypeError as e:
        # un-servable checkpoint kind — crisp stderr + exit code
        print(f"cannot serve: {e}", file=sys.stderr)
        sys.exit(1)
    try:
        httpd = srv.make_server(
            state, host=args.host, port=args.port,
            max_wait_ms=args.max_wait_ms, queue_rows=args.queue_depth,
            debug_faults=args.debug_faults,
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
    print(f"ready: POST /v1/knn, GET /healthz, GET /metrics on port "
          f"{port}", file=sys.stderr, flush=True)
    stop.wait()
    print("shutting down: draining in-flight requests...", file=sys.stderr)
    httpd.stop()
    print("drained; bye", file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser (``main`` parses with it)."""
    p = argparse.ArgumentParser(prog="kdtree-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; 'cpu' on request)")
    p.add_argument("--generator", choices=["threefry", "mt19937"], default="mt19937",
                   help="problem generator (mt19937 = bit-exact reference replay)")
    p.add_argument("--engine", choices=[*ENGINES, *UNPORTED_ENGINES], default="auto",
                   help="tiled = Morton tree + Hilbert-tiled batched scan (large "
                        "query counts); the engines not ported yet exit with the "
                        "ROADMAP item that brings them")
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
    b.set_defaults(fn=cmd_bench)

    bu = sub.add_parser("build", help="build a tree and save to npz")
    bu.add_argument("--seed", type=int, default=42)
    bu.add_argument("--dim", type=int, default=3)
    bu.add_argument("--n", type=int, default=1 << 20)
    bu.add_argument("--points", default=None, metavar="FILE",
                    help="build over user data ([N, D] .npy/.npz) instead of a "
                         "seeded problem")
    bu.add_argument("--out", default=None, help="npz checkpoint path")
    bu.set_defaults(fn=cmd_build)

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
    q.set_defaults(fn=cmd_query)

    sv = sub.add_parser(
        "serve",
        help="online k-NN serving: micro-batched POST /v1/knn + writes + "
             "/healthz + Prometheus /metrics (docs/SERVING.md)",
    )
    sv.add_argument("--index", default=None, metavar="FILE",
                    help="serve a checkpoint (a `build --out` npz of a "
                         "Morton tree)")
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
    sv.add_argument("--debug-faults", action="store_true",
                    help="arm POST /debug/faults (live fault injection) — "
                         "a remote wedge-this-process button, so it is "
                         "opt-in; setting KDTREE_TPU_FAULTS also arms it")
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> None:
    p = build_parser()
    args = p.parse_args(argv)
    if args.cmd == "harness" and args.spec and len(args.spec) != 3:
        print(f"Usage: {p.prog} harness SEED DIM_POINTS  NUM_POINTS", file=sys.stderr)
        sys.exit(1)
    if args.cmd != "query" and args.engine in UNPORTED_ENGINES:
        print(f"engine {args.engine!r} is not ported to kdtree_tpu_torch yet "
              f"(ROADMAP queue 1 item {UNPORTED_ENGINES[args.engine]})", file=sys.stderr)
        sys.exit(1)
    from kdtree_tpu_torch import resolve_device
    from kdtree_tpu_torch.ops.morton import BuildCapacityError

    try:
        args.dev = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e).replace("device='cpu'", "--device cpu"), file=sys.stderr)
        sys.exit(1)
    try:
        args.fn(args)
    except BuildCapacityError as e:
        # the device-memory guard of the build: crisp stderr + exit code
        print(str(e), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
