"""Time the port's Morton DFS engine (``ops/morton.py::morton_knn``) of one
or more checkouts side by side on one CUDA card.

    python3 scripts/torch_dfs_bench.py [--tree LABEL=DIR ...] [--rounds N] [--out FILE]

Each ``--tree`` is a checkout of the repository (``.`` by default) whose
own ``kdtree_tpu_torch`` is timed through its public entry points, in a
process of its own: the trees' kernels all build at once first, then each
tree is timed in turn, ``--rounds`` times over in alternating order (A B B
A ...), so that two trees are compared only within one run on one card.
Host seconds around work that ends in a fetch of the answer, as the CLI
times it:

- ``cli bench --engine morton --n 2^24 --dim 3`` in process (mt19937, 10
  queries at k=1 after a warm-up on another seed): the JSON's phases;
- the headline's query alone: ``morton_knn`` of 10 queries at k=1 on the
  2^24 x 3-D tree of ``generate_problem(1)`` (B=256), the least of 5 fresh
  query sets after a warm-up;
- the sparse-DFS lane: 65,536 queries at k=16 on the 2^24 tree of
  ``generate_points_rowwise(42)`` (B=256), after a warm-up on other
  queries;
- the scale lane's shard: 10 queries at k=1 on the 2^26 x 3-D tree of
  ``generate_points_rowwise(2)`` (B=128), the least of 3 after a warm-up.

Each run also prints a sha256 of the sparse lane's and the shard's answers
(d2 and ids); the script fails unless every tree's digests agree, so the
trees are held bit for bit against each other at full size. It prints one
JSON line per timed run, the card's name and power limit, and, with
``--out``, writes them to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

N = 1 << 24
SCALE_N = 1 << 26
SPARSE_Q = 1 << 16


def worker(label, build_only):
    import torch

    from kdtree_tpu_torch.kernels import _build

    _build.build()
    if build_only:
        return
    from kdtree_tpu_torch.ops.generate import (
        generate_points_rowwise, generate_problem, generate_queries,
    )
    from kdtree_tpu_torch.ops.morton import build_morton, morton_knn
    from kdtree_tpu_torch.utils import cli

    dev = torch.device("cuda")
    shapes, digests = {}, {}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d2, ids = fn()
        d2[:1].cpu()
        return time.perf_counter() - t0, (d2, ids)

    def digest(ans):
        h = hashlib.sha256()
        for x in ans:
            h.update(x.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(["--engine", "morton", "bench", "--n", str(N), "--dim", "3"])
    except SystemExit as e:
        if e.code not in (0, None):
            raise
    shapes["cli bench --engine morton"] = json.loads(out.getvalue().strip().splitlines()[-1])

    pts, qs = generate_problem(1, 3, N, 10, device=dev)
    tree = build_morton(pts, bucket_cap=256)
    del pts
    wall(lambda: morton_knn(tree, qs, k=1))
    fresh = [generate_queries(100 + s, 3, 10, device=dev) for s in range(5)]
    runs = [wall(lambda: morton_knn(tree, q, k=1))[0] for q in fresh]
    shapes["headline query, 10 x 1-NN over 2^24"] = {"s": min(runs), "runs": runs}

    tree = build_morton(generate_points_rowwise(42, 3, N, device=dev), bucket_cap=256)
    wall(lambda: morton_knn(tree, generate_queries(54, 3, SPARSE_Q, device=dev), k=16))
    qs = generate_queries(55, 3, SPARSE_Q, device=dev)
    s, ans = wall(lambda: morton_knn(tree, qs, k=16))
    shapes["sparse lane, 65,536 x 16-NN over 2^24"] = {"s": s}
    digests["sparse"] = digest(ans)
    del tree
    torch.cuda.empty_cache()

    tree = build_morton(generate_points_rowwise(2, 3, SCALE_N, device=dev), bucket_cap=128)
    q10 = generate_queries(77, 3, 10, device=dev)
    wall(lambda: morton_knn(tree, q10, k=1))
    runs, ans = [], None
    for _ in range(3):
        s, ans = wall(lambda: morton_knn(tree, q10, k=1))
        runs.append(s)
    shapes["scale shard, 10 x 1-NN over 2^26 (B=128)"] = {"s": min(runs), "runs": runs}
    digests["scale"] = digest(ans)
    print("RESULT " + json.dumps({"label": label, "shapes": shapes, "digests": digests}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="LABEL=DIR of a checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.build_only)
        return 0

    trees = []
    for spec in args.tree or ["this=."]:
        label, _, path = spec.partition("=")
        trees.append((label, Path(path).resolve()))

    def spawn(label, root, build_only):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", label]
        return subprocess.Popen(cmd + (["--build-only"] if build_only else []), cwd=root,
                                env=dict(os.environ, PYTHONPATH=str(root)),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    t0 = time.perf_counter()
    builds = [(label, spawn(label, root, True)) for label, root in trees]
    failed = []
    for label, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            failed.append(label)
    if failed:
        raise SystemExit(f"build failed: {', '.join(failed)}")
    print(f"built {len(trees)} tree(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    results = []
    for r in range(args.rounds):
        for label, root in trees if r % 2 == 0 else trees[::-1]:
            log, _ = spawn(label, root, False).communicate()
            lines = [x[7:] for x in log.splitlines() if x.startswith("RESULT ")]
            if not lines:
                print(log)
                raise SystemExit(f"{label}: timing run failed")
            print(lines[0], flush=True)
            results.append(json.loads(lines[0]))
    if len({json.dumps(r["digests"], sort_keys=True) for r in results}) != 1:
        raise SystemExit("the trees' answers differ: "
                         + "; ".join(f"{r['label']} {r['digests']}" for r in results))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"answers bit-equal across the trees {results[0]['digests']}")
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "runs": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
