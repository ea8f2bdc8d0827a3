"""Time the port's fused exact k-NN (``kernels/knn_scan.py::knn_scan``) of
one or more checkouts side by side on one CUDA card.

    python3 scripts/torch_knn_scan_bench.py [--tree LABEL=DIR ...] [--rounds N] [--out FILE]

Each ``--tree`` is a checkout of the repository (``.`` by default) whose
own ``kdtree_tpu_torch`` is timed through its public ``knn_scan(points,
queries, k)``, in a process of its own: the trees' kernels all build at
once first, then each tree is timed in turn, ``--rounds`` times over in
alternating order (A B B A ...), so that two trees are compared only
within one run on one card. The timers and the Morton order are this
checkout's ``chip_smoke.py`` ones (``cuda_ms``: ms a call through the
wrapper; ``graph_ms``: a launch in a CUDA graph; ``morton_sorted``). The
shapes, k = 16, uniform points over [-100, 100)^D:

- 8, 64, 1,000 and 1,024 rows over 2^24 x 3-D, in random order, in the
  port's Morton order (phase 3c's timed shapes) and as bucket storage in
  Morton order with a +inf pad every 256 rows (the tree's storage that
  phase 4's fallback batch scans);
- at D = 8, 32 and 47, 1,000 rows over 20,011 points (phase 3c's) and 256
  rows over 2^19 points (phase 9a's oracle sample), in random order;
- the CLI's one-shot run: 10 rows over 2^24 points at D = 8 and 16, k = 1;
- 8, 64 and 1,000 rows over 2^19 x 8-D bucket storage in Morton order
  with a +inf pad every 256 rows (``morton_sorted(rows, 256)``), and the
  same rows in random order.

Each tree checks itself bit for bit against its ``knn_scan_plain`` first
(64 rows over 2^24 x 3-D in both orders, and every shape at D != 3). Each
shape also records the share of (warp, stage) pairs the kernel's cull
skipped (``culled``; None where the call examined none). The script
prints one JSON line per timed run, the card's name and power limit, and,
with ``--out``, writes them to a file.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
K = 16
SEED = 11
ROWS3 = (8, 64, 1000, 1024)
N3 = 1 << 24
# D != 3: (D, points, rows, k, order)
WIDE = ([(d, n, q, K, "random") for d in (8, 32, 47) for n, q in ((20011, 1000), (1 << 19, 256))]
        + [(d, 1 << 24, 10, 1, "random") for d in (8, 16)]
        + [(8, 1 << 19, q, K, order) for q in (8, 64, 1000) for order in ("morton", "random")])
BUCKET = 256


def _smoke():
    spec = importlib.util.spec_from_file_location("knn_bench_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(label, build_only):
    import numpy as np
    import torch

    from kdtree_tpu_torch.kernels import _build

    _build.build(["scan_knn", "knn_scan"])
    if build_only:
        return
    from kdtree_tpu_torch.kernels import knn_scan as ks

    smoke = _smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def rows(n, d):
        return torch.from_numpy(rng.uniform(-100, 100, (n, d)).astype(np.float32)).to(dev)

    def check(what, p, q, k=K):
        got, want = ks.knn_scan(p, q, k), ks.knn_scan_plain(p, q, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            f"{label}: knn_scan != knn_scan_plain at {what}"

    def timed(p, q, k=K):
        rec = {"ms": smoke.cuda_ms(lambda: ks.knn_scan(p, q, k), 5),
               "graph_ms": smoke.graph_ms(lambda: ks.knn_scan(p, q, k), 3, 3)}
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        ks.knn_scan(p, q, k, counts=counts)
        culled, seen = counts.tolist()
        rec["culled"] = culled / seen if seen else None
        return rec

    pts = rows(N3, 3)
    orders = (("random", pts), ("morton", smoke.morton_sorted(pts)),
              ("buckets", smoke.morton_sorted(pts, BUCKET)))
    queries = {q: rows(q, 3) for q in ROWS3}
    shapes = {}
    for name, p in orders:
        check(f"64 rows in {name} order", p, queries[64])
        for q in ROWS3:
            shapes[f"D=3 N={N3} Q={q} {name}"] = timed(p, queries[q])
    del pts, orders
    for d, n, q, k, order in WIDE:
        p, qs = rows(n, d), rows(q, d)
        if order == "morton":
            p = smoke.morton_sorted(p, BUCKET)
        check(f"D={d} N={n} Q={q} k={k} {order}", p, qs, k)
        shapes[f"D={d} N={n} Q={q} k={k} {order}"] = timed(p, qs, k)
        del p, qs
    print("RESULT " + json.dumps({"label": label, "shapes": shapes}), flush=True)


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "runs": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
