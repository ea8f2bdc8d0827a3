"""Split the Morton DFS kernel's time by its clock64() stamps, for one or
more checkouts on one CUDA card.

    python3 scripts/torch_dfs_stamps.py [--tree LABEL=DIR ...]

For each ``--tree`` (a checkout; ``.`` by default), in a process of its
own: the kernel's per-query clock64() sums at the headline's shape (10 x
1-NN over the 2^24 x 3-D tree of ``generate_problem(1)``, B=256) and at the
sparse lane's first 4,096 queries (k=16 on the 2^24 tree of
``generate_points_rowwise(42)``), each in the layout the checkout's wrapper
picks. A checkout whose wrapper takes ``stamps=`` (PR 20 on) is measured
through it: walk, scan, select, merge, and the walk's window loads. An
older checkout (PR 19's one-warp kernel) is measured through a copy of its
``csrc/morton_dfs.cu`` with stamps written in, built beside it under
``_build/``: walk (its child-box loads apart), scan, fold and merge, with
the counts of expansions, pops, insertions and rounds. Each prints the
mean query's and the slowest query's cycles and shares, the kernel's ms
over 10 launches (CUDA events) and the clock the slowest query implies,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

# PR 19's source, stamped: (text, replacement) in order
_STAMPS = [
    ("  long long Q;\n", "  long long Q;\n  long long* stamps;  // [Q, 10]\n"),
    ("  unsigned long long n_box = 0, n_pairs = 0;\n",
     "  unsigned long long n_box = 0, n_pairs = 0;\n  long long t_walk = 0, t_exp = 0, "
     "t_scan = 0, t_fold = 0, t_merge = 0, n_exp = 0, n_pop = 0, n_ins = 0, n_round = 0;\n"
     "  const long long t_start = clock64();\n"),
    ("    int nb = 0;\n    while (sp > 0 && nb < kV) {\n",
     "    int nb = 0;\n    long long tw0 = clock64();\n    while (sp > 0 && nb < kV) {\n"
     "      ++n_pop;\n"),
    ("      float bd = 0.f;\n      if (lane < 2) {",
     "      long long te0 = clock64();\n      ++n_exp;\n      float bd = 0.f;\n"
     "      if (lane < 2) {"),
    ("      const bool swap = bd0 < bd1;  // push the nearer child last\n",
     "      const bool swap = bd0 < bd1;  // push the nearer child last\n"
     "      t_exp += clock64() - te0;\n"),
    ("    if (nb == 0) continue;\n",
     "    t_walk += clock64() - tw0;\n    if (nb == 0) continue;\n    ++n_round;\n"),
    ("    for (int base = 0; base < total; base += 32 * kU) {\n      float cd[kU];",
     "    for (int base = 0; base < total; base += 32 * kU) {\n      long long ts0 = clock64();\n"
     "      float cd[kU];"),
    ("#pragma unroll\n      for (int u = 0; u < kU; ++u) {\n        unsigned m = __ballot_sync(",
     "      {\n        float acc = 0.f;\n#pragma unroll\n"
     "        for (int u = 0; u < kU; ++u) acc += cd[u] + cid[u];\n"
     "        if (__float_as_int(__shfl_sync(kFull, acc, 0)) == 0x7fc01234) cd[0] = 0.f;\n"
     "      }\n      long long tf0 = clock64();\n      t_scan += tf0 - ts0;\n#pragma unroll\n"
     "      for (int u = 0; u < kU; ++u) {\n        unsigned m = __ballot_sync("),
    ("          s = n;\n          if (s == k) smax = sd[k - 1];\n        }\n      }\n    }\n",
     "          s = n;\n          ++n_ins;\n          if (s == k) smax = sd[k - 1];\n        }\n"
     "      }\n      t_fold += clock64() - tf0;\n    }\n"),
    ("    // merge the selection into the k-list by (d2, id)\n",
     "    long long tm0 = clock64();\n    // merge the selection into the k-list by (d2, id)\n"),
    ("    worst = kd[k - 1];\n  }\n", "    worst = kd[k - 1];\n    t_merge += clock64() - tm0;\n  }\n"),
    ("  if (a.work && lane == 0) {",
     "  if (lane == 0 && a.stamps) {\n    long long* o = a.stamps + qi * 10;\n"
     "    o[0] = clock64() - t_start; o[1] = t_walk; o[2] = t_exp; o[3] = t_scan;\n"
     "    o[4] = t_fold; o[5] = t_merge; o[6] = n_exp; o[7] = n_pop; o[8] = n_ins;\n"
     "    o[9] = n_round;\n  }\n  if (a.work && lane == 0) {"),
    ("void* scr_i, void* node_seen, void* bucket_seen, void* work,",
     "void* scr_i, void* node_seen, void* bucket_seen, void* work, void* stamps,"),
    ("  a.Q = Q;\n", "  a.Q = Q;\n  a.stamps = static_cast<long long*>(stamps);\n"),
]
OLD_COLS = ("total", "walk", "child boxes", "scan", "fold", "merge", "expansions", "pops",
            "insertions", "rounds")


def _old_kernel(root: Path):
    """PR 19's kernel with stamps: (launch(tree, q, k, stamps), columns)."""
    import torch

    from kdtree_tpu_torch.kernels import _build

    src = (root / "kdtree_tpu_torch/csrc/morton_dfs.cu").read_text()
    for a, b in _STAMPS:
        if a not in src:
            raise SystemExit(f"{root}: not PR 19's source ({a.strip()[:40]!r})")
        src = src.replace(a, b, 1)
    out = root / "kdtree_tpu_torch/_build"
    out.mkdir(parents=True, exist_ok=True)
    (out / "morton_dfs_stamps.cu").write_text(src)
    (out / "d2.cuh").write_text((root / "kdtree_tpu_torch/csrc/d2.cuh").read_text())
    so = out / "libmorton_dfs_stamps.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(out / "morton_dfs_stamps.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).morton_dfs_launch
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(tree, q, k, stamps):
        Q, D = q.shape
        nb, B, _ = tree.bucket_pts.shape
        d = torch.empty((Q, k), dtype=torch.float32, device=q.device)
        i = torch.empty((Q, k), dtype=torch.int32, device=q.device)
        err = fn(q.data_ptr(), tree.node_lo.data_ptr(), tree.node_hi.data_ptr(),
                 tree.bucket_pts.data_ptr(), tree.bucket_gid.data_ptr(), d.data_ptr(),
                 i.data_ptr(), None, None, None, None, None,
                 None if stamps is None else stamps.data_ptr(), Q, D, B, k, nb,
                 tree.node_lo.shape[0], torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return d, i

    return launch, OLD_COLS


def worker(label):
    import numpy as np
    import torch

    import kdtree_tpu_torch.kernels.morton_dfs as md
    from kdtree_tpu_torch.ops.generate import (
        generate_points_rowwise, generate_problem, generate_queries,
    )
    from kdtree_tpu_torch.ops.morton import build_morton

    dev = torch.device("cuda")
    if "stamps" in md.morton_dfs.__code__.co_varnames:
        cols = md.STAMP_COLS

        def launch(tree, q, k, stamps):
            return md.morton_dfs(tree, q, k, stamps=stamps)
    else:
        launch, cols = _old_kernel(Path.cwd())
    out = {}

    def case(name, tree, q, k):
        want = md.morton_dfs(tree, q, k)
        st = torch.zeros((q.shape[0], len(cols)), dtype=torch.int64, device=dev)
        got = launch(tree, q, k, st)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
        for _ in range(3):
            launch(tree, q, k, None)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            launch(tree, q, k, None)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / 10
        s = st.cpu().numpy().astype(np.float64)
        slow = s[int(np.argmax(s[:, 0]))]
        out[name] = {"ms": ms, "ghz_implied": slow[0] / (ms * 1e-3) / 1e9,
                     "mean": dict(zip(cols, s.mean(0).round(1).tolist())),
                     "slowest": dict(zip(cols, slow.tolist()))}

    pts, qs = generate_problem(1, 3, 1 << 24, 10, device=dev)
    case("headline, 10 x 1-NN over 2^24", build_morton(pts, bucket_cap=256), qs, 1)
    del pts
    tree = build_morton(generate_points_rowwise(42, 3, 1 << 24, device=dev), bucket_cap=256)
    qs = generate_queries(55, 3, 1 << 16, device=dev)[:4096].contiguous()
    case("sparse lane's first 4,096 at k=16", tree, qs, 16)
    print("RESULT " + json.dumps({"label": label, "cases": out}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="LABEL=DIR of a checkout")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker)
        return 0
    for spec in args.tree or ["this=."]:
        label, _, path = spec.partition("=")
        root = Path(path).resolve()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", label],
                              cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
                              capture_output=True, text=True)
        lines = [x[7:] for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise SystemExit(f"{label}: the stamped run failed")
        print(lines[0], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
