"""Split a plain verb fold's device time by its ``record_function`` ranges
in two ways, on one CUDA card, to show why ``obs/timeline.py`` attributes
a range's device time by launch and not by Kineto's device-side windows.

    python3 scripts/torch_timeline_ranges.py [--repeats N] [--out FILE]

On ``chip_smoke.py``'s phase 4 tree (2^24 x 3-D, B=256) and its 1,000
verb rows, each repeat runs the plain range fold (and, on the first
repeat, the plain radius fold) at m below the largest count, as phase 4b
does, in a capture window of ``obs.profile``. For each capture it prints
the window's device busy time; the sum of the ``verbs.fold.*`` ranges as
``obs.timeline`` reports them (each slice in the ranges that hold its
launch call); the same sum from the ``gpu_user_annotation`` windows (the
union of the slices inside each name's windows); and how many pairs of
neighbouring windows of different names overlap. Then the card's name and
power limit. ``--out`` writes the records as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def window_split(trace: dict, merged) -> tuple:
    """({name: ms} from the ``gpu_user_annotation`` windows of the
    ``verbs.fold.*`` ranges, overlapping neighbour pairs of two names)."""
    from kdtree_tpu_torch.obs import timeline

    ann = sorted((e for e in trace["traceEvents"]
                  if e.get("cat") == "gpu_user_annotation" and "ts" in e
                  and e.get("name", "").startswith("verbs.fold.")), key=lambda e: e["ts"])
    ends = [e for _, e in merged]
    by = {}
    for e in ann:
        by.setdefault(e["name"], []).append(timeline._iv(e))
    split = {name: sum(timeline._overlap(merged, ends, s, t) for s, t in timeline._merge(iv)) / 1e3
             for name, iv in by.items()}
    over = sum(1 for a, b in zip(ann, ann[1:])
               if a["name"] != b["name"] and b["ts"] < a["ts"] + a.get("dur", 0.0))
    return split, over


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from kdtree_tpu_torch.kernels import _build
    from kdtree_tpu_torch.kernels import verb_fold as vf
    from kdtree_tpu_torch.obs import profile, timeline
    from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
    from kdtree_tpu_torch.ops.morton import build_morton
    from kdtree_tpu_torch.verbs import device as vd

    dev = torch.device("cuda")
    _build.build()
    tree = build_morton(generate_points_rowwise(cs.SEED, cs.DIM, cs.N_POINTS, device=dev),
                        bucket_cap=cs.BUCKET)
    q = generate_queries(cs.SEED + 950, cs.DIM, cs.MAX_BATCH + 1, device=dev).cpu().numpy()[:1000]
    half = np.float32(cs.VERB_SIDE / 2)
    recs = []
    for i, verb in enumerate(["radius"] + ["range"] * args.repeats):
        with cs.fold_calls() as seen:
            if verb == "range":
                vd.range_search(tree, q - half, q + half)
            else:
                vd.radius_search(tree, q, cs.VERB_R)
        t_, a, b, cand, m = seen[verb][-1]
        plain = vf._radius_fold_plain if verb == "radius" else vf._range_fold_plain
        small = max(1, int(plain(t_, a, b, cand, 0)[0].max()) // 2)
        with tempfile.TemporaryDirectory() as log_dir:
            with profile.capture(log_dir, dev) as cap:
                plain(t_, a, b, cand, small)
                torch.cuda.synchronize()
            trace = timeline.load_trace(cap.trace_file)
        rep = timeline.parse_timeline(trace)
        merged = timeline._merge([timeline._iv(e) for e in trace["traceEvents"]
                                  if e.get("cat") in timeline.EXEC_CATEGORIES and "ts" in e])
        windows, over = window_split(trace, merged)
        ranges = {k: v["busy_us"] / 1e3 for k, v in rep["device"]["ranges"].items()
                  if k.startswith("verbs.fold.")}
        rec = {"verb": verb, "m": small, "device_ms": rep["device"]["busy_us"] / 1e3,
               "launch_ms": ranges, "launch_sum_ms": sum(ranges.values()),
               "window_ms": windows, "window_sum_ms": sum(windows.values()),
               "overlapping_windows": over}
        recs.append(rec)
        print(f"{i}: plain {verb} fold, 1000 rows, m={small}: device {rec['device_ms']:.3f} ms; "
              f"ranges by launch {rec['launch_sum_ms']:.3f} ms "
              f"({rec['launch_sum_ms'] / rec['device_ms']:.4f} of it); by device-side window "
              f"{rec['window_sum_ms']:.3f} ms ({rec['window_sum_ms'] / rec['device_ms']:.4f}), "
              f"{over} overlapping window pairs", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if args.out:
        Path(args.out).write_text(json.dumps({"card": smi, "captures": recs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
