"""Classify XLA:CPU's vector lanes in the reference's vmapped DFS engines.

For each D and lane count, runs ``kdtree_tpu.knn`` (the classic DFS) or
``kdtree_tpu.bucket_knn`` (the bucket DFS) on 3,000 uniform points at
k=16, and the port's engine twice, forced to round every lane's squares
(the vector form) and to fuse them all (the scalar FMA chain). Each answer
row is marked ``v`` (only the vector form matches), ``s`` (only the chain
matches), ``b`` (both) or ``x`` (neither); a row string is a prefix of
``v``/``b`` followed by ``s``/``b``. Rows where
``kdtree_tpu_torch.ops._arith.xla_cpu_vector_rows`` disagrees are listed
at the end. Slow (one reference compile per lane count):

    JAX_PLATFORMS=cpu python scripts/torch_vector_lanes.py classic 1-8 1-128
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import kdtree_tpu as kt
from kdtree_tpu_torch.ops import _arith
from kdtree_tpu_torch.ops import bucket as tbk
from kdtree_tpu_torch.ops import build as tb
from kdtree_tpu_torch.ops import query as tq


def _span(arg):
    lo, _, hi = arg.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def _uniform(n, d, seed):
    return np.random.default_rng(seed).uniform(-100, 100, (n, d)).astype(np.float32)


def main(engine, dims, lanes):
    torch.set_num_threads(1)
    rule = _arith.xla_cpu_vector_rows
    wrong = []
    for d in dims:
        p = _uniform(3000, d, 11)
        if engine == "classic":
            jt, tt = kt.build_jit(jnp.asarray(p)), tb.build_jit(p, device="cpu")
            ref = lambda q: kt.knn(jt, jnp.asarray(q), k=16)  # noqa: E731
            port = lambda q: tq.knn(tt, torch.from_numpy(q), k=16)  # noqa: E731
        else:
            jt = kt.build_bucket(jnp.asarray(p), bucket_cap=8)
            tt = tbk.build_bucket(p, bucket_cap=8, device="cpu")
            ref = lambda q: kt.bucket_knn(jt, jnp.asarray(q), k=16)  # noqa: E731
            port = lambda q: tbk.bucket_knn(tt, torch.from_numpy(q), k=16)  # noqa: E731
        for rows in lanes:
            jax.clear_caches()  # one compile per lane count; keep memory flat
            q = _uniform(rows, d, 12 + rows)
            jd, ji = (np.asarray(a) for a in ref(q))
            forms = []
            for body in (lambda r, dim: r, lambda r, dim: 0):
                _arith.xla_cpu_vector_rows = body
                try:
                    forms.append([a.numpy() for a in port(q)])
                finally:
                    _arith.xla_cpu_vector_rows = rule
            marks = ""
            for i in range(rows):
                v, s = ((f[0][i].view(np.int32) == jd[i].view(np.int32)).all()
                        and (f[1][i] == ji[i]).all() for f in forms)
                marks += "b" if v and s else "v" if v else "s" if s else "x"
            vec = [i for i, m in enumerate(marks) if m == "v"]
            tail = [i for i, m in enumerate(marks) if m == "s"]
            lo, hi = (max(vec) + 1 if vec else 0), (min(tail) if tail else rows)
            print(d, rows, marks, flush=True)
            if "x" in marks or not lo <= rule(rows, d) <= hi:
                wrong.append((d, rows, lo, hi, rule(rows, d)))
    print("disagreements (D, lanes, vector lanes from, to, rule):", wrong)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], _span(sys.argv[2]), _span(sys.argv[3])))
