"""The port's CLI (``kdtree_tpu_torch.utils.cli``) against the reference's
(``kdtree_tpu.utils.cli``), both driven in process through ``main()``:
stdout byte-identical and the same exit code in every case. Also Morton
checkpoints across packages in both directions, the dense ``query
--queries`` route to the tiled engine, crisp exits for what is not
ported, and the two golden grading outputs through the port's harness."""

import contextlib
import io
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu.utils import checkpoint as jckpt
from kdtree_tpu.utils import cli as jcli
from kdtree_tpu_torch import native
from kdtree_tpu_torch.utils import checkpoint as tckpt
from kdtree_tpu_torch.utils import cli as tcli

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
needs_native = pytest.mark.skipif(
    not native.available(), reason="no g++ toolchain for the mt19937 generator")


def _run(main, argv, stdin=None):
    """(exit code, stdout, stderr) of one in-process ``main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    code = 0
    saved = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    finally:
        sys.stdin = saved
    return code, out.getvalue(), err.getvalue()


def _ref(argv, stdin=None):
    return _run(jcli.main, ["--platform", "cpu", *argv], stdin)


def _port(argv, stdin=None):
    return _run(tcli.main, ["--device", "cpu", *argv], stdin)


def _both(argv, stdin=None):
    r, t = _ref(argv, stdin), _port(argv, stdin)
    assert t[0] == r[0], (r[2][-800:], t[2][-800:])
    assert t[1] == r[1]
    return r, t


@pytest.mark.parametrize("engine", ["auto", "morton", "tiled", "bruteforce"])
@pytest.mark.parametrize("generator", [
    "threefry", pytest.param("mt19937", marks=needs_native)])
def test_harness_argv_mode(engine, generator):
    _, (code, out, _) = _both(["--generator", generator, "--engine", engine,
                               "harness", "42", "3", "20000"])
    assert code == 0 and out.startswith("READY\n") and out.endswith("DONE\n")
    assert out.count("DISTANCE: ") == 10


@pytest.mark.parametrize("generator", [
    "threefry", pytest.param("mt19937", marks=needs_native)])
def test_harness_interactive_mode(generator, monkeypatch):
    # the interactive problem size, cut down in both modules alike
    for mod in (jcli, tcli):
        monkeypatch.setattr(mod, "HARNESS_DIM", 8)
        monkeypatch.setattr(mod, "HARNESS_NUM_POINTS", 3000)
    _both(["--generator", generator, "harness"], stdin="7\n")
    _, (code, out, err) = _both(["--generator", generator, "harness"], stdin="seven\n")
    assert code == 0 and "using default seed 0" in err and "ID: 3000 \t" in out


@pytest.mark.parametrize("spec", [["-1", "3", "100"], ["1", "0", "100"], ["1", "3", "0"],
                                  ["0", "3", "100"], ["1", "2"], ["a", "3", "100"]])
def test_validation_errors(spec):
    (rcode, _, rerr), (tcode, _, terr) = _both(["--generator", "threefry", "harness", *spec])
    assert tcode == (0 if spec[0] == "0" else 1)
    for msg in ("Warning: default value 0", "has to be larger", "Usage:", "Invalid problem"):
        assert (msg in rerr) == (msg in terr)


def test_resolve_engine_grid():
    for engine in ("auto", "morton", "tiled", "bruteforce"):
        for dim in (1, 3, 6, 7, 16, 17, 128):
            for q in (None, 10, 511, 512, 4096, 1 << 20):
                for n in (None, 1000, 1 << 15, 1 << 20, 1 << 24, 1 << 30):
                    assert tcli._resolve_engine(engine, dim, q, n) == \
                        jcli._resolve_engine(engine, dim, q, n), (engine, dim, q, n)


def test_build_out_then_query(tmp_path):
    ref, port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    r = _ref(["--generator", "threefry", "build", "--seed", "3", "--n", "5000", "--out", ref])
    t = _port(["--generator", "threefry", "build", "--seed", "3", "--n", "5000", "--out", port])
    assert r[0] == t[0] == 0 and r[1].replace(ref, port) == t[1]
    r, t = _ref(["query", "--tree", ref]), _port(["query", "--tree", port])
    assert r[0] == t[0] == 0 and r[1] == t[1] and t[1].endswith("DONE\n")
    # the query path's seed comes from the checkpoint, with a note
    r, t = _ref(["query", "--tree", ref, "--seed", "9"]), _port(["query", "--tree", port,
                                                                 "--seed", "9"])
    assert r[1] == t[1] and "using checkpoint seed 3" in t[2]


def _same_tree(jt, tt):
    for name in ("node_lo", "node_hi", "bucket_pts", "bucket_gid"):
        a, b = np.asarray(getattr(jt, name)), getattr(tt, name).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (jt.n_real, jt.num_levels) == (tt.n_real, tt.num_levels)


def test_checkpoints_cross_load(tmp_path):
    ref, port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    assert _ref(["--generator", "threefry", "build", "--seed", "4", "--n", "3000",
                 "--dim", "5", "--out", ref])[0] == 0
    assert _port(["--generator", "threefry", "build", "--seed", "4", "--n", "3000",
                  "--dim", "5", "--out", port])[0] == 0
    jt, jmeta = jckpt.load_tree(port)  # the port's file in the reference
    tt, tmeta = tckpt.load_tree(ref, device="cpu")  # and the other way
    _same_tree(jt, tt)
    assert jmeta == tmeta == {"seed": 4, "generator": "threefry"}
    jt2, _ = jckpt.load_tree(ref)
    tt2, _ = tckpt.load_tree(port, device="cpu")
    _same_tree(jt2, tt2)
    # the port's save of a loaded tree writes the reference's arrays back
    tckpt.save_tree(str(tmp_path / "again.npz"), tt, meta=tmeta)
    with np.load(ref) as a, np.load(tmp_path / "again.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def test_checkpoint_corrupt_or_unported_exits_crisply(tmp_path):
    good = str(tmp_path / "t.npz")
    assert _port(["--generator", "threefry", "build", "--n", "2000", "--out", good])[0] == 0
    with np.load(good) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["child_2"] = arrays["child_2"].copy()
    arrays["child_2"][0, 0, 0] = np.nan
    np.savez(tmp_path / "nan.npz", **arrays)
    code, _, err = _port(["query", "--tree", str(tmp_path / "nan.npz")])
    assert code == 1 and "NaN" in err and "corrupt" in err
    from kdtree_tpu.ops.bucket import build_bucket

    pts = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    jckpt.save_tree(str(tmp_path / "bucket.npz"), build_bucket(jnp.asarray(pts)))
    code, _, err = _port(["query", "--tree", str(tmp_path / "bucket.npz")])
    assert code == 1 and "'bucket'" in err and "item 16" in err
    code, _, err = _port(["query", "--tree", str(tmp_path / "missing.npz")])
    assert code == 1 and "cannot load tree" in err


def test_query_dense_file_goes_tiled(tmp_path, monkeypatch):
    ref, port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    for run, path in ((_ref, ref), (_port, port)):
        assert run(["--generator", "threefry", "build", "--seed", "5", "--n", "20000",
                    "--out", path])[0] == 0
    qfile = tmp_path / "q.npy"
    np.save(qfile, np.random.default_rng(5).uniform(-100, 100, (600, 3)).astype(np.float32))
    from kdtree_tpu_torch.ops import tile_query

    calls = []
    real = tile_query.morton_knn_tiled
    monkeypatch.setattr(tile_query, "morton_knn_tiled",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    r = _ref(["query", "--tree", ref, "--queries", str(qfile), "--k", "8",
              "--out", str(tmp_path / "r_out.npz")])
    t = _port(["query", "--tree", port, "--queries", str(qfile), "--k", "8",
               "--out", str(tmp_path / "t_out.npz")])
    assert r[0] == t[0] == 0 and calls == [1]
    assert t[1] == f"saved d2[600, 8] + ids to {tmp_path / 't_out.npz'}\n"
    with np.load(tmp_path / "r_out.npz") as a, np.load(tmp_path / "t_out.npz") as b:
        for key in ("d2", "ids"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    # a sparse file takes the per-query DFS; protocol lines without --out
    np.save(qfile, np.load(qfile)[:20])
    r = _ref(["query", "--tree", ref, "--queries", str(qfile)])
    t = _port(["query", "--tree", port, "--queries", str(qfile)])
    assert r[0] == t[0] == 0 and r[1] == t[1] and calls == [1]


@pytest.mark.parametrize("argv, item", [
    (["--engine", "tree", "harness", "1", "3", "100"], "item 16"),
    (["--engine", "global-morton", "bench", "--n", "100"], "item 17"),
    (["--engine", "bucket", "build", "--out", "x.npz"], "item 16"),
    (["--engine", "ensemble", "harness", "1", "3", "100"], "item 17"),
])
def test_unported_engine_exits_crisply(argv, item):
    code, out, err = _port(argv)
    assert code == 1 and out == "" and item in err


def test_default_device_without_cuda_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out, err = _run(tcli.main, ["harness", "1", "3", "100"])
    assert code == 1 and out == "" and "--device cpu" in err


def test_bench_json_line():
    argv = ["--generator", "threefry", "--engine", "morton", "bench", "--n", "4096",
            "--dim", "3", "--k", "2"]
    r, t = _ref(argv), _port(argv)
    assert r[0] == t[0] == 0
    rj, tj = json.loads(r[1]), json.loads(t[1])
    assert t[1].count("\n") == 1 and sorted(rj) == sorted(tj)
    for key in ("n", "dim", "k", "engine"):
        assert rj[key] == tj[key]
    assert tj["platform"] == "cpu" and tj["pts_per_sec"] > 0
    assert set(tj) >= {"generate", "build", "query", "total"}


@needs_native
@pytest.mark.parametrize("seed", [7, 42])
def test_golden_harness(seed):
    """The grading configuration (interactive, 128-D, 500k points, mt19937)
    through the port: byte-identical to the reference program's capture."""
    code, out, _ = _port(["harness"], stdin=f"{seed}\n")
    assert code == 0
    assert out == (GOLDEN / f"ref_seed{seed}_128d_500k.txt").read_text()


def _start_serve(argv):
    """A ``python -m kdtree_tpu_torch serve`` child and its port, read from
    the ready line on stderr."""
    import os
    import subprocess

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    proc = subprocess.Popen([sys.executable, "-m", "kdtree_tpu_torch", *argv],
                            cwd=str(repo), env=env, stderr=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, text=True)
    lines = []
    for line in proc.stderr:
        lines.append(line)
        if line.startswith("ready:"):
            return proc, int(line.rsplit(" ", 1)[1]), lines
    proc.wait(timeout=60)
    raise AssertionError(f"serve exited {proc.returncode}: {''.join(lines)}")


def test_serve_subprocess_answers_like_the_reference_and_drains():
    import signal
    import urllib.request

    from kdtree_tpu.ops.generate import generate_points_rowwise
    from kdtree_tpu.ops.morton import build_morton
    from kdtree_tpu.serve.lifecycle import ServeEngine

    proc, port, lines = _start_serve(["--device", "cpu", "serve", "--seed", "42", "--dim",
                                      "3", "--n", "4000", "--k", "4", "--max-batch", "8",
                                      "--port", "0"])
    try:
        q = np.random.default_rng(3).uniform(-100, 100, (3, 3)).astype(np.float32)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/knn",
                                     data=json.dumps({"queries": q.tolist(), "k": 3}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        ref = ServeEngine(build_morton(generate_points_rowwise(42, 3, 4000)), 4)
        d2, ids, _ = ref.knn_batch(np.concatenate([q, np.repeat(q[-1:], 5, 0)]))
        assert got["ids"] == ids[:3, :3].tolist()
        assert got["distances"] == np.sqrt(d2[:3, :3].astype(np.float64)).tolist()
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, "".join(lines) + rest
    assert "drained; bye" in rest and "mutable index armed" in "".join(lines)


@pytest.mark.parametrize("flags, code", [
    (["--snapshot", "snapdir"], 2), (["--recall-sample", "0.1"], 2), (["--no-ladder"], 2),
    (["--index", "a.npz", "--points", "b.npy"], 1), (["--index", "missing.npz"], 1),
])
def test_serve_flags_not_ported_or_conflicting(flags, code):
    c, out, err = _port(["serve", "--port", "0", *flags])
    assert c == code and out == ""
    assert ("unrecognized arguments" in err) == (code == 2)
