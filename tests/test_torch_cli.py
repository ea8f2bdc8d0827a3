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

import numpy as np
import pytest
import torch

from kdtree_tpu.utils import checkpoint as jckpt
from kdtree_tpu.utils import cli as jcli
from kdtree_tpu_torch import native
from kdtree_tpu_torch.utils import checkpoint as tckpt
from kdtree_tpu_torch.utils import cli as tcli
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

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


@pytest.mark.parametrize("engine", ["auto", "morton", "tiled", "tree", "bucket",
                                    "bruteforce"])
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


@pytest.mark.parametrize("engine", ["tree", "bucket"])
def test_classic_build_out_then_query(engine, tmp_path):
    """``build --out`` with a classic or bucketed tree, then ``query``:
    the protocol lines, a sparse ``--queries`` file (the tree's own DFS)
    and a dense one (the tiled engine over the tree's Morton view), each
    the reference's bytes, across the two packages' checkpoints."""
    ref, port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    argv = ["--generator", "threefry", "--engine", engine, "build", "--seed", "6",
            "--n", "20000"]
    r, t = _ref([*argv, "--out", ref]), _port([*argv, "--out", port])
    kind = "KDTree" if engine == "tree" else "BucketKDTree"
    assert r[0] == t[0] == 0 and r[1].replace(ref, port) == t[1] and kind in t[1]
    with np.load(ref) as a, np.load(port) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    r, t = _ref(["query", "--tree", ref]), _port(["query", "--tree", port])
    assert r[0] == t[0] == 0 and r[1] == t[1] and t[1].endswith("DONE\n")
    qfile = tmp_path / "q.npy"
    rng = np.random.default_rng(6)
    for rows in (20, 600):  # sparse: the DFS; dense: the Morton view, tiled
        np.save(qfile, rng.uniform(-100, 100, (rows, 3)).astype(np.float32))
        outs = []
        for run, tree, tag in ((_ref, ref, "r"), (_port, port, "t")):
            out = str(tmp_path / f"{tag}{rows}.npz")
            code, text, _ = run(["query", "--tree", tree, "--queries", str(qfile), "--k",
                                 "8", "--out", out])
            assert code == 0 and text.startswith(f"saved d2[{rows}, 8]")
            outs.append(np.load(out))
        for key in ("d2", "ids"):
            assert outs[0][key].dtype == outs[1][key].dtype
            np.testing.assert_array_equal(outs[0][key], outs[1][key])
        r = _ref(["query", "--tree", ref, "--queries", str(qfile)])
        t = _port(["query", "--tree", port, "--queries", str(qfile)])
        assert r[0] == t[0] == 0 and r[1] == t[1]


@pytest.mark.parametrize("engine", ["tree", "bucket"])
def test_classic_build_save(engine, tmp_path):
    """``build --save`` snapshots a classic tree through its Morton view,
    segment for segment the reference's; a bucketed tree cannot be served,
    so both packages refuse to snapshot it."""
    argv = ["--generator", "threefry", "--engine", engine, "build", "--n", "20000"]
    r = _ref([*argv, "--save", str(tmp_path / "ref")])
    t = _port([*argv, "--save", str(tmp_path / "port")])
    assert r[0] == t[0] == (0 if engine == "tree" else 1)
    if engine == "bucket":
        assert "cannot snapshot: cannot serve a BucketKDTree" in t[2]
        return
    mans = [json.loads((tmp_path / d / "MANIFEST.json").read_text()) for d in ("ref", "port")]
    assert mans[0]["signature"] == mans[1]["signature"]
    assert {k: v["sha256"] for k, v in mans[0]["segments"].items()} == \
        {k: v["sha256"] for k, v in mans[1]["segments"].items()}


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
    # a multi-device kind (the reference writes it on its device mesh): the
    # port loads it and prints the reference's bytes
    gpath = str(tmp_path / "global.npz")
    assert _ref(["--generator", "threefry", "--engine", "global", "--devices", "4",
                 "build", "--n", "3000", "--out", gpath])[0] == 0
    _both(["query", "--tree", gpath])
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


@pytest.mark.parametrize("argv", [
    ["--engine", "global", "harness", "1", "3", "100"],
    ["--engine", "global-morton", "bench", "--n", "100"],
    ["--engine", "global-exact", "build", "--n", "2000", "--out", "{tmp}/x.npz"],
    ["--engine", "ensemble", "harness", "1", "3", "100"],
])
def test_unported_engine_exits_crisply(argv, tmp_path):
    """The engines of ROADMAP item 17, which this test once saw exit with
    their item, now answer: the same argv through both packages (4 shards)
    gives the same stdout bytes (bench: the same JSON keys and problem)."""
    argv = ["--devices", "4", *(a.format(tmp=tmp_path) for a in argv)]
    r, t = _ref(argv), _port(argv)
    assert r[0] == t[0] == 0, (r[2][-500:], t[2][-500:])
    if "bench" in argv:
        rj, tj = json.loads(r[1]), json.loads(t[1])
        assert sorted(rj) == sorted(tj)
        assert all(rj[key] == tj[key] for key in ("n", "dim", "k", "engine"))
    else:
        assert t[1] == r[1] and t[1]


MESH_ENGINES = ("ensemble", "global", "global-morton", "global-exact")


@pytest.mark.parametrize("engine", MESH_ENGINES)
@pytest.mark.parametrize("generator", ["threefry", pytest.param("mt19937", marks=needs_native)])
def test_multi_device_engine_harness(engine, generator):
    """The four multi-device engines on 4 shards: the harness's stdout is
    the reference's, byte for byte (the scale engines take the threefry
    row stream under either generator, as the reference does)."""
    _, (code, out, _) = _both(["--generator", generator, "--engine", engine, "--devices",
                               "4", "harness", "42", "3", "20000"])
    assert code == 0 and out.count("DISTANCE: ") == 10


@pytest.mark.parametrize("engine", MESH_ENGINES)
def test_multi_device_engine_bench(engine):
    argv = ["--generator", "threefry", "--engine", engine, "--devices", "4", "bench",
            "--n", "4096", "--k", "2"]
    r, t = _ref(argv), _port(argv)
    assert r[0] == t[0] == 0, t[2][-500:]
    rj, tj = json.loads(r[1]), json.loads(t[1])
    assert sorted(rj) == sorted(tj)
    assert all(rj[key] == tj[key] for key in ("n", "dim", "k", "engine"))
    # the fused phases: ensemble times build+query together
    assert ("build+query" in tj) == (engine == "ensemble")


@pytest.mark.parametrize("engine, extra", [
    ("global", []), ("global-morton", []), ("global-morton", ["--sharded"]),
    ("global-morton", ["--distribution", "clustered", "--slack", "3"]),
    ("global-exact", ["--distribution", "clustered"]),
])
def test_multi_device_engine_build_then_query(tmp_path, engine, extra):
    """``build`` on 4 shards prints the reference's line (the sharded
    suffix included); each package's checkpoint, queried by either
    package, prints the reference's protocol lines."""
    paths = {}
    for name, run in (("ref", _ref), ("port", _port)):
        paths[name] = str(tmp_path / f"{name}.npz")
        code, out, err = run(["--generator", "threefry", "--engine", engine, "--devices", "4",
                              "build", "--n", "6000", *extra, "--out", paths[name]])
        assert code == 0, err[-500:]
        assert out == f"saved {type_name(engine)} (n=6000, dim=3) to {paths[name]}" + (
            f" (+ per-device shard files {paths[name]}.shard*.npz)\n" if extra == ["--sharded"]
            else "\n")
    for path in paths.values():
        _both(["query", "--tree", path])


def type_name(engine):
    return {"global": "GlobalKDTree", "global-morton": "GlobalMortonForest",
            "global-exact": "GlobalExactTree"}[engine]


@pytest.mark.parametrize("layout", ["one file", "shard files"])
def test_global_morton_build_from_points(tmp_path, layout):
    """``build --points`` with the scale engine: one file streamed block by
    block through the exchange, or ``{i}`` shard files onto the shards as
    they are; then ``query --queries`` through both packages."""
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 20, (5000, 3)).astype(np.float32)
    if layout == "one file":
        src = str(tmp_path / "pts.npy")
        np.save(src, pts)
    else:
        for i, part in enumerate(np.array_split(pts, 4)):
            np.save(tmp_path / f"part-{i}.npy", part)
        src = str(tmp_path / "part-{i}.npy")
    q = str(tmp_path / "q.npy")
    np.save(q, rng.normal(0, 20, (700, 3)).astype(np.float32))
    outs = {}
    for name, run in (("ref", _ref), ("port", _port)):
        ck = str(tmp_path / f"{name}.npz")
        code, _, err = run(["--engine", "global-morton", "--devices", "4", "build", "--points",
                            src, "--out", ck])
        assert code == 0, err[-500:]
        outs[name] = str(tmp_path / f"{name}-ans.npz")
        assert run(["query", "--tree", ck, "--queries", q, "--k", "4",
                    "--out", outs[name]])[0] == 0
    with np.load(outs["ref"]) as a, np.load(outs["port"]) as b:
        np.testing.assert_array_equal(a["d2"].view(np.int32), b["d2"].view(np.int32))
        np.testing.assert_array_equal(a["ids"], b["ids"])


def test_distribution_needs_a_scale_engine():
    _both(["--engine", "morton", "build", "--distribution", "clustered", "--out", "x.npz"])


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
    (["--snapshot", "snapdir"], 1),
    (["--recall-sample", "0.1", "--index", "a.npz", "--points", "b.npy"], 1),
    (["--no-ladder", "--index", "missing.npz"], 1),
    (["--index", "a.npz", "--points", "b.npy"], 1), (["--index", "missing.npz"], 1),
])
def test_serve_flags_not_ported_or_conflicting(flags, code):
    c, out, err = _port(["serve", "--port", "0", *flags])
    assert c == code and out == ""
    assert ("unrecognized arguments" in err) == (code == 2)


def _json_line(out):
    return json.loads(out.strip().splitlines()[-1])


def test_recall_cli_matches_reference(tmp_path, monkeypatch):
    """The recall harness: the same curve (caps and recall; the timings
    are the machine's), the same calibration persisted, the same stdout
    keys."""
    monkeypatch.setenv("KDTREE_TPU_PLAN_CACHE", str(tmp_path / "ref-plans"))
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", str(tmp_path / "port-plans"))
    argv = ["--generator", "threefry", "recall", "--seed", "5", "--n", "8000",
            "--q", "512", "--k", "4", "--caps", "2,8,16,32"]
    rc, rout, rerr = _ref(argv + ["--out", str(tmp_path / "ref.json")])
    tc, tout, terr = _port(argv + ["--out", str(tmp_path / "port.json")])
    assert rc == tc == 0, (rerr[-800:], terr[-800:])
    rj, tj = _json_line(rout), _json_line(tout)
    assert set(rj) == set(tj) and tj["persisted"] and rj["persisted"]
    for key in ("caps", "calibration", "persisted"):
        assert tj[key] == rj[key], key
    rrep = json.loads((tmp_path / "ref.json").read_text())
    trep = json.loads((tmp_path / "port.json").read_text())
    assert trep["calibration"] == rrep["calibration"]
    cols = ("visit_cap", "recall")
    assert [[r[c] for c in cols] for r in trep["recall"]["curve"]] == \
        [[r[c] for c in cols] for r in rrep["recall"]["curve"]]
    head = [ln for ln in terr.splitlines() if ln.startswith("recall sweep:")]
    assert head and head == [ln for ln in rerr.splitlines() if ln.startswith("recall sweep:")]

    def caps_and_recall(err):
        return [ln.split()[:2] for ln in err.splitlines() if ln.startswith("  cap=")]

    assert caps_and_recall(terr) == caps_and_recall(rerr) and len(caps_and_recall(terr)) == 4
    # the calibration resolves at a serving bucket of the port's store
    from kdtree_tpu_torch import tuning
    from kdtree_tpu_torch.ops.morton import DEFAULT_BUCKET

    sig = tuning.make_signature(8, 3, 8000, 4, DEFAULT_BUCKET, 32, backend="cpu")
    assert tuning.profile_for(sig)["recall_caps"] == tj["calibration"]


def test_tune_cli_matches_reference(tmp_path, monkeypatch):
    """``tune``: the same sweep shape and the same persisted profile name;
    which candidate wins is a timing, the machine's."""
    monkeypatch.setenv("KDTREE_TPU_PLAN_CACHE", str(tmp_path / "ref-plans"))
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", str(tmp_path / "port-plans"))
    argv = ["--generator", "threefry", "tune", "--seed", "5", "--n", "8000",
            "--q", "1024", "--k", "4", "--tiles", "64,128", "--cmax", "32",
            "--scan-v", "1", "--scan-tb", "2"]
    rc, rout, rerr = _ref(argv)
    tc, tout, terr = _port(argv)
    assert rc == tc == 0, (rerr[-800:], terr[-800:])
    rj, tj = _json_line(rout), _json_line(tout)
    assert set(rj) == set(tj) and set(rj["winner"]) == set(tj["winner"])
    for key in ("persisted", "candidates", "block_candidates"):
        assert tj[key] == rj[key], key
    assert tj["persisted"] and tj["candidates"] == 3
    assert Path(tj["path"]).name == Path(rj["path"]).name
    assert Path(tj["path"]).parent == tmp_path / "port-plans"
    head = [ln for ln in terr.splitlines() if ln.startswith("sweeping tiled plans:")]
    assert head and head == [ln for ln in rerr.splitlines()
                             if ln.startswith("sweeping tiled plans:")]
    # the next automatic plan of the tuned shape is warm
    from kdtree_tpu_torch.ops import tile_query as tq
    from kdtree_tpu_torch.ops.morton import DEFAULT_BUCKET

    plan = tq.plan_tiled(1024, 3, 8000, 32, DEFAULT_BUCKET, 4, device="cpu")
    assert plan.source == "warm" and plan.tile == tj["winner"]["tile"]
    # a disabled store has nowhere to put a winner
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", "off")
    code, out, err = _port(argv)
    assert code == 1 and out == "" and "plan store is disabled" in err


@pytest.fixture
def _telemetry_reset():
    """--metrics-out flips each package's process-wide device-metrics gate
    and records the report path; restore both after the test."""
    from kdtree_tpu import obs as jobs
    from kdtree_tpu_torch import obs as tobs

    yield
    for o in (jobs, tobs):
        o.set_enabled(None)
        o._metrics_out_path = None


def _sections(text):
    return [line for line in text.splitlines() if line.startswith("==")]


def test_metrics_out_then_stats(tmp_path, _telemetry_reset, monkeypatch):
    """``--metrics-out`` on ``bench``: the report has the reference's keys
    (the runtime facts are each package's own families), ``stats``
    renders it with the reference's sections, ``stats --diff`` compares
    two, and ``bench --trace`` leaves a Chrome trace of the timed run.
    Each package reports into a registry of this test's own: the
    process-wide ones hold whatever earlier tests in this worker counted
    (a served request adds the cost sections to one package's report)."""
    from kdtree_tpu.obs import registry as jreg
    from kdtree_tpu_torch.obs import registry as treg

    for mod in (jreg, treg):
        monkeypatch.setattr(mod, "_default_registry", mod.MetricsRegistry())
    argv = ["--generator", "threefry", "--engine", "morton", "bench", "--n", "4096"]
    jm, tm, tm2 = (str(tmp_path / n) for n in ("j.json", "t.json", "t2.json"))
    r = _run(jcli.main, ["--metrics-out", jm, "--platform", "cpu", *argv])
    t = _run(tcli.main, ["--metrics-out", tm, "--device", "cpu", *argv,
                         "--trace", str(tmp_path / "tr")])
    assert r[0] == t[0] == 0
    jr, tr = (json.loads(Path(p).read_text()) for p in (jm, tm))
    assert set(tr) == set(jr)
    assert set(tr["spans"]) & set(jr["spans"]) >= {"generate", "build", "query"}
    assert any(k.startswith("torch_platform_info{") for k in tr["gauges"])
    assert list((tmp_path / "tr").glob("*.pt.trace.json"))
    rs, ts = _run(jcli.main, ["stats", jm]), _run(tcli.main, ["stats", tm])
    assert rs[0] == ts[0] == 0
    # the reference's gated device-side histogram (kdtree_bucket_occupancy,
    # a build-time fetch) is not ported: its "histograms" section is the
    # one the port's rendering lacks
    assert _sections(ts[1]) == [x for x in _sections(rs[1]) if x != "== histograms =="]
    ran = {'kdtree_builds_total{engine="morton"}', 'kdtree_queries_total{engine="morton"}'}
    assert ran <= set(tr["counters"]) & set(jr["counters"])
    assert "platform:            cpu" in ts[1] and "devices:             1" in ts[1]
    assert _run(tcli.main, ["--metrics-out", tm2, "--device", "cpu", *argv])[0] == 0
    diff = _run(tcli.main, ["stats", "--diff", tm, tm2])
    assert diff[0] == 0 and "== spans (by NEW total time) ==" in diff[1]
    for argv_bad in (["stats", tm, tm2], ["stats", "--diff", tm],
                     ["stats", str(tmp_path / "missing.json")]):
        assert _run(tcli.main, argv_bad)[0] == _run(jcli.main, argv_bad)[0] == 1


def test_profile_writes_its_artifact(tmp_path, _telemetry_reset):
    argv = ["profile", "--n", "4096", "--q", "512", "--k", "4", "--format", "json"]
    r = _ref([*argv, "--out", str(tmp_path / "j.json"), "--trace-dir", str(tmp_path / "jt")])
    t = _port([*argv, "--out", str(tmp_path / "t.json"), "--trace-dir", str(tmp_path / "tt")])
    assert r[0] == t[0] == 0, t[2][-800:]
    rj, tj = json.loads(r[1]), json.loads(t[1])
    assert set(tj) == set(rj) and tj["dispatches"] >= 1
    assert 0 < tj["device_busy_frac"] <= 1 and tj["correlated_spans"] >= 1
    ja, ta = (json.loads((tmp_path / n).read_text()) for n in ("j.json", "t.json"))
    assert set(ta) == set(ja)
    assert ta["workload"] == ja["workload"] and ta["device"]["kind"] == "cpu"
    assert "profile.query" in ta["spans"]
    human = _port(["profile", "--n", "4096", "--q", "512", "--out", str(tmp_path / "h.json")])
    assert human[0] == 0 and "== capture ==" in human[1]


def test_profile_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out, err = _run(tcli.main, ["profile", "--n", "1024", "--q", "64"])
    assert code == 1 and out == "" and "--device cpu" in err


def test_trace_and_costs_against_a_live_server(_telemetry_reset):
    from kdtree_tpu_torch.serve import engine as tengine
    from kdtree_tpu_torch.serve import server as tserver

    srv = tserver.make_server(tengine.build_state(problem=(5, 3, 4096), k=4, max_batch=16,
                                                  device="cpu"), port=0)
    srv.start(warmup_buckets=[8])
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        import urllib.request

        req = urllib.request.Request(
            f"{base}/v1/knn", data=json.dumps({"queries": [[1.0, 2.0, 3.0]]}).encode(),
            headers={"X-Request-Id": "cli-trace-1"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read())["trace_id"] == "cli-trace-1"
        code, out, err = _run(tcli.main, ["trace", "--target", base, "--id", "cli-trace-1"])
        assert code == 0 and out.startswith("trace cli-trace-1\n"), err
        assert "serve/request" in out and "serve/dispatch" in out
        assert _run(tcli.main, ["trace", "--target", base, "--id", "nope"])[0] == 1
        code, out, _ = _run(tcli.main, ["costs", "--target", base])
        assert code == 0 and "knn/exact/ok" in out and "headroom:" in out
        code, out, _ = _run(tcli.main, ["costs", "--target", base, "--json"])
        assert code == 0 and json.loads(out)["totals"]["requests"] >= 1
    finally:
        srv.stop()
    assert _run(tcli.main, ["costs", "--target", base, "--timeout-s", "2"])[0] == 1


@pytest.mark.parametrize("cmd", ["route", "loadgen", "lint", "trend"])
def test_unported_subcommands_name_their_item(cmd):
    """``lint`` and ``trend`` still name ROADMAP item 18; ``route`` and
    ``loadgen`` are ported, so an unknown flag is argparse's usage error
    and no unported-item message."""
    code, out, err = _run(tcli.main, [cmd, "--anything"])
    if cmd in tcli.UNPORTED_COMMANDS:
        assert code == 1 and out == "" and "item 18" in err
    else:
        assert code == 2 and out == "" and "item 18" not in err
        assert "unrecognized arguments: --anything" in err or "required" in err
