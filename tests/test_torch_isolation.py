"""The port stands alone: no jax, no kdtree_tpu, no silent CPU fallback,
and its kernel module imports without a CUDA toolkit."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kdtree_tpu_torch
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _modules():
    names = ["kdtree_tpu_torch"]
    for info in pkgutil.walk_packages(kdtree_tpu_torch.__path__, "kdtree_tpu_torch."):
        names.append(info.name)
    return names


def _serve_engine():
    from kdtree_tpu_torch.serve import engine

    return engine


def _server():
    from kdtree_tpu_torch.serve import server

    return server


def _cli():
    from kdtree_tpu_torch.utils import cli

    return cli


def _profile():
    from kdtree_tpu_torch.obs import profile

    return profile


def _parallel():
    from kdtree_tpu_torch import parallel

    return parallel


def _classic():
    from kdtree_tpu_torch.ops import build_presort

    return build_presort


_Q = [[0.0, 0.0, 0.0]]


def _run(code, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(REPO))


def test_every_module_imports_without_jax_or_the_reference():
    mods = _modules()
    assert "kdtree_tpu_torch.kernels.scan_knn" in mods and len(mods) >= 12
    for sub in ("kernels.verb_fold", "kernels.pair_d2", "kernels.frontier", "kernels.knn_scan",
                "kernels.morton_dfs",
                "snapshot.store", "snapshot.follower", "verbs.device", "verbs.oracle",
                "verbs.wire", "tuning.store", "tuning.feedback", "tuning.tuner",
                "approx.search", "approx.recall", "approx.ladder", "models.tree",
                "ops.build", "ops.build_presort", "ops.query", "ops.bucket",
                "obs.profile", "obs.timeline", "obs.torchrt", "obs.trace",
                "obs.costs", "parallel", "parallel.mesh", "parallel.global_morton",
                "parallel.ensemble", "parallel.global_exact", "parallel.global_tree",
                "parallel.dsharded", "serve.spatial", "serve.pool", "serve.router",
                "loadgen", "loadgen.schedule", "loadgen.runner", "obs.trend",
                "analysis", "analysis.lockwatch", "analysis.registry", "analysis.program",
                "analysis.checkers", "analysis.walker", "analysis.baseline",
                "analysis.reporting"):
        assert f"kdtree_tpu_torch.{sub}" in mods, sub
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'kdtree_tpu' or m.startswith('kdtree_tpu.'))\n"
        "print('LEAKED', bad)\n"
        "assert not bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stdout + out.stderr


def test_fleet_modules_stand_alone_and_stay_off_the_device():
    """In a fresh process: the router, the pool, the partitioner's
    geometry and the load harness route a request over a CPU shard
    without importing jax or the reference and without initializing
    CUDA (their processes must hold no CUDA context)."""
    code = (
        "import json, sys, urllib.request\n"
        "import numpy as np, torch\n"
        "from kdtree_tpu_torch.serve import engine, server, router, spatial, pool\n"
        "from kdtree_tpu_torch.loadgen import runner, schedule\n"
        "st = engine.build_state(points=np.zeros((64, 3), np.float32), k=2, max_batch=8,"
        " device='cpu')\n"
        "shard = server.make_server(st, port=0); shard.start(warmup_buckets=[8])\n"
        "url = f'http://127.0.0.1:{shard.server_address[1]}'\n"
        "rt = router.make_router([url]); rt.start(health_loop=False)\n"
        "req = urllib.request.Request(f'http://127.0.0.1:{rt.server_address[1]}/v1/knn',"
        " data=json.dumps({'queries': [[0.0, 0.0, 0.0]]}).encode())\n"
        "body = json.loads(urllib.request.urlopen(req, timeout=60).read())\n"
        "assert body['ids'] == [[0, 1]], body\n"
        "assert runner.discover(url, retries=3)['n'] == 64\n"
        "rt.stop(); shard.stop()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'kdtree_tpu' or m.startswith('kdtree_tpu.'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('FLEET OK')\n"
    )
    out = _run(code)
    assert out.returncode == 0 and "FLEET OK" in out.stdout, out.stdout + out.stderr


def test_lint_and_trend_stay_off_the_device():
    """In a fresh process the CLI's ``trend`` and ``lint`` run as host
    code: no jax, no reference package, no CUDA initialization."""
    bench = [str(REPO / f"BENCH_r0{i}.json") for i in range(1, 6)]
    code = (
        "import sys, torch\n"
        "from kdtree_tpu_torch.utils import cli\n"
        "def run(argv):\n"
        "    try:\n"
        "        cli.main(argv)\n"
        "    except SystemExit as e:\n"
        "        return e.code\n"
        "    return 0\n"
        f"assert run(['trend', *{bench!r}, '--baseline', 'trend_baseline.json']) == 0\n"
        "assert run(['lint', 'kdtree_tpu_torch/utils', '--baseline', 'none.json']) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'kdtree_tpu' or m.startswith('kdtree_tpu.'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('HOST OK')\n"
    )
    out = _run(code)
    assert out.returncode == 0 and "HOST OK" in out.stdout, out.stdout + out.stderr
    assert "[base]" in out.stdout and "0 finding(s)" in out.stdout


def test_public_surface_resolves_lazily():
    out = _run("import sys, kdtree_tpu_torch as k\n"
               "assert 'kdtree_tpu_torch.ops.tile_query' not in sys.modules\n"
               "assert callable(k.morton_knn_tiled) and callable(k.build_morton)\n"
               "assert callable(k.morton_knn) and callable(k.save_tree)\n"
               "assert 'kdtree_tpu_torch.utils.cli' not in sys.modules\n"
               "assert 'kdtree_tpu_torch.approx' not in sys.modules\n"
               "assert callable(k.morton_knn_approx) and callable(k.sweep_recall)\n"
               "assert k.approx.DegradationLadder is k.DegradationLadder\n"
               "assert callable(k.tuning.lookup) and callable(k.resolve_visit_cap)\n"
               "assert k.bruteforce.knn\n"
               "assert 'kdtree_tpu_torch.ops.query' not in sys.modules\n"
               "assert callable(k.build_jit) and callable(k.knn) and callable(k.bucket_knn)\n"
               "assert k.KDTree.__name__ == 'KDTree' and callable(k.tree_spec)\n"
               "assert callable(k.build) and callable(k.validate_invariants)\n"
               "assert callable(k.nearest_neighbor) and callable(k.build_bucket)\n"
               "assert k.BucketKDTree.__name__ == 'BucketKDTree' and k.TreeSpec\n")
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("call", [
    lambda: kdtree_tpu_torch.generate_queries(1, 3, 4),
    lambda: kdtree_tpu_torch.generate_points_rowwise(1, 3, 4),
    lambda: kdtree_tpu_torch.build_morton(torch.zeros(4, 3).numpy()),
    lambda: kdtree_tpu_torch.tree_from_arrays([[0.0]], [[0.0]], [[[0.0]]], [[0]], 1, 0),
    lambda: kdtree_tpu_torch.resolve_device(None),
    lambda: kdtree_tpu_torch.resolve_device("cuda"),
    lambda: kdtree_tpu_torch.load_tree("no-such-checkpoint.npz"),
    lambda: _serve_engine().build_state(problem=(1, 3, 64)),
    lambda: _serve_engine().build_state(points=torch.zeros(64, 3).numpy()),
    lambda: _server().make_server(_serve_engine().build_state(problem=(1, 3, 64))),
    lambda: _cli().cmd_serve(_cli().build_parser().parse_args(["serve", "--n", "64"])),
    lambda: kdtree_tpu_torch.build_jit(torch.zeros(4, 3).numpy()),
    lambda: kdtree_tpu_torch.build(torch.zeros(4, 3).numpy()),
    lambda: _classic().build_presort(torch.zeros(4, 3).numpy()),
    lambda: kdtree_tpu_torch.build_bucket(torch.zeros(4, 3).numpy()),
    lambda: kdtree_tpu_torch.knn(kdtree_tpu_torch.build_jit(torch.zeros(4, 3).numpy()), _Q),
    lambda: kdtree_tpu_torch.nearest_neighbor(
        kdtree_tpu_torch.tree_from_arrays(torch.zeros(1, 3).numpy(), [0], [0.0],
                                          kind="classic"), _Q),
    lambda: kdtree_tpu_torch.bucket_knn(
        kdtree_tpu_torch.build_bucket(torch.zeros(4, 3).numpy()), _Q),
    lambda: _profile().capture_for(0.0, "never-created"),
    lambda: _parallel().make_mesh(),
    lambda: _parallel().build_global_morton(1, 3, 64),
    lambda: _parallel().ensemble_knn(torch.zeros(4, 3).numpy(), _Q),
    lambda: _parallel().build_global_exact(1, 3, 64),
    lambda: _parallel().build_global(torch.zeros(4, 3).numpy()),
    lambda: _parallel().dsharded_knn(torch.zeros(4, 3).numpy(), _Q),
    lambda: _parallel().ensemble_knn_gen(1, 3, 64, _Q),
    lambda: kdtree_tpu_torch.generate_clustered(1, 3, 4),
])
def test_default_device_without_cuda_raises(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.fixture(scope="module")
def snapdir(tmp_path_factory):
    """A small snapshot, saved from a CPU tree (saving needs no CUDA)."""
    from kdtree_tpu_torch import snapshot

    d = str(tmp_path_factory.mktemp("snap") / "s")
    tree = kdtree_tpu_torch.build_morton(torch.zeros(64, 3).numpy(), device="cpu")
    snapshot.save_snapshot(d, tree)
    return d


def _load(d):
    from kdtree_tpu_torch import snapshot

    return snapshot.load_snapshot(d)[0]


def _verbs():
    from kdtree_tpu_torch.verbs import device, oracle

    return device, oracle


@pytest.mark.parametrize("call", [
    lambda d: _load(d),
    lambda d: _verbs()[0].radius_search(_load(d), _Q, 1.0),
    lambda d: _verbs()[0].range_search(_load(d), _Q, _Q),
    lambda d: _verbs()[1].radius_oracle(torch.zeros(4, 3).numpy(), _Q, 1.0),
    lambda d: _verbs()[1].range_oracle(torch.zeros(4, 3).numpy(), _Q, _Q),
    lambda d: _serve_engine().build_state(tree=_load(d)),
    lambda d: _cli().cmd_serve(_cli().build_parser().parse_args(
        ["serve", "--snapshot", d, "--port", "0"])),
])
def test_snapshot_and_verb_entry_points_raise_without_cuda(call, snapdir, monkeypatch):
    """Loading a snapshot, the verbs over a snapshot's tree, the verb
    oracles over host points, and a server from a snapshot all run on CUDA
    by default and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(snapdir)


def test_explicit_cpu_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = kdtree_tpu_torch.generate_queries(1, 3, 4, device="cpu")
    assert q.device.type == "cpu" and q.shape == (4, 3)
    pts = torch.zeros(4, 3).numpy()
    d2, _ = kdtree_tpu_torch.knn(kdtree_tpu_torch.build_jit(pts, device="cpu"), _Q)
    bd2, _ = kdtree_tpu_torch.bucket_knn(kdtree_tpu_torch.build_bucket(pts, device="cpu"), _Q)
    assert d2.device.type == bd2.device.type == "cpu" and float(d2[0, 0]) == 0.0


def test_kernel_module_imports_without_nvcc(tmp_path):
    code = ("import kdtree_tpu_torch.kernels.scan_knn as s, kdtree_tpu_torch.kernels._build as b\n"
            "import kdtree_tpu_torch.kernels.verb_fold as v, kdtree_tpu_torch.kernels.pair_d2 as p\n"
            "import kdtree_tpu_torch.kernels.frontier as f, kdtree_tpu_torch.kernels.knn_scan as k\n"
            "import kdtree_tpu_torch.kernels.morton_dfs as m\n"
            "assert s.scan_tiles.launches == f.frontier.launches == k.knn_scan.launches == 0\n"
            "assert v.radius_fold.launches == v.range_fold.launches == p.pair_d2.launches == 0\n"
            "assert m.morton_dfs.launches == 0\n"
            "assert b.sources() == ['frontier', 'knn_scan', 'morton_dfs', 'pair_d2', 'scan_knn',"
            " 'verb_fold']\n"
            "b.DEFAULT_NVCC = b.PKG_DIR / 'no-such-nvcc'\n"
            "try:\n"
            "    b._nvcc()\n"
            "except RuntimeError as e:\n"
            "    print('REFUSED', e)\n"
            "else:\n"
            "    raise SystemExit('found an nvcc on an empty PATH')\n")
    out = _run(code, {"PATH": str(tmp_path)})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "REFUSED" in out.stdout


def test_build_library_name_tracks_the_source():
    from kdtree_tpu_torch.kernels import _build

    path = _build.lib_path("scan_knn")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libscan_knn-")
    assert path == _build.lib_path("scan_knn")


def test_kernel_wrappers_raise_on_cuda_tensors_without_a_build(tmp_path):
    """On a CUDA tensor the fold, pair_d2, frontier, knn_scan and Morton
    DFS wrappers launch their kernel or raise (knn_scan and the DFS also
    for no query rows, the DFS also through ``morton_knn`` and
    ``morton_knn_chunks``): with no nvcc and no library built, each call
    (the frontier's with a forced cluster size too) raises nvcc's absence
    and never reaches its plain version (for the DFS, nor the lockstep
    loop nor the kernel's mirror). (A tensor subclass that reports a CUDA
    device stands in for a card this process lacks.)"""
    code = (
        "import torch, types\n"
        "import kdtree_tpu_torch.kernels._build as b\n"
        "import kdtree_tpu_torch.kernels.pair_d2 as p\n"
        "import kdtree_tpu_torch.kernels.verb_fold as v\n"
        "import kdtree_tpu_torch.kernels.frontier as f\n"
        "import kdtree_tpu_torch.kernels.knn_scan as k\n"
        "import kdtree_tpu_torch.kernels.morton_dfs as m\n"
        "import kdtree_tpu_torch.ops.morton as om\n"
        f"b.BUILD_DIR = b.Path({str(tmp_path / 'build')!r})\n"
        "b.DEFAULT_NVCC = b.PKG_DIR / 'no-such-nvcc'\n"
        "def plain(*a):\n"
        "    raise SystemExit('fell back to the plain version')\n"
        "v._radius_fold_plain = v._range_fold_plain = p.pair_d2_plain = plain\n"
        "k.knn_scan_plain = plain\n"
        "f._frontier = f.frontier_mirror = plain\n"
        "m.morton_knn_plain = m.morton_dfs_mirror = om.morton_knn_plain = plain\n"
        "om._morton_knn_batch = plain\n"
        "class Cuda(torch.Tensor):\n"
        "    @property\n"
        "    def device(self):\n"
        "        return torch.device('cuda', 0)\n"
        "def c(x):\n"
        "    return x.as_subclass(Cuda)\n"
        "as_tensor = torch.as_tensor\n"
        "torch.as_tensor = lambda x, **kw: x if isinstance(x, Cuda) else as_tensor(x, **kw)\n"
        "mt = om.MortonTree(c(torch.zeros(7, 3)), c(torch.zeros(7, 3)), c(torch.zeros(4, 8, 3)),"
        " c(torch.zeros(4, 8, dtype=torch.int32)), 32, 2)\n"
        "tree = types.SimpleNamespace(bucket_pts=c(torch.zeros(4, 8, 3)),"
        " bucket_gid=c(torch.zeros(4, 8, dtype=torch.int32)), bucket_size=8,"
        " num_buckets=4, num_levels=2, node_lo=c(torch.zeros(7, 3)),"
        " node_hi=c(torch.zeros(7, 3)))\n"
        "tq = c(torch.zeros(2, 4, 3))\n"
        "cand = c(torch.zeros(2, 3, dtype=torch.int32))\n"
        "calls = [lambda: v.radius_fold(tree, tq, c(torch.ones(2, 4)), cand, 8),\n"
        "         lambda: v.radius_fold(tree, tq, c(torch.ones(2, 4)), cand, 0),\n"
        "         lambda: v.range_fold(tree, tq, tq, cand, 8),\n"
        "         lambda: p.pair_d2(c(torch.zeros(5, 3)), c(torch.zeros(7, 3))),\n"
        "         lambda: k.knn_scan(c(torch.zeros(7, 3)), c(torch.zeros(5, 3)), 4),\n"
        "         lambda: k.knn_scan(c(torch.zeros(7, 3)), c(torch.zeros(0, 3)), 4),\n"
        "         lambda: f.frontier(tree, c(torch.zeros(2, 3)), c(torch.ones(2, 3)),"
        " c(torch.ones(2)), 3),\n"
        "         lambda: f.frontier(tree, c(torch.zeros(2, 3)), c(torch.ones(2, 3)),"
        " c(torch.ones(2)), 3, cluster=8),\n"
        "         lambda: m.morton_dfs(mt, c(torch.zeros(5, 3)), 4),\n"
        "         lambda: m.morton_dfs(mt, c(torch.zeros(0, 3)), 4),\n"
        "         lambda: om.morton_knn(mt, c(torch.zeros(5, 3)), k=4),\n"
        "         lambda: om.morton_knn_chunks(mt, c(torch.zeros(5, 3)), 4, chunk=2)]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'nvcc not found' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('a CUDA call ran without a kernel')\n"
        "assert v.radius_fold.launches == v.range_fold.launches == p.pair_d2.launches == 0\n"
        "assert f.frontier.launches == k.knn_scan.launches == m.morton_dfs.launches == 0\n"
        "print('RAISED', len(calls))\n"
    )
    out = _run(code, {"PATH": str(tmp_path)})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "RAISED 12" in out.stdout
