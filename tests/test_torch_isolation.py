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


def _run(code, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(REPO))


def test_every_module_imports_without_jax_or_the_reference():
    mods = _modules()
    assert "kdtree_tpu_torch.kernels.scan_knn" in mods and len(mods) >= 12
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


def test_public_surface_resolves_lazily():
    out = _run("import sys, kdtree_tpu_torch as k\n"
               "assert 'kdtree_tpu_torch.ops.tile_query' not in sys.modules\n"
               "assert callable(k.morton_knn_tiled) and callable(k.build_morton)\n"
               "assert callable(k.morton_knn) and callable(k.save_tree)\n"
               "assert 'kdtree_tpu_torch.utils.cli' not in sys.modules\n"
               "assert k.bruteforce.knn\n")
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
])
def test_default_device_without_cuda_raises(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_explicit_cpu_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = kdtree_tpu_torch.generate_queries(1, 3, 4, device="cpu")
    assert q.device.type == "cpu" and q.shape == (4, 3)


def test_kernel_module_imports_without_nvcc(tmp_path):
    code = ("import kdtree_tpu_torch.kernels.scan_knn as s, kdtree_tpu_torch.kernels._build as b\n"
            "assert s.scan_tiles.launches == 0\n"
            "assert b.sources() == ['scan_knn']\n"
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
