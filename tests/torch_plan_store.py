"""Each port test module gets a plan store of its own.

``plan_tiled`` reads the port's plan store and every automatic tiled run
writes its settled plan back, so a test that used the default
``~/.cache/kdtree_tpu_torch/plans`` would see what earlier runs left
there. ``tests/conftest.py`` isolates only the JAX package's store. A
module imports :func:`isolated_torch_plan_store`; being autouse and
module-scoped, it points ``KDTREE_TPU_TORCH_PLAN_CACHE`` at a fresh
temporary directory before any fixture of that module runs (CLI
subprocesses inherit it) and restores the environment afterwards."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def isolated_torch_plan_store(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KDTREE_TPU_TORCH_PLAN_CACHE",
                  str(tmp_path_factory.mktemp("torch-plans")))
        yield
