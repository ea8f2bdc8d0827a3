"""The port's global Morton forest against ``kdtree_tpu``'s, on the same
seeded inputs in one process: the reference on its 8-device CPU mesh
(``make_mesh(P)``), the port on P logical CPU shards (``make_mesh(P,
device="cpu")``), at P in {1, 2, 4, 8}.

Tolerance: exact. Forest arrays (``node_lo``, ``node_hi``,
``bucket_pts``, ``bucket_gid``) compare as int32 views of their bits, and
``occ_max`` as an int, built from a seed (uniform and clustered), from
points and from shard files. Query d2 compares bit for bit on every route
(the per-shard DFS, the SPMD tiled route, the mesh-free view and the
sequential fallback), ids exactly except between exactly tied d2 (none
occur in these inputs, so ids compare exactly too). Also the overflow
``RuntimeError``, the occupancy-sized slack, the obs families, the
checkpoints of both formats across packages, and the mesh's errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtree_tpu import obs as jobs
from kdtree_tpu.ops import morton as jmorton
from kdtree_tpu.parallel import global_morton as jgm
from kdtree_tpu.parallel import mesh as jmesh
from kdtree_tpu.utils import checkpoint as jckpt
from kdtree_tpu_torch import obs as tobs
from kdtree_tpu_torch.ops import morton as tmorton
from kdtree_tpu_torch.parallel import global_morton as tgm
from kdtree_tpu_torch.parallel import mesh as tmesh
from kdtree_tpu_torch.utils import checkpoint as tckpt
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

torch.set_num_threads(1)

# (P, n, D, distribution)
CASES = [
    (1, 3000, 3, "uniform"),
    (2, 5000, 2, "clustered"),
    (4, 20000, 3, "uniform"),
    (4, 8000, 3, "clustered"),
    (8, 32768, 8, "uniform"),
    (4, 3001, 33, "clustered"),
]
KS = (1, 3, 4, 16)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


def _jmesh(p):
    return jmesh.make_mesh(p)


def _tmesh(p):
    return tmesh.make_mesh(p, device="cpu")


def _same_forest(jf, tf):
    assert tf.devices == jf.devices and tf.num_levels == jf.num_levels
    for name in tgm.GlobalMortonForest.ARRAYS:
        a = np.asarray(getattr(jf, name))
        b = tgm.stack_shards(getattr(tf, name)).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    for name in tgm.GlobalMortonForest.AUX:
        assert getattr(jf, name) == getattr(tf, name), name


def _same_answer(j, t):
    jd, ji = j
    td, ti = t
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(_bits(jd), _bits(td.numpy()))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def _queries(q, d, seed=1):
    return np.random.default_rng(seed).uniform(-100, 100, (q, d)).astype(np.float32)


@pytest.fixture(scope="module")
def forests():
    """Both packages' forests for every case, built once."""
    out = {}
    for p, n, d, dist in CASES:
        jf = jgm.build_global_morton(5, d, n, mesh=_jmesh(p), distribution=dist)
        tf = tgm.build_global_morton(5, d, n, mesh=_tmesh(p), distribution=dist)
        out[(p, n, d, dist)] = (jf, tf)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "P{}-n{}-d{}-{}".format(*c))
def test_forest_from_seed_bit_identical(forests, case):
    _same_forest(*forests[case])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "P{}-n{}-d{}-{}".format(*c))
def test_dfs_route(forests, case, k):
    """10 queries: the per-shard DFS and the merge."""
    jf, tf = forests[case]
    p, _, d, _ = case
    q = _queries(10, d, seed=k)
    _same_answer(jgm.global_morton_query(jf, jnp.asarray(q), k=k, mesh=_jmesh(p)),
                 tgm.global_morton_query(tf, q, k=k, mesh=_tmesh(p)))


TILED = [c for c in CASES if c[2] <= 6]


@pytest.mark.parametrize("k", (1, 16))
@pytest.mark.parametrize("case", TILED, ids=lambda c: "P{}-n{}-d{}-{}".format(*c))
def test_spmd_tiled_route(forests, case, k):
    """A dense batch: the tiled engine on every shard, one merge per batch."""
    jf, tf = forests[case]
    p, _, d, _ = case
    q = _queries(600, d, seed=7)
    _same_answer(jgm.global_morton_query(jf, jnp.asarray(q), k=k, mesh=_jmesh(p)),
                 tgm.global_morton_query(tf, q, k=k, mesh=_tmesh(p)))


@pytest.mark.parametrize("case", [c for c in TILED if c[0] > 1],
                         ids=lambda c: "P{}-n{}-d{}-{}".format(*c))
def test_meshfree_view_route(forests, case):
    """A one-shard mesh for a P-shard forest: the flattened Morton view."""
    jf, tf = forests[case]
    q = _queries(700, case[2], seed=9)
    _same_answer(jgm.global_morton_query_tiled(jf, jnp.asarray(q), k=4, mesh=_jmesh(1)),
                 tgm.global_morton_query_tiled(tf, q, k=4, mesh=_tmesh(1)))
    assert isinstance(getattr(tf, "_dense_view"), tmorton.MortonTree)


def test_sequential_fallback_route():
    """The view over budget: the shards one after another, then the merge."""
    jf = jgm.build_global_morton(9, 3, 6000, mesh=_jmesh(4))
    tf = tgm.build_global_morton(9, 3, 6000, mesh=_tmesh(4))
    jf._dense_view = jmorton._BUDGET_EXCEEDED
    tf._dense_view = tmorton._BUDGET_EXCEEDED
    q = _queries(600, 3, seed=11)
    _same_answer(jgm.global_morton_query_tiled(jf, jnp.asarray(q), k=8, mesh=_jmesh(1)),
                 tgm.global_morton_query_tiled(tf, q, k=8, mesh=_tmesh(1)))


@pytest.mark.parametrize("p", (1, 4, 8))
@pytest.mark.parametrize("order", ("random", "sorted"))
def test_forest_from_points(p, order):
    """User rows streamed block-cyclically onto the shards, quantized on
    the data's own grid, exchanged and built."""
    pts = np.random.default_rng(p).normal(0, 30, (9000, 3)).astype(np.float32)
    if order == "sorted":
        pts = np.sort(pts, axis=0)
    jf = jgm.build_global_morton_from_points(pts, mesh=_jmesh(p))
    tf = tgm.build_global_morton_from_points(pts, mesh=_tmesh(p))
    _same_forest(jf, tf)
    q = _queries(30, 3, seed=p)
    _same_answer(jgm.global_morton_query(jf, jnp.asarray(q), k=4, mesh=_jmesh(p)),
                 tgm.global_morton_query(tf, q, k=4, mesh=_tmesh(p)))


@pytest.mark.parametrize("p", (2, 4))
def test_forest_from_shard_files(tmp_path, p):
    rng = np.random.default_rng(30 + p)
    paths = []
    for i in range(p):
        path = str(tmp_path / f"part-{i}.npy")
        np.save(path, rng.uniform(-50, 50, (1000 + 137 * i, 2)).astype(np.float32))
        paths.append(path)
    jf = jgm.build_global_morton_from_shard_files(paths, mesh=_jmesh(p))
    tf = tgm.build_global_morton_from_shard_files(paths, mesh=_tmesh(p))
    _same_forest(jf, tf)
    q = _queries(600, 2, seed=p)
    _same_answer(jgm.global_morton_query(jf, jnp.asarray(q), k=3, mesh=_jmesh(p)),
                 tgm.global_morton_query(tf, q, k=3, mesh=_tmesh(p)))


def test_overflow_raises_the_reference_error():
    with pytest.raises(RuntimeError) as je:
        jgm.build_global_morton(3, 3, 4000, mesh=_jmesh(4), slack=0.05)
    with pytest.raises(RuntimeError) as te:
        tgm.build_global_morton(3, 3, 4000, mesh=_tmesh(4), slack=0.05)
    assert str(te.value) == str(je.value)
    assert "retry with slack > 0.05" in str(te.value)


def test_occupancy_sized_slack_from_a_warm_store(tmp_path, monkeypatch):
    """A profile that recorded full buckets doubles the exchange slack in
    both packages (gauge and counter), and the forests stay identical."""
    from kdtree_tpu import tuning as jtuning
    from kdtree_tpu_torch import tuning as ttuning

    monkeypatch.setenv("KDTREE_TPU_PLAN_CACHE", str(tmp_path / "j"))
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", str(tmp_path / "t"))
    n = 1 << 14
    prof = {"tile": 64, "cmax": 32, "seeds": 8, "occupancy_p90": 128.0}
    jtuning.default_store().put(
        jtuning.make_signature(1024, 3, n, 4, 128, 32, devices=1, backend="cpu"), prof)
    ttuning.default_store().put(
        ttuning.make_signature(1024, 3, n, 4, 128, 32, devices=1, backend="cpu"), prof)
    jc = jobs.get_registry().counter("kdtree_slack_occupancy_sized_total")
    tc = tobs.get_registry().counter("kdtree_slack_occupancy_sized_total")
    j0, t0 = jc.value, tc.value
    jf = jgm.build_global_morton(5, 3, n, mesh=_jmesh(8))
    jslack = jobs.get_registry().snapshot()["gauges"]["kdtree_exchange_slack"]
    tf = tgm.build_global_morton(5, 3, n, mesh=_tmesh(8))
    tslack = tobs.get_registry().snapshot()["gauges"]["kdtree_exchange_slack"]
    assert jslack == tslack == 2.0 * tgm.DEFAULT_SLACK
    assert jc.value - j0 == tc.value - t0 == 1
    _same_forest(jf, tf)
    # the forest's DFS d2 (its FMA chain), not an eager oracle's rounding
    q = _queries(64, 3, seed=51)
    _same_answer(jgm.global_morton_query(jf, jnp.asarray(q), k=4, mesh=_jmesh(8)),
                 tgm.global_morton_query(tf, q, k=4, mesh=_tmesh(8)))


def _families(reg, names):
    snap = reg.snapshot()
    out = {}
    for kind in ("counters", "gauges"):
        for k, v in snap[kind].items():
            if k.split("{")[0] in names:
                out[k] = v
    return out


def test_obs_families_equal_reference():
    """A build and a DFS query move the forest's families alike: the engine
    counters, ``kdtree_forest_devices``, the per-shard query rows, and the
    ``build.global-morton`` span."""
    names = ("kdtree_builds_total", "kdtree_build_points_total", "kdtree_queries_total",
             "kdtree_query_rows_total", "kdtree_shard_queries_total",
             "kdtree_forest_devices")
    jreg, treg = jobs.get_registry(), tobs.get_registry()
    j0, t0 = _families(jreg, names), _families(treg, names)
    q = _queries(12, 3)
    jf = jgm.build_global_morton(2, 3, 2000, mesh=_jmesh(4))
    jgm.global_morton_query(jf, jnp.asarray(q), k=2, mesh=_jmesh(4))
    tf = tgm.build_global_morton(2, 3, 2000, mesh=_tmesh(4))
    tgm.global_morton_query(tf, q, k=2, mesh=_tmesh(4))

    def delta(before, after):
        return {k: v - before.get(k, 0.0) for k, v in after.items()
                if v != before.get(k, 0.0) or "forest_devices" in k}

    jd = delta(j0, _families(jreg, names))
    td = delta(t0, _families(treg, names))
    assert td == jd
    assert td['kdtree_shard_queries_total{shard="3"}'] == 12
    for reg in (jreg, treg):
        spans = reg.snapshot()["histograms"]
        assert any("build.global-morton" in k for k in spans)


@pytest.mark.parametrize("writer", ("reference", "port"))
@pytest.mark.parametrize("sharded", (False, True))
def test_checkpoint_across_packages(forests, tmp_path, writer, sharded):
    """A forest checkpoint, single-file or sharded-v1, written by either
    package loads in the other and answers the same."""
    path = str(tmp_path / "forest.npz")
    jf, tf = forests[(4, 8000, 3, "clustered")]
    if writer == "reference":
        fmt = jckpt.save_tree(path, jf, meta={"seed": 4}, sharded=sharded)
    else:
        fmt = tckpt.save_tree(path, tf, meta={"seed": 4}, sharded=sharded)
    assert fmt == ("sharded" if sharded else "single")
    jl, jmeta = jckpt.load_tree(path)
    tl, tmeta = tckpt.load_tree(path, device="cpu")
    assert jmeta == tmeta == {"seed": 4}
    assert isinstance(tl, tgm.GlobalMortonForest)
    _same_forest(jl, tl)
    _same_forest(jf, tl)
    q = _queries(600, 3)
    _same_answer(jgm.global_morton_query(jl, jnp.asarray(q), k=4),
                 tgm.global_morton_query(tl, q, k=4))


def test_sharded_checkpoint_needs_its_sidecars(tmp_path):
    path = str(tmp_path / "f.npz")
    tckpt.save_tree(path, tgm.build_global_morton(4, 3, 3000, mesh=_tmesh(2)),
                    sharded=True)
    next(tmp_path.glob("f.npz.shard1-*.npz")).unlink()
    with pytest.raises(FileNotFoundError, match="copied as a set"):
        tckpt.load_tree(path, device="cpu")


def test_global_morton_knn_convenience():
    q = _queries(20, 3)
    _same_answer(jgm.global_morton_knn(6, 3, 4000, jnp.asarray(q), k=5, mesh=_jmesh(2)),
                 tgm.global_morton_knn(6, 3, 4000, q, k=5, mesh=_tmesh(2)))


def test_make_mesh_refuses_more_cuda_devices_than_exist(monkeypatch):
    with pytest.raises(ValueError) as je:
        jmesh.make_mesh(9)
    assert str(je.value) == "requested 9 devices, have 8"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"^requested 2 devices, have 1$"):
        tmesh.make_mesh(2)
    assert [str(d) for d in tmesh.make_mesh(1).devices] == ["cuda:0"]
    # a mesh built by hand may repeat one card
    assert tmesh.Mesh(["cuda:0"] * 4).shape[tmesh.SHARD_AXIS] == 4


def test_cpu_mesh_holds_logical_shards():
    m = tmesh.make_mesh(8, device="cpu")
    assert m.size == 8 and set(m.devices) == {torch.device("cpu")}
    assert tmesh.make_mesh(device="cpu").size == 1
