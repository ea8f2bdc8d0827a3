"""The port's classic median-split tree against ``kdtree_tpu``'s, on the
same seeded inputs in one process, with exact tolerance: tree arrays
bit-identical (``tree_spec``, ``build_jit``, ``build``, ``build_presort``),
k-NN d2 bit-equal and ids equal (``knn``, ``nearest_neighbor``),
checkpoints of the classic, bucketed and legacy formats across packages
in both directions, classic trees served through their Morton view, and
the engine counters (``kdtree_builds_total`` and its three siblings)
equal to the reference's after the same calls.

Each distinct (tree shape, batch shape, k) is one JAX compile of the
reference's DFS; the cases share shapes where they can."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kdtree_tpu as kt
from kdtree_tpu import obs as jobs
from kdtree_tpu.ops import bruteforce as jbf
from kdtree_tpu.ops import tile_query as jtq
from kdtree_tpu.serve import lifecycle as jlife
from kdtree_tpu.utils import checkpoint as jckpt
from kdtree_tpu_torch import obs as tobs
from kdtree_tpu_torch.interop import tree_from_arrays, tree_to_arrays
from kdtree_tpu_torch.models import tree as tmodel
from kdtree_tpu_torch.ops import _arith
from kdtree_tpu_torch.ops import bruteforce as tbf
from kdtree_tpu_torch.ops import bucket as tbk
from kdtree_tpu_torch.ops import build as tb
from kdtree_tpu_torch.ops import build_presort as tp
from kdtree_tpu_torch.ops import morton as tm
from kdtree_tpu_torch.ops import query as tq
from kdtree_tpu_torch.ops import tile_query as ttq
from kdtree_tpu_torch.serve import engine as tserve
from kdtree_tpu_torch.utils import checkpoint as tckpt
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

BUILD_N = (1, 2, 3, 7, 100, 1000, 4097)
BUILD_D = (1, 2, 3, 8, 33)


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _same_classic(jt, tt):
    assert tt.node_point.dtype == torch.int32 and tt.split_val.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jt.node_point), tt.node_point.numpy())
    np.testing.assert_array_equal(_bits(np.asarray(jt.split_val)), _bits(tt.split_val.numpy()))
    np.testing.assert_array_equal(_bits(np.asarray(jt.points)), _bits(tt.points.numpy()))


def _uniform(n, d, seed):
    return np.random.default_rng(seed).uniform(-100, 100, (n, d)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 65, 1000, 4097])
def test_tree_spec_equals_reference(n):
    """The vectorized spec equals the reference's segment loop array for
    array, and so do its derived position arrays."""
    js, ts = kt.tree_spec(n), tmodel.tree_spec(n)
    assert (ts.n, ts.num_levels, ts.heap_size) == (js.n, js.num_levels, js.heap_size)
    for name in ("level_medpos", "level_nodes", "level_segstart"):
        a, b = getattr(js, name), getattr(ts, name)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for name in ("consume_level", "position_node", "all_medpos", "all_nodes"):
        np.testing.assert_array_equal(getattr(js, name), getattr(ts, name))
    np.testing.assert_array_equal(kt.models.tree.node_levels(js.heap_size),
                                  tmodel.node_levels(ts.heap_size))


@pytest.mark.parametrize("d", BUILD_D)
@pytest.mark.parametrize("n", BUILD_N)
def test_builds_bit_identical(n, d):
    """build_jit, build and build_presort: node_point and split_val
    bit-identical to ``kdtree_tpu.build_jit``, and the invariants hold."""
    p = _uniform(n, d, 100 * n + d)
    jt = kt.build_jit(jnp.asarray(p))
    for fn in (tb.build_jit, tb.build, tp.build_presort):
        tt = fn(p, device="cpu")
        _same_classic(jt, tt)
        tb.validate_invariants(tt)


def _ties():
    rng = np.random.default_rng(9)
    lattice = rng.integers(0, 4, (900, 3)).astype(np.float32)
    dup = np.repeat(_uniform(50, 2, 3), 7, axis=0)
    zeros = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), (400, 2))
    zeros[:, 1] = rng.uniform(-1, 1, 400)
    return {"lattice": lattice, "duplicates": dup, "signed-zeros": zeros}


@pytest.mark.parametrize("case", sorted(_ties()))
def test_builds_bit_identical_under_ties(case):
    """Tie-heavy data: a lattice, duplicated rows, and a column holding
    both 0.0 and -0.0 (``lax.sort`` compares them equal, so the id breaks
    the tie)."""
    p = _ties()[case]
    assert case != "signed-zeros" or np.signbit(p[p[:, 0] == 0, 0]).any()
    jt = kt.build_jit(jnp.asarray(p))
    for fn in (tb.build_jit, tp.build_presort):
        tt = fn(p, device="cpu")
        _same_classic(jt, tt)
        tb.validate_invariants(tt)


def test_ordered_bits_orders_as_lax_sort():
    x = np.array([np.nan, 1.0, -0.0, 0.0, -np.inf, np.inf, -1.5, 2.0, -np.nan], np.float32)
    keys = tb.ordered_bits(torch.from_numpy(x))
    assert keys[2] == keys[3] and keys[0] == keys[8]  # -0.0 == 0.0, NaNs equal
    order = torch.sort(keys, stable=True).indices.numpy()
    np.testing.assert_array_equal(order, [4, 6, 2, 3, 1, 7, 5, 0, 8])


def test_validator_rejects_corruption():
    tt = tb.build_jit(_uniform(500, 3, 1), device="cpu")
    tb.validate_invariants(tt)
    sv = tt.split_val.clone()
    sv[0] = sv[0] + 50.0  # the root's split no longer separates its subtrees
    with pytest.raises(AssertionError):
        tb.validate_invariants(tmodel.KDTree(tt.points, tt.node_point, sv))
    npnt = tt.node_point.clone()
    npnt[3] = npnt[4]  # a point twice
    with pytest.raises(AssertionError, match="permutation"):
        tb.validate_invariants(tmodel.KDTree(tt.points, npnt, tt.split_val))


def _knn_pair(p, q, k):
    jt = kt.build_jit(jnp.asarray(p))
    tt = tb.build_jit(p, device="cpu")
    jd, ji = kt.knn(jt, jnp.asarray(q), k=k)
    st = tm.DfsStats()
    td, ti = tq.knn(tt, torch.from_numpy(q), k=k, stats=st)
    kk = min(k, p.shape[0])
    assert td.shape == ti.shape == (q.shape[0], kk)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(_bits(np.asarray(jd)), _bits(td.numpy()))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert st.steps % tm._ROUND_STEPS == 0 and st.syncs >= 1
    return td, ti


@pytest.mark.parametrize("d", [1, 3, 8, 33, 40])
def test_knn_equals_reference(d):
    """k in {1, 5, 16} and k > n, on 40 queries: XLA:CPU vectorizes all 40
    lanes, so every row takes the vector form at D <= 8 (the batch sizes
    of test_knn_lane_forms cover the scalar tail)."""
    p, q = _uniform(1500, d, d), _uniform(40, d, 50 + d)
    for k in (1, 5, 16):
        td, ti = _knn_pair(p, q, k)
    od, oi = tbf.knn(torch.from_numpy(p), torch.from_numpy(q), k=16)
    np.testing.assert_array_equal(oi.numpy(), ti.numpy())  # no ties in uniform data
    small = _uniform(6, d, 7)
    _knn_pair(small, q, 16)  # k > n


LANE_GRID = [pytest.param(rows, 3, id=str(rows))
             for rows in (1, 4, 5, 8, 13, 16, 19, 20, 23, 36, 37)] + \
    [pytest.param(rows, d, id=f"d{d}-{rows}")
     for d in (3, 4, 5, 8) for rows in (32, 36, 37, 44, 63, 64)
     if (rows, d) not in ((36, 3), (37, 3))]


@pytest.mark.parametrize("rows,d", LANE_GRID)
def test_knn_lane_forms(rows, d):
    """The batch sizes on both sides of each bound of
    ``_arith.xla_cpu_vector_rows``, and at D = 3, 4, 5 and 8 the lane counts
    where XLA:CPU's vector lanes depend on D (a vector epilogue of 4 lanes
    at 36-39 lanes from D = 4, at 44-47 from D = 5, at 60-63 from D = 7):
    the vector rows round each square, the scalar tail fuses them, and the
    answers equal the reference's."""
    p = _uniform(3000, d, 11)
    q = _uniform(rows, d, 12 + rows)
    _knn_pair(p, q, 16)


def test_knn_one_point_tree_and_ties():
    """A one-node tree (its only point's distance is fused at every D),
    and a tie-heavy lattice where ids must follow (distance, id)."""
    _knn_pair(_uniform(1, 3, 2), _uniform(40, 3, 3), 4)
    lat = _ties()["lattice"]
    q = np.random.default_rng(4).integers(0, 4, (40, 3)).astype(np.float32)
    _knn_pair(lat, q, 8)


def test_nearest_neighbor_equals_reference():
    p, q = _uniform(2000, 3, 21), _uniform(37, 3, 22)
    jd, ji = kt.nearest_neighbor(kt.build_jit(jnp.asarray(p)), jnp.asarray(q))
    td, ti = tq.nearest_neighbor(tb.build_jit(p, device="cpu"), q)
    assert td.shape == ti.shape == (37,)
    np.testing.assert_array_equal(_bits(np.asarray(jd)), _bits(td.numpy()))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_interop_carries_classic_and_bucket_trees():
    p = _uniform(700, 3, 31)
    jt = kt.build_jit(jnp.asarray(p))
    tt = tree_from_arrays(np.asarray(jt.points), np.asarray(jt.node_point),
                          np.asarray(jt.split_val), kind="classic", device="cpu")
    _same_classic(jt, tt)
    arrays = tree_to_arrays(tt)
    assert arrays.pop("kind") == "classic"
    _same_classic(jt, tree_from_arrays(**arrays, kind="classic", device="cpu"))
    jb = kt.build_bucket(jnp.asarray(p), bucket_cap=16)
    tbt = tree_from_arrays(*(np.asarray(c) for c in jb.tree_flatten()[0]),
                           jb.n_real, jb.num_levels, kind="bucket", device="cpu")
    for name, c in zip(tckpt.KINDS["bucket"][1], jb.tree_flatten()[0]):
        np.testing.assert_array_equal(_bits(np.asarray(c)), _bits(getattr(tbt, name).numpy()))
    with pytest.raises(TypeError, match="classic"):
        tree_from_arrays(np.asarray(jt.points), kind="classic", device="cpu")


def _same_arrays(jtree, ttree, kind):
    for name, c in zip(tckpt.KINDS[kind][1], type(jtree).tree_flatten(jtree)[0]):
        a, b = np.asarray(c), getattr(ttree, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for name in tckpt.KINDS[kind][2]:
        assert getattr(jtree, name) == getattr(ttree, name)


@pytest.mark.parametrize("kind", ["classic", "bucket"])
def test_checkpoints_cross_load(kind, tmp_path):
    """A classic or bucketed checkpoint written by either package loads in
    the other with the same arrays, aux ints and meta; the port writes
    the reference's file back key for key."""
    p = _uniform(900, 3, 41)
    if kind == "classic":
        jtree, ttree = kt.build_jit(jnp.asarray(p)), tb.build_jit(p, device="cpu")
    else:
        jtree = kt.build_bucket(jnp.asarray(p), bucket_cap=32)
        ttree = tbk.build_bucket(p, bucket_cap=32, device="cpu")
    meta = {"seed": 4, "generator": "threefry"}
    ref, port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jckpt.save_tree(ref, jtree, meta=meta)
    tckpt.save_tree(port, ttree, meta=meta)
    jl, jmeta = jckpt.load_tree(port)
    tl, tmeta = tckpt.load_tree(ref, device="cpu")
    assert type(tl) is type(ttree) and jmeta == tmeta == meta
    _same_arrays(jl, ttree, kind)
    _same_arrays(jtree, tl, kind)
    with np.load(ref) as a, np.load(port) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
        arrays = {key: a[key] for key in a.files}
    # NaN in a float array is corruption in both kinds (inf is padding)
    arrays["child_0"] = arrays["child_0"].copy()
    arrays["child_0"][0, 0] = np.nan
    np.savez(tmp_path / "nan.npz", **arrays)
    with pytest.raises(ValueError, match="corrupt"):
        tckpt.load_tree(str(tmp_path / "nan.npz"), device="cpu")


def test_legacy_checkpoint_loads_in_both(tmp_path):
    """The format without a ``kind``: a classic tree only."""
    p = _uniform(300, 2, 51)
    jt = kt.build_jit(jnp.asarray(p))
    path = str(tmp_path / "legacy.npz")
    np.savez(path, points=np.asarray(jt.points), node_point=np.asarray(jt.node_point),
             split_val=np.asarray(jt.split_val), meta_seed=np.asarray(3))
    jl, jmeta = jckpt.load_tree(path)
    tl, tmeta = tckpt.load_tree(path, device="cpu")
    assert isinstance(tl, tmodel.KDTree) and jmeta == tmeta == {"seed": 3}
    _same_classic(jl, tl)


def test_unported_checkpoint_kind_names_its_item(tmp_path):
    """The ``global`` kind, once refused with its ROADMAP item, loads: the
    reference's global tree checkpoint gives the port the same node heap,
    which answers as the reference's."""
    from kdtree_tpu.parallel import global_tree as jgt
    from kdtree_tpu.parallel import mesh as jmesh
    from kdtree_tpu_torch.parallel import global_tree as tgt

    p, q = _uniform(500, 3, 71), _uniform(12, 3, 72)
    path = str(tmp_path / "g.npz")
    jt = jgt.build_global(jnp.asarray(p), mesh=jmesh.make_mesh(2))
    jckpt.save_tree(path, jt)
    tt, meta = tckpt.load_tree(path, device="cpu")
    assert isinstance(tt, tgt.GlobalKDTree) and meta == {}
    for name in ("node_coords", "node_gid", "node_traversable"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)),
                                      getattr(tt, name).numpy())
    jd, ji = jgt.global_knn(jt, jnp.asarray(q), k=3)
    td, ti = tgt.global_knn(tt, q, k=3)
    np.testing.assert_array_equal(_bits(np.asarray(jd)), _bits(td.numpy()))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_classic_tree_serves_through_its_view():
    """``tree_for_serving`` turns a classic tree into its Morton view,
    which answers a served batch as the reference's does; a bucketed tree
    is refused with the reference's message."""
    p = _uniform(4000, 3, 61)
    jv = jlife.tree_for_serving(kt.build_jit(jnp.asarray(p)))
    tv = tserve.tree_for_serving(tb.build_jit(p, device="cpu"))
    assert isinstance(tv, tm.MortonTree) and tv.n_real == jv.n_real == 4000
    q = _uniform(64, 3, 62)
    je, te = jlife.ServeEngine(jv, 8), tserve.ServeEngine(tv, 8)
    jd, ji, _ = je.knn_batch(q)
    td, ti, _ = te.knn_batch(q)
    np.testing.assert_array_equal(np.asarray(jd), np.asarray(td))
    np.testing.assert_array_equal(np.asarray(ji), np.asarray(ti))
    bucket = tbk.build_bucket(p, device="cpu")
    with pytest.raises(TypeError, match="cannot serve a BucketKDTree checkpoint"):
        tserve.tree_for_serving(bucket)
    with pytest.raises(TypeError, match="cannot serve a BucketKDTree checkpoint"):
        jlife.tree_for_serving(kt.build_bucket(jnp.asarray(p)))


def test_serving_view_caches_and_remembers_over_budget():
    p = _uniform(500, 3, 71)
    tt = tb.build_jit(p, device="cpu")
    calls = []

    def inputs():
        calls.append(1)
        return dict(points=tt.points)

    v = tm.serving_view(tt, inputs)
    assert tm.serving_view(tt, inputs) is v and calls == [1]

    class Owner:
        pass

    def over():
        calls.append(2)
        raise tm.BuildCapacityError("too big")

    o = Owner()
    assert tm.serving_view(o, lambda: over() or {}) is None
    assert tm.serving_view(o, lambda: over() or {}) is None
    assert calls == [1, 2]


# --- the engine counters ----------------------------------------------------

_FAMILIES = ("kdtree_builds_total", "kdtree_build_points_total",
             "kdtree_queries_total", "kdtree_query_rows_total")


def _engine_counters(registry):
    return {k: v for k, v in registry.snapshot()["counters"].items()
            if k.split("{")[0] in _FAMILIES}


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def _drive_reference(p, q):
    mt = kt.build_morton(jnp.asarray(p), bucket_cap=64)
    kt.morton_knn(mt, jnp.asarray(q), k=3)
    jtq.morton_knn_tiled(mt, jnp.asarray(q), k=3)
    jbf.knn(jnp.asarray(p), jnp.asarray(q), k=3)
    ct = kt.build_jit(jnp.asarray(p))
    kt.knn(ct, jnp.asarray(q), k=3)
    bt = kt.build_bucket(jnp.asarray(p), bucket_cap=32)
    kt.bucket_knn(bt, jnp.asarray(q), k=3)


def _drive_port(p, q):
    mt = tm.build_morton(p, bucket_cap=64, device="cpu")
    tm.morton_knn(mt, q, k=3)
    ttq.morton_knn_tiled(mt, q, k=3)
    tbf.knn(torch.from_numpy(p), torch.from_numpy(q), k=3)
    ct = tb.build_jit(p, device="cpu")
    tq.knn(ct, q, k=3)
    bt = tbk.build_bucket(p, bucket_cap=32, device="cpu")
    tbk.bucket_knn(bt, q, k=3)


def test_engine_counters_equal_reference(monkeypatch):
    """The same builds and queries move the four engine counter families
    by the same amounts in both registries. With the port's two counting
    functions turned off — the port before they existed — the families
    differ, which is the fault this test guards."""
    p, q = _uniform(800, 3, 81), _uniform(24, 3, 82)
    jreg, treg = jobs.get_registry(), tobs.get_registry()

    j0 = _engine_counters(jreg)
    _drive_reference(p, q)
    want = _delta(j0, _engine_counters(jreg))
    assert want == {
        'kdtree_builds_total{engine="morton"}': 1.0,
        'kdtree_build_points_total{engine="morton"}': 800.0,
        'kdtree_queries_total{engine="morton"}': 1.0,
        'kdtree_query_rows_total{engine="morton"}': 24.0,
        'kdtree_queries_total{engine="tiled"}': 1.0,
        'kdtree_query_rows_total{engine="tiled"}': 24.0,
        'kdtree_queries_total{engine="bruteforce"}': 1.0,
        'kdtree_query_rows_total{engine="bruteforce"}': 24.0,
        'kdtree_builds_total{engine="tree"}': 1.0,
        'kdtree_build_points_total{engine="tree"}': 800.0,
        'kdtree_builds_total{engine="bucket"}': 1.0,
        'kdtree_build_points_total{engine="bucket"}': 800.0,
        'kdtree_queries_total{engine="bucket"}': 1.0,
        'kdtree_query_rows_total{engine="bucket"}': 24.0,
    }

    with monkeypatch.context() as mp:
        mp.setattr(tobs, "count_build", lambda engine, points: None)
        mp.setattr(tobs, "count_query", lambda engine, rows: None)
        t0 = _engine_counters(treg)
        _drive_port(p, q)
        assert _delta(t0, _engine_counters(treg)) != want

    t0 = _engine_counters(treg)
    _drive_port(p, q)
    assert _delta(t0, _engine_counters(treg)) == want
    from kdtree_tpu_torch.obs.export import METRIC_HELP

    from kdtree_tpu.obs.export import METRIC_HELP as JHELP
    for family in _FAMILIES:
        assert METRIC_HELP[family] == JHELP[family]


def test_row_forms_of_the_arithmetic():
    """``sq_dist_rows`` rounds each square in the vectorized lanes and
    fuses them in the scalar tail, up to 8 axes; above, it is sq_dist."""
    assert [_arith.xla_cpu_vector_rows(r, 3) for r in (1, 3, 4, 8, 12, 16, 19, 20, 31, 32, 39)] \
        == [0, 0, 4, 8, 0, 16, 16, 20, 28, 32, 32]
    # the lanes that depend on D (the classified exceptions to the rule)
    assert [_arith.xla_cpu_vector_rows(r, d) for r, d in (
        (31, 2), (31, 3), (37, 3), (37, 4), (44, 4), (44, 5), (44, 6), (63, 5), (63, 8),
        (127, 7), (128, 8))] == [24, 28, 32, 36, 40, 44, 40, 56, 60, 124, 128]
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.uniform(-100, 100, (19, 3)).astype(np.float32))
    p = torch.from_numpy(rng.uniform(-100, 100, (19, 3)).astype(np.float32))
    got = _arith.sq_dist_rows(q, p)
    np.testing.assert_array_equal(got[:16].numpy(),
                                  _arith.sq_sum_windows((q - p)[:16] ** 2).numpy())
    np.testing.assert_array_equal(got[16:].numpy(), _arith.sq_dist(q[16:], p[16:]).numpy())
    q9 = torch.from_numpy(rng.uniform(-100, 100, (19, 9)).astype(np.float32))
    np.testing.assert_array_equal(_arith.sq_dist_rows(q9, q9.flip(0)).numpy(),
                                  _arith.sq_dist(q9, q9.flip(0)).numpy())


def test_server_from_classic_checkpoint_answers_like_the_reference(tmp_path):
    """``serve --index classic.npz`` in process: each package loads the
    other's classic checkpoint, builds its server state (the tree's Morton
    view) and answers /v1/knn in the same bytes."""
    import json
    import urllib.request

    from kdtree_tpu.serve import server as jsrv
    from kdtree_tpu_torch.serve import server as tsrv

    p = _uniform(3000, 3, 91)
    ref, port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jckpt.save_tree(ref, kt.build_jit(jnp.asarray(p)))
    tckpt.save_tree(port, tb.build_jit(p, device="cpu"))
    jt, _ = jckpt.load_tree(port)
    tt, _ = tckpt.load_tree(ref, device="cpu")
    servers = [jsrv.make_server(jlife.build_state(tree=jt, k=4, max_batch=16,
                                                 install_listeners=False), port=0),
               tsrv.make_server(tserve.build_state(tree=tt, k=4, max_batch=16), port=0)]
    started = []
    try:
        for s in servers:
            s.start(warmup_buckets=[8, 16])
            started.append(s)
        body = json.dumps({"queries": _uniform(5, 3, 92).tolist(), "k": 4}).encode()
        answers = []
        for s in servers:
            req = urllib.request.Request(
                f"http://127.0.0.1:{s.server_address[1]}/v1/knn", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                out = json.loads(resp.read())
            out.pop("trace_id", None)
            answers.append(out)
        assert answers[0] == answers[1] and len(answers[1]["ids"]) == 5
    finally:
        for s in started:
            s.stop()
