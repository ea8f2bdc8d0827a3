"""The port's spatial partitioner and selective fan-out geometry
(``kdtree_tpu_torch/serve/spatial.py``) against ``kdtree_tpu``'s, on the
same seeded clouds in one process, with exact tolerance: the numpy Morton
coder bit for bit against the port's device coder, ``plan_partition``'s
bounds, code ranges, boxes and order equal to the reference's,
``owner_of`` and the wave selection equal, the selective merge
byte-identical to the full fan-out's over seeds, and ``partition
--device cpu`` writing the reference's shard arrays, ``PARTITION.json``
and manifest ``spatial`` blocks."""

import json

import numpy as np
import pytest
import torch

from kdtree_tpu.serve import spatial as jsp
from kdtree_tpu_torch.ops import morton as tm
from kdtree_tpu_torch.serve import spatial as tsp
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)


def _cloud(seed, n, dim, kind):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return (rng.random((n, dim)) * 200.0 - 100.0).astype(np.float32)
    centers = (rng.random((4, dim)) * 160.0 - 80.0).astype(np.float32)
    parts = [c + rng.normal(0.0, 3.0, (n // 4, dim)) for c in centers]
    return np.concatenate(parts).astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def test_default_bits_equals_the_device_rule():
    for dim in range(1, 41):
        assert tsp.default_bits_np(dim) == tm.default_bits(dim) == jsp.default_bits_np(dim)


@pytest.mark.parametrize("dim", [1, 2, 3, 5, 8])
def test_numpy_coder_bit_identical_to_the_port_coder(dim):
    """On the fleet's shared grid, rows outside it (clamped to the edge
    cells) and non-finite rows (the top cell) included."""
    pts = _cloud(dim, 4096, dim, "uniform")
    lo, hi = pts[:2048].min(axis=0), pts[:2048].max(axis=0)
    pts[5] = np.inf
    pts[6, 0] = np.nan
    bits = tm.default_bits(dim)
    device = tm.morton_codes(torch.from_numpy(pts), bits, lo=torch.from_numpy(lo),
                             hi=torch.from_numpy(hi)).numpy()
    host = tsp.morton_codes_np(pts, tsp.SpatialGrid(lo, hi, bits))
    assert host.dtype == np.uint32
    np.testing.assert_array_equal(device, host.astype(np.int64))
    np.testing.assert_array_equal(host, jsp.morton_codes_np(pts, jsp.SpatialGrid(lo, hi, bits)))


def _same_plan(jp, tp):
    np.testing.assert_array_equal(jp["order"], tp["order"])
    assert tp["order"].dtype == np.int64
    assert jp["bounds"] == tp["bounds"] and jp["code_ranges"] == tp["code_ranges"]
    assert jp["grid"].to_json() == tp["grid"].to_json()
    for (jlo, jhi), (tlo, thi) in zip(jp["boxes"], tp["boxes"]):
        np.testing.assert_array_equal(_bits(jlo), _bits(tlo))
        np.testing.assert_array_equal(_bits(jhi), _bits(thi))


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
@pytest.mark.parametrize("shards,dim,bits", [(3, 3, None), (4, 2, None), (5, 3, 6),
                                             (4, 5, None)])
def test_plan_partition_and_owner_of_equal_reference(kind, shards, dim, bits):
    pts = _cloud(10 + shards + dim, 3000, dim, kind)
    jp = jsp.plan_partition(pts, shards, bits=bits)
    tp = tsp.plan_partition(pts, shards, bits=bits)
    _same_plan(jp, tp)
    probe = np.concatenate([pts[::7], _cloud(99, 64, dim, "uniform") * 3.0])
    owners = tsp.owner_of(probe, tp["grid"], tp["code_ranges"])
    np.testing.assert_array_equal(owners, jsp.owner_of(probe, jp["grid"], jp["code_ranges"]))
    for i, (s, e) in enumerate(tp["bounds"]):
        assert (tsp.owner_of(pts[tp["order"][s:e]], tp["grid"], tp["code_ranges"]) == i).all()


def test_partition_edges_equal_reference():
    """A code value never splits across shards, a collapse is refused
    with the reference's error, and grids parse the same way."""
    pts = np.concatenate([np.zeros((100, 3)), np.ones((5, 3))]).astype(np.float32)
    assert tsp.plan_partition(pts, 2)["bounds"] == jsp.plan_partition(pts, 2)["bounds"] \
        == [(0, 100), (100, 105)]
    for bad in (np.ones((3000, 3), np.float32), np.zeros((3, 3), np.float32)):
        with pytest.raises(ValueError) as te:
            tsp.plan_partition(bad, 4 if len(bad) == 3 else 2)
        with pytest.raises(ValueError) as je:
            jsp.plan_partition(bad, 4 if len(bad) == 3 else 2)
        assert str(te.value) == str(je.value)
    for obj in ({"lo": [-1.0, 0.0], "hi": [2.0, 3.0], "bits": 8}, None, {},
                {"lo": [0], "hi": "x", "bits": 8}, {"lo": [], "hi": [], "bits": 8},
                {"lo": [0.0], "hi": [1.0], "bits": "wide"}):
        tg, jg = tsp.SpatialGrid.from_json(obj), jsp.SpatialGrid.from_json(obj)
        assert (tg is None) == (jg is None)
        assert tg is None or tg.to_json() == jg.to_json()


def test_wave_selection_equals_reference():
    rng = np.random.default_rng(3)
    pts = _cloud(3, 500, 3, "uniform")
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    queries = (rng.random((50, 3)) * 600.0 - 300.0).astype(np.float32)
    np.testing.assert_array_equal(_bits(tsp.box_lower_bounds(queries, lo, hi)),
                                  _bits(jsp.box_lower_bounds(queries, lo, hi)))
    a = (np.array([0.0, 0.0], np.float32), np.array([1.0, 1.0], np.float32))
    b = (np.array([-1.0, 0.5], np.float32), np.array([0.5, 2.0], np.float32))
    assert [x.tolist() for x in tsp.box_union([a, None, b])] == \
        [x.tolist() for x in jsp.box_union([a, None, b])]
    assert tsp.box_union([None]) is None
    z = np.zeros(2)
    for lbs in ([None, z + 1.0, z], [None, z + 5.0, z + 1.0], [z + 5.0, z + 1.0, z + 3.0], []):
        assert tsp.initial_wave(lbs) == jsp.initial_wave(lbs)
    lbs = [None, np.array([5.0, 5.0, 5.0, 0.5]), np.array([2.0, 9.0, 1.0, 1.0])]
    for worst, short in ((np.ones(4), np.zeros(4, bool)),
                         (np.array([1.0, 1.0, 1.0, np.inf]), np.array([0, 0, 0, 1], bool)),
                         (np.array([2.0, 1.0, 0.5, 3.0]), np.zeros(4, bool))):
        for target in (None, 0.5, 0.7, 0.9):
            assert tsp.widen_wave(lbs, [1, 2], worst, short, target) == \
                jsp.widen_wave(lbs, [1, 2], worst, short, target)


def _shard_topk(shard_pts, shard_ids, queries, k):
    """One shard's wire answer: top-k by (distance, id), f32 squared
    distances and their float64 sqrt, padded with (inf, -1)."""
    d2 = ((queries[:, None, :] - shard_pts[None, :, :]) ** 2).sum(axis=-1, dtype=np.float32)
    dist = np.sqrt(d2.astype(np.float64))
    out_d = np.full((queries.shape[0], k), np.inf)
    out_i = np.full((queries.shape[0], k), -1, dtype=np.int64)
    for qi in range(queries.shape[0]):
        for j, (d, i) in enumerate(sorted(zip(dist[qi].tolist(), shard_ids.tolist()))[:k]):
            out_d[qi, j], out_i[qi, j] = d, i
    return out_d, out_i


def _merge(answers, k):
    d = np.concatenate([a[0] for a in answers], axis=1)
    ids = np.concatenate([a[1] for a in answers], axis=1)
    out_d = np.full((d.shape[0], k), np.inf)
    out_i = np.full((d.shape[0], k), -1, dtype=np.int64)
    for qi in range(d.shape[0]):
        pairs = sorted((float(x), int(i)) for x, i in zip(d[qi], ids[qi]) if i >= 0)[:k]
        for j, (x, i) in enumerate(pairs):
            out_d[qi, j], out_i[qi, j] = x, i
    return out_d, out_i


def _selective(sp, pts, queries, k, shards, target=None):
    """The router's two waves with module ``sp``: (merged, contacted,
    unguaranteed, full fan-out)."""
    plan = sp.plan_partition(pts, shards)
    order = plan["order"]
    answers = [_shard_topk(pts[order[s:e]], np.arange(s, e), queries, k)
               for s, e in plan["bounds"]]
    lbs = [np.sqrt(sp.box_lower_bounds(queries, lo, hi).astype(np.float64))
           for lo, hi in plan["boxes"]]
    contacted = sp.initial_wave(lbs)
    rest = [i for i in range(shards) if i not in contacted]
    cut = 0
    if rest:
        md, mi = _merge([answers[i] for i in contacted], k)
        short = mi[:, k - 1] < 0
        wave2, cut = sp.widen_wave(lbs, rest, np.where(short, np.inf, md[:, k - 1]),
                                   short, target)
        contacted = sorted(set(contacted) | set(wave2))
    return _merge([answers[i] for i in contacted], k), len(contacted), cut, \
        _merge(answers, k)


@pytest.mark.parametrize("kind", ["clustered", "uniform"])
def test_selective_merge_byte_identical_to_full_fanout(kind):
    """Over seeds: the port's selective contact set merges to the full
    fan-out's bytes (ties included), contacts what the reference's
    does, and prunes on clustered clouds; a recall target stops earlier
    and keeps the batch's mean recall at or above it."""
    near, requests = 0, 0
    for seed in range(4):
        pts = _cloud(100 + seed, 1200, 3, kind)
        rng = np.random.default_rng(1000 + seed)
        batches = [(pts[s] + rng.normal(0, 0.5, 3)).astype(np.float32).reshape(1, 3)
                   for s in rng.integers(0, pts.shape[0], size=3)]
        batches.append((rng.random((4, 3)) * 300.0 - 150.0).astype(np.float32))
        for qi, q in enumerate(batches):
            (md, mi), m, cut, (fd, fi) = _selective(tsp, pts, q, 8, 4)
            assert cut == 0
            np.testing.assert_array_equal(mi, fi)
            np.testing.assert_array_equal(md, fd)
            assert m == _selective(jsp, pts, q, 8, 4)[1]
            if qi < 3:
                near, requests = near + m, requests + 1
        (_, mi), m_sel, _, (_, fi) = _selective(tsp, pts, batches[-1], 8, 4, target=0.75)
        recalls = [len(set(fi[r]) & set(mi[r])) / 8 for r in range(fi.shape[0])]
        assert m_sel <= 4 and np.mean(recalls) >= 0.75
    if kind == "clustered":
        assert near / requests <= 2


@pytest.fixture(scope="module")
def partitions(tmp_path_factory):
    """``partition --device cpu`` of the port and ``partition`` of the
    reference over the same seeded 4,096 x 3-D threefry cloud, 3 shards."""
    import contextlib
    import io

    from kdtree_tpu.utils import cli as jcli
    from kdtree_tpu_torch.utils import cli as tcli

    base = tmp_path_factory.mktemp("partition")
    args = ["partition", "--seed", "5", "--dim", "3", "--n", "4096", "--shards", "3",
            "--k", "4", "--max-batch", "8"]
    outs = {}
    for name, main, pre in (("port", tcli.main, ["--device", "cpu"]),
                            ("ref", jcli.main, ["--platform", "cpu"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            main(pre + args + ["--out-dir", str(base / name)])
        outs[name] = (base / name, out.getvalue())
    return outs


def test_partition_cli_equals_reference(partitions):
    from kdtree_tpu_torch import snapshot
    from kdtree_tpu_torch.utils.checkpoint import KINDS

    (tdir, tout), (jdir, jout) = partitions["port"], partitions["ref"]
    assert tout.replace(str(tdir), "D") == jout.replace(str(jdir), "D")
    assert tout.count("\nshard ") + tout.startswith("shard ") == 3
    tman = json.loads((tdir / "PARTITION.json").read_text())
    jman = json.loads((jdir / "PARTITION.json").read_text())
    for man, d in ((tman, tdir), (jman, jdir)):
        for e in man["entries"]:
            assert e.pop("dir") == str(d / f"shard-{e['shard']:02d}")
    assert tman == jman
    seen = 0
    for i in range(3):
        tt, tm_ = snapshot.load_snapshot(str(tdir / f"shard-{i:02d}"), device="cpu")
        jt, jm_ = snapshot.load_snapshot(str(jdir / f"shard-{i:02d}"), device="cpu")
        assert tm_["meta"]["spatial"] == jm_["meta"]["spatial"]
        assert tm_["meta"]["spatial"]["id_range"] == tman["entries"][i]["id_range"]
        assert (tm_["id_offset"], tm_["epoch"]) == (jm_["id_offset"], jm_["epoch"]) == (0, 0)
        assert tt.n_real == jt.n_real and tt.num_levels == jt.num_levels
        for name in KINDS["morton"][1]:
            a, b = getattr(tt, name).numpy(), getattr(jt, name).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=name)
        seen += tt.n_real
    assert seen == 4096


def test_partition_cli_rejects_one_shard(capsys):
    from kdtree_tpu_torch.utils import cli as tcli

    with pytest.raises(SystemExit) as e:
        tcli.main(["--device", "cpu", "partition", "--n", "64", "--shards", "1",
                   "--out-dir", "never-written"])
    assert e.value.code == 1 and "--shards must be >= 2" in capsys.readouterr().err
