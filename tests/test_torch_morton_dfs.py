"""The Morton DFS kernel's CPU account (``kdtree_tpu_torch/kernels/morton_dfs.py``).

The kernel (``csrc/morton_dfs.cu``) runs only on a card. Here its
step-for-step mirror, ``morton_dfs_mirror`` (one query at a time, in both
of the kernel's layouts: the walk and its windows of bounds, the survivor
filter, the bitonic sort of 32 candidates' survivors and their merge into
the (d2, position) selection by ranks, the block layout's join of its
warps' selections, the (d2, id) merge), is held bit-equal, d2 and ids, to
the plain lockstep loop (what the wrapper runs on a CPU tensor) and to
``kdtree_tpu.morton_knn`` on the same trees, built by the reference from
seeded numpy data and carried over by ``interop.tree_from_arrays``. The
fold alone is held against ``ops/topk.py::merge_topk`` on tie-heavy
blocks, the sort and the merge against a sorted union, and the layout
choice as a plain function.

Each distinct (tree shape, k) is one JAX compile of the DFS; the cases
share shapes where they can to keep that count small."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kdtree_tpu.ops import morton as jm
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.kernels import morton_dfs as md
from kdtree_tpu_torch.ops import morton as tm
from kdtree_tpu_torch.ops.topk import merge_topk

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

_TREES = {}


def _trees(name, p, bucket):
    if name not in _TREES:
        jt = jm.build_morton(jnp.asarray(p), bucket_cap=bucket)
        tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                              np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                              jt.n_real, jt.num_levels, device="cpu")
        _TREES[name] = (jt, tt)
    return _TREES[name]


def _uniform(d, n, nq, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-100, 100, (n, d)).astype(np.float32),
            rng.uniform(-100, 100, (nq, d)).astype(np.float32))


def _lattice():
    # ~40 copies of each of 125 integer sites, queries on sites and between
    rng = np.random.default_rng(7)
    p = rng.integers(-2, 3, (5000, 3)).astype(np.float32)
    q = np.concatenate([rng.integers(-2, 3, (60, 3)),
                        rng.integers(-4, 5, (30, 3)) + 0.5]).astype(np.float32)
    return p, q


def _duplicates():
    rng = np.random.default_rng(8)
    base = rng.uniform(-100, 100, (60, 3)).astype(np.float32)
    p = np.concatenate([base[rng.integers(0, 60, 4000)],
                        rng.uniform(-100, 100, (1000, 3)).astype(np.float32)])
    q = np.concatenate([base[:40], rng.uniform(-100, 100, (50, 3))]).astype(np.float32)
    return p, q


CLOUDS = {  # name -> (points, queries, bucket)
    "D=1": (*_uniform(1, 3000, 80, 1), 64),
    "D=3": (*_uniform(3, 5000, 120, 3), 64),
    "D=3 B=8": (*_uniform(3, 1500, 80, 4), 8),
    "D=8": (*_uniform(8, 3000, 80, 8), 64),
    "D=33": (*_uniform(33, 1500, 40, 33), 64),
    "lattice": (*_lattice(), 64),
    "duplicates": (*_duplicates(), 64),
    # trees of fewer levels than a window (kL = 5), exactly as many, one more
    "levels=4": (*_uniform(3, 100, 30, 100), 8),
    "levels=5": (*_uniform(3, 200, 30, 200), 8),
    "levels=6": (*_uniform(3, 300, 30, 300), 8),
}


_ANSWERS = {}


def _three_ways(name, k, layout, stats=None):
    """The reference's, the plain loop's (the wrapper on CPU tensors) and
    the mirror's answers in ``layout`` on one cloud, k clamped as
    morton_knn clamps it."""
    p, q, bucket = CLOUDS[name]
    jt, tt = _trees(name, p, bucket)
    if (name, k) not in _ANSWERS:
        jd, ji = jm.morton_knn(jt, jnp.asarray(q), k=k)
        st_ = tm.DfsStats()
        td, ti = tm.morton_knn(tt, torch.from_numpy(q), k=k, stats=st_)
        assert st_.launches == 0 and st_.chunks >= 1 and st_.syncs >= 1
        _ANSWERS[name, k] = (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())
    md_, mi = md.morton_dfs_mirror(tt, torch.from_numpy(q), min(k, tt.n_real), layout, stats)
    return (*_ANSWERS[name, k], (md_.numpy(), mi.numpy()))


def _equal(ref, plain, mirror):
    for got in (plain, mirror):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


LAYOUTS = pytest.mark.parametrize("layout", md.LAYOUTS)


@LAYOUTS
@pytest.mark.parametrize("name,k", [
    ("D=1", 16), ("D=3", 1), ("D=3", 16), ("D=3", 100), ("D=3 B=8", 16),
    ("D=8", 16), ("D=33", 16), ("D=33", 1)])
def test_mirror_matches_the_plain_loop_and_the_reference(name, k, layout):
    ref, plain, mirror = _three_ways(name, k, layout)
    _equal(ref, plain, mirror)
    assert np.isfinite(ref[0]).all()


@LAYOUTS
@pytest.mark.parametrize("name", ["lattice", "duplicates"])
def test_mirror_on_tie_heavy_clouds(name, layout):
    # nearly every distance is tied: ids depend on the (d2, position)
    # selection before the (d2, id) merge, which the mirror must keep
    ref, plain, mirror = _three_ways(name, 16, layout)
    _equal(ref, plain, mirror)
    assert (np.diff(ref[0], axis=1) == 0).mean() > 0.5


@LAYOUTS
@pytest.mark.parametrize("levels", [4, 5, 6])
def test_window_depths(levels, layout):
    # trees of fewer levels than a window (kL = 5), exactly as many, and one
    # more (two bands: the top band holds the root's two children alone)
    name = f"levels={levels}"
    stats = md.MirrorStats()
    ref, plain, mirror = _three_ways(name, 4, layout, stats)
    assert _trees(name, CLOUDS[name][0], CLOUDS[name][2])[1].num_levels == levels
    _equal(ref, plain, mirror)
    assert stats.window_loads >= 30  # one at least a query
    # a window of nl levels holds 2^(nl + 1) - 2 boxes: 30 or 62, and 2 for
    # the top band of a six-level tree
    per = {4: {30}, 5: {62}, 6: {62, 2}}[levels]
    assert stats.boxes_loaded <= max(per) * stats.window_loads


@LAYOUTS
def test_a_popped_sibling_outside_the_window(layout):
    # on 256 buckets of 8 rows the walk backtracks across the subtrees of
    # the lower band's windows: a band's window moves to another root, and
    # the bounds stay the reference's
    stats = md.MirrorStats()
    ref, plain, mirror = _three_ways("D=3 B=8", 16, layout, stats)
    _equal(ref, plain, mirror)
    assert stats.window_moves > 0 and stats.window_loads > stats.window_moves
    assert stats.expansions > stats.window_loads  # most expansions read a kept window
    assert stats.sorted_groups > 0 and stats.single_groups > 0
    if layout == "block":
        assert stats.joins > 0


@LAYOUTS
def test_the_lanes_least_keys_bound_a_batch(layout):
    # a first round's batch has more than 32 survivors: only keys at or
    # below the k-th smallest of the lanes' least keys go on to the merge
    stats = md.MirrorStats()
    ref, plain, mirror = _three_ways("D=3", 16, layout, stats)
    _equal(ref, plain, mirror)
    assert stats.bounded_batches > 0


def test_the_list_paths_past_one_chunk():
    # k = 100: the selection and the k-list are longer than one chunk of 32
    stats = md.MirrorStats()
    ref, plain, mirror = _three_ways("D=3", 100, "block", stats)
    _equal(ref, plain, mirror)
    assert stats.long_merges > 0 and stats.joins > 0


def test_the_lattice_tells_the_selection_rules_apart(monkeypatch):
    # the fold taken as "the k smallest by (d2, id)" over a round's
    # survivors gives the same distances but other ids on the lattice: the
    # (d2, position) selection before the merge is the reference's rule,
    # not a tie-break the kernel could drop
    p, q, bucket = CLOUDS["lattice"]
    _, tt = _trees("lattice", p, bucket)
    qt = torch.from_numpy(q)
    want = md.morton_dfs_mirror(tt, qt, 16)

    def by_id(kl, cd, ci, k, *layout_and_stats):
        worst = kl[-1][0]
        return sorted(kl + [(float(x), int(i)) for x, i in zip(cd, ci)
                            if x <= worst and x < float("inf")])[:k]

    monkeypatch.setattr(md, "fold_round", by_id)
    other = md.morton_dfs_mirror(tt, qt, 16)
    assert torch.equal(want[0], other[0])
    assert not torch.equal(want[1], other[1])


@LAYOUTS
def test_k_past_the_shared_list_and_past_n_real(layout):
    # k = 100 is past the 64 entries a shared-memory list holds; on a
    # 37-point tree of 8-point buckets, k = 50 leaves 13 slots (+inf, -1)
    rng = np.random.default_rng(9)
    p = rng.uniform(-100, 100, (37, 3)).astype(np.float32)
    q = torch.from_numpy(rng.uniform(-100, 100, (20, 3)).astype(np.float32))
    jt = jm.build_morton(jnp.asarray(p), bucket_cap=8)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    plain = md.morton_dfs(tt, q, 50)
    mirror = md.morton_dfs_mirror(tt, q, 50, layout)
    assert torch.equal(plain[0], mirror[0]) and torch.equal(plain[1], mirror[1])
    assert torch.isinf(mirror[0][:, 37:]).all() and (mirror[1][:, 37:] == -1).all()
    assert all(sorted(row[:37]) == list(range(37)) for row in mirror[1].tolist())
    jd, ji = jm.morton_knn(jt, jnp.asarray(q.numpy()), k=50)  # clamped to 37
    np.testing.assert_array_equal(np.asarray(jd), mirror[0][:, :37].numpy())
    np.testing.assert_array_equal(np.asarray(ji), mirror[1][:, :37].numpy())


@LAYOUTS
def test_single_point_and_no_queries(layout):
    rng = np.random.default_rng(10)
    p = rng.uniform(-100, 100, (1, 3)).astype(np.float32)
    q = torch.from_numpy(rng.uniform(-100, 100, (5, 3)).astype(np.float32))
    jt = jm.build_morton(jnp.asarray(p), bucket_cap=64)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    jd, ji = jm.morton_knn(jt, jnp.asarray(q.numpy()), k=1)
    md_, mi = md.morton_dfs_mirror(tt, q, 1, layout)
    np.testing.assert_array_equal(np.asarray(jd), md_.numpy())
    np.testing.assert_array_equal(np.asarray(ji), mi.numpy())
    assert (mi == 0).all()
    for fn in (md.morton_dfs, lambda t, q, k: md.morton_dfs_mirror(t, q, k, layout)):
        d, i = fn(tt, torch.zeros((0, 3)), 1)
        assert d.shape == (0, 1) and i.shape == (0, 1)


@LAYOUTS
def test_one_query(layout):
    p, q, bucket = CLOUDS["D=3"]
    jt, tt = _trees("D=3", p, bucket)
    jd, ji = jm.morton_knn(jt, jnp.asarray(q[:1]), k=16)
    plain = md.morton_dfs(tt, torch.from_numpy(q[:1]), 16)
    mirror = md.morton_dfs_mirror(tt, torch.from_numpy(q[:1]), 16, layout)
    _equal((np.asarray(jd), np.asarray(ji)), (plain[0].numpy(), plain[1].numpy()),
           (mirror[0].numpy(), mirror[1].numpy()))


def test_layout_for_is_a_plain_function_of_the_batch_and_the_card():
    wave = md.BLOCK_QUERIES_PER_SM * 132
    assert md.layout_for(1, 132) == md.layout_for(10, 132) == "block"
    assert md.layout_for(wave, 132) == "block" and md.layout_for(wave + 1, 132) == "warp"
    assert md.layout_for(4096, 132) == md.layout_for(65536, 132) == "warp"
    assert md.layout_for(wave + 1, 133) == "block"  # a bigger card holds more


def test_wrapper_checks_and_counts_on_the_cpu():
    p, q, bucket = CLOUDS["D=3 B=8"]
    _, tt = _trees("D=3 B=8", p, bucket)
    qt = torch.from_numpy(q)
    before = md.morton_dfs.launches
    st_ = tm.DfsStats()
    d, i = md.morton_dfs(tt, qt, 4, chunk=16, stats=st_)
    assert md.morton_dfs.launches == before  # the plain loop launches nothing
    assert st_.chunks == 5 and st_.launches == 0 and st_.syncs >= 5
    d1, i1 = md.morton_dfs(tt, qt, 4)  # the chunking does not change the answer
    assert torch.equal(d, d1) and torch.equal(i, i1)
    seen = (torch.zeros(tt.heap_size, dtype=torch.uint8),
            torch.zeros(tt.num_buckets, dtype=torch.uint8), torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        md.morton_dfs(tt, qt, 4, seen=seen)
    with pytest.raises(ValueError, match="CUDA tensors"):
        md.morton_dfs(tt, qt, 4, stamps=torch.zeros((len(qt), 6), dtype=torch.int64))
    with pytest.raises(ValueError, match="uint8"):
        md.morton_dfs(tt, qt, 4, seen=(seen[0].float(), *seen[1:]))
    with pytest.raises(ValueError, match="shape"):
        md.morton_dfs(tt, qt, 4, seen=(*seen[:2], torch.zeros(2, dtype=torch.int64)))
    with pytest.raises(ValueError, match="layout"):
        md.morton_dfs(tt, qt, 4, _layout="tile")
    for layout in md.LAYOUTS:  # the plain loop whatever the layout
        d2, i2 = md.morton_dfs(tt, qt, 4, _layout=layout)
        assert torch.equal(d, d2) and torch.equal(i, i2)
    with pytest.raises(ValueError, match="shape"):
        md.morton_dfs(tt, qt[:, :2].contiguous(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        md.morton_dfs(tt, qt.t().contiguous().t(), 4)
    with pytest.raises(ValueError, match="float32"):
        md.morton_dfs(tt, qt.double(), 4)
    with pytest.raises(ValueError, match="k must be"):
        md.morton_dfs(tt, qt, -1)


def _buffer(draw, k):
    """A k-buffer as the DFS holds it: ascending by (d2, id), +inf slots
    with id -1."""
    d = draw(st.lists(st.sampled_from([0.0, 1.0, 2.0, 3.0, float("inf")]),
                      min_size=k, max_size=k))
    i = draw(st.lists(st.integers(0, 7), min_size=k, max_size=k))
    pairs = sorted((x, -1 if x == float("inf") else y) for x, y in zip(d, i))
    return [x for x, _ in pairs], [y for _, y in pairs]


@st.composite
def _fold_case(draw):
    k = draw(st.integers(1, 6))
    best_d, best_i = _buffer(draw, k)
    m = draw(st.integers(1, 80))  # past 32: the block layout's warps share the round
    cd = draw(st.lists(st.sampled_from([0.0, 1.0, 2.0, 3.0, 4.0, float("inf")]),
                       min_size=m, max_size=m))
    ci = draw(st.lists(st.integers(-1, 9), min_size=m, max_size=m))
    return k, best_d, best_i, cd, ci


@LAYOUTS
@settings(max_examples=300, deadline=None)
@given(case=_fold_case())
def test_survivor_fold_matches_merge_topk(case, layout):
    # the kernel's fold (survivors d2 <= worst, the k smallest of them by
    # (d2, position), merged by (d2, id)) against the reference's (the
    # min(k, M) smallest of the whole block by (d2, position), then the
    # (d2, id) merge), on tied distances and +inf padding with any ids
    k, best_d, best_i, cd, ci = case
    want = merge_topk(torch.tensor(best_d, dtype=torch.float32),
                      torch.tensor(best_i, dtype=torch.int32),
                      torch.tensor(cd, dtype=torch.float32),
                      torch.tensor(ci, dtype=torch.int32), True)
    got = md.fold_round(list(zip(best_d, best_i)), np.asarray(cd, dtype=np.float32),
                        np.asarray(ci, dtype=np.int32), k, layout)
    assert [x for x, _ in got] == want[0].tolist()
    assert [y for _, y in got] == want[1].tolist()


@settings(max_examples=200, deadline=None)
@given(st.data())
def test_sort32_and_merge_group_give_the_sorted_union(data):
    # the network sorts any 32 keys (ties, KNONE sentinels); the merge by
    # ranks, in place from the top chunk down, keeps the k smallest of the
    # list and the group, ascending, with their ids
    k = data.draw(st.integers(1, 100))
    n = data.draw(st.integers(0, k))
    g = data.draw(st.integers(1, 32))
    pool = data.draw(st.lists(st.integers(0, 1 << 40), min_size=n + g, max_size=n + g,
                              unique=True))
    lst, grp = sorted(pool[:n]), pool[n:]
    keys, ids = md.sort32(grp + [md.KNONE] * (32 - g), list(range(32)))
    assert keys[:g] == sorted(grp) and keys[g:] == [md.KNONE] * (32 - g)
    assert [grp[i] for i in ids[:g]] == keys[:g]  # ids travel with their keys
    lk = lst + [0] * (k - n)
    li = [-x for x in lk]
    got = md.merge_group(lk, li, n, k, keys, [-x for x in keys], g)
    want = sorted(lst + grp)[:k]
    assert got == len(want) and lk[:got] == want and li[:got] == [-x for x in want]
