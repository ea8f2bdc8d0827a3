"""The port's closed auto-tune loop on the CPU: plan-store semantics
(signature quantization, hit against miss, corrupt and stale profiles,
the disabled store, no-op suppression, the scan/record merge), the
engine mismatch reading as a miss, warm runs with zero retries and the
same answers, explicit knobs never recorded, feedback, and the ``tune``
sweep (winner persisted, block sweep round trip, swept knobs kept, all
candidates overflowing). Where a case has a reference twin, the port's
answer is held against ``kdtree_tpu``'s on the same inputs."""

import json
import os

import numpy as np
import pytest
import torch

from kdtree_tpu.ops import tile_query as jtq
from kdtree_tpu.ops.generate import generate_points_rowwise as jgen
from kdtree_tpu.ops.morton import build_morton as jbuild
from kdtree_tpu_torch import tuning
from kdtree_tpu_torch.interop import tree_from_arrays
from kdtree_tpu_torch.ops import bruteforce
from kdtree_tpu_torch.ops import tile_query as tq
from kdtree_tpu_torch.ops.generate import generate_points_rowwise, generate_queries
from kdtree_tpu_torch.ops.morton import build_morton
from kdtree_tpu_torch.tuning import tuner
from kdtree_tpu_torch.tuning.store import PROFILE_VERSION, PlanStore, make_signature
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A test-isolated plan store, and the environment pointing at it, so
    the engine's own lookups see the same one."""
    d = str(tmp_path / "plans")
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", d)
    return PlanStore(d)


def _tree(seed, dim, n):
    return build_morton(generate_points_rowwise(seed, dim, n, device="cpu"),
                        device="cpu")


def _sig(Q, tree, k):
    return make_signature(Q, tree.dim, tree.n_real, k, tree.bucket_size,
                          tree.num_buckets, backend="cpu")


def test_signature_quantization():
    a = make_signature(1000, 3, 1 << 20, 16, 256, 4096, backend="cpu")
    assert a.q_bucket == 1024 and a.n_bucket == 1 << 20
    b = make_signature(513, 3, (1 << 20) - 5, 16, 256, 4096, backend="cpu")
    assert a.key == b.key
    for other in (make_signature(1000, 3, 1 << 20, 8, 256, 4096, backend="cpu"),
                  make_signature(1000, 2, 1 << 20, 16, 256, 4096, backend="cpu"),
                  make_signature(1000, 3, 1 << 20, 16, 256, 4096, devices=8,
                                 backend="cpu"),
                  make_signature(1000, 3, 1 << 20, 16, 256, 4096, backend="cuda")):
        assert other.key != a.key


def test_store_hit_vs_miss(store):
    sig = make_signature(1024, 3, 4096, 4, 256, 16, backend="cpu")
    assert store.get(sig) is None
    assert store.put(sig, {"tile": 64, "cmax": 32, "seeds": 8})
    prof = store.get(sig)
    assert prof["tile"] == 64 and prof["cmax"] == 32
    assert tuning.lookup(sig, store=store)["tile"] == 64
    assert store.get(make_signature(1024, 3, 4096, 9, 256, 16, backend="cpu")) is None


def test_store_tolerates_corrupt_and_stale(store):
    sig = make_signature(512, 2, 1024, 1, 128, 8, backend="cpu")
    os.makedirs(store.cache_dir, exist_ok=True)
    for body in ("{not json",
                 json.dumps({"version": PROFILE_VERSION - 1, "tile": 64,
                             "cmax": 32, "seeds": 8}),
                 json.dumps({"version": PROFILE_VERSION, "tile": 0, "cmax": 32,
                             "seeds": 8})):
        with open(store.path_for(sig), "w") as f:
            f.write(body)
        assert store.get(sig) is None
        assert tuning.lookup(sig, store=store) is None
    # a plan over a corrupt profile is the heuristic one
    with open(store.path_for(sig), "w") as f:
        f.write("{not json")
    assert tq.plan_tiled(512, 2, 1024, 8, 128, 1, device="cpu").source == "heuristic"


def test_store_disabled_by_env(monkeypatch):
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", "none")
    s = PlanStore()
    assert not s.enabled
    sig = make_signature(512, 3, 1024, 1, 128, 8, backend="cpu")
    assert s.get(sig) is None and not s.put(sig, {"tile": 8})
    assert tuning.lookup(sig) is None and not s.record(sig, tile=8)
    assert list(s.scan()) == []


def test_record_suppresses_noop_rewrites_and_scan_lists(store):
    sig = make_signature(256, 3, 512, 2, 128, 4, backend="cpu")
    assert store.record(sig, tile=32, cmax=16, seeds=8)
    first = os.stat(store.path_for(sig)).st_mtime_ns
    assert not store.record(sig, tile=32, cmax=16, seeds=8)
    assert os.stat(store.path_for(sig)).st_mtime_ns == first
    assert store.record(sig, cmax=32)
    assert store.get(sig)["cmax"] == 32 and store.get(sig)["tile"] == 32
    # an advisory-only profile (no launch knobs) is merged over, not lost
    cal = make_signature(8, 3, 512, 2, 128, 4, backend="cpu")
    assert store.record(cal, recall_caps={"0.9": 4})
    assert store.get(cal) is None and tuning.profile_for(cal, store=store)
    assert store.record(cal, tile=8, cmax=4, seeds=8)
    assert store.get(cal)["recall_caps"] == {"0.9": 4}
    with open(os.path.join(store.cache_dir, "plan-junk.json"), "w") as f:
        f.write("[]")
    listed = {s["q_bucket"]: p for s, p in store.scan()}
    assert set(listed) == {256, 8} and listed[256]["cmax"] == 32


def test_engine_mismatch_reads_as_miss(store):
    """A profile the CUDA kernel settled is not the plain scan's, and a
    CPU plan never reads a CUDA-keyed one."""
    sig = make_signature(2048, 3, 16000, 4, 256, 64, backend="cpu")
    store.put(sig, {"tile": 128, "cmax": 32, "seeds": 8, "use_kernel": True})
    assert tuning.lookup(sig, use_kernel=False, store=store) is None
    assert tuning.lookup(sig, use_kernel=True, store=store) is not None
    assert tq.plan_tiled(2048, 3, 16000, 64, 256, 4, device="cpu").source == "heuristic"
    store.put(sig, {"tile": 128, "cmax": 32, "seeds": 8, "use_kernel": False})
    plan = tq.plan_tiled(2048, 3, 16000, 64, 256, 4, device="cpu")
    assert plan.source == "warm" and plan.tile == 128 and plan.sig == sig
    cuda = make_signature(4096, 3, 16000, 4, 256, 64, backend="cuda")
    store.put(cuda, {"tile": 128, "cmax": 32, "seeds": 8, "use_kernel": False})
    assert tq.plan_tiled(4096, 3, 16000, 64, 256, 4, device="cpu").source == "heuristic"


def test_warm_plan_knobs_match_reference(store, monkeypatch, tmp_path):
    """The same stored profile gives both packages the same warm plan."""
    monkeypatch.setenv("KDTREE_TPU_PLAN_CACHE", str(tmp_path / "ref"))
    from kdtree_tpu.tuning.store import PlanStore as JStore
    from kdtree_tpu.tuning.store import make_signature as jsig

    prof = {"tile": 128, "cmax": 32, "seeds": 4, "v": 1, "tb": 4}
    store.put(make_signature(2048, 3, 16000, 4, 256, 64, backend="cpu"),
              dict(prof, use_kernel=False))
    JStore().put(jsig(2048, 3, 16000, 4, 256, 64, backend="cpu"),
                 dict(prof, use_pallas=False))
    jp = jtq.plan_tiled(2048, 3, 16000, 64, 256, 4)
    tp = tq.plan_tiled(2048, 3, 16000, 64, 256, 4, device="cpu")
    assert jp.source == tp.source == "warm"
    assert tuple(jp)[:7] == tuple(tp)[:7]


def test_warm_run_zero_retries_identical_results(store, monkeypatch):
    pts = generate_points_rowwise(3, 3, 20000, device="cpu")
    qs = generate_queries(31, 3, 1500, device="cpu")
    tree = build_morton(pts, device="cpu")
    # the heuristic undersizes the cap, so the cold run must retry
    monkeypatch.setattr(tq, "_auto_tile", lambda *a, **kw: (64, 2))
    cold = tq.TileStats()
    d2c, gic = tq.morton_knn_tiled(tree, qs, k=8, stats=cold)
    assert cold.retries > 0, "setup failed: the cold run never overflowed"
    prof = store.get(_sig(1500, tree, 8))
    assert prof is not None and prof["cmax"] > 2 and prof["source"] == "feedback"
    assert prof["use_kernel"] is False
    plan = tq.plan_tiled(1500, 3, tree.n_real, tree.num_buckets,
                         tree.bucket_size, 8, device="cpu")
    assert plan.source == "warm" and plan.cmax == prof["cmax"]
    warm = tq.TileStats()
    d2w, giw = tq.morton_knn_tiled(tree, qs, k=8, stats=warm)
    assert warm.retries == 0
    assert torch.equal(d2c, d2w) and torch.equal(gic, giw)
    bd, bi = bruteforce.knn(pts, qs, k=8)
    assert torch.equal(bd, d2w) and torch.equal(bi, giw)


def test_warm_plan_survives_stale_cap(store):
    tree = _tree(5, 2, 8000)
    qs = generate_queries(51, 2, 600, device="cpu")
    sig = _sig(600, tree, 6)
    assert store.put(sig, {"tile": 16, "cmax": 1, "seeds": 4})
    d2, ids = tq.morton_knn_tiled(tree, qs, k=6)
    pts = generate_points_rowwise(5, 2, 8000, device="cpu")
    bd, bi = bruteforce.knn(pts, qs, k=6)
    assert torch.equal(d2, bd) and torch.equal(ids, bi)
    assert store.get(sig)["cmax"] > 1  # the settled cap replaced the stale one


def test_explicit_knobs_never_recorded(store):
    tree = _tree(7, 3, 4000)
    qs = generate_queries(71, 3, 512, device="cpu")
    tq.morton_knn_tiled(tree, qs, k=3, tile=8, cmax=4)
    tq.morton_knn_tiled(tree, qs, k=3, cmax=4)  # a cmax hint is an override
    tq.morton_knn_tiled(tree, qs, k=3, use_kernel=False)  # so is a forced engine
    tq.morton_knn_tiled(tree, qs, k=3, visit_cap=2)  # and a capped run
    assert store.get(_sig(512, tree, 3)) is None
    assert not os.path.isdir(store.cache_dir) or not os.listdir(store.cache_dir)


def test_feedback_settled_merges_and_keeps_block_knobs(store):
    sig = make_signature(2048, 3, 16000, 4, 256, 64, backend="cpu")
    base = {"tile": 128, "cmax": 32, "seeds": 8, "use_kernel": False}
    store.put(sig, dict(base, v=1, tb=4))
    plan = tq.plan_tiled(2048, 3, 16000, 64, 256, 4, device="cpu")
    assert plan.source == "warm" and (plan.v, plan.tb) == (1, 4)
    fb = tuning.feedback_for(plan, store=store)
    fb.settled(cmax=48, retries=0)
    prof = store.get(sig)
    assert prof["cmax"] == 48 and (prof["v"], prof["tb"]) == (1, 4)
    assert prof["source"] == "feedback"
    store.put(sig, dict(base, v="wide", tb=0))  # unusable block knobs
    plan = tq.plan_tiled(2048, 3, 16000, 64, 256, 4, device="cpu")
    assert plan.source == "warm" and plan.v >= 1 and plan.tb >= 1
    explicit = tq.plan_tiled(2048, 3, 16000, 64, 256, 4, tile=64, device="cpu")
    assert explicit.source == "explicit" and tuning.feedback_for(explicit) is None


def test_warm_block_knobs_dropped_when_tile_clamped(store):
    sig = make_signature(64, 3, 16000, 4, 256, 64, backend="cpu")
    store.put(sig, {"tile": 64, "cmax": 32, "seeds": 8, "use_kernel": False,
                    "v": 1, "tb": 2})
    plan = tq.plan_tiled(40, 3, 16000, 64, 256, 4, device="cpu")
    assert plan.source == "warm" and plan.tile == 40
    assert plan.v * 256 + 4 > tq._EXTRACT_W_MAX
    plan = tq.plan_tiled(64, 3, 16000, 64, 256, 4, device="cpu")
    assert (plan.tile, plan.v, plan.tb) == (64, 1, 1)


def test_drive_batches_warm_skips_settle_probe():
    calls = []

    def run_batch(b0, cap):
        calls.append((b0, cap))
        return torch.zeros((2, 1)), torch.zeros((2, 1), dtype=torch.int32), \
            torch.tensor(False)

    tq.drive_batches(run_batch, [0, 2, 4], cmax=8, nbp=64, settle_first=False)
    assert calls == [(0, 8), (2, 8), (4, 8)], calls


def test_tuner_sweep_persists_winner(store):
    tree = _tree(11, 3, 8000)
    qs = generate_queries(13, 3, 1024, device="cpu")
    out = tuner.sweep(tree, qs, k=4, tiles=(64, 256), cmaxs=(16, 32),
                      sweep_blocks=False, store=store)
    assert len(out["results"]) == 4 and out["block_results"] == []
    assert out["persisted"] and os.path.exists(out["path"])
    prof = store.get(_sig(1024, tree, 4))
    assert prof["source"] == "tune" and prof["use_kernel"] is False
    assert prof["tile"] == out["winner"]["tile"]
    plan = tq.plan_tiled(1024, 3, tree.n_real, tree.num_buckets,
                         tree.bucket_size, 4, device="cpu")
    assert plan.source == "warm" and plan.tile == out["winner"]["tile"]
    d2, ids = tq.morton_knn_tiled(tree, qs, k=4)
    bd, bi = bruteforce.knn(generate_points_rowwise(11, 3, 8000, device="cpu"),
                            qs, k=4)
    assert torch.equal(d2, bd) and torch.equal(ids, bi)


def test_tuner_block_sweep_roundtrips_through_store(store):
    tree = _tree(11, 3, 8000)
    qs = generate_queries(13, 3, 1024, device="cpu")
    out = tuner.sweep(tree, qs, k=4, tiles=(128,), cmaxs=(tree.num_buckets,),
                      vs=(1,), tbs=(2,), store=store)
    assert len(out["block_results"]) == 1
    assert (out["block_results"][0]["v"], out["block_results"][0]["tb"]) == (1, 2)
    assert out["persisted"]
    prof = store.get(_sig(1024, tree, 4))
    plan = tq.plan_tiled(1024, 3, tree.n_real, tree.num_buckets,
                         tree.bucket_size, 4, device="cpu")
    assert plan.source == "warm"
    if out["winner"]["v"] is not None:
        assert (prof["v"], prof["tb"]) == (1, 2) and (plan.v, plan.tb) == (1, 2)
    else:
        assert "v" not in prof and "tb" not in prof


def test_tuner_no_block_sweep_preserves_swept_knobs(store):
    tree = _tree(11, 3, 8000)
    qs = generate_queries(13, 3, 1024, device="cpu")
    sig = _sig(1024, tree, 4)
    store.put(sig, {"tile": 128, "cmax": 16, "seeds": 8, "use_kernel": False,
                    "v": 1, "tb": 2})
    out = tuner.sweep(tree, qs, k=4, tiles=(128,), cmaxs=(tree.num_buckets,),
                      sweep_blocks=False, store=store)
    assert out["persisted"] and out["winner"]["v"] is None
    assert (store.get(sig)["v"], store.get(sig)["tb"]) == (1, 2)
    store.put(sig, {"tile": 64, "cmax": int(tree.num_buckets), "seeds": 8,
                    "use_kernel": False, "v": 1, "tb": 2})
    out = tuner.sweep(tree, qs, k=4, tiles=(128,), cmaxs=(tree.num_buckets,),
                      sweep_blocks=False, store=store)
    assert out["persisted"] and out["winner"]["tile"] == 128
    assert "v" not in store.get(sig) and "tb" not in store.get(sig)
    store.put(sig, {"tile": 128, "cmax": int(tree.num_buckets), "seeds": 8,
                    "use_kernel": False, "v": 4, "tb": 8})
    out = tuner.sweep(tree, qs, k=4, tiles=(128,), cmaxs=(tree.num_buckets,),
                      vs=(1,), tbs=(2,), store=store)
    assert {(r["v"], r["tb"]) for r in out["block_results"]} == {(1, 2), (4, 8)}


def test_tuner_all_overflow_persists_nothing(store):
    tree = _tree(17, 3, 8000)
    qs = generate_queries(19, 3, 512, device="cpu")
    out = tuner.sweep(tree, qs, k=8, tiles=(32,), cmaxs=(1,), store=store)
    assert out["results"][0]["overflow_retries"] > 0
    assert not out["persisted"] and "overflow" in out["reason"]
    assert store.get(_sig(512, tree, 8)) is None


def test_tuned_tiled_run_matches_reference(store):
    """After a tune, the warm port run answers as the reference's run on
    the same tree and plan."""
    raw = jgen(11, 3, 8000)
    jt = jbuild(raw)
    tt = tree_from_arrays(np.asarray(jt.node_lo), np.asarray(jt.node_hi),
                          np.asarray(jt.bucket_pts), np.asarray(jt.bucket_gid),
                          jt.n_real, jt.num_levels, device="cpu")
    qs = generate_queries(13, 3, 1024, device="cpu")
    out = tuner.sweep(tt, qs, k=4, tiles=(64, 128), cmaxs=(32,),
                      sweep_blocks=False, store=store)
    assert out["persisted"]
    plan = tq.plan_tiled(1024, 3, tt.n_real, tt.num_buckets, tt.bucket_size, 4,
                         device="cpu")
    assert plan.source == "warm"
    td, ti = tq.morton_knn_tiled(tt, qs, k=4)
    jd, ji = jtq.morton_knn_tiled(jt, qs.numpy(), k=4, tile=plan.tile,
                                  cmax=plan.cmax, use_pallas=False)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
