"""The port's serving snapshots against kdtree_tpu's, on the CPU, on the
same seeded points: the round trip is bit-identical and answers like a
fresh build; a snapshot written by either package loads into the other
with the same manifest keys, and a server over it answers the same bytes
as the other package's server; versions, retention GC and rollback;
corrupt, truncated, schema-skewed and missing segments each raise their
named error and count it; the epoch-swap sink (and a failing one); the
blue/green follower; the read-only replica's 403 and /healthz blocks;
plan-profile seeding; and ``serve --snapshot`` falling back to
``--points`` on a corrupt snapshot."""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from kdtree_tpu import snapshot as jsnap
from kdtree_tpu.ops.generate import generate_points_rowwise as jgen
from kdtree_tpu.ops.morton import build_morton as jbuild
from kdtree_tpu.serve import lifecycle as jlife
from kdtree_tpu.serve import server as jsrv
from kdtree_tpu_torch import snapshot as snap
from kdtree_tpu_torch.interop import tree_to_arrays
from kdtree_tpu_torch.mutable.engine import MutableEngine
from kdtree_tpu_torch.obs import flight as tflight
from kdtree_tpu_torch.obs.registry import get_registry
from kdtree_tpu_torch.ops.generate import generate_points_rowwise
from kdtree_tpu_torch.ops.morton import build_morton
from kdtree_tpu_torch.ops.tile_query import morton_knn_tiled
from kdtree_tpu_torch.serve import engine as tlife
from kdtree_tpu_torch.serve import server as tsrv
from kdtree_tpu_torch.snapshot import SnapshotFollower
from kdtree_tpu_torch.tuning.store import PlanSignature, default_store, make_signature
from torch_plan_store import isolated_torch_plan_store  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DIM, K, N = 3, 4, 4096
SEED = 11
_ARRAYS = ("node_lo", "node_hi", "bucket_pts", "bucket_gid")


@pytest.fixture(autouse=True)
def _port_plan_cache(tmp_path, monkeypatch):
    """The port's plan store under this test's tmp dir (tests/conftest.py
    isolates only the reference's), and the port's flight dump limiter
    reset."""
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    tflight.recorder().reset_dump_rate_limit()
    yield


@pytest.fixture(scope="module")
def points():
    return generate_points_rowwise(SEED, DIM, N, device="cpu").numpy()


@pytest.fixture(scope="module")
def tree(points):
    return build_morton(torch.from_numpy(points), device="cpu")


@pytest.fixture(scope="module")
def jtree():
    return jbuild(jgen(SEED, DIM, N))


def _tiled(tree, queries, k=K):
    d2, ids = morton_knn_tiled(tree, torch.from_numpy(np.asarray(queries)), k=k)
    return d2.numpy(), ids.numpy()


def _arrays(t):
    return {a: np.asarray(getattr(t, a)) for a in _ARRAYS}


def _counter_value(name: str) -> float:
    return sum(v for key, v in get_registry().snapshot()["counters"].items()
               if key.startswith(name))


def _corrupt_segment(d, name="bucket_pts", offset=512):
    seg = [f for f in os.listdir(d) if f.startswith(f"seg-{name}-")][0]
    with open(os.path.join(d, seg), "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))
    return os.path.join(d, seg)


# ---------------------------------------------------------------------------
# round trip, and across packages
# ---------------------------------------------------------------------------


def test_roundtrip_bit_identical_arrays_and_answers(tree, points, tmp_path):
    d = str(tmp_path / "snap")
    man = snap.save_snapshot(d, tree, epoch=0, plan_keys=snap.plan_keys_for(tree, K))
    assert man["version"] == 1 and man["signature"]["n_real"] == N
    assert man["plan_keys"] and all(k.endswith("-cpu-p1") for k in man["plan_keys"])
    loaded, man2 = snap.load_snapshot(d, device="cpu")
    assert man2["version"] == 1
    for a in _ARRAYS:
        assert torch.equal(getattr(tree, a), getattr(loaded, a)), a
        # a private copy, never an alias of the read-only mmap
        assert getattr(loaded, a).numpy().flags.writeable, a
    assert (loaded.n_real, loaded.num_levels) == (tree.n_real, tree.num_levels)
    # a fresh build over the same points answers the same bytes
    fresh = build_morton(torch.from_numpy(points), device="cpu")
    q = points[:64]
    for a, b in zip(_tiled(fresh, q), _tiled(loaded, q)):
        assert np.array_equal(a, b)
    ev = [e for e in tflight.recorder().snapshot() if e["type"] == "snapshot.load"]
    assert ev and {"verify_seconds", "copy_seconds"} <= set(ev[-1])


def test_version_increments_and_stale_segments_cleaned(tree, tmp_path):
    d = str(tmp_path / "snap")
    snap.save_snapshot(d, tree, epoch=0)
    man2 = snap.save_snapshot(d, tree, epoch=1)
    assert man2["version"] == 2 and man2["epoch"] == 1
    assert len([f for f in os.listdir(d) if f.startswith("seg-")]) == len(_ARRAYS)
    assert snap.load_snapshot(d, device="cpu")[1]["version"] == 2


@contextlib.contextmanager
def _servers(jt, tt):
    """A reference server over ``jt`` and a port server over ``tt``."""
    js = jsrv.make_server(jlife.build_state(tree=jt, k=K, max_batch=16,
                                            install_listeners=False), port=0)
    ts = tsrv.make_server(tlife.build_state(tree=tt, k=K, max_batch=16), port=0)
    started = []
    try:
        for s in (js, ts):
            s.start(warmup_buckets=[8, 16])
            started.append(s)
        yield js, ts
    finally:
        for s in started:
            s.stop()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        out = json.loads(resp.read())
    out.pop("trace_id", None)
    return out


@pytest.mark.parametrize("writer", ["kdtree_tpu", "kdtree_tpu_torch"])
def test_snapshots_load_across_packages(writer, jtree, tree, points, tmp_path):
    """A snapshot written by one package loads into the other: the same
    manifest keys and segment layout, arrays bit-identical, and servers
    over the two loaded trees answer /v1/knn and /v1/radius in the same
    bytes."""
    d = str(tmp_path / "x")
    jd = str(tmp_path / "ref")
    if writer == "kdtree_tpu":
        man = jsnap.save_snapshot(d, jtree, epoch=2, id_offset=0,
                                  plan_keys=jsnap.plan_keys_for(jtree, K))
        other = snap.save_snapshot(jd, tree, epoch=2,
                                   plan_keys=snap.plan_keys_for(tree, K))
    else:
        man = snap.save_snapshot(d, tree, epoch=2, id_offset=0,
                                 plan_keys=snap.plan_keys_for(tree, K))
        other = jsnap.save_snapshot(jd, jtree, epoch=2,
                                    plan_keys=jsnap.plan_keys_for(jtree, K))
    assert set(man) == set(other)
    assert man["signature"] == other["signature"]
    assert man["plan_keys"] == other["plan_keys"]  # both CPU backends
    for name in _ARRAYS:
        a, b = man["segments"][name], other["segments"][name]
        assert (a["sha256"], a["bytes"], a["shape"], a["dtype"]) == \
            (b["sha256"], b["bytes"], b["shape"], b["dtype"]), name
    tt, tman = snap.load_snapshot(d, device="cpu")
    jt, jman = jsnap.load_snapshot(d)
    assert tman == jman
    for name, arr in _arrays(jt).items():
        assert np.array_equal(tree_to_arrays(tt)[name], arr), name
    q = points[:6] + np.float32(0.25)
    with _servers(jt, tt) as (js, ts):
        for path, body in (("/v1/knn", {"queries": q.tolist(), "k": 3}),
                           ("/v1/radius", {"queries": q.tolist(), "r": 9.0}),
                           ("/v1/count", {"lo": (q - 6).tolist(), "hi": (q + 6).tolist()})):
            want = _post(js.server_address[1], path, body)
            got = _post(ts.server_address[1], path, body)
            assert json.dumps(got) == json.dumps(want), path
        assert sum(want["counts"]) > 0


def test_resolve_dir_env_isolation(monkeypatch, tmp_path):
    monkeypatch.setenv("KDTREE_TPU_SNAPSHOT_DIR", str(tmp_path))
    assert snap.resolve_dir("rel/a") == str(tmp_path / "rel" / "a")
    assert snap.resolve_dir("/abs/a") == "/abs/a"
    monkeypatch.setenv("KDTREE_TPU_SNAPSHOT_DIR", "relbase")
    once = snap.resolve_dir("rel/a")
    assert os.path.isabs(once) and snap.resolve_dir(once) == once
    assert once == jsnap.resolve_dir("rel/a")
    monkeypatch.delenv("KDTREE_TPU_SNAPSHOT_DIR")
    assert snap.resolve_dir("rel/a") == "rel/a"


def test_snapshot_rejects_non_morton(tmp_path):
    with pytest.raises(TypeError, match="Morton"):
        snap.save_snapshot(str(tmp_path / "s"), object())


# ---------------------------------------------------------------------------
# corruption: named errors, counted
# ---------------------------------------------------------------------------


def _skew_schema(d):
    mp = os.path.join(d, snap.MANIFEST_NAME)
    man = json.load(open(mp))
    man["schema"] = snap.SNAPSHOT_SCHEMA + 1
    json.dump(man, open(mp, "w"))


def _truncate(d):
    seg = [f for f in os.listdir(d) if f.startswith("seg-bucket_gid")][0]
    path = os.path.join(d, seg)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _drop_segment(d):
    seg = [f for f in os.listdir(d) if f.startswith("seg-node_lo")][0]
    os.remove(os.path.join(d, seg))


@pytest.mark.parametrize("damage,err,match,reason", [
    (_corrupt_segment, "SnapshotCorruptError", "sha256", "checksum"),
    (_truncate, "SnapshotCorruptError", "truncated|bytes", "checksum"),
    (_skew_schema, "SnapshotSchemaError", "schema", "schema"),
    (_drop_segment, "SnapshotCorruptError", "copied as a set", "segment"),
    (lambda d: os.remove(os.path.join(d, snap.MANIFEST_NAME)), "SnapshotError",
     "manifest", "missing"),
])
def test_damaged_snapshot_named_error_and_counter(damage, err, match, reason, tree, jtree,
                                                  tmp_path):
    """Each damage raises the same named error class in both packages, and
    bumps the port's load-error counter under the reference's reason."""
    key = f'kdtree_snapshot_load_errors_total{{reason="{reason}"}}'
    for pkg, t in ((snap, tree), (jsnap, jtree)):
        d = str(tmp_path / pkg.__name__)
        pkg.save_snapshot(d, t)
        damage(d)
        before = _counter_value(key)
        with pytest.raises(getattr(pkg, err), match=match):
            if pkg is snap:
                snap.load_snapshot(d, device="cpu")
            else:
                jsnap.load_snapshot(d)
        if pkg is snap:
            assert _counter_value(key) == before + 1


# ---------------------------------------------------------------------------
# retention GC + rollback by version
# ---------------------------------------------------------------------------


def test_snapshot_keep_retains_generations_for_rollback(tree, points, tmp_path):
    d = str(tmp_path / "snap")
    for epoch in range(3):
        snap.save_snapshot(d, tree, epoch=epoch, keep=2)
    assert snap.list_versions(d) == [2, 3] == jsnap.list_versions(d)
    assert len([f for f in os.listdir(d) if f.startswith("seg-")]) == 2 * 4
    old_tree, old_man = snap.load_snapshot(d, version=2, device="cpu")
    assert old_man["version"] == 2 and old_man["epoch"] == 1
    for a, b in zip(_tiled(tree, points[:32]), _tiled(old_tree, points[:32])):
        assert np.array_equal(a, b)
    assert snap.load_snapshot(d, device="cpu")[1]["version"] == 3
    with pytest.raises(snap.SnapshotError):
        snap.load_snapshot(d, version=1, device="cpu")
    # the retained generations load into the reference too
    assert jsnap.load_snapshot(d, version=2)[1] == old_man
    # narrowing the retention GCs down on the next save
    snap.save_snapshot(d, tree, epoch=3, keep=1)
    assert snap.list_versions(d) == [4]
    assert len([f for f in os.listdir(d) if f.startswith("seg-")]) == 4


def _cli(main, argv):
    """(exit code, stdout) of one in-process CLI run."""
    import io
    from contextlib import redirect_stderr, redirect_stdout

    out, err = io.StringIO(), io.StringIO()
    code = 0
    with redirect_stdout(out), redirect_stderr(err):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, out.getvalue()


def test_build_save_keep_matches_the_reference(tmp_path):
    """``build --save DIR --snapshot-keep 2`` prints the reference's lines
    and writes the reference's segments, byte for byte."""
    from kdtree_tpu.utils import cli as jcli
    from kdtree_tpu_torch.utils import cli as tcli

    outs = {}
    for name, main, pre in (("ref", jcli.main, ["--platform", "cpu"]),
                            ("port", tcli.main, ["--device", "cpu"])):
        d = str(tmp_path / name)
        for seed in (3, 4, 5):
            code, out = _cli(main, [*pre, "--generator", "threefry", "--engine", "morton",
                                    "build", "--seed", str(seed), "--n", "3000",
                                    "--save", d, "--snapshot-keep", "2"])
            assert code == 0, out
        outs[name] = (out.replace(d, "DIR"), snap.read_manifest(d), snap.list_versions(d))
    (rout, rman, rver), (tout, tman, tver) = outs["ref"], outs["port"]
    assert tout == rout and tver == rver == [2, 3]
    assert {k: v["sha256"] for k, v in tman["segments"].items()} == \
        {k: v["sha256"] for k, v in rman["segments"].items()}
    assert tman["meta"] == rman["meta"] and tman["epoch"] == rman["epoch"]


# ---------------------------------------------------------------------------
# the mutable engine: emit on swap, delta excluded, failing sink
# ---------------------------------------------------------------------------


def _engine(tree, sink=None, max_delta_rows=6, epoch0=0):
    return MutableEngine(tlife.ServeEngine(tree, K), max_delta_rows=max_delta_rows,
                         max_delta_frac=0.0, requested_k=K, epoch0=epoch0,
                         snapshot_sink=sink)


def _wait_epoch(engine, epoch, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if engine.epoch >= epoch and not engine._rebuilding:
            return
        time.sleep(0.02)
    raise AssertionError(f"epoch {epoch} never arrived (at {engine.epoch})")


def _wait_manifest(d, epoch, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        man = snap.read_manifest(d)
        if man is not None and int(man.get("epoch", -1)) >= epoch:
            return man
        time.sleep(0.02)
    raise AssertionError(f"no epoch-{epoch} manifest in {d}")


def test_epoch_swap_emits_snapshot_without_delta(tree, tmp_path):
    d = str(tmp_path / "emit")
    emitted = []

    def sink(t, epoch):
        emitted.append(epoch)
        snap.save_snapshot(d, t, epoch=epoch)

    eng = _engine(tree, sink=sink, max_delta_rows=6, epoch0=4)
    try:
        new_pts = np.full((6, DIM), 0.5, dtype=np.float32) + \
            np.arange(6, dtype=np.float32)[:, None] * 1e-3
        eng.upsert(np.arange(N, N + 6), new_pts)  # crosses the threshold
        _wait_epoch(eng, 5)
        _wait_manifest(d, 5)
        assert emitted == [5]  # numbering continues from epoch0
        loaded, man = snap.load_snapshot(d, device="cpu")
        assert man["epoch"] == 5 and loaded.n_real == N + 6
        # a post-swap delta is NOT snapshotted
        eng.upsert(np.asarray([N + 100]), np.full((1, DIM), 0.25, dtype=np.float32))
        assert eng.stats()["delta_rows"] == 1 and emitted == [5]
        q = np.full((1, DIM), 0.25, dtype=np.float32)
        assert N + 100 in eng.knn_batch(q)[1][0].tolist()
        assert N + 100 not in _tiled(loaded, q)[1][0].tolist()
        # the emitted epoch loads into the reference with the same arrays
        jt, _ = jsnap.load_snapshot(d)
        for name, arr in _arrays(jt).items():
            assert np.array_equal(tree_to_arrays(loaded)[name], arr), name
    finally:
        eng.close()


def test_sink_failure_never_undoes_swap(tree):
    def sink(t, epoch):
        raise OSError("disk full")

    before = _counter_value("kdtree_snapshot_sink_errors_total")
    eng = _engine(tree, sink=sink, max_delta_rows=4)
    try:
        eng.upsert(np.arange(N, N + 4), np.zeros((4, DIM), dtype=np.float32))
        _wait_epoch(eng, 1)
        assert eng.epoch == 1  # the swap stood
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                _counter_value("kdtree_snapshot_sink_errors_total") != before + 1:
            time.sleep(0.02)
        assert _counter_value("kdtree_snapshot_sink_errors_total") == before + 1
        assert eng.knn_batch(np.zeros((1, DIM), np.float32))[1][0, 0] >= N
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the blue/green follower
# ---------------------------------------------------------------------------


def test_follower_adopts_and_preserves_k(tree, tmp_path):
    d = str(tmp_path / "bg")
    primary = _engine(tree, sink=lambda t, e: snap.save_snapshot(d, t, epoch=e))
    man0 = snap.save_snapshot(d, tree, epoch=0)
    sec_tree, man = snap.load_snapshot(d, device="cpu")
    secondary = _engine(sec_tree, epoch0=man["epoch"])
    follower = SnapshotFollower(secondary, d, poll_s=0.05, start_version=man["version"])
    try:
        assert follower.poll_once() is False  # nothing new yet
        new_pts = np.full((6, DIM), 0.75, dtype=np.float32)
        new_pts += np.arange(6, dtype=np.float32)[:, None] * 1e-3
        primary.upsert(np.arange(N, N + 6), new_pts)
        _wait_epoch(primary, 1)
        _wait_manifest(d, 1)
        assert follower.poll_once() is True
        assert secondary.epoch == 1 and secondary.k == K
        assert follower.poll_once() is False
        for a, b in zip(primary.knn_batch(new_pts[:2])[:2],
                        secondary.knn_batch(new_pts[:2])[:2]):
            assert np.array_equal(a, b)
        assert man0["version"] + 1 == snap.read_manifest(d)["version"]
        assert _counter_value("kdtree_snapshot_adoptions_total") >= 1
    finally:
        follower.stop()
        primary.close()
        secondary.close()


def test_follower_keeps_serving_through_corrupt_update(tree, tmp_path):
    d = str(tmp_path / "bg2")
    snap.save_snapshot(d, tree, epoch=0)
    sec_tree, man = snap.load_snapshot(d, device="cpu")
    secondary = _engine(sec_tree, epoch0=0)
    follower = SnapshotFollower(secondary, d, poll_s=0.05, start_version=man["version"])
    key = 'kdtree_snapshot_load_errors_total{reason="checksum"}'
    try:
        snap.save_snapshot(d, tree, epoch=1)
        _corrupt_segment(d)
        before = _counter_value(key)
        assert follower.poll_once() is False
        assert secondary.epoch == 0  # stale beats down
        assert _counter_value(key) == before + 1
        # the failed version is latched: no second verify pass
        assert follower.poll_once() is False
        assert _counter_value(key) == before + 1
        snap.save_snapshot(d, tree, epoch=2)  # a good save re-arms it
        assert follower.poll_once() is True and secondary.epoch == 2
    finally:
        follower.stop()
        secondary.close()


def test_follower_thread_polls_in_background(tree, jtree, tmp_path):
    d = str(tmp_path / "bg3")
    snap.save_snapshot(d, tree, epoch=0)
    sec_tree, man = snap.load_snapshot(d, device="cpu")
    secondary = _engine(sec_tree, epoch0=0)
    follower = SnapshotFollower(secondary, d, poll_s=0.05, start_version=man["version"])
    follower.start()
    try:
        # a reference-written generation is adopted just the same
        jsnap.save_snapshot(d, jtree, epoch=3)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and secondary.epoch != 3:
            time.sleep(0.02)
        assert secondary.epoch == 3
    finally:
        follower.stop()
        secondary.close()


# ---------------------------------------------------------------------------
# read-only replicas over HTTP
# ---------------------------------------------------------------------------


def test_read_only_replica_403s_writes_and_reports_snapshot(jtree, tree, points):
    blk = {"role": "secondary", "version": 1, "epoch": 0, "dir": "/x"}
    js = jsrv.make_server(jlife.build_state(tree=jtree, k=K, max_batch=16, read_only=True,
                                            meta={"snapshot": dict(blk)},
                                            install_listeners=False), port=0)
    ts = tsrv.make_server(tlife.build_state(tree=tree, k=K, max_batch=16, read_only=True,
                                            meta={"snapshot": dict(blk)}), port=0)
    started = []
    try:
        for s in (js, ts):
            s.start(warmup_buckets=[8])
            started.append(s)
        answers = []
        for s in (js, ts):
            port = s.server_address[1]
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                conn.request("POST", "/v1/upsert",
                             body=json.dumps({"ids": [1], "points": [[0.0] * DIM]}))
                resp = conn.getresponse()
                err = json.loads(resp.read())
                err.pop("trace_id")
                # the body was read: the keep-alive socket parses the next one
                conn.request("GET", "/healthz")
                health = json.loads(conn.getresponse().read())
            finally:
                conn.close()
            knn = _post(port, "/v1/knn", {"queries": points[:4].tolist(), "k": 1})
            answers.append((resp.status, err, health["read_only"], health["snapshot"], knn))
        assert answers[0] == answers[1]
        assert answers[1][0] == 403 and "primary" in answers[1][1]["error"]
        assert answers[1][2] is True and answers[1][3] == blk
    finally:
        for s in started:
            s.stop()


# ---------------------------------------------------------------------------
# pre-shipped plan profiles
# ---------------------------------------------------------------------------


def _settled_profile(tree, q=8):
    sig = make_signature(q, tree.dim, tree.n_real, K, tree.bucket_size, tree.num_buckets,
                         devices=1, backend=tree.device.type)
    assert default_store().put(sig, {"tile": 64, "cmax": 32, "seeds": 2})
    return sig


def test_plan_store_is_the_ports_own(tree, monkeypatch, tmp_path):
    assert default_store().cache_dir == str(tmp_path / "plans")
    monkeypatch.delenv("KDTREE_TPU_TORCH_PLAN_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert default_store().cache_dir == str(tmp_path / "xdg" / "kdtree_tpu_torch" / "plans")
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", "off")
    assert not default_store().enabled
    assert make_signature(8, 3, 100, 4, 256, 1, backend="cuda").key.endswith("-cuda-p1")


def test_manifest_carries_collected_plan_profiles(tree, tmp_path):
    sig = _settled_profile(tree)
    keys = snap.plan_keys_for(tree, k=K, max_batch=8)
    assert sig.key in keys
    profiles = snap.collect_plan_profiles(keys)
    assert set(profiles) == {sig.key} and profiles[sig.key]["tile"] == 64
    man = snap.save_snapshot(str(tmp_path / "snapdir"), tree, plan_keys=keys,
                             plan_profiles=profiles)
    assert man["plan_profiles"][sig.key]["cmax"] == 32
    on_disk = snap.read_manifest(snap.resolve_dir(str(tmp_path / "snapdir")))
    assert on_disk["plan_profiles"][sig.key]["seeds"] == 2


def test_seed_plan_store_fills_misses_only(tree, tmp_path, monkeypatch):
    sig = _settled_profile(tree)
    keys = snap.plan_keys_for(tree, k=K, max_batch=8)
    man = snap.save_snapshot(str(tmp_path / "s1"), tree, plan_keys=keys,
                             plan_profiles=snap.collect_plan_profiles(keys))
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", str(tmp_path / "replica-store"))
    assert snap.seed_plan_store(man) == 1
    local_sig = PlanSignature(**man["plan_profiles"][sig.key]["signature"])
    assert default_store().get(local_sig)["tile"] == 64
    assert snap.seed_plan_store(man) == 0  # the key is now present
    default_store().put(local_sig, {"tile": 128, "cmax": 64, "seeds": 4})
    assert snap.seed_plan_store(man) == 0  # local knowledge wins
    assert default_store().get(local_sig)["tile"] == 128


def test_seed_plan_store_tolerates_malformed_payloads():
    assert snap.seed_plan_store({}) == 0
    assert snap.seed_plan_store({"plan_profiles": "nope"}) == 0
    assert snap.seed_plan_store({"plan_profiles": {
        "k1": "not-a-dict",
        "k2": {"tile": 8},
        "k3": {"signature": {"q_bucket": 8}},
        "wrong-key": {"tile": 8, "cmax": 8, "seeds": 1, "signature": {
            "q_bucket": 8, "dim": 3, "n_bucket": 4096, "k": 4, "bucket_size": 256,
            "num_buckets": 16, "backend": "cpu", "devices": 1}},
    }}) == 0


def test_follower_adopt_seeds_plan_store(tree, points, tmp_path, monkeypatch):
    sig = _settled_profile(tree)
    d = str(tmp_path / "bg")
    keys = snap.plan_keys_for(tree, k=K, max_batch=8)
    snap.save_snapshot(d, tree, epoch=3, plan_keys=keys,
                       plan_profiles=snap.collect_plan_profiles(keys))
    monkeypatch.setenv("KDTREE_TPU_TORCH_PLAN_CACHE", str(tmp_path / "follower-store"))
    state = tlife.build_state(points=points[:256], k=K, max_batch=8, device="cpu")
    follower = SnapshotFollower(state.engine, d, start_version=0)
    assert follower.poll_once() is True and state.engine.epoch == 3
    assert state.engine.tree.n_real == N
    got = default_store().get(PlanSignature(
        **snap.read_manifest(d)["plan_profiles"][sig.key]["signature"]))
    assert got is not None and got["tile"] == 64
    swaps = [e for e in tflight.recorder().snapshot() if e["type"] == "snapshot.follow_swap"]
    assert swaps and swaps[-1]["plans_seeded"] == 1


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def test_serve_cli_falls_back_to_points_on_corrupt_snapshot(points, tree, tmp_path):
    """A corrupt snapshot is refused with the named error, and with
    --points the process rebuilds from source, reaches ready and answers
    like the oracle, with the load error on its scrape."""
    d = str(tmp_path / "snap")
    snap.save_snapshot(d, tree)
    _corrupt_segment(d)
    pts_file = tmp_path / "pts.npy"
    np.save(pts_file, points)
    log_path = tmp_path / "serve.log"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kdtree_tpu_torch", "--device", "cpu", "serve",
             "--snapshot", d, "--points", str(pts_file), "--port", "0", "--k", str(K),
             "--max-batch", "8"],
            cwd=REPO, env=env, stderr=log, stdout=subprocess.DEVNULL)
    try:
        port = None
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline and port is None:
            if proc.poll() is not None:
                raise AssertionError(f"serve died: {log_path.read_text()[-2000:]}")
            for line in log_path.read_text().splitlines():
                if line.startswith("ready:"):
                    port = int(line.rsplit("port", 1)[1].strip())
            time.sleep(0.2)
        assert port is not None, log_path.read_text()[-2000:]
        text = log_path.read_text()
        assert "snapshot load failed" in text and "falling back" in text
        out = _post(port, "/v1/knn", {"queries": points[:8].tolist(), "k": K})
        assert out["ids"] == _tiled(tree, points[:8])[1].tolist()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["snapshot"]["role"] == "fallback-rebuild"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        assert 'kdtree_snapshot_load_errors_total{reason="checksum"} 1' in metrics
    finally:
        if proc.poll() is None:
            proc.terminate()
        assert proc.wait(timeout=60) == 0


@pytest.mark.parametrize("flags", [
    ["--snapshot-follow", "1"],
    ["--snapshot", "DIR", "--snapshot-follow", "1", "--snapshot-save", "DIR"],
    ["--snapshot-version", "2"],
    ["--snapshot", "DIR", "--snapshot-version", "2", "--snapshot-follow", "1"],
    ["--index", "a.npz", "--snapshot", "DIR"],
    ["--snapshot", "DIR"],  # no manifest there, and no fallback source
])
def test_serve_snapshot_flag_checks_match_the_reference(flags, tmp_path):
    """The snapshot flags' exclusivity checks and the unloadable-snapshot
    exit: code 1 and the same stderr as the reference's, before anything
    is built."""
    import io
    from contextlib import redirect_stderr

    from kdtree_tpu.utils import cli as jcli
    from kdtree_tpu_torch.utils import cli as tcli

    argv = ["serve", "--port", "0", *[str(tmp_path) if f == "DIR" else f for f in flags]]
    errs = []
    for main, pre in ((jcli.main, ["--platform", "cpu"]), (tcli.main, ["--device", "cpu"])):
        err = io.StringIO()
        with redirect_stderr(err), pytest.raises(SystemExit) as exc:
            main([*pre, *argv])
        assert exc.value.code == 1
        errs.append(err.getvalue())
    assert errs[1] == errs[0]


def _serve_proc(args, log_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    with open(log_path, "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "kdtree_tpu_torch", "--device", "cpu", "serve", *args,
             "--port", "0", "--k", str(K), "--max-batch", "8"],
            cwd=REPO, env=env, stderr=log, stdout=subprocess.DEVNULL)


def _ready_port(proc, log_path, deadline):
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"serve died: {log_path.read_text()[-2000:]}")
        for line in log_path.read_text().splitlines():
            if line.startswith("ready:"):
                return int(line.rsplit("port", 1)[1].strip())
        time.sleep(0.2)
    raise AssertionError(f"serve never ready: {log_path.read_text()[-2000:]}")


def _healthz(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        return json.loads(r.read())


def test_serve_cli_primary_and_follower_converge(tree, points, tmp_path):
    """`serve --snapshot-save` (the primary re-emits on its epoch swap) and
    `serve --snapshot-follow` (a read-only secondary adopting each new
    version) as two processes: the secondary refuses writes, shows the
    new version on /healthz, and then answers like the primary."""
    d = str(tmp_path / "fleet")
    snap.save_snapshot(d, tree)
    procs = []
    try:
        plog, slog = tmp_path / "primary.log", tmp_path / "secondary.log"
        procs.append(_serve_proc(["--snapshot", d, "--snapshot-save", d,
                                  "--max-delta-rows", "4"], plog))
        procs.append(_serve_proc(["--snapshot", d, "--snapshot-follow", "0.2"], slog))
        deadline = time.monotonic() + 180
        pport, sport = (_ready_port(p, log, deadline) for p, log in zip(procs, (plog, slog)))
        assert "snapshot follower armed" in slog.read_text()
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(sport, "/v1/upsert", {"ids": [N + 1], "points": [[0.0] * DIM]})
        assert exc.value.code == 403
        new = (points[:4] + np.float32(0.01)).astype(np.float32)
        out = _post(pport, "/v1/upsert", {"ids": list(range(N, N + 4)),
                                          "points": new.tolist()})
        assert out["applied"] == 4
        while time.monotonic() < deadline:
            health = _healthz(sport)
            if health["snapshot"]["version"] == 2:
                break
            time.sleep(0.1)
        assert health["snapshot"] == {"dir": d, "version": 2, "epoch": 1,
                                      "role": "secondary"}
        assert health["epoch"] == 1 and health["read_only"] is True
        assert _healthz(pport)["epoch"] == 1
        body = {"queries": new.tolist(), "r": 1.0}
        got, want = _post(sport, "/v1/radius", body), _post(pport, "/v1/radius", body)
        assert got == want and all(N + i in ids for i, ids in enumerate(got["ids"]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        assert [p.wait(timeout=60) for p in procs] == [0] * len(procs)
