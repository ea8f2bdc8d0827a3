"""Versioned on-disk snapshots of a built serving index.

The port of ``kdtree_tpu/snapshot/store.py``. The on-disk format is the
reference's, key for key, so a snapshot written by either package loads
into the other:

    DIR/
      MANIFEST.json            # schema, version, epoch, signature,
                               # per-segment sha256 checksums, plan keys
      MANIFEST-v<8 digits>.json  # one per retained generation
      seg-node_lo-<tag>.npy    # flat .npy segments, one per tree array
      seg-node_hi-<tag>.npy
      seg-bucket_pts-<tag>.npy
      seg-bucket_gid-<tag>.npy

Write protocol: segments first (a fresh per-save ``tag``, so a crashed
re-save never mixes generations), each checksummed as it is written; the
manifests go to tmp files and are ``os.replace``d LAST — a reader that
sees a manifest sees a complete segment set. ``version`` increments on
every save into the directory; the blue/green follower
(``snapshot/follower.py``) polls it.

Read protocol: schema check, per-segment size and sha256 verification,
``np.load(mmap_mode="r")``, then ONE host-to-device copy per segment —
from a private host copy of the mmap, so the tensor never aliases a
read-only file the GC may delete. No sort, no build: the loaded arrays
ARE the built tree's bytes. A checksum mismatch or schema skew raises a
NAMED error (:class:`SnapshotCorruptError` / :class:`SnapshotSchemaError`)
— a half-read snapshot never serves.

The delta buffer of a mutable engine is not snapshotted: a snapshot holds
one epoch's compacted main tree, and the manifest records which epoch.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kdtree_tpu_torch import obs, resolve_device
from kdtree_tpu_torch.obs import flight

SNAPSHOT_SCHEMA = 1
MANIFEST_NAME = "MANIFEST.json"
# the MortonTree pytree leaves, in tree_flatten order
_SEGMENTS = ("node_lo", "node_hi", "bucket_pts", "bucket_gid")
_HASH_CHUNK = 1 << 22  # 4 MiB streaming-checksum window


class SnapshotError(Exception):
    """Base class for snapshot load/save failures — callers that want
    to fall back to a from-scratch rebuild catch exactly this."""


class SnapshotSchemaError(SnapshotError):
    """The manifest's schema version is not one this code reads."""


class SnapshotCorruptError(SnapshotError):
    """A segment is missing, truncated, or fails its checksum — the
    snapshot must not serve."""


def resolve_dir(path: str) -> str:
    """Resolve a snapshot directory path. Relative paths resolve under
    ``KDTREE_TPU_SNAPSHOT_DIR`` when it is set — the per-run isolation
    hook tests/CI use so snapshot litter can never land in the working
    tree. Absolute paths (and relative ones with the env unset) pass
    through unchanged. The result is ABSOLUTE whenever the base
    applies, so resolving twice (the follower stores a resolved dir
    and load_snapshot resolves again) is idempotent even under a
    relative base — without that, 'snapshots' + 'dir' re-resolved to
    'snapshots/snapshots/dir' and a follower never converged."""
    base = os.environ.get("KDTREE_TPU_SNAPSHOT_DIR")
    if base and not os.path.isabs(path):
        return os.path.abspath(os.path.join(base, path))
    return path


def _manifest_path(dirpath: str) -> str:
    return os.path.join(dirpath, MANIFEST_NAME)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


class _HashingWriter:
    """File-object shim that hashes every byte as it is written, so the
    save path computes each segment's checksum DURING the write instead
    of re-reading hundreds of MB back per epoch emit. (The load side's
    streamed re-hash stays — there it doubles as the page-cache warm.)
    Not a real file object on purpose: np.save's isfileobj check then
    takes the buffered fp.write path, which is the one that feeds us."""

    def __init__(self, f) -> None:
        self._f = f
        self.h = hashlib.sha256()

    def write(self, data) -> int:
        self.h.update(data)
        return self._f.write(data)


def _count_load_error(reason: str) -> None:
    obs.get_registry().counter(
        "kdtree_snapshot_load_errors_total", labels={"reason": reason}
    ).inc()


def _load_error(exc: SnapshotError, reason: str,
                dirpath: str) -> SnapshotError:
    """Count + flight-record one failed load, then return the exception
    for the caller to raise — every load failure is an incident-shaped
    event (the fallback-to-rebuild path dumps context from here)."""
    _count_load_error(reason)
    flight.record("snapshot.load_error", dir=dirpath, reason=reason,
                  error=str(exc)[:200])
    return exc


def plan_keys_for(tree, k: int, max_batch: int = 1024,
                  min_bucket: Optional[int] = None) -> List[str]:
    """The plan-store keys a server over this snapshot warms on its
    ladder: one signature per pow2 warmup bucket, on the tree's device
    type as the backend. Advisory manifest metadata — a replica fleet can
    pre-ship the matching plan profiles."""
    from kdtree_tpu_torch.serve.engine import MIN_BUCKET, warmup_buckets
    from kdtree_tpu_torch.tuning.store import make_signature

    buckets = warmup_buckets(int(max_batch), MIN_BUCKET if min_bucket is None
                             else min_bucket)
    kk = min(int(k), int(tree.n_real))
    return [
        make_signature(
            q, tree.dim, tree.n_real, kk, tree.bucket_size,
            tree.num_buckets, devices=1, backend=tree.device.type,
        ).key
        for q in buckets
    ]


def collect_plan_profiles(
    plan_keys: Optional[List[str]],
) -> Dict[str, dict]:
    """The local plan store's raw profiles for ``plan_keys`` — the
    payload a snapshot PRE-SHIPS to replicas. Only keys the local store has
    actually settled are included (a manifest must never ship a guess);
    a disabled or unreadable store yields an empty dict. Profiles stay
    version-checked raw dicts, signature included, so the seeding side
    can reconstruct the exact store key."""
    from kdtree_tpu_torch.tuning.store import default_store

    store = default_store()
    out: Dict[str, dict] = {}
    for key in plan_keys or []:
        prof = store.raw_for_key(str(key))
        if prof is not None:
            out[str(key)] = prof
    return out


def seed_plan_store(manifest) -> int:
    """Seed the LOCAL plan store from a manifest's pre-shipped
    ``plan_profiles`` (the other half of :func:`collect_plan_profiles`)
    — called by ``serve --snapshot`` and the blue/green follower BEFORE
    the warmup ladder runs, so adoption compiles warm instead of
    locally re-settling every launch plan. Returns how many profiles
    were written.

    Fill-misses-only: a key the local store already holds is skipped —
    local knowledge (possibly tuned on THIS host) outranks the
    primary's. Malformed entries are skipped silently (advisory
    metadata, the plan-store trust model: a wrong profile can only
    cost speed, and the overflow-retry contract still guards every
    batch)."""
    from kdtree_tpu_torch.tuning.store import PlanSignature, default_store

    profiles = (manifest or {}).get("plan_profiles")
    if not isinstance(profiles, dict) or not profiles:
        return 0
    store = default_store()
    if not store.enabled:
        return 0
    seeded = 0
    for key, prof in profiles.items():
        if not isinstance(prof, dict):
            continue
        sig_d = prof.get("signature")
        if not isinstance(sig_d, dict):
            continue
        try:
            sig = PlanSignature(**{f: sig_d[f]
                                   for f in PlanSignature._fields})
        except (KeyError, TypeError):
            continue
        if sig.key != key:
            continue  # the key must name the profile it claims to
        if store.get_raw(sig) is not None:
            continue
        body = {k: v for k, v in prof.items()
                if k not in ("version", "signature", "updated_unix")}
        if store.put(sig, body):
            seeded += 1
    if seeded:
        obs.get_registry().counter(
            "kdtree_snapshot_plan_seeded_total").inc(seeded)
        flight.record("snapshot.plan_seed", seeded=seeded,
                      shipped=len(profiles))
    return seeded


def read_manifest(dirpath: str) -> Optional[dict]:
    """Parse the manifest, or None when the directory holds none (or a
    torn/unparseable one — the follower treats that as 'nothing new
    yet', and an actual load attempt reports it crisply)."""
    try:
        with open(_manifest_path(dirpath)) as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    return man if isinstance(man, dict) else None


def _gen_manifest_name(version: int) -> str:
    return f"MANIFEST-v{int(version):08d}.json"


_GEN_MANIFEST_RE = re.compile(r"^MANIFEST-v(\d{8})\.json$")


def list_versions(dirpath: str) -> List[int]:
    """Retained generation numbers (ascending) — the versions a
    ``load_snapshot(..., version=N)`` rollback can still reach."""
    dirpath = resolve_dir(dirpath)
    out = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return out
    for fname in names:
        m = _GEN_MANIFEST_RE.match(fname)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _gc_generations(dirpath: str, keep: int) -> int:
    """Retention GC:
    keep the newest ``keep`` generation manifests, drop older ones,
    then remove every ``seg-*.npy`` no RETAINED manifest (the live
    ``MANIFEST.json`` included) references — segments are refcounted
    by manifest, so a file shared by two generations survives until
    both are dropped. Returns the number of generations removed.

    Safety against a concurrent follower load: the live manifest and
    every retained generation keep their full segment sets, so any
    reader that saw a retained manifest finds its files. A reader
    mid-load of a JUST-DROPPED generation can race the unlink — it
    then fails the missing-segment/checksum check with a NAMED error
    and retries its poll (the follower's contract); it can never serve
    a half state. ``keep >= 2`` gives followers a full generation of
    slack before that race is even reachable."""
    removed = 0
    keep = max(int(keep), 1)
    versions = list_versions(dirpath)
    for version in versions[:-keep] if len(versions) > keep else []:
        try:
            os.remove(os.path.join(dirpath, _gen_manifest_name(version)))
            removed += 1
        except OSError:
            pass
    referenced = set()
    manifests = [read_manifest(dirpath)]
    for version in list_versions(dirpath):
        try:
            with open(os.path.join(dirpath,
                                   _gen_manifest_name(version))) as f:
                manifests.append(json.load(f))
        except (OSError, ValueError):
            continue
    for man in manifests:
        if not isinstance(man, dict):
            continue
        for seg in (man.get("segments") or {}).values():
            if isinstance(seg, dict) and seg.get("file"):
                referenced.add(str(seg["file"]))
    try:
        names = os.listdir(dirpath)
    except OSError:
        return removed
    for fname in names:
        if (fname.startswith("seg-") and fname.endswith(".npy")
                and fname not in referenced):
            try:
                os.remove(os.path.join(dirpath, fname))
            except OSError:
                pass
    if removed:
        flight.record("snapshot.gc", dir=dirpath, removed=removed,
                      kept=len(list_versions(dirpath)))
        obs.get_registry().counter(
            "kdtree_snapshot_gc_generations_total").inc(removed)
    return removed


def save_snapshot(
    dirpath: str,
    tree,
    epoch: int = 0,
    id_offset: int = 0,
    plan_keys: Optional[List[str]] = None,
    plan_profiles: Optional[Dict[str, dict]] = None,
    meta: Optional[dict] = None,
    keep: int = 1,
) -> dict:
    """Serialize a built Morton serving index into ``dirpath``; returns
    the manifest dict (its ``version`` is the previous manifest's + 1).

    ``keep`` is the retention depth (``--snapshot-keep``): the newest
    ``keep`` generations stay loadable — each save also writes a
    per-generation ``MANIFEST-v*.json``, and the GC drops older
    generations plus any segment no retained manifest references
    (refcounted, see :func:`_gc_generations`). ``keep=1`` is the
    historical behavior: one generation on disk; ``keep=3`` makes
    ``serve --snapshot DIR --snapshot-version N`` a rollback button.

    Only :class:`~kdtree_tpu_torch.ops.morton.MortonTree` is
    snapshotable — it IS the serving representation (crisp ``TypeError``
    otherwise, same contract as serving itself). Each of its four arrays
    comes to the host once."""
    from kdtree_tpu_torch.ops.morton import MortonTree

    if not isinstance(tree, MortonTree):
        raise TypeError(
            f"snapshots hold the Morton serving index, got "
            f"{type(tree).__name__} — serve.engine.tree_for_serving "
            "names the kinds that serve"
        )
    dirpath = resolve_dir(dirpath)
    t0 = time.perf_counter()
    os.makedirs(dirpath, exist_ok=True)
    prev = read_manifest(dirpath)
    version = int(prev.get("version", 0)) + 1 if prev else 1
    tag = uuid.uuid4().hex[:8]
    segments: Dict[str, dict] = {}
    total_bytes = 0
    for name in _SEGMENTS:
        arr = getattr(tree, name).cpu().numpy()
        fname = f"seg-{name}-{tag}.npy"
        fpath = os.path.join(dirpath, fname)
        tmp = f"{fpath}.tmp"
        try:
            with open(tmp, "wb") as f:
                w = _HashingWriter(f)
                np.save(w, arr)
            os.replace(tmp, fpath)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        nbytes = os.path.getsize(fpath)
        total_bytes += nbytes
        segments[name] = {
            "file": fname,
            "sha256": w.h.hexdigest(),
            "bytes": nbytes,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
        }
    manifest = {
        "schema": SNAPSHOT_SCHEMA,
        "version": version,
        "epoch": int(epoch),
        "id_offset": int(id_offset),
        "kind": "morton",
        "signature": {
            "n_real": int(tree.n_real),
            "num_levels": int(tree.num_levels),
            "dim": int(tree.dim),
            "num_buckets": int(tree.num_buckets),
            "bucket_size": int(tree.bucket_size),
            "heap_size": int(tree.heap_size),
        },
        "segments": segments,
        "plan_keys": list(plan_keys or []),
        # the pre-shipped warm-plan payload (collect_plan_profiles):
        # replicas seed their store from it before warmup, so adoption
        # compiles warm instead of locally re-tuning (the PR 13 open
        # half — plan_keys used to be advisory key names only)
        "plan_profiles": dict(plan_profiles or {}),
        "created_unix": round(time.time(), 3),
        "meta": dict(meta or {}),
    }
    # generation manifest FIRST, live MANIFEST.json LAST: a reader that
    # sees the live manifest sees a complete retained set, and a crash
    # between the two leaves only an orphan generation file the next
    # save's GC collects
    for target in (os.path.join(dirpath, _gen_manifest_name(version)),
                   _manifest_path(dirpath)):
        tmp = f"{target}.tmp-{tag}"
        try:
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, target)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
    _gc_generations(dirpath, keep=keep)
    dt = time.perf_counter() - t0
    reg = obs.get_registry()
    reg.counter("kdtree_snapshot_saves_total").inc()
    reg.gauge("kdtree_snapshot_version").set(version)
    reg.gauge("kdtree_snapshot_epoch").set(int(epoch))
    reg.gauge("kdtree_snapshot_bytes").set(total_bytes)
    reg.gauge("kdtree_snapshot_save_seconds").set(round(dt, 6))
    flight.record("snapshot.save", dir=dirpath, version=version,
                  epoch=int(epoch), n=int(tree.n_real),
                  bytes=total_bytes, seconds=round(dt, 3))
    return manifest


def _read_manifest_strict(dirpath: str,
                          version: Optional[int] = None) -> dict:
    mpath = (_manifest_path(dirpath) if version is None
             else os.path.join(dirpath, _gen_manifest_name(version)))
    try:
        with open(mpath) as f:
            man = json.load(f)
    except OSError as e:
        raise _load_error(
            SnapshotError(f"no snapshot manifest at {mpath}: {e}"),
            "missing", dirpath,
        ) from None
    except ValueError as e:
        raise _load_error(
            SnapshotCorruptError(f"manifest {mpath} is not JSON: {e}"),
            "manifest", dirpath,
        ) from None
    if not isinstance(man, dict) or "segments" not in man:
        raise _load_error(
            SnapshotCorruptError(f"manifest {mpath} is not a snapshot "
                                 "manifest (no 'segments')"),
            "manifest", dirpath,
        )
    schema = man.get("schema")
    if schema != SNAPSHOT_SCHEMA:
        raise _load_error(
            SnapshotSchemaError(
                f"snapshot {dirpath} has schema {schema!r}; this build "
                f"reads schema {SNAPSHOT_SCHEMA} — rebuild the snapshot "
                "with a matching kdtree-tpu"
            ),
            "schema", dirpath,
        )
    return man


def load_snapshot(
    dirpath: str, version: Optional[int] = None, device=None,
) -> Tuple[object, dict]:
    """Load a snapshot into a ready-to-serve
    :class:`~kdtree_tpu_torch.ops.morton.MortonTree` on ``device`` (CUDA
    unless the caller asks for the CPU); returns ``(tree, manifest)``.

    ``version`` selects a RETAINED generation (``--snapshot-keep``
    kept it; :func:`list_versions` lists them) instead of the live
    manifest — the rollback-by-version read path. A version the GC
    already dropped fails with the named missing-manifest error.

    Every segment is checksum-verified BEFORE any of it is handed to
    the engine, then read through ``np.load(mmap_mode="r")`` and
    transferred to the device once, from a private host copy:
    the tensor never aliases the read-only mmap, whose file a later
    save's GC may delete. Raises the named :class:`SnapshotError`
    subclasses on any inconsistency — never returns a partially-read
    index. The flight event ``snapshot.load`` splits the time into the
    checksum pass (``verify_seconds``) and the copies
    (``copy_seconds``)."""
    dev = resolve_device(device)
    dirpath = resolve_dir(dirpath)
    t0 = time.perf_counter()
    verify_s = copy_s = 0.0
    man = _read_manifest_strict(dirpath, version=version)
    sig = man.get("signature", {})
    arrays = {}
    for name in _SEGMENTS:
        seg = man["segments"].get(name)
        if not isinstance(seg, dict) or "file" not in seg:
            raise _load_error(
                SnapshotCorruptError(
                    f"snapshot {dirpath}: manifest lacks segment "
                    f"{name!r}"),
                "manifest", dirpath,
            )
        fpath = os.path.join(dirpath, seg["file"])
        try:
            size = os.path.getsize(fpath)
        except OSError as e:
            raise _load_error(
                SnapshotCorruptError(
                    f"snapshot {dirpath}: segment {seg['file']} "
                    f"unreadable ({e}) — a snapshot is the manifest "
                    "plus its seg-*.npy files and must be copied as a "
                    "set"),
                "segment", dirpath,
            ) from None
        if size != int(seg.get("bytes", -1)):
            raise _load_error(
                SnapshotCorruptError(
                    f"snapshot {dirpath}: segment {seg['file']} is "
                    f"{size} bytes, manifest says {seg.get('bytes')} "
                    "(truncated or torn write)"),
                "checksum", dirpath,
            )
        tv = time.perf_counter()
        digest = _sha256_file(fpath)
        verify_s += time.perf_counter() - tv
        if digest != seg.get("sha256"):
            raise _load_error(
                SnapshotCorruptError(
                    f"snapshot {dirpath}: segment {seg['file']} "
                    f"fails its sha256 check (have {digest[:12]}…, "
                    f"manifest {str(seg.get('sha256'))[:12]}…)"),
                "checksum", dirpath,
            )
        try:
            arr = np.load(fpath, mmap_mode="r")
        except ValueError as e:
            raise _load_error(
                SnapshotCorruptError(
                    f"snapshot {dirpath}: segment {seg['file']} is not "
                    f"a readable .npy ({e})"),
                "segment", dirpath,
            ) from None
        if list(arr.shape) != list(seg.get("shape", [])) or \
                str(arr.dtype) != seg.get("dtype"):
            raise _load_error(
                SnapshotCorruptError(
                    f"snapshot {dirpath}: segment {seg['file']} has "
                    f"shape {arr.shape}/{arr.dtype}, manifest says "
                    f"{seg.get('shape')}/{seg.get('dtype')}"),
                "segment", dirpath,
            )
        # ONE device transfer per segment, from a writable host copy
        # (torch.from_numpy of the read-only mmap would alias the file).
        # A blocking copy from pageable memory has landed when .to()
        # returns, so the host clock times it without a device-wide sync.
        tc = time.perf_counter()
        arrays[name] = torch.from_numpy(np.array(arr)).to(dev)
        copy_s += time.perf_counter() - tc
    from kdtree_tpu_torch.ops.morton import MortonTree

    tree = MortonTree(
        node_lo=arrays["node_lo"],
        node_hi=arrays["node_hi"],
        bucket_pts=arrays["bucket_pts"],
        bucket_gid=arrays["bucket_gid"],
        n_real=int(sig.get("n_real", 0)),
        num_levels=int(sig.get("num_levels", 0)),
    )
    if tree.n_real <= 0 or tree.num_buckets != int(
            sig.get("num_buckets", -1)):
        raise _load_error(
            SnapshotCorruptError(
                f"snapshot {dirpath}: signature {sig!r} disagrees with "
                "the loaded arrays"),
            "manifest", dirpath,
        )
    dt = time.perf_counter() - t0
    reg = obs.get_registry()
    reg.counter("kdtree_snapshot_loads_total").inc()
    reg.gauge("kdtree_snapshot_version").set(int(man.get("version", 0)))
    reg.gauge("kdtree_snapshot_epoch").set(int(man.get("epoch", 0)))
    reg.gauge("kdtree_snapshot_load_seconds").set(round(dt, 6))
    flight.record("snapshot.load", dir=dirpath,
                  version=int(man.get("version", 0)),
                  epoch=int(man.get("epoch", 0)), n=int(tree.n_real),
                  seconds=round(dt, 3), verify_seconds=round(verify_s, 6),
                  copy_seconds=round(copy_s, 6))
    return tree, man
