"""Tree checkpoints, readable by both packages.

The port of ``kdtree_tpu/utils/checkpoint.py``. The layout is the
reference's, so a checkpoint saved by either package loads in the other:

- ``child_0..``: the tree's arrays, in the order of the reference's
  ``tree_flatten`` (:data:`KINDS`); a multi-device tree's per-shard
  arrays are stacked on a leading shard axis;
- ``aux``: int64 plain ints (``n_real, num_levels`` for the Morton,
  bucketed and global trees; the forests' provenance ints);
- ``kind``: ``"morton"``, ``"classic"``, ``"bucket"``, ``"global"``,
  ``"global-morton"`` or ``"global-exact"``; then one ``meta_<key>``
  entry per provenance item (seed, generator, ...).

A forest (``global-morton``, ``global-exact``) above
``_SHARD_SAVE_BYTES`` is saved in the ``sharded-v1`` format instead: a
manifest at the path and one ``<path>.shard<i>-<tag>.npz`` per shard, so
neither save nor load holds more than about one shard on the host. The
legacy format (``points``, ``node_point``, ``split_val`` and no ``kind``)
holds a classic tree and loads too. Files are written to a temporary name
and moved into place with ``os.replace``, so a crash mid-write never
truncates an earlier checkpoint.
"""

from __future__ import annotations

import os
import uuid

import numpy as np
import torch

from kdtree_tpu_torch import resolve_device
from kdtree_tpu_torch.models.tree import KDTree
from kdtree_tpu_torch.ops.bucket import BucketKDTree
from kdtree_tpu_torch.ops.morton import MortonTree
from kdtree_tpu_torch.utils.guards import validate_loaded_tree

# kind -> (class, its arrays in the reference's child order, its aux ints):
# the single-device kinds; _kinds() adds the multi-device ones
KINDS = {
    "classic": (KDTree, ("points", "node_point", "split_val"), ()),
    "bucket": (BucketKDTree, ("node_coords", "node_gid", "node_bucket", "bucket_pts",
                              "bucket_gid"), ("n_real", "num_levels")),
    "morton": (MortonTree, ("node_lo", "node_hi", "bucket_pts", "bucket_gid"),
               ("n_real", "num_levels")),
}


def _kinds() -> dict:
    """Every checkpoint kind; the multi-device classes load on first use."""
    from kdtree_tpu_torch.parallel import GlobalExactTree, GlobalKDTree, GlobalMortonForest

    return {**KINDS, **{kind: (cls, cls.ARRAYS, cls.AUX) for kind, cls in (
        ("global", GlobalKDTree), ("global-morton", GlobalMortonForest),
        ("global-exact", GlobalExactTree))}}

# above this many bytes a forest is saved one shard per file
_SHARD_SAVE_BYTES = 1 << 30
_SHARDED_KINDS = ("global-morton", "global-exact")
# a mesh-free load of a sharded checkpoint puts every shard on one device;
# above this it refuses unless the caller opts in (allow_host_materialize)
_HOST_MATERIALIZE_BYTES = 4 << 30


def _host_materialize_budget() -> int:
    raw = os.environ.get("KDTREE_TPU_HOST_MATERIALIZE_BYTES")
    if raw is None:
        return _HOST_MATERIALIZE_BYTES
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"KDTREE_TPU_HOST_MATERIALIZE_BYTES must be an integer byte "
            f"count, got {raw!r}"
        ) from None


def _shard_path(path: str, i: int, tag: str) -> str:
    return f"{path}.shard{i}-{tag}.npz"


def _shape(c) -> tuple:
    if isinstance(c, list):
        return (len(c),) + tuple(c[0].shape)
    return tuple(c.shape)


def _nbytes(c) -> int:
    x = c[0] if isinstance(c, list) else c
    return int(np.prod(_shape(c))) * x.element_size()


def _host(c) -> np.ndarray:
    if isinstance(c, list):
        return np.stack([x.cpu().numpy() for x in c])
    return c.cpu().numpy()


def _atomic_savez(path: str, payload: dict, tmp: str) -> None:
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _cleanup_stale_shards(path: str, keep_tag: str | None) -> None:
    """Best-effort removal of shard and tmp files of superseded saves at
    this path (runs on every save)."""
    base = os.path.basename(path)
    dirname = os.path.dirname(os.path.abspath(path))
    try:
        names = os.listdir(dirname)
    except OSError:
        return
    for fname in names:
        stale_shard = (fname.startswith(f"{base}.shard") and fname.endswith(".npz")
                       and (keep_tag is None or f"-{keep_tag}." not in fname))
        stale_tmp = (fname.startswith(f"{base}.tmp-")
                     and (keep_tag is None or not fname.endswith(keep_tag)))
        if stale_shard or stale_tmp:
            try:
                os.remove(os.path.join(dirname, fname))
            except OSError:
                pass


def save_tree(path: str, tree, meta: dict | None = None,
              sharded: bool | None = None) -> str:
    """Save a tree and its provenance ``meta`` to ``path`` (the name is
    used as given). Returns the format written: ``"single"`` or
    ``"sharded"`` (a manifest plus per-shard files, NOT one
    self-contained file). ``sharded=None`` picks the sharded format for a
    forest above ``_SHARD_SAVE_BYTES``; True/False force either."""
    kinds = _kinds()
    kind = next((k for k, (cls, _, _) in kinds.items() if isinstance(tree, cls)), None)
    if kind is None:
        raise TypeError(f"not a checkpointable tree: {type(tree)!r}")
    _, names, aux = kinds[kind]
    children = [(a, getattr(tree, a)) for a in names]  # a tensor, or a per-shard list
    auxv = np.asarray([getattr(tree, a) for a in aux], dtype=np.int64) if aux else None
    if sharded is None:
        sharded = (kind in _SHARDED_KINDS
                   and sum(_nbytes(c) for _, c in children) > _SHARD_SAVE_BYTES)
    if sharded:
        if kind not in _SHARDED_KINDS:
            raise TypeError(f"sharded checkpoints need a leading device axis; "
                            f"{type(tree).__name__} has none")
        _save_sharded(path, kind, tree, [c for _, c in children], auxv, meta)
        return "sharded"
    payload = {f"child_{i}": _host(c) for i, (_, c) in enumerate(children)}
    if auxv is not None:
        payload["aux"] = auxv
    payload["kind"] = np.asarray(kind)
    payload.update({f"meta_{k}": np.asarray(v) for k, v in (meta or {}).items()})
    _atomic_savez(path, payload, f"{path}.tmp-{uuid.uuid4().hex[:8]}")
    _cleanup_stale_shards(path, keep_tag=None)
    return "single"


def _save_sharded(path, kind, tree, children, auxv, meta) -> None:
    """Manifest at ``path`` plus one ``path.shard{i}-{tag}.npz`` per
    shard. Children with the shard axis go out one shard at a time;
    replicated ones (the exact tree's top heap) ride in the manifest. The
    manifest is replaced last, so an interrupted re-save never leaves it
    pointing at a mixed shard set."""
    p = int(tree.devices)
    is_dev = [_shape(c)[0] == p for c in children]
    tag = uuid.uuid4().hex[:8]
    for i in range(p):
        shard = {}
        for j, c in enumerate(children):
            if is_dev[j]:
                shard[f"child_{j}"] = c[i].cpu().numpy()[None]
        np.savez_compressed(_shard_path(path, i, tag), **shard)
    manifest = {
        "kind": np.asarray(kind),
        "format": np.asarray("sharded-v1"),
        "tag": np.asarray(tag),
        "num_shards": np.asarray(p, dtype=np.int64),
        "num_children": np.asarray(len(children), dtype=np.int64),
        "sharded_mask": np.asarray(is_dev, dtype=np.bool_),
        "shard_bytes": np.asarray(
            sum(_nbytes(c) // p for j, c in enumerate(children) if is_dev[j]),
            dtype=np.int64),
    }
    for j, c in enumerate(children):
        if not is_dev[j]:
            manifest[f"repl_{j}"] = _host(c)
    if auxv is not None:
        manifest["aux"] = auxv
    manifest.update({f"meta_{k}": np.asarray(v) for k, v in (meta or {}).items()})
    _atomic_savez(path, manifest, f"{path}.tmp-{tag}")
    _cleanup_stale_shards(path, keep_tag=tag)


def _shard_devices(p: int, dev: torch.device):
    """Where a loaded forest's shards go: mesh device i for shard i when
    ``dev``'s type has a mesh of ``p`` devices, else all on ``dev``."""
    from kdtree_tpu_torch.parallel.mesh import mesh_for

    mesh = mesh_for(p, dev)
    return None if mesh is None else list(mesh.devices)


def _forest(cls, names, children, ints, devs):
    """A forest from its stacked host arrays: shard i of each per-shard
    child goes to ``devs[i]``, replicated children to the first device."""
    out = []
    for name, c in zip(names, children):
        if name in getattr(cls, "REPLICATED", ()):
            out.append(torch.from_numpy(np.array(c)).to(devs[0]))
        else:
            out.append([torch.from_numpy(np.array(c[i])).to(d) for i, d in enumerate(devs)])
    return cls(*out, *ints)


def _load_sharded(path: str, z, dev: torch.device, allow_host_materialize: bool):
    """A forest from its per-shard files, one shard file at a time. With a
    mesh of ``num_shards`` devices on ``dev``'s type, shard i goes to mesh
    device i; otherwise every shard lands on ``dev``, which the
    host-materialize budget guards unless the caller opts in."""
    p = int(z["num_shards"])
    nchild = int(z["num_children"])
    tag = str(z["tag"])
    mask = [bool(b) for b in z["sharded_mask"]]
    cls, names, _ = _kinds()[str(z["kind"])]
    ints = [int(a) for a in z["aux"]] if "aux" in z.files else []
    devs = _shard_devices(p, dev)
    if devs is None:
        total = int(z["shard_bytes"]) * p
        if total > _host_materialize_budget() and not allow_host_materialize:
            raise ValueError(
                f"sharded checkpoint {path} holds ~{total / 2**30:.1f} GiB across "
                f"{p} shards but only {torch.cuda.device_count()} device(s) are "
                "visible — the mesh-free fallback would put all of it on one "
                f"device. Load on >= {p} devices, pass allow_host_materialize=True "
                "to load_tree (CLI: `query --allow-host-materialize`), or raise "
                "KDTREE_TPU_HOST_MATERIALIZE_BYTES.")
        devs = [dev] * p
    children = [[] if mask[j] else z[f"repl_{j}"] for j in range(nchild)]
    for i in range(p):
        sp = _shard_path(path, i, tag)
        try:
            zs = np.load(sp)
        except OSError as e:
            raise FileNotFoundError(
                f"sharded checkpoint {path} references sidecar file {sp} which "
                f"cannot be read ({e}); a sharded checkpoint is the manifest plus "
                f"{p} '*.shard*-{tag}.npz' files and must be copied as a set") from e
        with zs:
            for j in range(nchild):
                if mask[j]:
                    children[j].append(torch.from_numpy(
                        np.array(zs[f"child_{j}"][0])).to(devs[i]))
    for j in range(nchild):
        if not mask[j]:
            children[j] = torch.from_numpy(np.array(children[j])).to(devs[0])
        elif names[j] in getattr(cls, "REPLICATED", ()):
            children[j] = torch.stack([c.to(devs[0]) for c in children[j]])
    return cls(*children, *ints)


def load_tree(path: str, device=None, allow_host_materialize: bool = False):
    """Returns (tree, meta) with the tree's tensors on ``device`` (CUDA by
    default); the tree's type follows the saved kind. A sharded forest
    spreads over a mesh of its shard count when the device type has one
    (``allow_host_materialize`` opts in to the one-device fallback above
    the budget). Raises ``ValueError`` for a checkpoint whose float arrays
    hold NaN."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a)).to(dev)

    with np.load(path) as z:
        meta = {
            k[len("meta_"):]: z[k].item() if z[k].ndim == 0 else z[k]
            for k in z.files
            if k.startswith("meta_")
        }
        if "format" in z.files and str(z["format"]) == "sharded-v1":
            tree = _load_sharded(path, z, dev, allow_host_materialize)
        elif "kind" not in z.files:  # the legacy format: a classic tree only
            tree = KDTree(put(z["points"]), put(z["node_point"]), put(z["split_val"]))
        else:
            kind = str(z["kind"])
            kinds = _kinds()
            if kind not in kinds:
                raise ValueError(f"unknown checkpoint kind {kind!r}")
            cls, names, aux = kinds[kind]
            ints = [int(a) for a in z["aux"]] if aux else []
            if kind in _SHARDED_KINDS:
                children = [z[f"child_{i}"] for i in range(len(names))]
                p = children[names.index(cls.ARRAYS[-1])].shape[0]
                tree = _forest(cls, names, children, ints,
                               _shard_devices(p, dev) or [dev] * p)
            else:
                tree = cls(*[put(z[f"child_{i}"]) for i in range(len(names))], *ints)
    validate_loaded_tree(tree)  # NaN in a checkpoint = corruption, fail here
    return tree, meta
