"""Tree checkpoints: one npz file, readable by both packages.

The port of ``kdtree_tpu/utils/checkpoint.py``'s single-file format for
the Morton tree, the classic tree and the bucketed tree. The layout is
the reference's, so a checkpoint saved by either package loads in the
other:

- ``child_0..``: the tree's arrays, in the order of the reference's
  ``tree_flatten`` (:data:`KINDS`);
- ``aux``: int64 ``(n_real, num_levels)`` for the Morton and bucketed
  trees (the classic tree has none);
- ``kind``: ``"morton"``, ``"classic"`` or ``"bucket"``; then one
  ``meta_<key>`` entry per provenance item (seed, generator, ...).

The legacy format (``points``, ``node_point``, ``split_val`` and no
``kind``) holds a classic tree and loads too. The file is written to a
temporary name and moved into place with ``os.replace``, so a crash
mid-write never truncates an earlier checkpoint. The multi-device kinds
and the sharded format are not ported yet; loading one fails with a
``ValueError`` that names the ROADMAP item that brings them.
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

# the reference's engines that this package does not have yet, by the
# ROADMAP queue 1 item that ports them; a checkpoint's kind is the name of
# the engine that wrote it
UNPORTED_ENGINES = {"ensemble": 17, "global": 17, "global-morton": 17,
                    "global-exact": 17}

# kind -> (class, its arrays in the reference's child order, its aux ints)
KINDS = {
    "classic": (KDTree, ("points", "node_point", "split_val"), ()),
    "bucket": (BucketKDTree, ("node_coords", "node_gid", "node_bucket", "bucket_pts",
                              "bucket_gid"), ("n_real", "num_levels")),
    "morton": (MortonTree, ("node_lo", "node_hi", "bucket_pts", "bucket_gid"),
               ("n_real", "num_levels")),
}


def save_tree(path: str, tree, meta: dict | None = None) -> None:
    """Save a Morton, classic or bucketed tree and its provenance ``meta``
    to ``path`` (the name is used as given; no ``.npz`` is appended)."""
    kind = next((k for k, (cls, _, _) in KINDS.items() if isinstance(tree, cls)), None)
    if kind is None:
        raise TypeError(f"not a checkpointable tree: {type(tree)!r}")
    _, names, aux = KINDS[kind]
    payload = {f"child_{i}": getattr(tree, a).cpu().numpy() for i, a in enumerate(names)}
    if aux:
        payload["aux"] = np.asarray([getattr(tree, a) for a in aux], dtype=np.int64)
    payload["kind"] = np.asarray(kind)
    payload.update({f"meta_{k}": np.asarray(v) for k, v in (meta or {}).items()})
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
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


def load_tree(path: str, device=None):
    """Returns (tree, meta) with the tree's tensors on ``device`` (CUDA by
    default); the tree's type follows the saved kind. Raises
    ``ValueError`` for a checkpoint this package cannot read yet, or one
    whose float arrays hold NaN."""
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
            raise ValueError(
                "sharded (per-device) checkpoints hold multi-device forests, "
                "which are not ported yet (ROADMAP queue 1 item "
                f"{UNPORTED_ENGINES['global']})")
        if "kind" not in z.files:  # the legacy format: a classic tree only
            tree = KDTree(put(z["points"]), put(z["node_point"]), put(z["split_val"]))
        else:
            kind = str(z["kind"])
            if kind not in KINDS:
                item = UNPORTED_ENGINES.get(kind)
                where = f" (ROADMAP queue 1 item {item})" if item else ""
                raise ValueError(f"checkpoint kind {kind!r} is not ported yet{where}")
            cls, names, aux = KINDS[kind]
            children = [put(z[f"child_{i}"]) for i in range(len(names))]
            ints = [int(a) for a in z["aux"]] if aux else []
            tree = cls(*children, *ints)
    validate_loaded_tree(tree)  # NaN in a checkpoint = corruption, fail here
    return tree, meta
