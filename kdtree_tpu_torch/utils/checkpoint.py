"""Tree checkpoints: one npz file, readable by both packages.

The port of ``kdtree_tpu/utils/checkpoint.py``'s single-file format for
the Morton tree. The layout is the reference's, so a checkpoint saved by
either package loads in the other:

- ``child_0..3``: ``node_lo``, ``node_hi``, ``bucket_pts``, ``bucket_gid``
  (the order of the reference's ``MortonTree.tree_flatten``);
- ``aux``: int64 ``(n_real, num_levels)``;
- ``kind``: ``"morton"``; then one ``meta_<key>`` entry per provenance
  item (seed, generator, ...).

The file is written to a temporary name and moved into place with
``os.replace``, so a crash mid-write never truncates an earlier
checkpoint. Other kinds, the sharded format and the legacy format are not
ported yet; loading one fails with a ``ValueError`` that names the
ROADMAP item that brings it.
"""

from __future__ import annotations

import os
import uuid

import numpy as np
import torch

from kdtree_tpu_torch import resolve_device
from kdtree_tpu_torch.ops.morton import MortonTree
from kdtree_tpu_torch.utils.guards import validate_loaded_tree

# the reference's engines that this package does not have yet, by the
# ROADMAP queue 1 item that ports them; a checkpoint's kind is the name of
# the engine that wrote it, except "classic", written by "tree"
UNPORTED_ENGINES = {"tree": 16, "bucket": 16, "ensemble": 17, "global": 17,
                    "global-morton": 17, "global-exact": 17}


def save_tree(path: str, tree, meta: dict | None = None) -> None:
    """Save a Morton tree and its provenance ``meta`` to ``path`` (the
    name is used as given; no ``.npz`` is appended)."""
    if not isinstance(tree, MortonTree):
        raise TypeError(f"not a checkpointable tree: {type(tree)!r}")
    children = (tree.node_lo, tree.node_hi, tree.bucket_pts, tree.bucket_gid)
    payload = {f"child_{i}": c.cpu().numpy() for i, c in enumerate(children)}
    payload["aux"] = np.asarray((tree.n_real, tree.num_levels), dtype=np.int64)
    payload["kind"] = np.asarray("morton")
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
    default). Raises ``ValueError`` for a checkpoint this package cannot
    read yet, or one whose float arrays hold NaN."""
    dev = resolve_device(device)
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
        if "kind" not in z.files:
            raise ValueError(
                "legacy classic-tree checkpoint: the classic tree is not "
                f"ported yet (ROADMAP queue 1 item {UNPORTED_ENGINES['tree']})")
        kind = str(z["kind"])
        if kind != "morton":
            item = UNPORTED_ENGINES.get("tree" if kind == "classic" else kind)
            where = f" (ROADMAP queue 1 item {item})" if item else ""
            raise ValueError(f"checkpoint kind {kind!r} is not ported yet{where}")
        children = [torch.from_numpy(np.array(z[f"child_{i}"])).to(dev)
                    for i in range(4)]
        n_real, num_levels = (int(a) for a in z["aux"])
    tree = MortonTree(*children, n_real, num_levels)
    validate_loaded_tree(tree)  # NaN in a checkpoint = corruption, fail here
    return tree, meta
