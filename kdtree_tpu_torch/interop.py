"""Carry a tree across packages as plain numpy arrays.

:func:`tree_from_arrays` takes the arrays of a JAX ``MortonTree``,
``KDTree`` or ``BucketKDTree`` (or any tree with the same layout) and
returns this package's tree of that kind; :func:`tree_to_arrays` goes the
other way. Tests use the pair to feed both packages the same index.
"""

from __future__ import annotations

import numpy as np
import torch

from kdtree_tpu_torch import resolve_device
from kdtree_tpu_torch.utils.checkpoint import KINDS

# the integer arrays of every kind; the rest are float32
_INT_ARRAYS = ("node_point", "node_gid", "node_bucket", "bucket_gid")


def tree_from_arrays(*args, kind: str = "morton", device=None, **named):
    """The tree of ``kind`` ("morton", "classic" or "bucket") from its
    arrays and ints, given in the reference's child order and then its
    aux ints (for a Morton tree: node_lo, node_hi, bucket_pts, bucket_gid,
    n_real, num_levels), or by those names."""
    cls, names, aux = KINDS[kind]
    fields = names + aux
    values = dict(zip(fields, args), **named)
    if sorted(values) != sorted(fields):
        raise TypeError(f"a {kind} tree takes {fields}, got {sorted(values)}")
    dev = resolve_device(device)

    def put(name):
        dtype = np.int32 if name in _INT_ARRAYS else np.float32
        return torch.from_numpy(np.array(values[name], dtype=dtype, copy=True)).to(dev)

    return cls(*(put(a) for a in names), *(int(values[a]) for a in aux))


def tree_to_arrays(tree) -> dict:
    """The tree's arrays on the host and its ints, keyed by
    :func:`tree_from_arrays`'s names, with its ``kind``."""
    kind = next(k for k, (cls, _, _) in KINDS.items() if isinstance(tree, cls))
    _, names, aux = KINDS[kind]
    out = {a: getattr(tree, a).cpu().numpy() for a in names}
    out.update({a: getattr(tree, a) for a in aux}, kind=kind)
    return out
