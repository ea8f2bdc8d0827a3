"""Carry a Morton tree across packages as plain numpy arrays.

:func:`tree_from_arrays` takes the arrays of a JAX ``MortonTree`` (or any
tree with the same layout) and returns this package's tree;
:func:`tree_to_arrays` goes the other way. Tests use the pair to feed both
packages the same index.
"""

from __future__ import annotations

import numpy as np
import torch

from kdtree_tpu_torch import resolve_device
from kdtree_tpu_torch.ops.morton import MortonTree


def tree_from_arrays(node_lo, node_hi, bucket_pts, bucket_gid, n_real,
                     num_levels, device=None) -> MortonTree:
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(dev)

    return MortonTree(put(node_lo, np.float32), put(node_hi, np.float32),
                      put(bucket_pts, np.float32), put(bucket_gid, np.int32),
                      int(n_real), int(num_levels))


def tree_to_arrays(tree: MortonTree) -> dict:
    """The tree's arrays on the host, keyed by :func:`tree_from_arrays`'s
    argument names."""
    return {
        "node_lo": tree.node_lo.cpu().numpy(),
        "node_hi": tree.node_hi.cpu().numpy(),
        "bucket_pts": tree.bucket_pts.cpu().numpy(),
        "bucket_gid": tree.bucket_gid.cpu().numpy(),
        "n_real": tree.n_real,
        "num_levels": tree.num_levels,
    }
