"""The port's threefry generation is bit-identical to kdtree_tpu's."""

import numpy as np
import pytest
import torch

from kdtree_tpu.ops import generate as jgen
from kdtree_tpu_torch.ops import generate as tgen

# small tensors: one intra-op thread leaves the cores to the other test
# workers running beside this file
torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1]
DIMS = [1, 3, 8]


def _same_bits(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dim", DIMS)
def test_problem_and_queries(seed, dim):
    jp, jq = jgen.generate_problem(seed, dim, 777, 37)
    tp, tq = tgen.generate_problem(seed, dim, 777, 37, device="cpu")
    _same_bits(jp, tp)
    _same_bits(jq, tq)
    _same_bits(jgen.generate_queries(seed, dim, 37),
               tgen.generate_queries(seed, dim, 37, device="cpu"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dim", DIMS)
def test_rowwise_stream(seed, dim):
    _same_bits(jgen.generate_points_rowwise(seed, dim, 513),
               tgen.generate_points_rowwise(seed, dim, 513, device="cpu"))


@pytest.mark.parametrize("seed", [3, 42])
@pytest.mark.parametrize("windows", [[(0, 100), (100, 1), (101, 299)],
                                     [(0, 7), (7, 393)]])
def test_shard_windows_compose_into_rowwise(seed, windows):
    whole = tgen.generate_points_rowwise(seed, 3, 400, device="cpu")
    parts = [tgen.generate_points_shard(seed, 3, s, r, device="cpu")
             for s, r in windows]
    _same_bits(np.concatenate([p.numpy() for p in parts]), whole)
    for s, r in windows:
        _same_bits(jgen.generate_points_shard(seed, 3, s, r),
                   tgen.generate_points_shard(seed, 3, s, r, device="cpu"))
