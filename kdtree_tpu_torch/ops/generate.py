"""Problem generation: JAX's threefry stream, bit for bit, in torch.

The JAX package draws its problems with ``jax.random`` under
``jax_threefry_partitionable=True`` (``kdtree_tpu/ops/generate.py``). The
same seed must give the same points here, so this module re-implements
the pieces of that stream it uses — the seed-to-key rule, ``split``,
``fold_in``, the 32-bit ``random_bits`` and ``uniform``'s mantissa trick —
on int64 tensors masked to 32 bits (torch has no full uint32
arithmetic). Everything runs elementwise on the chosen device, so a
2^24-row cloud is generated on the card without a host round trip.

Shard windows compose exactly like the reference: each row's bits depend
only on (seed, row), so :func:`generate_points_shard` over any cover of
``[0, N)`` concatenates to :func:`generate_points_rowwise`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kdtree_tpu_torch import resolve_device

COORD_MIN = -100.0
COORD_MAX = 100.0

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on int64 tensors holding u32 values;
    the key words and counters broadcast against each other."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _key(seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.key(seed)`` in 32-bit mode: the seed becomes an int32,
    so the high key word is 0 and the low word is its 32 bits."""
    z = torch.zeros((), dtype=torch.int64, device=device)
    return z, z + (int(seed) & _M32)


def _split2(key):
    """``jax.random.split(key, 2)`` (fold-like partitionable form): key i
    is the threefry hash of the counter pair (0, i)."""
    k1, k2 = key
    ctr = torch.arange(2, dtype=torch.int64, device=k1.device)
    b1, b2 = _threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
    return (b1[0], b2[0]), (b1[1], b2[1])


def _fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in`` over a vector of u32 data: one key per
    element, the hash of the counter pair (0, data)."""
    k1, k2 = key
    return _threefry2x32(k1, k2, torch.zeros_like(data), data & _M32)


def _uniform(k1, k2, flat_index: torch.Tensor, dtype=torch.float32):
    """``jax.random.uniform(minval=-100, maxval=100)`` at the given flat
    element indices: partitionable random bits (hash of the 64-bit index
    split hi/lo, words xor-ed), the top 23 bits as a mantissa in [1, 2),
    minus 1, scaled, offset and floored at ``minval``."""
    if dtype != torch.float32:
        raise ValueError(f"only float32 generation is ported, got {dtype}")
    b1, b2 = _threefry2x32(k1, k2, flat_index >> 32, flat_index & _M32)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # XLA fuses ``floats * span + minval`` into one fused multiply-add (one
    # rounding). In float64 the product of a 23-bit mantissa and 200 and
    # the sum with -100 are both exact, so a single cast back to float32
    # rounds exactly once too: the same bits as the fused form.
    scaled = floats.double() * (COORD_MAX - COORD_MIN) + COORD_MIN
    return torch.clamp_min(scaled.float(), COORD_MIN)


def _uniform_block(key, shape, device):
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _uniform(key[0], key[1], idx).reshape(shape)


def generate_problem(
    seed: int, dim: int, num_points: int, num_queries: int = 10,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(points f32[num_points, dim], queries f32[num_queries, dim])``,
    bit-identical to ``kdtree_tpu.generate_problem``."""
    dev = resolve_device(device)
    kp, kq = _split2(_key(seed, dev))
    return (_uniform_block(kp, (num_points, dim), dev),
            _uniform_block(kq, (num_queries, dim), dev))


def generate_queries(seed: int, dim: int, num_queries: int = 10,
                     device=None) -> torch.Tensor:
    """Only the query block of :func:`generate_problem`, without the
    points (the query key does not depend on num_points)."""
    dev = resolve_device(device)
    _, kq = _split2(_key(seed, dev))
    return _uniform_block(kq, (num_queries, dim), dev)


def generate_points_shard(
    seed: int, dim: int, shard_start: int, shard_rows: int, device=None,
) -> torch.Tensor:
    """Rows ``[shard_start, shard_start + shard_rows)`` of the row-wise
    point stream, without generating the rest: row r's key is
    ``fold_in(kp, r)`` and its coordinates are ``uniform(key, (dim,))``."""
    dev = resolve_device(device)
    kp, _ = _split2(_key(seed, dev))
    rows = shard_start + torch.arange(shard_rows, dtype=torch.int64, device=dev)
    r1, r2 = _fold_in(kp, rows)
    col = torch.arange(dim, dtype=torch.int64, device=dev)
    return _uniform(r1[:, None], r2[:, None], col[None, :])


def generate_points_rowwise(seed: int, dim: int, num_points: int,
                            device=None) -> torch.Tensor:
    """Whole-array form of :func:`generate_points_shard` (rows 0..N)."""
    return generate_points_shard(seed, dim, 0, num_points, device=device)
