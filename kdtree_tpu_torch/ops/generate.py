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

The Gaussian-mixture generators (:func:`generate_clustered`,
:func:`generate_points_shard_clustered`) also port ``jax.random.randint``
and ``jax.random.normal``. The normal draw is ``sqrt(2) * erf_inv(u)``, and
``torch.erfinv`` is not XLA's ``erf_inv``: :func:`_erf_inv` is the
polynomial XLA:CPU compiles, operation for operation, with its fused
multiply-adds, bit-equal to the jitted reference on every input ``normal``
can draw.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kdtree_tpu_torch import resolve_device
from kdtree_tpu_torch.ops._arith import fma

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


def _split(k1, k2, n: int):
    """``jax.random.split(key, n)`` of one key or of a tensor of keys:
    key i is the threefry hash of the counter pair (0, i)."""
    out = []
    for i in range(n):
        c = torch.full_like(k1, i)
        out.append(_threefry2x32(k1, k2, torch.zeros_like(c), c))
    return out


def _bits(k1, k2, flat_index: torch.Tensor) -> torch.Tensor:
    """Partitionable 32-bit ``random_bits`` at the given flat element
    indices: the hash of the 64-bit index split hi/lo, words xor-ed."""
    b1, b2 = _threefry2x32(k1, k2, flat_index >> 32, flat_index & _M32)
    return b1 ^ b2


def _unit(k1, k2, flat_index: torch.Tensor) -> torch.Tensor:
    """The top 23 bits as a mantissa in [1, 2), minus 1: ``uniform``'s
    float32 draw in [0, 1)."""
    bits = (_bits(k1, k2, flat_index) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _uniform(k1, k2, flat_index: torch.Tensor, dtype=torch.float32):
    """``jax.random.uniform(minval=-100, maxval=100)`` at the given flat
    element indices: partitionable random bits (hash of the 64-bit index
    split hi/lo, words xor-ed), the top 23 bits as a mantissa in [1, 2),
    minus 1, scaled, offset and floored at ``minval``."""
    if dtype != torch.float32:
        raise ValueError(f"only float32 generation is ported, got {dtype}")
    floats = _unit(k1, k2, flat_index)
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


# ---------------------------------------------------------------------------
# the Gaussian-mixture stream: randint, normal and XLA's float32 erf_inv
# ---------------------------------------------------------------------------


def _c(bits: int) -> float:
    """A float32 constant given by its float64 bit pattern, as it appears
    in the compiled code."""
    return float(torch.tensor(bits, dtype=torch.int64).view(torch.float64))


_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)
_LOG1P_DEN = (0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
              0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000)
_LOG1P_NUM = (0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
              0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
              0x40340A2020000000)
# erf_inv's coefficients, (w < 5, w >= 5) pairs, highest degree first
_ERF_INV = ((2.81022636e-08, -0.000200214257), (3.43273939e-07, 0.000100950558),
            (-3.5233877e-06, 0.00134934322), (-4.39150654e-06, -0.00367342844),
            (0.00021858087, 0.00573950773), (-0.00125372503, -0.0076224613),
            (-0.00417768164, 0.00943887047), (0.246640727, 1.00167406),
            (1.50140941, 2.83297682))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, x)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p`` for x in (-1, 0]: a rational function
    below |x| = sqrt(2) - 1, else its Cephes ``log`` of the rounded 1 + x.
    Each fused multiply-add is where the compiled code has one."""
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    # log(1 + x): mantissa m in [0.5, 1), exponent e
    v = torch.clamp_min(x + 1.0, 2.0 ** -126)
    b = v.view(torch.int32)
    m = ((b & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((b >> 23) - 127).float() + 1.0
    small = m < 0.707106781186547524
    t = (m - 1.0) + torch.where(small, m, zero)
    e = e - torch.where(small, one, zero)
    t2 = t * t
    t3 = t2 * t
    p = [_f32(c, t) for c in _LOG_P]
    y = fma(fma(t, p[0], p[1]), t, p[2])
    y1 = fma(fma(t, p[3], p[4]), t, p[5])
    y2 = fma(fma(t, p[6], p[7]), t, p[8])
    y = fma(fma(y, t3, y1), t3, y2)
    y = fma(y, t3, e * -2.12194440e-4)
    large = fma(e, _f32(0.693359375, t), (t - t2 * 0.5) + y)
    # the rational form near 0
    x2 = x * x
    z = x * 0.0
    den = z + 1.0
    for c in _LOG1P_DEN:
        den = fma(den, x, _f32(_c(c), x))
    num = z + _c(_LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma(num, x, _f32(_c(c), x))
    near = x + (x2 * -0.5 + (x * x2) * (num.double() / den.double()).float())
    return torch.where(x.abs() < _c(0x3FDA8279A0000000), near, large)


def _erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' two-branch polynomial in
    w = -log1p(-u^2)), as XLA:CPU compiles it; +-inf at +-1, subnormal
    results flushed to zero. Square roots
    and quotients are taken in float64 and rounded once (correctly
    rounded, like the compiled code's)."""
    lg = _log1p(u * (-u))
    lt = lg > -5.0
    w = torch.where(lt, -2.5 - lg,
                    torch.sqrt((-lg).double()).float() + -3.0)

    def coef(i):
        a, b = _ERF_INV[i]
        return torch.where(lt, _f32(a, u), _f32(b, u))

    p = fma(coef(0), w, coef(1))
    for i in range(2, len(_ERF_INV)):
        p = fma(w, p, coef(i))
    r = p * u
    # XLA:CPU runs with subnormals flushed to zero (sign kept); only inputs
    # below 2^-126 reach that range, and normal's draw has none
    r = torch.where(r.abs() < 2.0 ** -126, r * 0.0, r)
    return torch.where(u.abs() == 1.0, u * float("inf"), r)


_SQRT2 = 1.4142135381698608  # np.sqrt(2) as float32
_NORMAL_LO = -0.99999994  # nextafter(-1, 0) in float32


def _erf_inv_draw(k1, k2, flat_index: torch.Tensor) -> torch.Tensor:
    """``erf_inv(u)`` of ``jax.random.normal``'s uniform draw on
    [nextafter(-1, 0), 1) at the given flat indices; the normal sample is
    this times sqrt(2) (:func:`_mixture` applies the factor)."""
    u = torch.clamp_min(_unit(k1, k2, flat_index) * 2.0 + _NORMAL_LO, _NORMAL_LO)
    return _erf_inv(u)


def _randint(k1, k2, flat_index: torch.Tensor, span: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, span)`` at the given flat
    indices: two 32-bit draws from the key's split, combined modulo
    ``span`` as the reference's u32 arithmetic does."""
    (h1, h2), (l1, l2) = _split(k1, k2, 2)
    hi = _bits(h1, h2, flat_index)
    lo = _bits(l1, l2, flat_index)
    mult = ((1 << 16) % span) ** 2 % span
    return ((((hi % span) * mult) & _M32) + lo % span) % span


def _mixture(centers, assign, e, stddev: float) -> torch.Tensor:
    """``centers[assign] + stddev * normal`` with ``normal = sqrt(2) * e``
    as the jitted reference compiles it: XLA folds ``stddev * sqrt(2)``
    into one float32 constant and fuses the multiply-add."""
    return fma(e, torch.full_like(e, _SQRT2 * stddev), centers[assign])


def _centers(kc, num_clusters: int, dim: int, device):
    return _uniform_block(kc, (num_clusters, dim), device)


def generate_clustered(
    seed: int, dim: int, num_points: int, num_queries: int = 10,
    num_clusters: int = 8, stddev: float = 2.0, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Gaussian-mixture problem ``(points f32[N, D], queries f32[Q,
    D])``, bit-identical to ``kdtree_tpu.ops.generate.generate_clustered``:
    ``num_clusters`` centers uniform on the generator domain, each row a
    center plus N(0, stddev^2) noise."""
    dev = resolve_device(device)
    kc, ka, kn, kqa, kqn = _split(*_key(seed, dev), 5)
    centers = _centers(kc, num_clusters, dim, dev)

    def draw(kassign, knoise, rows):
        idx = torch.arange(rows, dtype=torch.int64, device=dev)
        assign = _randint(kassign[0], kassign[1], idx, num_clusters)
        flat = torch.arange(rows * dim, dtype=torch.int64, device=dev)
        noise = _erf_inv_draw(knoise[0], knoise[1], flat).reshape(rows, dim)
        return _mixture(centers, assign, noise, stddev)

    return draw(ka, kn, num_points), draw(kqa, kqn, num_queries)


def generate_points_shard_clustered(
    seed: int, dim: int, shard_start: int, shard_rows: int,
    num_clusters: int = 8, stddev: float = 2.0, device=None,
) -> torch.Tensor:
    """Rows ``[shard_start, shard_start + shard_rows)`` of the clustered
    row stream, bit-identical to the reference's: the centers come from
    the seed key alone, and row r folds r into the row key for its
    (assignment, noise) draws, so shard windows compose across device
    counts."""
    dev = resolve_device(device)
    kc, kr = _split(*_key(seed, dev), 2)
    centers = _centers(kc, num_clusters, dim, dev)
    rows = shard_start + torch.arange(shard_rows, dtype=torch.int64, device=dev)
    r1, r2 = _fold_in(kr, rows)
    (a1, a2), (n1, n2) = _split(r1, r2, 2)
    zero = torch.zeros_like(rows)
    assign = _randint(a1, a2, zero, num_clusters)
    col = torch.arange(dim, dtype=torch.int64, device=dev)
    noise = _erf_inv_draw(n1[:, None], n2[:, None], col[None, :])
    return _mixture(centers, assign, noise, stddev)
