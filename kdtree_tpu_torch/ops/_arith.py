"""The one distance accumulation every engine of the port shares.

The JAX package's squared distances and box lower bounds are sums of
squares taken axis by axis, ``acc = acc + x * x`` for d = 0..D-1, and
XLA:CPU contracts each step into one fused multiply-add (a single
rounding of ``acc + x*x``). The CUDA scan kernel does the same with
``__fmaf_rn``. Torch exposes no fused multiply-add whose rounding it
promises, so :func:`sq_add` computes the correctly rounded result itself,
in float64: the square of a float32 is exact there, TwoSum gives the sum's
exact error, and rounding the float64 sum to odd before the one cast to
float32 makes that cast round exactly once (53 >= 2 * 24 + 2 bits). The
result is bit for bit the fused form on any device.

Above :data:`FMA_DIM_MAX` axes XLA:CPU compiles the same ``jnp.sum(x * x,
-1)`` differently: the multiply is a fusion of its own, so each square is
rounded, and the sum becomes a ``reduce-window`` of 32 over the row padded
with zeros to a multiple of 32 (half the padding in front, rounded down),
whose window sums are then reduced by the same rule.
:func:`sq_sum_windows` is that sum; the JAX package's eager oracle rounds
its squares at every D and sums them the same way.
"""

from __future__ import annotations

import torch

FMA_DIM_MAX = 32  # above this, jitted sums of squares round each square
ROW_ROUNDED_DIM_MAX = 8  # see sq_dist_rows
_WINDOW = 32


def sq_add(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(x, x, acc)`` for ``acc >= 0`` (or +inf), exactly."""
    a = acc.double()
    p = x.double() * x.double()  # exact: 24-bit mantissa squared
    s = a + p
    bp = s - a
    err = (a - (s - bp)) + (p - bp)  # TwoSum: s + err == a + p exactly
    bits = s.view(torch.int64)
    nudge = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    bits = bits + nudge.to(torch.int64) * torch.where(err > 0, 1, -1)
    return bits.view(torch.float64).float()


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, b, c)``, rounded once, for any signs: the product
    is exact in float64, and the sum is rounded to odd there before the
    one cast to float32, as :func:`sq_add` does."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    bits = s.view(torch.int64)
    nudge = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return (bits + nudge.to(torch.int64) * step).view(torch.float64).float()


def sq_sum_unrolled(xs: list[torch.Tensor]) -> torch.Tensor:
    """The same sum written out as ``acc = 0; acc = acc + x_d * x_d`` in
    straight-line code, as XLA:CPU compiles it: the simplifier drops the
    zero, leaving ``x0*x0 + x1*x1``, whose first product is fused with the
    rounded second; later axes fuse onto the running sum. This is the
    arithmetic of the JAX frontier's box lower bounds."""
    if len(xs) == 1:
        return xs[0] * xs[0]
    acc = sq_add(xs[1] * xs[1], xs[0])
    for x in xs[2:]:
        acc = sq_add(acc, x)
    return acc


def sq_sum_windows(sq: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 sum of ``sq`` over its last axis, for rounded
    squares: up to 32 terms are added in order from the first; a longer row
    is padded with ``p // 2`` zeros in front and ``p - p // 2`` behind (p =
    32 * ceil(D / 32) - D), each window of 32 is added in order, and the
    window sums are reduced by the same rule (a second level past 1,024
    axes)."""
    D = sq.shape[-1]
    if D > _WINDOW:
        w = -(-D // _WINDOW)
        p = w * _WINDOW - D
        sq = torch.nn.functional.pad(sq, (p // 2, p - p // 2))
        sq = sq_sum_windows(sq.reshape(*sq.shape[:-1], w, _WINDOW))
        return sq_sum_windows(sq)
    acc = sq[..., 0]
    for d in range(1, D):
        acc = acc + sq[..., d]
    return acc


def sq_dist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared distances over the last axis of broadcastable ``q`` and
    ``p``: accumulated d = 0..D-1 with :func:`sq_add` up to
    :data:`FMA_DIM_MAX` axes, rounded squares summed by
    :func:`sq_sum_windows` above."""
    D = q.shape[-1]
    if D > FMA_DIM_MAX:
        diff = q - p
        return sq_sum_windows(diff * diff)
    acc = None
    for d in range(D):
        diff = q[..., d] - p[..., d]
        acc = sq_add(torch.zeros_like(diff) if acc is None else acc, diff)
    return acc


def sq_dist_to_box(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Squared distances from ``q`` to the boxes ``[lo, hi]`` over the last
    axis (broadcastable), with the scan kernel's per-warp skip arithmetic:
    per axis the gap ``lo - q`` or ``q - hi``, 0 inside, accumulated
    d = 0..D-1 with :func:`sq_add`, or above :data:`FMA_DIM_MAX` axes
    summed as :func:`sq_dist` sums. Rounding is monotone, so the result is
    never above :func:`sq_dist` to a point inside the box. An empty box
    (lo = +inf, hi = -inf) is at +inf."""
    if q.shape[-1] > FMA_DIM_MAX:
        gap = torch.where(q < lo, lo - q, torch.where(q > hi, q - hi,
                                                      torch.zeros_like(q)))
        return sq_sum_windows(gap * gap)
    acc = None
    for d in range(q.shape[-1]):
        qd, lo_d, hi_d = q[..., d], lo[..., d], hi[..., d]
        gap = torch.where(qd < lo_d, lo_d - qd,
                          torch.where(qd > hi_d, qd - hi_d, torch.zeros_like(qd)))
        acc = sq_add(torch.zeros_like(gap) if acc is None else acc, gap)
    return acc


# (dim, rows) -> vector lanes where XLA:CPU departs from the lane-count rule
# of xla_cpu_vector_rows: its vectorizer also weighs the loop body, which
# grows with D, and then runs a vector epilogue of 4 lanes or none. Found
# by scripts/torch_vector_lanes.py, which runs the reference's classic and
# bucket DFS at every lane count from 1 to 128 and every D up to
# ROW_ROUNDED_DIM_MAX on this x86 host and marks each answer row as the
# rounded form or the FMA chain (both engines gave the same lanes). Above
# 128 lanes only the rule is known to hold, and not everywhere: at D = 7-8,
# 132-252 lanes take a 4-lane epilogue too, while 1,004 lanes do not.
_VECTOR_ROWS_BY_DIM = {
    **{(2, r): 24 for r in range(28, 32)},
    **{(d, r): 36 for d in (4, 5, 6, 7, 8) for r in range(36, 40)},
    **{(d, r): 44 for d in (5, 7, 8) for r in range(44, 48)},
    **{(d, r): r - r % 4 for d in (7, 8) for r in range(52, 129) if r % 8 >= 4},
}


def xla_cpu_vector_rows(rows: int, dim: int) -> int:
    """How many leading lanes of a vmapped loop over ``rows`` lanes of
    ``dim``-axis rows XLA:CPU (LLVM's loop vectorizer, the trip count
    known) runs in vector code on this x86 host; the rest run in the
    scalar tail. From 32 lanes on the vector loop takes 8 at a time; from
    16, 4 at a time; below 16 only exactly 4 or 8 lanes are vectorized —
    except at the (dim, rows) of ``_VECTOR_ROWS_BY_DIM``."""
    if (dim, rows) in _VECTOR_ROWS_BY_DIM:
        return _VECTOR_ROWS_BY_DIM[dim, rows]
    if rows >= 32:
        return rows - rows % 8
    if rows >= 16:
        return rows - rows % 4
    return rows if rows in (4, 8) else 0


def sq_dist_rows(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared distances between the rows of ``q`` and ``p`` (f32[Q, D]),
    as the jitted classic-tree DFS sums ``jnp.sum(diff * diff)`` of one
    point per vmapped lane inside its ``while_loop``, with row i as lane
    i of a program over Q lanes. Up to :data:`ROW_ROUNDED_DIM_MAX` axes
    XLA:CPU unrolls the sum: in the vector code
    (:func:`xla_cpu_vector_rows`) each square is rounded and they are
    added in order, with no fused multiply-add; the scalar tail takes
    :func:`sq_dist`'s FMA chain. Above 8 axes every lane takes
    :func:`sq_dist`'s form."""
    if q.shape[-1] > ROW_ROUNDED_DIM_MAX:
        return sq_dist(q, p)
    rows = q.shape[0]
    body = xla_cpu_vector_rows(rows, q.shape[-1])
    diff = q[:body] - p[:body]
    rounded = sq_sum_windows(diff * diff)
    if body == rows:
        return rounded
    return torch.cat([rounded, sq_dist(q[body:], p[body:])])
