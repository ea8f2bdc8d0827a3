"""Hilbert-curve codes (Skilling's transpose algorithm), u32 in int64.

The port of ``kdtree_tpu/ops/hilbert.py``: the jump-free space-filling
order the tiled query engine sorts its queries by, so that any window of
consecutive sorted queries is a connected region with a tight box. Per-axis
cells are transformed in place by ``bits`` rounds of conditional
exchange/invert against axis 0, Gray-decoded, and their bits interleaved
most significant first. Values stay below 2^32 in int64 tensors.
"""

from __future__ import annotations

import torch

from kdtree_tpu_torch.ops.morton import quantize


def _quantize(points: torch.Tensor, bits: int) -> list[torch.Tensor]:
    """Per-axis cell coords in [0, 2^bits), the Morton build's rule."""
    cells = quantize(points, bits)
    return [cells[:, a] for a in range(points.shape[1])]


def hilbert_codes(points: torch.Tensor, bits: int) -> torch.Tensor:
    """Hilbert indices; ``bits`` quantization bits per axis. When
    ``bits * D > 32`` only the leading axes that fit order the points (the
    reference's degradation: consumers need an order, not this order)."""
    n, d = points.shape
    if bits * d > 32:
        d = max(32 // max(bits, 1), 1)
        points = points[:, :d]
    x = _quantize(points, bits)
    if d == 1:
        return x[0]

    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        for i in range(d):
            high = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            x0 = x[0]
            x[0] = torch.where(high, x0 ^ p, x0 ^ t)
            if i:
                x[i] = torch.where(high, x[i], x[i] ^ t)
        q >>= 1

    for i in range(1, d):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros(n, dtype=torch.int64, device=points.device)
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((x[d - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    for i in range(d):
        x[i] = x[i] ^ t

    code = torch.zeros(n, dtype=torch.int64, device=points.device)
    for b in range(bits):
        for i in range(d):
            pos = (bits - 1 - b) * d + (d - 1 - i)
            code = code | (((x[i] >> (bits - 1 - b)) & 1) << pos)
    return code
