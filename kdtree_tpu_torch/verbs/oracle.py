"""Brute-force oracles for the query verbs.

The port of ``kdtree_tpu/verbs/oracle.py``: the exactness referees every
verb answer is held against — the device search, the mutable overlay,
the server endpoints. They run on the points' device (a tensor's own, or
``device`` for a host array: CUDA unless the caller asks for the CPU),
block by block, with the brute-force oracle's direct-subtraction distances
(:func:`kdtree_tpu_torch.ops.bruteforce.block_d2_exact`, the arithmetic of
the jitted ``_block_d2_exact`` of ``kdtree_tpu/ops/bruteforce.py:44`` and
of the device fold), so an answer can be byte-identical rather than
close. Rows come out in the
canonical forms of :mod:`kdtree_tpu_torch.verbs.device`.

Oracles accept the flat padded storage the serving engines already hold
(+inf padding rows, gid -1) — padding and tombstone holes self-exclude
via the gid mask, never via distance screening.
"""

from __future__ import annotations

import numpy as np
import torch

from kdtree_tpu_torch import resolve_device
from kdtree_tpu_torch.ops.bruteforce import block_d2_exact
from kdtree_tpu_torch.verbs.device import VerbResult

_ORACLE_ELEMS = 1 << 24  # (query, point) pairs per distance block


def _inputs(points, gid, device):
    """(points f32[N, D], gid i32[N]) on one device: a tensor's own, else
    ``device``."""
    if isinstance(points, torch.Tensor):
        pts = points.to(torch.float32)
    else:
        pts = torch.from_numpy(np.array(points, dtype=np.float32)).to(
            resolve_device(device))
    dev = pts.device
    if gid is None:
        g = torch.arange(pts.shape[0], dtype=torch.int32, device=dev)
    elif isinstance(gid, torch.Tensor):
        g = gid.to(device=dev, dtype=torch.int32)
    else:
        g = torch.from_numpy(np.array(gid, dtype=np.int32)).to(dev)
    return pts, g


def _on(x, dev) -> torch.Tensor:
    """Caller rows (array or tensor) as f32 on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)


def _block(n_queries: int, n_points: int) -> int:
    return max(1, min(n_points, _ORACLE_ELEMS // max(n_queries, 1)))


def _rows(Q: int, qi, ids, d2=None):
    """Pack hits (query row, id[, d2]) into padded [Q, m] host rows,
    ordered by (d2, id) — or by id without distances — within each row:
    the canonical forms, (+inf, -1) padding last, m = max(count, 1)."""
    dev = qi.device
    order = torch.sort(ids, stable=True).indices
    if d2 is not None:
        order = order[torch.sort(d2[order], stable=True).indices]
    order = order[torch.sort(qi[order], stable=True).indices]
    qi, ids = qi[order], ids[order]
    counts = torch.bincount(qi, minlength=Q)
    m = max(int(counts.max()) if Q else 0, 1)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(qi.numel(), device=dev) - start[qi]
    out_i = torch.full((Q, m), -1, dtype=torch.int32, device=dev)
    out_i[qi, pos] = ids
    out_d = None
    if d2 is not None:
        out_d = torch.full((Q, m), float("inf"), device=dev)
        out_d[qi, pos] = d2[order]
        out_d = out_d.cpu().numpy()
    return out_d, out_i.cpu().numpy()


def radius_oracle(points, queries, r, *, gid=None, with_ids: bool = True,
                  device=None) -> VerbResult:
    """Exhaustive radius answer: every live point with d2 <= r^2 in f32,
    using the device fold's exact distance arithmetic."""
    pts, g = _inputs(points, gid, device)
    q = _on(queries, pts.device)
    Q = q.shape[0]
    r = np.broadcast_to(np.asarray(r, dtype=np.float32), (Q,))
    r2 = torch.as_tensor((r * r).astype(np.float32), device=pts.device)
    counts = torch.zeros(Q, dtype=torch.int64, device=pts.device)
    hq, hi, hd = [], [], []
    step = _block(Q, pts.shape[0])
    for s in range(0, pts.shape[0], step):
        d2 = block_d2_exact(q, pts[s:s + step])
        hit = (d2 <= r2[:, None]) & (g[None, s:s + step] >= 0)
        counts += hit.sum(dim=1)
        if with_ids:
            qi, pi = torch.nonzero(hit, as_tuple=True)
            hq.append(qi)
            hi.append(g[s:s + step][pi])
            hd.append(d2[qi, pi])
    counts_h = counts.cpu().numpy()
    if not with_ids:
        return VerbResult(counts_h, None, None, False, 0)
    if not hq:
        return VerbResult(counts_h, np.full((Q, 1), np.inf, np.float32),
                          np.full((Q, 1), -1, np.int32), False, 0)
    d2p, idp = _rows(Q, torch.cat(hq), torch.cat(hi), torch.cat(hd))
    return VerbResult(counts_h, d2p, idp, False, 0)


def range_oracle(points, box_lo, box_hi, *, gid=None, with_ids: bool = True,
                 device=None) -> VerbResult:
    """Exhaustive box-containment answer (inclusive faces). Pure f32
    comparisons — no arithmetic, so exactness is trivial."""
    pts, g = _inputs(points, gid, device)
    lo = _on(box_lo, pts.device)
    hi_box = _on(box_hi, pts.device)
    Q = lo.shape[0]
    counts = torch.zeros(Q, dtype=torch.int64, device=pts.device)
    hq, hi = [], []
    step = _block(Q, pts.shape[0])
    for s in range(0, pts.shape[0], step):
        blk = pts[s:s + step]
        inside = (g[None, s:s + step] >= 0).expand(Q, blk.shape[0])
        for d in range(pts.shape[1]):
            inside = inside & (blk[None, :, d] >= lo[:, d:d + 1]) & \
                (blk[None, :, d] <= hi_box[:, d:d + 1])
        counts += inside.sum(dim=1)
        if with_ids:
            qi, pi = torch.nonzero(inside, as_tuple=True)
            hq.append(qi)
            hi.append(g[s:s + step][pi])
    counts_h = counts.cpu().numpy()
    if not with_ids:
        return VerbResult(counts_h, None, None, False, 0)
    if not hq:
        return VerbResult(counts_h, None, np.full((Q, 1), -1, np.int32),
                          False, 0)
    _, idp = _rows(Q, torch.cat(hq), torch.cat(hi))
    return VerbResult(counts_h, None, idp, False, 0)


def radius_count_oracle(points, queries, r, *, gid=None,
                        device=None) -> np.ndarray:
    return radius_oracle(points, queries, r, gid=gid, with_ids=False,
                         device=device).counts


def range_count_oracle(points, box_lo, box_hi, *, gid=None,
                       device=None) -> np.ndarray:
    return range_oracle(points, box_lo, box_hi, gid=gid, with_ids=False,
                        device=device).counts
