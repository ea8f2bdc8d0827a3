"""The k-buffer merge shared by the bucketed tree queries.

The port of ``kdtree_tpu/ops/topk.py``. A query collects up to V
candidate buckets, computes a dense [V*B] block of squared distances, and
folds it into its ascending k-buffer. The invariants carry over unchanged:
+inf lanes never displace a real candidate, and only distances decide
unless they are equal, when the smaller id comes first (a -1 padding id
can only tie another +inf entry, and every such entry is discardable).

The functions work on any leading batch shape: the reference's per-query
vectors are the case of no leading axes.

Tie rules, as in the reference:

- the candidate pre-selection is ``lax.top_k(-d2, kk)``, which keeps the
  lowest index first among equal values; a stable ascending sort does the
  same (``torch.topk``'s tie order is unspecified, so it is not used);
- the merge is ``lax.sort((d, i), num_keys=2, is_stable=True)``; two stable
  sorts, by id and then by distance, give the same order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kdtree_tpu_torch.ops._arith import sq_dist


def sort_pairs(d: torch.Tensor, i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort (d, i) along the last axis by d, then by i, stably."""
    i, perm = torch.sort(i, dim=-1, stable=True)
    d = d.gather(-1, perm)
    d, perm = torch.sort(d, dim=-1, stable=True)
    return d, i.gather(-1, perm)


def merge_topk(best_d: torch.Tensor, best_i: torch.Tensor, cand_d2: torch.Tensor,
               cand_gid: torch.Tensor, enabled) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold candidates (d2 f32[..., M], gid i32[..., M]) into the ascending
    k-buffer (best_d f32[..., k], best_i i32[..., k]); rows whose
    ``enabled`` (bool, broadcast over the leading axes) is false keep their
    buffer."""
    k = best_d.shape[-1]
    kk = min(k, cand_d2.shape[-1])
    sel_d, sel = torch.sort(cand_d2, dim=-1, stable=True)
    all_d = torch.cat([best_d, sel_d[..., :kk]], dim=-1)
    all_i = torch.cat([best_i, cand_gid.gather(-1, sel[..., :kk])], dim=-1)
    all_d, all_i = sort_pairs(all_d, all_i)
    en = torch.as_tensor(enabled, device=best_d.device)[..., None]
    return (torch.where(en, all_d[..., :k], best_d),
            torch.where(en, all_i[..., :k], best_i))


def scan_bucket_block(q: torch.Tensor, bucket_pts: torch.Tensor, bucket_gid: torch.Tensor,
                      blist: torch.Tensor, bcnt: torch.Tensor, best_d: torch.Tensor,
                      best_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-scan the collected buckets and merge them into the k-buffer.

    q f32[..., D]; bucket_pts f32[NB, B, D] (+inf padding); bucket_gid
    i32[NB, B] (-1 padding); blist i32[..., V] bucket indices (-1 = empty
    slot); bcnt i32[...]. Distances accumulate axis by axis with one fused
    multiply-add each (``_arith.sq_dist``), as the jitted reference does."""
    bsel = blist.clamp(min=0).long()
    pts_v = bucket_pts[bsel]  # [..., V, B, D]
    gid_v = bucket_gid[bsel]  # [..., V, B]
    d2_v = sq_dist(q[..., None, None, :], pts_v)  # [..., V, B] (inf at padding)
    d2_v = torch.where((blist >= 0)[..., None], d2_v, float("inf"))
    return merge_topk(best_d, best_i, d2_v.flatten(-2), gid_v.flatten(-2), bcnt > 0)
