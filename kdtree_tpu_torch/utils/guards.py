"""Input guards: fail loudly at the edges instead of silently mis-sorting."""

from __future__ import annotations

import torch

_MAX_ROWS_I32 = 1 << 31  # global point ids are int32 everywhere


def check_rows_fit_i32(n: int, what: str) -> None:
    """Global point ids (``bucket_gid``, result ids) are int32 throughout
    the engines; rows past 2**31-1 would wrap their gids negative and be
    silently treated as padding by every downstream mask — data loss, not
    an error. Refuse crisply at the door instead."""
    if n >= _MAX_ROWS_I32:
        raise ValueError(
            f"{what} has {n} rows, but global point ids are int32 "
            f"(max {_MAX_ROWS_I32 - 1} rows per index); split the data "
            "across multiple forests"
        )


def validate_loaded_tree(tree) -> None:
    """Checkpoint-load guard: NaN anywhere in a tree's float arrays is
    corruption (inf is legal padding in bucket and box arrays). A forest's
    per-shard lists count as one stacked [P, ...] array."""
    for t in vars(tree).values():
        for x in t if isinstance(t, list) else [t]:
            if isinstance(x, torch.Tensor) and x.is_floating_point() \
                    and bool(torch.isnan(x).any()):
                shape = ((len(t),) if isinstance(t, list) else ()) + tuple(x.shape)
                raise ValueError(
                    f"loaded tree contains NaN in a {shape} array — "
                    "checkpoint is corrupt"
                )
