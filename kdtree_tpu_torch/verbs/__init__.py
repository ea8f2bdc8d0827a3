"""Query verbs beyond k-NN: exact radius, box-range, and count.

The port of ``kdtree_tpu/verbs``. Same exactness contract as the k-NN
stack: tree-pruned device search (``device``) pinned byte-identical to
brute-force oracles (``oracle``), overflow detected and retried rather
than silently truncated. ``wire`` holds the HTTP request/response
contract.
"""

from kdtree_tpu_torch.verbs.device import (
    VerbResult,
    canonical_radius_rows,
    canonical_range_rows,
    radius_search,
    range_search,
)
from kdtree_tpu_torch.verbs.oracle import (
    radius_count_oracle,
    radius_oracle,
    range_count_oracle,
    range_oracle,
)
from kdtree_tpu_torch.verbs.wire import (
    VERBS,
    VerbParseError,
    parse_count_body,
    parse_radius_body,
    parse_range_body,
)

__all__ = [
    "VerbResult",
    "canonical_radius_rows",
    "canonical_range_rows",
    "radius_search",
    "range_search",
    "radius_oracle",
    "range_oracle",
    "radius_count_oracle",
    "range_count_oracle",
    "VERBS",
    "VerbParseError",
    "parse_radius_body",
    "parse_range_body",
    "parse_count_body",
]
