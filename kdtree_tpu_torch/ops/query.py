"""Batched exact (k-)nearest-neighbour queries over the implicit tree.

The port of ``kdtree_tpu/ops/query.py``: the plane-bound DFS of the
classic median-split tree. Each query walks the tree with an explicit
bounded stack of (node, bound): descend into the near child, and push the
far child with its splitting-plane bound ``delta^2``, re-tested against
the *current* k-th best when it is popped.

The reference runs ``_knn_one`` under ``vmap`` in a ``lax.while_loop``;
:func:`_knn_lockstep` runs the same per-query state as one lockstep loop
over the batch, in rounds of ``_ROUND_STEPS`` steps with one look from the
host per round (a CUDA graph per round on the card), as the Morton DFS
does (``ops/morton.py``). Lanes never interact, and a lane whose stack is
empty is frozen, as ``vmap`` of a ``while_loop`` freezes it, so every lane
steps exactly as the reference's loop would. The rules that decide ids:

- a point is taken only on strict ``d2 < worst``, into the slot of the
  *first* largest ``best_d`` (``jnp.argmax``; ``torch.argmax`` also
  returns the first);
- the near side is right on ``delta >= 0`` (so -0.0 goes right);
- the answer ends with a stable 2-key (d2, id) sort.

Distances are ``_arith.sq_dist_rows``'s over the batch's lanes: up to 8
axes the jitted reference rounds each square in the lanes XLA:CPU
vectorizes and fuses them in its scalar tail, and fuses them everywhere
above 8 axes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kdtree_tpu_torch.models.tree import KDTree, tree_spec
from kdtree_tpu_torch.ops._arith import sq_dist, sq_dist_rows
from kdtree_tpu_torch.ops.build import _node_axes
from kdtree_tpu_torch.ops.morton import _ROUND_STEPS, DfsStats, _round_runner
from kdtree_tpu_torch.ops.topk import sort_pairs


def _knn_lockstep(get_node, node_axes: torch.Tensor, heap_size: int, max_depth: int,
                  k: int, queries: torch.Tensor, stats: DfsStats | None,
                  d2_fn=sq_dist_rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of every row of ``queries``, one lane per row.

    ``get_node(node) -> (coords f32[Q, D], id i32[Q], traversable bool[Q])``
    abstracts the tree's storage, as ``_knn_one``'s does: the classic tree
    gathers ``points[node_point[node]]``; ``traversable`` says whether the
    node's subtree may hold real points, and ``id < 0`` that the node's
    own point must not be taken. ``node_axes[i]`` is node i's split axis
    (``level(i) % D``); ``d2_fn(q, p)`` is the distance arithmetic."""
    dev = queries.device
    Q = queries.shape[0]
    best_d = torch.full((Q, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    if Q == 0:
        return best_d, best_i
    cap = max_depth + 2  # one far sibling per level + the live path's head
    # slots at or above a lane's sp are dead, so every step pops, writes its
    # two pushes at sp and sp + 1 unconditionally and advances sp past the
    # real ones
    stack_n = torch.zeros((Q, cap), dtype=torch.int64, device=dev)
    stack_b = torch.zeros((Q, cap), dtype=torch.float32, device=dev)
    sp = torch.ones(Q, dtype=torch.int64, device=dev)  # root pre-pushed, bound 0
    st = stats if stats is not None else DfsStats()
    st.chunks += 1

    def step():  # in place: a captured graph replays on these tensors
        active = sp > 0
        top = (sp - 1).clamp(min=0)[:, None]
        node = stack_n.gather(1, top)[:, 0]
        bound = stack_b.gather(1, top)[:, 0]
        worst = best_d.amax(1)
        nc = node.clamp(0, heap_size - 1)
        p, pidx, traversable = get_node(nc)
        visit = active & (node < heap_size) & traversable & (bound < worst)
        d2 = d2_fn(queries, p)
        # insert into the k-buffer, replacing the first current worst
        wi = best_d.argmax(1, keepdim=True)
        take = (visit & (d2 < worst) & (pidx >= 0))[:, None]
        best_d.scatter_(1, wi, torch.where(take, d2[:, None], best_d.gather(1, wi)))
        best_i.scatter_(1, wi, torch.where(take, pidx[:, None], best_i.gather(1, wi)))
        ax = node_axes[nc][:, None].long()
        delta = (queries.gather(1, ax) - p.gather(1, ax))[:, 0]
        go_right = (delta >= 0).to(torch.int64)
        # pop 1, push far (with its plane bound) then near (always visited)
        sp.sub_(active.to(torch.int64))
        slot = sp[:, None]
        stack_n.scatter_(1, slot, (2 * nc + 2 - go_right)[:, None])
        stack_b.scatter_(1, slot, (delta * delta)[:, None])
        nxt = (slot + 1).clamp(max=cap - 1)
        stack_n.scatter_(1, nxt, (2 * nc + 1 + go_right)[:, None])
        stack_b.scatter_(1, nxt, torch.zeros_like(bound)[:, None])
        sp.add_(2 * visit.to(torch.int64))

    def steps():
        for _ in range(_ROUND_STEPS):
            step()

    run = _round_runner(steps, dev, st)
    while True:
        st.steps += _ROUND_STEPS
        st.syncs += 1
        if not bool((sp > 0).any()):
            break
        run()
    # ascending by (distance, id) for determinism under ties
    return sort_pairs(best_d, best_i)


def _knn_batch(node_point: torch.Tensor, points: torch.Tensor, queries: torch.Tensor,
               k: int, max_depth: int,
               stats: DfsStats | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    heap_size = node_point.shape[0]

    def get_node(node):
        pidx = node_point[node]
        return points[pidx.clamp(min=0).long()], pidx, pidx >= 0

    node_axes = _node_axes(heap_size, points.shape[1], points.device)
    # over a one-node tree XLA:CPU compiles the only point's gather as a
    # slice and fuses the squares at every D
    d2_fn = sq_dist if heap_size == 1 else sq_dist_rows
    return _knn_lockstep(get_node, node_axes, heap_size, max_depth, k, queries, stats,
                         d2_fn)


def _knn_batch_nodes(node_coords: torch.Tensor, node_gid: torch.Tensor,
                     node_traversable: torch.Tensor, queries: torch.Tensor, k: int,
                     max_depth: int,
                     stats: DfsStats | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN over a node-coordinate heap (the global tree's storage): node
    i's point at ``node_coords[i]``, its global id at ``node_gid[i]`` (-1:
    padding or an empty slot), and ``node_traversable[i]`` whether its
    subtree can hold real points."""
    heap_size, d = node_coords.shape

    def get_node(node):
        return node_coords[node], node_gid[node], node_traversable[node]

    node_axes = _node_axes(heap_size, d, node_coords.device)
    return _knn_lockstep(get_node, node_axes, heap_size, max_depth, k, queries, stats)


def knn(tree: KDTree, queries, k: int = 1,
        stats: DfsStats | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN for a batch of queries, on the tree's device.

    Args:
      tree: a built :class:`KDTree`.
      queries: f32[Q, D], a tensor or an array.
      k: neighbours per query (clamped to N).
      stats: if given, accumulates the DFS's steps and host syncs.

    Returns:
      (dists_sq f32[Q, k], indices i32[Q, k]) ascending by (distance, id):
      the same answer as ``kdtree_tpu.knn`` on the same tree.
    """
    queries = torch.as_tensor(queries, dtype=torch.float32, device=tree.device)
    k = min(k, tree.n)
    max_depth = tree_spec(tree.n).num_levels
    return _knn_batch(tree.node_point, tree.points, queries, k, max_depth, stats)


def nearest_neighbor(tree: KDTree, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN convenience wrapper (the reference program's only query mode).

    Returns (dist_sq f32[Q], index i32[Q])."""
    d2, idx = knn(tree, queries, k=1)
    return d2[:, 0], idx[:, 0]
