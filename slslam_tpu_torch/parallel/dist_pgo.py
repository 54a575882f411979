"""Distributed pose-graph optimization: edges sharded over the ranks.

Port of ``slslam_tpu/parallel/dist_pgo.py``.  Each rank evaluates the
residuals and Jacobians of its edge shard, sums its edge blocks with K1
over its own block plan, and one all-reduce of (cost, H, g) per assemble
gives every rank the whole system; the small 6V x 6V solve runs alike on
every rank (``ops/pose_graph.pose_graph_opt`` with ``group``).
"""

from __future__ import annotations

from ..ops import pose_graph
from .dist_ba import make_mesh


def dist_pose_graph_opt(group, poses, edges_i, edges_j, constraints, e_valid,
                        pose_free, max_iters=10):
    """Same contract as ``ops.pose_graph.pose_graph_opt``, sharded over the
    ranks of ``group`` (None: the default group).  Every argument is the
    whole graph, on every rank; this rank solves with the contiguous 1/n of
    the edge arrays, as ``P(AXIS)`` splits them in the JAX package.  The
    edge arrays' length must be divisible by the world size (pad with
    e_valid False rows)."""
    group, rank, n = make_mesh(group)
    E = edges_i.shape[0]
    if E % n:
        raise ValueError(f"{E} edges do not split over {n} ranks: pad the "
                         "edge arrays to a multiple of the world size")
    sl = slice(rank * (E // n), (rank + 1) * (E // n))
    return pose_graph.pose_graph_opt(
        poses, edges_i[sl], edges_j[sl], constraints[sl], e_valid[sl],
        pose_free, max_iters=max_iters, group=group)
