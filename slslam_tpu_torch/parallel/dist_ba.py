"""Distributed windowed bundle adjustment, line-sharded, over
``torch.distributed``.

Port of ``slslam_tpu/parallel/dist_ba.py``.  Where the JAX package runs one
SPMD program over a ``jax.sharding.Mesh`` (``shard_map`` around the LM
``while_loop``), the port runs one process per rank: each holds the whole
replicated state (cameras, the reduced camera system) and its own line
shard with the observations of those lines, and each ``psum`` becomes an
all-reduce on the process group (``parallel/comm.py``).  Every rank
eliminates its own 4x4 line blocks; per LM iteration the only collectives
are the sums of {Hcc, gc}, of the (6C x 6C) coupling with its rhs, and of
a few scalars, so the bytes sent do not grow with the number of lines or
observations (``ops/schur_ba.local_ba`` with ``group``).  The reduced
camera system is solved alike on every rank.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ..ops import schur_ba


def make_mesh(group=None):
    """(group, rank, world size) of ``group``, the default process group
    (``dist.group.WORLD``) unless one is passed (the JAX ``make_mesh``,
    dist_ba.py:34-37).  Raises unless ``torch.distributed`` is
    initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialized: start the "
            "ranks with torchrun, or call parallel.initialize_multihost "
            "(or dist.init_process_group) in each rank first")
    group = dist.group.WORLD if group is None else group
    return group, dist.get_rank(group), dist.get_world_size(group)


def partition_by_line(line_orth, line_free, obs, obs_cam, obs_line,
                      obs_valid, n_shards):
    """Partition a BA problem by line for dist_local_ba_lines (a copy of
    dist_ba.py:39-89; numpy only).

    Lines are dealt round-robin to shards (balances observation counts for
    typical windows); each shard receives its lines plus the observations of
    those lines, with obs_line rewritten to local indices.  All shards are
    padded to identical sizes.  Returns the stacked per-shard arrays
    (leading axis = shard) plus the line permutation needed to undo the
    reordering of the returned line array.
    """
    L = len(line_orth)
    shard_of = np.arange(L) % n_shards
    local_of = np.arange(L) // n_shards
    Lp = (L + n_shards - 1) // n_shards

    obs_shard = shard_of[obs_line]
    obs_local = local_of[obs_line]

    counts = np.bincount(obs_shard[np.asarray(obs_valid, bool)],
                         minlength=n_shards)
    Op = max(int(counts.max()) if len(counts) else 1, 1)
    # round up for friendly tiling
    Op = int(2 ** np.ceil(np.log2(max(Op, 8))))

    lo = np.zeros((n_shards, Lp, 4), np.asarray(line_orth).dtype)
    lo[:, :, 3] = 0.5
    lf = np.zeros((n_shards, Lp), bool)
    ob = np.zeros((n_shards, Op, 8), np.asarray(obs).dtype)
    oc = np.zeros((n_shards, Op), np.int32)
    ol = np.zeros((n_shards, Op), np.int32)
    ov = np.zeros((n_shards, Op), bool)

    for s in range(n_shards):
        sel = shard_of == s
        lo[s, :sel.sum()] = np.asarray(line_orth)[sel]
        lf[s, :sel.sum()] = np.asarray(line_free)[sel]
        osel = (obs_shard == s) & np.asarray(obs_valid, bool)
        n = osel.sum()
        ob[s, :n] = np.asarray(obs)[osel]
        oc[s, :n] = np.asarray(obs_cam)[osel]
        ol[s, :n] = obs_local[osel]
        ov[s, :n] = True

    # permutation: global line i lives at (shard_of[i], local_of[i]) ->
    # flattened position shard_of[i] * Lp + local_of[i]
    perm = shard_of * Lp + local_of
    return lo, lf, ob, oc, ol, ov, perm


def dist_local_ba_lines(group, cam_wt, line_orth, obs, obs_cam, obs_line,
                        obs_valid, cam_free, line_free, baseline,
                        huber_delta, robust=True, max_iters=10,
                        line_param="orth"):
    """Line-sharded distributed BA on this rank of ``group``
    (dist_ba.py:92-132).

    ``cam_wt`` and ``cam_free`` are replicated; ``line_orth``,
    ``line_free``, ``obs``, ``obs_cam``, ``obs_line`` and ``obs_valid`` are
    this rank's row of ``partition_by_line``'s stacked arrays, as tensors.
    Returns (cam_wt' (replicated), this rank's line_orth' (Lp, 4),
    BAStats); ``parallel.comm.all_gather_shards`` stacks the ranks' lines,
    and ``perm`` puts them back in global order.  ``group`` None is the
    default group."""
    group, _, _ = make_mesh(group)
    return schur_ba.local_ba(
        cam_wt, line_orth, obs, obs_cam, obs_line, obs_valid, cam_free,
        line_free, baseline, huber_delta, robust=robust,
        max_iters=max_iters, line_param=line_param, group=group)
