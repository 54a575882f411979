"""The port's pose-graph optimizer (slslam_tpu_torch/ops/pose_graph.py) and
the deferred loop closure's stitch against JAX's.

The drifted odometry ring of tests/test_batch_lc.py (24 keyframes around a
circle, systematic drift on every edge) with a perfect loop edge, in
float64 on the CPU: ``pose_graph_opt`` takes the same LM iterations as
JAX's and lands within 1e-9 (poses), with and without the Huber edge loss;
``_pose_graph_stitch`` takes the same branch as JAX's (PGO run, or skipped
on a consistent graph) and gives the same trajectory within 1e-9 m."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.config import SlamConfig
from slslam_tpu.engine import batch_lc as jlc
from slslam_tpu.engine.batch import BatchResult
from slslam_tpu.ops import pose_graph as jpg
from slslam_tpu_torch import hostgeom as thost
from slslam_tpu_torch.config import SlamConfig as TSlamConfig
from slslam_tpu_torch.engine import batch_lc as tlc
from slslam_tpu_torch.engine.batch import BatchResult as TBatchResult
from slslam_tpu_torch.ops import pose_graph as tpg

from test_batch_lc import TestPoseGraphStitch

torch.set_num_threads(1)

JCFG = dataclasses.replace(SlamConfig(), compute_dtype="float64")
TCFG = dataclasses.replace(TSlamConfig(), compute_dtype="float64")


def _chain(drift):
    return TestPoseGraphStitch()._chain(drift=drift)


def _graph(drift=0.5):
    """(poses (K,6) world->cam, ei, ej, c, valid, free) of the ring with
    the loop edge 0 -> K-1."""
    gt, _, edges, traj = _chain(drift)
    K = len(traj)
    poses = np.stack([T.inv().wt() for T in traj])
    ei = np.concatenate([np.arange(K - 1), [0]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, K), [K - 1]]).astype(np.int32)
    c = np.concatenate([edges, [(gt[-1] @ gt[0].inv()).wt()]])
    free = np.ones(K, bool)
    free[0] = False
    return poses, ei, ej, c, np.ones(len(ei), bool), free


def test_edge_residual_jac_matches_jax():
    poses, ei, ej, c, _, _ = _graph()
    rj, j1j, j2j = jpg._edge_rj_batch(jnp.asarray(poses[ei]),
                                      jnp.asarray(poses[ej]), jnp.asarray(c))
    rt, j1t, j2t = tpg.edge_residual_jac(torch.as_tensor(poses[ei]),
                                         torch.as_tensor(poses[ej]),
                                         torch.as_tensor(c))
    for a, b in ((rj, rt), (j1j, j1t), (j2j, j2t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("huber_delta", [None, 0.25])
def test_pose_graph_opt_matches_jax(huber_delta):
    poses, ei, ej, c, ev, free = _graph()
    out_j, st_j = jpg.pose_graph_opt(
        jnp.asarray(poses), jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(c),
        jnp.asarray(ev), jnp.asarray(free), max_iters=10,
        huber_delta=huber_delta)
    out_t, st_t = tpg.pose_graph_opt(
        torch.as_tensor(poses), torch.as_tensor(ei), torch.as_tensor(ej),
        torch.as_tensor(c), torch.as_tensor(ev), torch.as_tensor(free),
        max_iters=10, huber_delta=huber_delta)
    assert int(st_t.iterations) == int(st_j.iterations) > 1
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(float(st_t.initial_cost),
                               float(st_j.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(st_t.final_cost), float(st_j.final_cost),
                               rtol=1e-8, atol=1e-14)
    assert float(st_t.final_cost) < float(st_t.initial_cost)
    np.testing.assert_array_equal(out_t.numpy()[0], poses[0])


def test_padded_edges_inert():
    """Invalid (padding) edges change nothing."""
    poses, ei, ej, c, ev, free = _graph()
    t = torch.as_tensor
    a, sa = tpg.pose_graph_opt(t(poses), t(ei), t(ej), t(c), t(ev), t(free))
    pad = 5
    b, sb = tpg.pose_graph_opt(
        t(poses), t(np.concatenate([ei, np.zeros(pad, np.int32)])),
        t(np.concatenate([ej, np.full(pad, 3, np.int32)])),
        t(np.concatenate([c, np.ones((pad, 6))])),
        t(np.concatenate([ev, np.zeros(pad, bool)])), t(free))
    assert int(sa.iterations) == int(sb.iterations)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12, atol=1e-12)


def _results(drift):
    gt, _, edges, traj = _chain(drift)
    K = len(traj)
    jres = BatchResult(trajectory=traj, edges_wt=edges,
                       is_kf=np.ones(K, bool), kf_count=K, landmarks=[],
                       stats={}, per_frame={})
    ttraj = [thost.Pose(T.R, T.t) for T in traj]
    tres = TBatchResult(trajectory=ttraj, edges_wt=edges,
                        is_kf=np.ones(K, bool), kf_count=K, landmarks=[],
                        stats={}, per_frame={})
    loop = [(0, K - 1, (gt[-1] @ gt[0].inv()).wt())]
    return jres, tres, loop


@pytest.mark.parametrize("drift", [0.5, 0.0])
def test_pose_graph_stitch_matches_jax(drift):
    """drift 0.5 breaks the consistency check (PGO runs); drift 0 keeps
    the graph consistent (PGO skipped, the replay's trajectory returned)."""
    jres, tres, loop = _results(drift)
    traj_j, st_j = jlc._pose_graph_stitch(jres, loop, JCFG, jnp.float64)
    traj_t, st_t = tlc._pose_graph_stitch(tres, loop, TCFG, torch.float64,
                                          "cpu")
    assert (st_t is None) == (st_j is None) == (drift == 0.0)
    if st_j is not None:
        assert int(st_t.iterations) == int(st_j.iterations)
    d = max(np.linalg.norm(a.t - b.t) for a, b in zip(traj_j, traj_t))
    assert d <= 1e-9, d
    for a, b in zip(traj_j, traj_t):
        np.testing.assert_allclose(b.R, a.R, atol=1e-9)
