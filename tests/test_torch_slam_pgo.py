"""The interactive engine's pose-graph optimization on the port vs JAX.

tests/test_torch_slam_lc.py's small village run (80 frames, float64 on the
CPU, JAX's RANSAC noise, descriptor stream and vocabulary), with the
consistency thresholds lowered to 2 cm and 0.01 rad so that
``consistency_broken()`` (slslam_tpu/engine/slam.py:894-905) trips at the
closures and ``Slam.pose_optimization`` runs: three times, at frames 72,
75 and 78, in JAX's run.  Both engines must run it equally often, at the
same frames, over the same edges and keyframes; the keyframe poses right
after each solve and at the end agree within 1e-8 m or within what the
port moves when the observations from frame 27 on change by 1e-15
relative (the rounding witness of test_torch_slam_lc.py: the windows of
frames 30-36 amplify rounding to ~1e-7 m before any closure)."""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from slslam_tpu import sim as jsim
from slslam_tpu.config import SlamConfig
from slslam_tpu.engine import Slam as JaxSlam
from slslam_tpu.loopclosure import PlaceRecognizer as JaxRecognizer
from slslam_tpu.loopclosure import VocTree as JaxVocTree
from slslam_tpu.loopclosure.voctree import VocTreeParams as JaxParams
from slslam_tpu_torch import sim as tsim
from slslam_tpu_torch.config import SlamConfig as PortConfig
from slslam_tpu_torch.engine import Slam
from slslam_tpu_torch.loopclosure import PlaceRecognizer, VocTree
from slslam_tpu_torch.loopclosure import VocTreeParams
from test_torch_slam import JaxGumbel
from test_torch_slam_lc import OVER, PARAMS, WITNESS_FROM, _continue, village

torch.set_num_threads(1)

PGO_OVER = dict(OVER, pgo_consistency_tr_thr=0.02,
                pgo_consistency_rot_thr=0.01)
ATOL = 1e-8


def _record_pgo(engine):
    """Wrap ``engine.pose_optimization``: each call appends (frame id,
    sorted edges, keyframe translations after the solve)."""
    solves = []
    orig = engine.pose_optimization

    def wrapped():
        orig()
        st = engine.state
        solves.append((engine.frame_id, sorted(st.edge_set),
                       np.stack([st.kfs[i].T.t for i in sorted(st.kfs)])))
    engine.pose_optimization = wrapped
    return solves


def _port(vocab, assigner, nseg):
    t = Slam(dataclasses.replace(PortConfig(), **PGO_OVER), device="cpu",
             gumbel_hook=JaxGumbel(jax.random.PRNGKey(4)))
    t.place_recognizer = PlaceRecognizer(
        VocTree(vocab, VocTreeParams(**PARAMS), device="cpu"),
        min_matches=8, min_similarity=0.8)
    t.descriptor_source = tsim.SegmentDescriptorSource(assigner, nseg,
                                                       noise=0.01, seed=7)
    return t


@pytest.fixture(scope="module")
def pgo_runs(village):
    """JAX's run, the port's, a rounding witness of the port's (the same
    run with the observations from frame WITNESS_FROM on scaled by
    1 + 1e-15 N(0, 1)), each with its keyframes and PGO record."""
    frames, assigner, nseg, vocab = village
    j = JaxSlam(dataclasses.replace(SlamConfig(), **PGO_OVER))
    j.place_recognizer = JaxRecognizer(JaxVocTree(vocab, JaxParams(**PARAMS)),
                                       min_matches=8, min_similarity=0.8)
    j.descriptor_source = jsim.SegmentDescriptorSource(assigner, nseg,
                                                       noise=0.01, seed=7)
    sj = _record_pgo(j)
    kj = [i for i, f in enumerate(frames) if j.process_frame(dict(f), i)]
    t = _port(vocab, assigner, nseg)
    kt = _continue(t, frames[:WITNESS_FROM], 0)
    w = copy.deepcopy(t)
    st, sw = _record_pgo(t), _record_pgo(w)
    kt += _continue(t, frames, WITNESS_FROM)
    kw = _continue(w, frames, WITNESS_FROM, scale=1e-15, seed=2)
    return (j, kj, sj), (t, kt, st), (w, kw, sw)


def test_pose_graph_runs_and_decisions_match_jax(pgo_runs):
    (j, kj, sj), (t, kt, st), (w, kw, sw) = pgo_runs
    n_j = j.stop_watch.stats("pose_graph").count
    assert n_j > 0
    assert t.stop_watch.stats("pose_graph").count == n_j == t.pgo_runs
    assert len(sj) == len(st) == len(sw) == n_j
    assert [s[0] for s in st] == [s[0] for s in sj] == [72, 75, 78]
    assert [s[1] for s in st] == [s[1] for s in sj]
    assert kt == kj
    assert t.lc_cnt == j.lc_cnt >= 1
    assert t.state.edge_set == j.state.edge_set
    assert sorted(t.state.kfs) == sorted(j.state.kfs)
    assert sorted(t.state.lms) == sorted(j.state.lms)
    assert t.sum_num_iteration == j.sum_num_iteration
    # the witness takes the same decisions, so its gap is rounding alone
    assert kw == [k for k in kt if k >= WITNESS_FROM]
    assert [s[1] for s in sw] == [s[1] for s in st]
    assert w.state.edge_set == t.state.edge_set


def test_poses_after_each_pose_graph_solve_match_jax(pgo_runs):
    """After each PGO and at the end: JAX's keyframe positions and the
    port's part by no more than 1e-8 m or the witness's gap, the larger."""
    (j, _, sj), (t, _, st), (w, _, sw) = pgo_runs
    for (_, _, a), (_, _, b), (_, _, c) in zip(sj, st, sw, strict=True):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= max(ATOL, np.max(np.abs(c - b)))
    end = [np.stack([x.t for x in e.trajectory()]) for e in (j, t, w)]
    assert (np.max(np.abs(end[0] - end[1]))
            <= max(ATOL, np.max(np.abs(end[2] - end[1]))))
