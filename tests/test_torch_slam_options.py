"""The port's interactive engine with the options of its window BA, vs JAX.

aid lines, window anchors and the BA init jitter together (every frame a
keyframe; the jitter is JAX's numpy stream, default_rng((rseed, frame,
0x0B0A))) on the CPU in float64 against the JAX engine fed the same RANSAC
noise: identical keyframes, edges, landmarks and window LM iterations,
trajectories within 1e-8 m.  And the gc_landmarks lifecycle of
tests/test_lifecycle.py on the port."""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from slslam_tpu_torch.config import SlamConfig as PortConfig
from slslam_tpu_torch.engine import Slam
from slslam_tpu_torch.engine import state as tstate
from slslam_tpu_torch.sim import (StereoLineRenderer, house_segments,
                                  wave_trajectory)
from test_torch_slam import JaxGumbel, _assert_same_run, _both, _frames

torch.set_num_threads(1)


def test_aid_anchors_and_jitter_match_jax():
    """Every frame a keyframe, aid lines, window anchors and the BA init
    jitter (JAX's numpy stream, default_rng((rseed, frame, 0x0B0A)))."""
    j, t, kj, kt = _both(_frames(10), kf_rot_thr=1e-9, kf_tr_thr=1e-9,
                         line_param="aid", window_anchor_sigma_rot=0.01,
                         window_anchor_sigma_t=0.05, ba_init_jitter=0.01)
    assert len(kj) == 10
    _assert_same_run(j, t, kj, kt, atol=1e-8)
    # the options change the solve: without them the run lands elsewhere
    plain = Slam(dataclasses.replace(PortConfig(), compute_dtype="float64",
                                     kf_rot_thr=1e-9, kf_tr_thr=1e-9),
                 device="cpu",
                 gumbel_hook=JaxGumbel(jax.random.PRNGKey(4)))
    for i, f in enumerate(_frames(10)):
        plain.process_frame(f, i)
    assert plain.sum_num_iteration != t.sum_num_iteration


_ONESHOT_BASE = 900000   # synthetic feature ids observed exactly once


def _lifecycle(gc_landmarks, num_frames=24):
    """tests/test_lifecycle.py's run on the port: every frame a keyframe,
    window 4, one single-shot feature injected per frame."""
    cfg = dataclasses.replace(
        PortConfig(), compute_dtype="float64", kf_rot_thr=1e-9,
        kf_tr_thr=1e-9, ba_window_size=4, gc_landmarks=gc_landmarks,
        obs_buckets=(1024,), cam_buckets=(16,), line_buckets=(256,),
        corr_buckets=(128,))
    ren = StereoLineRenderer(house_segments(), cfg.camera, noise_px=0.2,
                             seed=3)
    slam = Slam(cfg, device="cpu")
    for i, T in enumerate(wave_trajectory(num_frames=64)[:num_frames]):
        frame = ren.observe(T)
        if frame:
            frame[_ONESHOT_BASE + i] = np.asarray(
                next(iter(frame.values()))).copy()
        slam.process_frame(frame, i)
    return slam


@pytest.fixture(scope="module")
def lifecycle_runs():
    return _lifecycle(False), _lifecycle(True)


def test_gc_landmarks_lifecycle(lifecycle_runs):
    """The gc_landmarks lifecycle of tests/test_lifecycle.py: one-shot
    non-members survive with gc on and off; the deletion mechanism drops
    member singletons and stale references and keeps twice-observed
    members; gc does not move the trajectory."""
    off, on = lifecycle_runs
    for s in (off, on):
        assert len([f for f in s.state.lms if f >= _ONESHOT_BASE]) >= 15
    twice = [{f for f, lm in s.state.lms.items()
              if lm.twice_observed and f < _ONESHOT_BASE} for s in (off, on)]
    assert twice[0] == twice[1]
    np.testing.assert_allclose(np.stack([T.t for T in on.trajectory()]),
                               np.stack([T.t for T in off.trajectory()]),
                               atol=1e-9)

    slam = copy.deepcopy(on)
    st = slam.state
    kid = sorted(set(st.kfs) - set(slam.ba_kfs))[0]
    proto = next(iter(st.lms.values()))
    for fid, twice_obs in ((990001, False), (990002, True)):
        lm = tstate.Landmark(line=proto.line.copy(), init_kfid=kid)
        lm.twice_observed = twice_obs
        st.lms[fid] = lm
        st.kfs[kid].member_lms.add(fid)
    st.kfs[kid].member_lms.add(990003)
    slam.prev_ba_kfs = set(slam.ba_kfs) | {kid}
    slam.delete_lms()
    assert 990001 not in st.lms and 990002 in st.lms
    assert 990003 not in st.kfs[kid].member_lms
    assert slam.prev_ba_kfs == set(slam.ba_kfs)


