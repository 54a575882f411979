"""The port's global refine (slslam_tpu_torch/engine/refine.py) vs JAX's.

A 20-frame slice of the house world (render seed 4, 0.2 px), every frame a
keyframe, float64 on the CPU.  Both packages refine the same trajectory:
the ground truth with a seeded numpy perturbation on every pose but the
first.  The host-side problem building is identical; the line init agrees
to 1e-10; ``global_refine`` with ``method="cg"`` and ``method="dense"``
takes the same LM path (identical iteration totals) and lands within
1e-7 m (poses) and 1e-7 (line rows) of JAX's."""

import dataclasses

import numpy as np
import pytest
import torch

from slslam_tpu import hostgeom as jhost
from slslam_tpu.config import SlamConfig
from slslam_tpu.engine import refine as jref
from slslam_tpu.sim import StereoLineRenderer, house_segments, wave_trajectory
from slslam_tpu_torch import hostgeom as thost
from slslam_tpu_torch.config import SlamConfig as TSlamConfig
from slslam_tpu_torch.engine import refine as tref
from slslam_tpu_torch.ops.triangulate import triangulate_lines_host

torch.set_num_threads(1)

NF = 20
KW = dict(compute_dtype="float64", kf_rot_thr=1e-9, kf_tr_thr=1e-9)
JCFG = dataclasses.replace(SlamConfig(), **KW)
TCFG = dataclasses.replace(TSlamConfig(), **KW)


@pytest.fixture(scope="module")
def house():
    """Frames, is_kf and the perturbed camera-to-world trajectory (JAX's
    Pose and the port's, the same numbers)."""
    poses = wave_trajectory(num_frames=400)[:NF]
    ren = StereoLineRenderer(house_segments(), JCFG.camera, noise_px=0.2,
                             seed=4)
    frames = [ren.observe(T) for T in poses]
    rng = np.random.default_rng(0)
    traj = []
    for k, T in enumerate(poses):
        wt = (T @ poses[0].inv()).inv().wt()
        if k:
            wt = wt + rng.standard_normal(6) * np.repeat([0.01, 0.03], 3)
        traj.append(wt)
    jtraj = [jhost.Pose.from_wt(w) for w in traj]
    ttraj = [thost.Pose(T.R, T.t) for T in jtraj]
    return frames, np.ones(NF, bool), jtraj, ttraj


def test_problem_structure_identical(house):
    frames, is_kf, _, _ = house
    for kf in (is_kf, np.arange(NF) % 3 != 1):
        a = jref.build_problem_structure(frames, kf)
        b = tref.build_problem_structure(frames, kf)
        assert a.feat_ids == b.feat_ids
        for name in ("first_obs", "last_obs", "first_kf", "last_kf", "obs",
                     "ocam", "olin"):
            x, y = getattr(a, name), getattr(b, name)
            np.testing.assert_array_equal(y, x, err_msg=name)
            assert y.dtype == x.dtype, name


def _band_map(K=40):
    """tests/test_refine.py's synthetic band map: every track spans four
    keyframes."""
    frames = []
    for kf in range(K):
        fr = {}
        for k in range(max(0, kf - 3), kf + 1):
            for j in range(5):
                fr[100 * k + j] = np.zeros(8)
        frames.append(fr)
    return frames, np.ones(K, bool)


def test_band_visibility_identical(house):
    frames, is_kf, _, _ = house
    for f, k in ((frames, is_kf), _band_map(), (frames[:2], is_kf[:2])):
        assert tref.detect_band_visibility(f, k) == \
            jref.detect_band_visibility(f, k)
    assert tref.detect_band_visibility(*_band_map())[0]
    assert not tref.detect_band_visibility(frames, is_kf)[0]


def test_init_problem_values_match_jax(house):
    frames, is_kf, jtraj, ttraj = house
    s = jref.build_problem_structure(frames, is_kf)
    cj, lj = jref.init_problem_values(s, jtraj, JCFG)
    ct, lt = tref.init_problem_values(
        tref.build_problem_structure(frames, is_kf), ttraj, TCFG,
        torch.float64, "cpu")
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(lt, lj, rtol=1e-10, atol=1e-10)
    a = jref.build_global_problem(frames, is_kf, jtraj, JCFG)
    b = tref.build_global_problem(frames, is_kf, ttraj, TCFG, device="cpu")
    np.testing.assert_allclose(b[1], a[1], rtol=1e-10, atol=1e-10)
    for x, y in zip(a[:1] + a[2:5], b[:1] + b[2:5]):
        np.testing.assert_array_equal(y, x)
    assert b[5] == a[5]


@pytest.mark.parametrize("method", ["cg", "dense"])
def test_global_refine_matches_jax(house, method):
    frames, is_kf, jtraj, ttraj = house
    kw = dict(rounds=2, max_iters=6, method=method)
    a = jref.global_refine(frames, is_kf, jtraj, config=JCFG, **kw)
    b = tref.global_refine(frames, is_kf, ttraj, config=TCFG, device="cpu",
                           **kw)
    assert b.iterations == a.iterations > 2
    assert (b.num_cams, b.num_lines, b.num_obs) == (a.num_cams, a.num_lines,
                                                    a.num_obs)
    assert b.feature_ids == a.feature_ids
    dpos = max(np.linalg.norm(x.t - y.t)
               for x, y in zip(a.trajectory, b.trajectory))
    assert dpos <= 1e-7, dpos
    np.testing.assert_allclose(b.lines_world, a.lines_world, rtol=1e-7,
                               atol=1e-7)
    np.testing.assert_allclose(b.initial_cost, a.initial_cost, rtol=1e-9)
    np.testing.assert_allclose(b.final_cost, a.final_cost, rtol=1e-7)
    assert b.final_cost < b.initial_cost
    np.testing.assert_allclose(b.trajectory[0].t, 0.0, atol=1e-12)


def test_auto_picks_dense_on_cpu_only_for_small_problems(house,
                                                         monkeypatch):
    frames, is_kf, _, ttraj = house
    picked = []
    for name in ("local_ba", "global_ba_cg"):
        orig = getattr(tref, name)

        def spy(*a, _orig=orig, _name=name, **k):
            picked.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(tref, name, spy)
    tref.global_refine(frames, is_kf, ttraj, config=TCFG, rounds=1,
                       max_iters=1, device="cpu")
    assert set(picked) == {"local_ba"}
    monkeypatch.setattr(tref, "_DENSE_CAM_LIMIT", NF - 1)
    picked.clear()
    tref.global_refine(frames, is_kf, ttraj, config=TCFG, rounds=1,
                       max_iters=1, device="cpu")
    assert set(picked) == {"global_ba_cg"}


@pytest.mark.parametrize("kw", [
    dict(odometry_prior=True), dict(prior_edges=([0], [1], np.zeros((1, 6))))])
def test_priors_raise(house, kw, monkeypatch):
    """Priors live on the CG path: method="dense" with a prior raises a
    warning and solves by CG (refine.py:445-452)."""
    frames, is_kf, _, ttraj = house
    picked = []
    orig = tref.global_ba_cg

    def spy(*a, **k):
        picked.append(k)
        return orig(*a, **k)

    monkeypatch.setattr(tref, "global_ba_cg", spy)
    with pytest.warns(UserWarning, match="CG"):
        tref.global_refine(frames, is_kf, ttraj, config=TCFG, device="cpu",
                           method="dense", rounds=1, max_iters=1, **kw)
    assert picked and all(k["prior_c"] is not None
                          or k["prior_edges"] is not None for k in picked)


def _loop_edges(poses):
    """Two loop constraints of the house slice from the ground truth."""
    rng = np.random.default_rng(11)
    T0 = poses[0]
    cw = [(T @ T0.inv()).inv().inv() for T in poses]   # world->cam

    def rel(a, b):
        return (cw[b] @ cw[a].inv()).wt() + rng.standard_normal(6) * 0.005

    ei, ej = np.array([0, 3]), np.array([NF - 1, NF - 4])
    return ei, ej, np.stack([rel(a, b) for a, b in zip(ei, ej)])


@pytest.mark.parametrize("prior", ["odometry", "edges", "both"])
def test_global_refine_priors_match_jax(house, prior):
    """global_refine with the odometry prior forced on, with prior_edges,
    and with both (the deferred loop closure's merged refine, which passes
    the odometry measurements as _prior_c): identical LM iterations, poses
    within 1e-7 m."""
    from slslam_tpu.sim import wave_trajectory as jwave
    frames, is_kf, jtraj, ttraj = house
    edges = _loop_edges(jwave(num_frames=400)[:NF])
    chain = np.stack([(jtraj[i + 1].inv() @ jtraj[i]).wt()
                      for i in range(NF - 1)])
    chain = chain + np.random.default_rng(2).standard_normal(chain.shape) \
        * 0.002
    kw = {"odometry": dict(odometry_prior=True),
          "edges": dict(prior_edges=edges, odometry_prior=False),
          "both": dict(prior_edges=edges, odometry_prior=True,
                       _prior_c=chain)}[prior]
    a = jref.global_refine(frames, is_kf, jtraj, config=JCFG, rounds=2,
                           max_iters=6, **kw)
    b = tref.global_refine(frames, is_kf, ttraj, config=TCFG, rounds=2,
                           max_iters=6, device="cpu", **kw)
    assert b.iterations == a.iterations > 2
    dpos = max(np.linalg.norm(x.t - y.t)
               for x, y in zip(a.trajectory, b.trajectory))
    assert dpos <= 1e-7, dpos
    np.testing.assert_allclose(b.final_cost, a.final_cost, rtol=1e-7)


def test_cuda_without_a_card_raises(house):
    frames, is_kf, _, ttraj = house
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tref.global_refine(frames, is_kf, ttraj, config=TCFG)


@pytest.mark.parametrize("entry", ["init_problem_values",
                                   "build_global_problem",
                                   "triangulate_lines_host"])
def test_host_entries_default_to_the_card(house, entry):
    """Called without a device, the line init and the host triangulation
    ask for the card, and raise here rather than run on the CPU."""
    frames, is_kf, _, ttraj = house
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s = tref.build_problem_structure(frames, is_kf)
    call = {
        "init_problem_values":
            lambda: tref.init_problem_values(s, ttraj, TCFG),
        "build_global_problem":
            lambda: tref.build_global_problem(frames, is_kf, ttraj, TCFG),
        "triangulate_lines_host":
            lambda: triangulate_lines_host(s.first_obs, 0.12),
    }[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()
