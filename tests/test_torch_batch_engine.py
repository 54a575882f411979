"""The port's batch engine (slslam_tpu_torch/engine/batch.py) vs JAX's.

30 frames of the house world, float64, the bench's buckets.  The JAX
engine's per-frame step runs from a Python loop (the body of its
lax.scan), and its RANSAC noise, jax.random.gumbel(fold_in(PRNGKey(rseed),
frame), (H, Lp)), is injected into the port: keyframe flags, RANSAC scores,
final inlier counts and LM iteration counts are identical and the
trajectories agree to 1e-7 m."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.config import SlamConfig, bucket_for
from slslam_tpu.engine import batch as jb
from slslam_tpu.sim import StereoLineRenderer, house_segments, wave_trajectory
from slslam_tpu_torch.cli import main as cli_main
from slslam_tpu_torch.engine import batch as tb

torch.set_num_threads(1)

NF = 30
CFG = dataclasses.replace(
    SlamConfig(), compute_dtype="float64", kf_rot_thr=1e-9, kf_tr_thr=1e-9,
    obs_buckets=(80, 2048), line_buckets=(80, 2048), corr_buckets=(80, 256))


def _frames(n):
    poses = wave_trajectory(num_frames=400)[:n]
    ren = StereoLineRenderer(house_segments(), CFG.camera, noise_px=0.2,
                             seed=4)
    return [ren.observe(T) for T in poses], poses


@pytest.fixture(scope="module")
def jax_run():
    """JAX engine, stepped frame by frame: carries after every frame,
    stacked outputs, the BatchResult, and the port's Gumbel hook."""
    frames, poses = _frames(NF)
    eng = jb.BatchSlam(CFG)
    pack = jb.pack_frames(frames, window=CFG.ba_window_size)
    Wn = 2 * CFG.ba_window_size
    Lcap = bucket_for(pack.num_slots, CFG.line_buckets)
    Lp, Om = Lcap + 1, bucket_for(pack.obs.shape[1], CFG.obs_buckets)
    Rm, Fmax = pack.retire_slot.shape[1], NF
    base = jax.random.PRNGKey(CFG.rseed)
    step = jax.jit(jb._make_step(CFG, Wn, Lp, Om, Rm, Fmax, jnp.float64,
                                 base))

    def pad(a):
        out = np.zeros(a.shape[:1] + (Om,) + a.shape[2:], a.dtype)
        out[:, :a.shape[1]] = a
        return out

    xs = (pad(pack.obs), pad(pack.slot), pad(pack.valid), pack.retire_slot,
          pack.retire_valid, pack.frame_idx)
    carry = eng._carry0(Wn, Lp, Om, Fmax)
    carries, ys = [], []
    for f in range(NF):
        carry, y = step(carry, tuple(jnp.asarray(x[f]) for x in xs))
        carries.append(jb.BatchCarry(*(np.asarray(v) for v in carry)))
        ys.append(y)
    ys = jb.BatchStepOut(*(np.stack([np.asarray(v) for v in col])
                           for col in zip(*ys)))
    res = eng._collect(carries[-1], ys, pack, Lcap)

    def hook(fidx):
        g = jax.random.gumbel(jax.random.fold_in(base, fidx),
                              (CFG.ransac_num_hypotheses, Lp), jnp.float64)
        return torch.as_tensor(np.array(g))

    return frames, poses, carries, res, hook


@pytest.fixture(scope="module")
def torch_run(jax_run):
    frames, _, _, _, hook = jax_run
    eng = tb.BatchSlam(CFG, device="cpu", gumbel_hook=hook)
    return eng, eng.run(frames)


@pytest.mark.parametrize("key", ["is_kf", "ransac_score", "n_final_inliers",
                                 "ba_iters", "n_common"])
def test_per_frame_outputs_identical(jax_run, torch_run, key):
    res_j = jax_run[3]
    res_t = torch_run[1]
    np.testing.assert_array_equal(res_t.per_frame[key], res_j.per_frame[key])


def test_trajectory_agrees(jax_run, torch_run):
    res_j, res_t = jax_run[3], torch_run[1]
    assert res_t.kf_count == res_j.kf_count == NF
    assert len(res_t.trajectory) == len(res_j.trajectory)
    for a, b in zip(res_j.trajectory, res_t.trajectory):
        np.testing.assert_allclose(b.t, a.t, rtol=0, atol=1e-7)
        np.testing.assert_allclose(b.R, a.R, rtol=0, atol=1e-7)


def test_landmarks_and_stats_agree(jax_run, torch_run):
    res_j, res_t = jax_run[3], torch_run[1]
    assert res_t.stats["num_landmarks"] == res_j.stats["num_landmarks"]
    assert (res_t.stats["avg_num_iterations"]
            == res_j.stats["avg_num_iterations"])
    np.testing.assert_allclose(res_t.stats["avg_final_cost"],
                               res_j.stats["avg_final_cost"], rtol=1e-8)
    assert len(res_t.world_segments(min_len=0.5)) == len(
        res_j.world_segments(min_len=0.5))


def test_carry_from_numpy_steps_like_jax(jax_run, torch_run):
    """The JAX carry after 10 frames, moved into the port and stepped once,
    gives JAX's carry after 11 frames (edges' dump row excluded)."""
    frames, _, carries, _, hook = jax_run
    eng = torch_run[0]
    pack, stepper, _ = eng.layout(frames)
    xs = eng.frame_inputs(pack, stepper.Om)
    f = 10
    c = tb.carry_from_numpy(carries[f - 1], "cpu", torch.float64)
    c, _ = stepper.step(c, tuple(x[f] for x in xs),
                        bool(pack.valid[f].any()), gumbel=hook(f))
    got = tb.carry_to_numpy(c)
    want = carries[f]
    for name, a, b in zip(tb.BatchCarry._fields, want, got):
        if name == "edges":
            a, b = a[:-1], b[:-1]
        assert a.shape == b.shape, name
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9,
                                       err_msg=name)


def test_carry_round_trip(jax_run):
    c = jax_run[2][5]
    back = tb.carry_to_numpy(tb.carry_from_numpy(c, "cpu", "float64"))
    for a, b in zip(c, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pack_frames_copy_matches_original():
    frames, _ = _frames(40)
    frames = [({(fid + 10000 if fid % 2 else fid): o
                for fid, o in fr.items()} if i >= 20 else fr)
              for i, fr in enumerate(frames)]
    a = jb.pack_frames(frames, lifetime=6)
    b = tb.pack_frames(frames, lifetime=6)
    assert a.retire_valid.any()
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            assert x == y, name


def test_normalize_frames_copy_matches_original():
    rng = np.random.default_rng(0)
    frames = [{k: rng.random(8) * 600 for k in range(5)} for _ in range(3)]
    a = jb.normalize_frames(frames, CFG.camera)
    b = tb.normalize_frames(frames, CFG.camera)
    for fa, fb in zip(a, b):
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fb[k], fa[k])


def test_empty_frames_are_skipped():
    frames, _ = _frames(6)
    frames[2] = {}
    res = tb.BatchSlam(CFG, device="cpu").run(frames)
    assert not res.is_kf[2]
    assert res.kf_count == 5


def test_unported_options_raise():
    """ba_init_jitter, window anchors and aid / asd lines are ported now
    (tests/test_torch_batch_options.py); the interactive engine's sharded
    mode needs an initialized process group, and the window anchors need
    positive sigmas."""
    for over in (dict(ba_init_jitter=0.1), dict(line_param="aid"),
                 dict(window_anchor_sigma_rot=0.1,
                      window_anchor_sigma_t=0.1)):
        tb.BatchSlam(dataclasses.replace(CFG, **over), device="cpu")
    from slslam_tpu_torch.engine import Slam
    with pytest.raises(RuntimeError, match="process group"):
        Slam(dataclasses.replace(CFG, mesh_devices=2), device="cpu")
    from slslam_tpu_torch.ops.schur_ba import make_cam_anchor
    with pytest.raises(ValueError, match="positive"):
        make_cam_anchor((0.0, 0.1), torch.zeros(2, 6))


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tb.BatchSlam(CFG, device="cuda")


def test_cli_writes_reference_trajectory(tmp_path):
    out = tmp_path / "run"
    cli_main(["sim", "--engine", "batch", "--frames", "6", "--device",
              "cpu", "--dtype", "float64", "--out", str(out)])
    rows = np.loadtxt(out / "trajectory.txt", ndmin=2)
    assert rows.shape[1] == 7 and 1 <= rows.shape[0] <= 6
    assert os.path.isfile(out / "stats.json")
