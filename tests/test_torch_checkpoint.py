"""Checkpoint / resume of the port's interactive engine, and its CLI.

A JAX checkpoint after frame 20 of a house run (every frame a keyframe,
float64), resumed by the port with the JAX engine's RANSAC noise continued
from the file's rng_key, equals the JAX engine's straight run to 1e-8 m.
The port's own save / load round trip resumes bit for bit with its
torch.Generator.  The CLI's ``sim`` (default engine: interactive) and
``run --obs-dir`` on line-track files written by the port's renderer, on
the CPU."""

import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from slslam_tpu.checkpoint import save_checkpoint as jax_save
from slslam_tpu.config import SlamConfig
from slslam_tpu.engine import Slam as JaxSlam
from slslam_tpu_torch import checkpoint
from slslam_tpu_torch.cli import main as cli_main
from slslam_tpu_torch.config import SlamConfig as PortConfig
from slslam_tpu_torch.engine import Slam
from slslam_tpu_torch.sim import (StereoLineRenderer, house_segments,
                                  wave_trajectory)
from test_torch_slam import JaxGumbel, _frames

torch.set_num_threads(1)

NF, CUT = 25, 20
GATES = dict(compute_dtype="float64", kf_rot_thr=1e-9, kf_tr_thr=1e-9)


def _poses_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x.R, y.R) and np.array_equal(x.t, y.t)
        for x, y in zip(a, b))


def test_jax_checkpoint_resumed_by_the_port(tmp_path):
    frames = _frames(NF)
    j = JaxSlam(dataclasses.replace(SlamConfig(), **GATES))
    for i in range(CUT + 1):
        j.process_frame(frames[i], i)
    path = str(tmp_path / "jax.npz")
    jax_save(j, path)
    for i in range(CUT + 1, NF):
        j.process_frame(frames[i], i)

    t = Slam(dataclasses.replace(PortConfig(), **GATES), device="cpu")
    with pytest.warns(RuntimeWarning, match="JAX package checkpoint"):
        checkpoint.load_checkpoint(t, path)
    assert t.vo_calls == 0 and t.jax_rng_key is not None
    t.gumbel_hook = JaxGumbel(jax.numpy.asarray(t.jax_rng_key))
    for i in range(CUT + 1, NF):
        t.process_frame(frames[i], i)
    assert t.state.edge_set == j.state.edge_set
    assert sorted(t.state.lms) == sorted(j.state.lms)
    assert t.sum_num_iteration == j.sum_num_iteration
    assert t.num_frames_processed == j.num_frames_processed
    for a, b in zip(j.trajectory(), t.trajectory(), strict=True):
        np.testing.assert_allclose(b.t, a.t, rtol=0, atol=1e-8)
        np.testing.assert_allclose(b.R, a.R, rtol=0, atol=1e-8)


def test_port_round_trip_is_bit_for_bit(tmp_path):
    """Save after frame 10, go on; a fresh engine loads the file and runs
    the same frames: the same trajectory, bit for bit, with the
    torch.Generator's stream restored (no hook)."""
    nf, cut = 16, 10
    frames = _frames(nf)
    cfg = dataclasses.replace(PortConfig(), **GATES)
    a = Slam(cfg, device="cpu")
    path = str(tmp_path / "port.npz")
    for i in range(nf):
        a.process_frame(frames[i], i)
        if i == cut:
            checkpoint.save_checkpoint(a, path)
    b = Slam(cfg, device="cpu")
    b.generator.manual_seed(12345)       # the file must restore the stream
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        checkpoint.load_checkpoint(b, path)
    for i in range(cut + 1, nf):
        b.process_frame(frames[i], i)
    assert _poses_equal(b.trajectory(), a.trajectory())
    assert b.sum_num_iteration == a.sum_num_iteration
    assert b.vo_calls == a.vo_calls
    z = np.load(path)
    assert {"torch_rng_state", "rng_key", "meta", "kf_ids"} <= set(z.files)


def test_port_checkpoint_keeps_the_jax_layout(tmp_path):
    """The port's file is JAX's layout plus its additions: the JAX package
    loads it (its map; the JAX key it carries)."""
    from slslam_tpu.checkpoint import load_checkpoint as jax_load
    frames = _frames(6)
    t = Slam(dataclasses.replace(PortConfig(), **GATES), device="cpu")
    for i, f in enumerate(frames):
        t.process_frame(f, i)
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(t, path)
    j = JaxSlam(dataclasses.replace(SlamConfig(), **GATES))
    jax_load(j, path)
    assert sorted(j.state.kfs) == sorted(t.state.kfs)
    assert j.state.edge_set == t.state.edge_set
    for k in t.state.kfs:
        np.testing.assert_array_equal(j.state.kfs[k].T.t,
                                      t.state.kfs[k].T.t)
    np.testing.assert_array_equal(np.asarray(j.key),
                                  np.asarray(jax.random.PRNGKey(4)))


def test_cli_sim_interactive(tmp_path):
    stats = cli_main(["sim", "--frames", "20", "--device", "cpu", "--dtype",
                      "float64", "--checkpoint-every", "2", "--out",
                      str(tmp_path)])
    with open(tmp_path / "stats.json") as f:
        saved = json.load(f)
    for key in ("num_keyframes", "num_landmarks", "avg_num_iterations",
                "proc_local_ba_mean_s", "embedding_walker", "ate_m"):
        assert key in saved, key
    K = saved["num_keyframes"]
    assert K >= 2 and saved["ate_m"] < 0.05
    assert np.loadtxt(tmp_path / "trajectory.txt", ndmin=2).shape == (K, 7)
    assert np.loadtxt(tmp_path / "gt_trajectory.txt", ndmin=2).shape == (K, 7)
    assert np.loadtxt(tmp_path / "landmarks.txt", ndmin=2).shape[1] == 6
    assert os.path.isfile(tmp_path / "checkpoint.npz")
    assert stats["num_keyframes"] == K


def test_cli_run_obs_dir(tmp_path):
    """``run --obs-dir`` on %04d.txt files from the port's renderer (pixel
    coordinates; frame 0 absent, as the reference's sequences) equals the
    interactive engine on the same files with the CLI's settings."""
    cfg = PortConfig()
    poses = wave_trajectory(num_frames=400)[:18]
    ren = StereoLineRenderer(house_segments(), cfg.camera, noise_px=0.2,
                             seed=4)
    seq = tmp_path / "seq"
    ren.write_sequence(str(seq), poses)
    os.remove(seq / "0000.txt")
    out = tmp_path / "out"
    stats = cli_main(["run", "--obs-dir", str(seq), "--device", "cpu",
                      "--dtype", "float64", "--stopfrm", "15", "--out",
                      str(out)])
    rows = np.loadtxt(out / "trajectory.txt", ndmin=2)
    assert rows.shape == (stats["num_keyframes"], 7) and rows.shape[0] >= 2
    assert np.all(np.isfinite(rows))

    from slslam_tpu_torch.frontend import ObsFileLoader
    slam = Slam(dataclasses.replace(cfg, compute_dtype="float64",
                                    max_num_iter=10), device="cpu")
    for frame_id, obs in ObsFileLoader(str(seq)):
        if frame_id > 15:
            break
        slam.process_frame(obs, frame_id, normalized=False)
    slam.save_trajectory(str(tmp_path / "direct.txt"))
    assert ((tmp_path / "direct.txt").read_bytes()
            == (out / "trajectory.txt").read_bytes())
    assert len(slam.state.kfs) == stats["num_keyframes"]


def test_cli_batch_engine_still_runs(tmp_path):
    stats = cli_main(["sim", "--engine", "batch", "--frames", "6",
                      "--device", "cpu", "--dtype", "float64", "--out",
                      str(tmp_path)])
    assert stats["num_keyframes"] >= 1
    assert os.path.isfile(tmp_path / "landmarks.txt")
