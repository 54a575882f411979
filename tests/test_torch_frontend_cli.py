"""``cli track`` on the port vs the JAX CLI's, and the image files it reads.

Eight rendered house frames (the JAX package's StereoImageRenderer, seed
0, ``wave_trajectory(400)[::3][:8]``) are written as 8-bit grayscale PNGs
into left/ and right/ under tmp_path.  JAX's ``cmd_track`` (CPU, float64)
and the port's (``--device cpu --dtype float64``) read the same files;
the port's ``Slam`` is built with JAX's RANSAC noise (``JaxGumbel``, the
JAX engine's key split per RANSAC call), so both runs take the same
keyframes and write trajectories within 1e-8 m.  ``--vocab`` with a
missing file trains a vocabulary from the sequence and saves it in the
layout JAX's ``VocTree.load`` reads back, centroid for centroid."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from slslam_tpu import cli as jcli
from slslam_tpu import native as jnative
from slslam_tpu.loopclosure import VocTree as JaxVocTree
from slslam_tpu.sim import house_segments, wave_trajectory
from PIL import Image

from slslam_tpu.sim.images import StereoImageRenderer
import slslam_tpu_torch.engine as tengine
from slslam_tpu_torch import cli as tcli
from slslam_tpu_torch.loopclosure import VocTree
from test_torch_slam import JaxGumbel

torch.set_num_threads(1)

NF = 8
TRAJ_ATOL = 1e-8


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq")
    ren = StereoImageRenderer(house_segments(), seed=0)
    for side in ("left", "right"):
        os.makedirs(root / side)
    for i, T in enumerate(wave_trajectory(400)[::3][:NF]):
        for side, img in zip(("left", "right"), ren.render(T)[:2]):
            Image.fromarray(np.clip(np.rint(img), 0, 255).astype(
                np.uint8)).save(str(root / side / f"{i:04d}.png"))
    return root


def _args(seq, out, *extra):
    return ["track", "--left-dir", str(seq / "left"), "--right-dir",
            str(seq / "right"), "--out", str(out), *extra]


@pytest.fixture(scope="module")
def runs(seq, tmp_path_factory):
    assert jnative.available()       # see test_torch_frontend_matcher.py
    jout = tmp_path_factory.mktemp("jax")
    jcli.main(_args(seq, jout, "--platform", "cpu", "--dtype", "float64"))
    tout = tmp_path_factory.mktemp("port")
    orig = tengine.Slam

    def slam_with_jax_noise(cfg, device, **kw):
        return orig(cfg, device=device,
                    gumbel_hook=JaxGumbel(jax.random.PRNGKey(cfg.rseed)))

    tengine.Slam = slam_with_jax_noise
    try:
        stats = tcli.main(_args(seq, tout, "--device", "cpu", "--dtype",
                                "float64"))
    finally:
        tengine.Slam = orig
    return jout, tout, stats


def test_track_matches_jax_cli(runs):
    jout, tout, stats = runs
    with open(jout / "stats.json") as f:
        jstats = json.load(f)
    assert stats["num_keyframes"] == jstats["num_keyframes"] >= 2
    assert len(stats["keyframe_frames"]) == stats["num_keyframes"]
    assert stats["num_landmarks"] == jstats["num_landmarks"]
    assert stats["avg_num_iterations"] == jstats["avg_num_iterations"]
    assert stats["device"] == "cpu" and stats["dtype"] == "torch.float64"
    a = np.loadtxt(jout / "trajectory.txt")
    b = np.loadtxt(tout / "trajectory.txt")
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=TRAJ_ATOL)


def test_track_trains_a_vocabulary_jax_reads(seq, tmp_path):
    vocab = tmp_path / "vocab.bin"
    stats = tcli.main(_args(seq, tmp_path / "out", "--device", "cpu",
                            "--vocab", str(vocab), "--stopfrm", "5"))
    assert stats["num_keyframes"] >= 1
    assert vocab.exists()
    mine = VocTree.load(str(vocab), device="cpu")
    theirs = JaxVocTree.load(str(vocab))
    np.testing.assert_array_equal(np.asarray(theirs.centroids),
                                  mine.centroids.numpy())
    assert float(np.abs(mine.centroids.numpy()).max()) > 0
    # a second run loads the file instead of training again
    before = vocab.stat().st_mtime_ns
    tcli.main(_args(seq, tmp_path / "out2", "--device", "cpu", "--vocab",
                    str(vocab), "--vocab-preset", "outdoor", "--stopfrm",
                    "2"))
    assert vocab.stat().st_mtime_ns == before


def test_track_live_dir_names_the_missing_slice(seq, tmp_path):
    """--live-dir, ported with the views (it raised naming the slice
    before): the JAX CLI's tracking views, ``tracking_%05d.png`` every
    --live-every frames, drawn over the images."""
    stats = tcli.main(_args(seq, tmp_path / "out", "--device", "cpu",
                            "--live-dir", str(tmp_path / "live"),
                            "--live-every", "2", "--stopfrm", "3"))
    assert stats["num_keyframes"] >= 1
    views = sorted(os.listdir(tmp_path / "live"))
    assert views == ["tracking_00000.png", "tracking_00002.png"]
    img = np.asarray(Image.open(tmp_path / "live" / views[0]).convert("L"))
    assert img.std() > 10        # the images, not a blank canvas
