"""The port's stereo/temporal matcher vs the JAX package's.

25 house frames (``wave_trajectory(400)[::3][:25]``, as
tests/test_frontend.py:152 takes them) rendered by the JAX package's
StereoImageRenderer (seed 0, stroke 1.5, noise 2.0) go through JAX's
``StereoLineMatcher.process`` (CPU, x64 on) and the port's on CPU tensors:
the same track ids in every frame, observations within 1e-4 px, the same
live tracks and descriptors (within 1e-6) after the run.  Then the
matcher's contracts: ``descriptors`` for the engine, a worker's exception
reaching the caller, and the stage runner that the front-end bench times
``side`` through.

JAX's native binding loads the library on first use without a lock
(slslam_tpu/native.py:78-85): when the matcher's two threads make that
first call together, one of them may find the library "tried" but not yet
loaded and run the Python grower instead, which changes that frame's
tracks.  The fixtures load JAX's library before the first frame; the
port's detector loads its library when it is built, in the caller's
thread."""

import numpy as np
import pytest
import torch

from slslam_tpu import native as jnative
from slslam_tpu.frontend.matcher import StereoLineMatcher as JaxMatcher
from slslam_tpu.sim import house_segments, wave_trajectory
from slslam_tpu.sim.images import StereoImageRenderer
from slslam_tpu_torch.frontend.matcher import StereoLineMatcher

torch.set_num_threads(1)

NF = 25
OBS_PX = 1e-4
DESC_ATOL = 1e-6


@pytest.fixture(scope="module")
def images():
    ren = StereoImageRenderer(house_segments(), seed=0)
    return [ren.render(T)[:2] for T in wave_trajectory(400)[::3][:NF]]


@pytest.fixture(scope="module")
def runs(images):
    assert jnative.available()
    j = JaxMatcher()
    t = StereoLineMatcher(device="cpu")
    fj = [j.process(i, *im) for i, im in enumerate(images)]
    ft = [t.process(i, *im) for i, im in enumerate(images)]
    t.close()
    return j, t, fj, ft


def test_track_ids_identical_every_frame(runs):
    _, _, fj, ft = runs
    assert np.mean([len(f) for f in ft]) > 20
    for a, b in zip(fj, ft, strict=True):
        assert list(b) == list(a)


def test_observations_match(runs):
    _, _, fj, ft = runs
    for a, b in zip(fj, ft, strict=True):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=OBS_PX)


def test_tracks_and_descriptors_match(runs):
    j, t, _, _ = runs
    assert sorted(t.tracks) == sorted(j.tracks)
    assert t._next_id == j._next_id
    ids = sorted(j.tracks) + [10 ** 6]
    want = j.descriptors(NF - 1, ids)
    got = t.descriptors(NF - 1, ids)
    assert got.dtype == np.float32 and got.shape == (len(ids), 72)
    np.testing.assert_allclose(got, want, rtol=0, atol=DESC_ATOL)
    assert not got[-1].any()           # an unknown id gives zeros
    for tid, tr in j.tracks.items():
        assert t.tracks[tid].last_frame == tr.last_frame


def test_worker_exception_reaches_the_caller(images):
    """The left image goes to the pool's worker: its exception is raised by
    ``process``, whether or not the right side succeeds."""
    m = StereoLineMatcher(device="cpu")
    orig = m.detector.detect_with_gradients
    bad = np.zeros((3, 3), np.float32)

    def detect(img, *stage):
        if img is bad:
            raise ValueError("left side failed")
        return orig(img, *stage)

    m.detector.detect_with_gradients = detect
    with pytest.raises(ValueError, match="left side failed"):
        m.process(0, bad, images[0][1])
    with pytest.raises(ValueError, match="left side failed"):
        m.process(1, bad, bad)
    assert m.process(2, *images[0])
    m.close()
    assert m._pool is None


def test_stage_runner_sees_every_step_of_a_side(images):
    """``side`` runs each front-end step through its stage runner, in the
    order ``process`` runs them, and returns what it returns without one:
    tools/torch_frontend_bench.py's stage split times this path."""
    m = StereoLineMatcher(device="cpu")
    seen = []

    def stage(name, fn, *a):
        seen.append(name)
        return fn(*a)

    segs, desc = m.side(images[1][0], stage)
    ref_segs, ref_desc = m.side(images[1][0])
    assert seen == ["gradients", "to_host", "grower", "fuse_merge",
                    "describe"]
    assert len(segs) > 20
    np.testing.assert_array_equal(segs, ref_segs)
    np.testing.assert_array_equal(desc, ref_desc)
