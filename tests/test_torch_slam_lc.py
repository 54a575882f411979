"""Interactive loop closure on the port vs the JAX engine.

tests/test_lc_e2e.py's small village configuration (6 houses on a ring of
radius 9, orbit radius 3.5, 0.3 px, 64 RANSAC hypotheses, its buckets and
vocabulary-tree parameters, its motion of 3.2 pi over 120 frames), cut to
its first 80 frames (the first revisits), float64 on the CPU.  One JAX
run, cached in a module fixture; the port gets the same track ids, the
same descriptor stream, the same vocabulary and the JAX engine's RANSAC
noise: the same loop closures, edges, landmark merges and window LM
iterations, and trajectories inside the run's rounding band.  The two
engines part by 6.3e-8 m, a gap that opens in the long window solves at
frames 30-36, before any closure; from frame 27 on, a 1e-15
relative change of the observations moves the port alone by 6.5e-8 to
7.3e-6 m over three seeds (4.4e-6 m for the seed the test takes).  (The
40-frame house run holds 1e-8 m, tests/test_torch_slam.py.)"""

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
from slslam_tpu.loopclosure import build_vocabulary
from slslam_tpu.loopclosure.voctree import VocTreeParams as JaxParams
from slslam_tpu_torch import sim as tsim
from slslam_tpu_torch.config import SlamConfig as PortConfig
from slslam_tpu_torch.engine import Slam
from slslam_tpu_torch.loopclosure import PlaceRecognizer, VocTree
from slslam_tpu_torch.loopclosure import VocTreeParams
from test_torch_slam import JaxGumbel

torch.set_num_threads(1)

NF = 80
OVER = dict(compute_dtype="float64", ransac_num_hypotheses=64,
            corr_buckets=(64, 128), obs_buckets=(512, 1024, 2048),
            line_buckets=(256, 512))
PARAMS = dict(non_consider_recent=8, consider_seq_length=3, threshold=0.25,
              num_avg_words=30)


@pytest.fixture(scope="module")
def village():
    """Track-id frames, the assigner, the vocabulary, ground truth."""
    segs = jsim.village_segments(n_houses=6, ring_radius=9.0)
    poses = jsim.village_trajectory(num_frames=NF, arc=3.2 * np.pi * NF / 120,
                                    orbit_radius=3.5)
    ren = jsim.StereoLineRenderer(segs, SlamConfig().camera, noise_px=0.3,
                                  seed=1)
    assigner = jsim.TrackIdAssigner(max_gap=5)
    frames = [assigner.assign(i, ren.observe(T))
              for i, T in enumerate(poses)]
    src = jsim.SegmentDescriptorSource(assigner, len(segs), noise=0.01,
                                       seed=7)
    rng0 = np.random.default_rng(0)
    samples = np.concatenate([
        src.base + rng0.standard_normal(src.base.shape).astype(np.float32)
        * 0.02 for _ in range(3)])
    samples /= np.linalg.norm(samples, axis=1, keepdims=True)
    vocab = build_vocabulary(samples, seed=0, kmeans_iters=2)
    return frames, assigner, len(segs), vocab


WITNESS_FROM = 27   # before the windows that amplify rounding (frames 30-36)


def _continue(t, frames, start, scale=0.0, seed=0):
    """Frames ``start``.. through the port engine ``t``, each observation
    scaled by 1 + ``scale`` x N(0, 1); the keyframes' frame indices."""
    rng = np.random.default_rng(seed)
    kt = []
    for i in range(start, len(frames)):
        f = {k: v * (1.0 + scale * rng.standard_normal(8))
             for k, v in frames[i].items()}
        if t.process_frame(f, i):
            kt.append(i)
    return kt


@pytest.fixture(scope="module")
def runs(village):
    """The JAX run, the port's run, their keyframes, and a copy of the
    port's engine after frame WITNESS_FROM - 1 (the rounding witness's
    start)."""
    frames, assigner, nseg, vocab = village
    j = JaxSlam(dataclasses.replace(SlamConfig(), **OVER))
    j.place_recognizer = JaxRecognizer(JaxVocTree(vocab, JaxParams(**PARAMS)),
                                       min_matches=8, min_similarity=0.8)
    j.descriptor_source = jsim.SegmentDescriptorSource(assigner, nseg,
                                                       noise=0.01, seed=7)
    kj = [i for i, f in enumerate(frames) if j.process_frame(dict(f), i)]
    t = Slam(dataclasses.replace(PortConfig(), **OVER), device="cpu",
             gumbel_hook=JaxGumbel(jax.random.PRNGKey(4)))
    t.place_recognizer = PlaceRecognizer(
        VocTree(vocab, VocTreeParams(**PARAMS), device="cpu"),
        min_matches=8, min_similarity=0.8)
    t.descriptor_source = tsim.SegmentDescriptorSource(assigner, nseg,
                                                       noise=0.01, seed=7)
    kt = _continue(t, frames[:WITNESS_FROM], 0)
    snapshot = copy.deepcopy(t)
    kt += _continue(t, frames, WITNESS_FROM)
    return j, t, kj, kt, snapshot


def test_loop_closures_match_jax(runs):
    j, t, kj, kt, _ = runs
    assert kt == kj
    assert j.lc_cnt >= 1 and t.lc_cnt == j.lc_cnt
    assert len(j.state.edge_set) >= len(kj)      # beyond the odometry chain
    assert t.state.edge_set == j.state.edge_set
    assert t.state.match_lookup == j.state.match_lookup
    assert sorted(t.state.lms) == sorted(j.state.lms)
    assert t.sum_num_iteration == j.sum_num_iteration


def _gap(a, b):
    return max(float(np.max(np.abs(x.t - y.t)))
               for x, y in zip(a.trajectory(), b.trajectory(), strict=True))


def test_trajectory_matches_jax_within_rounding(runs, village):
    """JAX's and the port's trajectories part by no more than 1e-7 m or
    than the port moves when the observations from frame WITNESS_FROM on
    change by 1e-15 relative, the larger; the port's decisions stay the
    same under that change."""
    j, t, _, kt, snapshot = runs
    w = copy.deepcopy(snapshot)
    kw = _continue(w, village[0], WITNESS_FROM, scale=1e-15, seed=2)
    assert kw == [k for k in kt if k >= WITNESS_FROM]
    assert w.state.edge_set == t.state.edge_set
    assert _gap(j, t) <= max(1e-7, _gap(w, t))
    assert (t.stop_watch.stats("pose_graph").count
            == j.stop_watch.stats("pose_graph").count)
