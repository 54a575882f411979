"""The port's copies of the JAX package's jax-free modules vs the originals,
and the port's independence from the JAX package.

slslam_tpu_torch keeps cited copies of what it needs from slslam_tpu.config,
slslam_tpu.hostgeom, slslam_tpu.sim (house, wave, renderer, village,
tracks), slslam_tpu.evalio (writers, traj), slslam_tpu.utils.stopwatch,
slslam_tpu.engine.state, slslam_tpu.frontend.io, the numpy stages of
slslam_tpu.frontend.detector and .matcher, slslam_tpu.sim.images, the
vocabulary-tree presets, the native bindings of slslam_tpu.native, the
numpy parts of
slslam_tpu.engine.refine, slslam_tpu.ops.schur_cg and
slslam_tpu.engine.batch_lc, the numpy vocabulary training of
slslam_tpu.loopclosure.voctree, slslam_tpu.viz,
slslam_tpu.viz_interactive, slslam_tpu.sim.street,
slslam_tpu.parallel.dist_ba's partition_by_line and
__graft_entry__._example_ba_problem (tools/torch_scaling_bench.py).
These tests hold each copy to its
original on the same inputs (exact equality; the refine's and the packer's
copies are held in tests/test_torch_refine.py and
tests/test_torch_schur_cg.py, the loop closure's joint problem packing in
tests/test_torch_batch_lc.py), and check that importing every module of
the port, chip_smoke, profile_replay and the port's tools
(tools/torch_*.py) loads neither jax nor slslam_tpu."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import slslam_tpu_torch
from slslam_tpu import config as jconfig
from slslam_tpu import hostgeom as jhost
from slslam_tpu import sim as jsim
from slslam_tpu.engine import batch_lc as jlc
from slslam_tpu.engine import refine as jrefine
from slslam_tpu.evalio import writers as jwriters
from slslam_tpu.loopclosure import voctree as jvoc
from slslam_tpu_torch import config as tconfig
from slslam_tpu_torch import hostgeom as thost
from slslam_tpu_torch import sim as tsim
from slslam_tpu_torch.engine import batch_lc as tlc
from slslam_tpu_torch.engine import refine as trefine
from slslam_tpu_torch.evalio import writers as twriters
from slslam_tpu_torch.loopclosure import voctree as tvoc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's tools, each the counterpart of a JAX tool
TOOLS = ["tools." + f[:-3] for f in sorted(os.listdir(os.path.join(
    REPO, "tools"))) if f.startswith("torch_") and f.endswith(".py")]


def test_slam_config_fields_identical():
    j, t = jconfig.SlamConfig(), tconfig.SlamConfig()
    assert ([f.name for f in dataclasses.fields(j)]
            == [f.name for f in dataclasses.fields(t)])
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.error_thr, j.huber_delta) == (t.error_thr, t.huber_delta)
    jc, tc = jconfig.CameraConfig(), tconfig.CameraConfig()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (jc.fx, jc.fy) == (tc.fx, tc.fy)


@pytest.mark.parametrize("n", [0, 1, 80, 81, 2048, 5000])
def test_bucket_for_identical(n):
    buckets = jconfig.SlamConfig().line_buckets
    assert tconfig.bucket_for(n, buckets) == jconfig.bucket_for(n, buckets)


@pytest.mark.parametrize("shift", [True, False])
def test_house_segments_identical(shift):
    np.testing.assert_array_equal(tsim.house_segments(shift=shift),
                                  jsim.house_segments(shift=shift))


def test_wave_trajectory_identical():
    for a, b in zip(tsim.wave_trajectory(400), jsim.wave_trajectory(400),
                    strict=True):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
def test_renderer_identical(noise_px):
    poses = jsim.wave_trajectory(400)[::40]
    ren_j = jsim.StereoLineRenderer(jsim.house_segments(),
                                    jconfig.CameraConfig(),
                                    noise_px=noise_px, seed=3)
    ren_t = tsim.StereoLineRenderer(tsim.house_segments(),
                                    tconfig.CameraConfig(),
                                    noise_px=noise_px, seed=3)
    for T in poses:
        a = ren_j.observe(T)
        b = ren_t.observe(thost.Pose(T.R, T.t))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _rotations():
    rng = np.random.default_rng(5)
    ws = [rng.standard_normal(3) * s for s in (1e-9, 1e-3, 0.5, 2.0)]
    ws.append(np.array([np.pi - 1e-4, 0.0, 0.0]))   # so3_log's near-pi arm
    ws.append(np.zeros(3))
    return [jhost.rodrigues(w) for w in ws]


def test_hostgeom_identical():
    for R in _rotations():
        np.testing.assert_array_equal(thost.so3_log(R), jhost.so3_log(R))
        w = jhost.so3_log(R)
        np.testing.assert_array_equal(thost.rodrigues(w), jhost.rodrigues(w))
        t = np.array([0.3, -1.0, 2.0])
        a, b = jhost.Pose(R, t), thost.Pose(R, t)
        for x, y in ((a.inv(), b.inv()), (a @ a.inv(), b @ b.inv()),
                     (a.rel_to(a.inv()), b.rel_to(b.inv())),
                     (jhost.Pose.from_wt(a.wt()),
                      thost.Pose.from_wt(b.wt()))):
            np.testing.assert_array_equal(x.R, y.R)
            np.testing.assert_array_equal(x.t, y.t)


def _lines_av(n=64, seed=6):
    """(cp, dv) lines, with a zero row and the orth gimbal lock (the
    normal along z) among them."""
    rng = np.random.default_rng(seed)
    av = rng.standard_normal((n, 6))
    av[0] = 0.0
    av[1] = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    av[2] = [0.0, 2.0, 0.0, -3.0, 0.0, 0.0]
    return av


def test_orth_conversions_identical():
    av = _lines_av()
    np.testing.assert_array_equal(thost._normalize_rows(av),
                                  jhost._normalize_rows(av))
    orth = jhost.av_to_orth_np(av)
    np.testing.assert_array_equal(thost.av_to_orth_np(av), orth)
    np.testing.assert_array_equal(thost.orth_to_av_np(orth[3:]),
                                  jhost.orth_to_av_np(orth[3:]))


def test_two_view_lines_identical():
    """The refine's wide-baseline init on random keyframe pairs, with
    near-parallel planes (first and last keyframe alike) among them."""
    rng = np.random.default_rng(7)
    L, K = 48, 12
    first, last = (rng.standard_normal((L, 8)) * 0.3 for _ in range(2))
    last[:4] = first[:4]
    kf0 = rng.integers(0, K, L)
    kf1 = rng.integers(0, K, L)
    R = np.stack([jhost.rodrigues(w) for w in rng.standard_normal((K, 3))])
    t = rng.standard_normal((K, 3))
    fb = _lines_av(L, seed=8)
    np.testing.assert_array_equal(
        trefine._two_view_lines(first, last, kf0, kf1, R, t, fb),
        jrefine._two_view_lines(first, last, kf0, kf1, R, t, fb))


def test_trajectory_writers_identical(tmp_path):
    poses = [T.inv() for T in jsim.wave_trajectory(50)]
    jwriters.write_trajectory(tmp_path / "j.txt", poses)
    twriters.write_trajectory(tmp_path / "t.txt",
                              [thost.Pose(T.R, T.t) for T in poses])
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    np.testing.assert_array_equal(twriters.trajectory_rows(poses),
                                  jwriters.trajectory_rows(poses))


@pytest.mark.parametrize("n_houses,ring", [(6, 9.0), (8, 10.0)])
def test_village_identical(n_houses, ring):
    np.testing.assert_array_equal(tsim.village_segments(n_houses, ring),
                                  jsim.village_segments(n_houses, ring))
    kw = dict(num_frames=60, arc=2.7 * np.pi, orbit_radius=3.8)
    for a, b in zip(tsim.village_trajectory(**kw),
                    jsim.village_trajectory(**kw), strict=True):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)


def test_tracks_identical():
    """TrackIdAssigner's id churn and SegmentDescriptorSource's stream on
    the village's observations (ids lost and re-detected)."""
    segs = jsim.village_segments(6, 9.0)
    poses = jsim.village_trajectory(num_frames=40, arc=2.7 * np.pi,
                                    orbit_radius=3.8)
    ren = jsim.StereoLineRenderer(segs, jconfig.CameraConfig(),
                                  noise_px=0.3, seed=1)
    ja, ta = jsim.TrackIdAssigner(max_gap=5), tsim.TrackIdAssigner(max_gap=5)
    js = jsim.SegmentDescriptorSource(ja, len(segs), noise=0.01, seed=7)
    ts = tsim.SegmentDescriptorSource(ta, len(segs), noise=0.01, seed=7)
    for i, T in enumerate(poses):
        obs = ren.observe(T)
        a, b = ja.assign(i, obs), ta.assign(i, obs)
        assert sorted(a) == sorted(b)
        ids = sorted(a) + [10 ** 6]          # an unknown id: random
        np.testing.assert_array_equal(ts(i, ids), js(i, ids))
    assert ta.track_to_seg == ja.track_to_seg
    np.testing.assert_array_equal(ts.base, js.base)


def test_vocabulary_training_identical():
    rng = np.random.default_rng(3)
    d = rng.standard_normal((700, 72)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_array_equal(tvoc.build_vocabulary(d, seed=2,
                                                        kmeans_iters=2),
                                  jvoc.build_vocabulary(d, seed=2,
                                                        kmeans_iters=2))
    for n in (0, 5, 40, 300):       # empty, sparse and full nodes
        a = jvoc._kmeans(d[:n], 40, 3, np.random.default_rng(n))
        b = tvoc._kmeans(d[:n], 40, 3, np.random.default_rng(n))
        np.testing.assert_array_equal(b, a)


def test_vocabulary_presets_identical():
    for preset in ("indoor", "outdoor", "outdoor_long_loop"):
        assert (dataclasses.asdict(getattr(tvoc.VocTreeParams, preset)())
                == dataclasses.asdict(getattr(jvoc.VocTreeParams, preset)()))
    assert (dataclasses.asdict(tvoc.VocTreeParams())
            == dataclasses.asdict(jvoc.VocTreeParams()))


def _raw_segments(seed, n=60):
    """Grower-like output: near-parallel stroke-edge pairs, collinear
    fragments and strays, with gradient directions of both polarities."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(20, 600, (n // 3, 4))
    d = base[:, 2:4] - base[:, 0:2]
    nrm = np.stack([-d[:, 1], d[:, 0]], 1)
    nrm /= np.linalg.norm(d, axis=1, keepdims=True)
    off = rng.uniform(0.6, 4.0, (n // 3, 1))
    twin = base + np.concatenate([nrm, nrm], 1) * off
    frag = base.copy()
    frag[:, 0:2] = base[:, 2:4] + d * rng.uniform(0.02, 0.05, (n // 3, 1))
    frag[:, 2:4] = frag[:, 0:2] + d * 0.5
    segs = np.concatenate([base, twin, frag])
    ang = rng.uniform(0, 2 * np.pi, len(segs))
    g = np.stack([np.sin(ang), -np.cos(ang)], 1)
    g[n // 3:2 * (n // 3)] = -g[:n // 3]        # the twins: anti-parallel
    return segs, g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detector_postprocessing_identical(seed):
    from slslam_tpu.frontend import detector as jdet
    from slslam_tpu_torch.frontend import detector as tdet
    segs, g = _raw_segments(seed)
    np.testing.assert_array_equal(tdet.fuse_stroke_edge_pairs(segs, g),
                                  jdet.fuse_stroke_edge_pairs(segs, g))
    np.testing.assert_array_equal(tdet.merge_collinear_segments(segs),
                                  jdet.merge_collinear_segments(segs))
    a = np.linspace(-7, 7, 29)
    np.testing.assert_array_equal(tdet._angle_diff(a, 0.3),
                                  jdet._angle_diff(a, 0.3))


def test_image_renderer_and_draw_segments_identical():
    from slslam_tpu.sim import images as jimg
    from slslam_tpu_torch.sim import images as timg
    segs = np.array([[50.0, 50.0, 500.0, 80.0], [10.0, 400.0, 700.0, -20.0],
                     [3.0, 3.0, 3.5, 3.2]])
    for noise in (0.0, 1.5):
        np.testing.assert_array_equal(
            timg.draw_segments(segs, 640, 480, noise=noise,
                               rng=np.random.default_rng(1)),
            jimg.draw_segments(segs, 640, 480, noise=noise,
                               rng=np.random.default_rng(1)))
    jr = jimg.StereoImageRenderer(jsim.house_segments(), seed=5)
    tr = timg.StereoImageRenderer(tsim.house_segments(), seed=5)
    for T in jsim.wave_trajectory(400)[::150]:
        a, b = jr.render(T), tr.render(T)
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert sorted(b[2]) == sorted(a[2])


def test_matcher_helpers_identical():
    from slslam_tpu.frontend import matcher as jm
    from slslam_tpu_torch.frontend import matcher as tm
    rng = np.random.default_rng(8)
    a = rng.uniform(0, 600, (30, 4))
    b = a + rng.normal(0, 5, a.shape)
    b[::4, 1] = b[::4, 3]                       # zero vertical extent
    np.testing.assert_array_equal(tm._seg_angle(a), jm._seg_angle(a))
    np.testing.assert_array_equal(tm._angdiff(a[:, 0], b[:, 1]),
                                  jm._angdiff(a[:, 0], b[:, 1]))
    np.testing.assert_array_equal(tm._overlap_y_matrix(a, b),
                                  jm._overlap_y_matrix(a, b))
    for sl, sr in zip(a, b):
        np.testing.assert_array_equal(tm.StereoLineMatcher._obs(sl, sr),
                                      jm.StereoLineMatcher._obs(sl, sr))
    # the stereo pairing's gates, order and one-to-one resolution, on
    # descriptors with ties (repeated rows)
    d = rng.standard_normal((30, 72)).astype(np.float32)
    d[10:20] = d[:10]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    right = a.copy()
    right[:, [0, 2]] -= rng.uniform(0, 40, (30, 1))
    args = (a, right, d, d[rng.permutation(30)])
    pairs = tm.StereoLineMatcher._stereo_pairs(_bare(tm), *args)
    assert len(pairs) >= 10
    assert pairs == jm.StereoLineMatcher._stereo_pairs(_bare(jm), *args)


def _bare(mod):
    """A matcher of ``mod`` with the default gates and no detector."""
    m = mod.StereoLineMatcher.__new__(mod.StereoLineMatcher)
    m.max_disparity, m.min_desc_sim = 150.0, 0.0
    return m


def _detections(seed=4):
    """Raw detections (k, old_k, match) with runs, gaps and a jump."""
    rng = np.random.default_rng(seed)
    out = []
    for k in list(range(20, 34)) + [36, 37, 60, 61, 62, 90]:
        old = int(k * 0.3) + int(rng.integers(0, 2))
        out.append((k, old, {int(x): int(x) % 97 for x in
                             rng.integers(0, 500, rng.integers(3, 12))}))
    return out


@pytest.mark.parametrize("window", [3, 5, 10])
def test_span_candidates_and_merge_identical(window):
    c = _detections()
    assert tlc._span_candidates(c, window) == jlc._span_candidates(c, window)
    matches = [m for _, _, m in c] + [{5: 3, 3: 1}, {1: 5}]
    assert tlc._merge_fids(matches) == jlc._merge_fids(matches)


@pytest.mark.parametrize("scale", [0.0, 0.01, 0.5])
def test_consistency_check_identical(scale):
    rng = np.random.default_rng(6)
    poses = rng.standard_normal((12, 6)) * 0.5
    edges = []
    for i, j in ((0, 11), (2, 7), (5, 6)):
        rel = (jhost.Pose.from_wt(poses[j])
               @ jhost.Pose.from_wt(poses[i]).inv()).wt()
        edges.append((i, j, rel + rng.standard_normal(6) * scale))
    cfg_j, cfg_t = jconfig.SlamConfig(), tconfig.SlamConfig()
    assert (tlc._consistency_broken(poses, edges, cfg_t)
            == jlc._consistency_broken(poses, edges, cfg_j))


class _Prep:
    """The fields of a joint problem that the alignment reads."""

    def __init__(self, M_odo, new_k):
        self.M_odo = M_odo
        self.new_ks = [new_k]


def test_ransac_align_identical():
    """The line-cloud alignment on a cloud and its rigid image plus noise,
    with unusable rows (no observation, zero direction) among them."""
    rng = np.random.default_rng(8)
    L = 40
    lines_a = np.concatenate([rng.standard_normal((L, 3)) * 3,
                              rng.standard_normal((L, 3))], axis=1)
    S = jhost.Pose(jhost.rodrigues(np.array([0.1, -0.3, 0.2])),
                   np.array([1.0, 0.5, -2.0]))
    lines_b = np.concatenate([lines_a[:, :3] @ S.R.T + S.t,
                              lines_a[:, 3:] @ S.R.T], axis=1)
    lines_b += rng.standard_normal(lines_b.shape) * 0.01
    lines_b[3, 3:] = 0.0
    cnt_a = rng.integers(0, 4, L)
    cnt_b = rng.integers(1, 4, L)
    cfg_j, cfg_t = jconfig.SlamConfig(), tconfig.SlamConfig()
    M = jhost.Pose(S.R, S.t + 0.3)
    a = jlc._ransac_align(_Prep(M, 17), lines_a, cnt_a, lines_b, cnt_b, cfg_j)
    b = tlc._ransac_align(_Prep(thost.Pose(M.R, M.t), 17), lines_a, cnt_a,
                          lines_b, cnt_b, cfg_t)
    assert len(a) == len(b) > 200
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.R, x.R)
        np.testing.assert_array_equal(y.t, x.t)
    assert tlc._ransac_align(_Prep(M, 1), lines_a[:2], cnt_a[:2],
                             lines_b[:2], cnt_b[:2], cfg_t) is None


def _poses(n=6, seed=11):
    """World->camera poses along a wandering path with turns of up to 0.4
    rad a step."""
    rng = np.random.default_rng(seed)
    out, R, c = [], np.eye(3), np.zeros(3)
    for _ in range(n):
        R = jhost.rodrigues(rng.standard_normal(3) * 0.2) @ R
        c = c + rng.standard_normal(3) * 0.6
        out.append(jhost.Pose(R, -R @ c))
    return out


def test_viz_identical(tmp_path):
    """Both plots of slslam_tpu_torch.viz write the same PNG bytes as the
    originals on the same inputs."""
    from slslam_tpu import viz as jviz
    from slslam_tpu_torch import viz as tviz
    traj = [T.inv() for T in _poses()]
    segs = np.random.default_rng(1).standard_normal((20, 6)) * 3
    gt = jwriters.trajectory_rows(traj)
    obs = {3: np.arange(8.0) * 40, 17: np.arange(8.0)[::-1] * 30}
    img = np.random.default_rng(2).integers(0, 255, (48, 64)).astype(
        np.uint8)
    for mod, d in ((jviz, "j"), (tviz, "t")):
        mod.plot_map(traj, segs, str(tmp_path / d / "map.png"),
                     gt_trajectory=gt, title="m")
        mod.plot_observations(None, None, obs, str(tmp_path / d / "o.png"),
                              image_size=(64, 48), title="frame 3")
        mod.plot_observations(img, img, obs, str(tmp_path / d / "i.png"))
    for name in ("map.png", "o.png", "i.png"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


def test_viz_interactive_identical(tmp_path):
    from slslam_tpu import viz_interactive as jvi
    from slslam_tpu_torch import viz_interactive as tvi
    traj = [T.inv() for T in _poses()]
    segs = np.random.default_rng(3).standard_normal((9, 6))
    gt = jwriters.trajectory_rows(traj)
    kw = dict(gt_rows=gt, first_seen=list(range(9)),
              frame_stats=[{"obs": i, "iters": 2 * i} for i in range(6)],
              title="village")
    jvi.export_interactive_map(str(tmp_path / "j.html"), traj, segs, **kw)
    tvi.export_interactive_map(str(tmp_path / "t.html"), traj, segs, **kw)
    jvi.export_interactive_map(str(tmp_path / "j0.html"), traj[:1],
                               np.zeros((0, 6)))
    tvi.export_interactive_map(str(tmp_path / "t0.html"), traj[:1],
                               np.zeros((0, 6)))
    for a, b in (("j", "t"), ("j0", "t0")):
        assert ((tmp_path / f"{b}.html").read_text()
                == (tmp_path / f"{a}.html").read_text())


def test_street_helpers_identical():
    """The proxy world's helpers that read no file: the video-rate
    interpolation, the corridor world with signs and banners, the
    association outliers."""
    from slslam_tpu.sim import street as jst
    from slslam_tpu_torch.sim import street as tst
    poses = _poses(8)
    tposes = [thost.Pose(T.R, T.t) for T in poses]
    a = jst.interpolate_poses(poses, max_rot=0.05, max_trans=0.25)
    b = tst.interpolate_poses(tposes, max_rot=0.05, max_trans=0.25)
    assert len(a) == len(b) > 3 * len(poses)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.R, x.R)
        np.testing.assert_array_equal(y.t, x.t)
    for kw in (dict(), dict(sign_density=1.0, banner_every=4, seed=3,
                            return_arcs=True)):
        ja = jst.corridor_segments(a, lateral=5.0, **kw)
        tb = tst.corridor_segments(b, lateral=5.0, **kw)
        for x, y in zip(ja if kw else [ja], tb if kw else [tb]):
            assert len(x) > 20
            np.testing.assert_array_equal(y, x)
    assert jst.SEQUENCES == tst.SEQUENCES
    obs = {i: np.full(8, float(i)) for i in range(30)}
    ji, ti = jst.OutlierInjector(0.2, seed=5), tst.OutlierInjector(0.2, seed=5)
    for _ in range(4):
        x, y = ji(obs), ti(obs)
        assert sorted(x) == sorted(y)
        assert any(x[k][0] != k for k in x)
        for k in x:
            np.testing.assert_array_equal(y[k], x[k])


def test_real_proxy_matches_jax():
    """The proxy workload from the reference's trajectory files, and the
    port's tool on it: needs the files."""
    from slslam_tpu.sim import street as jst
    from slslam_tpu_torch.sim import street as tst
    from tools import torch_real_proxy
    if not os.path.isdir(tst.REFERENCE_DIR):
        pytest.skip("needs the reference's trajectory files in "
                    f"{tst.REFERENCE_DIR}")
    kw = dict(max_frames=20, noise_px=0.5, outlier_frac=0.05, seed=0,
              interpolate=True, ref_dir=tst.REFERENCE_DIR)
    ja = jst.real_proxy_workload("itbt3f", **kw)
    tb = tst.real_proxy_workload("itbt3f", **kw)
    for x, y in zip(ja[0], tb[0], strict=True):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(y[k], x[k])
    np.testing.assert_array_equal(tb[2], ja[2])
    assert tb[3] == ja[3]
    out = torch_real_proxy.run_sequence("itbt3f", torch_real_proxy.parser()
                                        .parse_args(["--max-frames", "20",
                                                     "--device", "cpu"]))
    assert out["ate_refined_m"] < 0.01 * out["path_len_m"]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_partition_by_line_identical(n_shards):
    """parallel/dist_ba.py's copy of partition_by_line: the same stacked
    shards and perm as the JAX package's, on a padded window with pad rows
    and lines without observations."""
    from slslam_tpu.parallel.dist_ba import partition_by_line as jpart
    from slslam_tpu_torch.parallel.dist_ba import partition_by_line as tpart
    rng = np.random.default_rng(n_shards)
    L, O = 37, 300
    args = (rng.standard_normal((L, 4)), rng.random(L) > 0.2,
            rng.standard_normal((O, 8)), rng.integers(0, 9, O).astype(
                np.int32), rng.integers(0, L - 3, O).astype(np.int32),
            rng.random(O) > 0.1, n_shards)
    for a, b in zip(tpart(*args), jpart(*args), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_scaling_tool_example_problem_identical():
    """tools/torch_scaling_bench.py's numpy copy of
    __graft_entry__._example_ba_problem."""
    import jax.numpy as jnp

    from __graft_entry__ import _example_ba_problem as jprob
    from tools.torch_scaling_bench import _example_ba_problem as tprob
    for C, L, O in ((8, 64, 256), (64, 512, 16384)):
        mine = tprob(C=C, L=L, O=O)
        theirs = jprob(C=C, L=L, O=O, dtype=jnp.float64)
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _port_modules():
    mods = [slslam_tpu_torch.__name__]
    for info in pkgutil.walk_packages(slslam_tpu_torch.__path__,
                                      slslam_tpu_torch.__name__ + "."):
        mods.append(info.name)
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter imports every module of the port, chip_smoke
    and profile_replay: jax and slslam_tpu stay out of sys.modules."""
    mods = _port_modules() + ["chip_smoke", "profile_replay"] + TOOLS
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'slslam_tpu' or "
            "m.startswith('slslam_tpu.'))\n"
            "print(len(bad), bad[:10])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[0] == "0", proc.stdout
    assert len(mods) > 15
    for m in ("slslam_tpu_torch.loopclosure",
              "slslam_tpu_torch.ops.pose_graph",
              "slslam_tpu_torch.engine.batch_lc",
              "slslam_tpu_torch.engine.slam",
              "slslam_tpu_torch.checkpoint", "slslam_tpu_torch.native",
              "slslam_tpu_torch.frontend.io",
              "slslam_tpu_torch.frontend.detector",
              "slslam_tpu_torch.frontend.descriptor",
              "slslam_tpu_torch.frontend.matcher",
              "slslam_tpu_torch.sim.images", "slslam_tpu_torch.viz",
              "slslam_tpu_torch.viz_interactive",
              "slslam_tpu_torch.sim.street", "tools.torch_frontend_bench",
              "tools.torch_large_map_bench", "tools.torch_param_study",
              "tools.torch_scale_lc", "tools.torch_real_proxy",
              "slslam_tpu_torch.parallel",
              "slslam_tpu_torch.parallel.comm",
              "slslam_tpu_torch.parallel.dist_ba",
              "slslam_tpu_torch.parallel.dist_pgo",
              "slslam_tpu_torch.parallel.multihost",
              "tools.torch_scaling_bench"):
        assert m in mods, m


def _sources():
    root = os.path.join(REPO, "slslam_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "profile_replay.py")
    for m in TOOLS:
        yield os.path.join(REPO, *m.split(".")) + ".py"


def test_port_sources_name_no_jax_import():
    """No import statement of the port (including those inside functions)
    names jax or slslam_tpu."""
    found = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("jax", "slslam_tpu"):
                    found.append((os.path.relpath(path, REPO), n))
    assert found == []


def test_interactive_hostgeom_identical():
    rng = np.random.default_rng(9)
    av = _lines_av(40, seed=9)[3:]
    for R in _rotations():
        Tj = jhost.Pose(R, rng.standard_normal(3))
        Tt = thost.Pose(Tj.R, Tj.t)
        for line in av[:5]:
            np.testing.assert_array_equal(thost.line_to_pose(line, Tt),
                                          jhost.line_to_pose(line, Tj))
            np.testing.assert_array_equal(thost.line_from_pose(line, Tt),
                                          jhost.line_from_pose(line, Tj))
        np.testing.assert_array_equal(thost.lines_from_pose(av, Tt),
                                      jhost.lines_from_pose(av, Tj))
        assert thost.rotation_angle(R) == jhost.rotation_angle(R)
    for v in (np.zeros(3), av[0, 3:]):
        np.testing.assert_array_equal(thost.normalize(v), jhost.normalize(v))
    aid = jhost.av_to_aid_np(av)
    np.testing.assert_array_equal(thost.av_to_aid_np(av), aid)
    np.testing.assert_array_equal(thost.aid_to_av_np(aid),
                                  jhost.aid_to_av_np(aid))


def test_traj_metrics_and_stopwatch_identical():
    from slslam_tpu.evalio import traj as jtraj
    from slslam_tpu.utils import stopwatch as jsw
    from slslam_tpu_torch.evalio import traj as ttraj
    from slslam_tpu_torch.utils import stopwatch as tsw
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((30, 7)), rng.standard_normal((25, 7))
    for name in ("ate_position_error", "ate_matlab_literal", "ate_aligned"):
        assert getattr(ttraj, name)(a, b) == getattr(jtraj, name)(a, b)
    np.testing.assert_array_equal(ttraj.align_heading(a),
                                  jtraj.align_heading(a))
    for sw in (jsw.StopWatch(), tsw.StopWatch()):
        sw.tock("never opened")
        for _ in range(3):
            sw.tick("c")
            sw.tock("c")
        assert sw.stats("c").count == 3 and sw.stats("c").mean >= 0.0
        assert sw.stats("none").mean == 0.0 and sw.elapsed() > 0.0


def test_map_state_identical():
    from slslam_tpu.engine import state as jst
    from slslam_tpu_torch.engine import state as tst
    rng = np.random.default_rng(4)
    obs = [(int(k), rng.standard_normal(8)) for k in (3, 1, 7)]
    for mod, P in ((jst, jhost.Pose), (tst, thost.Pose)):
        lm = mod.Landmark(line=np.ones(6), init_kfid=1)
        assert lm.obs_arrays()[1].shape == (0, 8)
        lm.obs_vec.extend(obs)
        k, o = lm.obs_arrays()
        np.testing.assert_array_equal(k, [3, 1, 7])
        np.testing.assert_array_equal(o, np.stack([x for _, x in obs]))
        e = mod.Edge.from_pose(P(jhost.rodrigues([0.1, 0.2, 0.3]),
                                 [1.0, 2.0, 3.0]))
        np.testing.assert_array_equal(e.inverse().C.t, e.T.inv().t)
        st = mod.MapState()
        assert st.last_kf_id() is None
        st.kfs[4] = mod.Keyframe(T=P())
        assert st.last_kf_id() == 4
    assert ([f.name for f in dataclasses.fields(jst.Landmark)]
            == [f.name for f in dataclasses.fields(tst.Landmark)])


def test_obs_files_and_writers_identical(tmp_path):
    """The renderer's line-track files, their loader (native and numpy
    paths, a malformed line, a missing frame 0) and the landmark writer."""
    from slslam_tpu.frontend import io as jio
    from slslam_tpu_torch.frontend import io as tio
    poses = jsim.wave_trajectory(400)[:5]
    kw = dict(noise_px=0.5, seed=3)
    jsim.StereoLineRenderer(jsim.house_segments(), jconfig.CameraConfig(),
                            **kw).write_sequence(str(tmp_path / "j"), poses)
    tsim.StereoLineRenderer(tsim.house_segments(), tconfig.CameraConfig(),
                            **kw).write_sequence(
        str(tmp_path / "t"), [thost.Pose(T.R, T.t) for T in poses])
    for i in range(5):
        name = f"{i:04d}.txt"
        assert ((tmp_path / "j" / name).read_bytes()
                == (tmp_path / "t" / name).read_bytes())
    (tmp_path / "t" / "0000.txt").unlink()
    with open(tmp_path / "t" / "0003.txt", "a") as f:
        f.write("oops not a row\n")
    got = list(tio.ObsFileLoader(str(tmp_path / "t")))
    want = list(jio.ObsFileLoader(str(tmp_path / "t")))
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(5))
    for (_, a), (_, b) in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    segs = [np.arange(6.0) + k for k in range(4)]
    jwriters.write_landmarks(tmp_path / "jl.txt", segs)
    twriters.write_landmarks(tmp_path / "tl.txt", segs)
    assert ((tmp_path / "jl.txt").read_bytes()
            == (tmp_path / "tl.txt").read_bytes())


def test_native_builds_outside_native_dir(tmp_path, monkeypatch):
    """The port's native library builds into its build directory, never
    into the repository's native/, and parses and walks as JAX's
    binding."""
    from slslam_tpu import native as jnative
    from slslam_tpu_torch import native as tnative
    native_dir = os.path.join(REPO, "native")

    def listing():
        return {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
                for f in os.listdir(native_dir)}

    before = listing()
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    assert tnative.available(), tnative.build_error
    built = os.listdir(tmp_path / "build")
    assert any(f.startswith("libslslam_native_") and f.endswith(".so")
               for f in built)
    assert listing() == before
    path = tmp_path / "obs.txt"
    path.write_text("3 1 2 3 4 5 6 7 8 0\n9 0.5 0 0 0 0 0 0 1 0\n")
    a, b = tnative.parse_obs_file(str(path)), jnative.parse_obs_file(str(path))
    assert sorted(a) == sorted(b) == [3, 9]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
