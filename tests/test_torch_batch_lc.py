"""The port's deferred loop closure (slslam_tpu_torch/engine/batch_lc.py)
against JAX's, on the CPU in float64.

The workload is bench.py's lc configuration (village of 6 houses, ring
radius 9, orbit radius 3.8, 0.3 px noise, render seed 1, descriptor seed
7, every frame a keyframe, bench.py's village buckets) cut to 100 frames
over an arc of 2.3 pi: the shortest village orbit here on which JAX's
post-pass still closes loops (2 closures, 102 merged tracks).  The JAX
replay runs once per module; both post-passes start from its result and
from the same descriptors (computed once, in frame order), and the port's
span solves take JAX's Gumbel stream, fold_in(PRNGKey(rseed ^ 0x10C),
keyframe).  Tolerances: decisions (closures, merges, events, scores,
inlier pairs, lanes, winners, refine_pick) identical; loop edges within
1e-6; the final trajectory within 1e-6 m."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.config import SlamConfig
from slslam_tpu.engine import batch_lc as jlc
from slslam_tpu.engine.batch import BatchSlam as JBatchSlam
from slslam_tpu.loopclosure import VocTree as JTree
from slslam_tpu.loopclosure import build_vocabulary
from slslam_tpu.loopclosure.batch import BatchPlaceRecognizer as JBatchRec
from slslam_tpu.loopclosure.voctree import VocTreeParams as JParams
from slslam_tpu.sim import (SegmentDescriptorSource, StereoLineRenderer,
                            TrackIdAssigner, village_segments,
                            village_trajectory)
from slslam_tpu_torch.config import SlamConfig as TSlamConfig
from slslam_tpu_torch.engine import batch_lc as tlc
from slslam_tpu_torch.engine.batch import BatchResult as TBatchResult
from slslam_tpu_torch.hostgeom import Pose as TPose
from slslam_tpu_torch.loopclosure import (BatchPlaceRecognizer,
                                          PlaceRecognizer, VocTree,
                                          VocTreeParams)

torch.set_num_threads(2)

NF, ARC = 100, 2.3
KW = dict(compute_dtype="float64", kf_rot_thr=1e-9, kf_tr_thr=1e-9,
          obs_buckets=(64, 80, 128, 256, 512, 1024, 2048),
          line_buckets=(32, 64, 128, 320, 512, 1024, 2048),
          corr_buckets=(80, 256))
JCFG = dataclasses.replace(SlamConfig(), **KW)
TCFG = dataclasses.replace(TSlamConfig(), **KW)
VT = dict(non_consider_recent=10, consider_seq_length=4, threshold=0.25,
          num_avg_words=30)


def hook(k, H, N_):
    """JAX's span noise: gumbel(fold_in(PRNGKey(rseed ^ 0x10C), k))."""
    g = jax.random.gumbel(
        jax.random.fold_in(jax.random.PRNGKey(JCFG.rseed ^ 0x10C), k),
        (H, N_), jnp.float64)
    return torch.as_tensor(np.array(g))


def _port_result(r):
    return TBatchResult([TPose(T.R, T.t) for T in r.trajectory], r.edges_wt,
                        r.is_kf, r.kf_count, [], dict(r.stats), r.per_frame)


@pytest.fixture(scope="module")
def lc():
    segs = village_segments(n_houses=6, ring_radius=9.0)
    poses = village_trajectory(num_frames=NF, arc=ARC * np.pi,
                               orbit_radius=3.8)
    ren = StereoLineRenderer(segs, JCFG.camera, noise_px=0.3, seed=1)
    assigner = TrackIdAssigner(max_gap=5)
    src = SegmentDescriptorSource(assigner, len(segs), noise=0.01, seed=7)
    frames = [assigner.assign(i, ren.observe(T)) for i, T in enumerate(poses)]
    rng0 = np.random.default_rng(0)
    samples = np.concatenate([
        src.base + rng0.standard_normal(src.base.shape).astype(np.float32)
        * 0.02 for _ in range(3)])
    samples /= np.linalg.norm(samples, axis=1, keepdims=True)
    vocab = build_vocabulary(samples, seed=0, kmeans_iters=2)
    res = JBatchSlam(JCFG).run(frames)
    pre = [src(i, sorted(fr)) for i, fr in enumerate(frames)]

    class Replayed:
        def dispatch(self, frames, **kw):
            return None

        def collect(self, handle):
            return res

    eng = jlc.BatchSlamLC(JCFG, recognizer=JBatchRec(JTree(vocab,
                                                           JParams(**VT))),
                          descriptor_source=lambda i, f: pre[i],
                          refine=True, refine_rounds=2)
    eng._batch = Replayed()
    jout = eng.run(frames)
    kf_idx = np.flatnonzero(res.is_kf)
    hits = JBatchRec(JTree(vocab, JParams(**VT))).recognize_all(
        list(range(len(kf_idx))), [sorted(frames[f]) for f in kf_idx],
        [pre[f] for f in kf_idx])
    cands = [(k, h[0], h[1]) for k, h in enumerate(hits) if h is not None]
    return dict(frames=frames, poses=poses, vocab=vocab, res=res, pre=pre,
                jout=jout, kf_idx=kf_idx, assigner=assigner,
                spans=jlc._span_candidates(cands, JCFG.ba_window_size))


@pytest.fixture(scope="module")
def tout(lc):
    eng = tlc.BatchSlamLC(
        TCFG, recognizer=BatchPlaceRecognizer(VocTree(
            lc["vocab"], VocTreeParams(**VT), device="cpu")),
        descriptor_source=lambda i, f: lc["pre"][i], refine=True,
        device="cpu", gumbel_hook=hook)
    return eng.post_pass(lc["frames"], _port_result(lc["res"]),
                         pre_desc=lc["pre"])


def _event_key(e):
    return (e.old_kf, e.new_kf, e.n_matches, e.ransac_score, e.accepted,
            e.deduped, e.joint, e.wt_rel is None)


def test_post_pass_matches_jax(lc, tout):
    jout = lc["jout"]
    for k in ("num_loop_candidates", "num_loop_spans", "num_loop_closures",
              "num_merged_tracks", "pgo_iterations", "num_joint_solves",
              "refine_pick"):
        assert tout.stats[k] == jout.stats[k], k
    assert tout.stats["num_loop_closures"] >= 1
    assert tout.merged_fids == jout.merged_fids
    assert [_event_key(e) for e in tout.events] == \
        [_event_key(e) for e in jout.events]
    for a, b in zip(tout.events, jout.events):
        if a.wt_rel is not None:
            np.testing.assert_allclose(a.wt_rel, b.wt_rel, atol=1e-6)
    d = max(np.linalg.norm(a.t - b.t)
            for a, b in zip(tout.trajectory, jout.trajectory))
    assert d <= 1e-6, d
    assert tout.refined.iterations == jout.refined.iterations
    # every merge identifies one world segment; the loop closure beats
    # odometry
    seg = lc["assigner"].track_to_seg
    assert all(seg[a] == seg[r] for a, r in tout.merged_fids.items())
    kfi, poses = lc["kf_idx"], lc["poses"]
    gt = [(poses[i] @ poses[kfi[0]].inv()).inv() for i in kfi]

    def ate(traj):
        return np.mean([np.linalg.norm(a.t - b.t) for a, b in zip(traj, gt)])

    assert ate(tout.trajectory) < ate(lc["res"].trajectory)
    assert tout.stats["descriptor_stream_changed"] is False


def _round_cands(lc, rnd):
    return [sorted(s, key=lambda c: -len(c[2]))[rnd] for s in lc["spans"]
            if rnd < len(s)]


def test_solve_span_round_matches_jax(lc):
    """Two rounds of span representatives, JAX's Gumbel stream injected:
    the same accept / reject, scores, offered counts and inlier pairs, and
    the loop edges within 1e-6."""
    frames, kf_idx = lc["frames"], lc["kf_idx"]
    cands = _round_cands(lc, 0) + _round_cands(lc, 1)
    assert len(cands) >= 3
    base = jax.random.PRNGKey(JCFG.rseed ^ 0x10C)
    a = jlc._solve_span_round(cands, frames, kf_idx, JCFG, jnp.float64,
                              base)
    b = tlc._solve_span_round(cands, frames, kf_idx, TCFG, torch.float64,
                              "cpu", hook)
    accepted = 0
    for (wa, sa, na, pa), (wb, sb, nb, pb) in zip(a, b):
        assert (sb, nb, pb) == (sa, na, pa)
        assert (wb is None) == (wa is None)
        if wa is not None:
            accepted += 1
            np.testing.assert_allclose(wb, wa, atol=1e-6)
    assert accepted >= 1


def test_joint_prep_matches_jax(lc):
    traj_j = lc["res"].trajectory
    traj_t = [TPose(T.R, T.t) for T in traj_j]
    for span in lc["spans"]:
        a = jlc._JointPrep(span, lc["frames"], lc["kf_idx"], traj_j, JCFG)
        b = tlc._JointPrep(span, lc["frames"], lc["kf_idx"], traj_t, TCFG)
        for name in ("old_ks", "new_ks", "cams", "line_ids", "pair_rows",
                     "n", "C", "L", "min_score"):
            assert getattr(b, name) == getattr(a, name), name
        for name in ("cam_wt", "rows", "ocam", "olin"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        np.testing.assert_array_equal(b.M_odo.wt(), a.M_odo.wt())


def _confirm_jobs(lc):
    """Every span as a confirm job, alternately with and without its
    2-view edge (the run skips revisit-range odometry-consistent edges;
    here the joint stage runs on all of them)."""
    res = lc["res"]
    jobs = []
    for i, span in enumerate(lc["spans"]):
        k, old_k, _ = sorted(span, key=lambda c: -len(c[2]))[0]
        edge = (old_k, k, (res.trajectory[k].inv()
                           @ res.trajectory[old_k]).wt())
        jobs.append((span, edge if i % 2 == 0 else None))
    return jobs


def _jax_group_fits(lc, rescue):
    preps = [(i, jlc._JointPrep(p.span, lc["frames"], lc["kf_idx"],
                                lc["res"].trajectory, JCFG))
             for i, p in rescue]
    return jlc._fit_group_problems(preps, lc["res"].trajectory, JCFG,
                                   jnp.float64)


def test_group_fits_match_jax(lc):
    """Both groups' lines-only fits of every span: lines seen by 4 or more
    of the group's cameras within 1e-4 of JAX's.  The fit is a 50-iteration
    LM whose shared trust region couples the lines, and it amplifies
    rounding: JAX's own fits part between its "scatter" and "onehot"
    assemblies by up to 3.6e-3 on these lines and 0.46 on lines seen by 3
    or fewer cameras (left out here); the port sits 4.8e-5 from JAX's
    "scatter" fit (CPU, float64)."""
    traj_t = [TPose(T.R, T.t) for T in lc["res"].trajectory]
    preps = [(i, tlc._JointPrep(s, lc["frames"], lc["kf_idx"], traj_t, TCFG))
             for i, s in enumerate(lc["spans"])]
    a = _jax_group_fits(lc, preps)
    b = tlc._fit_group_problems(preps, traj_t, TCFG, torch.float64, "cpu")
    assert sorted(b) == sorted(a) and a
    compared = 0
    for i in a:
        for side in (0, 2):
            np.testing.assert_array_equal(b[i][side + 1], a[i][side + 1])
            well = a[i][side + 1] >= 4
            compared += int(well.sum())
            np.testing.assert_allclose(b[i][side][well], a[i][side][well],
                                       atol=1e-4)
    assert compared >= 50


def test_joint_confirm_jobs_matches_jax(lc, monkeypatch):
    """Given JAX's group fits, the rest of the confirm stage (the RANSAC
    alignment, the candidate scoring, the joint polishes with prior edges,
    the verification and the vote) gives JAX's lanes, votes and winners;
    the loop edges within 1e-6."""
    frames, kf_idx, res = lc["frames"], lc["kf_idx"], lc["res"]
    traj_t = [TPose(T.R, T.t) for T in res.trajectory]
    jobs = _confirm_jobs(lc)

    def drift_ok(old_k, k, wt):
        return np.linalg.norm(wt[3:]) < 50.0

    a, _ = jlc._joint_confirm_jobs(jobs, frames, kf_idx, res.trajectory,
                                   JCFG, jnp.float64, drift_ok)
    monkeypatch.setattr(tlc, "_fit_group_problems",
                        lambda rescue, *args, **kw: _jax_group_fits(lc,
                                                                    rescue))
    b, stages = tlc._joint_confirm_jobs(jobs, frames, kf_idx, traj_t, TCFG,
                                        torch.float64, "cpu", drift_ok)
    assert len(b) == len(a) and any(x is not None for x in a)
    assert {"prep", "group_fits", "ransac_align", "joint_polish",
            "verify_vote"} <= set(stages)
    names = set()
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is None:
            continue
        (la, wa), (lb, wb) = x, y
        assert wb == wa
        assert [(l.init_name, l.old_rep, l.k_rep, l.n_final, l.n, l.vote_ok,
                 l.inl_pairs) for l in lb] == \
            [(l.init_name, l.old_rep, l.k_rep, l.n_final, l.n, l.vote_ok,
              l.inl_pairs) for l in la]
        for p, q in zip(la, lb):
            np.testing.assert_allclose(q.wt, p.wt, atol=1e-6)
            names.add(p.init_name)
    assert names == {"edge", "aligned", "odometry"}


class _Counting:
    """A descriptor source that records its calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, frame_id, feat_ids):
        self.calls.append(frame_id)
        rng = np.random.default_rng(frame_id)
        d = rng.standard_normal((len(feat_ids), 72)).astype(np.float32)
        return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("overlap", [True, False])
def test_descriptor_stream_changed_is_recorded(lc, overlap):
    """overlap_descriptors=True with frames that are not keyframes asks
    the source for every frame (another call stream than the default
    keyframe-only one, batch_lc.py:1106-1115): the port warns and records
    it in stats; the default path calls the keyframes only."""
    frames = lc["frames"][:6]
    is_kf = np.array([True, True, False, True, False, True])
    traj = [TPose() for _ in range(4)]
    res = TBatchResult(traj, np.zeros((3, 6)), is_kf, 4, [], {}, {})

    class Replayed:
        def dispatch(self, frames, **kw):
            return None

        def collect(self, handle):
            return res

    src = _Counting()
    eng = tlc.BatchSlamLC(
        TCFG, recognizer=PlaceRecognizer(VocTree(lc["vocab"],
                                                 VocTreeParams(**VT),
                                                 device="cpu")),
        descriptor_source=src, overlap_descriptors=overlap, device="cpu")
    eng._batch = Replayed()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = eng.run(frames)
    changed = [w for w in caught if "call stream" in str(w.message)]
    assert out.stats["descriptor_stream_changed"] is overlap
    assert bool(changed) is overlap
    assert src.calls == (list(range(6)) if overlap else [0, 1, 3, 5])
