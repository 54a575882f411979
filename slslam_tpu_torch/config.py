"""Configuration of the port: ``SlamConfig``, ``CameraConfig``, ``bucket_for``.

A copy of ``slslam_tpu/config.py`` (the classes and function above, field for
field and value for value), kept here so that the port imports nothing of
the JAX package.  ``tests/test_torch_copies.py`` checks that the copies
agree with the originals.  Numeric values are the reference's
(src/parameter.h:43-62).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Stereo rig calibration (reference: src/parameter.h:43-52)."""

    image_width: int = 640
    image_height: int = 480
    baseline: float = 0.12
    focal_length: float = 406.05
    cx: float = 327.783
    cy: float = 237.172

    @property
    def fx(self) -> float:
        return self.focal_length

    @property
    def fy(self) -> float:
        return self.focal_length


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Engine thresholds and solver knobs.

    Reference sources: RANSAC constants src/parameter.h:25-26,53; thresholds
    src/parameter.h:55-62; runtime flags src/main.cpp:22-27.
    """

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)

    # RANSAC (reference: src/parameter.h:25-26,53). The reference runs an
    # adaptive sequential loop capped at max_trials=1000; the TPU engine runs a
    # fixed batch of hypotheses scored in parallel (shape-stable under jit).
    ransac_min_sample: int = 5           # max_feat_num
    ransac_num_hypotheses: int = 256     # fixed batched trial count
    # Minimal-solver rotation re-linearizations: 1 = the reference's
    # single small-angle LS (slam.cpp:435-483); 2+ compose successive
    # solves on rotated normals, removing the O(theta^2) bias (~3% at
    # the 15-degree keyframe gate).  Cheap: one extra 2Sx3 solve per
    # hypothesis per extra iteration.
    vo_relin_iters: int = 2
    prob_free_outliers: float = 0.999
    ransac_max_t_norm: float = 1.0       # hypothesis reject (src/slam.cpp:401)
    # The |t| <= 1 gate assumes inter-frame motion; a recognized loop
    # keyframe can legitimately sit further away (place recognition
    # resolution is one document).  The ONLINE path (engine/slam.py,
    # reference semantics) closes loops at revisit range, so its gate
    # stays modest:
    lc_ransac_max_t_norm: float = 2.5
    # The DEFERRED path (engine/batch_lc.py) accepts terminal-approach
    # detections that fire while the camera is still 4-17 m from the
    # recognized keyframe (measured on the olympic4f/myungdong proxies;
    # a 2.5 m gate rejected every genuine closure solve there); its real
    # verification is the joint-refit inlier vote + the drift-fraction
    # gate, so this bound only rejects wild garbage.
    lc_defer_max_t_norm: float = 30.0
    # Loop-edge acceptance requires this many post-moBA inliers AND this
    # fraction of the offered matches.  The reference's pose estimation
    # only needs >= 5 absolute inliers (slam.cpp:295-298), but its live
    # LC path never shipped; measured on the village workload, 5-of-11
    # and 12-of-28 edges are meters wrong while genuine revisits score
    # > 90% inliers — the ratio + absolute floor separates them cleanly.
    lc_min_inliers: int = 8
    lc_min_inlier_ratio: float = 0.6
    # Odometry-consistency sanity gate on accepted loop edges: the
    # correction a loop edge implies (its deviation from the
    # odometry-implied relative pose) cannot exceed plausible
    # accumulated drift — this fraction of the path length between the
    # two keyframes.  Catches wrong-but-self-consistent relative-pose
    # solutions along weakly observable directions (measured on the
    # olympic4f proxy: an edge 9.5 m off with a 40/60 refit inlier vote,
    # vs ~1-2% actual drift).  The reference's consistency_broken check
    # (slam.cpp:1215-1232) plays the symmetric role AFTER insertion.
    lc_max_drift_frac: float = 0.03
    # A 2-view span edge longer than this gets CONFIRMED by the joint
    # multi-keyframe solve before use (engine/batch_lc.py): long edges
    # are terminal-approach closures whose single-stereo-pair geometry
    # leaves a weak translation mode (olympic4f's accepted 2-view edge
    # measured 3.3 m off ground truth), while revisit-range edges are
    # reliable and their joint confirms only cost wall (the village LC
    # bench spent 10-15 s confirming 9 sub-meter edges for identical
    # results).  The value mirrors lc_ransac_max_t_norm: the online
    # path's own notion of revisit range.
    lc_confirm_t_norm: float = 2.5
    # ... AND the correction it implies must be small: a short 2-view
    # edge whose deviation from the odometry-implied relative pose
    # exceeds this (meters) wants to MOVE the map, and that claim needs
    # the joint multi-keyframe confirm (with its odometry-null lane)
    # behind it.  Measured r5: myungdong seed 2's revisit-range edge
    # skipped confirmation and its accepted correction REGRESSED the
    # trajectory 1.21 -> 1.91 m.  Odometry-consistent short edges still
    # skip (the village workload's sub-meter edges confirm to identical
    # results, pure wall cost).
    lc_confirm_dev_t: float = 0.3
    # Counterfactual basin selection (engine/batch_lc.py): a contested
    # closure whose implied correction is below this fraction of the
    # path between its endpoints keeps the map odometry-anchored (the
    # closure still contributes its verified merges + weak edge prior);
    # above it, the stitched jump stands.  Measured r5: for corrections
    # in this regime EVERY internal signal saturates in both basins —
    # refine cost (the wrong basin was 5.6% CHEAPER), merged-track
    # inlier fraction (97-99% both basins, at full AND half threshold)
    # — so a sub-noise correction is unverifiable from the data, and
    # odometry is the prior-correct anchor (the proxies' odometry floor
    # measures 0.4-1.3% of path wolc).  Genuine closures sit far above:
    # olympic4f s1's 6.4 m correction is 2.7% of path.
    lc_counterfactual_corr_frac: float = 0.01

    # Reprojection / thresholds (reference: src/parameter.h:55-62).
    inverse_depth: float = 0.1
    kf_rot_thr: float = 15.0 * math.pi / 180.0
    kf_tr_thr: float = 0.75
    # PGO consistency gate (slam.cpp:1215-1232 reuses the keyframe
    # constants; kept independent here so workloads that disable the
    # keyframe gates — every-frame-keyframe replays — still gate PGO at
    # the reference's fixed 15 deg / 0.75 m)
    pgo_consistency_rot_thr: float = 15.0 * math.pi / 180.0
    pgo_consistency_tr_thr: float = 0.75
    # global-refine odometry-chain prior (ops/schur_cg.py prior_c): sigma
    # per consecutive-keyframe edge.  Deliberately WEAK: a null mode (no
    # observation information) is pinned by any prior weight at all, while
    # observable corrections must not be blocked (sigma_t=0.1 froze the
    # every-frame-keyframe replay at its odometry ATE).  Even this weak
    # sigma costs accuracy on fully-observable maps (house-400: 0.0015 m
    # pure ML vs 0.046 m with prior), which is why global_refine's "auto"
    # mode enables the prior only for band-visibility maps
    # (engine/refine.py detect_band_visibility).
    refine_prior_sigma_rot: float = 0.2
    refine_prior_sigma_t: float = 2.0
    line_vn_angle_thr: float = 3.0 * math.pi / 180.0
    extension_length: float = 5.0

    # Solver flags (reference: src/main.cpp:22-27, src/lba_problem.cpp:26-43).
    ba_window_size: int = 10
    # LM iteration cap.  The reference's gflags default is 10, but its own
    # benchmark baseline sweeps maxnumiter=1000 (the 35.9 s row,
    # BASELINE.md) and cap 10 under-converges dense outdoor-scale windows:
    # on the real-sequence proxies avg iterations pinned at the cap and
    # ATE was a chaotic function of it (myungdong across seeds: 1.7-11 m
    # at cap 10 vs 0.87-1.97 m at cap 50; PERF_HISTORY r4).  Convergence
    # tolerances exit early everywhere the cap does not bind (house f32
    # steady state ~5 iterations), so the higher default costs nothing on
    # easy windows.  Documented deviation, PARITY.md.
    max_num_iter: int = 50
    # Weak Gaussian anchor of each free window camera at its initial
    # (odometry-predicted) pose during windowed BA (ops/schur_ba.py
    # cam_anchor_sigmas; 0 = off — the DEFAULT: measured on the
    # myungdong proxy, anchoring at (0.02 rad, 0.1 m) froze the window
    # solve to pure-VO odometry and drove ATE 1.7 -> 12 m; the window
    # corrections an anchor would suppress carry the drift correction).
    # Kept as a knob for genuinely anchor-needing workloads.
    window_anchor_sigma_rot: float = 0.0
    window_anchor_sigma_t: float = 0.0
    # Motion-only-BA (VO polish) iteration cap.  Capping it at the
    # reference's flag default (10) was measured to buy only ~2% replay
    # throughput while degrading olympic4f proxy odometry 1.27 -> 1.89 m
    # (the polish genuinely uses the budget on hard frames), so it
    # matches the windowed cap.
    moba_max_iter: int = 50
    # Lines-only damped-GN pre-stage before each windowed BA
    # (ops/schur_ba.py lines_gn_impl; 0 = off).  New lines enter the map
    # triangulated from one stereo pair — meters of depth noise outdoors
    # — and the joint LM burns its whole iteration cap dragging them in
    # (proxy avg_num_iterations pinned at the cap with seed-dependent
    # multi-meter drift; measured r4).  A few parallel 4x4 GN steps land
    # the line blocks in their basin first.  No reference analog: Ceres
    # re-solves from scratch each window and eats the iterations instead.
    # Applied to ALL lines qualifying for BA, every window: restricting
    # it to first-time-qualifying lines was tried (r4) and REJECTED —
    # the joint LM shares its iterations between cameras and lines, and
    # dropping the continuous staged line polish drove the interactive
    # engine's mapped-landmark median 0.02 -> 0.19 m off-world (see
    # engine/batch.py).  2 iterations measured 1.21% myungdong
    # worst-seed vs 0.99% at 4 — the full 4 stay.
    lines_gn_iters: int = 4
    # 4-DoF line parameterization used by the solvers: "orth" (production,
    # gc.cpp:361-460), "aid" or "asd" (the study's alternatives,
    # gc.cpp:188-356; see BASELINE.md §1)
    line_param: str = "orth"
    robust: bool = True                  # Huber loss, delta = 1/focal_length
    rseed: int = 4
    pgo_num_iter: int = 10               # src/slam.cpp:1283

    # VO failure containment (no reference analog — slam.cpp:274-298 just
    # skips the frame and retries against the same stale keyframe, so a
    # few sparse frames can kill tracking for the rest of the run): after
    # this many consecutive RANSAC failures with enough common features,
    # accept a RECOVERY keyframe using the best-effort polished motion
    # (score below the inlier floor); windowed BA then re-estimates it
    # jointly.  0 = reference behavior (never recover).
    vo_fail_recovery: int = 3

    # The released reference never populates curr_ba_kfs, so its delete_lms
    # (src/slam.cpp:765-791) is a no-op and landmarks are never
    # garbage-collected.  False reproduces that; True enables the intended
    # semantics (delete never-twice-observed landmarks of keyframes leaving
    # the BA window).
    gc_landmarks: bool = False

    # TPU-native knobs (no reference analog).
    compute_dtype: str = "float32"       # device kernel dtype
    # TPU matmuls default to bfloat16 multiplication passes, which destroys
    # the normal-equation conditioning (measured: house-sim ATE 0.10 m vs
    # 0.016 m).  "highest" forces full-f32 MXU passes for all solver
    # matmuls; the kernels stay latency-bound so the cost is negligible.
    matmul_precision: str = "highest"
    # Deterministic keyed jitter added to FREE line parameters at BA entry
    # (an annealing knob; 0 = off, the default).  Investigation notes: the
    # every-frame-keyframe replay workload has a weakly observable mode —
    # camera translation along the dominant scene-line direction trades off
    # against a common line shift, so the first ~dozen edges inherit frozen
    # stereo-triangulation noise (~0.15 m/line at 6 m depth, 0.12 m
    # baseline) projected onto that mode (~0.03 m/edge) and freeze before
    # windowed BA heals the map (seed-dependent ATE 0.01-0.34 m over 400
    # frames; the reference's window policy, slam.cpp:1374-1382, freezes
    # identically).  This jitter was tested as a mitigation and does NOT
    # help (the basin is re-entered within one solve); the structural fix
    # is the post-replay global refinement pass.
    ba_init_jitter: float = 0.0
    # Distributed execution: 0 = single device; N > 1 = run local BA
    # line-sharded and pose-graph optimization edge-sharded over an
    # N-device mesh (jax.devices()[:N]).
    mesh_devices: int = 0
    # Capacity buckets used to keep jitted kernel shapes stable. A problem of
    # size n runs in the smallest bucket >= n.
    obs_buckets: tuple = (64, 128, 256, 512, 1024, 2048, 4096)
    cam_buckets: tuple = (4, 8, 16, 32, 64, 128)
    line_buckets: tuple = (32, 64, 128, 256, 512, 1024, 2048)
    # correspondence count for the VO kernel (common features between two
    # frames — much smaller than the BA observation pool)
    corr_buckets: tuple = (64, 128, 256, 512)

    @property
    def error_thr(self) -> float:
        # src/parameter.h:56 — 5 px in normalized coords.
        return 5.0 / self.camera.focal_length

    @property
    def huber_delta(self) -> float:
        # src/lba_problem.cpp:78-80 — Huber delta = 1/focal_length.
        return 1.0 / self.camera.focal_length


def bucket_for(n: int, buckets) -> int:
    """Smallest capacity bucket >= n (last bucket if n exceeds all)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
