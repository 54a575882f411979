"""Post-replay global refinement: one full-sequence bundle adjustment.

Port of ``slslam_tpu/engine/refine.py`` (see its docstring for why a
global BA follows the windowed replay).  ``global_refine`` rebuilds the
whole problem from the replayed frames and the batch engine's trajectory,
solves it in rounds that re-triangulate the lines from the refined poses,
and returns the refined trajectory and lines.

Solver selection follows the JAX module: small problems on the CPU run the
exact dense-W Schur solver (``ops/schur_ba.py`` ``local_ba``), everything
else the matrix-free PCG Schur solver (``ops/schur_cg.py``
``global_ba_cg``), whose evaluate is K2's ``lm`` variant on the card.  The
host-side problem building (``build_problem_structure``,
``detect_band_visibility``, the two-view line init) is a numpy copy of the
JAX module's (tests/test_torch_refine.py holds it to the original); the
triangulation and the candidate scoring run in the solve's dtype on the
solve's device.

The pose priors follow the JAX module: the odometry-chain prior (on by
``detect_band_visibility`` for band-visibility maps, or forced) and
``prior_edges`` (the deferred loop closure's loop edges) enter the CG
solve, and a dense request with priors is overridden to CG with a warning.
Not ported: the vmapped multi-sequence ``global_refine_many``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, resolve_dtype
from ..config import SlamConfig, bucket_for
from ..hostgeom import Pose, av_to_orth_np, orth_to_av_np
from ..ops.residuals import lba_residual_batch
from ..ops.schur_ba import local_ba
from ..ops.schur_cg import global_ba_cg, pack_line_major
from ..ops.triangulate import triangulate_lines_host


@dataclasses.dataclass
class RefineResult:
    trajectory: List[Pose]      # refined camera-to-world, rooted at KF 0
    lines_world: np.ndarray     # (L, 6) refined (cp, dv) lines, world frame
    feature_ids: List[int]      # feature id per line row
    initial_cost: float
    final_cost: float
    iterations: int
    num_cams: int
    num_lines: int
    num_obs: int


@dataclasses.dataclass
class GlobalProblemStructure:
    """Trajectory-independent part of the global BA problem: which
    features qualify, their first/last observations, and the flat
    observation index arrays.  Built once and reused across refine
    rounds."""

    feat_ids: List[int]
    first_obs: np.ndarray   # (L, 8)
    last_obs: np.ndarray    # (L, 8)
    first_kf: np.ndarray    # (L,)
    last_kf: np.ndarray     # (L,)
    obs: np.ndarray         # (O, 8)
    ocam: np.ndarray        # (O,) int32
    olin: np.ndarray        # (O,) int32


def build_problem_structure(frames: List[Dict[int, np.ndarray]],
                            is_kf: np.ndarray,
                            min_obs: int = 2) -> GlobalProblemStructure:
    """Copy of slslam_tpu/engine/refine.py:73-109."""
    kf_frames = np.flatnonzero(np.asarray(is_kf, bool))

    # feature -> observing keyframe indices
    seen: Dict[int, List[int]] = {}
    for k, f in enumerate(kf_frames):
        for fid in frames[f]:
            seen.setdefault(fid, []).append(k)
    feat_ids = sorted(fid for fid, ks in seen.items() if len(ks) >= min_obs)
    fidx = {fid: i for i, fid in enumerate(feat_ids)}
    L = len(feat_ids)

    first_obs = np.zeros((L, 8))
    last_obs = np.zeros((L, 8))
    first_kf = np.zeros(L, np.int64)
    last_kf = np.zeros(L, np.int64)
    for fid, i in fidx.items():
        k0, k1 = seen[fid][0], seen[fid][-1]
        first_kf[i], last_kf[i] = k0, k1
        first_obs[i] = frames[kf_frames[k0]][fid]
        last_obs[i] = frames[kf_frames[k1]][fid]

    rows, ocam, olin = [], [], []
    for k, f in enumerate(kf_frames):
        for fid, o in frames[f].items():
            i = fidx.get(fid)
            if i is not None:
                rows.append(o)
                ocam.append(k)
                olin.append(i)
    obs = np.asarray(rows, np.float64).reshape(-1, 8)
    ocam = np.asarray(ocam, np.int32)
    olin = np.asarray(olin, np.int32)
    return GlobalProblemStructure(feat_ids, first_obs, last_obs, first_kf,
                                  last_kf, obs, ocam, olin)


def _init_candidates_host(s: GlobalProblemStructure, trajectory: List[Pose],
                          lines_cam: np.ndarray):
    """Host part of init_problem_values (refine.py:112-127): transform the
    stereo triangulation into the world frame and build the wide-baseline
    candidate.  Returns (cam_wt, lines_w, lines_wide)."""
    cam_wt = np.stack([T.inv().wt() for T in trajectory])  # world->cam
    lines_w = np.empty_like(lines_cam)
    R_cw = np.stack([T.R for T in trajectory])
    t_cw = np.stack([T.t for T in trajectory])
    lines_w[:, :3] = np.einsum("lij,lj->li", R_cw[s.first_kf],
                               lines_cam[:, :3]) + t_cw[s.first_kf]
    lines_w[:, 3:] = np.einsum("lij,lj->li", R_cw[s.first_kf],
                               lines_cam[:, 3:])
    lines_wide = _two_view_lines(s.first_obs, s.last_obs, s.first_kf,
                                 s.last_kf, R_cw, t_cw, lines_w)
    return cam_wt, lines_w, lines_wide


def init_problem_values(s: GlobalProblemStructure, trajectory: List[Pose],
                        cfg: SlamConfig, dtype=None, device="cuda"):
    """Initial (cam_wt, line_orth), numpy float64, for the given trajectory
    estimate (refine.py:130-154): per line, the better of the stereo
    triangulation at its first keyframe and the wide-baseline two-view
    line of its first and last keyframes.  The triangulation and the
    scoring run in ``dtype`` (default ``cfg.compute_dtype``) on ``device``
    (default the card; ``"cpu"`` only when asked)."""
    dtype = resolve_dtype(cfg.compute_dtype if dtype is None else dtype)
    device = resolve_device(device)
    lines_cam = triangulate_lines_host(
        s.first_obs, cfg.camera.baseline, inverse_depth=cfg.inverse_depth,
        dtype=dtype, device=device)
    cam_wt, lines_w, lines_wide = _init_candidates_host(s, trajectory,
                                                        lines_cam)
    lines_w = _pick_better_lines(lines_w, lines_wide, cam_wt, s.obs,
                                 s.ocam, s.olin, cfg, dtype, device)
    return cam_wt, av_to_orth_np(lines_w)


def build_global_problem(frames: List[Dict[int, np.ndarray]],
                         is_kf: np.ndarray,
                         trajectory: List[Pose],
                         cfg: SlamConfig,
                         min_obs: int = 2, device="cuda"):
    """Pack every keyframe observation into one flat BA problem
    (refine.py:209-224): (cam_wt, line_orth, obs, ocam, olin, feat_ids),
    numpy.  The line init runs in ``cfg.compute_dtype`` on ``device``."""
    K = int(np.sum(np.asarray(is_kf, bool)))
    if K != len(trajectory):
        raise ValueError(f"{K} keyframes but {len(trajectory)} poses")
    s = build_problem_structure(frames, is_kf, min_obs=min_obs)
    cam_wt, line_orth = init_problem_values(s, trajectory, cfg,
                                            device=device)
    return (cam_wt, line_orth, s.obs, s.ocam, s.olin, s.feat_ids)


def _two_view_lines(first_obs, last_obs, first_kf, last_kf, R_cw, t_cw,
                    fallback):
    """Wide-baseline line init: plane-plane intersection across keyframes
    (copy of refine.py:227-280).  Rows where the planes are near-parallel
    take ``fallback``."""
    L = len(first_obs)

    def plane_w(obs8, kf):
        p1 = np.concatenate([obs8[:, 0:2], np.ones((L, 1))], axis=1)
        p2 = np.concatenate([obs8[:, 2:4], np.ones((L, 1))], axis=1)
        n_c = np.cross(p1, p2)                   # plane normal, cam frame
        # world->cam is X_c = R X_w + t with (R, t) = inv(cam->world):
        # n_c . (R X_w + t) = 0  ->  n_w = R^T n_c, d = n_c . t
        R = np.transpose(R_cw[kf], (0, 2, 1))    # world->cam rotation
        t = -np.einsum("lij,lj->li", R, t_cw[kf])
        n_w = np.einsum("lji,lj->li", R, n_c)
        d = np.einsum("li,li->l", n_c, t)
        return n_w, d

    n1, d1 = plane_w(first_obs, first_kf)
    n2, d2 = plane_w(last_obs, last_kf)

    v = np.cross(n1, n2)
    nn = (np.linalg.norm(n1, axis=1) * np.linalg.norm(n2, axis=1))
    sin_ang = np.linalg.norm(v, axis=1) / np.maximum(nn, 1e-30)

    # min-norm point on both planes: x = A^T (A A^T)^-1 (-d)
    A = np.stack([n1, n2], axis=1)               # (L,2,3)
    M = A @ np.transpose(A, (0, 2, 1))           # (L,2,2)
    det = M[:, 0, 0] * M[:, 1, 1] - M[:, 0, 1] * M[:, 1, 0]
    ok = (sin_ang > 1e-3) & (np.abs(det) > 1e-20)
    det_s = np.where(ok, det, 1.0)
    Minv = np.empty_like(M)
    Minv[:, 0, 0] = M[:, 1, 1] / det_s
    Minv[:, 1, 1] = M[:, 0, 0] / det_s
    Minv[:, 0, 1] = -M[:, 0, 1] / det_s
    Minv[:, 1, 0] = -M[:, 1, 0] / det_s
    y = np.einsum("lij,lj->li", Minv, -np.stack([d1, d2], axis=1))
    x = np.einsum("lji,lj->li", A, y)            # point on the line
    vv = np.maximum(np.sum(v * v, axis=1, keepdims=True), 1e-30)
    cp = np.cross(v, np.cross(x, v)) / vv
    ok &= np.isfinite(cp).all(axis=1) & (np.linalg.norm(cp, axis=1) < 1e3)

    out = fallback.copy()
    out[ok, :3] = cp[ok]
    out[ok, 3:] = v[ok]
    return out


def _pick_better_lines(lines_a, lines_b, cam_wt, obs, ocam, olin, cfg,
                       dtype, device):
    """Per line, keep whichever candidate has lower total |residual| over
    that line's observations (refine.py:283-318): both candidates scored
    in one residual-only call over 2O rows, in ``dtype`` on ``device``."""
    L = len(lines_a)
    if L == 0 or len(obs) == 0:
        return lines_a
    orth2 = np.concatenate([av_to_orth_np(lines_a), av_to_orth_np(lines_b)])
    olin2 = np.concatenate([olin, L + olin])

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    r = lba_residual_batch(t(np.concatenate([cam_wt[ocam]] * 2)),
                           t(orth2[olin2]), t(np.concatenate([obs, obs])),
                           cfg.camera.baseline)
    e = np.abs(r.cpu().numpy().astype(np.float64)).sum(axis=1)
    e = np.where(np.isfinite(e), e, 1e6)
    tot = np.zeros(2 * L)
    np.add.at(tot, olin2, e)
    take_b = tot[L:] < tot[:L]
    out = lines_a.copy()
    out[take_b] = lines_b[take_b]
    return out


_DENSE_W_LIMIT = 400_000   # C*L above this -> matrix-free CG Schur solver
_DENSE_CAM_LIMIT = 128     # cameras above this -> CG (the dense reduced
                           # system is (6C)^2 and its Cholesky is (6C)^3)

_BAND_SPAN_FRAC = 0.5      # a track is "long-range" if it spans >= half
_BAND_LONG_FRAC = 0.05     # the keyframes; < 5% long tracks = band map
_BAND_COVER_FRAC = 0.9     # ... and long tracks must be OBSERVED by
                           # nearly every keyframe to pin the map


def detect_band_visibility(frames, is_kf) -> Tuple[bool, float]:
    """Decide whether the map's visibility graph is band-diagonal (copy of
    refine.py:331-379; its docstring gives the measurements behind the
    thresholds).  A band map's global BA has weakly observable bending
    modes that the odometry prior pins; a map whose long tracks are seen
    by nearly every keyframe pins them itself.

    Returns (is_band, fraction_of_long_tracks)."""
    kf_frames = np.flatnonzero(np.asarray(is_kf, bool))
    K = len(kf_frames)
    if K < 3:
        return False, 1.0
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for k, f in enumerate(kf_frames):
        for fid in frames[f]:
            first.setdefault(fid, k)
            last[fid] = k
    spans = np.asarray([last[f] - first[f] for f in first
                        if last[f] > first[f]])
    if len(spans) == 0:
        return False, 1.0
    span_thr = _BAND_SPAN_FRAC * (K - 1)
    frac_long = float(np.mean(spans >= span_thr))
    if frac_long < _BAND_LONG_FRAC:
        return True, frac_long
    long_fids = {fid for fid in first if last[fid] - first[fid] >= span_thr}
    cover = np.zeros(K, bool)
    for k, f in enumerate(kf_frames):
        if any(fid in long_fids for fid in frames[f]):
            cover[k] = True
    return bool(cover.mean() < _BAND_COVER_FRAC), frac_long


def global_refine(frames: List[Dict[int, np.ndarray]],
                  is_kf: np.ndarray,
                  trajectory: List[Pose],
                  config: Optional[SlamConfig] = None,
                  max_iters: int = 25,
                  min_obs: int = 2,
                  rounds: int = 2,
                  method: str = "auto",
                  odometry_prior="auto",
                  prior_edges=None,
                  device="cuda",
                  _prior_c: Optional[np.ndarray] = None) -> RefineResult:
    """Globally bundle-adjust a replayed sequence (refine.py:382-557):
    ``ref = global_refine(frames, res.is_kf, res.trajectory, cfg)``.

    Solves on ``device`` (default the card; ``"cpu"`` runs the kernels'
    plain twins) in ``config.compute_dtype``.  ``rounds`` re-runs the solve
    with lines re-triangulated from the refined poses; round 0 first
    solves the lines alone with every camera fixed.  ``method``: ``"cg"``,
    ``"dense"`` or ``"auto"`` (dense exactly where the JAX package picks it
    on its CPU backend: tensors on the CPU and a small problem).

    ``odometry_prior`` (``"auto"``: on for band-visibility maps,
    ``detect_band_visibility``; or True / False) fuses the odometry chain
    as a weak pose prior, its constraints from ``trajectory`` or from
    ``_prior_c`` (the deferred loop closure passes the replay's odometry
    measurements); ``prior_edges`` (ei, ej, c) adds general pose
    constraints with the same sigmas (``cfg.refine_prior_sigma_rot/t``).
    Both run on the CG path (refine.py:405-462)."""
    cfg = config or SlamConfig()
    dev = resolve_device(device)
    dtype = resolve_dtype(cfg.compute_dtype)
    if method not in ("auto", "cg", "dense"):
        raise ValueError(f"unknown refine method {method!r}")
    if odometry_prior == "auto":
        odometry_prior, _ = detect_band_visibility(frames, is_kf)
    if not odometry_prior:
        # the gate governs an explicitly passed _prior_c too (refine.py:
        # 420-428): it supplies the constraint values, not whether the
        # prior applies
        _prior_c = None
    elif _prior_c is None and len(trajectory) > 1:
        _prior_c = np.stack([
            (trajectory[i + 1].inv() @ trajectory[i]).wt()
            for i in range(len(trajectory) - 1)])

    s = build_problem_structure(frames, is_kf, min_obs=min_obs)
    K = len(trajectory)
    L, O = len(s.feat_ids), len(s.obs)
    if L == 0 or O == 0:
        # degenerate sequence: nothing observed twice — return the input
        return RefineResult(
            trajectory=list(trajectory), lines_world=np.zeros((0, 6)),
            feature_ids=[], initial_cost=0.0, final_cost=0.0, iterations=0,
            num_cams=K, num_lines=0, num_obs=0)
    priors = _prior_c is not None or prior_edges is not None
    if priors and method == "dense":
        # the priors live on the CG path only: never drop them silently
        warnings.warn("global_refine: pose priors require the CG solver; "
                      "overriding method='dense' -> 'cg'")
        method = "cg"
    if method == "auto":
        small = K * L <= _DENSE_W_LIMIT and K <= _DENSE_CAM_LIMIT
        method = ("dense" if small and dev.type == "cpu" and not priors
                  else "cg")

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=dev)

    cam_free = np.ones(K, bool)
    cam_free[0] = False                      # gauge: world = KF0 camera
    bl, hd = cfg.camera.baseline, cfg.huber_delta

    # Solver closure over the (round-invariant) packed layout.
    if method == "cg":
        p = pack_line_major(s.obs, s.ocam, s.olin, K, L)
        obs_t, ocam_t = t(p.obs), t(p.obs_cam, torch.int32)
        ovalid_t = t(p.obs_valid, torch.bool)
        lfree_t = torch.ones(L, dtype=torch.bool, device=dev)
        prior = None if _prior_c is None else t(_prior_c)
        pedges = None
        if prior_edges is not None:
            ei, ej, ec = prior_edges
            pedges = (t(ei, torch.int64), t(ej, torch.int64), t(ec))

        def solve(cam_in, line_in, cfree, iters):
            return global_ba_cg(
                t(cam_in), t(line_in), obs_t, ocam_t, ovalid_t,
                t(cfree, torch.bool), lfree_t, bl, hd, robust=cfg.robust,
                max_iters=iters, line_param=cfg.line_param, prior_c=prior,
                prior_sigma_rot=cfg.refine_prior_sigma_rot,
                prior_sigma_t=cfg.refine_prior_sigma_t, prior_edges=pedges)
    else:
        # the dense path pads the lines to their capacity bucket as the JAX
        # package does: the padded rows enter LM's step-size test (the
        # parameter norm), so the iteration counts follow JAX's only with
        # them.  The JAX path's row padding only spares XLA a recompile.
        Lb = bucket_for(L, cfg.line_buckets)
        obs_t = t(s.obs)
        ocam_t, olin_t = t(s.ocam, torch.int32), t(s.olin, torch.int32)
        ovalid_t = torch.ones(O, dtype=torch.bool, device=dev)
        lfree_t = torch.arange(Lb, device=dev) < L

        def solve(cam_in, line_in, cfree, iters):
            lorth_p = np.zeros((Lb, 4))
            lorth_p[:, 3] = 0.5
            lorth_p[:L] = line_in
            return local_ba(
                t(cam_in), t(lorth_p), obs_t, ocam_t, olin_t, ovalid_t,
                t(cfree, torch.bool), lfree_t, bl, hd, robust=cfg.robust,
                max_iters=iters, line_param=cfg.line_param)

    def host(x):
        return x.cpu().numpy().astype(np.float64)

    # Rounds (refine.py:523-550): each re-inits lines from the current
    # trajectory; round 0 first stages a lines-only solve (cameras fixed)
    # that lands the lines in their basin before the poses move.
    initial_cost = None
    iterations = 0
    traj = list(trajectory)
    for r in range(rounds):
        cam_wt, line_orth = init_problem_values(s, traj, cfg, dtype, dev)
        if r == 0:
            _, line_orth, _ = solve(cam_wt, line_orth, np.zeros(K, bool),
                                    max_iters)
            line_orth = host(line_orth)[:L]
        cam_out, line_out, stats = solve(cam_wt, line_orth, cam_free,
                                         max_iters)
        cam_out, line_out = host(cam_out), host(line_out)[:L]
        traj = [Pose.from_wt(w).inv() for w in cam_out]
        if initial_cost is None:
            initial_cost = float(stats.initial_cost)
        iterations += int(stats.iterations)

    return RefineResult(
        trajectory=traj, lines_world=orth_to_av_np(line_out),
        feature_ids=s.feat_ids, initial_cost=initial_cost,
        final_cost=float(stats.final_cost), iterations=iterations,
        num_cams=K, num_lines=L, num_obs=O)
