"""Loop closure as a post-pass over the batch replay: deferred batch LC.

Port of ``slslam_tpu/engine/batch_lc.py`` (see its docstring for the design
and the reference lines it follows).  ``BatchSlamLC.run`` replays the
sequence (``engine/batch.py``), then runs the post-pass over the replay's
``BatchResult``:

  1. **recognition** — the voctree place recognizer over the keyframes'
     descriptors (``loopclosure/``);
  2. **span solves** — raw detections grouped into revisit spans; each
     span's best representative is solved (triangulation, the fused VO
     with K2 ``cams`` in its polish, a joint 2-camera refit with K2
     ``full``, per-pair scoring), up to three rounds of fallbacks;
  3. **joint confirms** — per span, group line fits (K2 ``full``), a
     RANSAC line-cloud alignment on the host, and joint multi-keyframe
     polishes with in-group odometry priors (``local_ba`` ``prior_edges``),
     racing an odometry-null lane;
  4. **pose-graph stitch** — the odometry chain plus the loop edges through
     ``ops/pose_graph.py`` (K1 block sums), gated by the consistency check;
  5. optionally the **merged global refine** (K2 ``lm``, K1) with the loop
     edges as pose priors and the odometry prior where the band-visibility
     gate applies it, plus the counterfactual odometry-init refine for
     contested closures.

``post_pass`` runs stages 1-5 on any ``BatchResult`` (the tests feed it the
JAX replay's).  Where JAX vmaps the span solves, group fits and joint
polishes over lanes padded to a power of two, this port solves the
lanes one after another with no padding lane; each lane keeps JAX's row,
camera and line padding, which enters LM's step-size test.  Each span's
RANSAC noise comes from ``gumbel_hook(kf_index, H, N)`` where given (the
tests feed ``jax.random.gumbel(fold_in(PRNGKey(rseed ^ 0x10C), kf_index),
(H, N))``), else from a ``torch.Generator`` seeded from (rseed ^ 0x10C,
kf_index).  The host stages (span grouping, track merging, the joint
problem packing, the line-cloud alignment, the consistency check) are
numpy copies of the JAX module's.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import geometry as geo
from .. import resolve_device, resolve_dtype
from ..config import SlamConfig, bucket_for
from ..hostgeom import Pose, av_to_orth_np, orth_to_av_np
from ..ops.pose_graph import pose_graph_opt
from ..ops.residuals import lba_residual_batch
from ..ops.schur_ba import local_ba
from ..ops.triangulate import triangulate_lines, triangulate_lines_host
from ..ops.vo_pipeline import vo_body
from .batch import BatchResult, BatchSlam, normalize_frames


@dataclasses.dataclass
class LoopEvent:
    old_kf: int               # keyframe index recognized
    new_kf: int               # current keyframe index
    n_matches: int            # descriptor matches offered
    ransac_score: int         # RANSAC inliers of the relative-pose solve
    wt_rel: Optional[np.ndarray]   # (6,) T_new * T_old^-1, None if rejected
    accepted: bool            # True only for edges actually fed to PGO
    deduped: bool = False     # True: span-mate of an edge, never solved
    joint: bool = False       # True: from a joint multi-keyframe confirm


@dataclasses.dataclass
class BatchLCResult:
    base: BatchResult                 # odometry-only replay result
    trajectory: List[Pose]            # stitched camera-to-world trajectory
    events: List[LoopEvent]
    merged_fids: Dict[int, int]       # feature id -> merged root id
    stats: Dict[str, float]
    refined: Optional[object] = None  # engine.refine.RefineResult


SpanNoiseFn = Callable[[int, int, int], torch.Tensor]

_POLISH_LM_ITERS = 30      # joint-polish LM cap (batch_lc.py:167)
_SCORE_ROWS_CAP = 64       # rows per span scored when picking the RANSAC
                           # alignment candidate (batch_lc.py:168)
_SPAN_SEED = 0x10C         # the span solves' noise stream: rseed ^ this


def _to_host(x):
    return x.detach().cpu().numpy().astype(np.float64)


def _abs_max_residual(cw, lo, ob, cfg: SlamConfig, dtype, dev):
    """Per-row max |residual| of (n,6) cameras, (n,4) orth lines, (n,8)
    observations, on the device; non-finite rows -> inf (the scoring
    passes of batch_lc.py:199-203, 753-758, 909-914, unpadded)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    r = lba_residual_batch(t(cw), t(lo), t(ob), cfg.camera.baseline)
    err = np.abs(_to_host(r)).max(axis=1)
    return np.where(np.isfinite(err), err, np.inf)


def _merged_inlier_frac(ref, frames_m, is_kf, merged, cfg: SlamConfig,
                        dtype, dev):
    """(fraction, fraction at half the threshold) of merged-track
    observations within the inlier threshold under a refine result
    (batch_lc.py:173-212)."""
    from .refine import build_problem_structure

    roots = set(merged.values())
    if not roots:
        return 1.0
    s = build_problem_structure(frames_m, is_kf)
    lid = {f: i for i, f in enumerate(ref.feature_ids)}
    sel = np.asarray([o for o in range(len(s.olin))
                      if s.feat_ids[s.olin[o]] in roots
                      and s.feat_ids[s.olin[o]] in lid], np.int64)
    if len(sel) == 0:
        return 1.0
    cam_wt = np.stack([T.inv().wt() for T in ref.trajectory])
    orth = av_to_orth_np(ref.lines_world)
    rows_l = np.asarray([lid[s.feat_ids[s.olin[o]]] for o in sel])
    err = _abs_max_residual(cam_wt[s.ocam[sel]], orth[rows_l], s.obs[sel],
                            cfg, dtype, dev)
    return (float(np.mean(err < cfg.error_thr)),
            float(np.mean(err < 0.5 * cfg.error_thr)))


def _span_solve(o0, o1, valid, gumbel, generator, cfg: SlamConfig,
                refit_iters=25):
    """ONE span representative's relative-pose solve (batch_lc.py:77-130):
    lines triangulated in the old keyframe, the fused VO, a joint 2-camera
    free-line BA over every offered pair (cam 0 = old keyframe, the gauge),
    and each pair's max residual over both views under the refit.  Returns
    (ransac_score, wt_vo, wt_polished, pair_err) as tensors."""
    N = o0.shape[0]
    dtype, dev = o0.dtype, o0.device
    baseline = cfg.camera.baseline
    lines = triangulate_lines(o0, baseline, inverse_depth=cfg.inverse_depth)
    res = vo_body(o0, o1, lines, valid, baseline, cfg.error_thr,
                  cfg.huber_delta, max_t_norm=cfg.lc_defer_max_t_norm,
                  num_hyp=cfg.ransac_num_hypotheses,
                  sample_size=cfg.ransac_min_sample, robust=cfg.robust,
                  max_iters=cfg.moba_max_iter, line_param=cfg.line_param,
                  relin_iters=cfg.vo_relin_iters, gumbel=gumbel,
                  generator=generator)

    cam2 = torch.stack([torch.zeros(6, dtype=dtype, device=dev), res.wt])
    orth = geo.av_to_orth(lines)
    obs2 = torch.cat([o0, o1])
    oc2 = torch.cat([torch.zeros(N, dtype=torch.int32, device=dev),
                     torch.ones(N, dtype=torch.int32, device=dev)])
    ar = torch.arange(N, dtype=torch.int32, device=dev)
    ol2 = torch.cat([ar, ar])
    ov2 = torch.cat([valid, valid])
    cfree = torch.tensor([False, True], device=dev)
    cam_out, line_out, _ = local_ba(
        cam2, orth, obs2, oc2, ol2, ov2, cfree, valid, baseline,
        cfg.huber_delta, robust=cfg.robust, max_iters=refit_iters)

    r = lba_residual_batch(cam_out[oc2.long()], line_out[ol2.long()], obs2,
                           baseline)
    err2 = torch.abs(r).amax(dim=1)
    pair_err = torch.maximum(err2[:N], err2[N:])
    return res.ransac_score, res.wt, cam_out[1], pair_err


def _span_noise(cfg: SlamConfig, kf_index, H, N, dev,
                gumbel_hook: Optional[SpanNoiseFn]):
    """(gumbel, generator) for the span solve of keyframe ``kf_index``: the
    hook's (H, N) noise, or a generator seeded from (rseed ^ 0x10C,
    kf_index)."""
    if gumbel_hook is not None:
        return gumbel_hook(int(kf_index), H, N), None
    gen = torch.Generator(device=dev)
    gen.manual_seed(((cfg.rseed ^ _SPAN_SEED) << 32) + int(kf_index))
    return None, gen


def _solve_span_round(cands, frames, kf_idx, cfg: SlamConfig, dtype, dev,
                      gumbel_hook: Optional[SpanNoiseFn] = None):
    """Solve one round of span representatives [(k, old_k, match), ...]
    (batch_lc.py:215-301): per candidate (wt | None, score, n_offered,
    inl_pairs) with the same gating.  The solves run one after another,
    each padded to the round's correspondence bucket."""
    per = []
    solve_rows = []
    for (k, old_k, match) in cands:
        obs_new = frames[kf_idx[k]]
        obs_old = frames[kf_idx[old_k]]
        pairs = [(nf, of) for nf, of in match.items()
                 if nf in obs_new and of in obs_old]
        per.append({"pairs": pairs, "n": len(pairs)})
        if len(pairs) >= cfg.ransac_min_sample:
            solve_rows.append((len(per) - 1, k, old_k, pairs))

    results = [(None, 0, p["n"], {}) for p in per]
    if not solve_rows:
        return results

    N = bucket_for(max(len(r[3]) for r in solve_rows), cfg.corr_buckets)
    H = cfg.ransac_num_hypotheses
    for (ci, k, old_k, pairs) in solve_rows:
        obs_new = frames[kf_idx[k]]
        obs_old = frames[kf_idx[old_k]]
        o0 = np.zeros((N, 8))
        o1 = np.zeros((N, 8))
        valid = np.zeros(N, bool)
        for i, (nf, of) in enumerate(pairs):
            o0[i] = obs_old[of]
            o1[i] = obs_new[nf]
            valid[i] = True
        gumbel, gen = _span_noise(cfg, kf_idx[k], H, N, dev, gumbel_hook)
        score_d, wt_vo_d, wt_pol_d, pair_err_d = _span_solve(
            torch.as_tensor(o0, dtype=dtype, device=dev),
            torch.as_tensor(o1, dtype=dtype, device=dev),
            torch.as_tensor(valid, device=dev), gumbel, gen, cfg)
        n = len(pairs)
        score = int(score_d)
        wt = _to_host(wt_vo_d)
        # plausibility: the RANSAC must find SOME support and a finite
        # model (slam.cpp:295-298's absolute floor); the decisive gate
        # runs on the joint refit below
        if score < cfg.ransac_min_sample or not np.all(np.isfinite(wt)):
            results[ci] = (None, int(max(score, 0)), n, {})
            continue
        wt_polished = _to_host(wt_pol_d)
        if np.all(np.isfinite(wt_polished)):
            wt = wt_polished
        final_inl = (_to_host(pair_err_d) < cfg.error_thr) & valid
        n_final = int(np.sum(final_inl))
        min_score = max(cfg.lc_min_inliers,
                        int(np.ceil(cfg.lc_min_inlier_ratio * n)))
        if n_final < min_score:
            results[ci] = (None, n_final, n, {})
            continue
        # geometrically verified pairs only feed the merge
        inl_pairs = {nf: of for (nf, of), good in zip(pairs, final_inl[:n])
                     if good}
        results[ci] = (wt, n_final, n, inl_pairs)
    return results


class _JointPrep:
    """Host-packed joint multi-keyframe problem for one span (copy of
    batch_lc.py:304-361)."""

    def __init__(self, span, frames, kf_idx, traj, cfg: SlamConfig):
        self.span = span
        self.old_ks = sorted({c[1] for c in span})
        self.new_ks = sorted({c[0] for c in span})
        self.cams = self.old_ks + self.new_ks
        self.cam_of = {g: i for i, g in enumerate(self.cams)}
        self.gauge = traj[self.old_ks[0]]
        # pose of camera g (world->cam) in the gauge frame
        self.cam_wt = np.stack([(traj[g].inv() @ self.gauge).wt()
                                for g in self.cams])
        self.Qg = {g: traj[g].inv() @ traj[self.new_ks[0]]
                   for g in self.new_ks}
        self.M_odo = traj[self.new_ks[0]].inv() @ traj[self.old_ks[0]]

        line_ids: List[int] = []
        line_of: Dict[int, int] = {}
        line_first: Dict[int, Tuple[int, np.ndarray]] = {}
        rows, ocam, olin = [], [], []
        pair_rows: Dict[Tuple[int, int], List[int]] = {}
        row_of: Dict[Tuple[int, int, int], int] = {}
        for (k, old_k, match) in span:
            fr_new, fr_old = frames[kf_idx[k]], frames[kf_idx[old_k]]
            for nf, of in match.items():
                if nf not in fr_new or of not in fr_old:
                    continue
                li = line_of.get(of)
                if li is None:
                    li = line_of[of] = len(line_ids)
                    line_ids.append(of)
                    line_first[of] = (old_k, fr_old[of])
                for g, fid, o8 in ((old_k, of, fr_old[of]),
                                   (k, nf, fr_new[nf])):
                    key = (g, fid, li)
                    ri = row_of.get(key)
                    if ri is None:
                        ri = row_of[key] = len(rows)
                        rows.append(o8)
                        ocam.append(self.cam_of[g])
                        olin.append(li)
                    pair_rows.setdefault((nf, of), []).append(ri)
        self.line_ids = line_ids
        self.line_of = line_of
        self.line_first = line_first
        self.rows = np.asarray(rows).reshape(-1, 8)
        self.ocam = np.asarray(ocam, np.int32)
        self.olin = np.asarray(olin, np.int32)
        self.pair_rows = pair_rows
        self.n = len(pair_rows)
        self.C = len(self.cams)
        self.L = len(line_ids)
        self.min_score = max(cfg.lc_min_inliers,
                             int(np.ceil(cfg.lc_min_inlier_ratio
                                         * max(self.n, 1))))


@dataclasses.dataclass
class _LaneResult:
    init_name: str            # "edge" | "aligned" | "odometry"
    old_rep: int
    k_rep: int
    wt: np.ndarray            # (6,) joint-estimate loop edge
    inl_pairs: Dict[int, int]
    n_final: int
    n: int
    vote_ok: bool


def _fit_group_problems(preps, traj, cfg: SlamConfig, dtype, dev,
                        timing=None):
    """Stage 1 for every confirmable span: both groups' multi-view line
    fits, cameras fixed at the in-group odometry (batch_lc.py:436-559).
    One lines-only ``local_ba`` (K2 ``full``) per group, each padded to the
    batch's camera, line and row buckets as JAX's vmapped lanes are.
    Returns {prep_idx: (lines_A, cntA, lines_B, cntB)}, lines in each
    group's local frame."""
    t_sub = time.perf_counter()
    jobs = []   # (prep_idx, side, grp, cw, rws, oc, ol)
    for pi, prep in preps:
        for side in ("old", "new"):
            grp = prep.old_ks if side == "old" else prep.new_ks
            gidx = {g: i for i, g in enumerate(grp)}
            loc = traj[grp[0]]
            cw = np.stack([(traj[g].inv() @ loc).wt() for g in grp])
            # this side's rows, deduped per (camera, line)
            side_rows = []
            seen_go = set()
            for ri in range(len(prep.rows)):
                if (prep.ocam[ri] >= len(prep.old_ks)) != (side == "new"):
                    continue
                key = (int(prep.ocam[ri]), int(prep.olin[ri]))
                if key in seen_go:
                    continue
                seen_go.add(key)
                side_rows.append(ri)
            rws = prep.rows[side_rows]
            oc_l = np.asarray([gidx[prep.cams[prep.ocam[ri]]]
                               for ri in side_rows], np.int32)
            ol_l = prep.olin[side_rows]
            jobs.append((pi, side, grp, cw, rws, oc_l, ol_l))

    if not jobs:
        return {}
    if timing is not None:
        timing["group_fits_rows"] = round(time.perf_counter() - t_sub, 3)
        t_sub = time.perf_counter()

    Gb = bucket_for(max(len(j[2]) for j in jobs), cfg.cam_buckets)
    Lb = bucket_for(max(p.L for _, p in preps), cfg.line_buckets)
    Ob = bucket_for(max(len(j[4]) for j in jobs), cfg.obs_buckets)

    tri_cat = triangulate_lines_host(
        np.concatenate([j[4] for j in jobs]), cfg.camera.baseline,
        inverse_depth=cfg.inverse_depth, dtype=dtype, device=dev)
    if timing is not None:
        timing["group_fits_tri"] = round(time.perf_counter() - t_sub, 3)
        t_sub = time.perf_counter()

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=dev)

    out = {}
    pos = 0
    t_pack = t_solve = 0.0
    for pi, side, grp, cw, rws, oc_l, ol_l in jobs:
        t0 = time.perf_counter()
        nr = len(rws)
        tri = tri_cat[pos:pos + nr]
        pos += nr
        cam_b = np.zeros((Gb, 6))
        cam_b[:len(grp)] = cw
        obs_b = np.zeros((Ob, 8))
        oc_b = np.zeros(Ob, np.int32)
        ol_b = np.zeros(Ob, np.int32)
        ov_b = np.zeros(Ob, bool)
        obs_b[:nr] = rws
        oc_b[:nr] = oc_l
        ol_b[:nr] = ol_l
        ov_b[:nr] = True
        cnt = np.bincount(ol_l, minlength=Lb)
        init = np.zeros((Lb, 6))
        init[:, 5] = 1.0
        seenl = set()
        for i in range(nr):
            li = int(ol_l[i])
            if li in seenl:
                continue
            seenl.add(li)
            P = Pose.from_wt(cw[oc_l[i]]).inv()
            init[li, :3] = P.R @ tri[i, :3] + P.t
            init[li, 3:] = P.R @ tri[i, 3:]
        t1 = time.perf_counter()
        _, line_out, _ = local_ba(
            t(cam_b), t(av_to_orth_np(init)), t(obs_b), t(oc_b, torch.int32),
            t(ol_b, torch.int32), t(ov_b, torch.bool),
            torch.zeros(Gb, dtype=torch.bool, device=dev),
            t(cnt > 0, torch.bool), cfg.camera.baseline, cfg.huber_delta,
            robust=True, max_iters=max(cfg.max_num_iter, 25),
            line_param=cfg.line_param)
        lines = orth_to_av_np(_to_host(line_out))
        t_pack += t1 - t0
        t_solve += time.perf_counter() - t1
        cur = out.setdefault(pi, [None, None, None, None])
        if side == "old":
            cur[0], cur[1] = lines, cnt
        else:
            cur[2], cur[3] = lines, cnt
    if timing is not None:
        timing["group_fits_pack"] = round(t_pack, 3)
        timing["group_fits_solve"] = round(t_solve, 3)
    return {pi: tuple(v) for pi, v in out.items()}


def _ransac_align(prep: "_JointPrep", linesA, cntA, linesB, cntB,
                  cfg: SlamConfig):
    """Stage 2: RANSAC line-cloud alignment X_B = S(X_A) (copy of
    batch_lc.py:562-641).  Returns the candidate list, the odometry-implied
    alignment appended as the fallback, or None."""
    M_odo = prep.M_odo
    nzA = np.linalg.norm(linesA[:, 3:], axis=1)
    nzB = np.linalg.norm(linesB[:, 3:], axis=1)
    usable = (cntA > 0) & (cntB > 0) & (nzA > 1e-9) & (nzB > 1e-9)
    vA = linesA[:, 3:] / np.maximum(nzA, 1e-30)[:, None]
    vB = linesB[:, 3:] / np.maximum(nzB, 1e-30)[:, None]
    aA, aB = linesA[:, :3], linesB[:, :3]

    def fit_S_batch(idxs, w=None):
        """(J, k) sample index sets -> (J, 3, 3) R, (J, 3) t, (J,) ok."""
        J, k = idxs.shape
        if w is None:
            w = np.ones((J, k))
        vAi, vBi = vA[idxs], vB[idxs]            # (J, k, 3)
        aAi, aBi = aA[idxs], aB[idxs]
        R = np.broadcast_to(M_odo.R, (J, 3, 3)).copy()
        t = np.broadcast_to(M_odo.t, (J, 3)).copy()
        P = (np.eye(3)[None, None]
             - vBi[..., :, None] * vBi[..., None, :])   # (J, k, 3, 3)
        A_t = np.einsum("jn,jnab->jab", w, P)
        for _ in range(2):
            s = np.sign(np.einsum("jab,jnb,jna->jn", R, vAi, vBi))
            s[s == 0] = 1.0
            Mw = np.einsum("jn,jna,jnb->jab", w * s, vBi, vAi)
            try:
                U, _, Vt = np.linalg.svd(Mw)
            except np.linalg.LinAlgError:
                # a batched SVD aborts wholesale if ONE 3x3 fails to
                # converge; jitter the candidates negligibly
                Mw = Mw + 1e-12 * np.random.default_rng(0).standard_normal(
                    Mw.shape)
                U, _, Vt = np.linalg.svd(Mw)
            det = np.linalg.det(np.einsum("jab,jbc->jac", U, Vt))
            D = np.zeros((J, 3, 3))
            D[:, 0, 0] = D[:, 1, 1] = 1.0
            D[:, 2, 2] = det
            R = np.einsum("jab,jbc,jcd->jad", U, D, Vt)
            b_t = np.einsum("jn,jnab,jnb->ja", w, P,
                            aBi - np.einsum("jab,jnb->jna", R, aAi))
            ok_t = np.abs(np.linalg.det(A_t)) > 1e-12
            A_s = np.where(ok_t[:, None, None], A_t, np.eye(3)[None])
            t = np.linalg.solve(A_s, b_t[..., None])[..., 0]
        ok = (np.isfinite(R).all(axis=(1, 2)) & np.isfinite(t).all(axis=1)
              & ok_t)
        return R, t, ok

    strong = np.flatnonzero(usable & (cntA >= 2) & (cntB >= 2))
    pool = strong if len(strong) >= 3 else np.flatnonzero(usable)
    if len(pool) < 3:
        return None
    rng = np.random.default_rng(cfg.rseed ^ (0x5A11 + prep.new_ks[0]))
    samples = np.stack([rng.choice(pool, 3, replace=False)
                        for _ in range(256)])
    R_b, t_b, ok_b = fit_S_batch(samples)
    cands_S = [Pose(R_b[j], t_b[j]) for j in np.flatnonzero(ok_b)]
    Rp, tp, okp = fit_S_batch(pool[None, :])
    if okp[0]:
        cands_S.append(Pose(Rp[0], tp[0]))
    cands_S.append(M_odo)            # odometry-implied as the fallback
    return cands_S


def _joint_confirm_jobs(jobs, frames, kf_idx, traj, cfg: SlamConfig,
                        dtype, dev, drift_ok):
    """Confirm-or-drop for a batch of spans (batch_lc.py:644-960): group
    fits and the RANSAC alignment for every confirmable span, then per span
    the lanes "edge" (from the verified 2-view edge), "aligned" (from the
    best alignment) and "odometry" (the null hypothesis), each a joint
    polish with strong in-group odometry priors (``local_ba`` with
    ``prior_edges``, K2 ``full``), solved one after another.  Returns
    (a list parallel to jobs of None or (lanes, winner-or-None), the stage
    timings)."""
    timing = {}
    t_stage = time.perf_counter()

    def _mark(key):
        nonlocal t_stage
        timing[key] = round(time.perf_counter() - t_stage, 3)
        t_stage = time.perf_counter()

    n_jobs = len(jobs)
    min_attempt = max(cfg.lc_min_inliers, cfg.ransac_min_sample)
    preps: List[Optional[_JointPrep]] = []
    for (span, _) in jobs:
        p = _JointPrep(span, frames, kf_idx, traj, cfg)
        preps.append(p if p.n >= min_attempt else None)
    _mark("prep")

    # ---- stages 1-2 for every confirmable span ----
    rescue = [(i, preps[i]) for i in range(n_jobs)
              if preps[i] is not None]
    fits = _fit_group_problems(rescue, traj, cfg, dtype, dev, timing=timing)
    _mark("group_fits")
    cand_lists = {}
    score_parts = []            # (job_i, J, Rn, cw, lo, ob)
    for i, prep in rescue:
        f = fits.get(i)
        if f is None or f[0] is None or f[2] is None:
            continue
        linesA, cntA, linesB, cntB = f
        cands_S = _ransac_align(prep, linesA, cntA, linesB, cntB, cfg)
        if cands_S is None:
            continue
        new_rows = [ri for ri in range(len(prep.rows))
                    if prep.ocam[ri] >= len(prep.old_ks)]
        Rn = len(new_rows)
        J = len(cands_S)
        if Rn > _SCORE_ROWS_CAP:
            sel = np.linspace(0, Rn - 1, _SCORE_ROWS_CAP).astype(int)
            new_rows = [new_rows[k] for k in sel]
            Rn = len(new_rows)
        cam_wts = {}
        for g in prep.new_ks:
            Qgg = prep.Qg[g]
            cam_wts[prep.cam_of[g]] = np.stack(
                [(Qgg @ Sc).wt() for Sc in cands_S])        # (J, 6)
        cw_all = np.stack([cam_wts[int(prep.ocam[ri])]
                           for ri in new_rows], axis=1)     # (J, Rn, 6)
        la = av_to_orth_np(linesA)[prep.olin[new_rows]]
        score_parts.append((i, J, Rn, cw_all.reshape(-1, 6),
                            np.tile(la, (J, 1)),
                            np.tile(prep.rows[new_rows], (J, 1))))
        cand_lists[i] = cands_S
    S_best = {}
    if score_parts:
        # one scoring call for every span's candidates: image-space
        # inliers of the new-side observations against the old cloud
        err_f = _abs_max_residual(
            np.concatenate([p[3] for p in score_parts]),
            np.concatenate([p[4] for p in score_parts]),
            np.concatenate([p[5] for p in score_parts]), cfg, dtype, dev)
        pos = 0
        for (i, J, Rn, _, _, _) in score_parts:
            e = err_f[pos:pos + J * Rn].reshape(J, Rn)
            pos += J * Rn
            S_best[i] = cand_lists[i][int(np.argmax(
                (e < cfg.error_thr).sum(axis=1)))]
    _mark("ransac_align")

    # ---- stage 3: the joint polish of every lane ----
    lanes = []                  # (job_i, name, S alignment in gauge frame)
    for i, (span, init_edge) in enumerate(jobs):
        prep = preps[i]
        if prep is None:
            continue
        if init_edge is not None:
            e_old, e_new, e_wt = init_edge
            lanes.append((i, "edge",
                          prep.Qg[e_new].inv()
                          @ Pose.from_wt(np.asarray(e_wt))
                          @ (traj[e_old].inv() @ prep.gauge)))
        if i in S_best:
            lanes.append((i, "aligned", S_best[i]))
        lanes.append((i, "odometry", prep.M_odo))
    if not lanes:
        return [None] * n_jobs, timing

    act = sorted({i for i, _, _ in lanes})
    ap = [preps[i] for i in act]
    Cb = bucket_for(max(p.C for p in ap), cfg.cam_buckets)
    Lb = bucket_for(max(p.L for p in ap), cfg.line_buckets)
    rnd8 = lambda n: max(8, -(-n // 8) * 8)
    # camera-major blocked layout: OmC rows per camera slot
    OmC = rnd8(max(int(np.bincount(p.ocam).max()) for p in ap))
    Eb = rnd8(max((len(p.old_ks) - 1) + (len(p.new_ks) - 1) for p in ap))

    # per-job layout, priors and line inits (shared by the job's lanes)
    packs, priors, line_inits, cfree_j, lfree_j = {}, {}, {}, {}, {}
    tri_jobs = [(i, np.stack([preps[i].line_first[of][1]
                              for of in preps[i].line_ids])) for i in act]
    tri_cat = triangulate_lines_host(
        np.concatenate([t for _, t in tri_jobs]), cfg.camera.baseline,
        inverse_depth=cfg.inverse_depth, dtype=dtype, device=dev)
    pos = 0
    for i, first_obs in tri_jobs:
        prep = preps[i]
        ob_f = np.zeros((Cb * OmC, 8))
        ol_f = np.zeros(Cb * OmC, np.int32)
        ov_f = np.zeros(Cb * OmC, bool)
        fill = np.zeros(Cb, np.int32)
        for ri in range(len(prep.rows)):
            c = int(prep.ocam[ri])
            k = c * OmC + fill[c]
            fill[c] += 1
            ob_f[k] = prep.rows[ri]
            ol_f[k] = prep.olin[ri]
            ov_f[k] = True
        packs[i] = (ob_f, ol_f, ov_f)
        ei, ej, ec, esig = [], [], [], []
        for grp in (prep.old_ks, prep.new_ks):
            for a, b in zip(grp, grp[1:]):
                ei.append(prep.cam_of[a])
                ej.append(prep.cam_of[b])
                ec.append((traj[b].inv() @ traj[a]).wt())
                esig.append((0.01, 0.05))   # strong in-group odometry
        while len(ei) < Eb:
            ei.append(0)
            ej.append(0)
            ec.append(np.zeros(6))
            esig.append((1e9, 1e9))         # zero-weight padding
        priors[i] = (np.asarray(ei, np.int32), np.asarray(ej, np.int32),
                     np.stack(ec), np.asarray(esig))
        tri = tri_cat[pos:pos + prep.L]
        pos += prep.L
        lines_g = np.zeros((Lb, 6))
        lines_g[:, 5] = 1.0
        first_cam = [prep.cam_of[prep.line_first[of][0]]
                     for of in prep.line_ids]
        for li in range(prep.L):
            P = Pose.from_wt(prep.cam_wt[first_cam[li]]).inv()
            lines_g[li, :3] = P.R @ tri[li, :3] + P.t
            lines_g[li, 3:] = P.R @ tri[li, 3:]
        line_inits[i] = av_to_orth_np(lines_g)
        cf = np.zeros(Cb, bool)
        cf[1:prep.C] = True
        cfree_j[i] = cf
        lf = np.zeros(Lb, bool)
        lf[:prep.L] = True
        lfree_j[i] = lf

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    ocam_f = t(np.repeat(np.arange(Cb, dtype=np.int32), OmC), torch.int32)
    cam_out, line_out = [], []
    for (i, name, S) in lanes:
        prep = preps[i]
        cam_init = np.zeros((Cb, 6))
        cam_init[:prep.C] = prep.cam_wt
        for g in prep.new_ks:
            cam_init[prep.cam_of[g]] = (prep.Qg[g] @ S).wt()
        ob_f, ol_f, ov_f = packs[i]
        ei, ej, ec, esig = priors[i]
        c_out, l_out, _ = local_ba(
            t(cam_init), t(line_inits[i]), t(ob_f), ocam_f,
            t(ol_f, torch.int32), t(ov_f, torch.bool),
            t(cfree_j[i], torch.bool), t(lfree_j[i], torch.bool),
            cfg.camera.baseline, cfg.huber_delta, robust=cfg.robust,
            max_iters=_POLISH_LM_ITERS, line_param=cfg.line_param,
            prior_edges=(t(ei, torch.int64), t(ej, torch.int64), t(ec),
                         t(esig)))
        cam_out.append(_to_host(c_out))
        line_out.append(_to_host(l_out))
    _mark("joint_polish")

    # ---- stage 4: one verification over every lane's rows ----
    ver = [(cam_out[s][preps[i].ocam], line_out[s][preps[i].olin],
            preps[i].rows) for s, (i, _, _) in enumerate(lanes)]
    err_f = _abs_max_residual(np.concatenate([p[0] for p in ver]),
                              np.concatenate([p[1] for p in ver]),
                              np.concatenate([p[2] for p in ver]),
                              cfg, dtype, dev)

    job_lanes: Dict[int, List[_LaneResult]] = {}
    pos = 0
    for s, (i, name, S) in enumerate(lanes):
        prep = preps[i]
        err = err_f[pos:pos + len(prep.rows)]
        pos += len(prep.rows)
        if not np.all(np.isfinite(cam_out[s][:prep.C])):
            continue
        inl_pairs = {}
        n_final = 0
        for (nf, of), idxs in prep.pair_rows.items():
            if err[idxs].max() < cfg.error_thr:
                n_final += 1
                inl_pairs[nf] = of
        k_rep, old_rep, _ = max(prep.span, key=lambda c: len(c[2]))
        wt = (Pose.from_wt(cam_out[s][prep.cam_of[k_rep]])
              @ Pose.from_wt(cam_out[s][prep.cam_of[old_rep]]).inv()).wt()
        job_lanes.setdefault(i, []).append(_LaneResult(
            name, old_rep, k_rep, wt, inl_pairs, n_final, prep.n,
            n_final >= prep.min_score))

    out = []
    for i in range(n_jobs):
        lr = job_lanes.get(i)
        if not lr:
            out.append(None)
            continue
        winner = None
        best = -1
        for li, lane in enumerate(lr):
            if not lane.vote_ok or not drift_ok(lane.old_rep, lane.k_rep,
                                                lane.wt):
                continue
            # >= : ties go to the later lane (the odometry-null lane is
            # last; batch_lc.py:949-957)
            if lane.n_final >= best:
                best = lane.n_final
                winner = li
        out.append((lr, winner))
    _mark("verify_vote")
    return out, timing


def _consistency_broken(poses_wt: np.ndarray, edges: Sequence[Tuple[int,
                        int, np.ndarray]], cfg: SlamConfig) -> bool:
    """slam.cpp:1215-1232 (copy of batch_lc.py:963-976): any edge whose
    current relative pose deviates from its constraint by more than the
    keyframe thresholds."""
    for i, j, c in edges:
        Ti = Pose.from_wt(poses_wt[i])
        Tj = Pose.from_wt(poses_wt[j])
        C = Pose.from_wt(c)
        D = (Tj @ Ti.inv()) @ C.inv()
        ang = np.linalg.norm(Pose(D.R, np.zeros(3)).wt()[:3])
        if ang >= cfg.pgo_consistency_rot_thr \
                or np.linalg.norm(D.t) >= cfg.pgo_consistency_tr_thr:
            return True
    return False


def _pose_graph_stitch(res: BatchResult, loop_edges, cfg: SlamConfig,
                       dtype, device):
    """Chain + loop edges -> PGO on ``device`` -> stitched trajectory
    (batch_lc.py:979-1017).  Returns (trajectory, PGOStats or None when the
    graph is already consistent)."""
    K = res.kf_count
    poses = np.stack([T.inv().wt() for T in res.trajectory])   # world->cam
    edges = [(g, g + 1, res.edges_wt[g]) for g in range(K - 1)]
    edges += [(o, n, wt) for (o, n, wt) in loop_edges]

    if not _consistency_broken(poses, loop_edges, cfg):
        # graph already consistent (reference: pose_optimization skipped)
        return [T for T in res.trajectory], None

    dev = resolve_device(device)
    free = np.ones(K, bool)
    free[0] = False                        # gauge-fix pose 0
    ei = np.asarray([e[0] for e in edges], np.int32)
    ej = np.asarray([e[1] for e in edges], np.int32)
    ec = np.stack([np.asarray(e[2], np.float64) for e in edges])
    # huber_delta=0.25 is the documented deviation of batch_lc.py:1006-1010
    # (PARITY.md): all loop edges enter at once, so one bad edge is
    # soft-gated
    out, stats = pose_graph_opt(
        torch.as_tensor(poses, dtype=dtype, device=dev),
        torch.as_tensor(ei, device=dev), torch.as_tensor(ej, device=dev),
        torch.as_tensor(ec, dtype=dtype, device=dev),
        torch.ones(len(edges), dtype=torch.bool, device=dev),
        torch.as_tensor(free, device=dev), max_iters=cfg.pgo_num_iter,
        huber_delta=0.25)
    traj = [Pose.from_wt(w).inv() for w in _to_host(out)]
    return traj, stats


def _merge_fids(match_dicts: Sequence[Dict[int, int]]) -> Dict[int, int]:
    """Union-find over loop matches: current fid -> oldest root fid (copy
    of batch_lc.py:1020-1037; slam.cpp:1162-1208 as id unification)."""
    parent: Dict[int, int] = {}

    def find(x):
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    for match in match_dicts:
        for nf, of in match.items():
            rn, ro = find(nf), find(of)
            if rn != ro:
                parent[max(rn, ro)] = min(rn, ro)
    return {x: find(x) for x in list(parent)}


def _span_candidates(cands: Sequence[Tuple[int, int, Dict[int, int]]],
                     window: int, gap: int = 2):
    """Group raw detections into revisit spans before any device work
    (copy of batch_lc.py:1040-1081): both sides contiguous within ``gap``,
    long runs split into ``window``-keyframe spans."""
    spans = []
    cur: List[Tuple[int, int, Dict[int, int]]] = []
    for c in cands:
        if cur:
            dnew = c[0] - cur[-1][0]
            dold = abs(c[1] - cur[-1][1])
            if dnew <= gap and dold <= gap + dnew:
                cur.append(c)
                continue
        if cur:
            spans.append(cur)
        cur = [c]
    if cur:
        spans.append(cur)
    out = []
    for run in spans:
        base = run[0][0]
        chunk: List[Tuple[int, int, Dict[int, int]]] = []
        for c in run:
            if c[0] - base >= window and chunk:
                out.append(chunk)
                chunk = []
                base = c[0]
            chunk.append(c)
        if chunk:
            out.append(chunk)
    return out


class BatchSlamLC:
    """Batch replay with deferred loop closure on ``device``.

    Usage::

        eng = BatchSlamLC(cfg, recognizer, descriptor_source, refine=True)
        result = eng.run(frames)            # frames: [{fid: obs8}, ...]

    ``descriptor_source(frame_id, feat_ids) -> (F, 72)`` descriptors;
    ``recognizer``: a ``loopclosure`` ``PlaceRecognizer`` or
    ``BatchPlaceRecognizer``.  ``device`` defaults to the card (``"cpu"``
    runs the kernels' plain twins); the dtype is ``cfg.compute_dtype``.
    ``gumbel_hook(kf_index, H, N)`` injects the span solves' RANSAC noise.
    """

    def __init__(self, config: Optional[SlamConfig] = None,
                 recognizer=None, descriptor_source=None,
                 refine: bool = False, refine_rounds: int = 2,
                 overlap_descriptors: bool = False, device="cuda",
                 gumbel_hook: Optional[SpanNoiseFn] = None):
        self.cfg = config or SlamConfig()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.cfg.compute_dtype)
        self.recognizer = recognizer
        self.descriptor_source = descriptor_source
        self.refine = refine
        self.refine_rounds = refine_rounds
        # overlap_descriptors=True asks for EVERY frame's descriptors in
        # frame order right after the replay (batch_lc.py:1106-1115, where
        # the host computes them while the device runs the scan).  A
        # stateful source (sim.tracks draws noise per call) then sees
        # another call stream than the default keyframe-only one whenever
        # some frame is not a keyframe: the run warns and records
        # stats["descriptor_stream_changed"].
        self.overlap_descriptors = overlap_descriptors
        self.gumbel_hook = gumbel_hook
        self._batch = BatchSlam(self.cfg, device=self.device)

    def run(self, frames: List[Dict[int, np.ndarray]],
            frame_ids: Optional[List[int]] = None,
            normalized: bool = True,
            lifetime: Optional[int] = None) -> BatchLCResult:
        t0 = time.perf_counter()
        if not normalized:
            frames = normalize_frames(frames, self.cfg.camera)
        handle = self._batch.dispatch(frames, frame_ids=frame_ids,
                                      lifetime=lifetime)
        pre_desc = None
        if (self.overlap_descriptors and self.recognizer is not None
                and self.descriptor_source is not None):
            pre_desc = [self.descriptor_source(i, sorted(fr))
                        for i, fr in enumerate(frames)]
        res = self._batch.collect(handle)
        return self.post_pass(frames, res, pre_desc=pre_desc,
                              t_replay=time.perf_counter() - t0)

    def post_pass(self, frames: List[Dict[int, np.ndarray]],
                  res: BatchResult, pre_desc=None,
                  t_replay: float = 0.0) -> BatchLCResult:
        """Stages 1-5 over a replay's result (batch_lc.py:1140-1453).
        ``pre_desc``: every frame's descriptors, computed in frame order
        (``overlap_descriptors``); without it the keyframes' descriptors
        are computed here, in keyframe order."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        kf_idx = np.flatnonzero(np.asarray(res.is_kf, bool))
        stream_changed = bool(pre_desc is not None
                              and len(kf_idx) != len(frames))
        if stream_changed:
            warnings.warn(
                "BatchSlamLC: overlap_descriptors computed every frame's "
                "descriptors but only some frames are keyframes; a stateful "
                "descriptor source saw another call stream than the "
                "keyframe-only default")
        events: List[LoopEvent] = []
        merge_matches: List[Dict[int, int]] = []
        loop_edges = []
        n_candidates = 0
        n_spans = 0
        n_joint = 0
        confirm_stages = {}
        t_rounds = t_joint = 0.0
        t1 = time.perf_counter()
        t_desc = t_scan = 0.0
        cum = np.concatenate([[0.0], np.cumsum([
            np.linalg.norm(res.trajectory[g + 1].t - res.trajectory[g].t)
            for g in range(res.kf_count - 1)])])
        if self.recognizer is not None and self.descriptor_source is not None:
            fids_list = [sorted(frames[f]) for f in kf_idx]
            if hasattr(self.recognizer, "recognize_all"):
                descs = (
                    [pre_desc[int(f)] for f in kf_idx]
                    if pre_desc is not None else
                    [self.descriptor_source(int(f), fids)
                     for f, fids in zip(kf_idx, fids_list)])
                t_desc = time.perf_counter() - t1
                hits = self.recognizer.recognize_all(
                    list(range(len(kf_idx))), fids_list, descs)
                t_scan = time.perf_counter() - t1 - t_desc
            else:
                hits = [self.recognizer.query_and_insert(
                    k, fids_list[k],
                    pre_desc[int(f)] if pre_desc is not None
                    else self.descriptor_source(int(f), fids_list[k]))
                    for k, f in enumerate(kf_idx)]

            # correlated detections dedup to one edge per revisit span
            cands = [(k, hit[0], hit[1]) for k, hit in enumerate(hits)
                     if hit is not None]
            n_candidates = len(cands)
            spans = _span_candidates(cands, cfg.ba_window_size)
            n_spans = len(spans)

            def _drift_ok(old_k, k, wt):
                implied = (res.trajectory[k].inv()
                           @ res.trajectory[old_k])
                dev_t = np.linalg.norm(Pose.from_wt(wt).t
                                       - implied.wt()[3:])
                path = max(cum[k] - cum[old_k], 1.0)
                return dev_t <= cfg.lc_max_drift_frac * path

            # per round, every pending span's next-best representative is
            # solved; rejected spans fall back to the next, up to 3
            t_rounds0 = time.perf_counter()
            span_ordered = [sorted(s, key=lambda c: -len(c[2]))[:3]
                            for s in spans]
            span_events: List[List[LoopEvent]] = [[] for _ in spans]
            span_edge: List[Optional[tuple]] = [None] * n_spans
            span_merge: List[Optional[dict]] = [None] * n_spans
            span_solved: List[set] = [set() for _ in spans]
            pending = list(range(n_spans))
            for rnd in range(3):
                rd = [(si, span_ordered[si][rnd]) for si in pending
                      if rnd < len(span_ordered[si])]
                if not rd:
                    break
                res_r = _solve_span_round([c for _, c in rd], frames,
                                          kf_idx, cfg, dtype, dev,
                                          self.gumbel_hook)
                nxt = []
                for (si, (k, old_k, match)), (wt, score, n, inl_pairs) \
                        in zip(rd, res_r):
                    if wt is not None and not _drift_ok(old_k, k, wt):
                        wt = None
                    accepted = wt is not None
                    span_events[si].append(
                        LoopEvent(old_k, k, n, score, wt, accepted))
                    span_solved[si].add(k)
                    if accepted:
                        span_edge[si] = (old_k, k, wt)
                        span_merge[si] = inl_pairs
                    else:
                        nxt.append(si)
                pending = nxt
            t_rounds = time.perf_counter() - t_rounds0

            # every span gets a joint multi-keyframe confirm, except a
            # revisit-range 2-view edge that is odometry-consistent
            # (batch_lc.py:1236-1265)
            t_joint0 = time.perf_counter()
            jobs = []
            job_si = []
            for si in range(n_spans):
                accepted_edge = span_edge[si]
                if accepted_edge is not None and np.linalg.norm(
                        accepted_edge[2][3:]) <= cfg.lc_confirm_t_norm:
                    old_k, k, wt = accepted_edge
                    implied = (res.trajectory[k].inv()
                               @ res.trajectory[old_k])
                    dev_t = np.linalg.norm(Pose.from_wt(wt).t - implied.t)
                    if dev_t <= cfg.lc_confirm_dev_t:
                        continue
                jobs.append((spans[si], accepted_edge))
                job_si.append(si)
            outs = []
            if jobs:
                outs, confirm_stages = _joint_confirm_jobs(
                    jobs, frames, kf_idx, res.trajectory, cfg, dtype, dev,
                    _drift_ok)
            for (span_j, accepted_edge), si, out in zip(jobs, job_si,
                                                        outs):
                if out is None:
                    # not attemptable: an existing 2-view edge stands
                    continue
                lanes_r, winner = out
                n_joint += len(lanes_r)
                for li, lane in enumerate(lanes_r):
                    ok = li == winner
                    span_events[si].append(LoopEvent(
                        lane.old_rep, lane.k_rep, lane.n, lane.n_final,
                        lane.wt if ok else None, ok, joint=True))
                if winner is not None:
                    lane = lanes_r[winner]
                    span_edge[si] = (lane.old_rep, lane.k_rep, lane.wt)
                    span_merge[si] = lane.inl_pairs
                elif accepted_edge is not None:
                    # every lane failed the joint vote: the multi-view
                    # geometry refutes the 2-view edge
                    span_edge[si] = None
                    span_merge[si] = None
            t_joint = time.perf_counter() - t_joint0
            for si, span in enumerate(spans):
                for (k, old_k, match) in span:
                    if k not in span_solved[si]:
                        span_events[si].append(
                            LoopEvent(old_k, k, len(match), 0, None,
                                      False, deduped=True))
                events.extend(span_events[si])
                if span_edge[si] is not None:
                    loop_edges.append(span_edge[si])
                    merge_matches.append(span_merge[si])
        t_recog = time.perf_counter() - t1

        t2 = time.perf_counter()
        if loop_edges:
            traj, pgo_stats = _pose_graph_stitch(res, loop_edges, cfg,
                                                 dtype, dev)
        else:
            traj, pgo_stats = list(res.trajectory), None
        t_pgo = time.perf_counter() - t2

        merged = _merge_fids(merge_matches)

        refined = None
        t_refine = 0.0
        refine_pick = "stitched"
        refine_loop_frac = None
        if self.refine and res.kf_count:
            from .refine import global_refine
            t3 = time.perf_counter()
            if merged:
                frames_m = [{merged.get(fid, fid): o for fid, o in
                             fr.items()} for fr in frames]
            else:
                frames_m = frames
            # the refine initializes from the stitched trajectory; its
            # odometry prior values are the replay's odometry measurements
            # (batch_lc.py:1334-1347), and the loop edges enter as general
            # pose priors (:1348-1358)
            prior_c = (np.asarray(res.edges_wt, np.float64)
                       if res.kf_count > 1 else None)
            pedges = None
            if loop_edges:
                pedges = (np.asarray([o for (o, _, _) in loop_edges]),
                          np.asarray([nk for (_, nk, _) in loop_edges]),
                          np.stack([wt for (_, _, wt) in loop_edges]))
            refined = global_refine(frames_m, res.is_kf, traj, config=cfg,
                                    rounds=self.refine_rounds,
                                    _prior_c=prior_c, prior_edges=pedges,
                                    device=dev)
            traj = refined.trajectory

            # counterfactual basin selection for contested closures
            # (batch_lc.py:1364-1426)
            contested = False
            any_large = False
            for (old_k, new_k, wt) in loop_edges:
                implied = (res.trajectory[new_k].inv()
                           @ res.trajectory[old_k])
                dev_t = np.linalg.norm(Pose.from_wt(wt).t - implied.t)
                if dev_t > cfg.lc_confirm_dev_t:
                    contested = True
                    path = max(cum[new_k] - cum[old_k], 1.0)
                    if dev_t > cfg.lc_counterfactual_corr_frac * path:
                        any_large = True
            contested = contested and not any_large
            if contested:
                alt = global_refine(frames_m, res.is_kf,
                                    list(res.trajectory), config=cfg,
                                    rounds=self.refine_rounds,
                                    _prior_c=prior_c, prior_edges=pedges,
                                    device=dev)
                f_st, fh_st = _merged_inlier_frac(refined, frames_m,
                                                  res.is_kf, merged, cfg,
                                                  dtype, dev)
                f_od, fh_od = _merged_inlier_frac(alt, frames_m, res.is_kf,
                                                  merged, cfg, dtype, dev)
                refine_loop_frac = {
                    "stitched": (round(f_st, 3), round(fh_st, 3)),
                    "odometry_init": (round(f_od, 3), round(fh_od, 3))}
                if f_od >= f_st - 0.05 and fh_od >= fh_st - 0.05:
                    refined = alt
                    traj = alt.trajectory
                    refine_pick = "odometry-init"
            t_refine = time.perf_counter() - t3

        stats = dict(res.stats)
        stats.update({
            "num_loop_candidates": n_candidates,
            "num_loop_spans": n_spans,
            "num_loop_closures": len(loop_edges),
            "num_merged_tracks": len(merged),
            "pgo_iterations": (int(pgo_stats.iterations)
                               if pgo_stats is not None else 0),
            "wall_replay_s": round(t_replay, 3),
            "wall_recognition_s": round(t_recog, 3),
            "wall_desc_s": round(t_desc, 3),
            "wall_recog_scan_s": round(t_scan, 3),
            "wall_span_rounds_s": round(t_rounds, 3) if n_spans else 0.0,
            "wall_joint_confirm_s": (round(t_joint, 3)
                                     if n_spans else 0.0),
            "num_joint_solves": n_joint if n_spans else 0,
            "wall_confirm_stages": (confirm_stages if n_spans else {}),
            "wall_pgo_s": round(t_pgo, 3),
            "wall_refine_s": round(t_refine, 3),
            "refine_pick": refine_pick,
            "refine_loop_frac": refine_loop_frac,
            "descriptor_stream_changed": stream_changed,
        })
        return BatchLCResult(base=res, trajectory=traj, events=events,
                             merged_fids=merged, stats=stats,
                             refined=refined)
