"""Visual odometry: RANSAC + motion-only BA + final scoring.

Port of ``slslam_tpu/ops/vo_pipeline.py`` (SLAM::pose_estimation's device
work, slam.cpp:244-319): the RANSAC stage, the Ceres motion polish
(slam.cpp:578-675) as a 4-camera pose-only instance of the Schur-LM solver
(cam 0 free, all lines fixed, inlier observations in both frames), and the
final scoring under the polished motion.  ``vo_pipeline`` is the
interactive engine's entry: host correspondences padded to a capacity
bucket, as engine/slam.py:275-286 pads them for JAX's jitted pipeline.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import geometry as geo
from ..config import bucket_for
from .ransac import ransac_stage
from .residuals import score_error_hyp_obs
from .schur_ba import local_ba


class VOResult(NamedTuple):
    wt: torch.Tensor            # (6,) polished motion prev->curr
    ransac_score: torch.Tensor  # inlier count of the RANSAC winner
    ransac_wt: torch.Tensor     # (6,) pre-polish winner
    final_errors: torch.Tensor  # (N,) errors under the polished motion
    num_inliers_used: torch.Tensor


def vo_body(obs0, obs1, lines_av, valid, baseline, error_thr, huber_delta,
            max_t_norm=1.0, num_hyp=256, sample_size=5, robust=True,
            max_iters=10, line_param="orth", relin_iters=1,
            gumbel: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None):
    """VO solve (vo_pipeline.py:35-81).  ``gumbel`` / ``generator`` feed the
    RANSAC sampling (see ``ransac_stage``)."""
    N = obs0.shape[0]
    dtype, dev = obs0.dtype, obs0.device
    rr = ransac_stage(obs0, obs1, lines_av, valid, baseline, error_thr,
                      max_t_norm=max_t_norm, num_hyp=num_hyp,
                      sample_size=sample_size, relin_iters=relin_iters,
                      gumbel=gumbel, generator=generator)

    line_orth = geo.LINE_ENCODERS[line_param](lines_av)
    cam = torch.zeros((4, 6), dtype=dtype, device=dev)
    cam[0] = rr.best_wt
    cam_free = torch.tensor([True, False, False, False], device=dev)
    obs_cat = torch.cat([obs1, obs0], dim=0)
    ocam = torch.cat([torch.zeros(N, dtype=torch.int32, device=dev),
                      torch.ones(N, dtype=torch.int32, device=dev)])
    ar = torch.arange(N, dtype=torch.int32, device=dev)
    olin = torch.cat([ar, ar])
    ovalid = torch.cat([rr.inliers, rr.inliers])

    cam_out, _, _ = local_ba(
        cam, line_orth, obs_cat, ocam, olin, ovalid, cam_free,
        torch.zeros(N, dtype=torch.bool, device=dev), baseline, huber_delta,
        robust=robust, max_iters=max_iters, line_param=line_param,
        pose_only=True)
    wt = cam_out[0]

    Rf = geo.rodrigues(wt[None, :3])
    final_errors = score_error_hyp_obs(obs1, Rf, wt[None, 3:], lines_av,
                                       baseline)[0]
    return VOResult(wt, rr.best_score, rr.best_wt, final_errors,
                    torch.sum(rr.inliers.to(torch.int32)))


def vo_pipeline(obs0, obs1, lines_av, baseline, error_thr, huber_delta,
                buckets, device, dtype, **kw):
    """VO of N host correspondences, obs0/obs1 (N, 8) and lines (N, 6) in
    the frame of obs0 (numpy), padded to ``bucket_for(N, buckets)`` rows
    (padding: zero observations, a benign unit direction, invalid) and run
    by ``vo_body`` on ``device``; ``kw`` are vo_body's options.  Returns
    the padded ``VOResult``."""
    N = len(obs0)
    Nb = bucket_for(N, buckets)
    o0 = np.zeros((Nb, 8))
    o1 = np.zeros((Nb, 8))
    ln = np.zeros((Nb, 6))
    ln[:, 5] = 1.0
    valid = np.zeros(Nb, bool)
    o0[:N], o1[:N], ln[:N], valid[:N] = obs0, obs1, lines_av, True

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return vo_body(t(o0), t(o1), t(ln), torch.as_tensor(valid, device=device),
                   baseline, error_thr, huber_delta, **kw)
