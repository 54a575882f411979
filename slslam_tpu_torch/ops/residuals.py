"""Line reprojection residuals, Jacobians and the RANSAC scoring error.

Port of ``slslam_tpu/ops/residuals.py``:

* ``lba_residual`` — the BA residual of ceres::LineReprojectionError
  (reference lba_problem.h:41-121; residuals.py:50-76): four signed
  point-to-line distances (2 endpoints x 2 cameras).  Broadcasts over
  leading dimensions.
* ``lba_residual_jac_batch`` and friends — residual plus Jacobians.  The
  JAX package takes them with ``jax.jacfwd`` (residuals.py:79-107); here
  ``torch.func.jacfwd`` under ``torch.func.vmap`` computes the same
  forward-mode derivatives.  These are the plain versions that the CPU path
  runs and the CPU twin of the CUDA evaluate's Jacobians
  (``ops/kernels.py``).
* ``score_error`` / ``score_error_hyp_obs`` — the RANSAC scoring error
  (slam.cpp:691-726; residuals.py:110-137,193), broadcasting (H, N).
* ``robust_weights`` — Ceres's Huber loss (schur_ba.py:80-90).
"""

from __future__ import annotations

import functools

import torch

from .. import geometry as geo

_EPS = 1e-12


def lba_residual(cam_wt, line_param4, obs, baseline, line_param="orth"):
    """BA residual: cam (..., 6), line (..., 4), obs (..., 8) -> (..., 4)."""
    av = geo.LINE_DECODERS[line_param](line_param4)
    cp, dv = av[..., :3], av[..., 3:]
    R = geo.rodrigues(cam_wt[..., :3])
    pc = geo.matvec(R, cp) + cam_wt[..., 3:]
    dc = geo.matvec(R, dv)

    def segment_residuals(p, x_a, y_a, x_b, y_b):
        n = geo.cross(p, dc)
        sql = torch.sqrt(n[..., 0] ** 2 + n[..., 1] ** 2)
        n = n / torch.clamp_min(sql, _EPS)[..., None]
        r_a = -(x_a * n[..., 0] + y_a * n[..., 1] + n[..., 2])
        r_b = -(x_b * n[..., 0] + y_b * n[..., 1] + n[..., 2])
        return r_a, r_b

    r0, r1 = segment_residuals(pc, obs[..., 0], obs[..., 1],
                               obs[..., 2], obs[..., 3])
    pc_r = torch.cat([pc[..., :1] + (-baseline), pc[..., 1:]], dim=-1)
    r2, r3 = segment_residuals(pc_r, obs[..., 4], obs[..., 5],
                               obs[..., 6], obs[..., 7])
    return torch.stack([r0, r1, r2, r3], dim=-1)


def lba_residual_batch(cam_wt, line_param4, obs, baseline,
                       line_param="orth"):
    """Residual only, over gathered (O, 6), (O, 4), (O, 8) -> (O, 4)."""
    return lba_residual(cam_wt, line_param4, obs, baseline, line_param)


@functools.lru_cache(maxsize=None)
def _jac_batch_for(line_param, argnums):
    def f(cw, lo, ob, baseline):
        r = lba_residual(cw, lo, ob, baseline, line_param)
        return r, r
    jac = torch.func.jacfwd(f, argnums=argnums, has_aux=True)
    return torch.func.vmap(jac, in_dims=(0, 0, 0, None))


def lba_residual_jac_batch(cam_wt, line_param4, obs, baseline,
                           line_param="orth"):
    """(O,6),(O,4),(O,8) -> r (O,4), d r/d cam (O,4,6), d r/d line (O,4,4)."""
    (j_cam, j_line), r = _jac_batch_for(line_param, (0, 1))(
        cam_wt, line_param4, obs, baseline)
    return r, j_cam, j_line


def lba_residual_jac_cam_batch(cam_wt, line_param4, obs, baseline,
                               line_param="orth"):
    """Residual plus camera Jacobian only (the motion-only BA variant)."""
    j_cam, r = _jac_batch_for(line_param, 0)(cam_wt, line_param4, obs,
                                             baseline)
    return r, j_cam


def lba_residual_jac_line_batch(cam_wt, line_param4, obs, baseline,
                                line_param="orth"):
    """Residual plus line Jacobian only (the lines-only staged solve)."""
    j_line, r = _jac_batch_for(line_param, 1)(cam_wt, line_param4, obs,
                                              baseline)
    return r, j_line


def robust_weights(r, huber_delta, robust):
    """Ceres Huber loss: cost = 1/2 rho(|r|^2); residual scaling sqrt(rho').

    Returns (sqrt(rho') (O,), 1/2 rho (O,)) as schur_ba.py:80-90."""
    s = torch.sum(r * r, dim=-1)
    if not robust:
        return torch.ones_like(s), 0.5 * s
    d2 = huber_delta * huber_delta
    out = s > d2
    safe = torch.clamp_min(s, 1e-300)
    rho = torch.where(out, 2.0 * huber_delta * torch.sqrt(safe) - d2, s)
    rho1 = torch.where(out, huber_delta / torch.sqrt(safe),
                       torch.ones_like(s))
    return torch.sqrt(rho1), 0.5 * rho


def score_error(obs, R, t, line_av, baseline):
    """RANSAC scoring error (slam.cpp:691-726): mean of the 4 absolute
    normalized distances.  obs (..., 8), R (..., 3, 3), t (..., 3),
    line_av (..., 6) in the source frame; all broadcast."""
    cp, dv = line_av[..., :3], line_av[..., 3:]
    ex = torch.zeros(3, dtype=t.dtype, device=t.device)
    ex[0] = 1.0

    def one_cam(shift):
        tc = t + shift * ex
        cpc = geo.matvec(R, cp) + tc
        dvc = geo.matvec(R, dv)
        n = geo.cross(cpc, dvc)
        sql = torch.sqrt(n[..., 0] ** 2 + n[..., 1] ** 2)
        return n / torch.clamp_min(sql, _EPS)[..., None]

    n_l = one_cam(0.0)
    n_r = one_cam(-baseline)

    def dist(n, x, y):
        return torch.abs(x * n[..., 0] + y * n[..., 1] + n[..., 2])

    err = (dist(n_l, obs[..., 0], obs[..., 1])
           + dist(n_l, obs[..., 2], obs[..., 3])
           + dist(n_r, obs[..., 4], obs[..., 5])
           + dist(n_r, obs[..., 6], obs[..., 7]))
    return err / 4.0


def score_error_hyp_obs(obs, R, t, lines_av, baseline):
    """Scores of H hypotheses against N observations: obs (N, 8),
    R (H, 3, 3), t (H, 3), lines (N, 6) -> (H, N)."""
    return score_error(obs[None], R[:, None], t[:, None], lines_av[None],
                       baseline)
