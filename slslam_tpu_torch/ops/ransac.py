"""Vectorized RANSAC line visual odometry (port of slslam_tpu/ops/ransac.py).

Replaces the reference's SLAM::ransac_motion + vo_angle_axis_approx
(slam.cpp:323-574): a fixed batch of H hypotheses, each a 5-sample minimal
solve, scored against every observation in one (H, N) pass; the first
maximum wins.  Hypotheses are sampled by Gumbel top-k; the (H, N) Gumbel
noise is either injected (so that a test can feed JAX's stream) or drawn
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import geometry as geo
from .residuals import score_error_hyp_obs

_EPS = 1e-12


class RansacResult(NamedTuple):
    best_wt: torch.Tensor       # (6,) motion prev->curr (angle-axis, t)
    best_score: torch.Tensor    # inlier count of the winner
    inliers: torch.Tensor       # (N,) bool inlier mask of the winner
    errors: torch.Tensor        # (N,) reprojection errors under the winner
    num_valid_hyp: torch.Tensor


def _lifted_line(a, b):
    """Image line through two lifted endpoints: cross([a,1],[b,1])."""
    one = torch.ones(a.shape[:-1] + (1,), dtype=a.dtype, device=a.device)
    return geo.cross(torch.cat([a, one], dim=-1), torch.cat([b, one], dim=-1))


def _safe_normalize(v):
    n = geo.norm(v, keepdim=True)
    return v / torch.clamp_min(n, _EPS), n[..., 0]


def _solve3(A, b):
    """(A^T A + eps I)^-1 A^T b over leading batch dims."""
    At = A.transpose(-1, -2)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    x, _ = torch.linalg.solve_ex(At @ A + _EPS * eye, geo.matvec(At, b))
    return x


def minimal_motion(obs0, obs1, a4_x, relin_iters=1):
    """vo_angle_axis_approx (slam.cpp:433-574; ransac.py:54-156) over
    leading batch dims: obs0, obs1 (..., S, 8) -> wt (..., 6), ok (...,).

    a4_x is the reference's (negated) baseline argument; relin_iters > 1
    composes extra small-angle solves on rotated normals."""
    l1 = _lifted_line(obs0[..., 0:2], obs0[..., 2:4])
    l2 = _lifted_line(obs0[..., 4:6], obs0[..., 6:8])
    l3 = _lifted_line(obs1[..., 0:2], obs1[..., 2:4])
    l4 = _lifted_line(obs1[..., 4:6], obs1[..., 6:8])

    lx0, lxn = _safe_normalize(geo.cross(l1, l2))
    ly3, l3n = _safe_normalize(l3)
    ly4, l4n = _safe_normalize(l4)

    def small_angle_w(lx):
        def k_rows(ly):
            c = torch.stack([
                lx[..., 2] * ly[..., 1] - lx[..., 1] * ly[..., 2],
                lx[..., 0] * ly[..., 2] - lx[..., 2] * ly[..., 0],
                lx[..., 1] * ly[..., 0] - lx[..., 0] * ly[..., 1],
            ], dim=-1)
            d = torch.sum(lx * ly, dim=-1, keepdim=True)
            return torch.cat([c, d], dim=-1)

        K = torch.cat([k_rows(ly3), k_rows(ly4)], dim=-2)     # (..., 2S, 4)
        return -_solve3(K[..., :3], -K[..., 3])

    w = small_angle_w(lx0)
    R = geo.rodrigues(w)
    for _ in range(relin_iters - 1):
        dw = small_angle_w(lx0 @ R.transpose(-1, -2))
        R = geo.rodrigues(dw) @ R
        w = geo.so3_log(R)

    # translation system (slam.cpp:485-565)
    l1n_, l1nn = _safe_normalize(l1)
    l2n_, l2nn = _safe_normalize(l2)
    _, lx2n = _safe_normalize(geo.cross(l1n_, l2n_))
    baseline = a4_x

    def m_rows(l3u, right):
        l2a = l2n_[..., 0] * a4_x                  # l2 . (a4x, 0, 0)
        rl3 = l3u @ R
        c = -l2a[..., None] * rl3
        if right:
            c = c + l2n_ * (baseline * l3u[..., 0:1])
        x0 = l1n_[..., 1] * l2n_[..., 2] - l1n_[..., 2] * l2n_[..., 1]
        x1 = l1n_[..., 2] * l2n_[..., 0] - l1n_[..., 0] * l2n_[..., 2]
        x2 = l1n_[..., 0] * l2n_[..., 1] - l1n_[..., 1] * l2n_[..., 0]
        r0 = torch.stack([x0 * l3u[..., 0], x0 * l3u[..., 1],
                          x0 * l3u[..., 2],
                          l1n_[..., 1] * c[..., 2] - l1n_[..., 2] * c[..., 1]],
                         dim=-1)
        r1 = torch.stack([x1 * l3u[..., 0], x1 * l3u[..., 1],
                          x1 * l3u[..., 2],
                          l1n_[..., 2] * c[..., 0] - l1n_[..., 0] * c[..., 2]],
                         dim=-1)
        r2 = torch.stack([x2 * l3u[..., 0], x2 * l3u[..., 1],
                          x2 * l3u[..., 2],
                          l1n_[..., 0] * c[..., 1] - l1n_[..., 1] * c[..., 0]],
                         dim=-1)
        return torch.cat([r0, r1, r2], dim=-2)

    M = torch.cat([m_rows(ly3, False), m_rows(ly4, True)], dim=-2)
    t = _solve3(M[..., :3], -M[..., 3])

    norms = torch.stack([lxn, l3n, l4n, l1nn, l2nn, lx2n], dim=-1)
    ok = torch.all((norms > 1e-30).flatten(-2), dim=-1)
    return torch.cat([w, t], dim=-1), ok


def gumbel_noise(generator, shape, dtype, device):
    """Standard Gumbel noise -log(-log U) drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, tiny, 1.0)))


def first_argmax(x, dim=-1):
    """Index of the FIRST maximum along ``dim`` (jnp.argmax's rule)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ar = torch.arange(n, device=x.device).reshape(shape)
    m = torch.amax(x, dim=dim, keepdim=True)
    return torch.amin(torch.where(x == m, ar, n), dim=dim)


def ransac_stage(obs0, obs1, lines_av, valid, baseline, error_thr,
                 max_t_norm=1.0, num_hyp=256, sample_size=5, relin_iters=1,
                 gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """RANSAC stage (ransac.py:170-232).  obs0/obs1 (N, 8), lines_av (N, 6)
    in the previous frame, valid (N,).  ``gumbel`` (num_hyp, N) is the
    sampling noise; without it, it is drawn from ``generator``."""
    N = obs0.shape[0]
    dtype, dev = obs0.dtype, obs0.device
    if gumbel is None:
        if generator is None:
            raise ValueError("ransac_stage needs gumbel noise or a generator")
        gumbel = gumbel_noise(generator, (num_hyp, N), dtype, dev)
    g = torch.where(valid[None, :], gumbel.to(dtype=dtype, device=dev),
                    torch.full((), float("-inf"), dtype=dtype, device=dev))
    # top-k with lax.top_k's tie rule (lower index first)
    samples = torch.sort(g, dim=1, descending=True,
                         stable=True).indices[:, :sample_size]

    wt, ok = minimal_motion(obs0[samples], obs1[samples], -baseline)
    R = geo.rodrigues(wt[:, :3])
    t = wt[:, 3:]

    errors = score_error_hyp_obs(obs1, R, t, lines_av, baseline)   # (H, N)
    inl = torch.logical_and(errors < error_thr, valid[None, :])
    score = torch.sum(inl, dim=1)
    t_ok = geo.norm(t) <= max_t_norm
    hyp_ok = torch.logical_and(ok, t_ok)
    score = torch.where(hyp_ok, score, torch.full_like(score, -1))

    best = first_argmax(score)
    best_wt = wt[best]
    best_score = score[best]
    inliers = inl[best]
    best_errors = errors[best]

    if relin_iters > 1:
        # guarded winner re-linearization (ransac.py:217-229)
        s_best = samples[best]
        wt_r, ok_r = minimal_motion(obs0[s_best], obs1[s_best], -baseline,
                                    relin_iters=relin_iters)
        good = torch.logical_and(ok_r, torch.all(torch.isfinite(wt_r)))
        err_r = score_error_hyp_obs(obs1, geo.rodrigues(wt_r[None, :3]),
                                    wt_r[None, 3:], lines_av, baseline)[0]
        inl_r = torch.logical_and(err_r < error_thr, valid)
        good = torch.logical_and(good, torch.sum(inl_r) >= best_score)
        best_wt = torch.where(good, wt_r, best_wt)
        inliers = torch.where(good, inl_r, inliers)
        best_errors = torch.where(good, err_r, best_errors)

    return RansacResult(best_wt, best_score, inliers, best_errors,
                        torch.sum(hyp_ok.to(torch.int32)))
