"""Geometry core in PyTorch: SE(3), lines and line parameterizations.

Port of ``slslam_tpu/geometry.py`` (same formulas, same branch structure,
same citations into the reference's gc.cpp).  Every function accepts
leading batch dimensions, broadcasts them, and is safe under
``torch.func.vmap`` / ``jacfwd`` (no in-place updates, no data-dependent
Python control flow): the Jacobians of ``ops/residuals.py`` go through it.

Conventions: a pose (R, t) maps world to camera, p_c = R p_w + t; ``wt`` is
the 6-vector (angle-axis w, translation t); a (cp, dv) line is the 6-vector
(closest point, direction); ``orth`` is (alpha, beta, gamma, theta).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def cross(a, b):
    """a x b over the last axis (broadcasting)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def norm(v, keepdim=False):
    """Euclidean norm over the last axis as sqrt(sum v^2), as jnp computes it."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def matvec(R, v):
    """R @ v over (..., 3, 3) x (..., 3) with broadcasting."""
    return (R @ v.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# SO(3) / SE(3)
# ---------------------------------------------------------------------------

def skew(v):
    """Skew-symmetric matrix [v]x (gc.cpp:119-123)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def rodrigues(w):
    """Angle-axis (..., 3) -> rotation (..., 3, 3) (gc.cpp:24-34), with the
    Taylor branch below theta^2 = 1e-16 (geometry.py:45-62)."""
    # (..., 1, 1) shapes throughout: under torch.func.vmap + jacfwd a
    # per-sample 0-dim `1.0 - theta2 / 6.0` inside torch.where promotes
    # the tangents of a float32 input to float64
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS))
    small = theta2 < 1e-16
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    W = skew(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * W2


def so3_log(R):
    """Rotation (..., 3, 3) -> angle-axis (..., 3) (gc.cpp:36-49), with the
    small-angle and near-pi branches of geometry.py:65-97."""
    vee = 0.5 * torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    s = norm(vee)
    c = 0.5 * ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]) - 1.0)
    theta = torch.atan2(s, c)

    small = s < 1e-8
    scale = torch.where(small, 1.0 + (1.0 - c) / 6.0,
                        theta / torch.where(small, torch.ones_like(s), s))
    w_generic = scale[..., None] * vee

    near_pi = c < -0.99
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp_min((diag - c[..., None])
                            / (1.0 - c[..., None] + _EPS), 0.0)
    axis = torch.sqrt(axis2)
    sgn = torch.sign(torch.where(torch.abs(vee) > 1e-12, vee,
                                 torch.ones_like(vee)))
    axis = axis * sgn
    axis = axis / (norm(axis, keepdim=True) + _EPS)
    w_pi = theta[..., None] * axis
    return torch.where(near_pi[..., None], w_pi, w_generic)


def t_inv(R, t):
    """Inverse pose (gc.cpp:51-53)."""
    Ri = R.transpose(-1, -2)
    return Ri, -matvec(Ri, t)


def t_compose(R21, t21, R10, t10):
    """T20 = T21 * T10 (gc.cpp:164-166)."""
    return R21 @ R10, matvec(R21, t10) + t21


def t_rel(R20, t20, R10, t10):
    """T21 = T20 * T10^-1 (gc.cpp:169-171)."""
    Ri, ti = t_inv(R10, t10)
    return t_compose(R20, t20, Ri, ti)


def wt_to_Rt(wt):
    """6-vector (w, t) -> (R, t) (gc.cpp:173-176)."""
    return rodrigues(wt[..., :3]), wt[..., 3:]


def Rt_to_wt(R, t):
    """(R, t) -> 6-vector (gc.cpp:178-184)."""
    return torch.cat([so3_log(R), t], dim=-1)


def wt_inv(wt):
    """Inverse pose in 6-vector form (po_problem.h:27-39 semantics)."""
    R, t = wt_to_Rt(wt)
    _, ti = t_inv(R, t)
    return torch.cat([-wt[..., :3], ti], dim=-1)


def wt_compose(wt21, wt10):
    """T20 = T21 * T10 in 6-vector form (po_problem.h:54-64)."""
    R21, t21 = wt_to_Rt(wt21)
    R10, t10 = wt_to_Rt(wt10)
    return Rt_to_wt(*t_compose(R21, t21, R10, t10))


# ---------------------------------------------------------------------------
# Lines
# ---------------------------------------------------------------------------

def line_to_pose(line_w, R, t):
    """(cp, dv) line world -> camera (gc.cpp:63-77)."""
    cp = matvec(R, line_w[..., :3]) + t
    dv = matvec(R, line_w[..., 3:])
    return torch.cat([cp, dv], dim=-1)


def ppp_pi(x1, x2, x3):
    """Plane through three points (gc.cpp:100-105). Returns (..., 4)."""
    normal = cross(x1 - x3, x2 - x3)
    d = -torch.sum(x3 * cross(x1, x2), dim=-1, keepdim=True)
    return torch.cat([normal, d], dim=-1)


def pipi_plk(pi1, pi2):
    """Plücker line (n, v) from two planes (gc.cpp:107-113)."""
    dp = (pi1[..., :, None] * pi2[..., None, :]
          - pi2[..., :, None] * pi1[..., None, :])
    return torch.stack([
        dp[..., 0, 3], dp[..., 1, 3], dp[..., 2, 3],
        -dp[..., 1, 2], dp[..., 0, 2], -dp[..., 0, 1],
    ], dim=-1)


def normalize(v):
    """Safe normalization (gc.cpp:152-157)."""
    n = norm(v, keepdim=True)
    return torch.where(n > 0, v / torch.where(n > 0, n, torch.ones_like(n)),
                       v)


# ---------------------------------------------------------------------------
# 4-DoF line parameterizations (gc.cpp:188-460)
# ---------------------------------------------------------------------------

def av_to_orth(av):
    """(cp, dv) line -> orthonormal 4-vector (gc.cpp:361-417), hardened at
    gimbal lock exactly as geometry.py:248-285."""
    a = av[..., :3]
    v = av[..., 3:]
    n = cross(a, v)
    x = normalize(n)
    y = normalize(v)
    z = cross(x, y)

    beta = torch.asin(torch.clamp(-x[..., 2], -1.0, 1.0))
    alpha_reg = torch.atan2(y[..., 2], z[..., 2])
    gamma_reg = torch.atan2(x[..., 1], x[..., 0])
    lock = torch.abs(torch.abs(x[..., 2]) - 1.0) < 1e-12
    sign_term = torch.where(x[..., 2] < 0, y[..., 0], -y[..., 0])
    alpha_lock = torch.atan2(sign_term, y[..., 1])
    alpha = torch.where(lock, alpha_lock, alpha_reg)
    gamma = torch.where(lock, torch.zeros_like(gamma_reg), gamma_reg)

    nn = norm(n)
    vn = norm(v)
    wnorm = torch.sqrt(nn * nn + vn * vn)
    theta = torch.asin(torch.clamp(vn / torch.clamp_min(wnorm, _EPS),
                                   -1.0, 1.0))
    return torch.stack([alpha, beta, gamma, theta], dim=-1)


def orth_rotation(orth):
    """Euler angles (alpha, beta, gamma) -> R (gc.cpp:427-438)."""
    a, b, g = orth[..., 0], orth[..., 1], orth[..., 2]
    s1, c1 = torch.sin(a), torch.cos(a)
    s2, c2 = torch.sin(b), torch.cos(b)
    s3, c3 = torch.sin(g), torch.cos(g)
    row0 = torch.stack([c2 * c3, s1 * s2 * c3 - c1 * s3,
                        c1 * s2 * c3 + s1 * s3], dim=-1)
    row1 = torch.stack([c2 * s3, s1 * s2 * s3 + c1 * c3,
                        c1 * s2 * s3 - s1 * c3], dim=-1)
    row2 = torch.stack([-s2, s1 * c2, c1 * c2], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def orth_to_av(orth):
    """Orthonormal 4-vector -> (cp, dv) line (gc.cpp:419-460)."""
    R = orth_rotation(orth)
    t = orth[..., 3:]      # keepdim: see rodrigues
    d = torch.cos(t) / torch.sin(t)
    cp = -R[..., :, 2] * d
    dv = R[..., :, 1]
    return torch.cat([cp, dv], dim=-1)


def _frame_aa(av):
    a = av[..., :3]
    x = av[..., 3:]
    y = cross(a, x)
    depth = norm(x) / norm(y)
    xn = normalize(x)
    yn = normalize(y)
    z = cross(xn, yn)
    return so3_log(torch.stack([xn, yn, z], dim=-1)), depth


def av_to_aid(av):
    """(cp, dv) -> angle-axis frame + inverse depth (gc.cpp:188-226)."""
    aa, d_inv = _frame_aa(av)
    return torch.cat([aa, d_inv[..., None]], dim=-1)


def aid_to_av(aid):
    """Inverse of av_to_aid (gc.cpp:228-261)."""
    R = rodrigues(aid[..., :3])
    d = 1.0 / aid[..., 3:]
    return torch.cat([R[..., :, 2] * d, R[..., :, 0]], dim=-1)


def av_to_asd(av):
    """(cp, dv) -> angle-axis frame + sigmoid depth (gc.cpp:265-321)."""
    aa, depth = _frame_aa(av)
    return torch.cat([aa, torch.exp(depth)[..., None]], dim=-1)


def asd_to_av(asd):
    """Inverse of av_to_asd (gc.cpp:323-356)."""
    R = rodrigues(asd[..., :3])
    sig_d_inv = torch.log(asd[..., 3:])
    return torch.cat([R[..., :, 2] * sig_d_inv, R[..., :, 0]], dim=-1)


LINE_ENCODERS = {"orth": av_to_orth, "aid": av_to_aid, "asd": av_to_asd}
LINE_DECODERS = {"orth": orth_to_av, "aid": aid_to_av, "asd": asd_to_av}
