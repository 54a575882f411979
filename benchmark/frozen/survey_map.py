"""Frozen copy of the survey deployment's map generator.

Copied verbatim from ``tools/torch_large_map_bench.py`` (itself a copy of
``tools/large_map_bench.py:43-174``) at the commit that added the
benchmark: the survey loop of ``C`` cameras on a circle 0.78 m apart (the
reference's real-sequence median keyframe spacing), line landmarks
anchored along the path and seen within +-``band_m`` metres, the
reference's intrinsics and 0.12 m baseline (src/parameter.h:43-52); with
``so3_log`` and ``av_to_orth_np`` of ``slslam_tpu_torch/hostgeom.py``.
``benchmark/tests/test_bench_frozen.py`` holds them equal to the port's.
"""

from __future__ import annotations

import numpy as np

HALF_W = 327.783 / 406.05   # normalized image half-extent (parameter.h:43-52)
HALF_H = 237.172 / 406.05
BASELINE = 0.12


def so3_log(R):
    """Rotation matrix -> angle-axis (robust near 0 and pi)."""
    R = np.asarray(R, dtype=np.float64)
    vee = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                          R[1, 0] - R[0, 1]])
    s = np.linalg.norm(vee)
    c = 0.5 * (np.trace(R) - 1.0)
    theta = np.arctan2(s, c)
    if c < -0.99:
        diag = np.diag(R)
        axis2 = np.maximum((diag - c) / (1.0 - c + 1e-300), 0.0)
        axis = np.sqrt(axis2)
        sgn = np.sign(np.where(np.abs(vee) > 1e-12, vee, 1.0))
        axis = axis * sgn
        axis /= (np.linalg.norm(axis) + 1e-300)
        return theta * axis
    if s < 1e-8:
        return (1.0 + (1.0 - c) / 6.0) * vee
    return (theta / s) * vee


def _normalize_rows(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(n > 0, v / np.where(n > 0, n, 1.0), v)


def av_to_orth_np(av):
    """(N, 6) -> (N, 4), batched NumPy mirror of geometry.av_to_orth."""
    a = av[:, :3]
    v = av[:, 3:]
    n = np.cross(a, v)
    x = _normalize_rows(n)
    y = _normalize_rows(v)
    z = np.cross(x, y)

    beta = np.arcsin(np.clip(-x[:, 2], -1.0, 1.0))
    alpha_reg = np.arctan2(y[:, 2], z[:, 2])
    gamma_reg = np.arctan2(x[:, 1], x[:, 0])
    lock = np.abs(np.abs(x[:, 2]) - 1.0) < 1e-12
    sign_term = np.where(x[:, 2] < 0, y[:, 0], -y[:, 0])
    alpha = np.where(lock, np.arctan2(sign_term, y[:, 1]), alpha_reg)
    gamma = np.where(lock, 0.0, gamma_reg)

    nn = np.linalg.norm(n, axis=1)
    vn = np.linalg.norm(v, axis=1)
    wnorm = np.sqrt(nn * nn + vn * vn)
    theta = np.arcsin(np.clip(vn / np.maximum(wnorm, 1e-300), -1.0, 1.0))
    return np.stack([alpha, beta, gamma, theta], axis=1)


def _path_poses(C: int, spacing: float = 0.78):
    """C world->cam poses on a circle, camera z along the tangent; the
    radius scales with C so consecutive cameras stay ``spacing`` apart (the
    reference's real-sequence median keyframe spacing)."""
    radius = C * spacing / (2.0 * np.pi)
    th = np.linspace(0.0, 2.0 * np.pi, C, endpoint=False)
    pos = np.stack([radius * np.cos(th), np.zeros(C), radius * np.sin(th)],
                   axis=1)                                   # (C, 3) world
    z = np.stack([-np.sin(th), np.zeros(C), np.cos(th)], axis=1)  # tangent
    y = np.tile(np.array([0.0, 1.0, 0.0]), (C, 1))
    x = np.cross(y, z)
    R_cw = np.stack([x, y, z], axis=1)                       # rows = cam axes
    t = -np.einsum("cij,cj->ci", R_cw, pos)
    return R_cw, t, pos, z


def make_survey_problem(C=2048, lines_per_anchor=8, band_m=10.0,
                        noise_px=0.3, spacing=0.78, seed=0):
    """The survey-loop BA problem (vectorized numpy): camera c sees the
    lines anchored within +-band_m metres along the path.  Returns a dict
    of the ground-truth cameras (C, 6) and lines (L, 6), the observations
    (O, 8) and their camera and line indices."""
    rng = np.random.default_rng(seed)
    R_cw, t_wc, pos, tangent = _path_poses(C, spacing)
    band = max(1, int(round(band_m / spacing)))
    L = C * lines_per_anchor

    # landmarks: anchored at path point, lateral offset 3-9 m, random dir
    anchor = np.repeat(np.arange(C), lines_per_anchor)        # (L,)
    lateral = np.cross(np.array([0.0, 1.0, 0.0]), tangent)    # outward-ish
    off_r = rng.uniform(3.0, 9.0, L)[:, None]
    off_s = rng.choice([-1.0, 1.0], L)[:, None]
    off_h = rng.uniform(-2.0, 2.0, L)[:, None]
    p_on = (pos[anchor] + off_s * off_r * lateral[anchor]
            + off_h * np.array([0.0, 1.0, 0.0])
            + rng.uniform(-1.0, 1.0, (L, 3)))                 # point on line
    dv = rng.standard_normal((L, 3))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    # closest point to origin of the infinite line through p_on along dv
    cp = p_on - (np.einsum("lj,lj->l", p_on, dv))[:, None] * dv
    lines_w = np.concatenate([cp, dv], axis=1)                # (L, 6)

    # visibility band: camera c sees lines with anchor in [c-band, c+band]
    # (wraparound on the loop)
    offs = np.arange(-band, band + 1)
    cam_of = (np.arange(C)[:, None, None] + offs[None, :, None]) % C  # C,B,1
    line_of = (cam_of * lines_per_anchor
               + np.arange(lines_per_anchor)[None, None, :])   # C,B,A
    obs_cam = np.repeat(np.arange(C), offs.size * lines_per_anchor)
    obs_line = line_of.reshape(-1)

    # project: line -> camera frame
    Rc = R_cw[obs_cam]                                        # (O,3,3)
    tc = t_wc[obs_cam]
    cpc = np.einsum("oij,oj->oi", Rc, lines_w[obs_line, :3]) + tc
    dvc = np.einsum("oij,oj->oi", Rc, lines_w[obs_line, 3:])

    def endpoints(n, s_mid, s_len):
        d2 = np.sqrt(n[:, 0] ** 2 + n[:, 1] ** 2)
        # a relative degeneracy cut: n scales with the line's distance in
        # the camera frame, and rows whose residual normalization amplifies
        # float32 rounding are dropped (the JAX tool's comment, :100-103)
        nrm = np.linalg.norm(n, axis=1)
        ok = d2 > np.maximum(1e-3, 2e-2 * nrm)
        n = n / np.maximum(d2, 1e-12)[:, None]
        p0 = -n[:, 2:3] * n[:, :2]                            # foot point
        dir2 = np.stack([-n[:, 1], n[:, 0]], axis=1)
        a = p0 + (s_mid - 0.5 * s_len)[:, None] * dir2
        b = p0 + (s_mid + 0.5 * s_len)[:, None] * dir2
        inside = ((np.abs(a[:, 0]) < HALF_W) & (np.abs(a[:, 1]) < HALF_H)
                  & (np.abs(b[:, 0]) < HALF_W) & (np.abs(b[:, 1]) < HALF_H))
        return a, b, ok & inside

    O = len(obs_cam)
    s_mid = rng.uniform(-0.15, 0.15, O)
    s_len = rng.uniform(0.1, 0.4, O)
    n_l = np.cross(cpc, dvc)
    aL, bL, okL = endpoints(n_l, s_mid, s_len)
    cpr = cpc - np.array([0.12, 0.0, 0.0])
    n_r = np.cross(cpr, dvc)
    aR, bR, okR = endpoints(n_r, s_mid, s_len)

    # in front of the camera at the visible span (the closest point of the
    # camera-frame line)
    cp_cam = cpc - np.einsum("oj,oj->o", cpc, dvc)[:, None] * dvc
    ok = okL & okR & (cp_cam[:, 2] > 1.0) & (cp_cam[:, 2] < 40.0)

    obs = np.concatenate([aL, bL, aR, bR], axis=1)            # (O, 8)
    obs += rng.standard_normal(obs.shape) * (noise_px / 406.05)

    obs, obs_cam, obs_line = obs[ok], obs_cam[ok], obs_line[ok]

    # keep only lines observed >= 2 times, and re-index compactly
    cnt = np.bincount(obs_line, minlength=L)
    keep = cnt >= 2
    remap = -np.ones(L, np.int64)
    remap[keep] = np.arange(keep.sum())
    sel = keep[obs_line]
    obs, obs_cam = obs[sel], obs_cam[sel]
    obs_line = remap[obs_line[sel]]
    lines_w = lines_w[keep]

    cam_wt = np.concatenate([
        np.stack([so3_log(R) for R in R_cw]), t_wc], axis=1)  # (C, 6)
    return dict(cam_wt=cam_wt, lines_w=lines_w, obs=obs, obs_cam=obs_cam,
                obs_line=obs_line.astype(np.int64))


def perturb_lines_metric(lines_w, sigma_cp_m, sigma_dir_rad, rng):
    """(cp, dv) lines perturbed in metric space, then re-normalized (real
    initial estimates carry metric triangulation noise; the JAX tool's
    docstring, :160-166, says why not the orthonormal parameters)."""
    cp, dv = lines_w[:, :3].copy(), lines_w[:, 3:].copy()
    L = len(cp)
    dv = dv + rng.standard_normal((L, 3)) * sigma_dir_rad
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    cp = cp + rng.standard_normal((L, 3)) * sigma_cp_m
    cp = cp - np.einsum("lj,lj->l", cp, dv)[:, None] * dv  # re-orthogonalize
    return np.concatenate([cp, dv], axis=1)
