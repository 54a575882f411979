"""Plain reference of the survey map's global bundle adjustment.

A straightforward PyTorch implementation of the solve that the survey
cells time, written from its definition and sharing no code with the
port:

* the residual of one observation is the four signed distances of its
  endpoints (left pair, then right pair) to the line's projection in the
  left camera and in the right camera 0.12 m to its right
  (ceres LineReprojectionError, the reference's lba_problem.h:41-121);
  a camera is (angle-axis w, translation t), world to camera; a line is
  the orthonormal 4-vector (alpha, beta, gamma, theta) of gc.cpp:419-460;
* the cost is half the sum of Huber's rho of each row's squared residual
  norm, and the normal equations weigh each row by sqrt(rho');
* one LM iteration evaluates the Jacobians (``torch.func.jacfwd`` under
  ``vmap``, one row at a time), eliminates the lines (the Schur
  complement, never formed), solves the reduced camera system by PCG with
  the exact 6 x 6 diagonal blocks as preconditioner (Ceres's
  SCHUR_JACOBI), stops the PCG at ||r|| <= eta ||rhs|| (Ceres's eta
  forcing) or after ``cg_iters`` iterations, back-substitutes the lines,
  and takes or rejects the step by Ceres's trust-region rule; it stops
  after ``max_iters`` iterations or when the cost or the step stops
  moving (Ceres's function and parameter tolerances, floored at the
  dtype's resolution).

It works on the flat valid observations (no padding).  ``solve`` runs in
float64 for the reference, and for the control in float32 with every
matrix product computed as TF32 computes it (``Problem(..., tf32=True)``:
each product's operands rounded to 10 mantissa bits; the card's TF32
mode alone changes none of these small batched products).
"""

from __future__ import annotations

import math

import torch

MIN_DIAG, MAX_DIAG = 1e-6, 1e32
INIT_RADIUS = 1e4
MIN_RELATIVE_DECREASE = 1e-3
FUNCTION_TOL, PARAM_TOL = 1e-6, 1e-8


def round_tf32(x):
    """``x`` with each value's mantissa rounded to nearest at TF32's 10
    bits: the operand that a TF32 tensor-core product multiplies.  Under
    ``torch.func`` the tangent passes through unchanged."""
    p = x.detach()
    a = torch.abs(p)
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    scale = torch.exp2(e - 10.0)
    return x + (torch.where(a > 0, torch.round(p / scale) * scale, p) - p)


def matmul(a, b, tf32=False):
    """a @ b; with ``tf32`` as a TF32 product computes it (operands
    rounded to 10 mantissa bits, float32 sums)."""
    if tf32:
        return round_tf32(a) @ round_tf32(b)
    return a @ b


def tolerances(dtype):
    """Ceres's tolerances, floored at 64 and 8 epsilons of ``dtype``."""
    eps = torch.finfo(dtype).eps
    return max(FUNCTION_TOL, 64.0 * eps), max(PARAM_TOL, 8.0 * eps)


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def rotation(w, tf32=False):
    """Rodrigues' formula, (..., 3) -> (..., 3, 3), with its series below
    theta^2 = 1e-16."""
    th2 = torch.sum(w * w, -1)[..., None, None]
    small = th2 < 1e-16
    safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(safe)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / safe)
    K = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * matmul(K, K, tf32)


def line_from_orth(o):
    """Orthonormal 4-vector -> (closest point, direction)."""
    s1, c1 = torch.sin(o[..., 0]), torch.cos(o[..., 0])
    s2, c2 = torch.sin(o[..., 1]), torch.cos(o[..., 1])
    s3, c3 = torch.sin(o[..., 2]), torch.cos(o[..., 2])
    col1 = torch.stack([s1 * s2 * c3 - c1 * s3, s1 * s2 * s3 + c1 * c3,
                        s1 * c2], -1)
    col2 = torch.stack([c1 * s2 * c3 + s1 * s3, c1 * s2 * s3 - s1 * c3,
                        c1 * c2], -1)
    th = o[..., 3:]
    return -col2 * (torch.cos(th) / torch.sin(th)), col1


def residual(cam, orth, obs, baseline, tf32=False):
    """(..., 6), (..., 4), (..., 8) -> (..., 4)."""
    return residual_line(cam, *line_from_orth(orth), obs, baseline, tf32)


def residual_line(cam, cp, dv, obs, baseline, tf32=False):
    """The residual of a line given by a point ``cp`` and a direction
    ``dv`` (..., 3) in the world.  Every per-row value keeps a trailing
    axis: under ``vmap`` and ``jacfwd`` a per-row 0-d value met with a
    Python number turns float32 tangents into float64."""
    R = rotation(cam[..., :3], tf32)
    p = matmul(R, cp[..., None], tf32)[..., 0] + cam[..., 3:]
    d = matmul(R, dv[..., None], tf32)[..., 0]
    right = torch.tensor([baseline, 0.0, 0.0], dtype=p.dtype, device=p.device)
    out = []
    for q, first in ((p, 0), (p - right, 4)):
        n = torch.linalg.cross(q, d)
        n = n / torch.clamp_min(torch.linalg.vector_norm(
            n[..., :2], dim=-1, keepdim=True), 1e-12)
        ends = obs[..., first:first + 4].reshape(*obs.shape[:-1], 2, 2)
        out.append(-(torch.sum(ends * n[..., None, :2], -1) + n[..., 2:]))
    return torch.cat(out, -1)


def huber(r, delta):
    """(sqrt(rho'), rho / 2) of each row's squared residual norm."""
    s = torch.sum(r * r, -1)
    far = s > delta * delta
    root = torch.sqrt(torch.where(far, s, torch.ones_like(s)))
    rho = torch.where(far, 2.0 * delta * root - delta * delta, s)
    w = torch.where(far, delta / root, torch.ones_like(s))
    return torch.sqrt(w), 0.5 * rho


class Problem:
    """The flat valid observations of one map on ``device`` in ``dtype``:
    obs (O, 8), their camera and line indices, the fixed first camera."""

    def __init__(self, obs, obs_cam, obs_line, num_cams, num_lines,
                 baseline, huber_delta, dtype, device, rows=262_144,
                 tf32=False):
        self.obs = torch.as_tensor(obs, dtype=dtype, device=device)
        self.cam_idx = torch.as_tensor(obs_cam, device=device).long()
        self.line_idx = torch.as_tensor(obs_line, device=device).long()
        self.C, self.L = int(num_cams), int(num_lines)
        self.baseline, self.delta = float(baseline), float(huber_delta)
        self.dtype, self.device = dtype, device
        self.rows = rows
        self.tf32 = tf32
        free = torch.ones(self.C, dtype=dtype, device=device)
        free[0] = 0.0
        self.cam_free = free
        self._jac = torch.func.vmap(torch.func.jacfwd(
            lambda c, o, ob: (residual(c, o, ob, self.baseline, tf32),) * 2,
            argnums=(0, 1), has_aux=True))

    def _blocks(self):
        O = self.obs.shape[0]
        for a in range(0, O, self.rows):
            yield slice(a, min(O, a + self.rows))

    def cost(self, cam, orth):
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for s in self._blocks():
            r = residual(cam[self.cam_idx[s]], orth[self.line_idx[s]],
                         self.obs[s], self.baseline, self.tf32)
            total = total + torch.sum(huber(r, self.delta)[1])
        return total

    def evaluate(self, cam, orth):
        """cost, Hcc (C,6,6), gc (C,6), Hll (L,4,4), gl (L,4) and the
        per-row coupling Wb (O,6,4), the first camera's columns zero."""
        C, L, dt, dev = self.C, self.L, self.dtype, self.device
        Hcc = torch.zeros(C, 6, 6, dtype=dt, device=dev)
        gc = torch.zeros(C, 6, dtype=dt, device=dev)
        Hll = torch.zeros(L, 4, 4, dtype=dt, device=dev)
        gl = torch.zeros(L, 4, dtype=dt, device=dev)
        Wb = torch.empty(self.obs.shape[0], 6, 4, dtype=dt, device=dev)
        cost = torch.zeros((), dtype=dt, device=dev)

        def mm(a, b):
            return matmul(a, b, self.tf32)
        for s in self._blocks():
            ci, li = self.cam_idx[s], self.line_idx[s]
            (Jc, Jl), r = self._jac(cam[ci], orth[li], self.obs[s])
            w, rho = huber(r, self.delta)
            cost = cost + torch.sum(rho)
            r = r * w[:, None]
            Jc = torch.where(self.cam_free[ci][:, None, None] > 0,
                             Jc * w[:, None, None], torch.zeros_like(Jc))
            Jl = Jl * w[:, None, None]
            JcT, JlT = Jc.transpose(1, 2), Jl.transpose(1, 2)
            Hcc.index_add_(0, ci, mm(JcT, Jc))
            gc.index_add_(0, ci, mm(JcT, r[..., None])[..., 0])
            Hll.index_add_(0, li, mm(JlT, Jl))
            gl.index_add_(0, li, mm(JlT, r[..., None])[..., 0])
            Wb[s] = mm(JcT, Jl)
        return cost, Hcc, gc, Hll, gl, Wb


def inv_equilibrated(A):
    """Batched inverse of a symmetric positive block, scaled to a unit
    diagonal first."""
    d = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(A, 0, -2, -1),
                                         1e-12))
    scale = d[..., :, None] * d[..., None, :]
    return torch.linalg.inv(A * scale) * scale


def damped_step(P, Hcc, gc, Hll, gl, Wb, lam, cg_iters, eta):
    """The damped Gauss-Newton step by Schur complement and PCG: (dc, dl,
    lam (dc' D_c dc + dl' D_l dl), g . d, PCG iterations)."""
    C, dt, dev = P.C, P.dtype, P.device

    def mm(a, b):
        return matmul(a, b, P.tf32)
    ci, li = P.cam_idx, P.line_idx
    m = P.cam_free[:, None]
    dc_diag = torch.clamp(torch.diagonal(Hcc, 0, -2, -1), MIN_DIAG, MAX_DIAG)
    dl_diag = torch.clamp(torch.diagonal(Hll, 0, -2, -1), MIN_DIAG, MAX_DIAG)
    Binv = inv_equilibrated(Hll + lam * torch.diag_embed(dl_diag))
    Hd = Hcc + lam * torch.diag_embed(dc_diag)

    def cams_sum(rows, D):
        out = torch.zeros(C, *D, dtype=dt, device=dev)
        return out.index_add_(0, ci, rows)

    def lines_of(x):
        """Binv (sum over each line's rows of Wb^T x_m[cam])."""
        z = torch.zeros(P.L, 4, dtype=dt, device=dev)
        z.index_add_(0, li, mm(Wb.transpose(1, 2), (x * m)[ci][..., None])
                     [..., 0])
        return mm(Binv, z[..., None])[..., 0], z

    def S(x):
        w, _ = lines_of(x)
        v = cams_sum(mm(Wb, w[li][..., None])[..., 0], (6,))
        return (mm(Hd, (x * m)[..., None])[..., 0] - v) * m + x * (1.0 - m)

    wg = mm(Binv, gl[..., None])[..., 0]
    rhs = (-gc + cams_sum(mm(Wb, wg[li][..., None])[..., 0], (6,))) * m
    T = cams_sum(mm(mm(Wb, Binv[li]), Wb.transpose(1, 2)), (6, 6))
    eye = torch.eye(6, dtype=dt, device=dev)
    Minv = inv_equilibrated(torch.where(m[..., None] > 0, Hd - T, eye))

    x = torch.zeros_like(rhs)
    r = rhs
    z = mm(Minv, r[..., None])[..., 0]
    p = z
    rz = torch.sum(r * z)
    tol2 = eta * eta * torch.sum(rhs * rhs)
    it = 0
    while it < cg_iters and bool(torch.sum(r * r) > tol2):
        Ap = S(p)
        pAp = torch.sum(p * Ap)
        alpha = rz / pAp if bool(pAp > 0) else torch.zeros_like(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = mm(Minv, r[..., None])[..., 0]
        rz_new = torch.sum(r * z)
        beta = rz_new / rz if bool(rz != 0) else torch.ones_like(rz)
        p = z + beta * p
        rz = rz_new
        it += 1
    dc = x * m
    _, coup = lines_of(dc)
    dl = -mm(Binv, (gl + coup)[..., None])[..., 0]
    quad = lam * (torch.sum(dc_diag * dc * dc) + torch.sum(dl_diag * dl * dl))
    g_dot_d = torch.sum(gc * dc) + torch.sum(gl * dl)
    return dc, dl, quad, g_dot_d, it


def solve(P, cam, orth, max_iters, cg_iters, eta, tol_dtype=None,
          record=None, keep=0):
    """LM from (cam, orth): (cam, orth, initial cost, final cost, LM
    iterations, PCG iterations), the costs as Python floats.
    ``tol_dtype``: the dtype whose resolution floors the stopping
    tolerances (the solve's own by default).  ``record``: a list that
    gets one dict an LM iteration, its PCG iterations (``pcg``), the
    cost after it (``cost``) and, for the first ``keep`` iterations, the
    cameras and lines after it (``cam``, ``orth``)."""
    ftol, ptol = tolerances(tol_dtype or P.dtype)
    cost = P.cost(cam, orth)
    cost0 = float(cost)
    radius, dec = INIT_RADIUS, 2.0
    it = pcg = 0
    while it < max_iters and math.isfinite(float(cost)):
        c, Hcc, gc, Hll, gl, Wb = P.evaluate(cam, orth)
        dc, dl, quad, gd, n = damped_step(P, Hcc, gc, Hll, gl, Wb,
                                          1.0 / radius, cg_iters, eta)
        del Hcc, Hll, Wb
        pcg += n
        cam_new, orth_new = cam + dc, orth + dl
        cost_new = P.cost(cam_new, orth_new)
        model = float(0.5 * (quad - gd))
        rho = float(cost - cost_new) / max(model, 1e-300)
        accept = (model > 0 and rho > MIN_RELATIVE_DECREASE
                  and math.isfinite(float(cost_new)))
        if accept:
            radius = min(radius / max(1.0 - (2.0 * rho - 1.0) ** 3,
                                      1.0 / 3.0), 1e16)
            dec = 2.0
        else:
            radius = max(radius / dec, 1e-32)
            dec *= 2.0
        fconv = abs(float(cost - cost_new)) <= ftol * float(cost)
        xnorm = math.sqrt(float(torch.sum(cam * cam) + torch.sum(orth * orth)))
        snorm = math.sqrt(float(torch.sum(dc * dc) + torch.sum(dl * dl)))
        it += 1
        if accept:
            cam, orth, cost = cam_new, orth_new, cost_new
        if record is not None:
            record.append({"pcg": n, "cost": float(cost)})
            if it <= keep:
                record[-1].update(cam=cam, orth=orth)
        if (accept and (fconv or snorm <= ptol * (xnorm + ptol))) \
                or not snorm > 0:
            break
    return cam, orth, cost0, float(cost), it, pcg
