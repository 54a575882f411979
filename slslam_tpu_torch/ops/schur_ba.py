"""Windowed local BA: batched Schur-complement Levenberg-Marquardt.

Port of ``slslam_tpu/ops/schur_ba.py`` (the replacement for the reference's
Ceres solve, slam.cpp:795-975 and lba_problem.{h,cpp}): Huber-robust
residuals, normal equations, Schur elimination of the 4x4 line blocks, a
dense Cholesky on the reduced camera system, and Ceres's trust-region LM
(damping with clamped sqrt(diag JtJ), step acceptance rho > 1e-3, the
radius update, dtype-floored function and parameter tolerances).

Where the JAX package runs one traced ``lax.while_loop``, this port runs a
Python loop that reads the loop condition from the device once per
iteration; ``lines_gn``'s ``lax.scan`` is a fixed 4-step loop.  Every
evaluate goes through K2 (``ops/kernels.py`` ``fused_eval``): the window BA
through its ``full`` variant, the pose-only VO polish through ``cams``,
lines-GN through ``lines``; lines-GN's trial cost reduces with K1
(``segment_sum``).  Each solve builds its segment plan once and hands it to
every LM iteration.  On CPU tensors the kernels' plain twins run.

Not ported (they raise NotImplementedError): ``cam_anchor_sigmas`` and
``prior_edges`` (ROADMAP.md, Queue 1 open items).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels import ba_plan, fused_eval, segment_sum
from .residuals import lba_residual_batch, robust_weights

_MIN_DIAG = 1e-6
_MAX_DIAG = 1e32
_INIT_RADIUS = 1e4
_MIN_RELATIVE_DECREASE = 1e-3
_FUNCTION_TOL = 1e-6
_PARAM_TOL = 1e-8


def _tolerances(dtype, ftol_floor=64.0):
    """Ceres tolerances floored at the dtype's resolution
    (schur_ba.py:52-71): unchanged in f64, 64 eps / 8 eps in f32."""
    eps = float(torch.finfo(dtype).eps)
    return max(_FUNCTION_TOL, ftol_floor * eps), max(_PARAM_TOL, 8.0 * eps)


class BAStats(NamedTuple):
    iterations: torch.Tensor      # successful + unsuccessful LM steps
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def _unported(cam_anchor_sigmas, prior_edges):
    if cam_anchor_sigmas is not None:
        raise NotImplementedError(
            "cam_anchor_sigmas is not ported yet (ROADMAP.md Queue 1, "
            "open items of the port)")
    if prior_edges is not None:
        raise NotImplementedError(
            "prior_edges (Hoff) is not ported yet (ROADMAP.md Queue 1, "
            "open items of the port)")


def _masked_cost(r, w_valid, huber_delta, robust):
    _, cost_i = robust_weights(r, huber_delta, robust)
    return torch.where(w_valid > 0, cost_i, torch.zeros_like(cost_i))


def _eval_system(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                 cam_free_f, line_free_f, baseline, huber_delta, robust,
                 line_param="orth", plan=None):
    """Cost and all normal-equation blocks (schur_ba.py:93-176): K2
    ``full``."""
    return fused_eval(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                      cam_free_f, line_free_f, baseline, huber_delta,
                      robust=robust, line_param=line_param, variant="full",
                      plan=plan)


def _eval_pose_system(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                      cam_free_f, baseline, huber_delta, robust,
                      line_param="orth", plan=None):
    """Camera-only normal equations, the motion-only BA case
    (schur_ba.py:179-209): K2 ``cams``, which is ``full`` with every line
    fixed and never builds the line blocks."""
    return fused_eval(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                      cam_free_f, None, baseline, huber_delta, robust=robust,
                      line_param=line_param, variant="cams", plan=plan)


def _cholesky_solve_batched(H, rhs):
    """Batched Cholesky solve; a failed factorization yields NaN, as
    jax.scipy.linalg.cho_factor does."""
    Lf, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(rhs.unsqueeze(-1), Lf).squeeze(-1)
    bad = (info != 0).unsqueeze(-1)
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def _solve_step_pose(Hcc, gc, lam, cam_free_f):
    """Damped camera-block solve with every line fixed (schur_ba.py:212-238):
    batched equilibrated Cholesky per camera."""
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    diag_c = torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1),
                         _MIN_DIAG, _MAX_DIAG)
    Hcc_d = Hcc + lam * diag_c[..., None] * eye6
    f = cam_free_f[:, None, None]
    Hm = Hcc_d * f + eye6 * (1.0 - f)
    rhs = -gc * cam_free_f[:, None]
    d = torch.sqrt(torch.clamp_min(torch.diagonal(Hm, dim1=-2, dim2=-1),
                                   1e-12))
    di = 1.0 / d
    Hn = Hm * di[..., :, None] * di[..., None, :]
    dc = _cholesky_solve_batched(Hn, rhs * di) * di
    dc = dc * cam_free_f[:, None]
    damp_quad = lam * torch.sum(diag_c * dc * dc)
    g_dot_d = torch.sum(gc * dc)
    return dc, damp_quad, g_dot_d


def _inv4_equilibrated(Hll_d):
    """Jacobi-equilibrated batched 4x4 inverse (schur_ba.py:334-345)."""
    d = torch.sqrt(torch.clamp_min(torch.diagonal(Hll_d, dim1=-2, dim2=-1),
                                   1e-12))
    di = 1.0 / d
    An = Hll_d * di[..., :, None] * di[..., None, :]
    inv, _ = torch.linalg.inv_ex(An)
    return inv * di[..., :, None] * di[..., None, :]


def _cho_solve_equilibrated(S, rhs):
    """Jacobi-equilibrated dense Cholesky solve (schur_ba.py:348-354)."""
    d = torch.sqrt(torch.clamp_min(torch.diagonal(S), 1e-12))
    di = 1.0 / d
    Sn = S * di[:, None] * di[None, :]
    return _cholesky_solve_batched(Sn, rhs * di) * di


def _solve_step(Hcc, Hll, gc, gl, W, lam, cam_free_f, line_free_f):
    """Solve (H + lam D^2) delta = -g by Schur elimination of the lines
    (schur_ba.py:357-409, without the prior-edge Hoff)."""
    C = Hcc.shape[0]
    L = Hll.shape[0]
    dtype, dev = Hcc.dtype, Hcc.device
    diag_c = torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1),
                         _MIN_DIAG, _MAX_DIAG)
    diag_l = torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1),
                         _MIN_DIAG, _MAX_DIAG)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    Binv = _inv4_equilibrated(Hll + lam * diag_l[..., None] * eye4)

    # reduced camera system S (6C x 6C)
    Wm = W.permute(0, 2, 1, 3).reshape(C * 6, L * 4)
    X = torch.einsum("clab,lbd->clad", W, Binv)
    Xm = X.permute(0, 2, 1, 3).reshape(C * 6, L * 4)
    S = -(Xm @ Wm.T)
    Hcc_d = Hcc + lam * diag_c[..., None] * torch.eye(6, dtype=dtype,
                                                      device=dev)
    S = S.reshape(C, 6, C, 6)
    ar = torch.arange(C, device=dev)
    S[ar, :, ar, :] += Hcc_d
    S = S.reshape(C * 6, C * 6)
    rhs = -gc.reshape(-1) + Xm @ gl.reshape(-1)

    # fixed cameras: identity rows/cols, zero rhs
    m = cam_free_f.repeat_interleave(6)
    S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    rhs = rhs * m
    dc = _cho_solve_equilibrated(S, rhs).reshape(C, 6)

    coup = torch.einsum("clab,ca->lb", W, dc)
    dl = -torch.einsum("lab,lb->la", Binv, gl + coup)
    dl = dl * line_free_f[:, None]
    dc = dc * cam_free_f[:, None]
    damp_quad = lam * (torch.sum(diag_c * dc * dc)
                       + torch.sum(diag_l * dl * dl))
    g_dot_d = torch.sum(gc * dc) + torch.sum(gl * dl)
    return dc, dl, damp_quad, g_dot_d


def lines_gn(cam_wt, line_orth, obs, obs_cam, obs_line, obs_valid,
             line_free, baseline, huber_delta, robust=True, iters=4,
             line_param="orth"):
    """Lines-only damped Gauss-Newton, cameras fixed (schur_ba.py:241-326).

    Every line is an independent 4x4 block; a step that does not strictly
    reduce the line's own robust cost (margin 1e-4) is rejected per line.
    Hll|gl|cost come from K2 ``lines``; the trial cost reduces in one K1
    call of 1 lane over the same line plan."""
    C, L = cam_wt.shape[0], line_orth.shape[0]
    dtype, dev = cam_wt.dtype, cam_wt.device
    cam_wt = cam_wt.contiguous()
    w_valid = obs_valid.to(dtype)
    line_free_f = line_free.to(dtype)
    obs_cam = obs_cam.to(torch.int32).contiguous()
    obs_line = obs_line.to(torch.int32).contiguous()
    plan = ba_plan(obs_cam, obs_line, w_valid, C, L, "lines")
    ol = obs_line.long()
    cw = cam_wt[obs_cam.long()]
    eye4 = torch.eye(4, dtype=dtype, device=dev)

    def cost_lines(lo):
        r = lba_residual_batch(cw, lo[ol], obs, baseline,
                               line_param=line_param)
        cost_o = _masked_cost(r, w_valid, huber_delta, robust)
        return segment_sum(cost_o[:, None].contiguous(), plan.line.key, L,
                           plan=plan.line)[:, 0]

    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    lo = line_orth.contiguous()
    for _ in range(iters):
        Hll, gl, cost_l = fused_eval(
            cam_wt, lo, obs, obs_cam, obs_line, w_valid, None, line_free_f,
            baseline, huber_delta, robust=robust, line_param=line_param,
            variant="lines", plan=plan)
        diag_l = torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1),
                             _MIN_DIAG, _MAX_DIAG)
        Binv = _inv4_equilibrated(Hll + lam * diag_l[..., None] * eye4)
        dl = -torch.einsum("lab,lb->la", Binv, gl) * line_free_f[:, None]
        lo_new = lo + dl
        cost_new = cost_lines(lo_new)
        take = torch.logical_and(torch.isfinite(cost_new),
                                 cost_new < cost_l * (1.0 - 1e-4))[:, None]
        take = torch.logical_and(
            take, torch.all(torch.isfinite(lo_new), dim=-1, keepdim=True))
        lo = torch.where(take, lo_new, lo)
    return lo


def local_ba(cam_wt, line_orth, obs, obs_cam, obs_line, obs_valid,
             cam_free, line_free, baseline, huber_delta, robust=True,
             max_iters=10, line_param="orth", pose_only=False,
             cam_anchor_sigmas=None, prior_edges=None):
    """Windowed local BA (schur_ba.py:412-653).  Shapes are padded; the
    arguments are those of the JAX ``local_ba_impl``.  ``pose_only``
    treats every line as fixed and never builds the line blocks (the
    motion-only BA, slam.cpp:578-675).

    Returns (cam_wt', line_orth', BAStats); ``BAStats.iterations`` counts
    LM steps, accepted or not."""
    _unported(cam_anchor_sigmas, prior_edges)
    dtype, dev = cam_wt.dtype, cam_wt.device
    ftol, ptol = _tolerances(dtype)
    cam_free_f = cam_free.to(dtype)
    line_free_f = line_free.to(dtype)
    w_valid = obs_valid.to(dtype)
    obs_cam = obs_cam.to(torch.int32).contiguous()
    obs_line = obs_line.to(torch.int32).contiguous()
    oc, ol = obs_cam.long(), obs_line.long()
    plan = ba_plan(obs_cam, obs_line, w_valid, cam_wt.shape[0],
                   line_orth.shape[0], "cams" if pose_only else "full")

    def cost_only(cw, lo):
        r = lba_residual_batch(cw[oc], lo[ol], obs, baseline,
                               line_param=line_param)
        return torch.sum(_masked_cost(r, w_valid, huber_delta, robust))

    cost0 = cost_only(cam_wt, line_orth)
    cam, line, cost = cam_wt, line_orth, cost0
    radius = torch.tensor(_INIT_RADIUS, dtype=dtype, device=dev)
    dec = torch.tensor(2.0, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    # loop condition of schur_ba.py:581-591, read once per iteration
    while it < max_iters and bool(torch.logical_and(~done,
                                                    torch.isfinite(cost))):
        lam = 1.0 / radius
        if pose_only:
            _, Hcc, gc = _eval_pose_system(
                cam.contiguous(), line.contiguous(), obs, obs_cam, obs_line,
                w_valid, cam_free_f, baseline, huber_delta, robust,
                line_param, plan)
            dc, damp_quad, g_dot_d = _solve_step_pose(Hcc, gc, lam,
                                                      cam_free_f)
            dl = torch.zeros_like(line)
        else:
            _, Hcc, Hll, gc, gl, W = _eval_system(
                cam.contiguous(), line.contiguous(), obs, obs_cam, obs_line,
                w_valid, cam_free_f, line_free_f, baseline, huber_delta,
                robust, line_param, plan)
            dc, dl, damp_quad, g_dot_d = _solve_step(
                Hcc, Hll, gc, gl, W, lam, cam_free_f, line_free_f)

        cam_new = cam + dc
        line_new = line + dl
        cost_new = cost_only(cam_new, line_new)

        model_change = 0.5 * (damp_quad - g_dot_d)
        rho = (cost - cost_new) / torch.clamp_min(model_change, 1e-300)
        accept = torch.logical_and(model_change > 0,
                                   rho > _MIN_RELATIVE_DECREASE)
        accept = torch.logical_and(accept, torch.isfinite(cost_new))

        tmp = 2.0 * rho - 1.0
        radius_acc = radius / torch.clamp_min(1.0 - tmp ** 3, 1.0 / 3.0)
        radius_rej = radius / dec
        radius_new = torch.where(accept, torch.clamp_max(radius_acc, 1e16),
                                 torch.clamp_min(radius_rej, 1e-32))
        dec = torch.where(accept, torch.full_like(dec, 2.0), dec * 2.0)

        fconv = torch.abs(cost - cost_new) <= ftol * cost
        xnorm = torch.sqrt(torch.sum(cam * cam) + torch.sum(line * line))
        snorm = torch.sqrt(torch.sum(dc * dc) + torch.sum(dl * dl))
        pconv = snorm <= ptol * (xnorm + ptol)
        converged = torch.logical_and(accept, torch.logical_or(fconv, pconv))
        done = torch.logical_or(converged, ~(snorm > 0))

        cam = torch.where(accept, cam_new, cam)
        line = torch.where(accept, line_new, line)
        cost = torch.where(accept, cost_new, cost)
        radius = radius_new
        it += 1
    stats = BAStats(torch.tensor(it, dtype=torch.int32, device=dev), cost0,
                    cost)
    return cam, line, stats
