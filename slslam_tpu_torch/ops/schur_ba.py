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

``prior_edges`` fuses pairwise pose constraints into the normal equations
(the deferred loop closure's joint span polish): their residuals and
Jacobians are ``ops/pose_graph.py``'s, their per-camera sums and their
off-diagonal coupling blocks in the reduced camera system are K1 sums over
a fixed block key.  ``cam_anchor_sigmas`` anchors every free camera at its
initial pose (the interactive engine's window anchors): per-camera adds
around K2's output, a diagonal on Hcc, its gradient on gc and its cost in
the trial cost.  ``staged_local_ba`` is lines-GN followed by ``local_ba``,
the interactive engine's window solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels import ba_plan, fused_eval, segment_sum
from .pose_graph import (block_plan, edge_residual, edge_residual_jac,
                         edge_system)
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


class CamAnchor(NamedTuple):
    """A weak Gaussian anchor of every free camera at its initial pose
    (schur_ba.py:479-489): residual weights ``aw`` (6,) = 1/sigma_rot x 3,
    1/sigma_t x 3."""

    pose: torch.Tensor    # (C, 6) the initial cam_wt
    aw: torch.Tensor      # (6,)

    def terms(self, cw, cam_free_f):
        """(cost_a, g_a (C, 6)) at cameras ``cw``."""
        d = (cw - self.pose) * cam_free_f[:, None]
        return 0.5 * torch.sum((d * self.aw) ** 2), d * (self.aw * self.aw)

    def hessian(self, cam_free_f):
        """H_a (C, 6, 6): diag(aw^2) on every free camera."""
        return torch.diag(self.aw * self.aw)[None] * cam_free_f[:, None, None]


def make_cam_anchor(cam_anchor_sigmas, cam_wt):
    """``CamAnchor`` from (sigma_rot, sigma_t) at the initial ``cam_wt``."""
    sr, st = (torch.as_tensor(x, dtype=cam_wt.dtype, device=cam_wt.device)
              for x in cam_anchor_sigmas)
    if not (bool(sr > 0) and bool(st > 0)):
        raise ValueError(f"cam_anchor_sigmas must be positive, got "
                         f"({float(sr)}, {float(st)})")
    one = torch.ones(3, dtype=cam_wt.dtype, device=cam_wt.device)
    return CamAnchor(cam_wt, torch.cat([one / sr, one / st]))


class PriorEdges(NamedTuple):
    """Pose-prior edges of one solve: T_j ~ c T_i, residuals scaled by
    ``scale`` (E, 6), and the K1 plans of their block sums."""

    ei: torch.Tensor      # (E,) long
    ej: torch.Tensor
    c: torch.Tensor       # (E, 6)
    scale: torch.Tensor   # (E, 6)
    plan: object          # pose_graph.BlockPlan over the solve's cameras


def prior_terms(pe: PriorEdges, cw, cam_free_f):
    """(cost, gc_e (C,6), Hcc_e (C,6,6), Hoff (E,6,6)) of the prior edges at
    cameras ``cw`` (schur_ba.py:499-515, schur_cg.py:376-386)."""
    r, J1, J2 = edge_residual_jac(cw[pe.ei], cw[pe.ej], pe.c)
    r = r * pe.scale
    J1 = J1 * pe.scale[:, :, None] * cam_free_f[pe.ei, None, None]
    J2 = J2 * pe.scale[:, :, None] * cam_free_f[pe.ej, None, None]
    Hd, g, Hoff = edge_system(pe.plan, J1, J2, r)
    return 0.5 * torch.sum(r * r), g, Hd, Hoff


def prior_cost(pe: PriorEdges, cw):
    """The prior edges' cost alone (the trial points' cost)."""
    re = edge_residual(cw[pe.ei], cw[pe.ej], pe.c)
    return 0.5 * torch.sum((re * pe.scale) ** 2)


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


def _solve_step(Hcc, Hll, gc, gl, W, lam, cam_free_f, line_free_f,
                Hoff=None, prior=None):
    """Solve (H + lam D^2) delta = -g by Schur elimination of the lines
    (schur_ba.py:357-409).  ``Hoff`` (E,6,6): the prior edges' camera-camera
    coupling, placed in the dense reduced system by one K1 sum over the
    ``"offdiag"`` plan of ``prior`` (a ``PriorEdges``)."""
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
    if Hoff is not None:
        E = Hoff.shape[0]
        rows = torch.cat([Hoff, Hoff.transpose(1, 2)]).reshape(2 * E, 36)
        off = segment_sum(rows.contiguous(), prior.plan.hkey, C * C,
                          plan=prior.plan.hplan)
        S = S + off.reshape(C, C, 6, 6).permute(0, 2, 1, 3)
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


def make_prior_edges(prior_edges, C, dtype, device, blocks=None):
    """``PriorEdges`` from (ei, ej, c, sig) arrays or tensors over C
    cameras; ``blocks``: the block plan's kind (``"offdiag"`` for the dense
    reduced system, None for the PCG)."""
    ei, ej, c, sig = (torch.as_tensor(x, device=device) for x in prior_edges)
    E = ei.shape[0]
    if not (ej.shape == (E,) and tuple(c.shape) == (E, 6)
            and tuple(sig.shape) == (E, 2)):
        raise ValueError(f"prior_edges shapes {tuple(ei.shape)}, "
                         f"{tuple(ej.shape)}, {tuple(c.shape)}, "
                         f"{tuple(sig.shape)}; expected (E,), (E,), (E, 6), "
                         "(E, 2)")
    ei, ej, sig = ei.long(), ej.long(), sig.to(dtype)
    # per-edge (sigma_rot, sigma_t) -> (E, 6) residual weights
    # (schur_ba.py:494-497)
    scale = torch.cat([1.0 / sig[:, 0:1].repeat(1, 3),
                       1.0 / sig[:, 1:2].repeat(1, 3)], dim=1)
    return PriorEdges(ei, ej, c.to(dtype), scale,
                      block_plan(ei, ej, C, blocks))


def local_ba(cam_wt, line_orth, obs, obs_cam, obs_line, obs_valid,
             cam_free, line_free, baseline, huber_delta, robust=True,
             max_iters=10, line_param="orth", pose_only=False,
             cam_anchor_sigmas=None, prior_edges=None):
    """Windowed local BA (schur_ba.py:412-653).  Shapes are padded; the
    arguments are those of the JAX ``local_ba_impl``.  ``pose_only``
    treats every line as fixed and never builds the line blocks (the
    motion-only BA, slam.cpp:578-675).

    ``prior_edges``: (ei (E,), ej (E,), c (E,6), sig (E,2)), pairwise pose
    constraints T_j ~ c T_i with per-edge (sigma_rot, sigma_t)
    (schur_ba.py:435-447); pad with zero-weight self-edges (sig ~ 1e9).

    ``cam_anchor_sigmas``: (sigma_rot, sigma_t), a weak Gaussian anchor of
    every free camera at its initial pose (schur_ba.py:448-459, 479-489).

    Returns (cam_wt', line_orth', BAStats); ``BAStats.iterations`` counts
    LM steps, accepted or not."""
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
    prior = None
    if prior_edges is not None:
        if pose_only:
            raise ValueError("prior_edges needs the full solve path, not "
                             "pose_only")
        prior = make_prior_edges(prior_edges, cam_wt.shape[0], dtype, dev,
                                 blocks="offdiag")
    anchor = None
    if cam_anchor_sigmas is not None:
        anchor = make_cam_anchor(cam_anchor_sigmas, cam_wt)
        H_a = anchor.hessian(cam_free_f)

    def cost_only(cw, lo):
        r = lba_residual_batch(cw[oc], lo[ol], obs, baseline,
                               line_param=line_param)
        cost = torch.sum(_masked_cost(r, w_valid, huber_delta, robust))
        if anchor is not None:
            cost = cost + anchor.terms(cw, cam_free_f)[0]
        if prior is not None:
            # the full (unmasked) residual, as prior_terms' cost
            cost = cost + prior_cost(prior, cw)
        return cost

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
            if anchor is not None:
                Hcc, gc = Hcc + H_a, gc + anchor.terms(cam, cam_free_f)[1]
            dc, damp_quad, g_dot_d = _solve_step_pose(Hcc, gc, lam,
                                                      cam_free_f)
            dl = torch.zeros_like(line)
        else:
            _, Hcc, Hll, gc, gl, W = _eval_system(
                cam.contiguous(), line.contiguous(), obs, obs_cam, obs_line,
                w_valid, cam_free_f, line_free_f, baseline, huber_delta,
                robust, line_param, plan)
            if anchor is not None:
                Hcc, gc = Hcc + H_a, gc + anchor.terms(cam, cam_free_f)[1]
            Hoff = None
            if prior is not None:
                _, gc_e, Hcc_e, Hoff = prior_terms(prior, cam, cam_free_f)
                Hcc, gc = Hcc + Hcc_e, gc + gc_e
            dc, dl, damp_quad, g_dot_d = _solve_step(
                Hcc, Hll, gc, gl, W, lam, cam_free_f, line_free_f, Hoff,
                prior)

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


def staged_local_ba(cam_wt, line_orth, obs, obs_cam, obs_line, obs_valid,
                    cam_free, line_free, baseline, huber_delta, robust=True,
                    max_iters=10, line_param="orth", gn_iters=4,
                    cam_anchor_sigmas=None, gn_free=None):
    """lines-GN pre-stage, then ``local_ba`` (schur_ba.py:661-682): the
    interactive engine's window solve.  ``gn_free`` restricts the pre-stage
    to a subset of lines; default ``line_free``."""
    if gn_iters > 0:
        line_orth = lines_gn(cam_wt, line_orth, obs, obs_cam, obs_line,
                             obs_valid,
                             line_free if gn_free is None else gn_free,
                             baseline, huber_delta, robust=robust,
                             iters=gn_iters, line_param=line_param)
    return local_ba(cam_wt, line_orth, obs, obs_cam, obs_line, obs_valid,
                    cam_free, line_free, baseline, huber_delta, robust=robust,
                    max_iters=max_iters, line_param=line_param,
                    cam_anchor_sigmas=cam_anchor_sigmas)
