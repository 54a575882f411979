"""Large-scale bundle adjustment: matrix-free Schur solve with PCG.

Port of ``slslam_tpu/ops/schur_cg.py``, the analog of Ceres's
ITERATIVE_SCHUR with the SCHUR_JACOBI preconditioner that the global
refine (``engine/refine.py``) runs.  See the JAX module's docstring for the
design; in short:

* observations live in a line-major bucketed layout, (L, kL) padded rows,
  one bucket per line (``pack_line_major``, a copy of :49-111): per-line
  reductions are dense sums over the bucket axis;
* the reduced camera system S = Hcc_d - W Binv W^T is never built: PCG runs
  on it with a matvec over the per-row coupling blocks Wb (L, kL, 6, 4);
* the preconditioner is the exact 6x6 diagonal blocks of S;
* the LM trust-region loop is ``ops/schur_ba.py``'s, and the inner CG
  stops by Ceres's eta forcing (||r|| <= eta ||rhs||).

On Hopper the evaluate is K2's ``lm`` variant (``ops/kernels.py``), one
launch per LM iteration, and the trial cost, the robust cost alone at the
start and at each LM trial point, is K2's ``cost`` variant, one launch
over the line plan's valid rows.  The PCG's work over rows is K3 and K4
over the solve's camera and line plans, built once per solve
(``ba_plan(..., "lm")``): the right-hand side is one K3 camera pass, the
SCHUR_JACOBI blocks one K4 launch, the whole PCG loop one K3
``schur_pcg`` launch (its matvecs, preconditioner, dot products and stop
test on the device) and the back-substitution's coupling one K3 line
pass, each reading only the valid rows.  Where JAX gathers through the (C, kC) camera permutation,
this port reads the camera plan, so ``cam_perm`` is not an argument of
the solver.  The LM loop is a Python loop that reads its condition from
the device once per LM iteration; a damped step reads nothing, and its
PCG count stays on the device.  On CPU tensors the kernels' plain twins
run: the JAX module's einsums, the PCG as a Python loop.

The pose priors (``prior_c``, the odometry chain, and ``prior_edges``,
general pose constraints such as loop edges) take their residuals and
Jacobians from ``ops/pose_graph.py``; their per-camera sums are K1 sums
over the edges' node plan once per LM iteration, and their off-diagonal
coupling enters each PCG matvec inside ``schur_pcg``, over the same plan.

Spans and a counter (``utils/trace.py``; off by default; read by
``profile_replay.py``, joined to a profile by
``benchmark/harness/spans.py``):

* ``ba.solve``: one ``global_ba_cg`` call (attrs C, L, O = L kL rows,
  max_iters, cg_iters), the root of the others;
* ``ba.start``: the plans, the priors' edges and the start's cost;
* ``ba.read``: each read of the loop condition, the one host-device
  synchronisation of an LM iteration;
* ``ba.iter``: one LM iteration's body (attr k), holding
  ``ba.evaluate`` (K2 ``lm`` and the priors' terms), ``ba.step``
  (``_solve_step_cg``: ``ba.step.blocks``, the damped blocks and the
  right-hand side; ``ba.step.precond``, K4 and the 6x6 inverses;
  ``ba.step.pcg``, K3 ``schur_pcg``; ``ba.step.backsub``, the line
  updates and the step's reductions), ``ba.trial_cost`` and
  ``ba.update`` (the accept, radius and convergence arithmetic);
* counter ``ba.pcg_iters``: each LM step's PCG iterations, in order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import trace
from .kernels import (ba_plan, fused_cost, fused_eval, schur_jacobi,
                      schur_matvec_cam, schur_matvec_line, schur_pcg)
from .schur_ba import (_INIT_RADIUS, _MAX_DIAG, _MIN_DIAG,
                       _MIN_RELATIVE_DECREASE, _inv4_equilibrated,
                       _tolerances, make_prior_edges, prior_cost,
                       prior_terms)


# ---------------------------------------------------------------------------
# Host-side layout builder (a copy of slslam_tpu/ops/schur_cg.py:49-111;
# tests/test_torch_schur_cg.py checks that it packs identically)
# ---------------------------------------------------------------------------

class LineMajorProblem(NamedTuple):
    """Bucketed BA problem (host numpy; pass to global_ba_cg as tensors)."""

    obs: np.ndarray        # (L, kL, 8)
    obs_cam: np.ndarray    # (L, kL) int32 camera index per observation
    obs_valid: np.ndarray  # (L, kL) bool
    cam_perm: np.ndarray   # (C, kC) int32 flat index into L*kL
    cam_perm_valid: np.ndarray  # (C, kC) bool
    kL: int
    kC: int
    fill: float            # valid / padded observation ratio


def pack_line_major(obs, obs_cam, obs_line, num_cams, num_lines,
                    round_to: int = 8, k_l=None, k_c=None) -> LineMajorProblem:
    """Bucket flat observations by line + build the camera permutation.

    obs (O, 8), obs_cam (O,), obs_line (O,) — valid observations only.
    Bucket sizes are padded to multiples of ``round_to`` for friendly
    tiling.  ``k_l`` / ``k_c`` force the bucket sizes (must be >= the
    natural ones) so several problems share a layout.
    """
    obs = np.asarray(obs, np.float64).reshape(-1, 8)
    obs_cam = np.asarray(obs_cam, np.int64)
    obs_line = np.asarray(obs_line, np.int64)
    O = len(obs)
    C, L = int(num_cams), int(num_lines)

    cnt_l = np.bincount(obs_line, minlength=L)
    cnt_c = np.bincount(obs_cam, minlength=C)
    rnd = lambda n: max(round_to, int(-(-n // round_to) * round_to))
    kL = int(k_l) if k_l else rnd(int(cnt_l.max()) if O else 1)
    kC = int(k_c) if k_c else rnd(int(cnt_c.max()) if O else 1)
    if O and not (kL >= cnt_l.max() and kC >= cnt_c.max()):
        raise ValueError(f"bucket sizes {(kL, kC)} below the counts "
                         f"{(int(cnt_l.max()), int(cnt_c.max()))}")

    ob = np.zeros((L, kL, 8))
    oc = np.zeros((L, kL), np.int32)
    ov = np.zeros((L, kL), bool)
    # slot within bucket = rank among observations of the same line
    # (vectorized: stable sort by line, then index minus group start)
    order = np.argsort(obs_line, kind="stable")
    ls = obs_line[order]
    start_l = np.searchsorted(ls, np.arange(L))
    slot = np.arange(O) - start_l[ls] if O else np.zeros(0, np.int64)
    ob[ls, slot] = obs[order]
    oc[ls, slot] = obs_cam[order]
    ov[ls, slot] = True
    flat_of = np.empty(O, np.int64)
    flat_of[order] = ls * kL + slot

    cp = np.zeros((C, kC), np.int32)
    cpv = np.zeros((C, kC), bool)
    order_c = np.argsort(obs_cam, kind="stable")
    cs = obs_cam[order_c]
    start_c = np.searchsorted(cs, np.arange(C))
    slot_c = np.arange(O) - start_c[cs] if O else np.zeros(0, np.int64)
    cp[cs, slot_c] = flat_of[order_c]
    cpv[cs, slot_c] = True

    fill = O / max(L * kL, 1)
    return LineMajorProblem(ob, oc, ov, cp, cpv, kL, kC, fill)


class CGStats(NamedTuple):
    iterations: torch.Tensor      # LM steps, accepted or not
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    cg_iterations: torch.Tensor   # PCG iterations over all LM steps


# ---------------------------------------------------------------------------
# System evaluation (residuals + blocks, no dense W)
# ---------------------------------------------------------------------------

def _line_rows(L, kL, device):
    """obs_line of the flat line-major rows: row l kL + k is line l's."""
    return torch.arange(L, dtype=torch.int32,
                        device=device).repeat_interleave(kL)


def lm_plan(obs_cam, w_valid, num_cams):
    """The camera and line plans of a line-major problem's valid rows,
    obs_cam and w_valid (L, kL): ``ba_plan(..., "lm")`` on the flat rows.
    A solve builds it once."""
    L, kL = obs_cam.shape
    return ba_plan(obs_cam.reshape(-1).to(torch.int32).contiguous(),
                   _line_rows(L, kL, obs_cam.device),
                   w_valid.reshape(-1), num_cams, L, "lm")


def _eval_system_lm(cam_wt, line_orth, obs, obs_cam, w_valid, cam_free_f,
                    line_free_f, baseline, huber_delta, robust,
                    line_param="orth", plan=None):
    """Blocks for the bucketed layout (schur_cg.py:118-166): K2 ``lm`` on
    the flat (L kL) rows.

    obs (L, kL, 8), obs_cam (L, kL), w_valid (L, kL) ->  cost, Hcc (C,6,6),
    Hll (L,4,4), gc (C,6), gl (L,4), Wb (L,kL,6,4).  Padded observations
    contribute exact zeros, so gathers need no re-masking.  ``plan``:
    ``lm_plan(obs_cam, w_valid, C)``."""
    L, kL = obs.shape[:2]
    cost, Hcc, Hll, gc, gl, Wb = fused_eval(
        cam_wt, line_orth, obs.reshape(L * kL, 8),
        obs_cam.reshape(-1).to(torch.int32).contiguous(),
        _line_rows(L, kL, obs.device), w_valid.reshape(-1), cam_free_f,
        line_free_f, baseline, huber_delta, robust=robust,
        line_param=line_param, variant="lm", plan=plan)
    return cost, Hcc, Hll, gc, gl, Wb.reshape(L, kL, 6, 4)


def _cost_lm(cam_wt, line_orth, obs, obs_cam, w_valid, baseline,
             huber_delta, robust, line_param="orth", plan=None):
    """The robust cost alone, for LM's trial points (schur_cg.py:394-406
    without the priors): K2 ``cost`` over the valid rows, residuals only.
    ``plan``: ``lm_plan(obs_cam, w_valid, C)``, the solve's; without one
    the line plan is built here.  The line plan's key is each flat row's
    line (L on the rows it drops), so with a plan no row index is made."""
    L, kL = obs.shape[:2]
    obs_line = (_line_rows(L, kL, obs.device) if plan is None
                else plan.line.key)
    return fused_cost(cam_wt.contiguous(), line_orth.contiguous(),
                      obs.reshape(L * kL, 8),
                      obs_cam.reshape(-1).to(torch.int32).contiguous(),
                      obs_line, w_valid.reshape(-1), baseline, huber_delta,
                      robust=robust, line_param=line_param, plan=plan)


# ---------------------------------------------------------------------------
# Matrix-free Schur solve (PCG with SCHUR_JACOBI preconditioner)
# ---------------------------------------------------------------------------

def damped_blocks(Hcc, Hll, lam):
    """The LM-damped blocks of one step (schur_cg.py:180-187): the clamped
    diagonals diag_c (C,6) and diag_l (L,4), Binv = (Hll + lam D_l)^-1
    (L,4,4) by the equilibrated inverse, and Hcc_d = Hcc + lam D_c
    (C,6,6), both contiguous."""
    dtype, dev = Hcc.dtype, Hcc.device
    diag_c = torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1),
                         _MIN_DIAG, _MAX_DIAG)
    diag_l = torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1),
                         _MIN_DIAG, _MAX_DIAG)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Binv = _inv4_equilibrated(Hll + lam * diag_l[..., None]
                              * eye4).contiguous()
    Hcc_d = (Hcc + lam * diag_c[..., None] * eye6).contiguous()
    return diag_c, diag_l, Binv, Hcc_d


def _solve_step_cg(Hcc, Hll, gc, gl, Wb, obs_cam, cam_plan, lam,
                   cam_free_f, line_free_f, cg_iters, eta, Hoff=None,
                   prior=None, line_plan=None):
    """(H + lam D^2) delta = -g by PCG on the reduced camera system
    (schur_cg.py:173-277).  ``cam_plan`` and ``line_plan``: the camera and
    line plans of the valid rows (``lm_plan``); the kernels read them, the
    CPU twins the camera plan's key only.  The right-hand side is a K3
    camera pass, the preconditioner's blocks one K4 launch, the PCG one
    K3 ``schur_pcg`` launch, the back-substitution's coupling a line pass.
    ``Hoff`` (E,6,6): the pose priors' coupling of cameras (ei, ej) of
    ``prior`` (a ``schur_ba.PriorEdges``), added to each matvec over the
    edges' node plan.  Returns (dc, dl, damp_quad, g_dot_d, PCG
    iterations), the last a 0-d int32 tensor on the blocks' device; on
    the card nothing here reads the device from the host."""
    with trace.span("ba.step.blocks"):
        oc = obs_cam.to(torch.int32).contiguous()
        Wb = Wb.contiguous()
        diag_c, diag_l, Binv, Hcc_d = damped_blocks(Hcc, Hll, lam)
        mf = cam_free_f.contiguous()
        m = mf[:, None]                                    # (C,1)

        # rhs = -gc + W Binv gl
        w0 = torch.einsum("lab,lb->la", Binv, gl).contiguous()
        rhs = schur_matvec_cam(Wb, w0, mf, cam_plan, gc=gc.contiguous())

    # SCHUR_JACOBI: exact 6x6 diagonal blocks of S (one obs per (cam,line)
    # pair, so only the camera's own rows contribute)
    with trace.span("ba.step.precond"):
        Minv = _inv4_equilibrated(schur_jacobi(Wb, Binv, Hcc_d, mf,
                                               cam_plan)).contiguous()

    # PCG (Ceres eta forcing: stop at ||r|| <= eta * ||rhs||)
    with trace.span("ba.step.pcg"):
        x, it = schur_pcg(rhs, Minv, Wb, oc, mf, Binv, Hcc_d, cam_plan,
                          line_plan, cg_iters, eta,
                          None if Hoff is None else Hoff.contiguous(),
                          None if Hoff is None else prior.plan)

    # back-substitute line updates: coup = W^T dc, K3's line pass
    with trace.span("ba.step.backsub"):
        dc = x * m
        _, coup = schur_matvec_line(Wb, oc, dc.contiguous(), mf, Binv,
                                    line_plan)
        dl = -torch.einsum("lab,lb->la", Binv, gl + coup)
        dl = dl * line_free_f[:, None]

        damp_quad = lam * (torch.sum(diag_c * dc * dc)
                           + torch.sum(diag_l * dl * dl))
        g_dot_d = torch.sum(gc * dc) + torch.sum(gl * dl)
    return dc, dl, damp_quad, g_dot_d, it


def _prior_edges(C, prior_c, prior_edges, sigma_rot, sigma_t, dtype, dev):
    """The chain prior and the general edges as one ``PriorEdges`` block
    (schur_cg.py:322-366): chain edges (i, i + 1) first, with the scalar
    sigmas; ``prior_edges`` (ei, ej, c) with the scalar sigmas, or
    (ei, ej, c, sig) with per-edge (sigma_rot, sigma_t)."""
    parts = []

    def sig_of(n):
        return torch.tensor([[sigma_rot, sigma_t]], dtype=dtype,
                            device=dev).expand(n, 2)

    if prior_c is not None:
        c = torch.as_tensor(prior_c, dtype=dtype, device=dev)
        if tuple(c.shape) != (C - 1, 6):
            raise ValueError(f"prior_c has shape {tuple(c.shape)}, expected "
                             f"({C - 1}, 6)")
        ar = torch.arange(C, device=dev)
        parts.append((ar[:-1], ar[1:], c, sig_of(C - 1)))
    if prior_edges is not None:
        if len(prior_edges) not in (3, 4):
            raise ValueError("prior_edges is (ei, ej, c) or (ei, ej, c, sig)")
        ei, ej, c = (torch.as_tensor(x, device=dev) for x in prior_edges[:3])
        sig = (torch.as_tensor(prior_edges[3], dtype=dtype, device=dev)
               if len(prior_edges) == 4 else sig_of(ei.shape[0]))
        parts.append((ei.long(), ej.long(), c.to(dtype), sig))
    if not parts:
        return None
    return make_prior_edges(
        [torch.cat([p[k] for p in parts]) for k in range(4)], C, dtype, dev)


def global_ba_cg(cam_wt, line_orth, obs, obs_cam, obs_valid, cam_free,
                 line_free, baseline, huber_delta, robust=True, max_iters=25,
                 cg_iters=100, eta=1e-2, line_param="orth", prior_c=None,
                 prior_sigma_rot=0.02, prior_sigma_t=0.1, prior_edges=None):
    """LM bundle adjustment on the bucketed layout with matrix-free Schur
    (global_ba_cg_impl, schur_cg.py:280-472).

    obs (L, kL, 8), obs_cam (L, kL), obs_valid (L, kL) from
    pack_line_major; cam_free (C,), line_free (L,) bool.  The JAX
    function's ``cam_perm`` / ``cam_perm_valid`` are not taken: the solve
    builds its camera plan from obs_cam and obs_valid.

    ``prior_c`` (C-1, 6): odometry-chain constraints (camera i+1 relative
    to camera i), weighted 1/``prior_sigma_rot`` and 1/``prior_sigma_t``;
    ``prior_edges``: general pose constraints (ei, ej, c) with the same
    sigmas, or (ei, ej, c, sig (E, 2)) with per-edge sigmas (the JAX
    docstring, schur_cg.py:293-312, says why).

    Returns (cam', line', CGStats)."""
    dtype, dev = cam_wt.dtype, cam_wt.device
    C = cam_wt.shape[0]
    with trace.span("ba.solve", C=C, L=obs.shape[0],
                    O=obs.shape[0] * obs.shape[1], max_iters=max_iters,
                    cg_iters=cg_iters):
        with trace.span("ba.start"):
            ftol, ptol = _tolerances(dtype)
            cam_free_f = cam_free.to(dtype)
            line_free_f = line_free.to(dtype)
            w_valid = obs_valid.to(dtype)
            plan = lm_plan(obs_cam, w_valid, C)
            prior = _prior_edges(C, prior_c, prior_edges, prior_sigma_rot,
                                 prior_sigma_t, dtype, dev)

            def cost_only(cw, lo):
                cost = _cost_lm(cw, lo, obs, obs_cam, w_valid, baseline,
                                huber_delta, robust, line_param, plan)
                if prior is not None:
                    cost = cost + prior_cost(prior, cw)
                return cost

            cost0 = cost_only(cam_wt, line_orth)
            cam, line, cost = cam_wt, line_orth, cost0
            radius = torch.tensor(_INIT_RADIUS, dtype=dtype, device=dev)
            dec = torch.tensor(2.0, dtype=dtype, device=dev)
            done = torch.zeros((), dtype=torch.bool, device=dev)
            cg_total = torch.zeros((), dtype=torch.int32, device=dev)
        it = 0
        # loop condition of schur_cg.py:423-429, read once per iteration
        while it < max_iters:
            with trace.span("ba.read"):
                go = bool(torch.logical_and(~done, torch.isfinite(cost)))
            if not go:
                break
            with trace.span("ba.iter", k=it):
                lam = 1.0 / radius
                with trace.span("ba.evaluate"):
                    _, Hcc, Hll, gc, gl, Wb = _eval_system_lm(
                        cam.contiguous(), line.contiguous(), obs, obs_cam,
                        w_valid, cam_free_f, line_free_f, baseline,
                        huber_delta, robust, line_param, plan)
                    Hoff = None
                    if prior is not None:
                        _, gc_e, Hcc_e, Hoff = prior_terms(prior, cam,
                                                           cam_free_f)
                        Hcc, gc = Hcc + Hcc_e, gc + gc_e
                with trace.span("ba.step"):
                    dc, dl, damp_quad, g_dot_d, n_cg = _solve_step_cg(
                        Hcc, Hll, gc, gl, Wb, obs_cam, plan.cam, lam,
                        cam_free_f, line_free_f, cg_iters, eta, Hoff, prior,
                        line_plan=plan.line)
                    cg_total = cg_total + n_cg
                    trace.count("ba.pcg_iters", n_cg)

                with trace.span("ba.trial_cost"):
                    cam_new = cam + dc
                    line_new = line + dl
                    cost_new = cost_only(cam_new, line_new)

                with trace.span("ba.update"):
                    model_change = 0.5 * (damp_quad - g_dot_d)
                    rho = (cost - cost_new) / torch.clamp_min(model_change,
                                                              1e-300)
                    accept = torch.logical_and(model_change > 0,
                                               rho > _MIN_RELATIVE_DECREASE)
                    accept = torch.logical_and(accept,
                                               torch.isfinite(cost_new))

                    tmp = 2.0 * rho - 1.0
                    radius_acc = radius / torch.clamp_min(1.0 - tmp ** 3,
                                                          1.0 / 3.0)
                    radius_rej = radius / dec
                    radius_new = torch.where(
                        accept, torch.clamp_max(radius_acc, 1e16),
                        torch.clamp_min(radius_rej, 1e-32))
                    dec = torch.where(accept, torch.full_like(dec, 2.0),
                                      dec * 2.0)

                    fconv = torch.abs(cost - cost_new) <= ftol * cost
                    xnorm = torch.sqrt(torch.sum(cam * cam)
                                       + torch.sum(line * line))
                    snorm = torch.sqrt(torch.sum(dc * dc) + torch.sum(dl * dl))
                    pconv = snorm <= ptol * (xnorm + ptol)
                    converged = torch.logical_and(
                        accept, torch.logical_or(fconv, pconv))
                    done = torch.logical_or(converged, ~(snorm > 0))

                    cam = torch.where(accept, cam_new, cam)
                    line = torch.where(accept, line_new, line)
                    cost = torch.where(accept, cost_new, cost)
                    radius = radius_new
            it += 1
        stats = CGStats(torch.tensor(it, dtype=torch.int32, device=dev),
                        cost0, cost, cg_total)
    return cam, line, stats
