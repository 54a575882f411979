"""Pose-graph optimization: batched Levenberg-Marquardt over SE(3) edges.

Port of ``slslam_tpu/ops/pose_graph.py`` (the replacement for
SLAM::pose_optimization + ceres::POProblem, slam.cpp:1236-1313,
po_problem.{h,cpp}).  Per edge (i, j) with constraint C, the stored
relative pose i -> j, the residual is the 6-vector log of
Te = T2^-1 (C T1) (po_problem.h:73-105).  Every edge residual and its two
6x6 Jacobians are evaluated in one batch (``torch.func.jacfwd`` under
``vmap``, as JAX's ``jax.jacfwd``); the normal equations are summed into a
dense 6V x 6V system and solved by an equilibrated dense Cholesky, under
Ceres's LM trust region (the constants of ``ops/schur_ba.py``).

The block sums are K1 (``ops/kernels.py`` ``segment_sum``) over a fixed
block key, one plan per solve: where JAX scatters with ``.at[].add``, the
card sums every block's rows in a fixed order, so a solve repeats bit for
bit.  The same edge terms serve the solvers' pose priors
(``schur_ba.local_ba`` and ``schur_cg.global_ba_cg`` ``prior_edges``).
The LM loop reads its condition from the device once per iteration.  The
JAX function's ``axis_name`` (edge-sharded PGO) belongs to the distributed
layer and is not ported.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import geometry as geo
from .kernels import segment_plan, segment_sum
from .residuals import robust_weights

class PGOStats(NamedTuple):
    iterations: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def edge_residual(pose1, pose2, constraint):
    """po_problem.h:73-105: Te = T2^-1 C T1 as a 6-vector (pose_graph.py:
    35-53), composed in matrix form with one log at the end.  Broadcasts
    over leading dimensions."""
    Rc, tc = geo.wt_to_Rt(constraint)
    R1, t1 = geo.wt_to_Rt(pose1)
    R2, t2 = geo.wt_to_Rt(pose2)
    R = Rc @ R1                    # C * T1
    t = geo.matvec(Rc, t1) + tc
    R2t = R2.transpose(-1, -2)
    Re = R2t @ R                   # T2^-1 * (C * T1)
    te = geo.matvec(R2t, t - t2)
    # a trailing batch dimension: so3_log's per-sample 0-dim terms would
    # promote float32 tangents to float64 under vmap + jacfwd
    # (geometry.rodrigues, ROADMAP Queue 3)
    return torch.cat([geo.so3_log(Re.unsqueeze(-3)).squeeze(-2), te],
                     dim=-1)


@functools.lru_cache(maxsize=None)
def _edge_rj():
    def f(p1, p2, c):
        r = edge_residual(p1, p2, c)
        return r, r
    return torch.func.vmap(torch.func.jacfwd(f, argnums=(0, 1),
                                             has_aux=True))


def edge_residual_jac(pose1, pose2, constraint):
    """(E,6) x3 -> r (E,6), d r/d pose1 (E,6,6), d r/d pose2 (E,6,6)
    (pose_graph.py:56-63)."""
    (j1, j2), r = _edge_rj()(pose1, pose2, constraint)
    return r, j1, j2


class BlockPlan(NamedTuple):
    """K1 plans of one solve's edge blocks over V nodes: ``gkey`` keys the
    rows (i rows, then j rows) by node; ``hkey`` keys (6,6) blocks by
    (row node, column node) over V*V segments, or is None."""

    gkey: torch.Tensor
    gplan: object
    hkey: object
    hplan: object
    V: int
    blocks: object


def block_plan(edge_i, edge_j, V, blocks=None):
    """Plans of edges (i, j) among V nodes, keyed in JAX's order of
    accumulation (pose_graph.py:98-111): node rows i then j; with
    ``blocks="full"`` the PGO's four H blocks (i,i), (j,j), (i,j), (j,i),
    with ``blocks="offdiag"`` the two coupling blocks (i,j), (j,i)."""
    ei, ej = edge_i.long(), edge_j.long()
    gkey = torch.cat([ei, ej]).to(torch.int32).contiguous()
    parts = {"full": (ei * V + ei, ej * V + ej, ei * V + ej, ej * V + ei),
             "offdiag": (ei * V + ej, ej * V + ei), None: None}[blocks]
    hkey = hplan = None
    if parts is not None:
        hkey = torch.cat(parts).to(torch.int32).contiguous()
        hplan = segment_plan(hkey, V * V)
    return BlockPlan(gkey, segment_plan(gkey, V), hkey, hplan, V, blocks)


def edge_system(plan: BlockPlan, J1, J2, r):
    """Normal-equation terms of weighted, masked edges (J1, J2 (E,6,6),
    r (E,6)), summed by K1 in a fixed order.

    With a ``"full"`` plan: (H (6V, 6V), g (V,6)) of the whole graph (the
    PGO).  Otherwise: (Hd (V,6,6), g (V,6), Hoff (E,6,6)) — per-node
    diagonal blocks and each edge's (i, j) coupling, which the solvers'
    pose priors place themselves (schur_ba.py:499-515)."""
    V = plan.V
    E = r.shape[0]
    A11 = torch.einsum("eki,ekj->eij", J1, J1)
    A22 = torch.einsum("eki,ekj->eij", J2, J2)
    A12 = torch.einsum("eki,ekj->eij", J1, J2)
    g_rows = torch.cat([torch.einsum("eki,ek->ei", J1, r),
                        torch.einsum("eki,ek->ei", J2, r)]).contiguous()
    g = segment_sum(g_rows, plan.gkey, V, plan=plan.gplan)
    if plan.blocks == "full":
        A21 = torch.einsum("eki,ekj->eij", J2, J1)
        rows = torch.cat([A11, A22, A12, A21]).reshape(4 * E, 36)
        H = segment_sum(rows.contiguous(), plan.hkey, V * V, plan=plan.hplan)
        H = H.reshape(V, V, 6, 6).permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
        return H, g
    rows = torch.cat([A11, A22]).reshape(2 * E, 36).contiguous()
    Hd = segment_sum(rows, plan.gkey, V, plan=plan.gplan).reshape(V, 6, 6)
    return Hd, g, A12


def _assemble(poses, edges_i, edges_j, constraints, e_valid, free_f,
              plan, huber_delta=None):
    """Cost, H (6V,6V), g (6V,) at ``poses`` (pose_graph.py:72-117)."""
    ei, ej = edges_i.long(), edges_j.long()
    r, j1, j2 = edge_residual_jac(poses[ei], poses[ej], constraints)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    vmask = e_valid[:, None] > 0
    r = torch.where(vmask, r, zero)
    j1 = torch.where(vmask[..., None], j1 * free_f[ei][:, None, None], zero)
    j2 = torch.where(vmask[..., None], j2 * free_f[ej][:, None, None], zero)
    if huber_delta is not None:
        # Huber on the edge residual norm caps a wrong loop edge's pull
        w_r, cost_e = robust_weights(r, huber_delta, True)
        cost = torch.sum(torch.where(e_valid > 0, cost_e, zero))
        r = r * w_r[:, None]
        j1 = j1 * w_r[:, None, None]
        j2 = j2 * w_r[:, None, None]
    else:
        cost = 0.5 * torch.sum(r * r)
    H, g = edge_system(plan, j1, j2, r)
    return cost, H, g.reshape(-1)


def pose_graph_opt(poses, edges_i, edges_j, constraints, e_valid, pose_free,
                   max_iters=10, huber_delta=None):
    """Optimize keyframe poses against relative-pose constraints
    (pose_graph_opt_impl, pose_graph.py:120-201).

    poses (V,6) world->cam (angle-axis, t); edges_i, edges_j (E,) int;
    constraints (E,6), the pose of j relative to i; e_valid (E,) bool;
    pose_free (V,) bool, False for gauge-fixed poses.  Returns (poses',
    PGOStats)."""
    # schur_ba imports this module for its pose priors: its LM constants
    # and dense solve come in here, at call time
    from .schur_ba import (_FUNCTION_TOL, _INIT_RADIUS, _MAX_DIAG, _MIN_DIAG,
                           _MIN_RELATIVE_DECREASE, _cho_solve_equilibrated)
    dtype, dev = poses.dtype, poses.device
    V = poses.shape[0]
    free_f = pose_free.to(dtype)
    ev = e_valid.to(dtype)
    plan = block_plan(edges_i, edges_j, V, "full")

    def assemble(p):
        return _assemble(p, edges_i, edges_j, constraints, ev, free_f, plan,
                         huber_delta)

    cost0, H, g = assemble(poses)
    cost = cost0
    radius = torch.tensor(_INIT_RADIUS, dtype=dtype, device=dev)
    dec = torch.tensor(2.0, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    m = free_f.repeat_interleave(6)
    it = 0
    # loop condition of pose_graph.py:159-160, read once per iteration
    while it < max_iters and not bool(done):
        lam = 1.0 / radius
        diag = torch.clamp(torch.diagonal(H), _MIN_DIAG, _MAX_DIAG)
        A = H + torch.diag(lam * diag)
        A = A * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        dx = _cho_solve_equilibrated(A, -g * m) * m

        poses_new = poses + dx.reshape(-1, 6)
        cost_new, H_n, g_n = assemble(poses_new)

        model_change = 0.5 * (lam * torch.sum(diag * dx * dx)
                              - torch.sum(g * dx))
        rho = (cost - cost_new) / torch.clamp_min(model_change, 1e-300)
        accept = torch.logical_and(model_change > 0,
                                   rho > _MIN_RELATIVE_DECREASE)
        accept = torch.logical_and(accept, torch.isfinite(cost_new))

        tmp = 2.0 * rho - 1.0
        radius = torch.where(
            accept,
            torch.clamp_max(radius / torch.clamp_min(1.0 - tmp ** 3,
                                                     1.0 / 3.0), 1e16),
            torch.clamp_min(radius / dec, 1e-32))
        dec = torch.where(accept, torch.full_like(dec, 2.0), dec * 2.0)
        done = torch.logical_and(
            accept, torch.abs(cost - cost_new) <= _FUNCTION_TOL * cost)

        poses = torch.where(accept, poses_new, poses)
        cost = torch.where(accept, cost_new, cost)
        H = torch.where(accept, H_n, H)
        g = torch.where(accept, g_n, g)
        it += 1
    return poses, PGOStats(torch.tensor(it, dtype=torch.int32, device=dev),
                           cost0, cost)
