"""K3's PCG (``kernels.schur_pcg``) through its CPU twin, float64.

* Bit for bit with the Python PCG loop that ``_solve_step_cg`` ran before
  the loop became one kernel launch (a copy below, ``_loop_step``, over
  the K3 passes' twins and K1's for the priors' coupling), at 0, 1, 3 and
  100 iterations and where eta stops it, with and without the priors.
* Against JAX's ``_solve_step_cg`` where eta stops the loop before
  ``cg_iters``: the same PCG iterations, the same step within 1e-10.
* The twin's matvec with the priors' coupling over the edges' node rows
  against an explicit dense S (as test_torch_schur_matvec's passes).
* ``kernel_checks.schur_work("schur_pcg")`` counts the valid rows only;
  ``kernel_checks``' PCG case and check run (twin against twin here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.ops import schur_cg as jcg
from slslam_tpu_torch import kernel_checks as kc
from slslam_tpu_torch.ops import kernels
from slslam_tpu_torch.ops import schur_ba as tba
from slslam_tpu_torch.ops import schur_cg as tcg

from test_torch_schur_matvec import (C, FEATURES, KL, L, _case, _explicit,
                                     _prior, _rel, _t, problem)  # noqa: F401

torch.set_num_threads(1)


def _loop_step(Hcc, Hll, gc, gl, Wb, obs_cam, cam_plan, lam, cam_free_f,
               line_free_f, cg_iters, eta, Hoff=None, prior=None,
               line_plan=None):
    """The damped PCG step as a Python loop over the matvec's passes and a
    K1 sum of the priors' rows, a host read an iteration: the solver this
    port ran before K3's PCG (the reference of the bit-for-bit test)."""
    dtype, dev = Hcc.dtype, Hcc.device
    oc = obs_cam.to(torch.int32).contiguous()
    Wb = Wb.contiguous()
    diag_c, diag_l, Binv, Hcc_d = tcg.damped_blocks(Hcc, Hll, lam)
    mf = cam_free_f.contiguous()
    m = mf[:, None]

    def matvec(x):
        w, _ = kernels.schur_matvec_line(Wb, oc, x, mf, Binv, line_plan)
        Sx = kernels.schur_matvec_cam(Wb, w, mf, cam_plan, Hcc_d=Hcc_d, x=x)
        if Hoff is None:
            return Sx
        xm = x * m
        rows = torch.cat([torch.einsum("eab,eb->ea", Hoff, xm[prior.ej]),
                          torch.einsum("eba,eb->ea", Hoff, xm[prior.ei])])
        return Sx + kernels.segment_sum(rows.contiguous(), prior.plan.gkey,
                                        Hcc_d.shape[0],
                                        plan=prior.plan.gplan) * m

    w0 = torch.einsum("lab,lb->la", Binv, gl).contiguous()
    rhs = kernels.schur_matvec_cam(Wb, w0, mf, cam_plan, gc=gc.contiguous())
    Minv = tba._inv4_equilibrated(kernels.schur_jacobi(Wb, Binv, Hcc_d, mf,
                                                       cam_plan))

    def precond(r):
        return torch.einsum("cab,cb->ca", Minv, r)

    tol2 = (eta * eta) * torch.sum(rhs * rhs)
    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    it = 0
    while it < cg_iters and bool(torch.sum(r * r) > tol2):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, one), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(rz != 0, rz, one)
        p = z + beta * p
        rz = rz_new
        it += 1
    dc = x * m
    _, coup = kernels.schur_matvec_line(Wb, oc, dc.contiguous(), mf, Binv,
                                        line_plan)
    dl = -torch.einsum("lab,lb->la", Binv, gl + coup)
    dl = dl * line_free_f[:, None]
    damp_quad = lam * (torch.sum(diag_c * dc * dc)
                       + torch.sum(diag_l * dl * dl))
    g_dot_d = torch.sum(gc * dc) + torch.sum(gl * dl)
    return dc, dl, damp_quad, g_dot_d, it


def _step_args(problem, with_prior):
    """The blocks of test_torch_schur_matvec's problem as global_ba_cg
    hands them to _solve_step_cg (torch), and JAX's (numpy): ((args, kw),
    (Hcc, gc, Hoff, ei, ej) for JAX)."""
    cam0, p, cf, lf, wv, blocks = problem
    C_ = len(cam0)
    Hcc, Hll, gc, gl, Wb = blocks[1:]
    Hoff = prior = None
    ei = ej = np.zeros(0, np.int32)
    Hoff_j = np.zeros((0, 6, 6))
    if with_prior:
        from test_torch_schur_cg import _priors
        chain, _, e4 = _priors(cam0)
        prior = tcg._prior_edges(C_, chain, e4, 0.02, 0.1, torch.float64,
                                 "cpu")
        _, gc_e, Hcc_e, Hoff = tba.prior_terms(prior, _t(cam0), _t(cf))
        Hcc, gc = Hcc + Hcc_e.numpy(), gc + gc_e.numpy()
        ei, ej = prior.ei.numpy(), prior.ej.numpy()
        Hoff_j = Hoff.numpy()
    plan = tcg.lm_plan(_t(p.obs_cam), _t(wv), C_)
    args = (*(_t(x) for x in (Hcc, Hll, gc, gl, Wb)), _t(p.obs_cam),
            plan.cam, 1e-3, _t(cf), _t(lf))
    kw = dict(Hoff=Hoff, prior=prior, line_plan=plan.line)
    return (args, kw), (Hcc, gc, Hoff_j, ei, ej)


@pytest.mark.parametrize("with_prior", [False, True], ids=["no prior",
                                                           "priors"])
@pytest.mark.parametrize("cg_iters,eta", [(0, 1e-2), (1, 1e-2), (3, 1e-2),
                                          (100, 1e-2), (100, 0.3)])
def test_solve_step_cg_bit_for_bit_with_the_loop(problem, cg_iters, eta,
                                                 with_prior):
    """On CPU tensors the step through schur_pcg's twin equals the Python
    loop over the passes' twins and K1's twin bit for bit, its count a
    0-d int32 tensor."""
    (args, kw), _ = _step_args(problem, with_prior)
    got = tcg._solve_step_cg(*args, cg_iters, eta, **kw)
    ref = _loop_step(*args, cg_iters, eta, **kw)
    assert got[4].dtype == torch.int32 and got[4].dim() == 0
    assert int(got[4]) == ref[4]
    for name, a, b in zip(("dc", "dl", "damp_quad", "g_dot_d"), got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("with_prior", [False, True], ids=["no prior",
                                                           "priors"])
@pytest.mark.parametrize("eta", [0.3, 0.1])
def test_solve_step_cg_eta_stop_matches_jax(problem, eta, with_prior):
    """Where eta ends the PCG before cg_iters, the port's step (its count
    on the device) and JAX's stop after the same iterations with the same
    step."""
    cam0, p, cf, lf, wv, blocks = problem
    (args, kw), (Hcc, gc, Hoff_j, ei, ej) = _step_args(problem, with_prior)
    cg_iters = 100
    ref = jcg._solve_step_cg(
        jnp.asarray(Hcc), jnp.asarray(blocks[2]), jnp.asarray(gc),
        *(jnp.asarray(x) for x in blocks[4:]), jnp.asarray(Hoff_j),
        jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
        jnp.asarray(p.obs_cam), jnp.asarray(p.cam_perm),
        jnp.asarray(p.cam_perm_valid), 1e-3, jnp.asarray(cf),
        jnp.asarray(lf), cg_iters, eta)
    got = tcg._solve_step_cg(*args, cg_iters, eta, **kw)
    assert 0 < int(got[4]) == int(ref[4]) < cg_iters
    for name, a, b in zip(("dc", "dl", "damp_quad", "g_dot_d"), ref, got):
        assert _rel(b.numpy(), np.asarray(a)) <= 1e-10, name


@pytest.mark.parametrize("with_prior", [False, True], ids=["no prior",
                                                           "priors"])
@pytest.mark.parametrize("feature", FEATURES)
def test_pcg_twin_matvec_matches_explicit_S(feature, with_prior):
    """schur_matvec_twin (the PCG twin's S p) with the priors' coupling
    over the node rows gkey = cat(ei, ej) equals S x of an explicit dense
    S, fixed cameras as the identity, within 1e-12; and one PCG iteration
    of the twin from x = 0 moves along Minv rhs by the exact step
    length."""
    c = _case(feature)
    prior, Hoff = _prior() if with_prior else (None, None)
    _, S = _explicit(c, prior, Hoff)
    t = {k: _t(v) for k, v in c.items()}
    plan = tcg.lm_plan(t["obs_cam"], t["valid"].double(), C)
    M = np.repeat(c["m"], 6)
    S_eff = M[:, None] * S * M[None, :] + np.diag(1.0 - M)
    gkey = None if prior is None else prior.plan.gkey
    Sx = kernels.schur_matvec_twin(t["x"], t["Wb"], t["obs_cam"], t["m"],
                                   t["Binv"], t["Hcc_d"], plan.cam.key, Hoff,
                                   gkey)
    assert _rel(Sx.reshape(-1), S_eff @ c["x"].reshape(-1)) <= 1e-12

    # one iteration: x1 = alpha z0, alpha = r.z / z.Sz, z0 = Minv rhs
    rhs = t["gc"] * t["m"][:, None]
    Minv = torch.eye(6, dtype=torch.float64).expand(C, 6, 6).contiguous()
    x1, it = kernels.schur_pcg_twin(rhs, Minv, t["Wb"], t["obs_cam"],
                                    t["m"], t["Binv"], t["Hcc_d"],
                                    plan.cam.key, 1, 1e-2, Hoff, gkey)
    r = rhs.numpy().reshape(-1)
    sz = S_eff @ r
    if r @ sz > 0:
        assert int(it) == 1
        assert _rel(x1.numpy().reshape(-1), (r @ r) / (r @ sz) * r) <= 1e-12


def test_schur_pcg_takes_priors_whole():
    c = _case("dense")
    t = {k: _t(v) for k, v in c.items()}
    plan = tcg.lm_plan(t["obs_cam"], t["valid"].double(), C)
    prior, Hoff = _prior()
    Minv = torch.eye(6, dtype=torch.float64).expand(C, 6, 6)
    for kw in (dict(Hoff=Hoff), dict(prior_plan=prior.plan)):
        with pytest.raises(ValueError, match="together"):
            kernels.schur_pcg(t["gc"], Minv, t["Wb"], t["obs_cam"], t["m"],
                              t["Binv"], t["Hcc_d"], plan.cam, plan.line, 10,
                              1e-2, **kw)


@pytest.mark.parametrize("with_prior", [False, True], ids=["no prior",
                                                           "priors"])
def test_pcg_work_counts_valid_rows_only(with_prior):
    """schur_work("schur_pcg") (one iteration's bytes and operations)
    follows the valid rows: 8 more padding rows a line give the same
    work; it is the line pass, the camera pass, the update's C (36 + 5 6)
    values and the priors' 2E rows; pcg_work is it times the
    iterations."""
    c = _case("all")
    n_valid = int(c["valid"].sum())
    t = {k: _t(v) for k, v in c.items()}
    pad = dict(t, Wb=torch.cat([t["Wb"], torch.zeros(L, 8, 6, 4,
                                                     dtype=torch.float64)], 1),
               obs_cam=torch.cat([t["obs_cam"], torch.zeros(
                   L, 8, dtype=torch.int32)], 1),
               valid=torch.cat([t["valid"], torch.zeros(L, 8,
                                                        dtype=torch.bool)], 1))
    prior, Hoff = _prior() if with_prior else (None, None)
    E = 0 if Hoff is None else Hoff.shape[0]
    works = []
    for case in (t, pad):
        plan = tcg.lm_plan(case["obs_cam"], case["valid"].double(), C)
        works.append(kc.pcg_work(dict(Wb=case["Wb"], cam_free_f=case["m"],
                                      Hoff=Hoff), plan, 7))
    assert works[0] == works[1]
    one = kc.schur_work("schur_pcg", C, L, n_valid, 8, E=E)
    assert works[0] == tuple(7 * v for v in one)
    passes = [kc.schur_work(n, C, L, n_valid, 8)
              for n in ("schur_matvec/line", "schur_matvec/cam")]
    assert one[0] >= passes[0][0] + passes[1][0] + C * 66 * 8
    every = kc.schur_work("schur_pcg", C, L, L * KL, 8, E=E)
    assert all(x < y for x, y in zip(one, every))
    if E:
        bare = kc.schur_work("schur_pcg", C, L, n_valid, 8)
        assert all(x > y for x, y in zip(one, bare))


@pytest.mark.parametrize("priors", [False, True], ids=["no prior", "priors"])
def test_pcg_case_and_check_run_on_the_cpu(priors):
    """kernel_checks' PCG case (K2 lm's blocks of a real BA problem, damped)
    gives an SPD system on which the PCG converges by eta; its checks run
    here twin against twin (float64: equal; float32: the rounding witness
    is positive and the limit holds)."""
    shape = (12, 20, 160)
    case, plan = kc.pcg_case(torch.float64, "cpu", shape, 0.05, priors)
    assert (case["Hoff"] is None) == (not priors)
    out = kc.check_pcg_case(case, plan)
    assert out["iterations"] == out["twin_iterations"] < kc.PCG_ITERS
    assert out["err"] == 0.0
    case32, plan32 = kc.pcg_case(torch.float32, "cpu", shape, 0.05, priors)
    out32 = kc.check_pcg_case(case32, plan32)
    assert 0 < out32["witness"] and out32["err"] <= out32["limit"]


def test_global_ba_cg_keeps_the_pcg_count_on_the_device(problem):
    """global_ba_cg sums the steps' PCG counts as a tensor: CGStats'
    cg_iterations is a 0-d int32 tensor, positive."""
    cam0, p, cf, lf, wv, _ = problem
    from test_schur_cg import BL, HD, _perturbed
    _, orth0, *_ = _perturbed()
    _, _, st = tcg.global_ba_cg(
        _t(cam0), _t(orth0), _t(p.obs), _t(p.obs_cam), _t(p.obs_valid),
        _t(cf > 0), _t(lf > 0), BL, HD, max_iters=3)
    assert st.cg_iterations.dtype == torch.int32
    assert st.cg_iterations.dim() == 0 and int(st.cg_iterations) > 0
