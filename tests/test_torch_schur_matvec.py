"""The refine PCG's Schur kernels K3 (``schur_matvec``) and K4
(``schur_jacobi``) through their CPU twins, float64.

* Against an explicit S = Hcc_d - W Binv W^T built in numpy on small
  problems (C 12, L 40, kL 8; one observation a (camera, line) pair, as
  the packed layout has): K3's line pass (z = W^T x_m, w = Binv z), the
  matvec (line pass, camera pass, the priors' coupling) against S x with
  fixed cameras as the identity, the right-hand side, and K4's blocks
  against S's diagonal blocks; within 1e-12 of the largest entry.
* Against JAX: ``_solve_step_cg`` of both packages on the same blocks, at
  0, 1, 3 and 100 PCG iterations (the right-hand side and back-
  substitution alone; one matvec with the Jacobi blocks; a few; the whole
  loop), with and without the priors: the same PCG iterations, dc, dl,
  damp_quad and g_dot_d within 1e-10 of the largest entry.
* ``kernel_checks.schur_work`` counts the valid rows only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.ops import schur_cg as jcg
from slslam_tpu_torch import kernel_checks as kc
from slslam_tpu_torch.ops import kernels
from slslam_tpu_torch.ops import schur_ba as tba
from slslam_tpu_torch.ops import schur_cg as tcg

from test_schur_cg import BL, HD, _perturbed

torch.set_num_threads(1)

C, L, KL = 12, 40, 8
FEATURES = ("dense", "padded rows", "fixed cameras", "camera without rows",
            "line without rows", "all")


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              1e-300)


def _case(feature, seed=0):
    """A line-major problem with ``feature`` ("all": every one): numpy
    arrays obs_cam (L, kL), valid (L, kL), Wb (L, kL, 6, 4) zero on the
    invalid rows, Binv (L, 4, 4), Hcc_d (C, 6, 6), m (C,), x, gc (C, 6),
    gl (L, 4).  Padding rows hold camera 0, as pack_line_major writes."""
    rng = np.random.default_rng(seed)
    oc = np.stack([rng.permutation(C)[:KL] for _ in range(L)])
    valid = np.ones((L, KL), bool)
    m = np.ones(C)
    every = feature == "all"
    if every or feature == "padded rows":
        valid &= np.arange(KL)[None, :] < rng.integers(3, KL + 1, L)[:, None]
    if every or feature == "fixed cameras":
        m[[0, 5]] = 0.0
    if every or feature == "camera without rows":
        valid &= oc != C - 1
    if every or feature == "line without rows":
        valid[[7, L - 1]] = False
    oc[~valid] = 0
    Wb = rng.standard_normal((L, KL, 6, 4)) * 0.5
    Wb[~valid] = 0.0
    A = rng.standard_normal((L, 4, 4))
    Binv = A @ A.transpose(0, 2, 1) / 4 + 0.2 * np.eye(4)
    H = rng.standard_normal((C, 6, 6))
    Hcc_d = H @ H.transpose(0, 2, 1) + 6 * np.eye(6)
    return dict(obs_cam=oc.astype(np.int32), valid=valid, Wb=Wb, Binv=Binv,
                Hcc_d=Hcc_d, m=m, x=rng.standard_normal((C, 6)),
                gc=rng.standard_normal((C, 6)),
                gl=rng.standard_normal((L, 4)))


def _prior(seed=3):
    """A chain prior and two loop edges over random poses: (PriorEdges,
    Hoff (E, 6, 6))."""
    rng = np.random.default_rng(seed)
    cam = rng.standard_normal((C, 6)) * 0.1
    chain = rng.standard_normal((C - 1, 6)) * 0.05
    edges = (np.array([0, 2]), np.array([C - 1, 9]),
             rng.standard_normal((2, 6)) * 0.05)
    prior = tcg._prior_edges(C, chain, edges, 0.02, 0.1, torch.float64,
                             "cpu")
    _, _, _, Hoff = tba.prior_terms(prior, _t(cam), torch.ones(C,
                                    dtype=torch.float64))
    return prior, Hoff


def _explicit(c, prior=None, Hoff=None):
    """W (C, L, 6, 4) and S (6C, 6C) = blockdiag(Hcc_d) - W Binv W^T (+ the
    priors' coupling blocks), built from the valid rows."""
    W = np.zeros((C, L, 6, 4))
    for l in range(L):
        for k in range(KL):
            if c["valid"][l, k]:
                W[c["obs_cam"][l, k], l] += c["Wb"][l, k]
    S = np.zeros((6 * C, 6 * C))
    for i in range(C):
        S[6 * i:6 * i + 6, 6 * i:6 * i + 6] = c["Hcc_d"][i]
    Wf = W.transpose(0, 2, 1, 3).reshape(6 * C, L, 4)
    for l in range(L):
        S -= Wf[:, l] @ c["Binv"][l] @ Wf[:, l].T
    if prior is not None:
        for e, (i, j) in enumerate(zip(prior.ei.tolist(),
                                       prior.ej.tolist())):
            S[6 * i:6 * i + 6, 6 * j:6 * j + 6] += Hoff[e].numpy()
            S[6 * j:6 * j + 6, 6 * i:6 * i + 6] += Hoff[e].numpy().T
    return W, S


@pytest.mark.parametrize("with_prior", [False, True], ids=["no prior",
                                                           "priors"])
@pytest.mark.parametrize("feature", FEATURES)
def test_schur_twins_match_explicit_S(feature, with_prior):
    c = _case(feature)
    prior, Hoff = _prior() if with_prior else (None, None)
    W, S = _explicit(c, prior, Hoff)
    t = {k: _t(v) for k, v in c.items()}
    plan = tcg.lm_plan(t["obs_cam"], t["valid"].double(), C)
    Wb, oc, m = t["Wb"], t["obs_cam"], t["m"]
    M = np.repeat(c["m"], 6)
    xm = c["x"] * c["m"][:, None]
    before = dict(kernels.launch_counts)

    # K3's line pass: z_l = W_l^T x_m, w_l = Binv_l z_l
    w, z = kernels.schur_matvec_line(Wb, oc, t["x"], m, t["Binv"], plan.line)
    z_ref = np.einsum("clab,ca->lb", W, xm)
    assert _rel(z, z_ref) <= 1e-12
    assert _rel(w, np.einsum("lab,lb->la", c["Binv"], z_ref)) <= 1e-12
    if feature in ("line without rows", "all"):
        assert torch.all(z[L - 1] == 0) and torch.all(w[L - 1] == 0)

    # the matvec: S x, fixed cameras as the identity
    S_eff = M[:, None] * S * M[None, :] + np.diag(1.0 - M)
    Sx = kernels.schur_matvec_twin(t["x"], Wb, oc, m, t["Binv"], t["Hcc_d"],
                                   plan.cam.key, Hoff,
                                   None if prior is None else prior.plan.gkey)
    assert _rel(Sx.reshape(-1), S_eff @ c["x"].reshape(-1)) <= 1e-12
    if feature in ("fixed cameras", "all"):
        assert torch.equal(Sx[[0, 5]], t["x"][[0, 5]])

    # the right-hand side: (-gc + W Binv gl) m
    w0 = torch.einsum("lab,lb->la", t["Binv"], t["gl"])
    rhs = kernels.schur_matvec_cam(Wb, w0, m, plan.cam, gc=t["gc"])
    rhs_ref = (-c["gc"] + np.einsum("clab,lbd,ld->ca", W, c["Binv"],
                                    c["gl"])) * c["m"][:, None]
    assert _rel(rhs, rhs_ref) <= 1e-12

    # K4: S's 6x6 diagonal blocks (no prior: its coupling is off the
    # diagonal), the identity for a fixed camera
    P = kernels.schur_jacobi(Wb, t["Binv"], t["Hcc_d"], m, plan.cam)
    _, S0 = _explicit(c)
    P_ref = np.stack([S0[6 * i:6 * i + 6, 6 * i:6 * i + 6] if c["m"][i]
                      else np.eye(6) for i in range(C)])
    assert _rel(P, P_ref) <= 1e-12
    if feature in ("camera without rows", "all"):
        assert torch.equal(P[C - 1], t["Hcc_d"][C - 1])
    assert kernels.launch_counts == before       # CPU tensors: the twins


def test_schur_cam_pass_takes_matvec_or_rhs():
    c = _case("dense")
    t = {k: _t(v) for k, v in c.items()}
    plan = tcg.lm_plan(t["obs_cam"], t["valid"].double(), C)
    w = torch.zeros(L, 4, dtype=torch.float64)
    for kw in ({}, dict(gc=t["gc"], x=t["x"]),
               dict(gc=t["gc"], Hcc_d=t["Hcc_d"])):
        with pytest.raises(ValueError, match="Hcc_d and x, or gc"):
            kernels.schur_matvec_cam(t["Wb"], w, t["m"], plan.cam, **kw)


@pytest.fixture(scope="module")
def problem():
    cam0, orth0, obs, obs_cam, obs_line, cam_free, _ = _perturbed()
    p = jcg.pack_line_major(obs, obs_cam, obs_line, len(cam0), len(orth0))
    cf = cam_free.astype(np.float64)
    lf = np.ones(len(orth0))
    wv = p.obs_valid.astype(np.float64)
    blocks = jax.jit(lambda *a: jcg._eval_system_lm(*a, True, "orth"))(
        *(jnp.asarray(x) for x in (cam0, orth0, p.obs, p.obs_cam, wv,
                                   p.cam_perm, p.cam_perm_valid, cf, lf,
                                   BL, HD)))
    return cam0, p, cf, lf, wv, [np.asarray(b) for b in blocks]


@pytest.mark.parametrize("with_prior", [False, True], ids=["no prior",
                                                           "priors"])
@pytest.mark.parametrize("cg_iters", [0, 1, 3, 100])
def test_solve_step_cg_matches_jax_by_iterations(problem, cg_iters,
                                                 with_prior):
    """One damped PCG step, the port's (K3 and K4's twins) against JAX's
    einsums on the same blocks, stopped after ``cg_iters`` PCG
    iterations."""
    cam0, p, cf, lf, wv, blocks = problem
    C_, L_ = len(cam0), len(lf)
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
    lam = 1e-3
    ref = jcg._solve_step_cg(
        *(jnp.asarray(x) for x in (Hcc, Hll, gc, gl, Wb, Hoff_j)),
        jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
        jnp.asarray(p.obs_cam), jnp.asarray(p.cam_perm),
        jnp.asarray(p.cam_perm_valid), lam, jnp.asarray(cf), jnp.asarray(lf),
        cg_iters, 1e-2)
    plan = tcg.lm_plan(_t(p.obs_cam), _t(wv), C_)
    before = dict(kernels.launch_counts)
    got = tcg._solve_step_cg(
        *(_t(x) for x in (Hcc, Hll, gc, gl, Wb)), _t(p.obs_cam), plan.cam,
        lam, _t(cf), _t(lf), cg_iters, 1e-2, Hoff, prior,
        line_plan=plan.line)
    assert kernels.launch_counts == before
    assert got[4] == int(ref[4]) <= cg_iters
    if cg_iters:
        assert got[4] > 0
    for name, a, b in zip(("dc", "dl", "damp_quad", "g_dot_d"), ref, got):
        a = np.asarray(a)
        if not np.any(a):
            assert not torch.any(b), name            # no PCG step: dc = 0
            continue
        assert _rel(b.numpy(), a) <= 1e-10, (name, _rel(b.numpy(), a))


def test_schur_work_counts_valid_rows_only():
    """The bound's bytes and operations follow the valid rows: the same
    problem with 8 more padding rows a line (zero Wb, dropped by the plans)
    gives the same work, and the same outputs; each kernel's work is the
    closed form at the valid rows' count, below its count at every row."""
    c = _case("all")
    n_valid = int(c["valid"].sum())
    t = {k: _t(v) for k, v in c.items()}
    pad = dict(t, Wb=torch.cat([t["Wb"], torch.zeros(L, 8, 6, 4,
                                                     dtype=torch.float64)], 1),
               obs_cam=torch.cat([t["obs_cam"], torch.zeros(
                   L, 8, dtype=torch.int32)], 1),
               valid=torch.cat([t["valid"], torch.zeros(L, 8,
                                                        dtype=torch.bool)], 1))
    works = []
    outs = []
    for case in (t, pad):
        plan = tcg.lm_plan(case["obs_cam"], case["valid"].double(), C)
        args = dict(Wb=case["Wb"], cam_free_f=case["m"])
        works.append({(n, rhs): kc.schur_case_work(n, args, plan, rhs)
                      for n in kc.SCHUR_OUTPUTS for rhs in (False, True)})
        outs.append(kc.schur_calls(
            dict(case, cam_free_f=case["m"],
                 w=torch.ones(L, 4, dtype=torch.float64)), plan, twin=True))
    assert works[0] == works[1]
    for n in kc.SCHUR_OUTPUTS:
        for a, b in zip(outs[0][n](), outs[1][n]()):
            assert _rel(a, b) <= 1e-12
        for rhs in (False, True):
            assert works[0][n, rhs] == kc.schur_work(n, C, L, n_valid, 8, rhs)
            every = kc.schur_work(n, C, L, L * KL, 8, rhs)
            assert all(x < y for x, y in zip(works[0][n, rhs], every))
