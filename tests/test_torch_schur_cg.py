"""The port's PCG Schur solver (slslam_tpu_torch/ops/schur_cg.py) vs JAX's.

On the CPU the port's evaluate is K2 ``lm``'s plain twin and its
per-camera sums are K1's twin.  Both packages get the perturbed problem of
tests/test_schur_cg.py in float64.  Tolerances: the packed layout is
identical; the evaluate's six outputs agree to 1e-10 relative (the same
function, sums in another order); the solves take the same LM and PCG
paths (identical iteration counts), with cameras and lines within 1e-8 and
costs within rtol 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.ops import schur_ba as jba
from slslam_tpu.ops import schur_cg as jcg
from slslam_tpu_torch.ops import kernels
from slslam_tpu_torch.ops import schur_ba as tba
from slslam_tpu_torch.ops import schur_cg as tcg

from test_schur_cg import BL, HD, _perturbed

torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def problem():
    cam0, orth0, obs, obs_cam, obs_line, cam_free, _ = _perturbed()
    C, L = len(cam0), len(orth0)
    p = jcg.pack_line_major(obs, obs_cam, obs_line, C, L)
    return cam0, orth0, obs, obs_cam, obs_line, cam_free, p


def _jax_solve(cam0, orth0, p, cam_free, line_free, max_iters):
    return jcg.global_ba_cg(
        jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(p.obs),
        jnp.asarray(p.obs_cam), jnp.asarray(p.obs_valid),
        jnp.asarray(p.cam_perm), jnp.asarray(p.cam_perm_valid),
        jnp.asarray(cam_free), jnp.asarray(line_free), jnp.asarray(BL),
        jnp.asarray(HD), robust=True, max_iters=max_iters)


def _port_solve(cam0, orth0, p, cam_free, line_free, max_iters, **kw):
    return tcg.global_ba_cg(
        _t(cam0), _t(orth0), _t(p.obs), _t(p.obs_cam), _t(p.obs_valid),
        _t(cam_free), _t(line_free), BL, HD, robust=True,
        max_iters=max_iters, **kw)


@pytest.mark.parametrize("forced", [False, True])
def test_pack_line_major_identical(problem, forced):
    _, _, obs, obs_cam, obs_line, _, p = problem
    C, L = int(obs_cam.max()) + 1, int(obs_line.max()) + 1
    kw = dict(k_l=p.kL + 8, k_c=p.kC + 16) if forced else {}
    a = jcg.pack_line_major(obs, obs_cam, obs_line, C, L, **kw)
    b = tcg.pack_line_major(obs, obs_cam, obs_line, C, L, **kw)
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                      err_msg=name)
        assert np.asarray(y).dtype == np.asarray(x).dtype, name


def test_eval_system_lm_matches_jax(problem):
    """K2 ``lm``'s twin against JAX's _eval_system_lm: cost, Hcc, Hll, gc,
    gl and the per-row Wb, zero on the padded rows."""
    cam0, orth0, _, _, _, cam_free, p = problem
    C, L = len(cam0), len(orth0)
    lfree = np.ones(L)
    lfree[3] = 0.0
    cf = cam_free.astype(np.float64)
    wv = p.obs_valid.astype(np.float64)
    ref = jax.jit(lambda *a: jcg._eval_system_lm(*a, True, "orth"))(
        *(jnp.asarray(x) for x in (cam0, orth0, p.obs, p.obs_cam, wv,
                                   p.cam_perm, p.cam_perm_valid, cf, lfree,
                                   BL, HD)))
    before = dict(kernels.launch_counts)
    got = tcg._eval_system_lm(_t(cam0), _t(orth0), _t(p.obs), _t(p.obs_cam),
                              _t(wv), _t(cf), _t(lfree), BL, HD, True)
    assert kernels.launch_counts == before     # CPU tensors: the twins ran
    assert got[5].shape == (L, p.kL, 6, 4)
    assert not p.obs_valid.all()
    assert torch.all(got[5][torch.as_tensor(~p.obs_valid)] == 0)
    for name, a, b in zip(("cost", "Hcc", "Hll", "gc", "gl", "Wb"), ref,
                          got):
        a = np.asarray(a)
        err = np.max(np.abs(b.numpy() - a)) / max(1.0, np.max(np.abs(a)))
        assert err <= 1e-10, (name, err)


def _jax_cost_only(cam, orth, p, obs, obs_cam, line_param="orth"):
    """The arithmetic of JAX's ``cost_only`` (slslam_tpu/ops/schur_cg.py:
    394-401, no priors) on ``p``'s validity with ``obs`` and ``obs_cam``
    in its place."""
    L, kL = p.obs_valid.shape
    r = jcg.lba_residual_batch(jnp.asarray(cam)[jnp.asarray(obs_cam)
                                                .reshape(-1)],
                               jnp.repeat(jnp.asarray(orth), kL, axis=0),
                               jnp.asarray(obs).reshape(-1, 8), BL,
                               line_param=line_param)
    _, cost_i = jba._robust_weights(r, HD, True)
    return float(jnp.sum(jnp.where(jnp.asarray(p.obs_valid).reshape(-1),
                                   cost_i, 0.0)))


def _garbage_padding(p, C):
    """``p``'s observations with NaNs, and its camera indices with
    indices out of range, on every padded row."""
    obs, oc = p.obs.copy(), p.obs_cam.copy()
    pad = ~p.obs_valid
    obs[pad] = np.nan
    oc[pad] = np.where(np.arange(int(pad.sum())) % 2, C + 5, -3)
    return obs, oc


@pytest.mark.parametrize("with_plan", [True, False],
                         ids=["solve's plan", "no plan (the tool)"])
def test_cost_lm_matches_jax_cost_only(problem, with_plan):
    """The trial cost's CPU twin (K2 ``cost``'s) against JAX's cost_only
    in float64 at the perturbed start, with NaNs and out-of-range cameras
    in the padded rows (JAX masks them; the twin never reads them), with
    the solve's plan and without one (tools/torch_large_map_bench.py's
    call): within 1e-12 relative, and no launch."""
    cam0, orth0, _, _, _, _, p = problem
    C = len(cam0)
    obs, oc = _garbage_padding(p, C)
    ref = _jax_cost_only(cam0, orth0, p, obs, oc)
    wv = _t(p.obs_valid.astype(np.float64))
    plan = tcg.lm_plan(_t(oc), wv, C) if with_plan else None
    before = dict(kernels.launch_counts)
    got = tcg._cost_lm(_t(cam0), _t(orth0), _t(obs), _t(oc), wv, BL, HD,
                       True, plan=plan)
    assert kernels.launch_counts == before
    assert got.shape == () and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), ref, rtol=1e-12)


def test_cost_lm_aid_lines_decode_to_the_orth_cost(problem):
    """aid lines: the twin's cost (residuals in aid) equals the cost of
    the same lines in orth, and the card's route (decode to orth, then the
    orth cost) gives the same; both against JAX's cost_only in aid."""
    from slslam_tpu_torch import geometry as geo
    cam0, orth0, _, _, _, _, p = problem
    C, L = len(cam0), len(orth0)
    aid = geo.LINE_ENCODERS["aid"](geo.orth_to_av(_t(orth0)))
    wv = _t(p.obs_valid.astype(np.float64))
    args = (_t(p.obs), _t(p.obs_cam), wv, BL, HD, True)
    orth_cost = float(tcg._cost_lm(_t(cam0), _t(orth0), *args))
    aid_cost = float(tcg._cost_lm(_t(cam0), aid, *args, line_param="aid"))
    decoded = geo.av_to_orth(geo.LINE_DECODERS["aid"](aid))
    rows = dict(obs=_t(p.obs).reshape(-1, 8),
                obs_cam=_t(p.obs_cam).reshape(-1).to(torch.int32),
                obs_line=tcg._line_rows(L, p.kL, "cpu"),
                w_valid=wv.reshape(-1), baseline=BL, huber_delta=HD)
    card_route = float(kernels.fused_cost_twin(_t(cam0), decoded, **rows))
    jax_aid = _jax_cost_only(cam0, aid.numpy(), p, p.obs, p.obs_cam, "aid")
    for got in (aid_cost, card_route, jax_aid):
        np.testing.assert_allclose(got, orth_cost, rtol=1e-10)
    np.testing.assert_allclose(aid_cost, jax_aid, rtol=1e-12)


def test_solve_step_cg_matches_jax(problem):
    """One damped PCG step on the same blocks: the same PCG iteration
    count and the same step (the 6x6 preconditioner blocks go through the
    size-agnostic equilibrated inverse on both sides)."""
    cam0, orth0, _, _, _, cam_free, p = problem
    C, L = len(cam0), len(orth0)
    cf = cam_free.astype(np.float64)
    lf = np.ones(L)
    wv = p.obs_valid.astype(np.float64)
    blocks = jax.jit(lambda *a: jcg._eval_system_lm(*a, True, "orth"))(
        *(jnp.asarray(x) for x in (cam0, orth0, p.obs, p.obs_cam, wv,
                                   p.cam_perm, p.cam_perm_valid, cf, lf,
                                   BL, HD)))
    lam = 1e-3
    ref = jcg._solve_step_cg(*blocks[1:], jnp.zeros((0, 6, 6)),
                             jnp.zeros(0, jnp.int32), jnp.zeros(0, jnp.int32),
                             jnp.asarray(p.obs_cam), jnp.asarray(p.cam_perm),
                             jnp.asarray(p.cam_perm_valid), lam,
                             jnp.asarray(cf), jnp.asarray(lf), 100, 1e-2)
    plan = tcg.lm_plan(_t(p.obs_cam), _t(wv), C)
    got = tcg._solve_step_cg(*(_t(x) for x in blocks[1:]), _t(p.obs_cam),
                             plan.cam, lam, _t(cf), _t(lf), 100, 1e-2)
    assert got[4] == int(ref[4]) > 0
    for name, a, b in zip(("dc", "dl", "damp_quad", "g_dot_d"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                   atol=1e-12, err_msg=name)


def test_inv_equilibrated_6x6_matches_jax():
    rng = np.random.default_rng(1)
    M = rng.standard_normal((16, 6, 6))
    H = M @ np.swapaxes(M, -1, -2) + 1e-3 * np.eye(6)
    a = jba._inv4_equilibrated(jnp.asarray(H))
    b = tba._inv4_equilibrated(torch.as_tensor(H))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9)


@pytest.mark.parametrize("max_iters", [4, 25])
def test_global_ba_cg_matches_jax(problem, max_iters):
    cam0, orth0, _, _, _, cam_free, p = problem
    L = len(orth0)
    cj, lj, sj = _jax_solve(cam0, orth0, p, cam_free, np.ones(L, bool),
                            max_iters)
    ct, lt, st = _port_solve(cam0, orth0, p, cam_free, np.ones(L, bool),
                             max_iters)
    assert int(st.iterations) == int(sj.iterations)
    assert int(st.cg_iterations) > 0
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-9)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-9)


def test_fixed_cameras_stay_fixed(problem):
    cam0, orth0, _, _, _, cam_free, p = problem
    cam_free = cam_free.copy()
    cam_free[:2] = False
    ct, _, _ = _port_solve(cam0, orth0, p, cam_free,
                           np.ones(len(orth0), bool), 10)
    np.testing.assert_array_equal(ct.numpy()[:2], cam0[:2])


def test_padded_lines_inert(problem):
    """Extra padded line rows (no valid observation, not free) change
    neither the cameras nor the real lines."""
    cam0, orth0, _, _, _, cam_free, p = problem
    L = len(orth0)
    ca, la, sa = _port_solve(cam0, orth0, p, cam_free, np.ones(L, bool), 8)
    Lp = L + 16
    orth_p = np.zeros((Lp, 4))
    orth_p[:, 3] = 0.5
    orth_p[:L] = orth0
    pad = p._replace(
        obs=np.concatenate([p.obs, np.zeros((16, p.kL, 8))]),
        obs_cam=np.concatenate([p.obs_cam, np.zeros((16, p.kL), np.int32)]),
        obs_valid=np.concatenate([p.obs_valid, np.zeros((16, p.kL), bool)]))
    lf = np.arange(Lp) < L
    cb, lb, sb = _port_solve(cam0, orth_p, pad, cam_free, lf, 8)
    assert int(sb.iterations) == int(sa.iterations)
    np.testing.assert_allclose(cb.numpy(), ca.numpy(), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(lb.numpy()[:L], la.numpy(), rtol=1e-7,
                               atol=1e-9)


@pytest.mark.parametrize("option", ["prior_c", "prior_edges"])
def test_priors_raise(problem, option):
    """Malformed priors are refused: a chain of the wrong length, edges of
    a tuple that is neither (ei, ej, c) nor (ei, ej, c, sig)."""
    cam0, orth0, _, _, _, cam_free, p = problem
    bad = {"prior_c": np.zeros((len(cam0), 6)),
           "prior_edges": (np.array([0]), np.array([1]))}[option]
    with pytest.raises(ValueError, match=option):
        _port_solve(cam0, orth0, p, cam_free, np.ones(len(orth0), bool), 2,
                    **{option: bad})


def _priors(cam0, seed=5):
    """prior_c: the chain of cam0's relative poses, perturbed; edges: two
    loop edges, their constraints perturbed too."""
    from slslam_tpu_torch.hostgeom import Pose
    rng = np.random.default_rng(seed)
    P = [Pose.from_wt(w) for w in cam0]

    def rel(a, b):
        return (P[b] @ P[a].inv()).wt() + rng.standard_normal(6) * 0.01

    C = len(cam0)
    chain = np.stack([rel(i, i + 1) for i in range(C - 1)])
    ei, ej = np.array([0, 1], np.int32), np.array([C - 1, C - 2], np.int32)
    c = np.stack([rel(a, b) for a, b in zip(ei, ej)])
    return chain, (ei, ej, c), (ei, ej, c, np.array([[0.05, 0.2],
                                                     [0.5, 3.0]]))


@pytest.mark.parametrize("which", ["prior_c", "prior_edges3",
                                   "prior_edges4", "both"])
def test_global_ba_cg_priors_match_jax(problem, which):
    """global_ba_cg with the odometry-chain prior, with 3- and 4-tuple
    prior edges, and with both: the same LM iterations as JAX, cameras and
    lines within 1e-8, costs within 1e-9."""
    cam0, orth0, _, _, _, cam_free, p = problem
    L = len(orth0)
    chain, e3, e4 = _priors(cam0)
    kw = {"prior_c": dict(prior_c=chain),
          "prior_edges3": dict(prior_edges=e3),
          "prior_edges4": dict(prior_edges=e4),
          "both": dict(prior_c=chain, prior_edges=e3)}[which]
    sig = dict(prior_sigma_rot=0.02, prior_sigma_t=0.1)
    jkw = {k: (jnp.asarray(v) if k == "prior_c" else
               tuple(jnp.asarray(x) for x in v)) for k, v in kw.items()}
    cj, lj, sj = jcg.global_ba_cg(
        jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(p.obs),
        jnp.asarray(p.obs_cam), jnp.asarray(p.obs_valid),
        jnp.asarray(p.cam_perm), jnp.asarray(p.cam_perm_valid),
        jnp.asarray(cam_free), jnp.asarray(np.ones(L, bool)),
        jnp.asarray(BL), jnp.asarray(HD), robust=True, max_iters=25,
        **sig, **jkw)
    ct, lt, st = _port_solve(cam0, orth0, p, cam_free, np.ones(L, bool), 25,
                             **sig, **kw)
    assert int(st.iterations) == int(sj.iterations) > 2
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-9)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-9)


def test_solve_step_cg_with_prior_matches_jax(problem):
    """One damped PCG step with the priors' Hoff in the matvec."""
    cam0, orth0, _, _, _, cam_free, p = problem
    C, L = len(cam0), len(orth0)
    cf = cam_free.astype(np.float64)
    lf = np.ones(L)
    wv = p.obs_valid.astype(np.float64)
    blocks = jax.jit(lambda *a: jcg._eval_system_lm(*a, True, "orth"))(
        *(jnp.asarray(x) for x in (cam0, orth0, p.obs, p.obs_cam, wv,
                                   p.cam_perm, p.cam_perm_valid, cf, lf,
                                   BL, HD)))
    chain, _, e4 = _priors(cam0)
    prior = tcg._prior_edges(C, chain, e4, 0.02, 0.1, torch.float64, "cpu")
    _, gc_e, Hcc_e, Hoff = tba.prior_terms(prior, _t(cam0), _t(cf))
    Hcc = blocks[1] + jnp.asarray(Hcc_e.numpy())
    gc = blocks[3] + jnp.asarray(gc_e.numpy())
    ref = jcg._solve_step_cg(
        Hcc, blocks[2], gc, *blocks[4:], jnp.asarray(Hoff.numpy()),
        jnp.asarray(prior.ei.numpy(), jnp.int32),
        jnp.asarray(prior.ej.numpy(), jnp.int32), jnp.asarray(p.obs_cam),
        jnp.asarray(p.cam_perm), jnp.asarray(p.cam_perm_valid), 1e-3,
        jnp.asarray(cf), jnp.asarray(lf), 100, 1e-2)
    plan = tcg.lm_plan(_t(p.obs_cam), _t(wv), C)
    got = tcg._solve_step_cg(
        _t(Hcc), _t(blocks[2]), _t(gc), *(_t(x) for x in blocks[4:]),
        _t(p.obs_cam), plan.cam, 1e-3, _t(cf), _t(lf), 100, 1e-2, Hoff,
        prior)
    assert got[4] == int(ref[4]) > 0
    for name, a, b in zip(("dc", "dl", "damp_quad", "g_dot_d"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
