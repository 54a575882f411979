"""The port's Schur-LM solver (slslam_tpu_torch/ops/schur_ba.py) vs JAX.

Both solve __graft_entry__._example_ba_problem in float64; outputs agree to
1e-8 and BAStats.iterations are identical (the LM accept / converge
decisions must follow the same path).  The window anchors and the staged
solve, and the aid / asd evaluate by the chain rule around an orth
evaluate (K2's on the card; its plain twin here), against JAX's jacfwd in
those parameterizations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from slslam_tpu.ops import schur_ba as jba
from slslam_tpu_torch.ops import schur_ba as tba

torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)


def _problem(**kw):
    j = ge._example_ba_problem(dtype=jnp.float64, **kw)
    t = [torch.as_tensor(np.array(x)) for x in j[:8]]
    return j, t + [float(j[8]), float(j[9])]


@pytest.mark.parametrize("max_iters", [3, 10])
def test_local_ba_matches_jax(max_iters):
    j, t = _problem()
    cj, lj, sj = jba.local_ba(*j, robust=True, max_iters=max_iters)
    ct, lt, st = tba.local_ba(*t, robust=True, max_iters=max_iters)
    assert int(st.iterations) == int(sj.iterations)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-8)


def test_local_ba_pose_only_matches_jax():
    j, t = _problem(C=4, L=32, O=128)
    cj, lj, sj = jba.local_ba(*j, robust=True, max_iters=10, pose_only=True)
    ct, lt, st = tba.local_ba(*t, robust=True, max_iters=10, pose_only=True)
    assert int(st.iterations) == int(sj.iterations)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_lines_gn_matches_jax():
    j, t = _problem()
    cam, line, obs, oc, ol, ov, _, lfree, bl, hd = j
    a = jba.lines_gn(cam, line, obs, oc, ol, ov, lfree, bl, hd, iters=4)
    cam, line, obs, oc, ol, ov, _, lfree, bl, hd = t
    b = tba.lines_gn(cam, line, obs, oc, ol, ov, lfree, bl, hd, iters=4)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_solve_step_matches_jax():
    j, t = _problem()
    cam, line, obs, oc, ol, ov, cfree, lfree, bl, hd = j
    wv, cf, lf = (x.astype(jnp.float64) for x in (ov, cfree, lfree))
    sys_j = jax.jit(lambda *a: jba._eval_system(*a, True))(
        cam, line, obs, oc, ol, wv, cf, lf, bl, hd)
    a = jax.jit(jba._solve_step)(*sys_j[1:], 1e-3, cf, lf)
    sys_t = [torch.as_tensor(np.array(x)) for x in sys_j[1:]]
    b = tba._solve_step(*sys_t, 1e-3, torch.as_tensor(np.array(cf)),
                        torch.as_tensor(np.array(lf)))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-9,
                                   atol=1e-12)


def test_inv4_equilibrated_matches_jax():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((16, 4, 4))
    H = M @ np.swapaxes(M, -1, -2) + 1e-3 * np.eye(4)
    a = jba._inv4_equilibrated(jnp.asarray(H))
    b = tba._inv4_equilibrated(torch.as_tensor(H))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tolerances_match_jax(dtype):
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    assert tba._tolerances(dtype) == jba._tolerances(jdt)


@pytest.mark.parametrize("option", ["cam_anchor_sigmas", "prior_edges"])
def test_unported_options_raise(option):
    """Both options are ported; they raise on malformed input:
    cam_anchor_sigmas that are not positive, prior_edges on the pose-only
    path (JAX asserts the same) or of the wrong shapes."""
    _, t = _problem(C=4, L=8, O=32)
    if option == "cam_anchor_sigmas":
        with pytest.raises(ValueError, match="positive"):
            tba.local_ba(*t, cam_anchor_sigmas=(0.1, 0.0))
        tba.local_ba(*t, max_iters=1, cam_anchor_sigmas=(0.1, 0.1))
        return
    edges = (np.array([0]), np.array([1]), np.zeros((1, 6)),
             np.ones((1, 2)))
    with pytest.raises(ValueError, match="pose_only"):
        tba.local_ba(*t, pose_only=True, prior_edges=edges)
    with pytest.raises(ValueError, match="shapes"):
        tba.local_ba(*t, prior_edges=edges[:3] + (np.ones((2, 2)),))


def _blocked_problem(C=8, L=64, O=256):
    """_example_ba_problem's valid rows in the camera-major blocked layout
    (OmC rows per camera, obs_cam == repeat(arange(C), OmC)), float64."""
    j = ge._example_ba_problem(C=C, L=L, O=O, dtype=jnp.float64)
    cam, line, obs, oc, ol, ov, cf, lf = (np.array(x) for x in j[:8])
    cnt = np.bincount(oc[ov], minlength=C)
    OmC = max(8, -(-int(cnt.max()) // 8) * 8)
    ob_b = np.zeros((C * OmC, 8))
    ol_b = np.zeros(C * OmC, np.int32)
    ov_b = np.zeros(C * OmC, bool)
    fill = np.zeros(C, int)
    for o in np.flatnonzero(ov):
        k = oc[o] * OmC + fill[oc[o]]
        fill[oc[o]] += 1
        ob_b[k], ol_b[k], ov_b[k] = obs[o], ol[o], True
    oc_b = np.repeat(np.arange(C, dtype=np.int32), OmC)
    return [cam, line, ob_b, oc_b, ol_b, ov_b, cf, lf, float(j[8]),
            float(j[9])]


def _prior_edges(cam, rng):
    """A chain over cameras 0-6 (strong), one loop edge 7 -> 2 (weak) and
    two zero-weight padding self-edges; constraints off the cameras'
    current relative poses by a seeded perturbation."""
    from slslam_tpu_torch.hostgeom import Pose
    ei = [0, 1, 2, 3, 4, 5, 7, 0, 0]
    ej = [1, 2, 3, 4, 5, 6, 2, 0, 0]
    c, sig = [], []
    for k, (a, b) in enumerate(zip(ei, ej)):
        if k >= 7:
            c.append(np.zeros(6))
            sig.append((1e9, 1e9))
            continue
        rel = (Pose.from_wt(cam[b]) @ Pose.from_wt(cam[a]).inv()).wt()
        c.append(rel + rng.standard_normal(6) * 0.02)
        sig.append((0.01, 0.05) if k < 6 else (0.2, 1.0))
    return (np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(c), np.asarray(sig))


@pytest.mark.parametrize("max_iters", [4, 10])
def test_local_ba_prior_edges_matches_jax(max_iters):
    """The joint polish's solve: local_ba with 4-tuple prior_edges against
    JAX's local_ba_impl(assembly="blocked", prior_edges=...): the same LM
    iterations, cameras and lines within 1e-8.  (The example problem's
    observations are random, not a geometry: past ~12 iterations its LM
    path amplifies rounding, JAX's own "scatter" and "blocked" assemblies
    part by 4e-8 at 15 and 2e-4 at 30.)"""
    a = _blocked_problem()
    pe = _prior_edges(a[0], np.random.default_rng(3))
    j = [jnp.asarray(x) for x in a[:8]] + [jnp.asarray(a[8]),
                                           jnp.asarray(a[9])]
    cj, lj, sj = jax.jit(lambda *x: jba.local_ba_impl(
        *x[:10], robust=True, max_iters=max_iters, assembly="blocked",
        prior_edges=x[10:]))(*j, *(jnp.asarray(x) for x in pe))
    t = [torch.as_tensor(x) for x in a[:8]] + a[8:]
    ct, lt, st = tba.local_ba(*t, robust=True, max_iters=max_iters,
                              prior_edges=pe)
    assert int(st.iterations) == int(sj.iterations) > 2
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-8)
    # the strong chain priors hold: without them the solve lands elsewhere
    cu, _, _ = tba.local_ba(*t, robust=True, max_iters=max_iters)
    assert float(torch.max(torch.abs(cu - ct))) > 1e-6


# The window anchors on the example problem, whose observations are random:
# at 10 LM iterations a 1e-15 relative change of the observations moves the
# anchored solve's lines by 7-9e-6 (the port against itself), so the
# anchored solves are held at 4 iterations, where that witness is 5e-11.
@pytest.mark.parametrize("anchor", [None, (0.01, 0.05)])
@pytest.mark.parametrize("pose_only", [False, True])
def test_local_ba_anchors_match_jax(anchor, pose_only):
    j, t = _problem()
    ja = None if anchor is None else tuple(jnp.asarray(x) for x in anchor)
    cj, lj, sj = jba.local_ba(*j, robust=True, max_iters=4,
                              pose_only=pose_only, cam_anchor_sigmas=ja)
    ct, lt, st = tba.local_ba(*t, robust=True, max_iters=4,
                              pose_only=pose_only, cam_anchor_sigmas=anchor)
    assert int(st.iterations) == int(sj.iterations)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-8)
    if anchor is not None:   # the anchors hold the cameras back
        c0, _, _ = tba.local_ba(*t, robust=True, max_iters=4,
                                pose_only=pose_only)
        assert float(torch.max(torch.abs(c0 - ct))) > 1e-9


@pytest.mark.parametrize("anchor", [None, (0.01, 0.05)])
def test_staged_local_ba_matches_jax(anchor):
    """lines-GN on the free lines, then the window solve (schur_ba.py:
    661-682), with and without window anchors, 4 LM iterations: identical
    iterations, cameras within 1e-8, lines within 1e-8 of the largest line
    parameter (lines-GN alone parts from JAX by 2.3e-7 on parameters up to
    112 on this problem, within test_lines_gn_matches_jax's rtol)."""
    j, t = _problem()
    ja = None if anchor is None else tuple(jnp.asarray(x) for x in anchor)
    cj, lj, sj = jba.staged_local_ba(*j, robust=True, max_iters=4,
                                     gn_iters=4, cam_anchor_sigmas=ja)
    ct, lt, st = tba.staged_local_ba(*t, robust=True, max_iters=4,
                                     gn_iters=4, cam_anchor_sigmas=anchor)
    assert int(st.iterations) == int(sj.iterations) > 1
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    lj = np.asarray(lj)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0,
                               atol=1e-8 * np.max(np.abs(lj)))
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-10)


def _problem_in(line_param):
    """The example problem with its lines re-encoded in ``line_param``."""
    from slslam_tpu import geometry as jgeo
    j, t = _problem()
    enc = {"aid": jgeo.av_to_aid, "asd": jgeo.av_to_asd}[line_param]
    lp = enc(jgeo.orth_to_av(j[1]))
    j = (j[0], lp) + tuple(j[2:])
    t = [t[0], torch.as_tensor(np.array(lp))] + t[2:]
    return j, t


def _chain_twin(*a):
    """The orth twin as the chain rule's inner evaluate (the card runs K2
    there)."""
    from slslam_tpu_torch.ops.kernels import fused_eval_twin
    return fused_eval_twin(*a[:-1])


@pytest.mark.parametrize("line_param", ["aid", "asd"])
def test_chain_rule_evaluate_matches_jax(line_param):
    """Cost and every block of the window evaluate, aid / asd by the chain
    rule (M = d orth / d p per line) against JAX's jacfwd in aid / asd:
    within 1e-9 relative."""
    from slslam_tpu_torch.ops.kernels import fused_eval_chart
    j, t = _problem_in(line_param)
    cam, line, obs, oc, ol, ov, cfree, lfree, bl, hd = j
    wv, cf, lf = (x.astype(jnp.float64) for x in (ov, cfree, lfree))
    want = jax.jit(lambda *a: jba._eval_system(*a, True,
                                               line_param=line_param))(
        cam, line, obs, oc, ol, wv, cf, lf, bl, hd)
    cam, line, obs, oc, ol, ov, cfree, lfree, bl, hd = t
    got = fused_eval_chart(cam, line, obs, oc.to(torch.int32),
                           ol.to(torch.int32), ov.double(), cfree.double(),
                           lfree.double(), bl, hd, robust=True,
                           line_param=line_param, variant="full",
                           evaluate=_chain_twin)
    for name, a, b in zip(("cost", "Hcc", "Hll", "gc", "gl", "W"), want,
                          got):
        a = np.asarray(a)
        err = np.max(np.abs(b.numpy() - a)) / max(np.max(np.abs(a)), 1e-300)
        assert err <= 1e-9, (name, err)


@pytest.mark.parametrize("line_param", ["aid", "asd"])
def test_chain_rule_local_ba_matches_jax(line_param, monkeypatch):
    """The window solve with aid / asd lines, every evaluate through the
    chain rule as on the card, against JAX's local_ba in aid / asd:
    identical LM iterations, outputs within 1e-8."""
    from slslam_tpu_torch.ops import kernels
    calls = []

    def routed(*a, line_param="orth", variant="full", plan=None, **k):
        calls.append(variant)
        return kernels.fused_eval_chart(*a, line_param=line_param,
                                        variant=variant, plan=plan,
                                        evaluate=_chain_twin, **k)

    monkeypatch.setattr(tba, "fused_eval", routed)
    j, t = _problem_in(line_param)
    cj, lj, sj = jba.local_ba(*j, robust=True, max_iters=10,
                              line_param=line_param)
    ct, lt, st = tba.local_ba(*t, robust=True, max_iters=10,
                              line_param=line_param)
    assert len(calls) == int(st.iterations) > 1
    assert int(st.iterations) == int(sj.iterations)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
