"""The port's Schur-LM solver (slslam_tpu_torch/ops/schur_ba.py) vs JAX.

Both solve __graft_entry__._example_ba_problem in float64; outputs agree to
1e-8 and BAStats.iterations are identical (the LM accept / converge
decisions must follow the same path)."""

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
    _, t = _problem(C=4, L=8, O=32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tba.local_ba(*t, **{option: (0.1, 0.1)})
