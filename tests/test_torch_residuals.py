"""PyTorch port residuals, Jacobians, scoring and triangulation vs JAX.

Same numpy-seeded inputs through slslam_tpu.ops.{residuals,triangulate,
schur_ba._robust_weights} and their slslam_tpu_torch counterparts, in
float64.  Tolerance 1e-10: the same formulas, with forward-mode derivatives
on both sides (jax.jacfwd vs torch.func.jacfwd)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu import geometry as jgeo
from slslam_tpu.ops import residuals as jres
from slslam_tpu.ops.schur_ba import _robust_weights as j_robust
from slslam_tpu.ops.triangulate import triangulate_lines as j_tri
from slslam_tpu_torch.ops import residuals as tres
from slslam_tpu_torch.ops.triangulate import triangulate_lines as t_tri

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)


def _problem(seed, O=96, line_param="orth"):
    rng = np.random.default_rng(seed)
    cam = rng.standard_normal((O, 6)) * 0.1
    cam[0, :3] = 0.0                        # rodrigues' Taylor branch
    if line_param == "orth":
        line = rng.standard_normal((O, 4)) * 0.2
        line[:, 3] = 0.3 + 0.5 * rng.random(O)
    elif line_param == "aid":
        line = rng.standard_normal((O, 4)) * 0.3
        line[:, 3] = 0.2 + rng.random(O)
    else:
        line = rng.standard_normal((O, 4)) * 0.3
        line[:, 3] = 1.5 + rng.random(O)
    obs = rng.standard_normal((O, 8)) * 0.2
    return cam, line, obs


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("line_param", ["orth", "aid", "asd"])
def test_lba_residual_jac_batch(line_param):
    cam, line, obs = _problem(0, line_param=line_param)
    a = _jit(jres.lba_residual_jac_batch, line_param=line_param)(
        *_j(cam, line, obs), 0.12)
    b = tres.lba_residual_jac_batch(*_t(cam, line, obs), 0.12,
                                    line_param=line_param)
    for name, x, y in zip(("r", "Jc", "Jl"), a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), err_msg=name,
                                   **TOL)


def test_lba_residual_jac_cam_and_line():
    cam, line, obs = _problem(1)
    a = _jit(jres.lba_residual_jac_cam_batch)(*_j(cam, line, obs), 0.12)
    b = tres.lba_residual_jac_cam_batch(*_t(cam, line, obs), 0.12)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)
    a = _jit(jres.lba_residual_jac_line_batch)(*_j(cam, line, obs),
                                                 0.12)
    b = tres.lba_residual_jac_line_batch(*_t(cam, line, obs), 0.12)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)


def test_lba_residual_batch():
    cam, line, obs = _problem(2)
    a = jres.lba_residual_batch(*_j(cam, line, obs), 0.12)
    b = tres.lba_residual_batch(*_t(cam, line, obs), 0.12)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_score_error_hyp_obs():
    rng = np.random.default_rng(3)
    H, N = 16, 40
    wt = rng.standard_normal((H, 6)) * 0.1
    R = np.asarray(jgeo.rodrigues(jnp.asarray(wt[:, :3])))
    t = wt[:, 3:]
    obs = rng.standard_normal((N, 8)) * 0.2
    lines = np.concatenate([rng.standard_normal((N, 3)) * 2.0,
                            rng.standard_normal((N, 3))], -1)
    a = _jit(jres.score_error_hyp_obs)(*_j(obs, R, t, lines), 0.12)
    b = tres.score_error_hyp_obs(*_t(obs, R, t, lines), 0.12)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("robust", [True, False])
def test_robust_weights(robust):
    rng = np.random.default_rng(4)
    r = rng.standard_normal((200, 4)) * 0.004
    r[0] = 0.0
    a = j_robust(jnp.asarray(r), 1.0 / 406.05, robust)
    b = tres.robust_weights(torch.as_tensor(r), 1.0 / 406.05, robust)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("shape", [(48,), (3, 16)])
def test_triangulate_lines(shape):
    """Any number of leading dims; zero rows hit the depth clamp, no NaN."""
    rng = np.random.default_rng(5)
    obs = rng.standard_normal(shape + (8,)) * 0.3
    obs.reshape(-1, 8)[:4] = 0.0
    a = np.asarray(j_tri(jnp.asarray(obs), 0.12))
    b = t_tri(torch.as_tensor(obs), 0.12).numpy()
    assert b.shape == shape + (6,)
    assert np.all(np.isfinite(b))
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("line_param", ["orth", "aid", "asd"])
def test_float32_jacobians_stay_float32(line_param):
    """torch.func promotes some 0-dim per-sample expressions to float64;
    the float32 engine on the card needs float32 Jacobians throughout."""
    cam, line, obs = _problem(6, O=8, line_param=line_param)
    c, l, o = (torch.as_tensor(x, dtype=torch.float32)
               for x in (cam, line, obs))
    outs = (tres.lba_residual_jac_batch(c, l, o, 0.12, line_param)
            + tres.lba_residual_jac_cam_batch(c, l, o, 0.12, line_param)
            + tres.lba_residual_jac_line_batch(c, l, o, 0.12, line_param))
    assert all(x.dtype == torch.float32 for x in outs)
