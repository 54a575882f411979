"""PyTorch port geometry (slslam_tpu_torch/geometry.py) vs the JAX original.

Same inputs, made from a numpy seed, through both; float64; tolerance
1e-12 (the two evaluate the same formulas in the same order up to the
summation order of 3x3 products)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu import geometry as jgeo
from slslam_tpu_torch import geometry as tgeo

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _both(jfn, tfn, *args):
    a = jfn(*(jnp.asarray(x) for x in args))
    b = tfn(*(torch.as_tensor(np.array(x)) for x in args))
    if isinstance(a, tuple):
        return [np.asarray(x) for x in a], [y.numpy() for y in b]
    return np.asarray(a), b.numpy()


def _rng(seed):
    return np.random.default_rng(seed)


def _angle_axes(seed):
    rng = _rng(seed)
    w = rng.standard_normal((64, 3)) * 0.7
    w[0] = 0.0                                    # identity
    w[1] = [1e-9, -2e-9, 5e-10]                   # Taylor branch
    w[2] = [np.pi - 1e-4, 0.0, 0.0]               # near pi
    w[3] = [0.0, 2.0, -1.0]
    w[3] *= (np.pi - 1e-3) / np.linalg.norm(w[3])
    return w


def _lines(seed, n=64):
    rng = _rng(seed)
    v = rng.standard_normal((n, 3))
    p = rng.standard_normal((n, 3)) * 3.0
    p -= np.sum(p * v, -1, keepdims=True) / np.sum(v * v, -1,
                                                   keepdims=True) * v
    av = np.concatenate([p, v], -1)
    # gimbal lock: moment along +-z (x = n_hat = +-e_z)
    av[0] = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    av[1] = [0.0, 1.0, 0.0, 1.0, 0.0, 0.0]
    return av


@pytest.mark.parametrize("seed", [0, 1])
def test_rodrigues(seed):
    a, b = _both(jgeo.rodrigues, tgeo.rodrigues, _angle_axes(seed))
    np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_so3_log(seed):
    R = np.asarray(jgeo.rodrigues(jnp.asarray(_angle_axes(seed))))
    a, b = _both(jgeo.so3_log, tgeo.so3_log, R)
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9)


def _wts(seed, n=32):
    rng = _rng(seed)
    wt = rng.standard_normal((n, 6)) * 0.5
    wt[0] = 0.0
    return wt


def test_wt_to_Rt_and_back():
    wt = _wts(2)
    a, b = _both(jgeo.wt_to_Rt, tgeo.wt_to_Rt, wt)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, **TOL)
    a, b = _both(jgeo.Rt_to_wt, tgeo.Rt_to_wt, *a)
    np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10)


def test_wt_inv():
    a, b = _both(jgeo.wt_inv, tgeo.wt_inv, _wts(3))
    np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("broadcast", [False, True])
def test_wt_compose(broadcast):
    x, y = _wts(4), _wts(5)
    if broadcast:   # the engine composes a whole ring with one motion
        y = y[7]
        a = np.asarray(jnp.stack([jgeo.wt_compose(jnp.asarray(r),
                                                  jnp.asarray(y))
                                  for r in x]))
        b = tgeo.wt_compose(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    else:
        a, b = _both(jgeo.wt_compose, tgeo.wt_compose, x, y)
    np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10)


def test_t_rel():
    R2, t2 = [np.asarray(v) for v in jgeo.wt_to_Rt(jnp.asarray(_wts(6)))]
    R1, t1 = [np.asarray(v) for v in jgeo.wt_to_Rt(jnp.asarray(_wts(7)))]
    a, b = _both(jgeo.t_rel, tgeo.t_rel, R2, t2, R1, t1)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, **TOL)


def test_line_to_pose():
    R, t = [np.asarray(v) for v in jgeo.wt_to_Rt(jnp.asarray(_wts(8)))]
    lines = _lines(9, 32)
    a, b = _both(jgeo.line_to_pose, tgeo.line_to_pose, lines, R, t)
    np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("seed", [10, 11])
def test_av_to_orth(seed):
    a, b = _both(jgeo.av_to_orth, tgeo.av_to_orth, _lines(seed))
    np.testing.assert_allclose(b, a, rtol=1e-11, atol=1e-11)


def test_orth_rotation_and_orth_to_av():
    orth = np.asarray(jgeo.av_to_orth(jnp.asarray(_lines(12))))
    a, b = _both(jgeo.orth_rotation, tgeo.orth_rotation, orth)
    np.testing.assert_allclose(b, a, **TOL)
    a, b = _both(jgeo.orth_to_av, tgeo.orth_to_av, orth)
    np.testing.assert_allclose(b, a, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("name", ["aid", "asd"])
def test_alternative_line_params(name):
    enc_j = {"aid": jgeo.av_to_aid, "asd": jgeo.av_to_asd}[name]
    dec_j = {"aid": jgeo.aid_to_av, "asd": jgeo.asd_to_av}[name]
    lines = _lines(13)[2:]
    lines[:, :3] *= 0.3                       # keep exp(depth) moderate
    a, b = _both(enc_j, tgeo.LINE_ENCODERS[name], lines)
    np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10)
    a, b = _both(dec_j, tgeo.LINE_DECODERS[name], a)
    np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10)


def test_ppp_pi_pipi_plk():
    rng = _rng(14)
    x1, x2, x3 = (rng.standard_normal((16, 3)) for _ in range(3))
    a, b = _both(jgeo.ppp_pi, tgeo.ppp_pi, x1, x2, x3)
    np.testing.assert_allclose(b, a, **TOL)
    pi2 = rng.standard_normal((16, 4))
    a2, b2 = _both(jgeo.pipi_plk, tgeo.pipi_plk, a, pi2)
    np.testing.assert_allclose(b2, a2, **TOL)


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, pkgutil, importlib, slslam_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "slslam_tpu_torch.__path__, 'slslam_tpu_torch.')]\n"
        "assert len(names) >= 10, names\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
