"""The port's RANSAC and VO (slslam_tpu_torch/ops/{ransac,vo_pipeline}.py)
vs JAX on a real frame pair of the house world, float64.

JAX's Gumbel noise (jax.random.gumbel under the same key) is injected into
the port, so both sample the same hypotheses: scores and inlier sets are
identical, motions agree to 1e-9."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.config import SlamConfig
from slslam_tpu.ops import ransac as jr
from slslam_tpu.ops.triangulate import triangulate_lines
from slslam_tpu.ops.vo_pipeline import vo_body as j_vo_body
from slslam_tpu.sim import StereoLineRenderer, house_segments, wave_trajectory
from slslam_tpu_torch.ops import ransac as tr
from slslam_tpu_torch.ops.vo_pipeline import vo_body as t_vo_body

torch.set_num_threads(1)

CFG = dataclasses.replace(SlamConfig(), compute_dtype="float64")
H = CFG.ransac_num_hypotheses


@pytest.fixture(scope="module")
def pair():
    """Common features of frames 5 and 6, padded to 64 rows, 12 of them
    invalid; lines triangulated in frame 5."""
    poses = wave_trajectory(num_frames=400)[5:7]
    ren = StereoLineRenderer(house_segments(), CFG.camera, noise_px=0.2,
                             seed=4)
    f0, f1 = (ren.observe(T) for T in poses)
    common = sorted(set(f0) & set(f1))
    N = 64
    obs0 = np.zeros((N, 8))
    obs1 = np.zeros((N, 8))
    valid = np.zeros(N, bool)
    for k, fid in enumerate(common[:N - 12]):
        obs0[k], obs1[k], valid[k] = f0[fid], f1[fid], True
    lines = np.asarray(triangulate_lines(jnp.asarray(obs0),
                                         CFG.camera.baseline))
    key = jax.random.PRNGKey(7)
    gumbel = np.asarray(jax.random.gumbel(key, (H, N), jnp.float64))
    return obs0, obs1, lines, valid, key, gumbel


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("relin", [1, 2])
def test_minimal_motion(pair, relin):
    obs0, obs1, _, _, _, _ = pair
    idx = [0, 3, 8, 13, 21]
    a, ok_a = jax.jit(functools.partial(jr.minimal_motion,
                                        relin_iters=relin))(
        jnp.asarray(obs0[idx]), jnp.asarray(obs1[idx]), -0.12)
    b, ok_b = tr.minimal_motion(_t(obs0[idx]), _t(obs1[idx]), -0.12,
                                relin_iters=relin)
    assert bool(ok_a) == bool(ok_b)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                               atol=1e-12)


def test_ransac_stage_with_injected_noise(pair):
    obs0, obs1, lines, valid, key, gumbel = pair
    kw = dict(max_t_norm=1.0, num_hyp=H, sample_size=5, relin_iters=2)
    a = jax.jit(functools.partial(jr.ransac_stage, **kw))(
        jnp.asarray(obs0), jnp.asarray(obs1), jnp.asarray(lines),
        jnp.asarray(valid), key, 0.12, CFG.error_thr)
    b = tr.ransac_stage(_t(obs0), _t(obs1), _t(lines), _t(valid), 0.12,
                        CFG.error_thr, gumbel=_t(gumbel), **kw)
    assert int(b.best_score) == int(a.best_score)
    assert int(b.num_valid_hyp) == int(a.num_valid_hyp)
    np.testing.assert_array_equal(b.inliers.numpy(), np.asarray(a.inliers))
    np.testing.assert_allclose(b.best_wt.numpy(), np.asarray(a.best_wt),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(b.errors.numpy(), np.asarray(a.errors),
                               rtol=1e-9, atol=1e-12)


def test_vo_body_with_injected_noise(pair):
    obs0, obs1, lines, valid, key, gumbel = pair
    kw = dict(max_t_norm=1.0, num_hyp=H, sample_size=5, robust=True,
              max_iters=CFG.moba_max_iter, relin_iters=2)
    a = jax.jit(functools.partial(j_vo_body, **kw))(
        jnp.asarray(obs0), jnp.asarray(obs1), jnp.asarray(lines),
        jnp.asarray(valid), key, 0.12, CFG.error_thr, CFG.huber_delta)
    b = t_vo_body(_t(obs0), _t(obs1), _t(lines), _t(valid), 0.12,
                  CFG.error_thr, CFG.huber_delta, gumbel=_t(gumbel), **kw)
    assert int(b.ransac_score) == int(a.ransac_score)
    assert int(b.num_inliers_used) == int(a.num_inliers_used)
    np.testing.assert_allclose(b.ransac_wt.numpy(), np.asarray(a.ransac_wt),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(b.wt.numpy(), np.asarray(a.wt), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(b.final_errors.numpy(),
                               np.asarray(a.final_errors), rtol=1e-8,
                               atol=1e-12)


def test_ransac_draws_from_generator(pair):
    """Without injected noise the stage samples from the generator it is
    given: the same seed gives the same winner."""
    obs0, obs1, lines, valid, _, _ = pair
    args = (_t(obs0), _t(obs1), _t(lines), _t(valid), 0.12, CFG.error_thr)
    runs = [tr.ransac_stage(*args, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0].best_wt, runs[1].best_wt)
    assert int(runs[0].best_score) >= 5
    with pytest.raises(ValueError):
        tr.ransac_stage(*args)


def test_first_argmax_takes_the_first_maximum():
    x = torch.tensor([1, 4, 2, 4, 4, -1])
    assert int(tr.first_argmax(x)) == int(jnp.argmax(jnp.asarray(x.numpy())))
    assert int(tr.first_argmax(x)) == 1
