"""The port's batch engine with the options of its window BA, vs JAX's.

12 house frames in float64 with the BA init jitter, window anchors and aid
lines (through the chain rule around K2 on the card; its plain twin here).
The JAX engine draws the jitter from its own key stream, which torch cannot
reproduce, so the port takes it, and JAX's RANSAC noise, through its
hooks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from slslam_tpu.config import bucket_for
from slslam_tpu.engine import batch as jb
from slslam_tpu_torch.engine import batch as tb
from test_torch_batch_engine import CFG, _frames

torch.set_num_threads(1)


def test_jitter_anchors_and_aid_match_jax():
    """12 frames with the BA init jitter, window anchors and aid lines:
    the JAX step's jitter, normal(fold_in(fold_in(PRNGKey(rseed), frame),
    0x0B0A)) on the qualifying lines, fed through ``jitter_hook``; the
    same per-frame outputs, trajectories within 1e-7 m."""
    nf = 12
    cfg = dataclasses.replace(CFG, ba_init_jitter=0.01, line_param="aid",
                              window_anchor_sigma_rot=0.01,
                              window_anchor_sigma_t=0.05)
    frames, _ = _frames(nf)
    res_j = jb.BatchSlam(cfg).run(frames)
    pack = jb.pack_frames(frames, window=cfg.ba_window_size)
    Lp = bucket_for(pack.num_slots, cfg.line_buckets) + 1
    base = jax.random.PRNGKey(cfg.rseed)

    def gumbel(fidx):
        return torch.as_tensor(np.array(jax.random.gumbel(
            jax.random.fold_in(base, fidx),
            (cfg.ransac_num_hypotheses, Lp), jnp.float64)))

    def jitter(fidx, shape):
        key = jax.random.fold_in(jax.random.fold_in(base, fidx), 0x0B0A)
        return torch.as_tensor(np.array(jax.random.normal(key, shape,
                                                          jnp.float64)))

    res_t = tb.BatchSlam(cfg, device="cpu", gumbel_hook=gumbel,
                         jitter_hook=jitter).run(frames)
    for key in ("is_kf", "ransac_score", "ba_iters"):
        np.testing.assert_array_equal(res_t.per_frame[key],
                                      res_j.per_frame[key])
    for a, b in zip(res_j.trajectory, res_t.trajectory, strict=True):
        np.testing.assert_allclose(b.t, a.t, rtol=0, atol=1e-7)
    # the jitter draws from the engine's generator without a hook
    plain = tb.BatchSlam(cfg, device="cpu", gumbel_hook=gumbel).run(frames)
    assert not np.array_equal(plain.per_frame["ba_final_cost"],
                              res_t.per_frame["ba_final_cost"])
