"""Batched stereo line triangulation (port of slslam_tpu/ops/triangulate.py).

Reference: SLAM::initialize_lm (slam.cpp:190-219).  Each stereo line
observation is back-projected to two planes, through the left camera at the
origin and the right camera at (baseline, 0, 0); their intersection is the
3D line, returned as (closest point, direction) with the reference's
degenerate-depth clamp (slam.cpp:206-213).
"""

from __future__ import annotations

import torch

from .. import geometry as geo


def triangulate_lines(obs, baseline, inverse_depth=0.1):
    """obs (..., 8) normalized endpoints (left pair, then right pair) ->
    (..., 6) lines (cp, v) in the camera frame.  Pad shapes come from
    ``obs.shape[:-1]``, so any number of leading dimensions works."""
    lead = obs.shape[:-1]
    one = torch.ones(lead + (1,), dtype=obs.dtype, device=obs.device)
    zero3 = torch.zeros(lead + (3,), dtype=obs.dtype, device=obs.device)

    p1 = torch.cat([obs[..., 0:2], one], dim=-1)
    p2 = torch.cat([obs[..., 2:4], one], dim=-1)
    p3 = torch.cat([obs[..., 4:5] + baseline, obs[..., 5:6], one], dim=-1)
    p4 = torch.cat([obs[..., 6:7] + baseline, obs[..., 7:8], one], dim=-1)

    cam_r = torch.cat([zero3[..., :1] + baseline, zero3[..., 1:]], dim=-1)
    pi1 = geo.ppp_pi(p1, p2, zero3)
    pi2 = geo.ppp_pi(p3, p4, cam_r)

    plk = geo.pipi_plk(pi1, pi2)
    n, v = plk[..., :3], plk[..., 3:]
    # NaN-safe closest point: padded/degenerate rows (v ~ 0) fall into the
    # depth clamp below instead of poisoning the batch
    vv = torch.sum(v * v, dim=-1, keepdim=True)
    cp = geo.cross(v, n) / torch.clamp_min(vv, 1e-30)

    cpn = geo.norm(cp, keepdim=True)
    bad = torch.logical_or(cpn < 0.1, cpn > 10.0)
    cp = torch.where(bad, cp / torch.clamp_min(cpn, 1e-12) / inverse_depth,
                     cp)
    cp = torch.where(cp[..., 2:3] < 0, -cp, cp)
    return torch.cat([cp, v], dim=-1)
