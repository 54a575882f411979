"""Stereo line-segment renderer: world segments -> per-frame observations.

A copy of ``StereoLineRenderer.observe``, ``observe_pixels`` and
``write_sequence`` (with the helpers they call) from
``slslam_tpu/sim/render.py``.  It produces the observation contract of the
reference's line-track files (src/slam.cpp:85-95), in normalized camera
coordinates: left endpoint pair then right pair, with perfect data
association (feature_id = world segment index) and optional Gaussian
endpoint noise (the sim build's ``obs_err_stddev`` knob, slam.cpp:23).

Right camera sits at (+baseline, 0, 0) in the left camera frame; a point with
left-frame coordinates p has right-frame coordinates p - (baseline, 0, 0)
(matching the residual convention, lba_problem.h:101-103).
"""

from __future__ import annotations

import os

import numpy as np

from ..config import CameraConfig
from ..hostgeom import Pose


class StereoLineRenderer:
    def __init__(self, segments_w, camera: CameraConfig = None,
                 noise_px: float = 0.0, seed: int = 0,
                 z_near: float = 0.2, min_len_px: float = 20.0,
                 max_range: float = None):
        """max_range: cull segments whose midpoint is further than this
        (meters) from the camera; None = infinite range (the house
        default)."""
        self.segments_w = np.asarray(segments_w, float)
        self.cam = camera or CameraConfig()
        self.noise_px = noise_px
        self.rng = np.random.default_rng(seed)
        self.z_near = z_near
        self.max_range = max_range
        self.min_len = min_len_px / self.cam.focal_length
        # normalized-coordinate image bounds
        c = self.cam
        self.u_min = (0.0 - c.cx) / c.fx
        self.u_max = (c.image_width - c.cx) / c.fx
        self.v_min = (0.0 - c.cy) / c.fy
        self.v_max = (c.image_height - c.cy) / c.fy

    def _clip_z(self, p1, p2):
        z1, z2 = p1[2], p2[2]
        if z1 < self.z_near and z2 < self.z_near:
            return None
        if z1 < self.z_near:
            s = (self.z_near - z1) / (z2 - z1)
            p1 = p1 + s * (p2 - p1)
        elif z2 < self.z_near:
            s = (self.z_near - z2) / (z1 - z2)
            p2 = p2 + s * (p1 - p2)
        return p1, p2

    def _clip_2d(self, a, b):
        """Liang–Barsky clip of segment a-b to the normalized image rect."""
        d = b - a
        t0, t1 = 0.0, 1.0
        for p, q in (
            (-d[0], a[0] - self.u_min), (d[0], self.u_max - a[0]),
            (-d[1], a[1] - self.v_min), (d[1], self.v_max - a[1]),
        ):
            if abs(p) < 1e-15:
                if q < 0:
                    return None
                continue
            r = q / p
            if p < 0:
                if r > t1:
                    return None
                t0 = max(t0, r)
            else:
                if r < t0:
                    return None
                t1 = min(t1, r)
        if t0 >= t1:
            return None
        return a + t0 * d, a + t1 * d

    def _project_one(self, p1c, p2c):
        clipped = self._clip_z(p1c, p2c)
        if clipped is None:
            return None
        p1c, p2c = clipped
        a = p1c[:2] / p1c[2]
        b = p2c[:2] / p2c[2]
        clipped = self._clip_2d(a, b)
        if clipped is None:
            return None
        a, b = clipped
        if np.linalg.norm(b - a) < self.min_len:
            return None
        return a, b

    def observe(self, T_wc: Pose):
        """Render observations for a world->camera pose.

        Returns dict feature_id -> (8,) normalized coords
        (x0 y0 x1 y1 | x2 y2 x3 y3), left image pair first.
        """
        obs = {}
        bl = self.cam.baseline
        for sid, seg in enumerate(self.segments_w):
            p1 = T_wc.R @ seg[:3] + T_wc.t
            p2 = T_wc.R @ seg[3:] + T_wc.t
            if self.max_range is not None and \
                    np.linalg.norm(0.5 * (p1 + p2)) > self.max_range:
                continue
            left = self._project_one(p1, p2)
            if left is None:
                continue
            off = np.array([bl, 0.0, 0.0])
            right = self._project_one(p1 - off, p2 - off)
            if right is None:
                continue
            o = np.concatenate([left[0], left[1], right[0], right[1]])
            if self.noise_px > 0:
                o = o + self.rng.normal(
                    0.0, self.noise_px / self.cam.focal_length, size=8)
            obs[sid] = o
        return obs

    def observe_pixels(self, T_wc: Pose):
        """Same as observe() but in pixel coordinates (the file format)."""
        c = self.cam
        out = {}
        for sid, o in self.observe(T_wc).items():
            px = o.copy()
            px[0::2] = px[0::2] * c.fx + c.cx
            px[1::2] = px[1::2] * c.fy + c.cy
            out[sid] = px
        return out

    def write_sequence(self, out_dir, poses):
        """Write %04d.txt line-track files in the reference format."""
        os.makedirs(out_dir, exist_ok=True)
        for i, T in enumerate(poses):
            rows = self.observe_pixels(T)
            path = os.path.join(out_dir, f"{i:04d}.txt")
            with open(path, "w") as f:
                for sid, px in sorted(rows.items()):
                    vals = " ".join(f"{v:.6f}" for v in px)
                    f.write(f"{sid} {vals} 0\n")
