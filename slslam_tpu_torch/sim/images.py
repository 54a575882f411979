"""Synthetic stereo image rendering: line-art frames for the front-end.

A copy of ``slslam_tpu/sim/images.py`` (:18-72) over the port's
``StereoLineRenderer.observe_pixels``: the world's line segments drawn as
dark strokes on a light background, with optional Gaussian noise, for both
cameras of the stereo rig.
"""

from __future__ import annotations

import numpy as np

from ..config import CameraConfig
from ..hostgeom import Pose
from .render import StereoLineRenderer


def draw_segments(segments_px, width, height, stroke=1.5,
                  background=200.0, ink=40.0, noise=0.0, rng=None):
    """Rasterize (N, 4) pixel segments into a grayscale image."""
    img = np.full((height, width), background, np.float32)
    for s in segments_px:
        x1, y1, x2, y2 = s
        length = float(np.hypot(x2 - x1, y2 - y1))
        if length < 1:
            continue
        n = int(length * 2) + 1
        ts = np.linspace(0.0, 1.0, n)
        xs = x1 + ts * (x2 - x1)
        ys = y1 + ts * (y2 - y1)
        for rad in np.linspace(-stroke / 2, stroke / 2, 3):
            # perpendicular offset for stroke width
            px = -(y2 - y1) / length * rad
            py = (x2 - x1) / length * rad
            xi = np.round(xs + px).astype(int)
            yi = np.round(ys + py).astype(int)
            ok = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
            img[yi[ok], xi[ok]] = ink
    if noise > 0:
        rng = rng or np.random.default_rng(0)
        img = img + rng.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 255)


class StereoImageRenderer:
    """World segments -> stereo grayscale images per pose."""

    def __init__(self, segments_w, camera: CameraConfig = None,
                 stroke=1.5, noise=2.0, seed=0):
        self.cam = camera or CameraConfig()
        self.line_renderer = StereoLineRenderer(segments_w, self.cam,
                                                noise_px=0.0)
        self.stroke = stroke
        self.noise = noise
        self.rng = np.random.default_rng(seed)

    def render(self, T_wc: Pose):
        """(left image, right image, {segment id: (8,) pixel obs})."""
        obs = self.line_renderer.observe_pixels(T_wc)
        c = self.cam
        left, right = [], []
        for o in obs.values():
            left.append(o[:4])
            right.append(o[4:])
        left = np.stack(left) if left else np.zeros((0, 4))
        right = np.stack(right) if right else np.zeros((0, 4))
        img_l = draw_segments(left, c.image_width, c.image_height,
                              stroke=self.stroke, noise=self.noise,
                              rng=self.rng)
        img_r = draw_segments(right, c.image_width, c.image_height,
                              stroke=self.stroke, noise=self.noise,
                              rng=self.rng)
        return img_l, img_r, obs
