"""Headless visualization (a copy of ``slslam_tpu/viz.py``).

Replaces the reference's GLFW/OpenGL + OpenCV viewer (src/cplot.{h,cpp}:
floor grid, trajectory polyline, 3D map lines, stereo observation overlay)
with matplotlib renderings to PNG (the Agg backend, no display needed).
Reads host copies only; ``tests/test_torch_copies.py`` holds both
functions to the originals' files.  Where matplotlib is not installed (a
machine with only the port's own dependencies), the same figures are drawn
with PIL: the same elements and colours, not the same pixels.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def plot_map(trajectory, segments, out_path: str,
             gt_trajectory: Optional[np.ndarray] = None,
             title: str = "slslam-tpu map"):
    """Top-down (x-z plane of the world frame) map + trajectory figure.

    trajectory: list of camera-to-world Pose (engine.trajectory()).
    segments: (N, 6) world line segments (engine._landmark_world_segments).
    gt_trajectory: optional (M, >=4) rows in the save_trajectory format.
    """
    try:
        import matplotlib
    except ImportError:
        return _plot_map_pil(trajectory, segments, out_path, gt_trajectory,
                             title)
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 9))

    for s in segments:
        # world frame = first keyframe camera frame: x right, y down,
        # z forward.  Plot top-down: (x, z).
        ax.plot([s[0], s[3]], [s[2], s[5]], color="#888888", lw=0.8)

    if trajectory:
        xs = [T.t[0] for T in trajectory]
        zs = [T.t[2] for T in trajectory]
        ax.plot(xs, zs, color="#cc3311", lw=1.6, label="estimate")
        ax.scatter(xs[:1], zs[:1], color="#cc3311", marker="o", s=25)

    if gt_trajectory is not None and len(gt_trajectory):
        # save_trajectory format: cols (i, t_z, -t_x, -t_y, ...)
        ax.plot(-gt_trajectory[:, 2], gt_trajectory[:, 1],
                color="#0077bb", lw=1.2, ls="--", label="ground truth")

    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend(loc="best")
    ax.set_title(title)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_observations(img_left, img_right, obs, out_path: str,
                      image_size=(640, 480), title: str = None):
    """Stereo image pair with tracked segments overlaid in per-id colors
    (the reference's live tracking view: drawObservation /
    drawImageTracking, cplot.cpp:260-340).  Images may be None (sequences
    replayed from line-track files have no pixels) — segments then draw on
    a blank canvas of ``image_size``."""
    try:
        import matplotlib
    except ImportError:
        return _plot_observations_pil(img_left, img_right, obs, out_path,
                                      image_size, title)
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if img_left is None:
        img_left = np.full((image_size[1], image_size[0]), 235, np.uint8)
    if img_right is None:
        img_right = np.full((image_size[1], image_size[0]), 235, np.uint8)

    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    if title:
        fig.suptitle(title)
    for ax, img in zip(axes, (img_left, img_right)):
        ax.imshow(img, cmap="gray", vmin=0, vmax=255)
        ax.axis("off")
    rng = np.random.default_rng(0)
    for fid, o in obs.items():
        col = tuple(rng.random(3) * 0.7 + 0.2)
        rs = np.random.default_rng(fid)
        col = tuple(rs.random(3) * 0.7 + 0.15)
        axes[0].plot([o[0], o[2]], [o[1], o[3]], color=col, lw=1.4)
        axes[1].plot([o[4], o[6]], [o[5], o[7]], color=col, lw=1.4)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
# The same figures drawn with PIL, where matplotlib is missing
# ---------------------------------------------------------------------------

def _rgb(hex_or_floats):
    if isinstance(hex_or_floats, str):
        return tuple(int(hex_or_floats[i:i + 2], 16) for i in (1, 3, 5))
    return tuple(int(round(255 * c)) for c in hex_or_floats)


def _save(img, out_path):
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    img.save(out_path)


def _plot_map_pil(trajectory, segments, out_path, gt_trajectory, title,
                  size=1080, margin=40):
    """plot_map's figure with PIL: the top-down (x, z) segments in grey,
    the estimate in red from a marked start, the ground truth in blue."""
    from PIL import Image, ImageDraw
    segs = np.asarray(segments, float).reshape(-1, 6)
    polys = [(np.array([[s[0], s[2]], [s[3], s[5]]]), "#888888", 1)
             for s in segs]
    if trajectory:
        polys.append((np.array([[T.t[0], T.t[2]] for T in trajectory]),
                      "#cc3311", 2))
    if gt_trajectory is not None and len(gt_trajectory):
        polys.append((np.stack([-gt_trajectory[:, 2], gt_trajectory[:, 1]],
                               axis=1), "#0077bb", 2))
    pts = np.concatenate([p for p, _, _ in polys]) if polys else \
        np.zeros((1, 2))
    extent = max(float(np.max(pts.max(0) - pts.min(0))), 1e-9)
    lo = (pts.max(0) + pts.min(0) - extent) / 2     # centred, equal aspect
    scale = (size - 2 * margin) / extent
    img = Image.new("RGB", (size, size), "white")
    draw = ImageDraw.Draw(img)

    def xy(p):           # z grows upward, as matplotlib's axis
        return [(margin + (x - lo[0]) * scale,
                 size - margin - (z - lo[1]) * scale) for x, z in p]

    for p, colour, width in polys:
        draw.line(xy(p), fill=_rgb(colour), width=width)
    if trajectory:
        (x, y), = xy(polys[len(segs)][0][:1])
        draw.ellipse([x - 4, y - 4, x + 4, y + 4], fill=_rgb("#cc3311"))
    draw.text((margin, 10), title, fill="black")
    _save(img, out_path)


def _plot_observations_pil(img_left, img_right, obs, out_path, image_size,
                           title):
    """plot_observations' figure with PIL: the two images (or blank
    canvases) side by side, each track's segment in its colour."""
    from PIL import Image, ImageDraw
    w, h = image_size
    views = [np.full((h, w), 235, np.uint8) if im is None
             else np.clip(np.asarray(im, float), 0, 255).astype(np.uint8)
             for im in (img_left, img_right)]
    h = max(v.shape[0] for v in views)
    top = 24 if title else 0
    img = Image.new("RGB", (views[0].shape[1] + views[1].shape[1],
                            h + top), "white")
    img.paste(Image.fromarray(views[0]).convert("RGB"), (0, top))
    img.paste(Image.fromarray(views[1]).convert("RGB"),
              (views[0].shape[1], top))
    draw = ImageDraw.Draw(img)
    for fid, o in obs.items():
        col = _rgb(np.random.default_rng(fid).random(3) * 0.7 + 0.15)
        for k, dx in ((0, 0), (4, views[0].shape[1])):
            draw.line([(o[k] + dx, o[k + 1] + top),
                       (o[k + 2] + dx, o[k + 3] + top)], fill=col, width=2)
    if title:
        draw.text((4, 4), title, fill="black")
    _save(img, out_path)
