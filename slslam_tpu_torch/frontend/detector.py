"""Line segment detector (LSD-style) of the port.

Port of ``slslam_tpu/frontend/detector.py``, a two-stage detector:

  * device stage, plain torch on the image's device: a separable Gaussian
    (sigma 1, radius 2, edge padding), Sobel / 8, the gradient magnitude and
    the level-line angle ``atan2(gx, -gy)``, in float32 as the JAX function
    computes it (``image_gradients``, detector.py:33-77).  The convolutions
    are sums of shifted slices, as JAX's ``conv2`` is, never ``F.conv2d``:
    cuDNN would run them in TF32 unless the caller switched that off;
  * host stage: anchor-seeded region growing along level-lines (the LSD
    recipe), PCA line fit and density validation, in the repository's
    native library (``slslam_lsd_detect``, native/slslam_native.cpp:166-286,
    through ``slslam_tpu_torch.native``) or in the Python grower
    ``_grow_regions`` (detector.py:272-349), its twin; then the stroke-edge
    fusion and the collinear merge, numpy copies of detector.py:80-216.

The detector computes the maps once on the device, copies magnitude and
angle to the host once for the grower, and hands the device copies to the
descriptor.  Where the JAX detector falls back to the Python grower when
the library is missing, ``resolve_grower`` warns and the detector reports
the grower it runs (``LineSegmentDetector.grower``).

Output segments are (x1, y1, x2, y2) in pixels.
"""

from __future__ import annotations

import warnings
from typing import List

import numpy as np
import torch

from .. import native, resolve_device

GROWERS = ("native", "python")

# Sobel / 8 (detector.py:58-60), row dy, column dx
_SOBEL_X = ((-0.125, 0.0, 0.125), (-0.25, 0.0, 0.25), (-0.125, 0.0, 0.125))
_SOBEL_Y = tuple(zip(*_SOBEL_X))


def resolve_grower(grower: str = "auto") -> str:
    """``"auto"`` -> ``"native"`` if the native library builds and loads,
    else ``"python"`` with a warning; ``"native"`` raises without it."""
    if grower not in GROWERS + ("auto",):
        raise ValueError(f"unknown region grower {grower!r}")
    if grower == "python":
        return grower
    if native.available():
        return "native"
    if grower == "native":
        raise RuntimeError("the native region grower is unavailable: "
                           f"{native.build_error}")
    warnings.warn(f"native region grower unavailable ({native.build_error}); "
                  "using the Python grower", RuntimeWarning, stacklevel=2)
    return "python"


def _gaussian_kernel(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _conv1d(x: torch.Tensor, k: torch.Tensor, axis: int) -> torch.Tensor:
    """Edge-padded 'same' correlation of ``x`` with taps ``k`` along
    ``axis`` (detector.py:43-55), one shifted slice per tap."""
    r = len(k) // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
    xp = x.index_select(axis, idx)
    out = k[0] * xp.narrow(axis, 0, n)
    for j in range(1, len(k)):
        out = out + k[j] * xp.narrow(axis, j, n)
    return out


def _conv3x3(x: torch.Tensor, k2) -> torch.Tensor:
    """Edge-padded 3x3 correlation (detector.py:62-69): the sum of the
    nonzero taps' shifted slices in JAX's (dy, dx) order."""
    H, W = x.shape
    iy = torch.arange(-1, H + 1, device=x.device).clamp_(0, H - 1)
    ix = torch.arange(-1, W + 1, device=x.device).clamp_(0, W - 1)
    xp = x.index_select(0, iy).index_select(1, ix)
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            if k2[dy][dx] != 0.0:
                out = out + k2[dy][dx] * xp[dy:dy + H, dx:dx + W]
    return out


def image_gradients(img: torch.Tensor, sigma_radius=(1.0, 2)):
    """(H, W) grayscale tensor -> (magnitude, angle) float32 maps on its
    device.  Separable Gaussian blur then Sobel; the angle is the
    level-line angle (perpendicular to the gradient), in [-pi, pi]."""
    x = img.to(torch.float32)
    sigma, radius = sigma_radius
    k = _gaussian_kernel(sigma, radius, x.device)
    sm = _conv1d(_conv1d(x, k, 0), k, 1)
    gx = _conv3x3(sm, _SOBEL_X)
    gy = _conv3x3(sm, _SOBEL_Y)
    mag = torch.sqrt(gx * gx + gy * gy)
    angle = torch.atan2(gx, -gy)
    return mag, angle


def _angle_diff(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def fuse_stroke_edge_pairs(segs, grad_dirs, angle_tol=3.0 * np.pi / 180.0,
                           max_sep=5.0, min_sep=0.5, min_overlap=0.3):
    """Fuse the two edges of a dark/bright stroke into its centerline
    (detector.py:85-148).

    A thin stroke produces two parallel detections with anti-parallel
    gradients; pairing them and averaging removes the half-stroke offset
    that would bias stereo disparity when the two cameras lock onto
    opposite edges.  Unpaired segments pass through unchanged."""
    n = len(segs)
    if n <= 1:
        return segs
    d = segs[:, 2:4] - segs[:, 0:2]
    length = np.hypot(d[:, 0], d[:, 1])
    u = d / np.maximum(length, 1e-9)[:, None]
    ang = np.arctan2(u[:, 1], u[:, 0]) % np.pi
    mid = (segs[:, 0:2] + segs[:, 2:4]) / 2

    # pair pre-filter as (n, n) broadcasts
    da = np.abs(ang[:, None] - ang[None, :])
    ok = np.minimum(da, np.pi - da) <= angle_tol
    ok &= (grad_dirs @ grad_dirs.T) <= -0.5      # anti-parallel gradients
    dmid = mid[None, :, :] - mid[:, None, :]     # (i, j, 2)
    off_m = np.abs(u[:, None, 0] * dmid[..., 1]
                   - u[:, None, 1] * dmid[..., 0])
    ok &= (off_m >= min_sep) & (off_m <= max_sep)
    r0 = segs[None, :, 0:2] - segs[:, None, 0:2]
    r1 = segs[None, :, 2:4] - segs[:, None, 0:2]
    t0 = np.einsum("ik,ijk->ij", u, r0)
    t1 = np.einsum("ik,ijk->ij", u, r1)
    tj_lo, tj_hi = np.minimum(t0, t1), np.maximum(t0, t1)
    inter = np.minimum(length[:, None], tj_hi) - np.maximum(0.0, tj_lo)
    ok &= inter >= min_overlap * np.minimum(length[:, None],
                                            length[None, :])
    ok &= np.triu(np.ones((n, n), bool), 1)      # i < j once
    ii, jj = np.nonzero(ok)
    cands = sorted(zip(off_m[ii, jj], ii.tolist(), jj.tolist()))
    used = set()
    out = []
    for off, i, j in cands:
        if i in used or j in used:
            continue
        used.add(i)
        used.add(j)
        # centerline: project both segments' endpoints onto the average
        # direction through the midpoint between the two lines
        w = np.array([length[i], length[j]])
        a2 = 2 * np.array([ang[i], ang[j]])
        avg = 0.5 * np.arctan2((w * np.sin(a2)).sum(),
                               (w * np.cos(a2)).sum())
        uu = np.array([np.cos(avg), np.sin(avg)])
        c = (mid[i] * length[i] + mid[j] * length[j]) / (length[i]
                                                         + length[j])
        pts = np.concatenate([segs[i].reshape(2, 2), segs[j].reshape(2, 2)])
        ts = (pts - c) @ uu
        out.append(np.concatenate([c + ts.min() * uu, c + ts.max() * uu]))
    for k in range(n):
        if k not in used:
            out.append(segs[k])
    return np.stack(out) if out else segs


def merge_collinear_segments(segs, angle_tol=2.0 * np.pi / 180.0,
                             offset_tol=2.5, gap_tol=8.0):
    """Fuse fragments lying on the same infinite image line
    (detector.py:151-216): direction within ``angle_tol``, perpendicular
    offset under ``offset_tol`` px, extents within ``gap_tol`` px, merged by
    union-find, keeping the extreme endpoints projected onto the average
    direction."""
    n = len(segs)
    if n <= 1:
        return segs
    d = segs[:, 2:4] - segs[:, 0:2]
    length = np.hypot(d[:, 0], d[:, 1])
    u = d / np.maximum(length, 1e-9)[:, None]
    ang = np.arctan2(u[:, 1], u[:, 0]) % np.pi
    mid = (segs[:, 0:2] + segs[:, 2:4]) / 2

    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    # pair pre-filter as (n, n) broadcasts; union-find runs only over the
    # surviving pairs
    da = np.abs(ang[:, None] - ang[None, :])
    ok = np.minimum(da, np.pi - da) <= angle_tol
    dm = mid[None, :, :] - segs[:, None, 0:2]
    off_m = np.abs(u[:, None, 0] * dm[..., 1]
                   - u[:, None, 1] * dm[..., 0])
    ok &= off_m <= offset_tol
    r0 = segs[None, :, 0:2] - segs[:, None, 0:2]
    r1 = segs[None, :, 2:4] - segs[:, None, 0:2]
    t0 = np.einsum("ik,ijk->ij", u, r0)
    t1 = np.einsum("ik,ijk->ij", u, r1)
    tj_lo, tj_hi = np.minimum(t0, t1), np.maximum(t0, t1)
    gap = np.maximum(0.0, tj_lo) - np.minimum(length[:, None], tj_hi)
    ok &= gap <= gap_tol
    ok &= np.triu(np.ones((n, n), bool), 1)
    for i, j in zip(*np.nonzero(ok)):
        parent[find(i)] = find(j)

    groups = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)

    out = []
    for members in groups.values():
        if len(members) == 1:
            out.append(segs[members[0]])
            continue
        w = length[members]
        # average direction (mod pi, via the doubled-angle trick)
        a2 = 2 * ang[members]
        avg = 0.5 * np.arctan2((w * np.sin(a2)).sum(),
                               (w * np.cos(a2)).sum())
        uu = np.array([np.cos(avg), np.sin(avg)])
        c = (mid[members] * w[:, None]).sum(axis=0) / w.sum()
        pts = np.concatenate([segs[members][:, 0:2], segs[members][:, 2:4]])
        ts = (pts - c) @ uu
        out.append(np.concatenate([c + ts.min() * uu, c + ts.max() * uu]))
    return np.stack(out)


def run_stage(name, fn, *args):
    """The front-end's default stage runner: ``fn(*args)``."""
    return fn(*args)


class LineSegmentDetector:
    """``detect(img)`` -> (N, 4) segments; the gradient maps run on
    ``device`` (default the card), the region grower on the host
    (``grower``: ``"auto"``, ``"native"`` or ``"python"``; the one chosen is
    ``self.grower``)."""

    def __init__(self, mag_threshold: float = 5.0,
                 angle_tolerance: float = 22.5 * np.pi / 180.0,
                 min_length: float = 20.0, min_density: float = 0.6,
                 merge_collinear: bool = True,
                 fuse_stroke_edges: bool = True,
                 stroke_max_sep: float = 5.0,
                 device="cuda", grower: str = "auto"):
        self.mag_threshold = mag_threshold
        self.angle_tol = angle_tolerance
        self.min_length = min_length
        self.min_density = min_density
        self.merge_collinear = merge_collinear
        self.fuse_stroke_edges = fuse_stroke_edges
        self.stroke_max_sep = stroke_max_sep
        self.device = resolve_device(device)
        self.grower = resolve_grower(grower)

    def detect(self, img: np.ndarray) -> np.ndarray:
        """(H, W) grayscale -> (N, 4) segments (x1, y1, x2, y2)."""
        return self.detect_with_gradients(img)[0]

    def gradients(self, img):
        """(H, W) grayscale (array or tensor) -> (magnitude, angle) on the
        detector's device."""
        return image_gradients(torch.as_tensor(img, dtype=torch.float32,
                                               device=self.device))

    def detect_with_gradients(self, img, stage=run_stage):
        """``detect`` that also returns the (magnitude, angle) maps on the
        device, which the descriptor reads (detector.py:235-258).  The maps
        reach the host in one copy, for the grower.  Each step runs through
        ``stage(name, fn, *args)`` (``gradients``, ``to_host``, ``grower``,
        ``fuse_merge``), which a caller may replace to time them."""
        mag, angle = stage("gradients", self.gradients, img)
        host = stage("to_host",
                     lambda: torch.stack([mag, angle]).cpu().numpy())
        grown = stage("grower", self.grow, host[0], host[1])
        return stage("fuse_merge", self.postprocess, *grown), mag, angle

    def segments(self, mag: np.ndarray, angle: np.ndarray) -> np.ndarray:
        """Host maps -> (N, 4) segments: the grower, then the stroke-edge
        fusion and the collinear merge."""
        return self.postprocess(*self.grow(mag, angle))

    def grow(self, mag: np.ndarray, angle: np.ndarray):
        """Host maps -> (segments (N, 4), gradient directions (N, 2)) of
        the region grower this detector runs."""
        if self.grower == "native":
            return native.lsd_detect(mag, angle, self.mag_threshold,
                                     self.angle_tol, self.min_length,
                                     self.min_density)
        return self._grow_regions(mag, angle)

    def postprocess(self, out, gd):
        """The stroke-edge fusion and the collinear merge of the grower's
        segments (detector.py:260-270)."""
        if self.fuse_stroke_edges and len(out):
            out = fuse_stroke_edge_pairs(out, gd,
                                         max_sep=self.stroke_max_sep)
        if self.merge_collinear and len(out):
            out = merge_collinear_segments(out)
            out = out[np.hypot(out[:, 2] - out[:, 0],
                               out[:, 3] - out[:, 1]) >= self.min_length] \
                if len(out) else out
        return out

    def _grow_regions(self, mag, angle):
        """Pure-Python region growing, the native grower's twin
        (detector.py:272-349)."""
        H, W = mag.shape
        used = mag < self.mag_threshold      # True = not usable
        # anchors: strongest gradients first (LSD's pseudo-ordering)
        ys, xs = np.nonzero(~used)
        if len(ys) == 0:
            return np.zeros((0, 4)), np.zeros((0, 2))
        order = np.argsort(-mag[ys, xs])
        ys, xs = ys[order], xs[order]

        segments: List[np.ndarray] = []
        grad_dirs: List[np.ndarray] = []
        neigh = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                 (1, -1), (1, 0), (1, 1)]

        for y0, x0 in zip(ys, xs):
            if used[y0, x0]:
                continue
            # region growing along the level-line direction
            region = [(y0, x0)]
            used[y0, x0] = True
            theta = angle[y0, x0]
            sx, sy = np.cos(theta), np.sin(theta)
            head = 0
            while head < len(region):
                cy, cx = region[head]
                head += 1
                for dy, dx in neigh:
                    ny, nx = cy + dy, cx + dx
                    if ny < 0 or ny >= H or nx < 0 or nx >= W:
                        continue
                    if used[ny, nx]:
                        continue
                    if _angle_diff(angle[ny, nx], theta) > self.angle_tol:
                        continue
                    used[ny, nx] = True
                    region.append((ny, nx))
                    # region angle update (LSD: running mean direction)
                    sx += np.cos(angle[ny, nx])
                    sy += np.sin(angle[ny, nx])
                    theta = np.arctan2(sy, sx)

            if len(region) < self.min_length:
                continue
            # mean gradient direction of the region (for stroke-edge
            # polarity: level-line angle a => gradient unit (sin a, -cos a))
            ridx = np.asarray(region)
            ra = angle[ridx[:, 0], ridx[:, 1]]
            gvec = np.array([np.sin(ra).sum(), -np.cos(ra).sum()])
            gn = np.linalg.norm(gvec)
            gvec = gvec / gn if gn > 0 else gvec

            pts = np.asarray(region, np.float64)       # (n, 2) (y, x)
            w = mag[pts[:, 0].astype(int), pts[:, 1].astype(int)]
            w = w / w.sum()
            c = (pts * w[:, None]).sum(axis=0)
            d = pts - c
            cov = (d * w[:, None]).T @ d
            evals, evecs = np.linalg.eigh(cov)
            v = evecs[:, -1]                           # (dy, dx) major axis
            t = d @ v
            t0, t1 = t.min(), t.max()
            length = t1 - t0
            if length < self.min_length:
                continue
            # density validation (rectangle width from minor eigenvalue)
            width = max(2.0 * np.sqrt(max(evals[0], 1e-12)) * 2.0, 1.0)
            density = len(region) / (length * width)
            if density < self.min_density:
                continue
            p1 = c + t0 * v
            p2 = c + t1 * v
            segments.append(np.array([p1[1], p1[0], p2[1], p2[0]]))
            grad_dirs.append(gvec)

        out = np.stack(segments) if segments else np.zeros((0, 4))
        gd = np.stack(grad_dirs) if grad_dirs else np.zeros((0, 2))
        return out, gd
