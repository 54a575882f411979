"""The 74-segment synthetic "house" line world.

A copy of ``slslam_tpu/sim/house.py``, the port of the reference's
matlab_script/house.m (the world used for the parameterization benchmark,
see BASELINE.md §1).  Returns segments as an (74, 6) array of (p1, p2)
world endpoints.  The default placement matches
matlab_script/plot_model_gt_traj.m:1-4 (x shifted by -2.25, y by +2.75).
"""

from __future__ import annotations

import numpy as np


def _seg(p1, p2):
    return np.concatenate([np.asarray(p1, float), np.asarray(p2, float)])


def _zseg(x, y, z1, z2):
    return _seg([x, y, z1], [x, y, z2])


def _xseg(x1, x2, y, z):
    return _seg([x1, y, z], [x2, y, z])


def _yseg(x, y1, y2, z):
    return _seg([x, y1, z], [x, y2, z])


def _xy_rect(x1, x2, y1, y2, z):
    return [
        _xseg(x1, x2, y1, z),
        _xseg(x1, x2, y2, z),
        _yseg(x1, y1, y2, z),
        _yseg(x2, y1, y2, z),
    ]


def _yz_rect(x, y1, y2, z1, z2):
    return [
        _yseg(x, y1, y2, z1),
        _yseg(x, y1, y2, z2),
        _zseg(x, y1, z1, z2),
        _zseg(x, y2, z1, z2),
    ]


def house_segments(x=0.0, y=0.0, z=0.0, shift=True):
    """All 74 house segments (house.m:19-133). shift applies the
    plot_model_gt_traj.m offsets (x-2.25, y+2.75)."""
    l, w, h = 4.5, 4.5, 3.5
    a, b, c, d = 0.2, 0.4, 0.6, 0.8
    p, q, r = 0.25, 0.5, 0.65

    H = []
    # 4 wall verticals
    H += [_zseg(x, y, z, z + r * h), _zseg(x + l, y, z, z + r * h),
          _zseg(x + l, y + w, z, z + r * h), _zseg(x, y + w, z, z + r * h)]
    # floor
    H += _xy_rect(x, x + l, y, y + w, z)
    # roof slopes
    H += [_seg([x, y, z + r * h], [x, y + w / 2, z + h]),
          _seg([x, y + w / 2, z + h], [x, y + w, z + r * h]),
          _seg([x + l, y, z + r * h], [x + l, y + w / 2, z + h]),
          _seg([x + l, y + w / 2, z + h], [x + l, y + w, z + r * h])]
    # roof ridge + eaves
    H += [_xseg(x, x + l, y + 0.5 * w, z + h),
          _xseg(x, x + l, y, z + r * h),
          _xseg(x, x + l, y + w, z + r * h)]
    # door
    H += _yz_rect(x, y + c * w, y + d * w, z, z + q * h)
    # window
    H += _yz_rect(x, y + a * w, y + b * w, z + p * h, z + q * h)
    # 24-25: wall-top horizontals
    H += [_yseg(x, y, y + w, z + r * h), _yseg(x + l, y, y + w, z + r * h)]
    # 26-27: window cross
    H += [_yseg(x, y + a * w, y + b * w, (2 * z + p * h + q * h) / 2),
          _zseg(x, (2 * y + a * w + b * w) / 2, z + p * h, z + q * h)]
    # 28-33: roof slope ribs
    for fx in (1 / 2, 1 / 4, 3 / 4):
        H.append(_seg([x + l * fx, y, z + r * h],
                      [x + l * fx, y + w / 2, z + h]))
    for fx in (1 / 2, 1 / 4, 3 / 4):
        H.append(_seg([x + l * fx, y + w / 2, z + h],
                      [x + l * fx, y + w, z + r * h]))
    # 34-39: roof horizontals
    for k in (1, 2, 3):
        H.append(_xseg(x, x + l, y + w * k / 8, z + r * h + (h - r * h) * k / 4))
    for k, m in ((5, 3), (6, 2), (7, 1)):
        H.append(_xseg(x, x + l, y + w * k / 8, z + r * h + (h - r * h) * m / 4))
    # 40-48: wall verticals
    for fx in (1 / 4, 2 / 4, 3 / 4):
        H.append(_zseg(x + l * fx, y, z, z + r * h))
    for fx in (1 / 4, 2 / 4, 3 / 4):
        H.append(_zseg(x + l * fx, y + w, z, z + r * h))
    for fy in (1 / 4, 2 / 4, 3 / 4):
        H.append(_zseg(x + l, y + w * fy, z, z + r * h))
    # 49-50: door cross diagonals
    H += [_seg([x, y + c * w, z], [x, y + d * w, z + q * h]),
          _seg([x, y + d * w, z], [x, y + c * w, z + q * h])]
    # 51-58: front wall diagonals
    for f1, f2 in ((0, 1 / 4), (1 / 4, 2 / 4), (2 / 4, 3 / 4), (3 / 4, 1)):
        H.append(_seg([x + f1 * l, y, z], [x + f2 * l, y, z + r * h]))
        H.append(_seg([x + f2 * l, y, z], [x + f1 * l, y, z + r * h]))
    # 59-66: right wall diagonals
    for f1, f2 in ((0, 1 / 4), (1 / 4, 2 / 4), (2 / 4, 3 / 4), (3 / 4, 1)):
        H.append(_seg([x + l, y + f1 * w, z], [x + l, y + f2 * w, z + r * h]))
        H.append(_seg([x + l, y + f2 * w, z], [x + l, y + f1 * w, z + r * h]))
    # 67-74: back wall diagonals
    for f1, f2 in ((0, 1 / 4), (1 / 4, 2 / 4), (2 / 4, 3 / 4), (3 / 4, 1)):
        H.append(_seg([x + f1 * l, y + w, z], [x + f2 * l, y + w, z + r * h]))
        H.append(_seg([x + f2 * l, y + w, z], [x + f1 * l, y + w, z + r * h]))

    segs = np.stack(H)
    assert segs.shape == (74, 6)
    if shift:
        segs[:, [0, 3]] -= 2.25
        segs[:, [1, 4]] += 2.75
    return segs
