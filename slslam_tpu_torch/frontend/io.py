"""Observation file loader.

A copy of ``slslam_tpu/frontend/io.py`` on the port's native binding
(``slslam_tpu_torch.native``).  Reads the reference's line-track files
(%04d.txt under data/<seq>/line_tracking_result; format per
SLAM::grab_new_frame, slam.cpp:74-104): one row per tracked stereo line
segment, ``feature_id x0 y0 x1 y1 x2 y2 x3 y3 <extra>`` in pixel
coordinates, left endpoint pair first.  The native parser serves when the
library loads; otherwise one vectorized ``np.loadtxt`` per file, which
gives the same dictionary.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import numpy as np


def parse_obs_file(path: str) -> Dict[int, np.ndarray]:
    """One file -> {feature_id: (8,) pixel coords}."""
    from .. import native
    if native.available():
        out = native.parse_obs_file(path)
        if out is not None:
            return out
    try:
        data = np.loadtxt(path, ndmin=2)
    except (ValueError, OSError):
        return {}
    if data.size == 0:
        return {}
    out = {}
    for row in data:
        out[int(row[0])] = row[1:9].copy()
    return out


class ObsFileLoader:
    """Iterates (frame_id, obs_dict) over a sequence directory.

    Mirrors the reference's replay loop: frames are %04d.txt starting at
    frame 1 (frame 0 has no file and yields empty observations,
    slam.cpp:62-64); iteration stops at the first missing file
    (slam.cpp:79-80 EOF semantics).
    """

    def __init__(self, obs_dir: str, start: int = 0):
        self.obs_dir = obs_dir
        self.start = start

    def path(self, frame_id: int) -> str:
        return os.path.join(self.obs_dir, f"{frame_id:04d}.txt")

    def __iter__(self) -> Iterator[Tuple[int, Dict[int, np.ndarray]]]:
        frame_id = self.start
        first = True
        while True:
            p = self.path(frame_id)
            if not os.path.exists(p):
                if first and frame_id == 0:
                    # frame 0 may legitimately be absent (slam.cpp:62-64)
                    yield frame_id, {}
                    frame_id += 1
                    first = False
                    continue
                return
            yield frame_id, parse_obs_file(p)
            frame_id += 1
            first = False
