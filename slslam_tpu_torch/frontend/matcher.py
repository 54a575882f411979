"""Stereo + temporal line matching and track management of the port.

A copy of ``slslam_tpu/frontend/matcher.py`` over the port's detector and
descriptor.  Pairs detected segments across the rectified stereo pair and
across time, keeps track ids, and emits the engine's observation contract
(feature_id -> 8 pixel endpoint coordinates, left pair first;
slam.cpp:85-135).

  * stereo: candidate pairs have similar direction, overlapping vertical
    extent and a positive disparity within bounds; scored by descriptor
    similarity and resolved greedily one-to-one (matcher.py:76-104);
  * temporal: geometry-first association with descriptor similarity as a
    bonus term, carrying track ids forward; unmatched pairs open new tracks
    (matcher.py:106-192).

The two images of a frame go through detection and description on a
2-thread pool (the native grower releases the GIL, and so do the torch
operations); a worker's exception reaches the caller.  The orders
(``np.lexsort``) and the greedy resolutions are JAX's: track ids are what
the engine keys on.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from ..config import CameraConfig
from .descriptor import DESC_DIM, describe
from .detector import LineSegmentDetector, run_stage


def _seg_angle(s):
    return np.arctan2(s[..., 3] - s[..., 1], s[..., 2] - s[..., 0])


def _angdiff(a, b):
    d = np.abs(a - b) % np.pi          # direction is mod pi
    return np.minimum(d, np.pi - d)


def _overlap_y_matrix(a, b):
    """Vertical-extent IoU for every (left, right) pair: (A, 4) x (B, 4)
    -> (A, B).  Pairs with zero union score -1."""
    a0 = np.minimum(a[:, 1], a[:, 3])[:, None]
    a1 = np.maximum(a[:, 1], a[:, 3])[:, None]
    b0 = np.minimum(b[:, 1], b[:, 3])[None, :]
    b1 = np.maximum(b[:, 1], b[:, 3])[None, :]
    inter = np.minimum(a1, b1) - np.maximum(a0, b0)
    union = np.maximum(a1, b1) - np.minimum(a0, b0)
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0),
                    -1.0)


@dataclasses.dataclass
class Track:
    track_id: int
    seg_left: np.ndarray
    seg_right: np.ndarray
    desc: np.ndarray
    last_frame: int


class StereoLineMatcher:
    """``process(frame_id, img_left, img_right)`` -> {track_id: (8,)
    pixel observation}.  The detector's maps and the descriptors run on
    ``device`` (default the card) unless a ``detector`` is given."""

    def __init__(self, camera: Optional[CameraConfig] = None,
                 detector: Optional[LineSegmentDetector] = None,
                 max_disparity: float = 150.0,
                 min_desc_sim: float = 0.7,
                 max_endpoint_motion: float = 60.0,
                 max_track_gap: int = 2,
                 device="cuda"):
        self.cam = camera or CameraConfig()
        self.detector = detector or LineSegmentDetector(device=device)
        self.max_disparity = max_disparity
        self.min_desc_sim = min_desc_sim
        self.max_motion = max_endpoint_motion
        self.max_track_gap = max_track_gap
        self.tracks: Dict[int, Track] = {}
        self._next_id = 0
        self._pool = None           # lazy 2-thread stereo pool

    # -- stereo pairing ----------------------------------------------------

    def _stereo_pairs(self, segs_l, segs_r, desc_l, desc_r):
        pairs = []
        if len(segs_l) == 0 or len(segs_r) == 0:
            return pairs
        # all gates as (L, R) broadcasts
        sim = desc_l @ desc_r.T
        ang_l = _seg_angle(segs_l)
        ang_r = _seg_angle(segs_r)
        ok = _angdiff(ang_l[:, None], ang_r[None, :]) <= 0.1
        ok &= _overlap_y_matrix(segs_l, segs_r) >= 0.5
        # disparity at segment midpoints: left x > right x
        dx = ((segs_l[:, 0] + segs_l[:, 2])[:, None]
              - (segs_r[:, 0] + segs_r[:, 2])[None, :]) / 2.0
        ok &= (dx >= 0.0) & (dx <= self.max_disparity)
        ok &= sim >= self.min_desc_sim
        ii, jj = np.nonzero(ok)
        order = np.lexsort((jj, ii, -sim[ii, jj]))
        used_l, used_r = set(), set()
        for k in order:
            i, j = int(ii[k]), int(jj[k])
            if i in used_l or j in used_r:
                continue
            used_l.add(i)
            used_r.add(j)
            pairs.append((i, j))
        return pairs

    # -- one image ---------------------------------------------------------

    def side(self, img, stage=run_stage):
        """One image -> (segments, descriptors); the detector's steps and
        ``describe`` run through ``stage`` (``detect_with_gradients``)."""
        segs, mag, ang = self.detector.detect_with_gradients(img, stage)
        return segs, stage("describe", describe, mag, ang, segs)

    # -- temporal association ----------------------------------------------

    def process(self, frame_id: int, img_left: np.ndarray,
                img_right: np.ndarray) -> Dict[int, np.ndarray]:
        """Stereo frame -> {track_id: (8,) pixel observation}."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(2)
        f_l = self._pool.submit(self.side, img_left)
        try:
            right = self.side(img_right)
        finally:
            left = f_l.result()     # raises the left worker's exception
        return self.associate(frame_id, left, right)

    def associate(self, frame_id: int, left, right) -> Dict[int, np.ndarray]:
        """The stereo pairing and the temporal association of one frame's
        (segments, descriptors) per side (matcher.py:133-192)."""
        segs_l, desc_l = left
        segs_r, desc_r = right
        pairs = self._stereo_pairs(segs_l, segs_r, desc_l, desc_r)
        if not pairs:
            self._expire(frame_id)
            return {}

        cur_left = np.stack([segs_l[i] for i, _ in pairs])
        cur_right = np.stack([segs_r[j] for _, j in pairs])
        cur_desc = np.stack([desc_l[i] for i, _ in pairs])

        # temporal: geometry-first association (descriptors alias on
        # texture-poor scenes), descriptor similarity as a bonus term
        live = [t for t in self.tracks.values()
                if frame_id - t.last_frame <= self.max_track_gap]
        out: Dict[int, np.ndarray] = {}
        assigned = set()
        if live:
            prev_desc = np.stack([t.desc for t in live])
            sim = cur_desc @ prev_desc.T
            prev_segs = np.stack([t.seg_left for t in live])
            cur_ang = _seg_angle(cur_left)
            prev_ang = _seg_angle(prev_segs)
            cur_mid = (cur_left[:, 0:2] + cur_left[:, 2:4]) / 2
            prev_mid = (prev_segs[:, 0:2] + prev_segs[:, 2:4]) / 2

            # geometric gates as (A, B) broadcasts: perpendicular distance
            # between the two lines at the previous midpoint, and the
            # endpoint slide
            dm = prev_mid[None, :, :] - cur_mid[:, None, :]     # (A,B,2)
            perp = np.abs(np.cos(cur_ang)[:, None] * dm[..., 1]
                          - np.sin(cur_ang)[:, None] * dm[..., 0])
            slide = np.linalg.norm(dm, axis=-1)
            ok = _angdiff(cur_ang[:, None], prev_ang[None, :]) <= 0.15
            ok &= (perp <= 15.0) & (slide <= self.max_motion)
            score = (perp / 15.0 + 0.3 * slide / self.max_motion
                     - 0.3 * sim)
            aa, bb = np.nonzero(ok)
            order = np.lexsort((bb, aa, score[aa, bb]))
            used_b = set()
            for k in order:
                a, b = int(aa[k]), int(bb[k])
                if a in assigned or b in used_b:
                    continue
                assigned.add(a)
                used_b.add(b)
                t = live[b]
                t.seg_left = cur_left[a]
                t.seg_right = cur_right[a]
                t.desc = cur_desc[a]
                t.last_frame = frame_id
                out[t.track_id] = self._obs(cur_left[a], cur_right[a])

        for a in range(len(pairs)):
            if a in assigned:
                continue
            tid = self._next_id
            self._next_id += 1
            self.tracks[tid] = Track(tid, cur_left[a], cur_right[a],
                                     cur_desc[a], frame_id)
            out[tid] = self._obs(cur_left[a], cur_right[a])

        self._expire(frame_id)
        return out

    def descriptors(self, frame_id: int, feat_ids) -> np.ndarray:
        """Latest 72-dim descriptor per track id: the engine's
        ``descriptor_source`` contract (matcher.py:194-208).  Unknown or
        expired ids yield zero vectors (zero similarity, never a match)."""
        out = np.zeros((len(feat_ids), DESC_DIM), np.float32)
        for k, fid in enumerate(feat_ids):
            t = self.tracks.get(fid)
            if t is not None:
                out[k] = t.desc
        return out

    def close(self):
        """Shut the stereo pool down (a later ``process`` starts anew)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def _expire(self, frame_id):
        dead = [tid for tid, t in self.tracks.items()
                if frame_id - t.last_frame > self.max_track_gap]
        for tid in dead:
            del self.tracks[tid]

    @staticmethod
    def _obs(seg_l, seg_r) -> np.ndarray:
        """Engine observation: left endpoints then right endpoints, with the
        right segment's endpoints ordered consistently with the left's."""
        if (seg_l[1] - seg_l[3]) * (seg_r[1] - seg_r[3]) < 0:
            seg_r = np.array([seg_r[2], seg_r[3], seg_r[0], seg_r[1]])
        return np.concatenate([seg_l, seg_r])
