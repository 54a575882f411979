"""Track-id churn: emulate a real tracker's id lifecycle (copied from
slslam_tpu/sim/tracks.py; tests/test_torch_copies.py holds it to the
original).

The renderer emits stable world-segment ids, but a real front-end assigns a
NEW track id whenever a feature is re-detected after being lost — which is
exactly the id aliasing loop closure exists to repair (the reference merges
re-detected tracks onto old landmarks, slam.cpp:1162-1208).  This wrapper
re-keys renderer observations with per-visibility-epoch track ids, and keeps
the track -> world-segment mapping so a descriptor source can produce stable
place signatures.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class TrackIdAssigner:
    def __init__(self, max_gap: int = 5):
        self.max_gap = max_gap
        self._active: Dict[int, Tuple[int, int]] = {}  # seg -> (track, last)
        self._next_track = 0
        self.track_to_seg: Dict[int, int] = {}

    def assign(self, frame_id: int, obs_by_seg: Dict[int, np.ndarray]
               ) -> Dict[int, np.ndarray]:
        out = {}
        for seg, o in obs_by_seg.items():
            rec = self._active.get(seg)
            if rec is not None and frame_id - rec[1] <= self.max_gap:
                track = rec[0]
            else:
                track = self._next_track
                self._next_track += 1
                self.track_to_seg[track] = seg
            self._active[seg] = (track, frame_id)
            out[track] = o
        return out


class SegmentDescriptorSource:
    """Stable per-world-segment descriptors + per-observation noise.

    Stands in for the (never-released) 72-dim line descriptor extractor:
    the same physical line yields near-identical descriptors on revisit.
    """

    def __init__(self, assigner: TrackIdAssigner, num_segments: int,
                 dim: int = 72, noise: float = 0.01, seed: int = 0):
        rng = np.random.default_rng(seed)
        d = rng.standard_normal((num_segments, dim)).astype(np.float32)
        self.base = d / np.linalg.norm(d, axis=1, keepdims=True)
        self.noise = noise
        self.assigner = assigner
        self.rng = np.random.default_rng(seed + 1)

    def __call__(self, frame_id: int, feat_ids):
        out = []
        for fid in feat_ids:
            seg = self.assigner.track_to_seg.get(fid)
            if seg is None:
                # id remapped by a previous loop closure: still a valid old
                # track id recorded in track_to_seg — unknown ids get a
                # random (unmatchable) descriptor
                d = self.rng.standard_normal(self.base.shape[1])
            else:
                d = (self.base[seg]
                     + self.rng.standard_normal(self.base.shape[1])
                     * self.noise)
            d = d / np.linalg.norm(d)
            out.append(d.astype(np.float32))
        return np.stack(out) if out else np.zeros((0, self.base.shape[1]),
                                                  np.float32)
