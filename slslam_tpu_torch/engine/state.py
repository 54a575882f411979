"""Map state containers (host side) of the interactive engine.

A numpy copy of ``slslam_tpu/engine/state.py`` on the port's ``Pose``: the
reference's registries (slam.h:38-82,149-162) of keyframes, landmarks,
relative-pose edges and the id-remap table written by loop closure.  Poses
are derived state: every cycle re-roots the pose field by metric embedding
(slam.cpp:1317-1366); the edge constraints are the authoritative state.
``tests/test_torch_copies.py`` checks the copy against the original.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..hostgeom import Pose


@dataclasses.dataclass
class Keyframe:
    """slam.h:46-50. T is transient (rewritten by every embedding)."""

    T: Pose
    member_lms: Set[int] = dataclasses.field(default_factory=set)
    neighbor_kfs: Set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class Edge:
    """slam.h:52-62. T = current estimate, C = constraint (BA-refreshed)."""

    T: Pose
    C: Pose

    @staticmethod
    def from_pose(T: Pose) -> "Edge":
        return Edge(T.copy(), T.copy())

    def inverse(self) -> "Edge":
        Ti = self.T.inv()
        return Edge(Ti.copy(), Ti.copy())


@dataclasses.dataclass
class Landmark:
    """slam.h:64-73. line = (cp, dv) in the init keyframe's camera frame;
    obs_vec = full observation history [(kf_id, obs8), ...]."""

    line: np.ndarray
    init_kfid: int
    tt: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2))
    pvn: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    twice_observed: bool = False
    ba_updated: bool = False
    currently_visible: bool = False
    obs_vec: List[Tuple[int, np.ndarray]] = dataclasses.field(
        default_factory=list)
    # cache of obs_vec as parallel arrays, keyed by current length
    _obs_cache: tuple = dataclasses.field(default=None, repr=False)

    def obs_arrays(self):
        """obs_vec as (kfids (n,), obs (n, 8)) NumPy arrays, cached."""
        n = len(self.obs_vec)
        if self._obs_cache is None or self._obs_cache[0] != n:
            kfids = np.fromiter((k for k, _ in self.obs_vec),
                                np.int64, count=n)
            obs = (np.stack([o for _, o in self.obs_vec])
                   if n else np.zeros((0, 8)))
            self._obs_cache = (n, kfids, obs)
        return self._obs_cache[1], self._obs_cache[2]


@dataclasses.dataclass
class MapState:
    kfs: Dict[int, Keyframe] = dataclasses.field(default_factory=dict)
    lms: Dict[int, Landmark] = dataclasses.field(default_factory=dict)
    edges: Dict[Tuple[int, int], Edge] = dataclasses.field(
        default_factory=dict)
    edge_set: Set[Tuple[int, int]] = dataclasses.field(default_factory=set)
    match_lookup: Dict[int, int] = dataclasses.field(default_factory=dict)

    def last_kf_id(self) -> Optional[int]:
        return max(self.kfs) if self.kfs else None
