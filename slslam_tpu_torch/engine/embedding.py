"""Metric embedding: re-root the relative map's pose field.

Port of ``slslam_tpu/engine/embedding.py`` (SLAM::metric_embedding,
slam.cpp:1317-1366): a best-first traversal from the root keyframe ordered
by accumulated edge translation norm; each reached keyframe's transient
pose T is the edge transform composed onto its parent's pose at insertion
time.  A host-side graph walk of O(V log V + E) over a few hundred nodes.

Two walkers compute it: ``"native"``, the repository's C++ walk
(``native/slslam_native.cpp`` through ``slslam_tpu_torch.native``), and
``"python"``, the plain walk below.  As in the JAX package the native walk
serves maps of more than two keyframes.  The caller names the walker; where
the JAX module falls back to the Python walk when the library is missing,
``resolve_walker`` warns and the engine reports the walker it used
(``Slam.post_processing()["embedding_walker"]``).
"""

from __future__ import annotations

import heapq
import warnings
from typing import List, Tuple

import numpy as np

from .. import native
from ..hostgeom import Pose
from .state import MapState

WALKERS = ("native", "python")


def resolve_walker(walker: str = "auto") -> str:
    """``"auto"`` -> ``"native"`` if the native library builds and loads,
    else ``"python"`` with a warning; ``"native"`` raises without it."""
    if walker not in WALKERS + ("auto",):
        raise ValueError(f"unknown embedding walker {walker!r}")
    if walker == "python":
        return walker
    if native.available():
        return "native"
    if walker == "native":
        raise RuntimeError("the native embedding walker is unavailable: "
                           f"{native.build_error}")
    warnings.warn("native embedding walker unavailable "
                  f"({native.build_error}); using the Python walk",
                  RuntimeWarning, stacklevel=2)
    return "python"


def metric_embedding(state: MapState, root_id: int, walker: str = "python"
                     ) -> List[Tuple[float, int]]:
    """Assign kfs[k].T for every keyframe reachable from root_id.

    Returns the embedding order [(accumulated_distance, kf_id), ...] sorted
    by distance (the reference's me_map multimap)."""
    if walker == "native" and len(state.kfs) > 2:
        return _native_embedding(state, root_id)
    if walker not in WALKERS:
        raise ValueError(f"unknown embedding walker {walker!r}")
    return _python_embedding(state, root_id)


def _native_embedding(state: MapState, root_id: int):
    n = max(state.kfs) + 1
    E = len(state.edges)
    ei = np.empty(E, np.int32)
    ej = np.empty(E, np.int32)
    eT = np.empty((E, 12), np.float64)
    for k, ((i, j), e) in enumerate(state.edges.items()):
        ei[k] = i
        ej[k] = j
        eT[k, :9] = e.T.R.reshape(-1)
        eT[k, 9:] = e.T.t
    res = native.metric_embedding(n, ei, ej, eT, root_id)
    if res is None:
        raise RuntimeError("the native embedding walker is unavailable: "
                           f"{native.build_error}")
    order, T_out, dist = res
    out = []
    for rank, kid in enumerate(order):
        kid = int(kid)
        kf = state.kfs.get(kid)
        if kf is None:
            continue
        kf.T = Pose(T_out[kid, :9].reshape(3, 3), T_out[kid, 9:])
        out.append((float(dist[rank]), kid))
    return out


def _python_embedding(state: MapState, root_id: int):
    state.kfs[root_id].T = Pose()
    heap: List[Tuple[float, int, int]] = [(0.0, 0, root_id)]
    embedded = {root_id}
    order: List[Tuple[float, int]] = []
    tiebreak = 0

    while heap:
        d, _, kid = heapq.heappop(heap)
        order.append((d, kid))
        kf = state.kfs[kid]
        T = kf.T

        for nb in sorted(kf.neighbor_kfs):
            if nb in embedded:
                continue
            edge = state.edges[(kid, nb)]
            new_T = edge.T
            new_d = float(pow(new_T.t @ new_T.t, 0.5))
            state.kfs[nb].T = new_T @ T
            embedded.add(nb)
            tiebreak += 1
            heapq.heappush(heap, (d + new_d, tiebreak, nb))

    return order
