"""Checkpoint / resume of the interactive engine: the state carried across.

Port of ``slslam_tpu/checkpoint.py``.  The full map state (keyframes, edges
with both T and C, landmarks with their observation histories, the id-remap
table), the run statistics and the random stream round-trip through one
compressed npz archive in the JAX package's layout and ``FORMAT_VERSION``
(checkpoint.py:27-97).  The port's files add:

* ``torch_rng_state``: the engine's ``torch.Generator`` state, and in the
  metadata the generator's device type, the RANSAC call count and the VO
  failure streak, so that a resumed run repeats the straight run bit for
  bit;
* ``rng_key``: the JAX key the file would continue in the JAX package
  (the loaded JAX key, or ``PRNGKey(rseed)``'s raw words).

``load_checkpoint`` reads the port's files and the JAX package's.  A JAX
file restores the whole map and keeps its ``rng_key`` array as
``slam.jax_rng_key`` (a test hook continues JAX's stream from it); it holds
no Generator state, so the Generator keeps its seed and a warning says so.
"""

from __future__ import annotations

import json
import warnings
from typing import TYPE_CHECKING

import numpy as np
import torch

from .engine.state import Edge, Keyframe, Landmark, MapState
from .hostgeom import Pose

if TYPE_CHECKING:
    from .engine.slam import Slam

FORMAT_VERSION = 1


def _jax_key_words(slam: "Slam") -> np.ndarray:
    if slam.jax_rng_key is not None:
        return np.asarray(slam.jax_rng_key)
    # jax.random.PRNGKey(seed) for 0 <= seed < 2**32: [0, seed] as uint32
    return np.array([0, slam.cfg.rseed], np.uint32)


def save_checkpoint(slam: "Slam", path: str):
    st = slam.state

    kf_ids = sorted(st.kfs)
    kf_R = np.stack([st.kfs[k].T.R for k in kf_ids]) if kf_ids else \
        np.zeros((0, 3, 3))
    kf_t = np.stack([st.kfs[k].T.t for k in kf_ids]) if kf_ids else \
        np.zeros((0, 3))
    kf_members = [sorted(st.kfs[k].member_lms) for k in kf_ids]
    kf_neighbors = [sorted(st.kfs[k].neighbor_kfs) for k in kf_ids]

    edge_keys = sorted(st.edges)
    edge_data = np.stack([
        np.concatenate([st.edges[k].T.R.reshape(-1), st.edges[k].T.t,
                        st.edges[k].C.R.reshape(-1), st.edges[k].C.t])
        for k in edge_keys]) if edge_keys else np.zeros((0, 24))

    lm_ids = sorted(st.lms)
    lm_line = np.stack([st.lms[i].line for i in lm_ids]) if lm_ids else \
        np.zeros((0, 6))
    lm_tt = np.stack([st.lms[i].tt for i in lm_ids]) if lm_ids else \
        np.zeros((0, 2))
    lm_pvn = np.stack([st.lms[i].pvn for i in lm_ids]) if lm_ids else \
        np.zeros((0, 3))
    lm_flags = np.array([[st.lms[i].twice_observed, st.lms[i].ba_updated,
                          st.lms[i].currently_visible, st.lms[i].init_kfid]
                         for i in lm_ids], np.int64) if lm_ids else \
        np.zeros((0, 4), np.int64)
    # observation histories: flat arrays + per-landmark counts
    obs_counts = np.array([len(st.lms[i].obs_vec) for i in lm_ids],
                          np.int64) if lm_ids else np.zeros(0, np.int64)
    obs_kfids = np.concatenate(
        [[kfid for kfid, _ in st.lms[i].obs_vec] for i in lm_ids]
        or [[]]).astype(np.int64)
    obs_data = (np.concatenate(
        [[o for _, o in st.lms[i].obs_vec] for i in lm_ids])
        if lm_ids and obs_counts.sum() else np.zeros((0, 8)))

    meta = {
        "version": FORMAT_VERSION,
        "frame_id": slam.frame_id,
        "lc_cnt": slam.lc_cnt,
        "lc_kf_id": slam.lc_kf_id,
        "sum_init_cost": slam.sum_init_cost,
        "sum_final_cost": slam.sum_final_cost,
        "sum_num_iteration": slam.sum_num_iteration,
        "num_frames_processed": slam.num_frames_processed,
        "match_lookup": sorted(st.match_lookup.items()),
        "kf_members": kf_members,
        "kf_neighbors": kf_neighbors,
        "edge_keys": [list(k) for k in edge_keys],
        "edge_set": sorted(list(e) for e in st.edge_set),
        "prev_ba_kfs": sorted(slam.prev_ba_kfs),
        "prev_kf_obs_ids": sorted(slam.prev_kf_obs),
        "curr_pose": [slam.curr_pose.R.tolist(), slam.curr_pose.t.tolist()],
        # the port's additions
        "torch_rng_device": slam.generator.device.type,
        "vo_calls": slam.vo_calls,
        "vo_fail_streak": slam._vo_fail_streak,
        "pgo_runs": slam.pgo_runs,
    }

    prev_obs = (np.stack([slam.prev_kf_obs[i]
                          for i in sorted(slam.prev_kf_obs)])
                if slam.prev_kf_obs else np.zeros((0, 8)))

    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
        kf_ids=np.asarray(kf_ids, np.int64), kf_R=kf_R, kf_t=kf_t,
        edge_data=edge_data,
        lm_ids=np.asarray(lm_ids, np.int64), lm_line=lm_line, lm_tt=lm_tt,
        lm_pvn=lm_pvn, lm_flags=lm_flags, obs_counts=obs_counts,
        obs_kfids=obs_kfids, obs_data=obs_data,
        prev_obs=prev_obs,
        rng_key=_jax_key_words(slam),
        torch_rng_state=slam.generator.get_state().numpy())


def load_checkpoint(slam: "Slam", path: str):
    """Restore ``slam`` from a checkpoint of the port or of the JAX
    package."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["meta"]).decode())
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != "
                         f"{FORMAT_VERSION}")

    st = MapState()
    kf_ids = z["kf_ids"]
    for n, kid in enumerate(kf_ids):
        kf = Keyframe(T=Pose(z["kf_R"][n], z["kf_t"][n]))
        kf.member_lms = set(meta["kf_members"][n])
        kf.neighbor_kfs = set(meta["kf_neighbors"][n])
        st.kfs[int(kid)] = kf

    for n, key in enumerate(meta["edge_keys"]):
        d = z["edge_data"][n]
        st.edges[tuple(key)] = Edge(Pose(d[:9].reshape(3, 3), d[9:12]),
                                    Pose(d[12:21].reshape(3, 3), d[21:24]))
    st.edge_set = {tuple(e) for e in meta["edge_set"]}
    st.match_lookup = {int(a): int(b) for a, b in meta["match_lookup"]}

    off = 0
    for n, lid in enumerate(z["lm_ids"]):
        lm = Landmark(line=z["lm_line"][n].copy(),
                      init_kfid=int(z["lm_flags"][n, 3]))
        lm.tt = z["lm_tt"][n].copy()
        lm.pvn = z["lm_pvn"][n].copy()
        lm.twice_observed = bool(z["lm_flags"][n, 0])
        lm.ba_updated = bool(z["lm_flags"][n, 1])
        lm.currently_visible = bool(z["lm_flags"][n, 2])
        cnt = int(z["obs_counts"][n])
        for k in range(cnt):
            lm.obs_vec.append((int(z["obs_kfids"][off + k]),
                               z["obs_data"][off + k].copy()))
        off += cnt
        st.lms[int(lid)] = lm

    slam.state = st
    slam.frame_id = meta["frame_id"]
    slam.lc_cnt = meta["lc_cnt"]
    slam.lc_kf_id = meta["lc_kf_id"]
    slam.sum_init_cost = meta["sum_init_cost"]
    slam.sum_final_cost = meta["sum_final_cost"]
    slam.sum_num_iteration = meta["sum_num_iteration"]
    slam.num_frames_processed = meta["num_frames_processed"]
    slam.prev_ba_kfs = set(meta["prev_ba_kfs"])
    slam.curr_pose = Pose(np.asarray(meta["curr_pose"][0]),
                          np.asarray(meta["curr_pose"][1]))
    slam.prev_kf_obs = {
        int(i): z["prev_obs"][n]
        for n, i in enumerate(meta["prev_kf_obs_ids"])}
    slam.jax_rng_key = np.asarray(z["rng_key"])

    if "torch_rng_state" not in z.files:
        slam.vo_calls = 0
        slam._vo_fail_streak = 0
        warnings.warn("a JAX package checkpoint: the map is restored, the "
                      "random stream is not (its rng_key is kept as "
                      "slam.jax_rng_key; the torch.Generator keeps its "
                      "seed)", RuntimeWarning, stacklevel=2)
        return
    slam.vo_calls = meta["vo_calls"]
    slam._vo_fail_streak = meta["vo_fail_streak"]
    slam.pgo_runs = meta["pgo_runs"]
    if meta["torch_rng_device"] != slam.generator.device.type:
        warnings.warn(f"checkpoint's generator state is for "
                      f"{meta['torch_rng_device']}, this engine runs on "
                      f"{slam.generator.device.type}: the random stream is "
                      "not restored", RuntimeWarning, stacklevel=2)
        return
    slam.generator.set_state(torch.as_tensor(z["torch_rng_state"]))
