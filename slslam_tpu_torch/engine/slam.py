"""The interactive SLAM engine: a per-frame host loop over device solves.

Port of ``slslam_tpu/engine/slam.py`` (class SLAM of the reference,
slam.{h,cpp}): this module owns the host-side map registries, id
bookkeeping, metric embedding and window selection, and calls the port's
device solves for every hot computation: RANSAC VO with its motion-only
polish (``ops/vo_pipeline.py``; K2 ``cams``), the staged window BA
(``ops/schur_ba.py`` ``staged_local_ba``; K2 ``lines`` and K1, then K2
``full``), the pose-graph optimization (``ops/pose_graph.py``; K1) and
batched triangulation.  Every device problem is padded to the config's
capacity buckets, as in the JAX engine.

Per-frame cycle (main.cpp:45-80):
  start_cycle -> grab_frame -> check_input_data -> check_keyframe_motion
  -> add_new_keyframe -> [place_recognized -> loop_closure ->
  pose_optimization] -> local_bundle_adjustment -> end_cycle

Randomness: RANSAC's Gumbel noise comes from a ``torch.Generator`` seeded
with ``cfg.rseed``; ``gumbel_hook(call_index, H, Nb)`` can give the noise of
each RANSAC instead (``call_index`` counts the RANSAC calls of this engine,
from 0 at construction or at loading a JAX checkpoint), which is how the
tests replay the JAX engine's stream (one key split per RANSAC call,
slam.py:288).  ``cfg.ba_init_jitter`` takes JAX's numpy stream exactly:
``default_rng((rseed, frame_id, 0x0B0A))`` (slam.py:549-554).

The engine runs on ``device`` (default the card; ``"cpu"`` runs the plain
twins, as the tests do) and never falls back: a CUDA request without CUDA
raises.

``cfg.mesh_devices > 1`` is the mesh path (slslam_tpu/engine/slam.py:
104-114, 568-608, 929-945): every rank of an initialized
``torch.distributed`` process group of that world size runs the same
engine on the same frames, the window BA runs line-sharded
(``parallel.dist_local_ba_lines``; the staged lines-GN first, on the whole
problem) and the PGO edge-sharded (``parallel.dist_pose_graph_opt``), and
the ranks' maps stay equal bit for bit.  As in the JAX package, the mesh
path passes no window anchors to the sharded solve.  Without such a group
the engine raises; it never runs single-process in its place.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

import numpy as np
import torch

from .. import resolve_device, resolve_dtype
from ..config import SlamConfig, bucket_for
from ..hostgeom import (Pose, aid_to_av_np, av_to_aid_np, av_to_orth_np,
                        line_from_pose, line_to_pose, normalize,
                        orth_to_av_np, rotation_angle)
from .. import geometry as geo
from ..ops.pose_graph import pose_graph_opt
from ..ops.schur_ba import staged_local_ba
from ..ops.triangulate import triangulate_lines
from ..ops.vo_pipeline import vo_pipeline
from ..utils.stopwatch import StopWatch
from .batch import window_anchor
from .embedding import metric_embedding, resolve_walker
from .state import Edge, Keyframe, Landmark, MapState

GumbelHook = Callable[[int, int, int], torch.Tensor]


def _encode_lines_host(line_av, line_param):
    """(N, 6) -> (N, 4) on the host (slam.py:53-62): the numpy mirrors for
    orth and aid, geometry's encoder in float64 for asd."""
    if line_param == "orth":
        return av_to_orth_np(line_av)
    if line_param == "aid":
        return av_to_aid_np(line_av)
    return geo.LINE_ENCODERS[line_param](
        torch.as_tensor(line_av, dtype=torch.float64)).numpy()


def _decode_lines_host(line_p4, line_param):
    if line_param == "orth":
        return orth_to_av_np(line_p4)
    if line_param == "aid":
        return aid_to_av_np(line_p4)
    return geo.LINE_DECODERS[line_param](
        torch.as_tensor(line_p4, dtype=torch.float64)).numpy()


class Slam:
    """The engine; one instance per sequence (reference SLAM ctor,
    slam.cpp:30-40)."""

    def __init__(self, config: Optional[SlamConfig] = None, device="cuda",
                 dtype=None, gumbel_hook: Optional[GumbelHook] = None):
        self.cfg = config or SlamConfig()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype or self.cfg.compute_dtype)
        # the mesh path: window BA line-sharded, PGO edge-sharded over the
        # default process group, whose world size must be mesh_devices
        self.group = None
        self.rank = 0
        if self.cfg.mesh_devices and self.cfg.mesh_devices > 1:
            import torch.distributed as dist

            from ..parallel import make_mesh
            try:
                self.group, self.rank, world = make_mesh()
            except RuntimeError as e:
                raise RuntimeError(
                    f"mesh_devices={self.cfg.mesh_devices} needs an "
                    f"initialized process group of world size "
                    f"{self.cfg.mesh_devices}: {e}") from None
            if world != self.cfg.mesh_devices:
                raise ValueError(
                    f"mesh_devices={self.cfg.mesh_devices} but the process "
                    f"group has world size {world}")
            self.dist_backend = dist.get_backend(self.group)
        self.embedding_walker = resolve_walker()
        self.state = MapState()

        self.frame_id = -1
        self.curr_pose = Pose()
        self.curr_obs: Dict[int, np.ndarray] = {}
        self.prev_kf_obs: Dict[int, np.ndarray] = {}
        self.final_inliers: Set[int] = set()
        self._vo_fail_streak = 0
        self._last_failed_motion: Optional[Pose] = None
        self._vo_fail_kind: Optional[str] = None
        self.ba_kfs: Dict[int, int] = {}
        self.prev_ba_kfs: Set[int] = set()
        self.match_result: Dict[int, int] = {}
        self.lc_kf_id = -1
        self.lc_cnt = 0

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.cfg.rseed)
        self.gumbel_hook = gumbel_hook
        self.vo_calls = 0
        # a JAX checkpoint's rng_key array (checkpoint.load_checkpoint)
        self.jax_rng_key: Optional[np.ndarray] = None
        self.stop_watch = StopWatch()

        # optional loop-closure subsystem (slslam_tpu_torch.loopclosure): a
        # PlaceRecognizer plus a descriptor source mapping
        # (frame_id, [feature ids]) -> (F, 72) descriptors
        self.place_recognizer = None
        self.descriptor_source = None
        self.verbose = False
        self.pgo_runs = 0

        # run statistics (reference m_sum_*, slam.cpp:37-39,949-952)
        self.sum_init_cost = 0.0
        self.sum_final_cost = 0.0
        self.sum_num_iteration = 0
        self.num_frames_processed = 0

    def _embed(self, root_id):
        return metric_embedding(self.state, root_id, self.embedding_walker)

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    # cycle plumbing
    # ------------------------------------------------------------------

    def start_cycle(self, frame_id: int):
        """slam.cpp:50-58."""
        self.frame_id = frame_id
        self.curr_obs = {}
        self.ba_kfs = {}
        self.match_result = {}

    def grab_frame(self, obs: Dict[int, np.ndarray],
                   normalized: bool = True):
        """Ingest one frame of stereo line observations (slam.cpp:62-135):
        pixel coordinates are normalized with the calibration unless
        ``normalized``; the loop-closure id remap applies; landmark
        visibility is refreshed."""
        for lm in self.state.lms.values():
            lm.currently_visible = False

        cam = self.cfg.camera
        for fid, o in obs.items():
            o = np.asarray(o, np.float64)
            if not normalized:
                o = o.copy()
                o[0::2] = o[0::2] / cam.fx - cam.cx / cam.fx
                o[1::2] = o[1::2] / cam.fy - cam.cy / cam.fy
            fid = self.state.match_lookup.get(fid, fid)
            self.curr_obs[fid] = o
            if fid in self.state.lms:
                self.state.lms[fid].currently_visible = True

    def check_input_data(self) -> int:
        """slam.cpp:139-147: 1 = no obs, 2 = no previous KF, 0 = proceed."""
        if not self.curr_obs:
            return 1
        if not self.prev_kf_obs:
            return 2
        return 0

    def end_cycle(self):
        """slam.cpp:1553-1555."""
        self.prev_kf_obs = self.curr_obs

    def process_frame(self, obs: Dict[int, np.ndarray], frame_id: int,
                      normalized: bool = True) -> bool:
        """One full frame of the reference main loop (main.cpp:45-80).
        Returns True if the frame became a keyframe."""
        self.start_cycle(frame_id)
        self.grab_frame(obs, normalized=normalized)
        status = self.check_input_data()
        if status == 1:
            return False
        if status == 2:
            self.add_new_keyframe(add_edge=False)
            self.end_cycle()
            return True
        if not self.check_keyframe_motion():
            return False
        self.add_new_keyframe(add_edge=True)
        if self.place_recognized() and self.loop_closure():
            if self.consistency_broken():
                self.pose_optimization()
        self.local_bundle_adjustment()
        self.end_cycle()
        self.num_frames_processed += 1
        return True

    # ------------------------------------------------------------------
    # landmark initialization
    # ------------------------------------------------------------------

    def _add_lms(self):
        """slam.cpp:161-186: triangulate new features in one batched call
        padded to an observation bucket, append observations of known
        ones."""
        st = self.state
        kfid = st.last_kf_id()
        new_kfid = (kfid + 1) if kfid is not None else 0

        new_ids = [fid for fid in self.curr_obs if fid not in st.lms]
        new_set = set(new_ids)
        if new_ids:
            Nb = bucket_for(len(new_ids), self.cfg.obs_buckets)
            O = np.zeros((Nb, 8))
            O[:len(new_ids)] = np.stack([self.curr_obs[f] for f in new_ids])
            lines = triangulate_lines(
                self._tensor(O), self.cfg.camera.baseline,
                inverse_depth=self.cfg.inverse_depth)
            lines = lines.cpu().numpy().astype(np.float64)[:len(new_ids)]
            for fid, line in zip(new_ids, lines):
                lm = Landmark(line=line, init_kfid=new_kfid)
                lm.tt = np.zeros(2)
                lm.pvn = normalize(line[3:])
                lm.obs_vec.append((new_kfid, self.curr_obs[fid]))
                st.lms[fid] = lm

        for fid, o in self.curr_obs.items():
            if fid not in new_set:
                st.lms[fid].obs_vec.append((new_kfid, o))

    # ------------------------------------------------------------------
    # visual odometry
    # ------------------------------------------------------------------

    def pose_estimation(self, obs0: Dict[int, np.ndarray],
                        obs1: Dict[int, np.ndarray],
                        max_t_norm: Optional[float] = None
                        ) -> Optional[Pose]:
        """slam.cpp:244-319: RANSAC + motion-only BA + final inliers.

        Landmark lines are fetched in the current embedding frame; the
        caller must have run metric_embedding at the reference frame.
        Returns the motion (frame of obs0 -> frame of obs1) or None."""
        self.stop_watch.tick("pose_estimation")
        st = self.state
        cfg = self.cfg
        # failure taxonomy of the recovery streak (slam.py:258-262):
        # "sparse" resets it, "ransac" increments it
        self._vo_fail_kind = None

        comm = sorted(set(obs0) & set(obs1) & set(st.lms))
        if len(comm) < cfg.ransac_min_sample:
            self._vo_fail_kind = "sparse"
            self.stop_watch.tock("pose_estimation")
            return None

        ln = np.stack([line_from_pose(st.lms[f].line,
                                      st.kfs[st.lms[f].init_kfid].T)
                       for f in comm])
        N = len(comm)
        gumbel = None
        if self.gumbel_hook is not None:
            gumbel = self.gumbel_hook(self.vo_calls,
                                      cfg.ransac_num_hypotheses,
                                      bucket_for(N, cfg.corr_buckets))
        self.vo_calls += 1
        res = vo_pipeline(
            np.stack([obs0[f] for f in comm]),
            np.stack([obs1[f] for f in comm]), ln, cfg.camera.baseline,
            cfg.error_thr, cfg.huber_delta, cfg.corr_buckets, self.device,
            self.dtype,
            max_t_norm=(max_t_norm if max_t_norm is not None
                        else cfg.ransac_max_t_norm),
            num_hyp=cfg.ransac_num_hypotheses,
            sample_size=cfg.ransac_min_sample, robust=cfg.robust,
            max_iters=cfg.moba_max_iter, line_param=cfg.line_param,
            relin_iters=cfg.vo_relin_iters, gumbel=gumbel,
            generator=self.generator)
        # one device -> host read for the whole VO result
        out = torch.cat([res.wt, res.ransac_score.to(res.wt.dtype)[None],
                         res.final_errors]).cpu().numpy().astype(np.float64)
        wt, best_score, errors = out[:6], int(out[6]), out[7:]

        if not np.all(np.isfinite(wt)):
            # a non-finite solve is a tracking failure for this frame,
            # never written to the map (slam.py:304-311)
            self._vo_fail_kind = "ransac"
            self.stop_watch.tock("pose_estimation")
            return None
        self.final_inliers = {
            comm[k] for k in range(N) if errors[k] < cfg.error_thr}
        if best_score < cfg.ransac_min_sample:
            # keep the best-effort motion for the recovery path
            self._vo_fail_kind = "ransac"
            self._last_failed_motion = Pose.from_wt(wt)
            self.stop_watch.tock("pose_estimation")
            return None

        if self.verbose:
            print(f"{self.frame_id}:\tFeature Num: {N}-{best_score}"
                  f"-{len(self.final_inliers)}")
        self.stop_watch.tock("pose_estimation")
        return Pose.from_wt(wt)

    def check_keyframe_motion(self) -> bool:
        """slam.cpp:223-240: VO against the previous keyframe; a keyframe
        iff the motion exceeds the rotation/translation thresholds.  After
        ``vo_fail_recovery`` consecutive RANSAC failures with enough common
        features the best-effort motion is accepted (slam.py:334-375)."""
        st = self.state
        cfg = self.cfg
        self._embed(st.last_kf_id())
        self._last_failed_motion = None
        motion = self.pose_estimation(self.prev_kf_obs, self.curr_obs)
        if motion is None:
            if self._vo_fail_kind == "ransac":
                self._vo_fail_streak += 1
                if (cfg.vo_fail_recovery > 0
                        and self._vo_fail_streak >= cfg.vo_fail_recovery
                        and self._last_failed_motion is not None
                        and np.linalg.norm(self._last_failed_motion.t)
                        <= 2.0 * cfg.ransac_max_t_norm):
                    self.curr_pose = self._last_failed_motion
                    self._vo_fail_streak = 0
                    return True
            else:
                self._vo_fail_streak = 0
            return False
        if (rotation_angle(motion.R) < cfg.kf_rot_thr
                and np.linalg.norm(motion.t) < cfg.kf_tr_thr):
            self._vo_fail_streak = 0
            return False
        self.curr_pose = motion
        self._vo_fail_streak = 0
        return True

    # ------------------------------------------------------------------
    # keyframe / map growth
    # ------------------------------------------------------------------

    def add_new_keyframe(self, add_edge: bool):
        """slam.cpp:730-761."""
        st = self.state
        kf = Keyframe(T=self.curr_pose.copy())

        prev_id = st.last_kf_id()
        # member lms: final inliers on the new and the previous keyframe
        # (slam.cpp:151-157)
        for fid in self.final_inliers:
            kf.member_lms.add(fid)
            if prev_id is not None:
                st.kfs[prev_id].member_lms.add(fid)

        self._add_lms()

        new_id = (prev_id + 1) if prev_id is not None else 0
        if add_edge:
            e = Edge.from_pose(self.curr_pose)
            st.edges[(prev_id, new_id)] = e
            st.edges[(new_id, prev_id)] = e.inverse()
            st.edge_set.add((prev_id, new_id))
            kf.neighbor_kfs.add(prev_id)
            st.kfs[prev_id].neighbor_kfs.add(new_id)

        st.kfs[new_id] = kf

    # ------------------------------------------------------------------
    # local bundle adjustment
    # ------------------------------------------------------------------

    def local_bundle_adjustment(self):
        """slam.cpp:1370-1427: embed at the newest keyframe, window = the
        first 2W keyframes by metric distance, BA, then write the BA's
        relative poses back into the edge constraints."""
        st = self.state
        cfg = self.cfg

        self.stop_watch.tick("embedding")
        order = self._embed(st.last_kf_id())
        self.stop_watch.tock("embedding")
        self.ba_kfs = {}
        for rank, (_, kid) in enumerate(order):
            if rank >= 2 * cfg.ba_window_size:
                break
            self.ba_kfs[kid] = rank

        self.stop_watch.tick("local_ba")
        self._bundle_adjustment()
        self.stop_watch.tock("local_ba")

        # refresh every intra-free-window edge: T and C := the BA relative
        # pose (slam.cpp:1390-1416)
        free = sorted(k for k, rank in self.ba_kfs.items()
                      if rank < cfg.ba_window_size)
        for i in range(len(free)):
            for j in range(i + 1, len(free)):
                n1, n2 = free[i], free[j]
                if (n1, n2) not in st.edges:
                    continue
                T = st.kfs[n2].T.rel_to(st.kfs[n1].T)
                st.edges[(n1, n2)].T = T.copy()
                st.edges[(n1, n2)].C = T.copy()
                Ti = T.inv()
                st.edges[(n2, n1)].T = Ti.copy()
                st.edges[(n2, n1)].C = Ti.copy()

        self.delete_lms()
        self.stop_watch.tick("endpoints")
        self.extend_end_points()
        self.stop_watch.tock("endpoints")

    def _bundle_adjustment(self):
        """slam.cpp:795-975: pack the window problem, solve, write back."""
        st = self.state
        cfg = self.cfg
        self.stop_watch.tick("ba_pack")

        # free cameras: window rank < W, registered in ascending kf id
        kfid_map: Dict[int, int] = {}
        vec_kfs: List[int] = []
        cam_wt: List[np.ndarray] = []
        lm_count: Dict[int, int] = {}
        for kid in sorted(self.ba_kfs):
            if self.ba_kfs[kid] >= cfg.ba_window_size:
                continue
            for fid in st.kfs[kid].member_lms:
                lm_count[fid] = lm_count.get(fid, 0) + 1
            kfid_map[kid] = len(vec_kfs)
            vec_kfs.append(kid)
            cam_wt.append(st.kfs[kid].T.wt())

        num_free = len(vec_kfs)
        max_kf = st.last_kf_id()
        in_window = np.zeros(max_kf + 1, bool)
        for kid in self.ba_kfs:
            in_window[kid] = True
        kfidx_of = np.full(max_kf + 1, -1, np.int64)
        for kid, ci in kfid_map.items():
            kfidx_of[kid] = ci

        obs_chunks: List[np.ndarray] = []
        cam_chunks: List[np.ndarray] = []
        line_chunks: List[np.ndarray] = []
        cam_fixed_flags: List[bool] = [False] * num_free
        line_ids: List[int] = []

        for fid in sorted(lm_count):
            if lm_count[fid] < 2 or fid not in st.lms:
                continue
            lm = st.lms[fid]
            lm.twice_observed = True
            lm.ba_updated = True
            kfids, obs_arr = lm.obs_arrays()
            mask = in_window[kfids]
            if not mask.any():
                continue
            sel_kfids = kfids[mask]
            # out-of-free-window observers become fixed cameras
            for kid in np.unique(sel_kfids[kfidx_of[sel_kfids] < 0]):
                ci = len(vec_kfs)
                kfid_map[int(kid)] = ci
                kfidx_of[kid] = ci
                vec_kfs.append(int(kid))
                cam_wt.append(st.kfs[int(kid)].T.wt())
                cam_fixed_flags.append(True)
            obs_chunks.append(obs_arr[mask])
            cam_chunks.append(kfidx_of[sel_kfids])
            line_chunks.append(np.full(mask.sum(), len(line_ids), np.int64))
            line_ids.append(fid)

        if not line_ids or num_free == 0:
            return

        # batched line fetch into the embedding frame, host-side encode
        Ti_cache = {}
        line_av = np.empty((len(line_ids), 6))
        for n, fid in enumerate(line_ids):
            lm = st.lms[fid]
            Ti = Ti_cache.get(lm.init_kfid)
            if Ti is None:
                Ti = st.kfs[lm.init_kfid].T.inv()
                Ti_cache[lm.init_kfid] = Ti
            line_av[n, :3] = Ti.R @ lm.line[:3] + Ti.t
            line_av[n, 3:] = Ti.R @ lm.line[3:]
        line_p4 = _encode_lines_host(line_av, cfg.line_param)

        obs_rows = np.concatenate(obs_chunks)
        C, L, O = len(vec_kfs), len(line_ids), len(obs_rows)
        Cb = bucket_for(C, cfg.cam_buckets)
        Lb = bucket_for(L, cfg.line_buckets)
        Ob = bucket_for(O, cfg.obs_buckets)

        cam_p = np.zeros((Cb, 6))
        cam_p[:C] = np.stack(cam_wt)
        cam_free = np.zeros(Cb, bool)
        cam_free[:C] = ~np.asarray(cam_fixed_flags)
        lorth = np.zeros((Lb, 4))
        lorth[:, 3] = 0.5
        lorth[:L] = line_p4
        if cfg.ba_init_jitter:
            # deterministic annealing jitter on the free lines only, JAX's
            # numpy stream (slam.py:549-554)
            jrng = np.random.default_rng((cfg.rseed, self.frame_id, 0x0B0A))
            lorth[:L] += cfg.ba_init_jitter * jrng.standard_normal((L, 4))
        line_free = np.zeros(Lb, bool)
        line_free[:L] = True
        obs_p = np.zeros((Ob, 8))
        obs_p[:O] = obs_rows
        ocam = np.zeros(Ob, np.int32)
        ocam[:O] = np.concatenate(cam_chunks)
        olin = np.zeros(Ob, np.int32)
        olin[:O] = np.concatenate(line_chunks)
        valid = np.zeros(Ob, bool)
        valid[:O] = True
        self.stop_watch.tock("ba_pack")

        dev = self.device
        if self.group is not None:
            cam_out, line_out, stats = self._sharded_ba(
                cam_p, lorth, obs_p, ocam, olin, valid, cam_free, line_free)
        else:
            cam_dev, line_dev, stats = staged_local_ba(
                self._tensor(cam_p), self._tensor(lorth),
                self._tensor(obs_p), torch.as_tensor(ocam, device=dev),
                torch.as_tensor(olin, device=dev),
                torch.as_tensor(valid, device=dev),
                torch.as_tensor(cam_free, device=dev),
                torch.as_tensor(line_free, device=dev), cfg.camera.baseline,
                cfg.huber_delta, robust=cfg.robust,
                max_iters=cfg.max_num_iter, line_param=cfg.line_param,
                gn_iters=cfg.lines_gn_iters,
                cam_anchor_sigmas=window_anchor(cfg))
            cam_out = cam_dev.cpu().numpy().astype(np.float64)
            line_out = line_dev.cpu().numpy().astype(np.float64)
        iters = int(stats.iterations)
        init_cost = float(stats.initial_cost)
        final_cost = float(stats.final_cost)

        self.sum_num_iteration += iters
        self.sum_init_cost += init_cost
        self.sum_final_cost += final_cost
        if self.verbose:
            print(f"\tBA: {C} cams / {L} lines / {O} obs, {iters} iters, "
                  f"cost {init_cost:.3e} -> {final_cost:.3e}")

        if not (np.all(np.isfinite(cam_out))
                and np.all(np.isfinite(line_out))):
            # reject the whole solve rather than poison the relative map
            return
        # poses first, then lines, which re-read the updated init-KF poses
        # (slam.cpp:957-972)
        for ci, kid in enumerate(vec_kfs):
            st.kfs[kid].T = Pose.from_wt(cam_out[ci])
        line_av_out = _decode_lines_host(line_out[:L], cfg.line_param)
        T_cache = {}
        for li, fid in enumerate(line_ids):
            lm = st.lms[fid]
            T = T_cache.get(lm.init_kfid)
            if T is None:
                T = st.kfs[lm.init_kfid].T
                T_cache[lm.init_kfid] = T
            lm.line = line_to_pose(line_av_out[li], T)

    def _sharded_ba(self, cam_p, lorth, obs_p, ocam, olin, valid, cam_free,
                    line_free):
        """The mesh path's window solve (slam.py:568-601): the staged
        lines-GN on the whole problem, the partition by line, this rank's
        sharded solve, and the ranks' lines gathered and put back in global
        order.  No window anchors, as in the JAX package."""
        from ..ops.schur_ba import lines_gn
        from ..parallel import (all_gather_shards, dist_local_ba_lines,
                                partition_by_line)
        cfg = self.cfg
        dev = self.device
        if cfg.lines_gn_iters > 0:
            # before the partition, so the sharded solve starts where the
            # single-process staged_local_ba's local_ba does
            lorth = lines_gn(
                self._tensor(cam_p), self._tensor(lorth),
                self._tensor(obs_p), torch.as_tensor(ocam, device=dev),
                torch.as_tensor(olin, device=dev),
                torch.as_tensor(valid, device=dev),
                torch.as_tensor(line_free, device=dev), cfg.camera.baseline,
                cfg.huber_delta, robust=cfg.robust, iters=cfg.lines_gn_iters,
                line_param=cfg.line_param).cpu().numpy().astype(np.float64)
        n = cfg.mesh_devices
        lo, lf, ob, oc, ol, ov, perm = partition_by_line(
            lorth, line_free, obs_p, ocam, olin, valid, n)
        r = self.rank
        cam_dev, line_dev, stats = dist_local_ba_lines(
            self.group, self._tensor(cam_p), self._tensor(lo[r]),
            self._tensor(ob[r]), torch.as_tensor(oc[r], device=dev),
            torch.as_tensor(ol[r], device=dev),
            torch.as_tensor(ov[r], device=dev),
            torch.as_tensor(cam_free, device=dev),
            torch.as_tensor(lf[r], device=dev), cfg.camera.baseline,
            cfg.huber_delta, robust=cfg.robust, max_iters=cfg.max_num_iter,
            line_param=cfg.line_param)
        line_sh = all_gather_shards(self.group, line_dev)
        line_out = line_sh.cpu().numpy().astype(np.float64).reshape(
            -1, 4)[perm]
        return cam_dev.cpu().numpy().astype(np.float64), line_out, stats

    # ------------------------------------------------------------------
    # landmark lifecycle
    # ------------------------------------------------------------------

    def delete_lms(self):
        """slam.cpp:765-791.  The released reference never populates
        curr_ba_kfs, so deletion never fires; the intended semantics sit
        behind cfg.gc_landmarks (slam.py:658-680)."""
        if not getattr(self.cfg, "gc_landmarks", False):
            self.prev_ba_kfs = set()
            return
        st = self.state
        curr = set(self.ba_kfs)
        for kid in self.prev_ba_kfs - curr:
            kf = st.kfs.get(kid)
            if kf is None:
                continue
            for fid in list(kf.member_lms):
                lm = st.lms.get(fid)
                if lm is None:
                    kf.member_lms.discard(fid)
                    continue
                if not lm.twice_observed:
                    del st.lms[fid]
        self.prev_ba_kfs = curr

    def extend_end_points(self):
        """slam.cpp:979-1084: maintain the finite endpoint intervals tt on
        the infinite landmark lines, vectorized over the active
        (BA-updated, currently visible) landmarks (slam.py:682-788)."""
        st = self.state
        thr = self.cfg.extension_length
        active = [lm for lm in st.lms.values()
                  if lm.ba_updated and lm.currently_visible]
        for lm in active:
            lm.ba_updated = False
        if not active:
            return
        M = len(active)
        line = np.stack([lm.line for lm in active])      # init-KF frame
        pvn = np.stack([lm.pvn for lm in active])
        tt_cur = np.stack([lm.tt for lm in active])
        obs = np.stack([lm.obs_vec[-1][1] for lm in active])

        def nrm(v):
            n = np.linalg.norm(v, axis=-1, keepdims=True)
            return np.where(n > 0, v / np.where(n > 0, n, 1.0), v)

        # direction-change reset (slam.cpp:990-996)
        cvn = nrm(line[:, 3:])
        ang = np.arccos(np.clip(np.sum(cvn * pvn, axis=1), -1.0, 1.0))
        reset = ang > self.cfg.line_vn_angle_thr
        pvn_new = np.where(reset[:, None], cvn, pvn)
        tt_cur = np.where(reset[:, None], 0.0, tt_cur)

        # init poses (world -> init cam in the current embedding)
        Rk = np.empty((M, 3, 3))
        tk = np.empty((M, 3))
        cache = {}
        for i, lm in enumerate(active):
            P = cache.get(lm.init_kfid)
            if P is None:
                P = st.kfs[lm.init_kfid].T
                cache[lm.init_kfid] = P
            Rk[i] = P.R
            tk[i] = P.t

        # the line in the embedding frame (line_from_pose, batched)
        Rki = np.transpose(Rk, (0, 2, 1))
        tki = -np.einsum("mij,mj->mi", Rki, tk)
        pc = np.einsum("mij,mj->mi", Rki, line[:, :3]) + tki
        vc = np.einsum("mij,mj->mi", Rki, line[:, 3:])
        nc = np.cross(pc, vc)

        one = np.ones((M, 1))
        p11 = np.concatenate([obs[:, 0:2], one], axis=1)
        p21 = np.concatenate([obs[:, 2:4], one], axis=1)
        ln = np.cross(p11, p21)[:, :2]
        n_ln = np.linalg.norm(ln, axis=1)
        ok = n_ln > 0
        ln = ln / np.maximum(n_ln, 1e-300)[:, None]
        zero = np.zeros((M, 1))
        p12 = p11 + np.concatenate([ln, zero], axis=1)
        p22 = p21 + np.concatenate([ln, zero], axis=1)

        # planes through the camera center: pi = (p_a x p_b, 0); for such a
        # plane the Plücker intersection Lc @ pi is (nc x n, -vc . n)
        n1 = np.cross(p11, p12)
        n2 = np.cross(p21, p22)
        e1_xyz = np.cross(nc, n1)
        e1_w = -np.sum(vc * n1, axis=1)
        e2_xyz = np.cross(nc, n2)
        e2_w = -np.sum(vc * n2, axis=1)

        vv = np.sum(vc * vc, axis=1)
        p0 = np.cross(vc, nc) / vv[:, None]
        vnn = vc / np.sqrt(vv)[:, None]
        p0_dist = np.linalg.norm(p0, axis=1)
        ok &= p0_dist <= thr
        ok &= (np.abs(e1_w) >= 1e-12) & (np.abs(e2_w) >= 1e-12)
        pc1 = e1_xyz / np.where(e1_w == 0, 1.0, e1_w)[:, None]
        pc2 = e2_xyz / np.where(e2_w == 0, 1.0, e2_w)[:, None]
        ok &= (pc1[:, 2] >= 0) & (pc2[:, 2] >= 0)

        t1 = np.sum(vnn * (pc1 - p0), axis=1)
        t2 = np.sum(vnn * (pc2 - p0), axis=1)
        tt_lo = np.minimum(t1, t2)
        tt_hi = np.maximum(t1, t2)
        extend = np.sqrt(np.maximum(thr * thr - p0_dist ** 2, 0.0))
        tt_lo = np.clip(tt_lo, -extend, extend)
        tt_hi = np.clip(tt_hi, -extend, extend)
        ok &= tt_lo != tt_hi

        # interval transport between frames: offset = init_pose.t . v_hat
        v_init_n = nrm(line[:, 3:])
        offset = np.sum(tk * v_init_n, axis=1)
        uninit = (tt_cur[:, 0] == 0) & (tt_cur[:, 1] == 0)
        tt1_lo = np.where(uninit, tt_lo,
                          np.minimum(tt_cur[:, 0] - offset, tt_lo))
        tt1_hi = np.where(uninit, tt_hi,
                          np.maximum(tt_cur[:, 1] - offset, tt_hi))
        new_lo = tt1_lo + offset
        new_hi = tt1_hi + offset

        for i, lm in enumerate(active):
            lm.pvn = pvn_new[i]
            lm.tt = (np.array([new_lo[i], new_hi[i]]) if ok[i]
                     else tt_cur[i].copy())

    # ------------------------------------------------------------------
    # loop closure / pose graph
    # ------------------------------------------------------------------

    def place_recognized(self) -> bool:
        """Query the place-recognition backend for the new keyframe
        (slam.cpp:1088-1104, the reference's intended flow): on a hit keep
        the matches whose current feature is a VO inlier.  False when no
        recognizer is attached (the release behavior)."""
        if self.place_recognizer is None or self.descriptor_source is None:
            return False
        kf_id = self.state.last_kf_id()
        feat_ids = sorted(self.curr_obs)
        desc = self.descriptor_source(self.frame_id, feat_ids)
        if desc is None or len(desc) != len(feat_ids):
            return False
        hit = self.place_recognizer.query_and_insert(kf_id, feat_ids, desc)
        if hit is None:
            return False
        lc_kf_id, match_result = hit
        self.match_result = {
            cid: lid for cid, lid in match_result.items()
            if cid in self.final_inliers}
        if len(self.match_result) < self.cfg.ransac_min_sample:
            return False
        self.lc_kf_id = lc_kf_id
        return True

    def loop_closure(self) -> bool:
        """slam.cpp:1108-1211: the loop's relative pose from the matched
        old landmarks, the loop edge, and the landmark merge."""
        st = self.state
        self.lc_cnt += 1
        self._embed(self.lc_kf_id)

        obs0: Dict[int, np.ndarray] = {}
        obs1: Dict[int, np.ndarray] = {}
        for cid, lid in self.match_result.items():
            lm = st.lms.get(lid)
            if lm is None:
                continue
            for (obs_kfid, o) in lm.obs_vec:
                if obs_kfid == self.lc_kf_id:
                    obs0[lid] = o
                    obs1[lid] = self.curr_obs[cid]
                    break

        motion = self.pose_estimation(
            obs0, obs1, max_t_norm=self.cfg.lc_ransac_max_t_norm)
        if motion is None:
            return False

        kfid = st.last_kf_id()
        e = Edge.from_pose(motion)
        st.edges[(self.lc_kf_id, kfid)] = e
        st.edges[(kfid, self.lc_kf_id)] = e.inverse()
        st.edge_set.add((self.lc_kf_id, kfid))
        st.kfs[self.lc_kf_id].neighbor_kfs.add(kfid)
        st.kfs[kfid].neighbor_kfs.add(self.lc_kf_id)

        # merge: the current landmark's history moves onto the old one,
        # keyframe memberships are rewritten, the current landmark goes,
        # the current observations are re-keyed and future frames remapped
        temp: Dict[int, int] = {}
        for cid, lid in self.match_result.items():
            if lid not in obs1 or cid not in st.lms:
                continue
            if lid not in self.final_inliers:
                continue
            if cid == lid:
                # self-match: the track survived since the recognized
                # keyframe, so old and current landmark are one object;
                # appending its obs_vec onto itself never ends
                # (slam.py:864-872)
                continue
            lm_old = st.lms[lid]
            lm_cur = st.lms[cid]
            for (obs_kfid, o) in list(lm_cur.obs_vec):
                lm_old.obs_vec.append((obs_kfid, o))
                kf = st.kfs[obs_kfid]
                if cid in kf.member_lms:
                    kf.member_lms.discard(cid)
                    kf.member_lms.add(lid)
            del st.lms[cid]
            temp[lid] = cid

        for lid in list(self.final_inliers):
            cid = temp.get(lid)
            if cid is None:
                continue
            if cid in self.curr_obs:
                self.curr_obs[lid] = self.curr_obs.pop(cid)
            st.match_lookup[cid] = lid
        return True

    def consistency_broken(self) -> bool:
        """slam.cpp:1215-1232: any edge whose current relative pose deviates
        from its constraint beyond the consistency thresholds."""
        st = self.state
        for (n1, n2) in st.edge_set:
            T = st.kfs[n2].T.rel_to(st.kfs[n1].T)
            d = T.rel_to(st.edges[(n1, n2)].C)
            if (rotation_angle(d.R) > self.cfg.pgo_consistency_rot_thr
                    or np.linalg.norm(d.t) > self.cfg.pgo_consistency_tr_thr):
                return True
        return False

    def pose_optimization(self):
        """slam.cpp:1236-1313: whole-graph pose optimization
        (``ops/pose_graph.pose_graph_opt``, K1 block sums)."""
        st = self.state
        self.stop_watch.tick("pose_graph")
        self._embed(st.last_kf_id())

        edge_list = sorted(st.edge_set)
        E = len(edge_list)
        V = len(st.kfs)
        if E == 0:
            self.stop_watch.tock("pose_graph")
            return
        ei = np.array([e[0] for e in edge_list], np.int32)
        ej = np.array([e[1] for e in edge_list], np.int32)
        ctr = np.stack([st.edges[e].C.wt() for e in edge_list])
        poses = np.stack([st.kfs[i].T.wt() for i in range(V)])
        pose_free = np.ones(V, bool)
        pose_free[ei[0]] = False  # gauge (po_problem.cpp:62-63)

        dev = self.device
        if self.group is not None:
            # edge-sharded over the ranks, the edges padded to a multiple
            # of the world size (slam.py:929-938)
            from ..parallel import dist_pose_graph_opt
            pad = -E % self.cfg.mesh_devices
            ei_p, ej_p = np.pad(ei, (0, pad)), np.pad(ej, (0, pad))
            ctr_p = np.pad(ctr, ((0, pad), (0, 0)))
            ev = np.arange(E + pad) < E
            out, _ = dist_pose_graph_opt(
                self.group, self._tensor(poses),
                torch.as_tensor(ei_p, device=dev),
                torch.as_tensor(ej_p, device=dev), self._tensor(ctr_p),
                torch.as_tensor(ev, device=dev),
                torch.as_tensor(pose_free, device=dev),
                max_iters=self.cfg.pgo_num_iter)
        else:
            out, _ = pose_graph_opt(
                self._tensor(poses), torch.as_tensor(ei, device=dev),
                torch.as_tensor(ej, device=dev), self._tensor(ctr),
                torch.ones(E, dtype=torch.bool, device=dev),
                torch.as_tensor(pose_free, device=dev),
                max_iters=self.cfg.pgo_num_iter)
        out = out.cpu().numpy().astype(np.float64)
        self.pgo_runs += 1

        for i in range(V):
            st.kfs[i].T = Pose.from_wt(out[i])
        for (n1, n2) in st.edge_set:
            st.edges[(n1, n2)].T = st.kfs[n2].T.rel_to(st.kfs[n1].T)
            st.edges[(n2, n1)].T = st.kfs[n1].T.rel_to(st.kfs[n2].T)
        self.stop_watch.tock("pose_graph")

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def trajectory(self) -> List[Pose]:
        """Camera-to-world poses rooted at keyframe 0 (slam.cpp:1473-1481)."""
        st = self.state
        if not st.kfs:
            return []
        self._embed(0)
        return [st.kfs[i].T.inv() for i in sorted(st.kfs)]

    def save_trajectory(self, path: str):
        """Reference text format: i t_z -t_x -t_y w0 w1 w2
        (slam.cpp:1489-1494)."""
        from ..evalio.writers import write_trajectory
        write_trajectory(path, self.trajectory())

    def save_landmarks(self, path: str):
        """Reference text format (slam.cpp:1431-1471)."""
        from ..evalio.writers import write_landmarks
        write_landmarks(path, self._landmark_world_segments(min_len=0.0))

    def _landmark_world_segments(self, min_len=1.0, require_twice=True):
        """World endpoint segments of mapped lines (slam.cpp:1508-1532)."""
        st = self.state
        segs = []
        for lm in st.lms.values():
            if require_twice and not lm.twice_observed:
                continue
            if abs(lm.tt[0] - lm.tt[1]) < min_len:
                continue
            p = lm.line[:3]
            v = lm.line[3:]
            n = np.cross(p, v)
            p0 = np.cross(v, n) / (v @ v)
            vn = v / np.linalg.norm(v)
            Ti = st.kfs[lm.init_kfid].T.inv()
            p1 = Ti.R @ (p0 + vn * lm.tt[0]) + Ti.t
            p2 = Ti.R @ (p0 + vn * lm.tt[1]) + Ti.t
            segs.append(np.concatenate([p1, p2]))
        return segs

    def post_processing(self) -> Dict[str, object]:
        """Summary statistics (slam.cpp:1565-1632, main.cpp:84-89): the JAX
        engine's keys, plus the embedding walker that ran and the number
        of pose-graph solves; on the mesh path also the world size and the
        process group's backend."""
        sw = self.stop_watch
        n = max(self.num_frames_processed, 1)
        mesh = {}
        if self.group is not None:
            mesh = {"mesh_devices": self.cfg.mesh_devices,
                    "dist_backend": self.dist_backend}
        return {
            "proc_pose_estimation_mean_s": sw.stats("pose_estimation").mean,
            "proc_local_ba_mean_s": sw.stats("local_ba").mean,
            "proc_pose_graph_mean_s": sw.stats("pose_graph").mean,
            "proc_ba_pack_mean_s": sw.stats("ba_pack").mean,
            "proc_embedding_mean_s": sw.stats("embedding").mean,
            "proc_endpoints_mean_s": sw.stats("endpoints").mean,
            "total_time_s": sw.elapsed(),
            "num_keyframes": len(self.state.kfs),
            "num_landmarks": len(self.state.lms),
            "num_edges": len(self.state.edges) // 2,
            "num_loop_closures": self.lc_cnt,
            "avg_num_iterations": self.sum_num_iteration / n,
            "avg_initial_cost": self.sum_init_cost / n,
            "avg_final_cost": self.sum_final_cost / n,
            "embedding_walker": self.embedding_walker,
            "num_pose_graph_runs": self.pgo_runs,
            **mesh,
        }
