"""Batch replay engine in PyTorch: the whole SLAM loop, frame by frame.

Port of ``slslam_tpu/engine/batch.py``.  The JAX engine uploads a sequence
once and runs every frame inside one ``lax.scan``; this port keeps the same
state layout (the carry), the same per-frame step and the same outputs, and
runs the step from a Python loop: ``lax.switch`` / ``lax.cond`` become
Python branches on flags read from the device, the LM loops read their
condition once per iteration.  See the JAX module's docstring for the
semantics (landmark slot pool, keyframe ring of the last 2W keyframes, the
edge chain) and the reference lines they follow.

Randomness: each replay draws RANSAC's Gumbel noise and the BA init
jitter (``cfg.ba_init_jitter``) from a ``torch.Generator`` seeded with
``cfg.rseed``; a ``gumbel_hook`` / ``jitter_hook`` can inject the per-frame
noise instead, which is how the tests feed the JAX engine's streams.
``carry_from_numpy`` / ``carry_to_numpy`` move a carry between the two
engines (this system has no weights; the carry is its state).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import geometry as geo
from .. import resolve_device, resolve_dtype
from ..ops.schur_ba import lines_gn, local_ba
from ..ops.triangulate import triangulate_lines
from ..config import SlamConfig, bucket_for
from ..evalio.writers import write_trajectory
from ..hostgeom import Pose
from ..ops.vo_pipeline import vo_body


# ---------------------------------------------------------------------------
# Host pre-pass (copied from slslam_tpu/engine/batch.py:69-152, which lives
# in a module that imports jax; tests/test_torch_batch_engine.py checks that
# the copies give the same output as the originals)
# ---------------------------------------------------------------------------

class FramePack(NamedTuple):
    """Per-frame observation tensors + retirement schedule (host arrays)."""

    obs: np.ndarray          # (F, Om, 8) normalized stereo endpoints
    slot: np.ndarray         # (F, Om) landmark slot per observation
    valid: np.ndarray        # (F, Om)
    retire_slot: np.ndarray  # (F, Rm) slots to retire *before* frame f
    retire_valid: np.ndarray  # (F, Rm)
    frame_idx: np.ndarray    # (F,) original frame ids (for RNG keys)
    fid_of_slot_events: list  # [(frame, slot, feature_id)] assignment log
    num_slots: int           # live-slot capacity actually needed


def pack_frames(frames: List[Dict[int, np.ndarray]],
                lifetime: Optional[int] = None,
                window: int = 10,
                max_obs: Optional[int] = None,
                frame_ids: Optional[List[int]] = None) -> FramePack:
    """Assign feature ids to recyclable device slots (engine/batch.py:82-152).

    A feature is live from its first observation until ``lifetime`` frames
    after its last (default 6*window); slots are reused across disjoint live
    ranges and a landmark's final state is emitted when its slot retires.
    """
    F = len(frames)
    if lifetime is None:
        lifetime = 6 * window
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for f, fr in enumerate(frames):
        for fid in fr:
            first.setdefault(fid, f)
            last[fid] = f

    free: List[int] = []
    free_at: Dict[int, List[int]] = {}
    slot_of: Dict[int, int] = {}
    retire_events: Dict[int, List[int]] = {}
    num_slots = 0
    events = sorted(first.items(), key=lambda kv: kv[1])
    for fid, f0 in events:
        exp = last[fid] + lifetime
        for ff in [k for k in list(free_at) if k <= f0]:
            free.extend(free_at.pop(ff))
        if free:
            s = free.pop()
        else:
            s = num_slots
            num_slots += 1
        slot_of[fid] = s
        if exp + 1 < F:
            free_at.setdefault(exp + 1, []).append(s)
            retire_events.setdefault(exp + 1, []).append(s)

    Om = max_obs or max((len(fr) for fr in frames), default=1)
    Om = max(Om, 1)
    Rm = max((len(v) for v in retire_events.values()), default=1)
    obs = np.zeros((F, Om, 8))
    slot = np.zeros((F, Om), np.int32)
    valid = np.zeros((F, Om), bool)
    for f, fr in enumerate(frames):
        for k, fid in enumerate(sorted(fr)):
            if k >= Om:
                raise ValueError(
                    f"frame {f} has {len(fr)} observations > max_obs={Om}")
            obs[f, k] = np.asarray(fr[fid], np.float64)
            slot[f, k] = slot_of[fid]
            valid[f, k] = True
    retire_slot = np.zeros((F, Rm), np.int32)
    retire_valid = np.zeros((F, Rm), bool)
    for f, slots in retire_events.items():
        for k, s in enumerate(slots):
            retire_slot[f, k] = s
            retire_valid[f, k] = True
    fidx = np.asarray(frame_ids if frame_ids is not None else range(F),
                      np.int32)
    log = sorted((f0, slot_of[fid], fid) for fid, f0 in first.items())
    return FramePack(obs, slot, valid, retire_slot, retire_valid, fidx,
                     log, num_slots)


def normalize_frames(frames: List[Dict[int, np.ndarray]],
                     cam) -> List[Dict[int, np.ndarray]]:
    """Pixel endpoints -> normalized camera coords (slam.cpp:121-128;
    copied from slslam_tpu/engine/batch.py:610-622)."""
    conv = []
    for fr in frames:
        d = {}
        for fid, o in fr.items():
            o = np.asarray(o, np.float64).copy()
            o[0::2] = o[0::2] / cam.fx - cam.cx / cam.fx
            o[1::2] = o[1::2] / cam.fy - cam.cy / cam.fy
            d[fid] = o
        conv.append(d)
    return conv


# ---------------------------------------------------------------------------
# Step state
# ---------------------------------------------------------------------------

class BatchCarry(NamedTuple):
    kf_count: torch.Tensor    # () int32 accepted keyframes so far
    fail_streak: torch.Tensor  # () int32 consecutive VO failures
    lm_line: torch.Tensor     # (Lp, 6) lines in current embedding frame
    lm_active: torch.Tensor   # (Lp,) bool
    lm_twice: torch.Tensor    # (Lp,) bool twice_observed
    lm_tt: torch.Tensor       # (Lp, 2) endpoint interval
    lm_pvn: torch.Tensor      # (Lp, 3) previous direction (reset detector)
    win_obs: torch.Tensor     # (Wn, Om, 8) ring of window keyframe obs
    win_slot: torch.Tensor    # (Wn, Om) int32
    win_valid: torch.Tensor   # (Wn, Om) bool
    win_member: torch.Tensor  # (Wn, Lp) bool member_lms flags
    win_pose: torch.Tensor    # (Wn, 6) pose embedding-frame -> kf camera
    win_g: torch.Tensor       # (Wn,) int32 global kf index, -1 = empty
    edges: torch.Tensor       # (Fmax + 2, 6) edge g -> g+1 as (w, t)
    sum_iters: torch.Tensor   # () int32
    sum_init_cost: torch.Tensor
    sum_final_cost: torch.Tensor
    n_processed: torch.Tensor  # () int32 frames through the full pipeline


class BatchStepOut(NamedTuple):
    is_kf: torch.Tensor
    wt: torch.Tensor          # (6,) accepted VO motion (zeros otherwise)
    n_common: torch.Tensor
    ransac_score: torch.Tensor
    n_final_inliers: torch.Tensor
    ba_iters: torch.Tensor
    ba_init_cost: torch.Tensor
    ba_final_cost: torch.Tensor
    ret_line: torch.Tensor    # (Rm, 6) retired landmark lines (frame of
    ret_tt: torch.Tensor      # (Rm, 2)   the then-newest keyframe ret_kf)
    ret_twice: torch.Tensor   # (Rm,)
    ret_kf: torch.Tensor      # (Rm,) int32
    ret_valid: torch.Tensor   # (Rm,)


def carry_to_numpy(carry: BatchCarry) -> BatchCarry:
    """The carry as numpy arrays (the JAX engine's layout and dtypes)."""
    return BatchCarry(*(x.detach().cpu().numpy() for x in carry))


def carry_from_numpy(carry, device, dtype) -> BatchCarry:
    """A carry of numpy arrays (e.g. the JAX engine's, via np.asarray) ->
    this engine's tensors: floats in ``dtype``, integers int32."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    out = []
    for x in carry:
        a = np.array(x)
        if a.dtype == np.bool_:
            t = torch.as_tensor(a, device=dev)
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.as_tensor(a.astype(np.int32), device=dev)
        else:
            t = torch.as_tensor(a, dtype=dt, device=dev)
        out.append(t.clone())
    return BatchCarry(*out)


def _closest_point(line):
    """Closest point to the origin on the (cp, v) line; safe on zero rows."""
    p, v = line[..., :3], line[..., 3:]
    n = geo.cross(p, v)
    vv = torch.sum(v * v, dim=-1, keepdim=True)
    return geo.cross(v, n) / torch.clamp_min(vv, 1e-30)


def _unit(v):
    return v / torch.clamp_min(geo.norm(v, keepdim=True), 1e-30)


def _transport(line, tt, pvn, active, R, t):
    """Lines, endpoint intervals and direction memory into the frame
    X' = R X + t (engine/batch.py:205-227)."""
    vv = torch.sum(line[..., 3:] ** 2, dim=-1, keepdim=True)
    vh = line[..., 3:] / torch.sqrt(torch.clamp_min(vv, 1e-30))
    p0 = _closest_point(line)
    P1 = p0 + tt[..., 0:1] * vh
    P2 = p0 + tt[..., 1:2] * vh
    line2 = geo.line_to_pose(line, R, t)
    p0n = _closest_point(line2)
    vhn = geo.matvec(R, vh)
    t1 = torch.sum(vhn * (geo.matvec(R, P1) + t - p0n), dim=-1)
    t2 = torch.sum(vhn * (geo.matvec(R, P2) + t - p0n), dim=-1)
    uninit = torch.logical_and(tt[..., 0] == 0.0, tt[..., 1] == 0.0)
    tt2 = torch.where(uninit[..., None], torch.zeros_like(tt),
                      torch.stack([t1, t2], dim=-1))
    pvn2 = geo.matvec(R, pvn)
    am = active[..., None]
    return (torch.where(am, line2, line), torch.where(am, tt2, tt),
            torch.where(am, pvn2, pvn))


def _extend_endpoints(line, tt, pvn, update, obs, cfg_thr, cfg_ext):
    """SLAM::extend_end_points (slam.cpp:979-1084) in the current
    embedding frame (engine/batch.py:230-289)."""
    v = line[..., 3:]
    vv = torch.sum(v * v, dim=-1)
    cvn = v / torch.sqrt(torch.clamp_min(vv, 1e-30))[..., None]
    dot = torch.clamp(torch.sum(cvn * pvn, dim=-1), -1.0, 1.0)
    reset = torch.arccos(dot) > cfg_thr
    pvn1 = torch.where(reset[..., None], cvn, pvn)
    tt1 = torch.where(reset[..., None], torch.zeros_like(tt), tt)

    one = torch.ones(obs.shape[:-1] + (1,), dtype=obs.dtype,
                     device=obs.device)
    zero = torch.zeros_like(one)
    p11 = torch.cat([obs[..., 0:2], one], dim=-1)
    p21 = torch.cat([obs[..., 2:4], one], dim=-1)
    ln = geo.cross(p11, p21)[..., :2]
    n_ln = geo.norm(ln)
    ok = n_ln > 0
    ln = ln / torch.clamp_min(n_ln, 1e-30)[..., None]
    p12 = p11 + torch.cat([ln, zero], dim=-1)
    p22 = p21 + torch.cat([ln, zero], dim=-1)

    pc = line[..., :3]
    nc = geo.cross(pc, v)
    n1 = geo.cross(p11, p12)
    n2 = geo.cross(p21, p22)
    e1_xyz = geo.cross(nc, n1)
    e1_w = -torch.sum(v * n1, dim=-1)
    e2_xyz = geo.cross(nc, n2)
    e2_w = -torch.sum(v * n2, dim=-1)

    p0 = _closest_point(line)
    p0_dist = geo.norm(p0)
    ok = ok & (p0_dist <= cfg_ext)
    ok = ok & (torch.abs(e1_w) >= 1e-12)
    ok = ok & (torch.abs(e2_w) >= 1e-12)
    pc1 = e1_xyz / torch.where(e1_w == 0, torch.ones_like(e1_w),
                               e1_w)[..., None]
    pc2 = e2_xyz / torch.where(e2_w == 0, torch.ones_like(e2_w),
                               e2_w)[..., None]
    ok = ok & (pc1[..., 2] >= 0) & (pc2[..., 2] >= 0)

    t1 = torch.sum(cvn * (pc1 - p0), dim=-1)
    t2 = torch.sum(cvn * (pc2 - p0), dim=-1)
    extend = torch.sqrt(torch.clamp_min(cfg_ext ** 2 - p0_dist ** 2, 0.0))
    tt_lo = torch.clamp(torch.minimum(t1, t2), -extend, extend)
    tt_hi = torch.clamp(torch.maximum(t1, t2), -extend, extend)
    ok = ok & (tt_lo != tt_hi)

    uninit = torch.logical_and(tt1[..., 0] == 0.0, tt1[..., 1] == 0.0)
    lo = torch.where(uninit, tt_lo, torch.minimum(tt1[..., 0], tt_lo))
    hi = torch.where(uninit, tt_hi, torch.maximum(tt1[..., 1], tt_hi))
    tt2 = torch.where(ok[..., None], torch.stack([lo, hi], dim=-1), tt1)
    um = update[..., None]
    return torch.where(um, tt2, tt), torch.where(um, pvn1, pvn)


NoiseFn = Callable[[int], Optional[torch.Tensor]]


def window_anchor(cfg: SlamConfig):
    """(sigma_rot, sigma_t) of the window BA's camera anchors, or None when
    either is 0 (engine/batch.py:521-527, engine/slam.py:614-618)."""
    if cfg.window_anchor_sigma_rot > 0 and cfg.window_anchor_sigma_t > 0:
        return (cfg.window_anchor_sigma_rot, cfg.window_anchor_sigma_t)
    return None


class FrameStep:
    """The per-frame step (engine/batch.py:292-603) for one set of shapes.

    ``step(carry, xs, has_obs, gumbel=None, generator=None)`` takes the
    frame's tensors ``xs = (obs (Om,8), slot (Om,), valid (Om,),
    retire_slot (Rm,), retire_valid (Rm,))`` and returns (carry, out).
    ``has_obs`` is the host's copy of ``valid.any()``.  ``jitter(shape)``
    gives the standard-normal noise of ``cfg.ba_init_jitter`` (default:
    drawn from ``generator``).
    """

    def __init__(self, cfg: SlamConfig, Wn, Lp, Om, Rm, Fmax, dtype,
                 device):
        self.cfg = cfg
        self.Wn, self.Lp, self.Om, self.Rm, self.Fmax = Wn, Lp, Om, Rm, Fmax
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)

    def carry0(self) -> BatchCarry:
        Wn, Lp, Om, Fmax = self.Wn, self.Lp, self.Om, self.Fmax
        kw = dict(dtype=self.dtype, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        b = dict(dtype=torch.bool, device=self.device)
        return BatchCarry(
            kf_count=torch.zeros((), **i32),
            fail_streak=torch.zeros((), **i32),
            lm_line=torch.zeros((Lp, 6), **kw),
            lm_active=torch.zeros((Lp,), **b),
            lm_twice=torch.zeros((Lp,), **b),
            lm_tt=torch.zeros((Lp, 2), **kw),
            lm_pvn=torch.zeros((Lp, 3), **kw),
            win_obs=torch.zeros((Wn, Om, 8), **kw),
            win_slot=torch.zeros((Wn, Om), **i32),
            win_valid=torch.zeros((Wn, Om), **b),
            win_member=torch.zeros((Wn, Lp), **b),
            win_pose=torch.zeros((Wn, 6), **kw),
            win_g=torch.full((Wn,), -1, **i32),
            edges=torch.zeros((Fmax + 2, 6), **kw),
            sum_iters=torch.zeros((), **i32),
            sum_init_cost=torch.zeros((), **kw),
            sum_final_cost=torch.zeros((), **kw),
            n_processed=torch.zeros((), **i32))

    def _scatter_map(self, sel, rows, has):
        """Dense slot-aligned (Lp, 8) map + presence flags; every invalid
        row lands on the dump row Lcap, which is then cleared."""
        Lp, dev = self.Lp, self.device
        m = torch.zeros((Lp, 8), dtype=self.dtype, device=dev)
        m[sel] = rows
        h = torch.zeros((Lp,), dtype=torch.bool, device=dev)
        h[sel] = has
        h[Lp - 1] = False
        return m, h

    def step(self, carry: BatchCarry, xs, has_obs: bool,
             gumbel: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             jitter: Optional[Callable[[tuple], torch.Tensor]] = None):
        dev = self.device
        obs_f, slot_f, val_f, ret_s, ret_v = xs
        Lcap = self.Lp - 1
        i32 = torch.int32

        # ---- retirement: emit final state, clear slots, purge the ring ----
        ret_idx = torch.where(ret_v, ret_s.long(), Lcap)
        ret_line = carry.lm_line[ret_idx]
        ret_tt = carry.lm_tt[ret_idx]
        ret_twice = carry.lm_twice[ret_idx]
        ret_valid = torch.logical_and(ret_v, carry.lm_active[ret_idx])
        ret_kf = torch.ones((self.Rm,), dtype=i32,
                            device=dev) * (carry.kf_count - 1)
        lm_active = carry.lm_active.clone()
        lm_active[ret_idx] = False
        lm_active[Lcap] = False
        lm_twice = carry.lm_twice.clone()
        lm_twice[ret_idx] = False
        lm_tt = carry.lm_tt.clone()
        lm_tt[ret_idx] = 0.0
        hit = torch.any(torch.logical_and(
            carry.win_slot[..., None] == ret_s[None, None, :].to(i32),
            ret_v[None, None, :]), dim=-1)
        win_valid = torch.logical_and(carry.win_valid, ~hit)
        win_member = carry.win_member.clone()
        win_member[:, ret_idx] = False
        carry = carry._replace(lm_active=lm_active, lm_twice=lm_twice,
                               lm_tt=lm_tt, win_valid=win_valid,
                               win_member=win_member)

        slot_sel = torch.where(val_f, slot_f.long(), Lcap)
        curr_map, curr_has = self._scatter_map(slot_sel, obs_f, val_f)

        zi = torch.zeros((), dtype=i32, device=dev)
        zf = torch.zeros((), dtype=self.dtype, device=dev)
        zeros_out = BatchStepOut(
            torch.zeros((), dtype=torch.bool, device=dev),
            torch.zeros(6, dtype=self.dtype, device=dev), zi, zi, zi, zi,
            zf, zf, ret_line, ret_tt, ret_twice, ret_kf, ret_valid)

        if not has_obs:
            return carry, zeros_out
        kf = int(carry.kf_count)
        if kf == 0:
            return self._first(carry, obs_f, slot_f, val_f, curr_map,
                               curr_has, zeros_out)
        return self._normal(carry, obs_f, slot_f, val_f, curr_map, curr_has,
                            zeros_out, kf, gumbel, generator, jitter)

    def _triangulate(self, curr_map):
        tri = triangulate_lines(curr_map, self.cfg.camera.baseline,
                                inverse_depth=self.cfg.inverse_depth)
        return tri, _unit(tri[..., 3:])

    def _first(self, c, obs_f, slot_f, val_f, curr_map, curr_has, zeros_out):
        # slam.cpp check_input_data()==2: first keyframe, no edge, no
        # members; triangulate everything
        tri, tri_dir = self._triangulate(curr_map)
        nm = curr_has[..., None]
        win_obs, win_slot = c.win_obs.clone(), c.win_slot.clone()
        win_valid, win_pose = c.win_valid.clone(), c.win_pose.clone()
        win_g = c.win_g.clone()
        win_obs[0] = obs_f
        win_slot[0] = slot_f.to(torch.int32)
        win_valid[0] = val_f
        win_pose[0] = 0.0
        win_g[0] = 0
        c = c._replace(
            kf_count=torch.ones((), dtype=torch.int32, device=self.device),
            lm_line=torch.where(nm, tri, c.lm_line),
            lm_active=torch.logical_or(c.lm_active, curr_has),
            lm_pvn=torch.where(nm, tri_dir, c.lm_pvn),
            win_obs=win_obs, win_slot=win_slot, win_valid=win_valid,
            win_pose=win_pose, win_g=win_g)
        return c, zeros_out._replace(
            is_kf=torch.ones((), dtype=torch.bool, device=self.device))

    def _normal(self, c, obs_f, slot_f, val_f, curr_map, curr_has,
                zeros_out, kf, gumbel, generator, jitter):
        cfg, Wn, Lcap = self.cfg, self.Wn, self.Lp - 1
        min_s = cfg.ransac_min_sample
        i32 = torch.int32
        prev_pos = (kf - 1) % Wn
        pv = c.win_valid[prev_pos]
        psel = torch.where(pv, c.win_slot[prev_pos].long(), Lcap)
        prev_map, prev_has = self._scatter_map(psel, c.win_obs[prev_pos], pv)

        common = curr_has & prev_has & c.lm_active
        n_common = torch.sum(common.to(i32)).to(i32)
        res = vo_body(prev_map, curr_map, c.lm_line, common,
                      cfg.camera.baseline, cfg.error_thr, cfg.huber_delta,
                      max_t_norm=cfg.ransac_max_t_norm,
                      num_hyp=cfg.ransac_num_hypotheses, sample_size=min_s,
                      robust=cfg.robust, max_iters=cfg.moba_max_iter,
                      line_param=cfg.line_param,
                      relin_iters=cfg.vo_relin_iters, gumbel=gumbel,
                      generator=generator)
        finite = torch.all(torch.isfinite(res.wt))
        ok = (n_common >= min_s) & (res.ransac_score >= min_s) & finite
        is_kf = ok & ((geo.norm(res.wt[:3]) >= cfg.kf_rot_thr)
                      | (geo.norm(res.wt[3:]) >= cfg.kf_tr_thr))
        failed = (n_common >= min_s) & ~ok
        if cfg.vo_fail_recovery > 0:
            recover = failed & (c.fail_streak + 1 >= cfg.vo_fail_recovery)
            recover = recover & finite
            recover = recover & (geo.norm(res.wt[3:])
                                 <= 2.0 * cfg.ransac_max_t_norm)
            is_kf = is_kf | recover

        final_inl = common & (res.final_errors < cfg.error_thr)
        out_base = zeros_out._replace(
            n_common=n_common, ransac_score=res.ransac_score.to(i32),
            n_final_inliers=torch.sum(final_inl.to(i32)).to(i32))

        if not bool(is_kf):
            # gated-but-tracking frames reset the streak; genuine RANSAC
            # failures accumulate it
            streak = torch.where(failed, c.fail_streak + 1,
                                 torch.zeros_like(c.fail_streak))
            return c._replace(fail_streak=streak), out_base
        if jitter is None:
            def jitter(shape):
                return torch.randn(shape, generator=generator,
                                   dtype=self.dtype, device=self.device)
        return self._accept(c, res.wt, obs_f, slot_f, val_f, curr_map,
                            curr_has, final_inl, out_base, kf, prev_pos,
                            jitter)

    def _accept(self, c, wt, obs_f, slot_f, val_f, curr_map, curr_has,
                final_inl, out_base, kf, prev_pos, jitter):
        cfg, dev, Wn, Lcap = self.cfg, self.device, self.Wn, self.Lp - 1
        W = cfg.ba_window_size
        baseline, huber = cfg.camera.baseline, cfg.huber_delta
        i32 = torch.int32
        Rn, tn_ = geo.wt_to_Rt(wt)
        g_new = kf
        new_pos = g_new % Wn

        # re-embed at the new keyframe: poses compose with the inverse
        # motion, lines and endpoint intervals transport by the motion
        win_pose = geo.wt_compose(c.win_pose, geo.wt_inv(wt))
        lm_line, lm_tt, lm_pvn = _transport(c.lm_line, c.lm_tt, c.lm_pvn,
                                            c.lm_active, Rn, tn_)

        # the new keyframe enters the ring; members = final VO inliers on
        # the new and the previous keyframe (slam.cpp:151-157, 730-761)
        win_obs, win_slot = c.win_obs.clone(), c.win_slot.clone()
        win_valid, win_member = c.win_valid.clone(), c.win_member.clone()
        win_g = c.win_g.clone()
        win_obs[new_pos] = obs_f
        win_slot[new_pos] = slot_f.to(i32)
        win_valid[new_pos] = val_f
        win_member[new_pos] = final_inl
        win_member[prev_pos] = win_member[prev_pos] | final_inl
        win_pose[new_pos] = 0.0
        win_g[new_pos] = g_new

        edges = c.edges.clone()
        edges[g_new - 1] = wt        # odometry edge prev -> new

        # triangulate first-seen features (slam.cpp:161-219)
        new_mask = curr_has & ~c.lm_active
        tri, tri_dir = self._triangulate(curr_map)
        nm = new_mask[..., None]
        lm_line = torch.where(nm, tri, lm_line)
        lm_tt = torch.where(nm, torch.zeros_like(lm_tt), lm_tt)
        lm_pvn = torch.where(nm, tri_dir, lm_pvn)
        lm_active = c.lm_active | new_mask

        # ---- windowed BA (slam.cpp:795-975) ----
        kc_new = g_new + 1
        age = (kc_new - 1) - win_g
        cam_valid = win_g >= 0
        cam_free = cam_valid & (age < W)
        member_cnt = torch.sum((win_member & cam_free[:, None]).to(i32),
                               dim=0)
        qualify = (member_cnt >= 2) & lm_active
        qualify[Lcap] = False

        benign = torch.zeros((self.Lp, 6), dtype=self.dtype, device=dev)
        benign[:, 2] = 1.0
        benign[:, 3] = 1.0
        line_p4 = geo.LINE_ENCODERS[cfg.line_param](
            torch.where(lm_active[..., None], lm_line, benign))
        if cfg.ba_init_jitter:
            # deterministic annealing jitter on the qualifying lines only
            # (engine/batch.py:488-496; SlamConfig.ba_init_jitter)
            noise = jitter(tuple(line_p4.shape)).to(dtype=self.dtype,
                                                    device=dev)
            line_p4 = line_p4 + (cfg.ba_init_jitter * noise
                                 * qualify[:, None].to(self.dtype))

        ob = win_obs.reshape(Wn * self.Om, 8)
        ocam = torch.arange(Wn, dtype=i32,
                            device=dev).repeat_interleave(self.Om)
        olin = torch.where(win_valid, win_slot,
                           torch.full_like(win_slot, Lcap)).reshape(-1)
        ovalid = (win_valid.reshape(-1) & qualify[olin.long()]
                  & cam_valid[ocam.long()])
        if cfg.lines_gn_iters > 0:
            line_p4 = lines_gn(win_pose, line_p4, ob, ocam, olin, ovalid,
                               qualify, baseline, huber, robust=cfg.robust,
                               iters=cfg.lines_gn_iters,
                               line_param=cfg.line_param)
        cam_out, line_out, stats = local_ba(
            win_pose, line_p4, ob, ocam, olin, ovalid, cam_free, qualify,
            baseline, huber, robust=cfg.robust, max_iters=cfg.max_num_iter,
            line_param=cfg.line_param, cam_anchor_sigmas=window_anchor(cfg))

        win_pose = torch.where(cam_valid[:, None], cam_out, win_pose)
        lm_line = torch.where(qualify[..., None],
                              geo.LINE_DECODERS[cfg.line_param](line_out),
                              lm_line)
        lm_twice = c.lm_twice | qualify

        # re-anchor the embedding at the newest keyframe
        anchor = win_pose[new_pos]
        Ra, ta = geo.wt_to_Rt(anchor)
        win_pose = geo.wt_compose(win_pose, geo.wt_inv(anchor))
        win_pose[new_pos] = 0.0
        lm_line, lm_tt, lm_pvn = _transport(lm_line, lm_tt, lm_pvn,
                                            lm_active, Ra, ta)

        # refresh intra-free-window consecutive edges with the BA relative
        # poses (slam.cpp:1398-1416).  Rows that are not refreshed write the
        # dump row Fmax + 1, as the JAX engine's scatter does.
        Rw, tw = geo.wt_to_Rt(win_pose)
        src_ok = cam_free & (age >= 1)
        p2 = ((win_g + 1) % Wn).long()
        Rr, tr = geo.t_rel(Rw[p2], tw[p2], Rw, tw)
        wt_rel = geo.Rt_to_wt(Rr, tr)
        eidx = torch.where(src_ok, win_g.long(), self.Fmax + 1)
        edges.index_put_((eidx,), wt_rel)

        # endpoint interval maintenance (slam.cpp:979-1084)
        upd = qualify & curr_has
        lm_tt, lm_pvn = _extend_endpoints(
            lm_line, lm_tt, lm_pvn, upd, curr_map, cfg.line_vn_angle_thr,
            cfg.extension_length)

        c2 = c._replace(
            fail_streak=torch.zeros_like(c.fail_streak),
            kf_count=torch.full_like(c.kf_count, kc_new), lm_line=lm_line,
            lm_active=lm_active, lm_twice=lm_twice, lm_tt=lm_tt,
            lm_pvn=lm_pvn, win_obs=win_obs, win_slot=win_slot,
            win_valid=win_valid, win_member=win_member, win_pose=win_pose,
            win_g=win_g, edges=edges,
            sum_iters=c.sum_iters + stats.iterations,
            sum_init_cost=c.sum_init_cost + stats.initial_cost,
            sum_final_cost=c.sum_final_cost + stats.final_cost,
            n_processed=c.n_processed + 1)
        out = out_base._replace(
            is_kf=torch.ones((), dtype=torch.bool, device=dev), wt=wt,
            ba_iters=stats.iterations, ba_init_cost=stats.initial_cost,
            ba_final_cost=stats.final_cost)
        return c2, out


# ---------------------------------------------------------------------------
# Public driver
# ---------------------------------------------------------------------------

class RetiredLandmark(NamedTuple):
    line: np.ndarray   # (6,) in the frame of keyframe `kf`
    tt: np.ndarray     # (2,)
    twice_observed: bool
    kf: int            # keyframe whose camera frame `line` lives in


def _closest_point_np(line):
    p, v = line[:3], line[3:]
    return np.cross(v, np.cross(p, v)) / max(float(v @ v), 1e-30)


@dataclasses.dataclass
class BatchResult:
    trajectory: List[Pose]          # camera-to-world, rooted at keyframe 0
    edges_wt: np.ndarray            # (K-1, 6) final edge chain
    is_kf: np.ndarray               # (F,) which frames became keyframes
    kf_count: int
    landmarks: List[RetiredLandmark]  # live + retired, world-consistent
    stats: Dict[str, float]
    per_frame: Dict[str, np.ndarray]

    def world_segments(self, min_len: float = 1.0,
                       require_twice: bool = True) -> List[np.ndarray]:
        """Landmark world endpoint segments (slam.cpp:1508-1532)."""
        segs = []
        for lm in self.landmarks:
            if require_twice and not lm.twice_observed:
                continue
            if abs(lm.tt[1] - lm.tt[0]) < min_len:
                continue
            p0 = _closest_point_np(lm.line)
            vn = lm.line[3:] / np.linalg.norm(lm.line[3:])
            Ti = self.trajectory[lm.kf]
            segs.append(np.concatenate([Ti.R @ (p0 + vn * lm.tt[0]) + Ti.t,
                                        Ti.R @ (p0 + vn * lm.tt[1]) + Ti.t]))
        return segs


def collect_result(carry, ys, Lcap) -> BatchResult:
    """BatchResult from a final carry and the stacked per-frame outputs,
    both as numpy arrays (engine/batch.py:888-942)."""
    K = int(carry.kf_count)
    edges = np.asarray(carry.edges, np.float64)[:max(K - 1, 0)]
    T = Pose()
    traj = [T.inv()]
    for g in range(K - 1):
        T = Pose.from_wt(edges[g]) @ T
        traj.append(T.inv())

    lms: List[RetiredLandmark] = []
    rl = np.asarray(ys.ret_line, np.float64)
    rt = np.asarray(ys.ret_tt, np.float64)
    rtw, rkf, rv = ys.ret_twice, ys.ret_kf, ys.ret_valid
    for f in range(rl.shape[0]):
        for k in range(rl.shape[1]):
            if rv[f, k]:
                lms.append(RetiredLandmark(rl[f, k], rt[f, k],
                                           bool(rtw[f, k]), int(rkf[f, k])))
    lm_line = np.asarray(carry.lm_line, np.float64)
    lm_tt = np.asarray(carry.lm_tt, np.float64)
    for s in range(Lcap):
        if carry.lm_active[s]:
            lms.append(RetiredLandmark(lm_line[s], lm_tt[s],
                                       bool(carry.lm_twice[s]), K - 1))
    n = max(int(carry.n_processed), 1)
    stats = {
        "num_keyframes": K,
        "num_landmarks": len(lms),
        "num_edges": max(K - 1, 0),
        "avg_num_iterations": int(carry.sum_iters) / n,
        "avg_initial_cost": float(carry.sum_init_cost) / n,
        "avg_final_cost": float(carry.sum_final_cost) / n,
    }
    per_frame = {
        "is_kf": np.asarray(ys.is_kf),
        "wt": np.asarray(ys.wt, np.float64),
        "n_common": np.asarray(ys.n_common),
        "ransac_score": np.asarray(ys.ransac_score),
        "n_final_inliers": np.asarray(ys.n_final_inliers),
        "ba_iters": np.asarray(ys.ba_iters),
        "ba_init_cost": np.asarray(ys.ba_init_cost, np.float64),
        "ba_final_cost": np.asarray(ys.ba_final_cost, np.float64),
    }
    return BatchResult(traj, edges, per_frame["is_kf"], K, lms, stats,
                       per_frame)


class BatchSlam:
    """Replay a whole observation sequence on ``device``.

    Usage::

        eng = BatchSlam(cfg, device="cuda")
        result = eng.run(frames)           # frames: [{fid: obs8}, ...]

    ``device`` is required (no CPU fallback); ``dtype`` defaults to
    ``cfg.compute_dtype``.  ``gumbel_hook(frame_id)``,
    if given, returns the (H, Lp) Gumbel noise of a frame's RANSAC instead
    of the engine's generator (seeded with ``cfg.rseed`` at each dispatch);
    ``jitter_hook(frame_id, shape)`` the standard-normal noise of
    ``cfg.ba_init_jitter`` on a keyframe's lines.  JAX draws that noise
    from ``fold_in(fold_in(PRNGKey(rseed), frame), 0x0B0A)``, a stream
    torch cannot reproduce; the tests feed it through the hook.
    """

    def __init__(self, config: Optional[SlamConfig], device, dtype=None,
                 lm_capacity: Optional[int] = None,
                 gumbel_hook: Optional[NoiseFn] = None,
                 jitter_hook: Optional[Callable[[int, tuple],
                                                torch.Tensor]] = None):
        self.cfg = config or SlamConfig()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype or self.cfg.compute_dtype)
        self.lm_capacity = lm_capacity
        self.gumbel_hook = gumbel_hook
        self.jitter_hook = jitter_hook

    def layout(self, frames, frame_ids=None, lifetime=None):
        """Host pre-pass: (pack, FrameStep, Lcap) for a sequence."""
        cfg = self.cfg
        pack = pack_frames(frames, window=cfg.ba_window_size,
                           frame_ids=frame_ids, lifetime=lifetime)
        Wn = 2 * cfg.ba_window_size
        Lcap = self.lm_capacity or bucket_for(pack.num_slots,
                                              cfg.line_buckets)
        if pack.num_slots > Lcap:
            raise ValueError(
                f"sequence needs {pack.num_slots} live landmark slots "
                f"> capacity {Lcap}; raise lm_capacity")
        Om = bucket_for(pack.obs.shape[1], cfg.obs_buckets)
        Rm = pack.retire_slot.shape[1]
        stepper = FrameStep(cfg, Wn, Lcap + 1, Om, Rm, len(frames),
                            self.dtype, self.device)
        return pack, stepper, Lcap

    def frame_inputs(self, pack: FramePack, Om: int):
        """The per-frame tensors of a pack, padded to Om, on the device."""
        def pad_om(a):
            out = np.zeros(a.shape[:1] + (Om,) + a.shape[2:], dtype=a.dtype)
            out[:, :a.shape[1]] = a
            return out
        dev = self.device
        return (torch.as_tensor(pad_om(pack.obs), dtype=self.dtype,
                                device=dev),
                torch.as_tensor(pad_om(pack.slot), device=dev),
                torch.as_tensor(pad_om(pack.valid), device=dev),
                torch.as_tensor(pack.retire_slot, device=dev),
                torch.as_tensor(pack.retire_valid, device=dev))

    def run(self, frames, frame_ids=None, normalized=True,
            lifetime=None) -> BatchResult:
        return self.collect(self.dispatch(frames, frame_ids=frame_ids,
                                          normalized=normalized,
                                          lifetime=lifetime))

    def dispatch(self, frames, frame_ids=None, normalized=True,
                 lifetime=None):
        """Replay every frame; returns the handle that ``collect`` reads.
        (Eager PyTorch: the work is done when this returns, up to the
        asynchronous tail of the last frame's kernels.)"""
        if not normalized:
            frames = normalize_frames(frames, self.cfg.camera)
        pack, stepper, Lcap = self.layout(frames, frame_ids, lifetime)
        xs = self.frame_inputs(pack, stepper.Om)
        has_obs = pack.valid.any(axis=1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.rseed)
        carry = stepper.carry0()
        ys = []
        for f in range(len(frames)):
            fidx = int(pack.frame_idx[f])
            gumbel = (None if self.gumbel_hook is None
                      else self.gumbel_hook(fidx))
            jitter = None
            if self.jitter_hook is not None:
                def jitter(shape, fidx=fidx):
                    return self.jitter_hook(fidx, shape)
            carry, out = stepper.step(carry, tuple(x[f] for x in xs),
                                      bool(has_obs[f]), gumbel=gumbel,
                                      generator=gen, jitter=jitter)
            ys.append(out)
        return carry, ys, Lcap

    def collect(self, handle) -> BatchResult:
        carry, ys, Lcap = handle
        stacked = BatchStepOut(*(torch.stack(list(v)).cpu().numpy()
                                 for v in zip(*ys)))
        return collect_result(carry_to_numpy(carry), stacked, Lcap)

    def save_trajectory(self, result: BatchResult, path: str):
        write_trajectory(path, result.trajectory)
