"""Large-map global bundle adjustment on the port (matrix-free PCG Schur).

The port's counterpart of tools/large_map_bench.py (which measures the JAX
package): the same synthetic survey loop (cameras on a circle 0.78 m
apart, line landmarks anchored along the path, each camera seeing the
lines anchored within +-band_m metres), the same perturbed start and the
same JSON keys, solved by the port's ``ops/schur_cg.py``:
``pack_line_major`` and ``global_ba_cg`` (K2 ``lm`` once per LM
iteration, the PCG in one K3 launch a damped step and its SCHUR_JACOBI
blocks on K4 over the solve's segment plans, which the solve builds
itself: no
``cam_perm``; with ``--prior`` the priors' sums on K1).  ``make_survey_problem``
and ``perturb_lines_metric`` are copies of the JAX tool's (the same arrays
for the same arguments; tests/test_torch_tools.py holds them equal).

Usage:
    python3 tools/torch_large_map_bench.py                # 2048 cameras
    python3 tools/torch_large_map_bench.py --cams 8192 --lines-per-cam 16
    python3 tools/torch_large_map_bench.py --device cpu --cams 256 \\
        --lines-per-cam 4 --max-iters 20 --cg-iters 60 --warm-runs 1
Prints one JSON line.  float32 on the card (TF32 off: ~1 km world
coordinates would lose metres in a 10-bit mantissa) and float64 on the CPU
unless --dtype says otherwise.  ``cost_at_gt`` is the robust cost at the
ground truth (``schur_cg._cost_lm``), the noise floor an exact solve
should reach.  The JAX tool's XLA compile analysis has no counterpart:
``xla_flops_per_solve`` and ``achieved_gflops_s`` are null (``notes``
says why), ``hbm_bytes`` is ``torch.cuda.max_memory_allocated`` over the
upload and every solve (``peak_device_bytes``), and
``achieved_hbm_gb_s`` is the hand-written kernels' bytes of one warm solve
(``kernel_checks``' closed forms, each input read once and each output
written once) over its wall.  Added keys: the device and its
``nvidia-smi`` name and power limit, ``cg_iterations``, the kernels'
launches by shape in one warm solve (``launch_shapes``), and with
``--profile`` the device's busy share over one warm solve, each
kernel's device milliseconds and the device kernels that take the most
time (``top_device``: name, seconds, launches; ``torch.profiler``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np

HALF_W = 327.783 / 406.05   # normalized image half-extent (parameter.h:43-52)
HALF_H = 237.172 / 406.05
BASELINE = 0.12
HUBER_DELTA = 1.0 / 406.05
# the kernels of a solve, by the names their launches carry in a profile
# (the plan's paths and passes and lm's two passes are several kernels)
KERNEL_NAMES = {"segment_plan": ("plan_segments_kernel", "plan_small_kernel",
                                 "plan_hist_kernel", "plan_scan_kernel",
                                 "plan_scatter_kernel", "plan_offsets_kernel"),
                "segment_sum": ("seg_sum_kernel",),
                "fused_eval/lm": ("lm_rows_kernel", "lm_cams_kernel"),
                "schur_matvec/line": ("schur_line_kernel",),
                "schur_matvec/cam": ("schur_cam_kernel",),
                "schur_pcg": ("schur_pcg_kernel",),
                "schur_jacobi": ("schur_jacobi_kernel",)}


# ---------------------------------------------------------------------------
# The problem (copies of tools/large_map_bench.py:43-174)
# ---------------------------------------------------------------------------

def _path_poses(C: int, spacing: float = 0.78):
    """C world->cam poses on a circle, camera z along the tangent; the
    radius scales with C so consecutive cameras stay ``spacing`` apart (the
    reference's real-sequence median keyframe spacing)."""
    radius = C * spacing / (2.0 * np.pi)
    th = np.linspace(0.0, 2.0 * np.pi, C, endpoint=False)
    pos = np.stack([radius * np.cos(th), np.zeros(C), radius * np.sin(th)],
                   axis=1)                                   # (C, 3) world
    z = np.stack([-np.sin(th), np.zeros(C), np.cos(th)], axis=1)  # tangent
    y = np.tile(np.array([0.0, 1.0, 0.0]), (C, 1))
    x = np.cross(y, z)
    R_cw = np.stack([x, y, z], axis=1)                       # rows = cam axes
    t = -np.einsum("cij,cj->ci", R_cw, pos)
    return R_cw, t, pos, z


def make_survey_problem(C=2048, lines_per_anchor=8, band_m=10.0,
                        noise_px=0.3, spacing=0.78, seed=0):
    """The survey-loop BA problem (vectorized numpy): camera c sees the
    lines anchored within +-band_m metres along the path.  Returns a dict
    of the ground-truth cameras (C, 6) and lines (L, 6), the observations
    (O, 8) and their camera and line indices."""
    from slslam_tpu_torch.hostgeom import so3_log
    rng = np.random.default_rng(seed)
    R_cw, t_wc, pos, tangent = _path_poses(C, spacing)
    band = max(1, int(round(band_m / spacing)))
    L = C * lines_per_anchor

    # landmarks: anchored at path point, lateral offset 3-9 m, random dir
    anchor = np.repeat(np.arange(C), lines_per_anchor)        # (L,)
    lateral = np.cross(np.array([0.0, 1.0, 0.0]), tangent)    # outward-ish
    off_r = rng.uniform(3.0, 9.0, L)[:, None]
    off_s = rng.choice([-1.0, 1.0], L)[:, None]
    off_h = rng.uniform(-2.0, 2.0, L)[:, None]
    p_on = (pos[anchor] + off_s * off_r * lateral[anchor]
            + off_h * np.array([0.0, 1.0, 0.0])
            + rng.uniform(-1.0, 1.0, (L, 3)))                 # point on line
    dv = rng.standard_normal((L, 3))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    # closest point to origin of the infinite line through p_on along dv
    cp = p_on - (np.einsum("lj,lj->l", p_on, dv))[:, None] * dv
    lines_w = np.concatenate([cp, dv], axis=1)                # (L, 6)

    # visibility band: camera c sees lines with anchor in [c-band, c+band]
    # (wraparound on the loop)
    offs = np.arange(-band, band + 1)
    cam_of = (np.arange(C)[:, None, None] + offs[None, :, None]) % C  # C,B,1
    line_of = (cam_of * lines_per_anchor
               + np.arange(lines_per_anchor)[None, None, :])   # C,B,A
    obs_cam = np.repeat(np.arange(C), offs.size * lines_per_anchor)
    obs_line = line_of.reshape(-1)

    # project: line -> camera frame
    Rc = R_cw[obs_cam]                                        # (O,3,3)
    tc = t_wc[obs_cam]
    cpc = np.einsum("oij,oj->oi", Rc, lines_w[obs_line, :3]) + tc
    dvc = np.einsum("oij,oj->oi", Rc, lines_w[obs_line, 3:])

    def endpoints(n, s_mid, s_len):
        d2 = np.sqrt(n[:, 0] ** 2 + n[:, 1] ** 2)
        # a relative degeneracy cut: n scales with the line's distance in
        # the camera frame, and rows whose residual normalization amplifies
        # float32 rounding are dropped (the JAX tool's comment, :100-103)
        nrm = np.linalg.norm(n, axis=1)
        ok = d2 > np.maximum(1e-3, 2e-2 * nrm)
        n = n / np.maximum(d2, 1e-12)[:, None]
        p0 = -n[:, 2:3] * n[:, :2]                            # foot point
        dir2 = np.stack([-n[:, 1], n[:, 0]], axis=1)
        a = p0 + (s_mid - 0.5 * s_len)[:, None] * dir2
        b = p0 + (s_mid + 0.5 * s_len)[:, None] * dir2
        inside = ((np.abs(a[:, 0]) < HALF_W) & (np.abs(a[:, 1]) < HALF_H)
                  & (np.abs(b[:, 0]) < HALF_W) & (np.abs(b[:, 1]) < HALF_H))
        return a, b, ok & inside

    O = len(obs_cam)
    s_mid = rng.uniform(-0.15, 0.15, O)
    s_len = rng.uniform(0.1, 0.4, O)
    n_l = np.cross(cpc, dvc)
    aL, bL, okL = endpoints(n_l, s_mid, s_len)
    cpr = cpc - np.array([0.12, 0.0, 0.0])
    n_r = np.cross(cpr, dvc)
    aR, bR, okR = endpoints(n_r, s_mid, s_len)

    # in front of the camera at the visible span (the closest point of the
    # camera-frame line)
    cp_cam = cpc - np.einsum("oj,oj->o", cpc, dvc)[:, None] * dvc
    ok = okL & okR & (cp_cam[:, 2] > 1.0) & (cp_cam[:, 2] < 40.0)

    obs = np.concatenate([aL, bL, aR, bR], axis=1)            # (O, 8)
    obs += rng.standard_normal(obs.shape) * (noise_px / 406.05)

    obs, obs_cam, obs_line = obs[ok], obs_cam[ok], obs_line[ok]

    # keep only lines observed >= 2 times, and re-index compactly
    cnt = np.bincount(obs_line, minlength=L)
    keep = cnt >= 2
    remap = -np.ones(L, np.int64)
    remap[keep] = np.arange(keep.sum())
    sel = keep[obs_line]
    obs, obs_cam = obs[sel], obs_cam[sel]
    obs_line = remap[obs_line[sel]]
    lines_w = lines_w[keep]

    cam_wt = np.concatenate([
        np.stack([so3_log(R) for R in R_cw]), t_wc], axis=1)  # (C, 6)
    return dict(cam_wt=cam_wt, lines_w=lines_w, obs=obs, obs_cam=obs_cam,
                obs_line=obs_line.astype(np.int64))


def perturb_lines_metric(lines_w, sigma_cp_m, sigma_dir_rad, rng):
    """(cp, dv) lines perturbed in metric space, then re-normalized (real
    initial estimates carry metric triangulation noise; the JAX tool's
    docstring, :160-166, says why not the orthonormal parameters)."""
    cp, dv = lines_w[:, :3].copy(), lines_w[:, 3:].copy()
    L = len(cp)
    dv = dv + rng.standard_normal((L, 3)) * sigma_dir_rad
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    cp = cp + rng.standard_normal((L, 3)) * sigma_cp_m
    cp = cp - np.einsum("lj,lj->l", cp, dv)[:, None] * dv  # re-orthogonalize
    return np.concatenate([cp, dv], axis=1)


def build(args):
    """The host side of the run (the JAX tool's main, :213-248): the
    problem, its line-major packing and the perturbed start.  Returns a
    dict of numpy arrays and the two host seconds."""
    from slslam_tpu_torch.hostgeom import Pose, av_to_orth_np
    from slslam_tpu_torch.ops.schur_cg import pack_line_major
    t0 = time.perf_counter()
    prob = make_survey_problem(C=args.cams,
                               lines_per_anchor=args.lines_per_cam,
                               band_m=args.band_m, spacing=args.spacing,
                               noise_px=args.noise_px)
    C, L = len(prob["cam_wt"]), len(prob["lines_w"])
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = pack_line_major(prob["obs"], prob["obs_cam"], prob["obs_line"],
                             C, L)
    pack_s = time.perf_counter() - t0

    rng = np.random.default_rng(7)
    cam0 = prob["cam_wt"].copy()
    cam0[1:, :3] += rng.standard_normal((C - 1, 3)) * args.cam_sigma_rot
    cam0[1:, 3:] += rng.standard_normal((C - 1, 3)) * args.cam_sigma_t
    lines0 = perturb_lines_metric(prob["lines_w"], args.line_sigma_cp_m,
                                  args.line_sigma_dir_rad, rng)
    prior_c = None
    if args.prior:
        chain = [Pose.from_wt(w) for w in cam0]
        prior_c = np.stack([(chain[i + 1] @ chain[i].inv()).wt()
                            for i in range(C - 1)])
    return dict(prob=prob, packed=packed, cam0=cam0,
                orth0=av_to_orth_np(lines0),
                orth_gt=av_to_orth_np(prob["lines_w"]), prior_c=prior_c,
                gen_s=gen_s, pack_s=pack_s)


def rpe(cam, cam_gt):
    """Mean consecutive relative-translation error against the ground
    truth, wrapping around the loop (the JAX tool's rpe, :268-278)."""
    from slslam_tpu_torch.hostgeom import rodrigues
    R = np.stack([rodrigues(w) for w in cam[:, :3]])
    pos = -np.einsum("cji,cj->ci", R, cam[:, 3:])        # camera centers
    Rg = np.stack([rodrigues(w) for w in cam_gt[:, :3]])
    pg = -np.einsum("cji,cj->ci", Rg, cam_gt[:, 3:])
    d = np.einsum("cij,cj->ci", R, np.roll(pos, -1, 0) - pos)
    dg = np.einsum("cij,cj->ci", Rg, np.roll(pg, -1, 0) - pg)
    return float(np.linalg.norm(d - dg, axis=1).mean())


# ---------------------------------------------------------------------------
# The solve on the port
# ---------------------------------------------------------------------------

def device_tensors(host, device, dtype):
    """The solve's inputs on ``device`` in ``dtype``."""
    import torch
    packed = host["packed"]
    C, L = len(host["cam0"]), len(host["orth0"])

    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    cam_free = torch.ones(C, dtype=torch.bool, device=device)
    cam_free[0] = False
    return dict(cam_wt=f(host["cam0"]), line_orth=f(host["orth0"]),
                obs=f(packed.obs),
                obs_cam=torch.as_tensor(packed.obs_cam, device=device),
                obs_valid=torch.as_tensor(packed.obs_valid, device=device),
                cam_free=cam_free,
                line_free=torch.ones(L, dtype=torch.bool, device=device))


def solve(t, host, args):
    """One ``global_ba_cg`` of the tool's settings on the tensors ``t``:
    (cameras, lines, CGStats)."""
    import torch
    from slslam_tpu_torch.ops.schur_cg import global_ba_cg
    prior_c = host["prior_c"]
    if prior_c is not None:
        prior_c = torch.as_tensor(prior_c, dtype=t["cam_wt"].dtype,
                                  device=t["cam_wt"].device)
    return global_ba_cg(t["cam_wt"], t["line_orth"], t["obs"], t["obs_cam"],
                        t["obs_valid"], t["cam_free"], t["line_free"],
                        BASELINE, HUBER_DELTA, robust=True,
                        max_iters=args.max_iters, cg_iters=args.cg_iters,
                        prior_c=prior_c, prior_sigma_rot=0.2,
                        prior_sigma_t=2.0)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_bytes(t, launch_shapes):
    """Bytes of the kernels' launches ``launch_shapes`` ((name, shape) ->
    launches) of one solve on the tensors ``t``, by kernel_checks' closed
    forms: (total bytes, {name: (bytes a launch at the solve's shape,
    bound ms, what bounds it)})."""
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops.kernels import BAPlan, segment_plan_twin
    from slslam_tpu_torch.ops.schur_cg import _line_rows
    C = t["cam_wt"].shape[0]
    w_valid = t["obs_valid"].to(t["cam_wt"].dtype)
    L, kL = t["obs_cam"].shape
    valid = t["obs_valid"].reshape(-1)

    def plan_of(key, P):
        # the solve's plan (schur_cg.lm_plan) by its plain version, so that
        # counting bytes launches nothing
        return segment_plan_twin(torch.where(
            valid, key, torch.full_like(key, P)).to(torch.int32), P)

    plan = BAPlan(cam=plan_of(t["obs_cam"].reshape(-1), C),
                  line=plan_of(_line_rows(L, kL, valid.device), L), pair=None)
    args = dict(cam_wt=t["cam_wt"], line_orth=t["line_orth"],
                obs=t["obs"].reshape(L * kL, 8),
                obs_cam=t["obs_cam"].reshape(-1), w_valid=w_valid.reshape(-1))
    total, per = 0, {}
    for (name, shape), n in launch_shapes.items():
        if name == "segment_plan":
            work = kc.plan_work(*shape)
        elif name == "segment_sum":
            O, D, P = shape
            vals = torch.empty((O, D), dtype=t["cam_wt"].dtype, device="meta")
            # the PCG's camera sums read the camera plan's rows; the prior
            # edges' sums (--prior) keep every one of their rows
            idx = (plan.cam.key if O == plan.cam.key.numel()
                   else torch.zeros(O, dtype=torch.int32))
            work = kc.k1_work(vals, idx, P)
        elif name.startswith("schur_"):
            # the camera pass's right-hand side launches read gc, not
            # Hcc_d and x: counted as matvecs, a few C x 36 floats more
            work = kc.schur_work(name, C, L, int(plan.cam.offsets[-1]),
                                 t["cam_wt"].element_size())
        else:
            work = kc.k2_work(args, name.split("/")[1], plan)
        total += n * work[0]
        per[f"{name} {shape}"] = (work[0], *kc.bound(*work))
    return total, per


def profile_solve(run, device, wall):
    """Device activity of one solve ``run()`` whose unprofiled wall is
    ``wall`` seconds: the device's busy seconds over that wall (the
    profiler's CPU activity stretches the profiled run's own wall; as
    profile_replay.device_profile measures it) and each hand-written
    kernel's device seconds, its wrapper calls (``launches``, as
    kernels.launch_counts counts them), the device time of one call, and
    the device kernels those calls launched (torch.profiler; a call of the
    plan or of K2 ``lm`` launches several)."""
    import torch
    from torch.autograd import DeviceType
    from profile_replay import busy_seconds
    from slslam_tpu_torch.ops import kernels
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    _sync(device)
    before = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        _sync(device)
    profiled_wall = time.perf_counter() - t0
    calls = {k: n - before[k] for k, n in kernels.launch_counts.items()}
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_seconds([(e.time_range.start * 1e-6,
                          e.time_range.end * 1e-6) for e in ev])
    kern = {}
    for name, tags in KERNEL_NAMES.items():
        mine = [e.time_range.elapsed_us() * 1e-6 for e in ev
                if any(tag in e.name for tag in tags)]
        kern[name] = {"device_s": float(np.sum(mine)),
                      "launches": calls[name],
                      "mean_device_ms": (1e3 * float(np.sum(mine))
                                         / calls[name]
                                         if calls[name] else None),
                      "device_kernels": len(mine)}
    by_name = {}
    for e in ev:
        s, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (s + e.time_range.elapsed_us() * 1e-6, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_s": wall, "profiled_wall_s": profiled_wall,
            "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_ops": len(ev), "kernels": kern,
            "top_device": [[name[:100], s, n] for name, (s, n) in top]}


def run(args, host=None):
    """The tool's run: (the JSON record, the final cameras (C, 6))."""
    import torch
    from slslam_tpu_torch import resolve_device
    from slslam_tpu_torch.ops import kernels
    from slslam_tpu_torch.ops.schur_cg import _cost_lm
    dev = resolve_device("cpu" if args.cpu else args.device)
    dtype = {"float32": torch.float32, "float64": torch.float64}[
        args.dtype or ("float64" if dev.type == "cpu" else "float32")]
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.load_library()
        torch.cuda.reset_peak_memory_stats(dev)
    host = host or build(args)
    prob, packed = host["prob"], host["packed"]
    C, L, O = len(prob["cam_wt"]), len(prob["lines_w"]), len(prob["obs"])
    t = device_tensors(host, dev, dtype)
    w_valid = t["obs_valid"].to(dtype)
    gt_cost = float(_cost_lm(
        torch.as_tensor(prob["cam_wt"], dtype=dtype, device=dev),
        torch.as_tensor(host["orth_gt"], dtype=dtype, device=dev), t["obs"],
        t["obs_cam"], w_valid, BASELINE, HUBER_DELTA, True))

    def timed():
        _sync(dev)
        t0 = time.perf_counter()
        out = solve(t, host, args)
        _sync(dev)
        return out, time.perf_counter() - t0

    (cam1, _, stats), cold_s = timed()
    walls = []
    launch_shapes = None
    for _ in range(args.warm_runs):
        before = dict(kernels.launch_shapes)
        (cam1, _, stats), wall = timed()
        walls.append(wall)
        launch_shapes = {k: n - before.get(k, 0)
                         for k, n in kernels.launch_shapes.items()
                         if n > before.get(k, 0)}
    warm_s = min(walls) if walls else cold_s
    profile = None
    if args.profile and dev.type == "cuda":
        profile = profile_solve(lambda: solve(t, host, args), dev, warm_s)

    cam1 = cam1.double().cpu().numpy()
    cam0, cam_gt = host["cam0"], prob["cam_wt"]
    t_err = np.linalg.norm(cam1[:, 3:] - cam_gt[:, 3:], axis=1)
    t_err0 = np.linalg.norm(cam0[:, 3:] - cam_gt[:, 3:], axis=1)
    iters = int(stats.iterations)
    final_cost = float(stats.final_cost)
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else None)
    k_bytes = per_launch = None
    if launch_shapes is not None and dev.type == "cuda":
        k_bytes, per_launch = kernel_bytes(t, launch_shapes)
    out = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        dtype=str(dtype)[6:],
        num_cams=C, num_lines=L, num_obs=O,
        kL=packed.kL, kC=packed.kC, fill=packed.fill,
        gen_s=host["gen_s"], pack_s=host["pack_s"],
        cold_s=cold_s, warm_s=warm_s,
        iterations=iters,
        initial_cost=float(stats.initial_cost),
        final_cost=final_cost,
        cost_at_gt=gt_cost,
        cost_vs_noise_floor=final_cost / gt_cost if gt_cost > 0 else None,
        mean_cam_t_err_init_m=float(t_err0.mean()),
        mean_cam_t_err_final_m=float(t_err.mean()),
        rpe_init_m=rpe(cam0, cam_gt),
        rpe_final_m=rpe(cam1, cam_gt),
        hbm_bytes=peak,
        hbm_gb=peak / 2**30 if peak else None,
        xla_flops_per_solve=None,
        achieved_gflops_s=None,
        achieved_hbm_gb_s=k_bytes / warm_s / 1e9 if k_bytes else None,
        obs_per_s=O * max(iters, 1) / warm_s / 1e6,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        peak_device_bytes=peak,
        cg_iterations=int(stats.cg_iterations),
        warm_walls_s=walls,
        launch_shapes=[[name, list(shape), n] for (name, shape), n
                       in sorted((launch_shapes or {}).items())],
        kernel_bytes_per_launch=per_launch,
        notes={
            "xla_flops_per_solve, achieved_gflops_s":
                "null: the JAX tool reads them from XLA's compile-time "
                "cost analysis, which a PyTorch program has no counterpart "
                "of",
            "hbm_bytes": "torch.cuda.max_memory_allocated over the upload "
                         "and every solve (peak_device_bytes); null on the "
                         "CPU",
            "achieved_hbm_gb_s": "the segment plans', K1's, K2's, K3's "
                                 "and K4's bytes of one warm solve "
                                 "(kernel_checks' closed "
                                 "forms) over its wall; the solve's "
                                 "PyTorch operations are not counted",
            "obs_per_s": "millions of observations times LM iterations a "
                         "second of the warm wall"},
    )
    if profile is not None:
        out["profile"] = profile
    if dev.type == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    return out, cam1


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=2048)
    ap.add_argument("--lines-per-cam", type=int, default=8)
    ap.add_argument("--band-m", type=float, default=10.0)
    ap.add_argument("--spacing", type=float, default=0.78)
    ap.add_argument("--noise-px", type=float, default=0.3)
    ap.add_argument("--cam-sigma-rot", type=float, default=0.005)
    ap.add_argument("--cam-sigma-t", type=float, default=0.05)
    ap.add_argument("--line-sigma-cp-m", type=float, default=0.05)
    ap.add_argument("--line-sigma-dir-rad", type=float, default=0.005)
    ap.add_argument("--max-iters", type=int, default=30)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--warm-runs", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="the JAX tool's flag: the same as --device cpu")
    ap.add_argument("--prior", action="store_true",
                    help="fuse the initial estimate's odometry chain as a "
                         "weak pose-graph prior (global_ba_cg prior_c)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the twins)")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "float64"),
                    help="default float32 on the card, float64 on the CPU")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm solve on the card: the "
                         "device's busy share, each kernel's device time")
    return ap


def main(argv=None):
    out, _ = run(parser().parse_args(argv))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
