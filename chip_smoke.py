"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # one card, no arguments

Phases, each printing one JSON line:

0. environment: ``nvidia-smi`` name and power limit, the device, the nvcc
   build of the kernel libraries from slslam_tpu_torch/csrc (sm_90a, one
   nvcc per source, in parallel) and each kernel's registers and spills
   from ``-Xptxas -v``;
1. K1: the segment plan against its twin (identical; on each path that
   can take the shape, each launched twice) at the main path's shapes, at
   the larger plans' (the large map's 3.49M-row line and camera plans, the
   scaling tool's pairs, the interactive window's pairs, the LC PGO's V^2
   blocks), on either side of each path's limit and on adversarial keys
   (``kernel_checks.plan_adversarial_cases``); ``segment_sum`` with and
   without a plan against its twin on CPU copies, float32 and float64, at
   the replay's shapes and at the refine's rows by camera; and
   ``assemble`` (the port of ``assemble_pallas``: three K1 sums, on no
   main path) against its plain version at the window's shape, checked
   and timed; K3 ``schur_matvec`` (its line pass, its camera pass as the
   matvec and as the right-hand side) and K4 ``schur_jacobi`` at the
   refine's, the loop-closure refine's and the large map's shapes
   (``kernel_checks.SCHUR_SHAPES``) against their twins in float32 and
   float64, launched twice bit for bit, and timed as below, the twin being
   the JAX package's einsum chain (a later phase that launched them at one
   of these cases reuses its check and times); K3 ``schur_pcg`` (the whole
   PCG of a damped step in one cooperative launch) at the same three
   shapes on a real BA system (``kernel_checks.pcg_case``: K2 ``lm``'s
   blocks, with the pose priors' coupling at the loop-closure refine's),
   at the refine's settings (100 iterations, eta 1e-2): float64 the
   twin's iteration count and x within 1e-10, float32 against the float64
   twin within a rounding witness, two launches bit for bit, timed per
   launch and per iteration against the twin (the Python loop);
2. K2 ``fused_eval``, every variant (full, cams, lines, lm) at its
   main-path shape against its twin, float32 and float64, a repeat launch
   that must agree bit for bit; ``lm``'s first launch writes into memory
   that held NaNs, and every Wb row its plan drops must be exactly zero;
   phases 1 and 2 also time each kernel at the main path's shapes in
   float32: eager CUDA events over 50 launches (``ms``, the host's enqueue
   included), the replay of a CUDA graph of 50 captured launches
   (``device_ms``), the plain twin (``plain_ms``) and one PyTorch call that
   computes the same function, where there is one (``library_ms``; the port
   never calls it): for K1 an ``index_add_`` into a pre-zeroed (P + 1, D)
   buffer, for the plan a stable ``torch.sort`` plus ``torch.searchsorted``.
   The plan is timed at each shape the main path builds (the window's line
   and (cam, line) pair plans, the VO polish's camera plan, a refine
   solve's camera and line plans) and at the larger plans' shapes, and K1
   at lines-GN's trial cost and at the refine's rows by camera (6 and 36
   lanes, on no path since K3 and K4 sum them); the shapes
   after the first are listed under ``shapes`` in the kernel's record;
3. slice parity in float64: 60 house frames on CUDA (kernels) and on the
   CPU (twins), fed the same Gumbel noise: identical keyframes and RANSAC
   scores, trajectories within 1e-6 m, every replay variant of K2
   launched; then the global refine of that replay (``method="cg"``, three
   rounds, the bench's) on CUDA and on the CPU from the same trajectory:
   the same LM iterations, poses within 1e-6 m, K2 ``lm``, K3 and K4
   launched;
4. the slice at full size: BatchSlam on CUDA in float32 with the bench's
   configuration, 400 frames of render seed 4, timed after a 20-frame
   warm-up: 400 keyframes, 74 landmarks, finite poses, raw ATE <= 0.55 m
   (the JAX reference: 0.484 m); K2 ``full`` launches == window-BA LM
   iterations, ``lines`` launches == lines_gn_iters x lines-GN calls, 0 <
   ``cams`` launches <= moba_max_iter x frames, K1 and the plan launched,
   and no call of the torch.func Jacobian helpers on CUDA tensors;
5. the global refine at full width: ``global_refine(frames, is_kf,
   trajectory, cfg, rounds=3)`` in float32 on phase 4's 400 keyframes: the
   CG path, the final cost below the initial one, keyframe 0 at identity,
   refined ATE <= 0.01 m (the JAX package's TPU record: 0.0016-0.0024 m);
   K2 ``lm`` launches == the CG solves' LM iterations (the staged
   lines-only solve included) == K3 ``schur_pcg`` launches == K3's line
   pass (the back-substitution) == its camera pass (the right-hand side)
   == K4, the launches' PCG counts summing to the PCG iterations that
   ``CGStats`` reports, no K1 (no priors), two plans per solve, no
   torch.func Jacobian on CUDA tensors.  It prints
   the wall, LM and PCG iterations, (O, kL, kC), raw and refined ATE and
   the replay + refine keyframes per second of this seed.
6. loop-closure mode at full size: bench.py's lc workload (the village,
   170 frames, every frame a keyframe, f32) through
   ``BatchSlamLC.run`` with the batched recognizer and the merged 2-round
   refine, as ``BENCH_MODE=lc`` drives it: at least 7 loop closures (the
   JAX package's documented gate), every merged track on one world
   segment, final ATE below the odometry ATE; K2 ``cams``, ``full`` and
   ``lm``, K1, K3 and K4 each launched in the post-pass; the merged
   refine's CG solves launch K1 twice an LM iteration where they have
   priors (their blocks, ``prior_terms``) and never per PCG iteration (the
   priors' coupling runs inside ``schur_pcg``); a second post-pass over
   the same replay and descriptors repeats bit for bit (trajectory,
   closures, merges).  Then the post-pass in f64 on that replay, CUDA
   against CPU, both fed the same span noise: identical closures, merges
   and PGO iterations, trajectories within 1e-6 m.  It prints the stage
   walls and ``refine_pick``.  Last, every kernel at every shape that the
   loop-closure run launched it at (``kernels.launch_shapes``: the
   village replay's window, the span refits, group fits and joint
   polishes, the priors' and the PGO's block sums, the merged refine):
   against its twin in float32 and float64 at the tolerances of phases 1
   and 2, and timed in float32 as they time the house shapes;
7. the interactive engine (``Slam``): (a) INTERACTIVE_FRAMES house
   frames in f32 at the reference gates (cut from 400 for the script's
   time; phase 10 (a) runs the 400), (b) the interactive bench, (c) f64
   parity with the CPU (orth; aid with window anchors), (d) interactive
   loop closure on the village, (e) (a)'s checkpoint at CHECKPOINT_FRAME
   resumed bit for bit; then every
   kernel at every shape phase 7 launched it at (role "interactive");
8. the image front-end: (a) on the first rendered house frames, the
   gradient maps on the card against the CPU (magnitude within FE_MAG_TOL,
   the angle within FE_ANGLE_TOL where it is read), the descriptors on
   identical inputs (FE_DESC_TOL), the host stages on the card's maps
   giving the card's segments, the native grower; (b) the front-end bench
   workload (tools/torch_frontend_bench.py: 60 frames -> matcher ->
   BatchSlam -> refine, f32): more than 20 tracks a frame, refined ATE
   below 0.35 m (tests/test_frontend.py's gate), the stage split and the
   device's busy share over the front-end loop; (c) ``cli track`` over 40
   rendered frames written as PNGs, through ``Slam`` at ``SlamConfig()``'s
   gates in f32 (the main path of the slice): keyframes and keyframe ATE
   within the CPU's band on the same frames (TRACK_KEYFRAMES,
   TRACK_ATE_MAX), K2 ``full`` launches == window LM iterations, ``lines`` == 4 x window
   solves, ``cams`` within the VO's cap, K1 launched, no torch.func
   Jacobian on CUDA tensors, the native walker; (d) the interactive PGO
   case of tests/test_torch_slam_pgo.py in f64: every pose-graph solve of
   the CPU's run repeated from its state on the card and on the CPU
   (within 1e-9 m), and the whole run on the card beside the CPU's (the
   same keyframes, edges and PGO frames, trajectories within
   PGO_TRAJ_TOL); then
   every kernel at every shape (b) and (c) launched it at (role
   "frontend");
9. the tools and the CLI's last commands (P13): (a) the large map at
   full width (tools/torch_large_map_bench.py's path at LARGE_MAP, ~0.93M
   observations, f32, a cold and one warm solve): every key of the tool's
   JSON logged, its final cost and ``rpe_final_m`` within LM_COST_RTOL /
   LM_RPE_RTOL (relative) of a float64 solve of the same problem on the
   card,
   ``rpe_final_m < rpe_init_m``, finite values, two plans a solve, K2
   ``lm``, K3 and K4 launched, then
   every kernel at every shape the run launched it at (role
   "large_map"); (b) the large map at LM_PARITY in float64, card against
   CPU: at LM_PARITY_ITERS the same LM and PCG iterations, cameras within
   1e-6, final cost within 1e-9 relative, K3 and K4 launched on the card
   (at the tool's 30 x 100
   iterations the gaps are logged: rounding alone moves a solve that
   long by ~6e-6); (c) tools/torch_param_study.py's ``run_one``,
   orth and aid, 0.2 px, window 10, STUDY_FRAMES frames, f32, its result
   files written: ATE <= STUDY_ATE_MAX; (d) tools/torch_scale_lc.py at
   LC9_FRAMES frames (cut from 1000 for the script's time), one run: at
   least 7 closures, final ATE within the JAX package's band at that cut
   (LC9_ATE_MAX: at 340 frames the merged refine beats the odometry for
   some seeds only, JAX's own too); (e) the CLI:
   ``gen`` CLI_GEN_FRAMES frames -> ``run --plot --viz --profile-dir`` ->
   ``view``, ``sim --verbose --live-dir`` over CLI_SIM_FRAMES frames,
   ``track --live-dir`` over phase 8 (c)'s
   first CLI_TRACK_FRAMES frames: the PNGs, ``map.html`` embedding
   ``const D = {``, the progress lines, and K2 among the trace's CUDA
   kernels; then every kernel at every shape (c), (d) and (e) launched it
   at that no earlier phase checked (role "phase9");
10. the distributed layer (P12), DIST_WORLD ranks spawned on the one card
   (``parallel.run_local_ranks``; gloo, since NCCL refuses two ranks on
   one device), each importing neither jax nor slslam_tpu, every group
   and collective under DIST_TIMEOUT_S: (a) ``Slam(SlamConfig())`` with
   mesh_devices=DIST_WORLD over DIST_FRAMES house frames in f32 at the
   reference gates (the slice's main path, counted in each rank up to its
   last frame; the edge-sharded PGO run after it on the final graph is
   counted apart and its shapes checked in (e)): keyframe
   ATE <= 0.1 m, the ranks' trajectories, landmarks, keyframes, edges and
   LM iterations equal bit for bit, K2 ``full`` launches == window LM
   iterations on each rank, logged beside phase 7 (a) at its frames; (b)
   in the same ranks, f64 over PARITY_FRAMES frames against phase 7 (c)'s
   single-process run on the card: the same keyframes, edges and LM
   iterations, trajectories within DIST_TRAJ_TOL; (c) NCCL at world 1 in
   this process: sharded window solves at two line counts and a sharded
   PGO against ``local_ba`` / ``pose_graph_opt`` on the same arrays
   (within DIST_W1_RTOL, the same iterations) and the collective bytes
   per LM iteration against their closed form in C; (d)
   tools/torch_scaling_bench.py at world 1 and DIST_WORLD, its JSON
   logged; then (e) every kernel at every shape (a)-(d) launched it at
   that no earlier phase checked (role "dist").

The launch counts of the kernels' record are those of the main-path runs
(phase 4's replay, phase 5's refine, phase 6's loop closure run, phase 7
(a), phase 8 (b) and (c), phase 9's large map, study runs, scale LC run
and CLI runs, and phase 10 (a) summed over its ranks), each counted from
zero (the split is under
``launches_by_path``); each timed shape carries its own launches in
those runs (``launches_at_shape``; role "lc": the loop-closure run's).
Then a line with the card's name
and power limit, a line with the kernels' record, and the last line
``{"ok": true, "device": {...}}``.  Any failed
check raises: the script exits non-zero and prints no result.  Without a
CUDA device it exits 1 at once.
"""

import contextlib
import json
import re
import subprocess
import sys
import time


WARMUP_FRAMES = 20
GRAPH_LAUNCHES = 50
# a timing's repetitions stop short of this many milliseconds where one
# launch is long (the map-scale plans of phase 9 take a good part of a
# second each); the house shapes keep their 50 launches
TIMING_BUDGET_MS = 2000.0
K1_SOURCE = "slslam_tpu_torch/csrc/segment_sum.cu"
K2_SOURCE = "slslam_tpu_torch/csrc/fused_eval.cu"
K34_SOURCE = "slslam_tpu_torch/csrc/schur_cg.cu"
# what K3's passes and K4 replace: the XLA einsums of the JAX package's
# PCG matvec and SCHUR_JACOBI blocks (it wrote no Pallas kernel for them)
K34_REPLACES = {"schur_matvec/line": "slslam_tpu/ops/schur_cg.py:198",
                "schur_matvec/cam": "slslam_tpu/ops/schur_cg.py:198",
                "schur_pcg": "slslam_tpu/ops/schur_cg.py:233",
                "schur_jacobi": "slslam_tpu/ops/schur_cg.py:221"}
# K3's PCG at phase 1's shapes: with the pose priors' coupling where the
# path runs it (the loop-closure workload's merged refine)
PCG_PRIORS = {"refine": False, "lc": True, "map": False}
JAC_HELPERS = ("lba_residual_jac_batch", "lba_residual_jac_cam_batch",
               "lba_residual_jac_line_batch")
REFINE_ROUNDS = 3
# phase 7 (a): cut from 400 frames for the script's time, the 400 being
# phase 10 (a)'s run; its checkpoint at frame 150, (e) resumes from there
INTERACTIVE_FRAMES = 200
CHECKPOINT_FRAME = 150
PARITY_FRAMES = 40
# the JAX package's keyframe ATE on phase 7 (a)'s run, in float64 on the CPU
# (tools/jax_interactive_reference.py --frames 200: 19 keyframes, 95 window
# LM iterations; at 400 frames 0.0018133 m)
JAX_INTERACTIVE_ATE_M = 0.001762914405919682
FRONTEND_FRAMES = 60
FE_CHECK_FRAMES = 5
TRACK_FRAMES = 40
TRACK_STRIDE = 3
# phase 8 (c)'s run on the CPU (tools/jax_frontend_reference.py track):
# over RANSAC seeds and rounding witnesses the JAX package takes 10
# keyframes at keyframe ATE 0.042-0.287 m (f32 and f64), the port 10-11
# keyframes at 0.044-0.374 m; the card's run is held to JAX's band, its
# top with 5 % headroom
TRACK_ATE_MAX = 0.30
TRACK_KEYFRAMES = (10, 11)
PGO_FRAMES = 80
# phase 8 (d)'s whole f64 runs, card against CPU: 1e-15 relative input
# changes move the CPU's own run 1.91e-5 to 2.61e-5 m
# (tools/jax_frontend_reference.py pgo); about twice the top of that band
PGO_TRAJ_TOL = 5e-5
# phase 9: the large map at full width (tools/torch_large_map_bench.py;
# 8192 cameras x 16 lines a camera, ~0.93M observations)
LARGE_MAP = ("--cams", "8192", "--lines-per-cam", "16")
# its f32 solve against the f64 solve of the same problem on the card,
# relative to the f64 values: 30 LM iterations leave the survey loop far
# from converged, where the two part widely; at the tool's default 2048
# cameras the f32 final cost is 0.349 and its rpe_final_m 1.226 above the
# f64 run's (4.3676 vs 3.2367; 0.17234 vs 0.07743 m;
# tools/torch_large_map_bench.py on an H100 80GB HBM3 at 700 W); the
# tolerances are twice those
LM_COST_RTOL = 2 * 0.349
LM_RPE_RTOL = 2 * 1.226
# (b)'s f64 parity, card against CPU, at the iterations of the CPU test
# against JAX (tests/test_torch_tools.py: 10 LM x 40 PCG), where rounding
# alone moves the CPU's own cameras 1.3e-10 and its cost 2.6e-11
# relative; then the tool's 30 x 100, logged: there the CPU's own
# rounding witnesses move the cameras 5.3e-6 to 6.1e-6 and the cost up to
# 1.05e-8 relative (reversed twin sums, 1e-15 input changes)
LM_PARITY = ("--cams", "256", "--lines-per-cam", "4")
LM_PARITY_ITERS = ("--max-iters", "10", "--cg-iters", "40")
STUDY_FRAMES = 120
# the interactive engine's ATE limit (phase 7 (a))
STUDY_ATE_MAX = 0.1
LC9_FRAMES = 340
# at 340 frames the merged refine does not always beat the odometry: over
# replay / post-pass seeds 4-7 the JAX package in f64 ends at 0.76-1.28
# times its odometry ATE, 0.0127-0.0215 m (tools/jax_scale_lc_reference.py,
# CPU); (d) is held to that band, its top with 5 % headroom, as phase 8 (c)
# is held to JAX's band.  (At 150 frames JAX's band is 0.0063-0.0161 m and
# the card's f32 run ended at 0.0171 m: ROADMAP Queue 3.)
LC9_ATE_MAX = 0.0226
# phase 9 (e)'s gen -> run --plot --viz --profile-dir -> view and its sim,
# cut from 60 and 40 frames for the script's time (the trace's export
# grows with the window solves: 498 MB at 60 frames, 352 MB at 30)
CLI_GEN_FRAMES = 12
CLI_SIM_FRAMES = 20
CLI_TRACK_FRAMES = 12
# the front-end's device stages, card against CPU (phase 8 (a)): magnitude
# (absolute, gray levels per pixel), level-line angle where the magnitude
# reaches the detector's threshold, normalized descriptor
FE_MAG_TOL = 1e-4
FE_ANGLE_TOL = 1e-5
FE_DESC_TOL = 1e-6
# phase 10: the distributed layer at world 2, two ranks sharing the card
# over gloo (NCCL refuses two ranks on one device); (a) over the whole
# 400 house frames
DIST_WORLD = 2
DIST_FRAMES = 400
# each spawned rank group's limit, and the timeout of its collectives
DIST_TIMEOUT_S = 300.0
# (b): f64 world 2 against the single-process run on the card, the JAX
# package's tolerance for its own mesh engine (tests/test_distributed.py:234)
DIST_TRAJ_TOL = 1e-8
# (c): NCCL at world 1 against local_ba / pose_graph_opt, f64, relative
DIST_W1_RTOL = 1e-12


def log(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _first_ms(fn):
    """Milliseconds of one synchronized call of ``fn`` (after one call to
    warm it): what sizes the repetitions of a long kernel's timing."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _reps(first_ms, most, budget_ms=TIMING_BUDGET_MS):
    """Repetitions of a timing: ``most``, fewer (at least 2) where that
    many would take more than ``budget_ms``."""
    return max(2, min(most, int(budget_ms / max(first_ms, 1e-3))))


def cuda_ms(fn, reps=50, warmup=5):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events around
    back-to-back eager calls: the host's enqueue is part of it); fewer
    calls where one takes long (``_reps``)."""
    import torch
    reps = _reps(_first_ms(fn), reps)
    for _ in range(min(warmup, reps)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches=GRAPH_LAUNCHES, replays=5):
    """Mean device milliseconds per call of ``fn``: ``launches`` calls
    captured in one CUDA graph, the graph replayed and timed with events;
    fewer launches and replays where one call takes long (``_reps``)."""
    import torch
    first = _first_ms(fn)
    launches = _reps(first, launches)
    replays = _reps(first * launches, replays)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def ptxas_summary(reports):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    -Xptxas -v reports (mangled names shortened)."""
    from slslam_tpu_torch.ops.kernels import VARIANTS
    out = {}
    dtypes = {"f": "f32", "d": "f64"}
    for text in reports.values():
        name = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                mangled = m.group(1)
                k2 = re.search(r"fused_eval_kernelI([fd])Li(\d)E", mangled)
                lm = re.search(r"lm_(rows|cams)_kernelI([fd])E", mangled)
                k1 = re.search(r"seg_sum_kernelI([fd])E", mangled)
                plan = re.search(r"plan_(\w+?)_kernel", mangled)
                k34 = re.search(r"schur_(line|cam|jacobi)_kernelI([fd])Li"
                                r"(\d+)E(Lb([01])E)?", mangled)
                pcg = re.search(r"schur_pcg_kernelI([fd])E", mangled)
                if pcg:
                    name = f"schur_pcg/{dtypes[pcg[1]]}"
                elif k34:
                    kind = {"line": "schur_matvec/line",
                            "cam": "schur_matvec/cam",
                            "jacobi": "schur_jacobi"}[k34[1]]
                    rhs = "/rhs" if k34[5] == "1" else ""
                    name = f"{kind}{rhs}/{dtypes[k34[2]]}/G{k34[3]}"
                elif k2:
                    name = (f"fused_eval/{VARIANTS[int(k2[2])]}"
                            f"/{dtypes[k2[1]]}")
                elif lm:
                    name = f"fused_eval/lm/{lm[1]}/{dtypes[lm[2]]}"
                elif k1:
                    name = f"segment_sum/{dtypes[k1[1]]}"
                elif plan:
                    name = f"segment_plan/{plan[1]}"
                else:
                    name = mangled
                out[name] = {}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and name:
                out[name].update(spill_stores=int(m[1]),
                                 spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name]["registers"] = int(m[1])
    return out


def phase0(dev):
    from slslam_tpu_torch.ops import kernels
    import torch
    smi = nvidia_smi()
    kernels.load_library()
    log({"phase": 0, "nvidia_smi": smi,
         "device": torch.cuda.get_device_name(dev),
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernel_build_s": kernels.build_seconds,
         "ptxas": ptxas_summary(kernels.ptxas_log),
         "tf32_matmul": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase1(dev, rec):
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    t_phase = time.perf_counter()
    out = {"phase": 1,
           "plans": {str(s): d for s, d in kc.check_plans(dev)}}
    # the plan, every path that can take each shape, at the larger plans'
    # shapes, on either side of each path's limit and on adversarial keys
    for key, kw in (("plans_large", dict(shapes=kc.PLAN_LARGE_SHAPES)),
                    ("plans_boundary",
                     dict(shapes=kc.PLAN_BOUNDARY_SHAPES)),
                    ("plans_adversarial",
                     dict(cases=kc.plan_adversarial_cases()))):
        out[key] = {str(s): d for s, d in kc.check_plans(dev, **kw)}
    for dtype in (torch.float32, torch.float64):
        for shape, err, max_abs in kc.check_k1(dtype, dev):
            out[f"{str(dtype)[6:]}_{shape}"] = {"err": err,
                                                "max_abs_err": max_abs}

    # the plan at every shape the main path builds, K1 at lines-GN's trial
    # cost and at the refine's rows by camera
    roles = ("window and lines-GN lines", "window (cam, line) pairs",
             "VO polish cameras", "refine cameras", "refine lines")
    for role, (O, P) in zip(roles, kc.PLAN_SHAPES):
        add_shape(rec["segment_plan"], dict(
            shape=[O, P], role=role,
            max_abs_err=float(out["plans"][str((O, P))]),
            **plan_times(dev, O, P)))
    for role, (O, P) in zip(kc.PLAN_LARGE_ROLES, kc.PLAN_LARGE_SHAPES):
        add_shape(rec["segment_plan"], dict(
            shape=[O, P], role=role,
            max_abs_err=float(out["plans_large"][str((O, P))]),
            **plan_times(dev, O, P)))

    k1_roles = ("lines-GN trial cost", None, None,
                "refine rows by camera, 6 lanes (on no path)",
                "refine rows by camera, 36 lanes (on no path)")
    for role, (O, D, P) in zip(k1_roles, kc.K1_SHAPES):
        if role is None:
            continue
        add_shape(rec["segment_sum"], dict(
            shape=[O, D, P], role=role,
            max_abs_err=out[f"float32_{(O, D, P, True)}"]["max_abs_err"],
            **k1_times(dev, O, D, P)))
    # assemble, the port of assemble_pallas (three K1 sums with their
    # plans), at the window's (C, L, O); no main path calls it
    C, L, O = kc.K2_SHAPES["full"]
    args = kc.assemble_case(C, L, O, torch.float32, dev)
    out["assemble"] = dict(
        shape=[C, L, O], launches=0,
        max_abs_err={str(dt)[6:]: kc.check_assemble(dt, dev)
                     for dt in (torch.float32, torch.float64)},
        ms=cuda_ms(lambda: kernels.assemble(*args)),
        device_ms=graph_ms(lambda: kernels.assemble(*args)),
        plain_ms=cuda_ms(lambda: kc.assemble_plain(*args)), library_ms=None)
    out["assemble"].update(zip(("bound_ms", "bound_by"), kc.bound(
        *kc.assemble_work(C, L, O, 4))))
    fields = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")
    out["times_float32"] = {
        name: [dict(shape=r["shape"], **{f: r[f] for f in fields})
               for r in [rec[name]] + rec[name]["shapes"]]
        for name in ("segment_plan", "segment_sum")}
    # K3 and K4 at the refine's, the loop-closure refine's and the map's
    # shapes: checked in float32 and float64, then timed
    t0 = time.perf_counter()
    for where, shape in kc.SCHUR_SHAPES.items():
        errs, times = schur_checks(dev, shape, kc.SCHUR_PADS[where])
        out[f"schur_{where}"] = errs
        for name in kc.SCHUR_OUTPUTS:
            add_shape(rec[name], dict(
                shape=list(shape), role=where, max_abs_err=max(
                    m for k, (_, m) in errs["float32"].items()
                    if k.startswith(name + " ")), **times[name]))
        errs, times = pcg_checks(dev, shape, kc.SCHUR_PADS[where],
                                 PCG_PRIORS[where])
        out[f"schur_pcg_{where}"] = errs
        add_shape(rec["schur_pcg"], dict(
            shape=list(shape), role=where, priors=PCG_PRIORS[where],
            max_abs_err=errs["float32"]["max_abs_err"], **times))
    out["times_float32"]["schur"] = {
        name: [dict(shape=r["shape"], **{f: r[f] for f in fields})
               for r in [rec[name]] + rec[name]["shapes"]]
        for name in kernels.SCHUR_KERNELS}
    out["schur_check_and_time_s"] = time.perf_counter() - t0
    # without a plan the wrapper builds one first: two launches
    O, D, P = kc.K1_SHAPES[0]
    vals, idx = kc.k1_case(O, D, P, torch.float32, dev)
    out["segment_sum_no_plan_ms"] = cuda_ms(
        lambda: kernels.segment_sum(vals, idx, P))
    out["phase_1_s"] = time.perf_counter() - t_phase
    log(out)


def plan_times(dev, O, P):
    """The plan at (O, P) in float32 (kernel_checks.plan_case): eager and
    graph-replayed ms, the twin's, the sort yardstick's, and the bound."""
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    key = kc.plan_case(O, P, dev)
    times = dict(
        ms=cuda_ms(lambda: kernels.segment_plan(key, P)),
        device_ms=graph_ms(lambda: kernels.segment_plan(key, P)),
        plain_ms=cuda_ms(lambda: kernels.segment_plan_twin(key, P)),
        library_ms=cuda_ms(lambda: sort_plan(key, P)))
    times.update(zip(("bound_ms", "bound_by"), kc.bound(*kc.plan_work(O, P))))
    return times


def k1_times(dev, O, D, P):
    """K1 at (O, D, P) in float32 (kernel_checks.k1_case) with its plan
    built outside the timing: eager and graph-replayed ms, the twin's, one
    ``index_add_`` into a pre-zeroed (P + 1, D) buffer, and the bound."""
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    vals, idx = kc.k1_case(O, D, P, torch.float32, dev)
    plan = kernels.segment_plan(idx, P)
    buf = torch.zeros((P + 1, D), dtype=vals.dtype, device=dev)
    pad = torch.where((idx >= 0) & (idx < P), idx, torch.full_like(idx, P))
    times = dict(
        ms=cuda_ms(lambda: kernels.segment_sum(vals, idx, P, plan=plan)),
        device_ms=graph_ms(lambda: kernels.segment_sum(vals, idx, P,
                                                       plan=plan)),
        plain_ms=cuda_ms(lambda: kernels.segment_sum_twin(vals, idx, P)),
        library_ms=cuda_ms(lambda: buf.index_add_(0, pad, vals)))
    times.update(zip(("bound_ms", "bound_by"),
                     kc.bound(*kc.k1_work(vals, idx, P))))
    return times


def k2_times(dev, variant, shape=None, pad_frac=0.008):
    """K2's ``variant`` at ``shape`` in float32 (kernel_checks.
    k2_variant_case) with its plan built outside the timing: eager and
    graph-replayed ms, the twin's, and the bound; no PyTorch call computes
    the same function (``library_ms`` None)."""
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    args, plan = kc.k2_variant_case(variant, torch.float32, dev, shape,
                                    pad_frac)

    def kernel():
        return kernels.fused_eval(**args, variant=variant, plan=plan)

    times = dict(
        ms=cuda_ms(kernel), device_ms=graph_ms(kernel),
        plain_ms=cuda_ms(lambda: kernels.fused_eval_twin(
            **args, variant=variant), reps=20),
        library_ms=None)
    times.update(zip(("bound_ms", "bound_by"),
                     kc.bound(*kc.k2_work(args, variant, plan))))
    if variant == "lm":
        times["dropped_rows"] = int(kc.dropped_rows(plan.cam).numel())
    return times


# K3 and K4's checks and times by (shape, padding share): a later phase
# that launched them at a case phase 1 checked reuses phase 1's
_schur_checked = {}


def schur_checks(dev, shape, pad_frac):
    """K3's passes and K4 at ``shape`` with ``pad_frac`` padding:
    ({dtype: kernel_checks.check_schur's errors}, schur_times), made once
    for each case."""
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    key = (tuple(shape), pad_frac)
    if key not in _schur_checked:
        case, plan = kc.schur_case(torch.float32, dev, shape, pad_frac)
        errs = {"float32": kc.check_schur_case(case, plan),
                "float64": kc.check_schur(torch.float64, dev, shape,
                                          pad_frac)}
        _schur_checked[key] = (errs, schur_times(case, plan))
    return _schur_checked[key]


def schur_times(case, plan):
    """K3's passes and K4 on a float32 kernel_checks.schur_case and its
    plan: {kernel: eager and graph-replayed ms, the twin's (the JAX
    package's einsums with ``index_add_`` camera sums), the bound}; the
    camera pass as the matvec.  No PyTorch call computes S x or the
    blocks (``library_ms`` None)."""
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    a = case
    calls = {
        "schur_matvec/line": (
            lambda: kernels.schur_matvec_line(a["Wb"], a["obs_cam"], a["x"],
                                              a["cam_free_f"], a["Binv"],
                                              plan.line),
            lambda: kernels.schur_matvec_line_twin(
                a["Wb"], a["obs_cam"], a["x"], a["cam_free_f"], a["Binv"])),
        "schur_matvec/cam": (
            lambda: kernels.schur_matvec_cam(a["Wb"], a["w"], a["cam_free_f"],
                                             plan.cam, Hcc_d=a["Hcc_d"],
                                             x=a["x"]),
            lambda: kernels.schur_matvec_cam_twin(
                a["Wb"], a["w"], a["cam_free_f"], plan.cam.key,
                Hcc_d=a["Hcc_d"], x=a["x"])),
        "schur_jacobi": (
            lambda: kernels.schur_jacobi(a["Wb"], a["Binv"], a["Hcc_d"],
                                         a["cam_free_f"], plan.cam),
            lambda: kernels.schur_jacobi_twin(a["Wb"], a["Binv"], a["Hcc_d"],
                                              a["cam_free_f"], plan.cam.key))}
    out = {}
    for name, (kernel, twin) in calls.items():
        out[name] = dict(ms=cuda_ms(kernel), device_ms=graph_ms(kernel),
                         plain_ms=cuda_ms(twin, reps=20), library_ms=None)
        out[name].update(zip(("bound_ms", "bound_by"), kc.bound(
            *kc.schur_case_work(name, case, plan))))
    return out


# K3's PCG checks and times by (shape, padding share, priors), as
# _schur_checked
_pcg_checked = {}


def pcg_checks(dev, shape, pad_frac, priors=False):
    """K3's PCG at ``shape`` with ``pad_frac`` padding, with or without the
    pose priors: ({dtype: kernel_checks.check_pcg_case's result},
    pcg_times), made once for each case."""
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    key = (tuple(shape), pad_frac, priors)
    if key not in _pcg_checked:
        case, plan = kc.pcg_case(torch.float32, dev, shape, pad_frac, priors)
        errs = {"float32": kc.check_pcg_case(case, plan),
                "float64": kc.check_pcg(torch.float64, dev, shape, pad_frac,
                                        priors)}
        _pcg_checked[key] = (errs, pcg_times(case, plan))
    return _pcg_checked[key]


def pcg_times(case, plan):
    """K3's PCG on a float32 kernel_checks.pcg_case at the refine's
    settings: a launch's eager and graph-replayed ms (the cooperative
    launch captures into a CUDA graph), its iterations and device ms an
    iteration, the twin's ms (the Python loop, a host read an iteration)
    and the bound of the launch's iterations.  No PyTorch call runs a
    PCG (``library_ms`` None)."""
    from slslam_tpu_torch import kernel_checks as kc
    kernel = kc.pcg_call(case, plan)
    iterations = int(kernel()[1])
    device_ms = graph_ms(kernel)
    times = dict(ms=cuda_ms(kernel), device_ms=device_ms,
                 iterations=iterations,
                 device_ms_per_iteration=device_ms / iterations,
                 plain_ms=cuda_ms(kc.pcg_call(case, plan, twin=True),
                                  reps=5, warmup=1),
                 library_ms=None)
    times.update(zip(("bound_ms", "bound_by"), kc.bound(
        *kc.pcg_work(case, plan, iterations))))
    times["bound_ms_per_iteration"] = times["bound_ms"] / iterations
    return times


def sort_plan(key, P):
    """The plan's function in PyTorch calls (the yardstick, never used by
    the port): a stable sort of the key with the dropped rows last, and
    each segment's start by binary search."""
    import torch
    k = torch.where((key >= 0) & (key < P), key, torch.full_like(key, P))
    sorted_k, perm = torch.sort(k, stable=True)
    return perm, torch.searchsorted(
        sorted_k, torch.arange(P + 1, dtype=k.dtype, device=k.device))


def add_shape(record, times):
    """The first shape timed fills the kernel's record; later ones go to
    its ``shapes`` list."""
    if "ms" not in record:
        record.update(times)
        record["shapes"] = []
    else:
        record["shapes"].append(times)


def phase2(dev, rec):
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    out = {"phase": 2, "shapes": kc.K2_SHAPES}
    for variant in kernels.VARIANTS:
        name = f"fused_eval/{variant}"
        for dtype in (torch.float32, torch.float64):
            errs = kc.check_k2(dtype, dev, variant)
            out[f"{variant}_{str(dtype)[6:]}"] = {
                k: {"err": e, "max_abs_err": m} for k, (e, m) in errs.items()}
        rec[name].update(
            shape=list(kc.K2_SHAPES[variant]),
            max_abs_err=max(v["max_abs_err"]
                            for v in out[f"{variant}_float32"].values()),
            **k2_times(dev, variant), shapes=[])
        out[f"{variant}_times_float32"] = {f: rec[name][f] for f in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}
    log(out)


def variant_launches(launches):
    from slslam_tpu_torch.ops.kernels import VARIANTS
    return {v: launches[f"fused_eval/{v}"] for v in VARIANTS}


def phase3(dev):
    import numpy as np
    import torch
    from slslam_tpu_torch.bench import bench_config, workload
    from slslam_tpu_torch.engine.batch import BatchSlam
    from slslam_tpu_torch.engine.refine import global_refine
    from slslam_tpu_torch.ops import kernels
    from slslam_tpu_torch.ops.ransac import gumbel_noise
    cfg = bench_config("float64")
    frames, _ = workload(cfg, 60, 4)
    H = cfg.ransac_num_hypotheses

    def hook(fidx, Lp=81):
        g = torch.Generator().manual_seed(1000 + fidx)
        return gumbel_noise(g, (H, Lp), torch.float64, "cpu")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gpu = BatchSlam(cfg, device=dev, gumbel_hook=hook).run(frames)
    t_gpu = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    cpu = BatchSlam(cfg, device="cpu", gumbel_hook=hook).run(frames)
    t_cpu = time.perf_counter() - t0
    differ = np.flatnonzero(gpu.per_frame["ba_iters"]
                            != cpu.per_frame["ba_iters"]).tolist()
    dtraj = max(float(np.linalg.norm(a.t - b.t))
                for a, b in zip(gpu.trajectory, cpu.trajectory))
    log({"phase": 3, "frames": len(frames), "kf": gpu.kf_count,
         "max_traj_diff_m": dtraj, "ba_iters_differ_at": differ,
         "launches_cuda": launches, "wall_cuda_s": t_gpu,
         "wall_cpu_s": t_cpu})
    if not np.array_equal(gpu.is_kf, cpu.is_kf):
        raise AssertionError("phase 3: is_kf differs between CUDA and CPU")
    if not np.array_equal(gpu.per_frame["ransac_score"],
                          cpu.per_frame["ransac_score"]):
        raise AssertionError("phase 3: ransac_score differs")
    if len(gpu.trajectory) != len(cpu.trajectory) or not dtraj <= 1e-6:
        raise AssertionError(f"phase 3: trajectories differ by {dtraj} m")
    idle = [v for v, n in variant_launches(launches).items()
            if n == 0 and v != "lm"]
    if idle:
        raise AssertionError(f"phase 3: K2 variants never launched: {idle}")

    # the refine of that replay with the bench's rounds, CUDA against CPU,
    # from one trajectory.  (A single round stops at its LM cap in the
    # slice's slow-descent valley, short of convergence, so its two results
    # are not held to 1e-6 m: PERF.md, PR 3.)
    def refine(device):
        t0 = time.perf_counter()
        ref = global_refine(frames, gpu.is_kf, gpu.trajectory, config=cfg,
                            rounds=REFINE_ROUNDS, method="cg", device=device)
        return ref, time.perf_counter() - t0

    kernels.reset_launch_counts()
    ref_gpu, t_gpu = refine(dev)
    n_lm = kernels.launch_counts["fused_eval/lm"]
    n_schur = {k: kernels.launch_counts[k] for k in kernels.SCHUR_KERNELS}
    ref_cpu, t_cpu = refine("cpu")
    dref = max(float(np.linalg.norm(x.t - y.t))
               for x, y in zip(ref_gpu.trajectory, ref_cpu.trajectory))
    log({"phase": 3, "refine": f"cg, {REFINE_ROUNDS} rounds, float64",
         "max_traj_diff_m": dref,
         "lm_iterations_cuda": ref_gpu.iterations,
         "lm_iterations_cpu": ref_cpu.iterations,
         "lm_launches": n_lm, "schur_launches": n_schur,
         "wall_cuda_s": t_gpu, "wall_cpu_s": t_cpu})
    if not dref <= 1e-6:
        raise AssertionError(f"phase 3: refined trajectories differ by "
                             f"{dref} m")
    if ref_gpu.iterations != ref_cpu.iterations:
        raise AssertionError("phase 3: refine LM iterations differ")
    if n_lm == 0:
        raise AssertionError("phase 3: the refine never launched K2 lm")
    if min(n_schur.values()) == 0:
        raise AssertionError(f"phase 3: the refine's PCG never launched K3 "
                             f"or K4: {n_schur}")


@contextlib.contextmanager
def counting(modules, names, count, when=lambda *a, **k: True):
    """Wrap ``module.name`` for each module and name so that each call
    for which ``when(*args)`` holds adds one to ``count[name]``."""
    saved = []
    for module in modules:
        for name in names:
            orig = getattr(module, name)

            def wrapped(*a, _orig=orig, _name=name, **k):
                if when(*a, **k):
                    count[_name] += 1
                return _orig(*a, **k)

            saved.append((module, name, orig))
            setattr(module, name, wrapped)
    try:
        yield count
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)


def phase4(dev):
    import numpy as np
    import torch
    from slslam_tpu_torch.bench import ate, bench_config, workload
    from slslam_tpu_torch.engine import batch
    from slslam_tpu_torch.ops import kernels, residuals
    cfg = bench_config("float32")
    frames, poses = workload(cfg, 400, 4)
    eng = batch.BatchSlam(cfg, device=dev)
    # warm-up outside the timed window: the first float32 frames load their
    # CUDA modules and solver state
    eng.run(frames[:WARMUP_FRAMES])
    torch.cuda.synchronize()
    calls = dict.fromkeys(JAC_HELPERS + ("lines_gn", "local_ba"), 0)
    with contextlib.ExitStack() as stack:
        stack.enter_context(counting(
            (kernels, residuals), JAC_HELPERS, calls,
            when=lambda cw, *a, **k: cw.device.type == "cuda"))
        stack.enter_context(counting((batch,), ("lines_gn", "local_ba"),
                                     calls))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        shapes = dict(kernels.launch_shapes)
    ate_raw = ate(res.trajectory, poses)
    lm_iters = int(np.sum(res.per_frame["ba_iters"]))
    by_variant = variant_launches(launches)
    jac_cuda = sum(calls[k] for k in JAC_HELPERS)
    out = {"phase": 4, "frames": len(frames), "kf": res.kf_count,
           "landmarks": res.stats["num_landmarks"], "wall_s": wall,
           "kf_per_s": res.kf_count / wall, "ate_raw_m": ate_raw,
           "avg_ba_iterations": res.stats["avg_num_iterations"],
           "window_lm_iterations": lm_iters, "lines_gn_calls":
           calls["lines_gn"], "window_ba_calls": calls["local_ba"],
           "jacobian_helper_calls_cuda": jac_cuda,
           "launches": launches}
    log(out)
    finite = all(np.all(np.isfinite(T.t)) and np.all(np.isfinite(T.R))
                 for T in res.trajectory)
    checks = {
        "400 keyframes": res.kf_count == 400,
        "74 landmarks": res.stats["num_landmarks"] == 74,
        "finite poses": finite,
        "raw ATE <= 0.55 m": ate_raw <= 0.55,
        "full launches == LM iterations": by_variant["full"] == lm_iters,
        "lines launches == lines_gn_iters x calls":
            by_variant["lines"] == cfg.lines_gn_iters * calls["lines_gn"],
        "0 < cams launches <= moba_max_iter x frames":
            0 < by_variant["cams"] <= cfg.moba_max_iter * len(frames),
        "no lm launch in the replay": by_variant["lm"] == 0,
        "K1 launched": launches["segment_sum"] > 0,
        "plans built": launches["segment_plan"] > 0,
        "no torch.func Jacobians on CUDA": jac_cuda == 0,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 4 failed: {failed}")
    return frames, poses, res, wall, launches, shapes


def phase5(dev, rec, replay):
    """The global refine at full width on phase 4's replay."""
    import numpy as np
    import torch
    from slslam_tpu_torch.bench import ate, bench_config
    from slslam_tpu_torch.engine import refine
    from slslam_tpu_torch.ops import kernels, residuals, schur_cg
    frames, poses, res, replay_wall, launches4, shapes4 = replay
    cfg = bench_config("float32")
    s = refine.build_problem_structure(frames, res.is_kf)
    pack = schur_cg.pack_line_major(s.obs, s.ocam, s.olin, len(res.is_kf),
                                    len(s.feat_ids))
    solves = []
    pcg_counts = []
    calls = dict.fromkeys(JAC_HELPERS + ("local_ba",), 0)

    def record(orig):
        def wrapped(*a, **k):
            out = orig(*a, **k)
            solves.append((int(out[2].iterations),
                           int(out[2].cg_iterations)))
            return out
        return wrapped

    def counted(orig):
        # each PCG launch's count, kept on the device until the refine ends
        def wrapped(*a, **k):
            out = orig(*a, **k)
            pcg_counts.append(out[1])
            return out
        return wrapped

    saved = refine.global_ba_cg, schur_cg.schur_pcg
    refine.global_ba_cg = record(saved[0])
    schur_cg.schur_pcg = counted(saved[1])
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(counting(
                (kernels, residuals), JAC_HELPERS, calls,
                when=lambda cw, *a, **k: cw.device.type == "cuda"))
            stack.enter_context(counting((refine,), ("local_ba",), calls))
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            ref = refine.global_refine(frames, res.is_kf, res.trajectory,
                                       config=cfg, rounds=REFINE_ROUNDS,
                                       device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.launch_counts)
            shapes5 = dict(kernels.launch_shapes)
    finally:
        refine.global_ba_cg, schur_cg.schur_pcg = saved
    n_lm = sum(i for i, _ in solves)
    n_cg = sum(c for _, c in solves)
    n_it = int(sum(int(c) for c in pcg_counts))
    jac_cuda = sum(calls[k] for k in JAC_HELPERS)
    ate_raw, ate_ref = ate(res.trajectory, poses), ate(
        ref.trajectory, poses)
    T0 = ref.trajectory[0]
    log({"phase": 5, "refine": f"cg, {REFINE_ROUNDS} rounds, float32",
         "wall_s": wall, "solves": len(solves),
         "lm_iterations_per_solve": [i for i, _ in solves],
         "pcg_iterations_per_solve": [c for _, c in solves],
         "lm_iterations": n_lm, "pcg_iterations": n_cg,
         "pcg_iterations_of_the_launches": n_it,
         "refine_iterations": ref.iterations, "O": len(s.obs),
         "kL": pack.kL, "kC": pack.kC, "fill": pack.fill,
         "initial_cost": ref.initial_cost, "final_cost": ref.final_cost,
         "ate_raw_m": ate_raw, "ate_refined_m": ate_ref,
         "replay_s": replay_wall,
         "replay_refine_kf_per_s": res.kf_count / (replay_wall + wall),
         "jacobian_helper_calls_cuda": jac_cuda, "launches": launches})
    checks = {
        "the CG path": calls["local_ba"] == 0
            and len(solves) == REFINE_ROUNDS + 1,
        "final cost < initial cost": ref.final_cost < ref.initial_cost,
        "keyframe 0 at identity": bool(
            np.allclose(T0.R, np.eye(3), atol=1e-12)
            and np.allclose(T0.t, 0.0, atol=1e-12)),
        "refined ATE <= 0.01 m": ate_ref <= 0.01,
        "lm launches == LM iterations":
            launches["fused_eval/lm"] == n_lm > 0,
        "schur_pcg == K3 line == K3 camera == K4 == LM iterations":
            launches["schur_pcg"] == launches["schur_matvec/line"]
            == launches["schur_matvec/cam"] == launches["schur_jacobi"]
            == n_lm == len(pcg_counts),
        "sum of the launches' PCG counts == CGStats' PCG iterations":
            n_it == n_cg > 0,
        "no K1 in the refine (no priors)": launches["segment_sum"] == 0,
        "two plans per solve": launches["segment_plan"] == 2 * len(solves),
        "no torch.func Jacobians on CUDA": jac_cuda == 0,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 5 failed: {failed}")
    by_path = {name: {"replay": launches4[name], "refine": launches[name]}
               for name in launches}
    for name, split in by_path.items():
        rec[name]["launches"] = split["replay"] + split["refine"]
        rec[name]["launches_by_path"] = split
    # every timed house shape: its launches in the replay and the refine
    for name in rec:
        for r in [rec[name]] + rec[name]["shapes"]:
            key = (name, tuple(r["shape"]))
            r["launches_at_shape"] = shapes4.get(key, 0) + shapes5.get(key, 0)


def _span_hook(seed=0x10C):
    """Span-solve noise made on the CPU from (seed, keyframe), the same on
    every device: the CUDA and CPU post-passes of phase 6 take it."""
    import torch
    from slslam_tpu_torch.ops.ransac import gumbel_noise

    def hook(k, H, N):
        g = torch.Generator().manual_seed((seed << 32) + int(k))
        return gumbel_noise(g, (H, N), torch.float64, "cpu")
    return hook


def _lc_summary(out):
    return {k: out.stats[k] for k in (
        "num_loop_candidates", "num_loop_spans", "num_loop_closures",
        "num_merged_tracks", "pgo_iterations", "num_joint_solves",
        "refine_pick")}


def phase6(dev):
    """Loop-closure mode at full size; returns its launch counts."""
    import numpy as np
    import torch
    from slslam_tpu_torch import bench
    from slslam_tpu_torch.engine import batch_lc, refine
    from slslam_tpu_torch.ops import kernels
    cfg = bench.lc_config("float32")
    frames, poses, src, assigner, vocab, params = bench.lc_workload(cfg)
    # the main path: BatchSlamLC.run, as BENCH_MODE=lc drives it
    eng = bench.lc_engine(cfg, src, vocab, params, dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    launch_shapes = dict(kernels.launch_shapes)
    res = out.base
    gt = [poses[i] for i in np.flatnonzero(res.is_kf)]
    ate_odo = bench.ate(res.trajectory, gt)
    ate_fin = bench.ate(out.trajectory, gt)
    seg = assigner.track_to_seg
    bad_merges = [a for a, r in out.merged_fids.items() if seg[a] != seg[r]]
    # two post-passes over that replay with one descriptor list: the
    # post-pass's own launches and solve shapes, and its repeat bit for bit
    pre = [src(i, sorted(fr)) for i, fr in enumerate(frames)]
    ba_shapes = {}

    def record(orig):
        def wrapped(cam, line, obs, *a, **k):
            key = (f"{tuple(cam.shape)[0]}x{tuple(line.shape)[0]}x"
                   f"{tuple(obs.shape)[0]}"
                   + (" priors" if k.get("prior_edges") is not None else ""))
            ba_shapes[key] = ba_shapes.get(key, 0) + 1
            return orig(cam, line, obs, *a, **k)
        return wrapped

    # the merged refine's CG solves: (LM, PCG iterations, with priors, K1
    # launches during the solve)
    refine_solves = []

    def record_solve(orig):
        def wrapped(*a, **k):
            k1 = kernels.launch_counts["segment_sum"]
            out = orig(*a, **k)
            refine_solves.append((
                int(out[2].iterations), int(out[2].cg_iterations),
                k.get("prior_c") is not None
                or k.get("prior_edges") is not None,
                kernels.launch_counts["segment_sum"] - k1))
            return out
        return wrapped

    posts = []
    for rep in range(2):
        kernels.reset_launch_counts()
        saved = batch_lc.local_ba, refine.global_ba_cg
        if rep == 0:
            batch_lc.local_ba = record(saved[0])
            refine.global_ba_cg = record_solve(saved[1])
        try:
            t0 = time.perf_counter()
            p = bench.lc_engine(cfg, src, vocab, params, dev).post_pass(
                frames, res, pre_desc=pre)
            torch.cuda.synchronize()
        finally:
            batch_lc.local_ba, refine.global_ba_cg = saved
        posts.append((p, time.perf_counter() - t0,
                      dict(kernels.launch_counts)))
    (p1, w1, post_launches), (p2, _, _) = posts
    repeat = (p1.stats["num_loop_closures"] == p2.stats["num_loop_closures"]
              and p1.merged_fids == p2.merged_fids
              and all(np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t)
                      for a, b in zip(p1.trajectory, p2.trajectory)))
    log({"phase": 6, "workload": f"village lc, {len(frames)} frames, float32",
         "nvidia_smi": nvidia_smi(), "kf": res.kf_count, "wall_s": wall,
         "kf_per_s": res.kf_count / wall, **_lc_summary(out),
         "ate_odometry_m": ate_odo, "ate_final_m": ate_fin,
         "refine_loop_frac": out.stats["refine_loop_frac"],
         "walls": {k: out.stats[k] for k in bench.LC_WALLS},
         "wall_confirm_stages": out.stats["wall_confirm_stages"],
         "launches": launches, "post_pass_wall_s": w1,
         "post_pass_launches": post_launches,
         "post_pass_local_ba_shapes_CxLxO": ba_shapes,
         "refine_C_L_O": [p1.refined.num_cams, p1.refined.num_lines,
                          p1.refined.num_obs],
         "post_pass_summary": _lc_summary(p1),
         "refine_solves_lm_pcg_priors_k1": refine_solves,
         "repeat_bit_for_bit": repeat})
    by_variant = variant_launches(post_launches)
    checks = {
        ">= 7 loop closures": out.stats["num_loop_closures"] >= 7,
        "merges on one world segment": not bad_merges,
        "final ATE < odometry ATE": ate_fin < ate_odo,
        "post-pass launched cams, full, lm": min(
            by_variant[v] for v in ("cams", "full", "lm")) > 0,
        "post-pass launched K1": post_launches["segment_sum"] > 0,
        "post-pass launched K3 and K4": min(
            post_launches[k] for k in kernels.SCHUR_KERNELS) > 0,
        "the merged refine solved with priors and PCG iterations": any(
            pri and cg > 0 for _, cg, pri, _ in refine_solves),
        "K1 in a refine solve: 2 a LM iteration with priors (prior_terms), "
        "none a PCG iteration": all(
            k1 == (2 * lm if pri else 0)
            for lm, _, pri, k1 in refine_solves),
        "post-pass repeats bit for bit": repeat,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 6 failed: {failed}")

    # the post-pass in f64 on that replay, CUDA against CPU
    cfg64 = bench.lc_config("float64")
    cmp = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        o = bench.lc_engine(cfg64, src, vocab, params, d,
                            gumbel_hook=_span_hook()).post_pass(
            frames, res, pre_desc=pre)
        cmp[str(d)] = (o, time.perf_counter() - t0)
    (og, tg), (oc, tc) = cmp[str(dev)], cmp["cpu"]
    dtraj = max(float(np.linalg.norm(a.t - b.t))
                for a, b in zip(og.trajectory, oc.trajectory))
    log({"phase": 6, "post_pass": "float64, CUDA vs CPU",
         "cuda": _lc_summary(og), "cpu": _lc_summary(oc),
         "max_traj_diff_m": dtraj, "wall_cuda_s": tg, "wall_cpu_s": tc,
         "refine_wall_cpu_s": oc.stats["wall_refine_s"],
         "ate_final_m": bench.ate(og.trajectory, gt)})
    if _lc_summary(og) != _lc_summary(oc):
        raise AssertionError("phase 6: f64 post-pass decisions differ "
                             "between CUDA and CPU")
    if og.merged_fids != oc.merged_fids:
        raise AssertionError("phase 6: f64 merges differ")
    if not dtraj <= 1e-6:
        raise AssertionError(f"phase 6: f64 trajectories differ by {dtraj} m")
    refined = out.refined
    return launches, launch_shapes, (refined.num_cams, refined.num_lines,
                                     refined.num_obs)


def shape_kernels(dev, rec, launches, launch_shapes, role, phase,
                  refine_cl_o=None):
    """Every kernel at every shape a path launched it at (its
    ``kernels.launch_shapes``): against its twin in float32 and float64 at
    K1_TOL / K2_TOL (the plan: identical), then timed in float32 as phases
    1 and 2 time the house shapes.  ``lm``'s, K3's and K4's cases pad the
    share of rows that the merged refine's packing pads (its (C, L, valid
    rows) is ``refine_cl_o``); K3's passes and K4 share one check and
    timing a case (``schur_checks``).  Each shape goes to its kernel's ``shapes`` with
    ``role`` and its launches in that path."""
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    covered = dict.fromkeys(launches, 0)
    worst = {}
    t0 = time.perf_counter()
    for (name, shape), n in sorted(launch_shapes.items()):
        covered[name] += n
        C, L, O = shape if len(shape) == 3 else (0, 0, 0)
        pad = 0.008
        if (refine_cl_o is not None and (C, L) == refine_cl_o[:2]
                and name not in ("segment_plan", "segment_sum")):
            pad = 1.0 - refine_cl_o[2] / O
        if name == "schur_pcg":
            by_dtype, times = pcg_checks(dev, shape, pad, role == "lc")
            errs = {k: e["max_abs_err"] for k, e in by_dtype.items()}
            for k, e in by_dtype.items():
                worst[name, k] = max(worst.get((name, k), 0.0), e["err"])
        elif name in kernels.SCHUR_KERNELS:
            by_dtype, by_name = schur_checks(dev, shape, pad)
            errs = {}
            for key, e in by_dtype.items():
                mine = [v for k, v in e.items() if k.startswith(name + " ")]
                errs[key] = max(m for _, m in mine)
                worst[name, key] = max(worst.get((name, key), 0.0),
                                       *(err for err, _ in mine))
            times = by_name[name]
        elif name == "segment_plan":
            (_, diff), = kc.check_plans(dev, [shape])
            errs = {"plan": float(diff)}
            times = plan_times(dev, *shape)
        elif name == "segment_sum":
            errs = {}
            for dtype in (torch.float32, torch.float64):
                for (*_, with_plan), err, max_abs in kc.check_k1(
                        dtype, dev, [shape]):
                    key = str(dtype)[6:]
                    errs[key] = max(errs.get(key, 0.0), max_abs)
                    worst[name, key] = max(worst.get((name, key), 0.0), err)
            times = k1_times(dev, *shape)
        else:
            variant = name.split("/")[1]
            errs = {}
            for dtype in (torch.float32, torch.float64):
                key = str(dtype)[6:]
                for err, max_abs in kc.check_k2(dtype, dev, variant, shape,
                                                pad).values():
                    errs[key] = max(errs.get(key, 0.0), max_abs)
                    worst[name, key] = max(worst.get((name, key), 0.0), err)
            times = k2_times(dev, variant, shape, pad)
        rec[name]["shapes"].append(dict(
            shape=list(shape), role=role, launches_at_shape=n,
            max_abs_err=errs.get("float32", errs.get("plan")), **times))
    log({"phase": phase, f"kernels_at_{role}_shapes": {
        name: len([k for k in launch_shapes if k[0] == name])
        for name in launches},
        "worst_normalized_error": {f"{k[0]} {k[1]}": v
                                   for k, v in worst.items()},
        "check_and_time_s": time.perf_counter() - t0})
    if covered != launches:
        raise AssertionError(f"phase {phase}: launches by shape {covered} "
                             f"do not add up to the launches {launches}")


def _merge_shapes(acc, shapes):
    for k, v in shapes.items():
        acc[k] = acc.get(k, 0) + v


def _run_slam(slam, frames, start=0, on_frame=None):
    """Frames ``start``.. through ``slam``; returns the keyframes' frame
    indices."""
    kf = []
    for i in range(start, len(frames)):
        if slam.process_frame(frames[i], i):
            kf.append(i)
        if on_frame is not None:
            on_frame(i)
    return kf


def _cpu_gumbel(seed=0x7A7):
    """RANSAC noise made on the CPU from (seed, call index), the same on
    every device: phase 7's CUDA and CPU engines take it."""
    import torch
    from slslam_tpu_torch.ops.ransac import gumbel_noise

    def hook(i, H, Nb):
        g = torch.Generator().manual_seed((seed << 32) + int(i))
        return gumbel_noise(g, (H, Nb), torch.float64, "cpu")
    return hook


def _poses_equal(a, b):
    import numpy as np
    return len(a) == len(b) and all(
        np.array_equal(x.R, y.R) and np.array_equal(x.t, y.t)
        for x, y in zip(a, b))


def phase7(dev):
    """The interactive engine (``Slam``): (a) the house at full width in
    f32 (the main path, counted), (b) the interactive bench workload, (c)
    f64 parity CUDA vs CPU (orth, then aid with window anchors), (d)
    interactive loop closure on the village, (e) the checkpoint round trip
    of (a).  Returns (a)'s launches, every phase 7 run's launch shapes,
    and (a)'s and (c) orth's CUDA runs for phase 10 (a) and (b)."""
    import dataclasses
    import os
    import numpy as np
    import torch
    from slslam_tpu_torch import bench
    from slslam_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.engine import Slam
    from slslam_tpu_torch.engine import slam as slam_mod
    from slslam_tpu_torch.loopclosure import (PlaceRecognizer, VocTree,
                                              VocTreeParams)
    from slslam_tpu_torch.ops import kernels, residuals
    shapes7 = {}
    t_phase = time.perf_counter()

    # (a) the house, INTERACTIVE_FRAMES frames, render seed 4, 0.2 px, the
    # reference gates
    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float32")
    frames, poses = bench.workload(cfg, INTERACTIVE_FRAMES, 4)
    _run_slam(Slam(cfg, device=dev), frames[:WARMUP_FRAMES])   # warm-up
    torch.cuda.synchronize()
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(ckpt_dir, "interactive.npz")
    calls = dict.fromkeys(JAC_HELPERS + ("staged_local_ba",), 0)
    slam = Slam(cfg, device=dev)

    def save_at(i):
        if i == CHECKPOINT_FRAME:
            save_checkpoint(slam, ckpt)

    with contextlib.ExitStack() as stack:
        stack.enter_context(counting(
            (kernels, residuals), JAC_HELPERS, calls,
            when=lambda cw, *a, **k: cw.device.type == "cuda"))
        stack.enter_context(counting((slam_mod,), ("staged_local_ba",),
                                     calls))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        kf = _run_slam(slam, frames, on_frame=save_at)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        shapes_a = dict(kernels.launch_shapes)
    _merge_shapes(shapes7, shapes_a)
    traj = slam.trajectory()
    ate_a = bench.ate(traj, [poses[i] for i in kf])
    stats = slam.post_processing()
    by_variant = variant_launches(launches)
    jac_cuda = sum(calls[k] for k in JAC_HELPERS)
    log({"phase": 7, "run": f"(a) house, {INTERACTIVE_FRAMES} frames, "
         "float32, reference gates", "kf": len(kf),
         "landmarks": stats["num_landmarks"],
         "wall_s": wall, "kf_per_s": len(kf) / wall,
         "frames_per_s": len(frames) / wall, "ate_kf_m": ate_a,
         "ate_kf_m_jax_f64_cpu": JAX_INTERACTIVE_ATE_M,
         "window_lm_iterations": slam.sum_num_iteration,
         "window_solves": calls["staged_local_ba"],
         "vo_calls": slam.vo_calls, "jacobian_helper_calls_cuda": jac_cuda,
         "post_processing": stats, "launches": launches})
    checks = {
        "finite poses": all(np.all(np.isfinite(T.t))
                            and np.all(np.isfinite(T.R)) for T in traj),
        ">= 10 keyframes": len(kf) >= 10,
        "keyframe ATE <= 0.1 m": ate_a <= 0.1,
        "full launches == window LM iterations":
            by_variant["full"] == slam.sum_num_iteration > 0,
        "lines launches == lines_gn_iters x window solves":
            by_variant["lines"]
            == cfg.lines_gn_iters * calls["staged_local_ba"] > 0,
        "0 < cams launches <= moba_max_iter x VO calls":
            0 < by_variant["cams"] <= cfg.moba_max_iter * slam.vo_calls,
        "no lm launch": by_variant["lm"] == 0,
        "K1 launched": launches["segment_sum"] > 0,
        "no torch.func Jacobians on CUDA": jac_cuda == 0,
        "native embedding walker": stats["embedding_walker"] == "native",
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 7 (a) failed: {failed}")

    # (b) the port's BENCH_MODE=interactive workload
    kernels.reset_launch_counts()
    kf_per_s, rec_b = bench.bench_interactive(dev)
    _merge_shapes(shapes7, kernels.launch_shapes)
    log({"phase": 7, "run": "(b) BENCH_MODE=interactive",
         "kf_per_s_median": kf_per_s,
         **{k: rec_b[k] for k in (
             "median_frame_ms", "mean_rate_kf_s", "vo_mean_ms",
             "ba_mean_ms", "avg_ba_iterations", "keyframes",
             "measured_frames", "post_processing")}})

    # (c) f64 parity, CUDA vs CPU, one noise stream: orth, then aid with
    # window anchors
    parity = {}
    for name, extra in (("orth", {}), ("aid + anchors", dict(
            line_param="aid", window_anchor_sigma_rot=0.01,
            window_anchor_sigma_t=0.05))):
        cfg64 = dataclasses.replace(SlamConfig(), compute_dtype="float64",
                                    **extra)
        fr64, _ = bench.workload(cfg64, PARITY_FRAMES, 4)
        runs = {}
        for d in (dev, "cpu"):
            kernels.reset_launch_counts()
            s = Slam(cfg64, device=d, gumbel_hook=_cpu_gumbel())
            t0 = time.perf_counter()
            k = _run_slam(s, fr64)
            runs[str(d)] = (s, k, time.perf_counter() - t0)
            if d == dev:
                _merge_shapes(shapes7, kernels.launch_shapes)
        (sg, kg, tg), (sc, kc_, tc) = runs[str(dev)], runs["cpu"]
        dtraj = max(float(np.linalg.norm(a.t - b.t))
                    for a, b in zip(sg.trajectory(), sc.trajectory()))
        parity[name] = {"kf": len(kg), "lm_iterations_cuda":
                        sg.sum_num_iteration, "lm_iterations_cpu":
                        sc.sum_num_iteration, "max_traj_diff_m": dtraj,
                        "wall_cuda_s": tg, "wall_cpu_s": tc}
        if (kg != kc_ or sg.state.edge_set != sc.state.edge_set
                or sg.sum_num_iteration != sc.sum_num_iteration
                or sorted(sg.state.lms) != sorted(sc.state.lms)):
            raise AssertionError(f"phase 7 (c) {name}: keyframes, edges, "
                                 "landmarks or LM iterations differ")
        if not dtraj <= 1e-6:
            raise AssertionError(f"phase 7 (c) {name}: trajectories differ "
                                 f"by {dtraj} m")
        if name == "orth":
            ref_b = {"kf": kg, "edges": sorted(sg.state.edge_set),
                     "iters": sg.sum_num_iteration,
                     "traj": sg.trajectory()}
    log({"phase": 7, "run": f"(c) f64 parity, {PARITY_FRAMES} house "
         "frames, CUDA vs CPU", **parity})

    # (d) interactive loop closure (tests/test_lc_e2e.py:63-83), float32
    cfg_lc = dataclasses.replace(
        SlamConfig(), compute_dtype="float32", ransac_num_hypotheses=64,
        corr_buckets=(64, 128), obs_buckets=(512, 1024, 2048),
        line_buckets=(256, 512))
    fr_lc, poses_lc, src, _, vocab, _ = bench.lc_workload(
        cfg_lc, 120, 3.2, orbit_radius=3.5)
    params = VocTreeParams(non_consider_recent=8, consider_seq_length=3,
                           threshold=0.25, num_avg_words=30)
    s = Slam(cfg_lc, device=dev)
    s.place_recognizer = PlaceRecognizer(VocTree(vocab, params, device=dev),
                                         min_matches=8, min_similarity=0.8)
    s.descriptor_source = src
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    kf_lc = _run_slam(s, fr_lc)
    torch.cuda.synchronize()
    wall_lc = time.perf_counter() - t0
    _merge_shapes(shapes7, kernels.launch_shapes)
    ate_lc = bench.ate(s.trajectory(), [poses_lc[i] for i in kf_lc])
    log({"phase": 7, "run": "(d) interactive loop closure, village, 120 "
         "frames, float32", "kf": len(kf_lc), "lc_cnt": s.lc_cnt,
         "edges": len(s.state.edge_set), "pgo_ran": s.pgo_runs > 0,
         "pgo_runs": s.pgo_runs, "ate_kf_m": ate_lc, "wall_s": wall_lc,
         "launches": dict(kernels.launch_counts)})
    checks = {"lc_cnt >= 1": s.lc_cnt >= 1,
              "an edge beyond the odometry chain":
                  len(s.state.edge_set) >= len(kf_lc),
              "ATE < 0.2 m": ate_lc < 0.2}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 7 (d) failed: {failed}")

    # (e) the checkpoint of (a) after frame CHECKPOINT_FRAME, resumed
    kernels.reset_launch_counts()
    fresh = Slam(cfg, device=dev)
    load_checkpoint(fresh, ckpt)
    kf_e = _run_slam(fresh, frames, start=CHECKPOINT_FRAME + 1)
    _merge_shapes(shapes7, kernels.launch_shapes)
    same = (_poses_equal(fresh.trajectory(), traj)
            and kf_e == [i for i in kf if i > CHECKPOINT_FRAME]
            and fresh.sum_num_iteration == slam.sum_num_iteration)
    log({"phase": 7, "run": f"(e) checkpoint after frame "
         f"{CHECKPOINT_FRAME} of (a), resumed", "bit_for_bit": same,
         "kf_after": len(kf_e), "phase_7_runs_s":
         time.perf_counter() - t_phase})
    if not same:
        raise AssertionError("phase 7 (e): the resumed run differs from "
                             "the straight run")
    ref_a = {"kf": len(kf), "window_lm_iterations": slam.sum_num_iteration,
             "ate_kf_m": ate_a, "wall_s": wall}
    return launches, shapes7, {"a": ref_a, "b": ref_b}


def _load_tool(name):
    """tools/<name>.py as a module (tools/ is no package)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _angle_gap(a, b):
    import numpy as np
    return np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))


def phase8a(dev, images):
    """(a) the front-end's device stages on the card against the same
    functions on the CPU, on the first rendered house frames."""
    import numpy as np
    from slslam_tpu_torch.frontend.descriptor import describe
    from slslam_tpu_torch.frontend.detector import LineSegmentDetector
    det_gpu = LineSegmentDetector(device=dev)
    det_cpu = LineSegmentDetector(device="cpu")
    worst = dict.fromkeys(("mag", "angle", "describe"), 0.0)
    seg_gap, counts, same_host = 0.0, [], True
    for pair in images:
        for img in pair:
            segs, mag, ang = det_gpu.detect_with_gradients(img)
            segs_c, mag_c, ang_c = det_cpu.detect_with_gradients(img)
            m, a = mag.cpu().numpy(), ang.cpu().numpy()
            mc, ac = mag_c.numpy(), ang_c.numpy()
            read = mc >= det_cpu.mag_threshold
            worst["mag"] = max(worst["mag"], float(np.abs(m - mc).max()))
            worst["angle"] = max(worst["angle"],
                                 float(_angle_gap(a, ac)[read].max()))
            # the descriptor on identical inputs (the CPU's maps, the CPU's
            # segments) on both devices
            d_gpu = describe(mag_c.to(dev), ang_c.to(dev), segs_c)
            d_cpu = describe(mag_c, ang_c, segs_c)
            worst["describe"] = max(worst["describe"],
                                    float(np.abs(d_gpu - d_cpu).max()))
            # the host stages fed the card's maps give the card's segments
            same_host &= bool(np.array_equal(det_cpu.segments(m, a), segs))
            counts.append([len(segs), len(segs_c)])
            if len(segs) == len(segs_c):
                seg_gap = max(seg_gap, float(np.abs(segs - segs_c).max()))
    out = {"phase": 8, "run": "(a) front-end stages, card vs CPU, "
           f"{len(images)} house frames", "max_abs_err": worst,
           "tolerance": {"mag": FE_MAG_TOL, "angle_rad": FE_ANGLE_TOL,
                         "describe": FE_DESC_TOL},
           "segments_card_cpu": counts, "max_endpoint_gap_px": seg_gap,
           "host_stages_on_card_maps_identical": same_host,
           "grower": det_gpu.grower}
    log(out)
    checks = {"mag": worst["mag"] <= FE_MAG_TOL,
              "angle": worst["angle"] <= FE_ANGLE_TOL,
              "describe": worst["describe"] <= FE_DESC_TOL,
              "host stages identical on the card's maps": same_host,
              "native grower": det_gpu.grower == "native"}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 8 (a) failed: {failed}")


def phase8(dev):
    """The image front-end (P11): (a) its device stages card vs CPU, (b)
    the front-end bench workload (tools/torch_frontend_bench.py: 60
    rendered frames -> matcher -> BatchSlam -> refine, f32), (c) ``cli
    track`` over rendered PNGs through ``Slam`` at ``SlamConfig()``'s gates
    in f32 (the main path, counted), (d) the interactive PGO case, card vs
    CPU in f64.  Returns the launches of (c) and of (b) and their launch
    shapes."""
    import dataclasses
    import os
    import tempfile
    import numpy as np
    import torch
    from PIL import Image
    from slslam_tpu_torch import bench, cli
    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch import engine
    from slslam_tpu_torch.engine import slam as slam_mod
    from slslam_tpu_torch.ops import kernels, residuals
    fb = _load_tool("torch_frontend_bench")
    t_phase = time.perf_counter()
    shapes8 = {}

    # (b) first: its rendered frames also feed (a)
    kernels.reset_launch_counts()
    rec_b, _, _, _ = fb.run(FRONTEND_FRAMES, 1, dev, profile=True)
    launches_b = dict(kernels.launch_counts)
    _merge_shapes(shapes8, kernels.launch_shapes)
    cfg_b = fb.frontend_config()
    images, _ = fb.render(cfg_b, FE_CHECK_FRAMES)
    phase8a(dev, images)
    log({"phase": 8, "run": f"(b) front-end bench, {FRONTEND_FRAMES} "
         "house frames, float32", **{k: v for k, v in rec_b.items()
                                     if k != "profile"},
         "device_busy": {k: rec_b["profile"][k] for k in (
             "wall_s", "profiled_wall_s", "device_busy_s", "device_ops",
             "top_device")},
         "launches": launches_b})
    checks = {"tracks per frame > 20": rec_b["mean_tracks_per_frame"] > 20,
              "refined ATE < 0.35 m": rec_b["ate_refined_m"] < 0.35,
              "every frame a keyframe":
                  rec_b["keyframes"] == FRONTEND_FRAMES,
              "native grower": rec_b["grower"] == "native"}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 8 (b) failed: {failed}")

    # (c) cli track over rendered PNGs, the reference gates, float32
    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float32")
    imgs_c, poses_c = fb.render(cfg, TRACK_FRAMES, TRACK_STRIDE)
    with tempfile.TemporaryDirectory() as tmp:
        for side in ("left", "right"):
            os.makedirs(os.path.join(tmp, side))
        for i, pair in enumerate(imgs_c):
            for side, img in zip(("left", "right"), pair):
                Image.fromarray(np.clip(np.rint(img), 0, 255).astype(
                    np.uint8)).save(os.path.join(tmp, side, f"{i:04d}.png"))
        calls = dict.fromkeys(JAC_HELPERS + ("staged_local_ba",), 0)
        made = []

        def keep(*a, _slam=engine.Slam, **k):
            made.append(_slam(*a, **k))
            return made[-1]

        with contextlib.ExitStack() as stack:
            stack.enter_context(counting(
                (kernels, residuals), JAC_HELPERS, calls,
                when=lambda cw, *a, **k: cw.device.type == "cuda"))
            stack.enter_context(counting((slam_mod,), ("staged_local_ba",),
                                         calls))
            saved, engine.Slam = engine.Slam, keep
            kernels.reset_launch_counts()
            try:
                t0 = time.perf_counter()
                stats = cli.main(["track", "--left-dir",
                                  os.path.join(tmp, "left"), "--right-dir",
                                  os.path.join(tmp, "right"), "--device",
                                  str(dev), "--dtype", "float32", "--out",
                                  os.path.join(tmp, "out")])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                engine.Slam = saved
            launches = dict(kernels.launch_counts)
            _merge_shapes(shapes8, kernels.launch_shapes)
    slam, = made
    kf = stats["keyframe_frames"]
    traj = slam.trajectory()
    ate_c = bench.ate(traj, [poses_c[i] for i in kf])
    by_variant = variant_launches(launches)
    jac_cuda = sum(calls[k] for k in JAC_HELPERS)
    log({"phase": 8, "run": f"(c) cli track, {TRACK_FRAMES} rendered "
         f"house frames (stride {TRACK_STRIDE}), float32, reference gates",
         "kf": len(kf), "keyframe_frames": kf, "ate_kf_m": ate_c,
         "ate_kf_max_m": TRACK_ATE_MAX,
         "wall_s": wall, "frames_per_s": TRACK_FRAMES / wall,
         "window_solves": calls["staged_local_ba"],
         "window_lm_iterations": slam.sum_num_iteration,
         "vo_calls": slam.vo_calls, "jacobian_helper_calls_cuda": jac_cuda,
         "post_processing": {k: stats[k] for k in (
             "num_keyframes", "num_landmarks", "avg_num_iterations",
             "proc_pose_estimation_mean_s", "proc_local_ba_mean_s",
             "embedding_walker")}, "launches": launches})
    checks = {
        "keyframes in the CPU's band":
            TRACK_KEYFRAMES[0] <= len(kf) <= TRACK_KEYFRAMES[1],
        "finite poses": all(np.all(np.isfinite(T.t))
                            and np.all(np.isfinite(T.R)) for T in traj),
        "keyframe ATE within JAX's band": ate_c <= TRACK_ATE_MAX,
        "full launches == window LM iterations":
            by_variant["full"] == slam.sum_num_iteration > 0,
        "lines launches == lines_gn_iters x window solves":
            by_variant["lines"]
            == cfg.lines_gn_iters * calls["staged_local_ba"] > 0,
        "0 < cams launches <= moba_max_iter x VO calls":
            0 < by_variant["cams"] <= cfg.moba_max_iter * slam.vo_calls,
        "no lm launch": by_variant["lm"] == 0,
        "K1 launched": launches["segment_sum"] > 0,
        "no torch.func Jacobians on CUDA": jac_cuda == 0,
        "native embedding walker": stats["embedding_walker"] == "native",
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 8 (c) failed: {failed}")

    # (d) the interactive PGO case, card vs CPU in float64
    pgo = phase8d(dev)
    log({"phase": 8, "run": "(d) interactive PGO, village 80 frames, "
         "float64, card vs CPU", **pgo,
         "phase_8_runs_s": time.perf_counter() - t_phase})
    return launches, launches_b, shapes8


def phase8d(dev):
    """tests/test_torch_slam_pgo.py's run (the small village, 80 frames,
    consistency thresholds 2 cm / 0.01 rad) in float64.  The CPU's run
    keeps the engine as it stands before each pose-graph solve; each such
    solve then runs from that state on the card and on the CPU: keyframe
    poses within 1e-9 m.  The whole run on the card beside the CPU's (one
    RANSAC noise stream) must take the same keyframes and edges and run
    the PGO at the same frames, with trajectories within PGO_TRAJ_TOL:
    this run's window solves amplify rounding (tests/test_torch_slam_lc.py),
    so the whole runs are held to the CPU's own band under 1e-15 input
    changes (tools/jax_frontend_reference.py pgo), not to 1e-9 m."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from slslam_tpu_torch import bench
    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.engine import Slam
    from slslam_tpu_torch.loopclosure import (PlaceRecognizer, VocTree,
                                              VocTreeParams)
    from slslam_tpu_torch.sim import SegmentDescriptorSource
    cfg = dataclasses.replace(
        SlamConfig(), compute_dtype="float64", ransac_num_hypotheses=64,
        corr_buckets=(64, 128), obs_buckets=(512, 1024, 2048),
        line_buckets=(256, 512), pgo_consistency_tr_thr=0.02,
        pgo_consistency_rot_thr=0.01)
    frames, _, src, assigner, vocab, _ = bench.lc_workload(
        cfg, PGO_FRAMES, 3.2 * PGO_FRAMES / 120, orbit_radius=3.5)
    params = VocTreeParams(non_consider_recent=8, consider_seq_length=3,
                           threshold=0.25, num_avg_words=30)

    def make(d):
        s = Slam(cfg, device=d, gumbel_hook=_cpu_gumbel())
        s.place_recognizer = PlaceRecognizer(VocTree(vocab, params, device=d),
                                             min_matches=8,
                                             min_similarity=0.8)
        s.descriptor_source = SegmentDescriptorSource(
            assigner, len(src.base), noise=0.01, seed=7)
        return s

    # the CPU's run and its states before each solve; the frames of the
    # solves on both sides
    cpu = make("cpu")
    before, pgo_frames = [], {"cpu": [], "cuda": []}

    def keep_state(_orig=cpu.pose_optimization):
        before.append(copy.deepcopy(cpu))
        pgo_frames["cpu"].append(cpu.frame_id)
        _orig()

    cpu.pose_optimization = keep_state
    t0 = time.perf_counter()
    k_cpu = [i for i in range(len(frames))
             if cpu.process_frame(frames[i], i)]
    t_cpu = time.perf_counter() - t0
    gpu = make(dev)

    def note_frame(_orig=gpu.pose_optimization):
        pgo_frames["cuda"].append(gpu.frame_id)
        _orig()

    gpu.pose_optimization = note_frame
    t0 = time.perf_counter()
    k_gpu = [i for i in range(len(frames))
             if gpu.process_frame(frames[i], i)]
    t_gpu = time.perf_counter() - t0

    solve_gaps = []
    for snap in before:
        poses = []
        for d in (dev, "cpu"):
            e = copy.deepcopy(snap)
            e.device = torch.device(d)
            Slam.pose_optimization(e)
            poses.append(np.stack([e.state.kfs[i].T.t
                                   for i in sorted(e.state.kfs)]))
        solve_gaps.append(float(np.abs(poses[0] - poses[1]).max()))

    out = {"kf": len(k_cpu), "lc_cnt": cpu.lc_cnt,
           "pgo_runs_cuda": gpu.pgo_runs, "pgo_runs_cpu": cpu.pgo_runs,
           "pgo_frames": pgo_frames,
           "pgo_solve_gap_card_cpu_m": solve_gaps,
           "same_keyframes": k_gpu == k_cpu,
           "same_edges": gpu.state.edge_set == cpu.state.edge_set,
           "lm_iterations_cuda": gpu.sum_num_iteration,
           "lm_iterations_cpu": cpu.sum_num_iteration,
           "max_traj_diff_m": max(
               float(np.linalg.norm(x.t - y.t))
               for x, y in zip(gpu.trajectory(), cpu.trajectory())),
           "traj_tolerance_m": PGO_TRAJ_TOL,
           "wall_cuda_s": t_gpu, "wall_cpu_s": t_cpu}
    checks = {"the PGO ran": cpu.pgo_runs > 0 and gpu.pgo_runs > 0,
              "same PGO count": gpu.pgo_runs == cpu.pgo_runs,
              "same PGO frames": pgo_frames["cuda"] == pgo_frames["cpu"],
              "same keyframes": out["same_keyframes"],
              "same edges": out["same_edges"],
              "whole runs within PGO_TRAJ_TOL":
                  out["max_traj_diff_m"] <= PGO_TRAJ_TOL,
              "every solve from one state within 1e-9 m":
                  len(solve_gaps) == cpu.pgo_runs
                  and max(solve_gaps) <= 1e-9}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 8 (d) failed: {failed}; {out}")
    return out


def phase9a(dev, rec, lmb):
    """(a) The large map at full width: tools/torch_large_map_bench.py's
    path at LARGE_MAP in float32 (a cold and one warm solve, counted),
    gated on a float64 run of the same problem on the card; then every
    kernel at every shape it launched."""
    import numpy as np
    from slslam_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    args = lmb.parser().parse_args([*LARGE_MAP, "--warm-runs", "1"])
    host = lmb.build(args)
    kernels.reset_launch_counts()
    out32, cam32 = lmb.run(args, host)
    launches = dict(kernels.launch_counts)
    shapes = dict(kernels.launch_shapes)
    out64, cam64 = lmb.run(lmb.parser().parse_args(
        [*LARGE_MAP, "--dtype", "float64", "--warm-runs", "0"]), host)
    cost_rel = abs(out32["final_cost"] - out64["final_cost"]) / abs(
        out64["final_cost"])
    rpe_rel = abs(out32["rpe_final_m"] - out64["rpe_final_m"]) / abs(
        out64["rpe_final_m"])
    log({"phase": 9, "run": f"(a) large map {' '.join(LARGE_MAP)}, float32, "
         "a cold and one warm solve", "float32": out32,
         "launches": launches, "run_s": time.perf_counter() - t0})
    log({"phase": 9, "run": "(a) the same problem in float64 on the card",
         "float64": out64, "final_cost_rel_gap": cost_rel,
         "rpe_final_rel_gap": rpe_rel, "max_cam_gap": float(np.max(np.abs(
             cam32 - cam64))), "cost_rel_tol": LM_COST_RTOL,
         "rpe_rel_tol": LM_RPE_RTOL})
    finite = [k for k, v in out32.items()
              if isinstance(v, float) and not np.isfinite(v)]
    checks = {
        f"f32 final cost within {LM_COST_RTOL} of f64": cost_rel
        <= LM_COST_RTOL,
        f"f32 rpe_final_m within {LM_RPE_RTOL} of f64": rpe_rel
        <= LM_RPE_RTOL,
        "rpe_final_m < rpe_init_m": out32["rpe_final_m"] < out32["rpe_init_m"],
        "finite values": not finite and bool(np.all(np.isfinite(cam32))),
        "the plan, K2 lm, K3 and K4 launched": all(
            launches[k] > 0 for k in ("segment_plan", "fused_eval/lm",
                                      *kernels.SCHUR_KERNELS)),
        "two plans a solve": launches["segment_plan"] == 4,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 9 (a) failed: {failed} {finite}")
    shape_kernels(dev, rec, launches, shapes, "large_map", 9,
                  (out32["num_cams"], out32["num_lines"], out32["num_obs"]))
    return launches, shapes


def phase9b(dev, lmb):
    """(b) The large map at LM_PARITY in float64, the card (kernels)
    against the CPU (twins) from one problem: at LM_PARITY_ITERS the same
    LM and PCG iterations, cameras within 1e-6, final cost within 1e-9
    relative; at the tool's iterations the gaps logged."""
    import numpy as np
    from slslam_tpu_torch.ops import kernels
    out = {}
    for name, iters in (("gated", list(LM_PARITY_ITERS)), ("tool", [])):
        argv = [*LM_PARITY, *iters, "--dtype", "float64", "--warm-runs", "0"]
        host = lmb.build(lmb.parser().parse_args(argv))
        kernels.reset_launch_counts()
        outg, camg = lmb.run(lmb.parser().parse_args(
            argv + ["--device", str(dev)]), host)
        schur = {k: kernels.launch_counts[k] for k in kernels.SCHUR_KERNELS}
        outc, camc = lmb.run(lmb.parser().parse_args(
            argv + ["--device", "cpu"]), host)
        out[name] = {
            "iters": " ".join(iters) or "the tool's",
            "iterations": [outg["iterations"], outc["iterations"]],
            "cg_iterations": [outg["cg_iterations"], outc["cg_iterations"]],
            "max_cam_gap": float(np.max(np.abs(camg - camc))),
            "final_cost_rel_gap": abs(outg["final_cost"] - outc["final_cost"])
            / abs(outc["final_cost"]),
            "final_cost": outg["final_cost"],
            "rpe_final_m": outg["rpe_final_m"], "schur_launches_card": schur,
            "solve_s_card": outg["cold_s"], "solve_s_cpu": outc["cold_s"]}
    log({"phase": 9, "run": f"(b) large map {' '.join(LM_PARITY)}, float64, "
         "card vs CPU", **out})
    g = out["gated"]
    checks = {"the same LM iterations":
                  g["iterations"][0] == g["iterations"][1],
              "the same PCG iterations":
                  g["cg_iterations"][0] == g["cg_iterations"][1],
              "cameras within 1e-6": g["max_cam_gap"] <= 1e-6,
              "final cost within 1e-9 relative":
                  g["final_cost_rel_gap"] <= 1e-9,
              "the card's PCG launched K3 and K4": all(
                  min(o["schur_launches_card"].values()) > 0
                  for o in out.values())}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 9 (b) failed: {failed}")


def phase9c(dev):
    """(c) The parameterization study's ``run_one``, orth and aid, at the
    tool's defaults (STUDY_FRAMES frames, 0.2 px, window 10), float32,
    writing its files; each run counted from zero."""
    import os
    from slslam_tpu_torch.ops import kernels
    tps = _load_tool("torch_param_study")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke", "study")
    os.makedirs(out_dir, exist_ok=True)
    launches, shapes, runs = {}, {}, {}
    for param in ("orth", "aid"):
        kernels.reset_launch_counts()
        r = tps.run_one(param, 0.2, 10, STUDY_FRAMES, dev)
        _merge_shapes(launches, kernels.launch_counts)
        _merge_shapes(shapes, kernels.launch_shapes)
        tag = f"{param}_err0.2_basize10"
        tps.write_result(out_dir, tag, r)
        runs[tag] = {k: v for k, v in r.items() if k != "est_rows"}
        runs[tag]["files"] = sorted(f for f in os.listdir(out_dir)
                                    if tag in f)
    log({"phase": 9, "run": f"(c) parameterization study, {STUDY_FRAMES} "
         "house frames, float32", "runs": runs, "launches": launches})
    checks = {f"{tag} ATE <= {STUDY_ATE_MAX} m": r["ate"] <= STUDY_ATE_MAX
              for tag, r in runs.items()}
    checks.update({f"{tag} files": len(r["files"]) == 2
                   for tag, r in runs.items()})
    checks["K2 full, lines and cams launched"] = all(
        launches[f"fused_eval/{v}"] > 0 for v in ("full", "lines", "cams"))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 9 (c) failed: {failed}")
    return launches, shapes


def phase9d(dev):
    """(d) The scale LC tool at LC9_FRAMES frames, one run, no prefix
    curve, counted."""
    import numpy as np
    from slslam_tpu_torch.ops import kernels
    tsl = _load_tool("torch_scale_lc")
    kernels.reset_launch_counts()
    out, res = tsl.run(LC9_FRAMES, prefixes=False, device=dev, warm=False)
    launches = dict(kernels.launch_counts)
    shapes = dict(kernels.launch_shapes)
    log({"phase": 9, "run": f"(d) scale LC, {LC9_FRAMES} frames (cut from "
         "the tool's 1000 for the script's time), orbits 3.35, float32, "
         "one run", **out, "launches": launches})
    checks = {">= 7 loop closures": out["num_loop_closures"] >= 7,
              f"final ATE <= {LC9_ATE_MAX} m (JAX's band)":
                  out["ate_final_m"] <= LC9_ATE_MAX,
              "finite poses": all(np.all(np.isfinite(T.t))
                                  for T in res.trajectory),
              "K2 lm and full launched": launches["fused_eval/lm"] > 0
              and launches["fused_eval/full"] > 0}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 9 (d) failed: {failed}")
    return launches, shapes


def _kernel_events(trace_path):
    """Names of the CUDA kernel events of a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def phase9e(dev):
    """(e) The CLI on the card: ``gen`` -> ``run --plot --viz
    --profile-dir`` -> ``view``; ``sim --verbose --live-dir``; ``track
    --live-dir`` over phase 8 (c)'s first CLI_TRACK_FRAMES frames; each
    engine run counted from zero."""
    import dataclasses
    import io
    import os
    import tempfile
    import numpy as np
    import torch
    from PIL import Image
    from slslam_tpu_torch import cli
    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.ops import kernels
    fb = _load_tool("torch_frontend_bench")
    launches, shapes, out = {}, {}, {}

    def counted(name, argv):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = cli.main(argv)
        torch.cuda.synchronize()
        out[name] = {"wall_s": time.perf_counter() - t0}
        _merge_shapes(launches, kernels.launch_counts)
        _merge_shapes(shapes, kernels.launch_shapes)
        return stats

    with tempfile.TemporaryDirectory() as tmp:
        def p(*parts):
            return os.path.join(tmp, *parts)

        cli.main(["gen", "--frames", str(CLI_GEN_FRAMES), "--out",
                  p("seq")])
        st = counted("run", ["run", "--obs-dir", p("seq"), "--device",
                             str(dev), "--plot", "--viz", "--profile-dir",
                             p("prof"), "--out", p("run")])
        out["run"].update(keyframes=st["num_keyframes"],
                          trace_mb=os.path.getsize(p("prof", "trace.json"))
                          / 2**20)
        k2 = [n for n in _kernel_events(p("prof", "trace.json"))
              if "fused_eval_kernel" in n]
        cli.main(["view", "--run", p("run"), "--out", p("view.html")])
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            st = counted("sim", ["sim", "--frames", str(CLI_SIM_FRAMES),
                                 "--verbose",
                                 "--device", str(dev), "--live-dir",
                                 p("live_sim"), "--live-every", "10",
                                 "--out", p("sim")])
        out["sim"].update(keyframes=st["num_keyframes"], ate_m=st["ate_m"])
        cfg = dataclasses.replace(SlamConfig(), compute_dtype="float32")
        imgs, _ = fb.render(cfg, CLI_TRACK_FRAMES, TRACK_STRIDE)
        for side in ("left", "right"):
            os.makedirs(p(side))
        for i, pair in enumerate(imgs):
            for side, img in zip(("left", "right"), pair):
                Image.fromarray(np.clip(np.rint(img), 0, 255).astype(
                    np.uint8)).save(p(side, f"{i:04d}.png"))
        st = counted("track", ["track", "--left-dir", p("left"),
                               "--right-dir", p("right"), "--device",
                               str(dev), "--live-dir", p("live_track"),
                               "--out", p("track")])
        out["track"].update(keyframes=st["num_keyframes"])

        def html_ok(path):
            with open(path) as f:
                return "const D = {" in f.read()

        def png(path):
            with open(path, "rb") as f:
                return f.read(8) == b"\x89PNG\r\n\x1a\n"

        checks = {
            "run map.png": png(p("run", "map.png")),
            "run map.html embeds const D = {": html_ok(p("run", "map.html")),
            "view map.html embeds const D = {": html_ok(p("view.html")),
            "sim tracking views every 10 frames": sorted(os.listdir(
                p("live_sim"))) == [f"tracking_{i:05d}.png"
                                    for i in range(0, CLI_SIM_FRAMES, 10)],
            "track tracking views every 10 frames": sorted(os.listdir(
                p("live_track"))) == [f"tracking_{i:05d}.png" for i in
                                      range(0, CLI_TRACK_FRAMES, 10)],
            "sim --verbose progress": "frame 0: kfs=" in err.getvalue(),
            "the trace names K2 among its CUDA kernels": len(k2) > 0,
        }
        checks["the tracking views are PNGs"] = all(
            png(p(d, "tracking_00000.png")) for d in ("live_sim",
                                                      "live_track"))
    log({"phase": 9, "run": "(e) the CLI on the card", **out,
         "k2_trace_events": len(k2), "k2_trace_name": k2[0] if k2 else None,
         "launches": launches})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 9 (e) failed: {failed}")
    return launches, shapes


def phase9(dev, rec, checked):
    """P13: the tools and the CLI's last commands, (a)-(e).  Returns the
    launches of each counted path and every shape they launched; checks
    every kernel at every shape the paths launched it at that no earlier
    phase checked."""
    t_phase = time.perf_counter()
    lmb = _load_tool("torch_large_map_bench")
    phase9b(dev, lmb)
    paths, shapes9 = {}, {}
    for name, fn in (("param_study", phase9c), ("scale_lc", phase9d),
                     ("cli", phase9e)):
        paths[name], shapes = fn(dev)
        _merge_shapes(shapes9, shapes)
    new = {k: v for k, v in shapes9.items() if k not in checked}
    shape_kernels(dev, rec, {k: sum(v for (n, _), v in new.items()
                                    if n == k) for k in paths["cli"]},
                  new, "phase9", 9)
    # the map-scale run last: it holds the most device memory
    paths["large_map"], shapes_map = phase9a(dev, rec, lmb)
    log({"phase": 9, "phase_9_s": time.perf_counter() - t_phase,
         "new_shapes_checked": len(new), "shapes_launched": len(shapes9)})
    return paths, set(shapes9) | set(shapes_map)


def _dist_slam_rank(rank, world, dev, runs):
    """Phase 10 (a) and (b)'s rank: ``_dist_slam_run`` of each (cfg,
    n_frames, hooked) of ``runs`` in turn, in one spawned group."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [_dist_slam_run(world, dev, *run) for run in runs]


def _dist_slam_run(world, dev, cfg, n_frames, hooked):
    """``Slam`` with mesh_devices=world over the house's first
    ``n_frames`` (render seed 4, 0.2 px), the kernel and collective counts
    from zero just before the run; RANSAC noise from ``_cpu_gumbel`` where
    ``hooked``, else the engine's own generator.  Also the keyframes and
    window LM iterations after phase 7 (a)'s INTERACTIVE_FRAMES frames,
    and the trajectory after one ``pose_optimization`` of the final graph
    (the house run triggers none: this one runs the edge-sharded PGO, its
    edges padded to the world size).  The run's launches and shapes are
    read before that PGO, whose own are counted apart (``pgo_launches``,
    ``pgo_shapes``)."""
    import dataclasses
    import torch
    from slslam_tpu_torch import bench
    from slslam_tpu_torch.engine import Slam
    from slslam_tpu_torch.ops import kernels
    from slslam_tpu_torch.parallel import comm_counts, reset_comm_counts
    frames, _ = bench.workload(cfg, n_frames, 4)
    slam = Slam(dataclasses.replace(cfg, mesh_devices=world), device=dev,
                gumbel_hook=_cpu_gumbel() if hooked else None)
    kernels.reset_launch_counts()
    reset_comm_counts()
    at_7a = {}

    def note(i):
        if i == INTERACTIVE_FRAMES - 1:
            at_7a.update(kf=len(slam.state.kfs),
                         window_lm_iterations=slam.sum_num_iteration)

    t0 = time.perf_counter()
    kf = _run_slam(slam, frames, on_frame=note)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches, shapes = (dict(kernels.launch_counts),
                        dict(kernels.launch_shapes))
    comm = comm_counts()
    traj = slam.trajectory()
    kernels.reset_launch_counts()
    slam.pose_optimization()
    return {"kf": kf, "traj": traj, "traj_pgo": slam.trajectory(),
            "lms": {f: (lm.line.copy(), lm.tt.copy())
                    for f, lm in slam.state.lms.items()},
            "edges": sorted(slam.state.edge_set),
            "iters": slam.sum_num_iteration, "stats": slam.post_processing(),
            "launches": launches, "shapes": shapes, "comm": comm,
            "pgo_launches": dict(kernels.launch_counts),
            "pgo_shapes": dict(kernels.launch_shapes),
            "wall_s": wall, "device": str(dev),
            "at_phase_7a_frames": at_7a,
            "foreign_modules": sorted(
                m for m in sys.modules if m.split(".")[0] in
                ("jax", "slslam_tpu"))}


def _dist_ranks(runs):
    """Each run of ``runs`` on DIST_WORLD spawned ranks sharing the card:
    ([every rank's result] for each run, the group's wall)."""
    from slslam_tpu_torch.parallel import run_local_ranks
    t0 = time.perf_counter()
    res = run_local_ranks(_dist_slam_rank, DIST_WORLD, args=(runs,),
                          device="cuda", timeout_s=DIST_TIMEOUT_S)
    return list(zip(*res)), time.perf_counter() - t0


def _ranks_equal(res):
    import numpy as np
    a = res[0]
    for b in res[1:]:
        if not (a["kf"] == b["kf"] and a["edges"] == b["edges"]
                and a["iters"] == b["iters"]
                and _poses_equal(a["traj"], b["traj"])
                and _poses_equal(a["traj_pgo"], b["traj_pgo"])
                and a["lms"].keys() == b["lms"].keys()
                and all(np.array_equal(x, y) for f in a["lms"]
                        for x, y in zip(a["lms"][f], b["lms"][f]))):
            return False
    return True


def _summed(res, key):
    out = {}
    for r in res:
        _merge_shapes(out, r[key])
    return out


def _ring_pgo(V=32, E_pad=64, drift=0.05, seed=0):
    """tests/test_distributed.py's ring (V poses around a circle, the
    chain and one loop edge, drifted starts, padded edges), built with the
    port's hostgeom: (poses, ei, ej, ctr, e_valid, pose_free)."""
    import numpy as np
    from slslam_tpu_torch.hostgeom import Pose
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(V) / V
    gt = np.stack([np.array([0.0, a, 0.0, np.sin(a) * 3, 0.0,
                             np.cos(a) * 3]) for a in ang])
    ei = np.zeros(E_pad, np.int32)
    ej = np.zeros(E_pad, np.int32)
    ctr = np.zeros((E_pad, 6))
    ev = np.zeros(E_pad, bool)
    for k, (i, j) in enumerate([(i, i + 1) for i in range(V - 1)]
                               + [(V - 1, 0)]):
        ei[k], ej[k], ev[k] = i, j, True
        ctr[k] = (Pose.from_wt(gt[j]) @ Pose.from_wt(gt[i]).inv()).wt()
    poses = gt + rng.standard_normal(gt.shape) * drift
    poses[0] = gt[0]
    free = np.ones(V, bool)
    free[0] = False
    return poses, ei, ej, ctr, ev, free


def _rel(a, b):
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def phase10c(dev, tsb):
    """(c) NCCL at world 1 in this process: sharded window solves (at two
    line counts; the scaling tool's random problem) and one sharded PGO
    against ``local_ba`` and ``pose_graph_opt`` on the card, on the same
    arrays, f64; the collective bytes per LM iteration against the closed
    form 8 (36 C^2 + 48 C + 5).  Returns the launches by shape."""
    import datetime
    import os
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from slslam_tpu_torch.ops import kernels
    from slslam_tpu_torch.ops.pose_graph import pose_graph_opt
    from slslam_tpu_torch.ops.schur_ba import local_ba
    from slslam_tpu_torch.parallel import (comm_counts, dist_local_ba_lines,
                                           dist_pose_graph_opt,
                                           partition_by_line,
                                           reset_comm_counts)
    from slslam_tpu_torch.parallel.multihost import backend_for
    if backend_for(dev, 1) != "nccl":
        raise AssertionError("phase 10 (c): the backend rule does not pick "
                             "NCCL for one rank on one card")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmp, "store"),
        world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    out, checks = {}, {}
    kernels.reset_launch_counts()
    try:
        C = 20
        per_iter = 8 * (36 * C * C + 48 * C + 5)

        def f(x):
            x = torch.as_tensor(x, device=dev)
            return x.double() if x.is_floating_point() else x

        for L, O in ((81, 1600), (324, 6400)):
            cam0, orth0, obs, oc, ol, ov, cf, lf, bl, hd = \
                tsb._example_ba_problem(C=C, L=L, O=O)
            # world 1's shard: the problem re-padded; both solves take it
            lo, lfs, ob, ocs, ols, ovs, _ = partition_by_line(
                orth0, lf, obs, oc, ol, ov, 1)
            shard = [f(a[0]) for a in (lo, ob, ocs, ols, ovs, lfs)]
            cam_s, line_s, st_s = local_ba(f(cam0), *shard[:5], f(cf),
                                           shard[5], bl, hd)
            reset_comm_counts()
            cam_d, line_d, st_d = dist_local_ba_lines(
                None, f(cam0), *shard[:5], f(cf), shard[5], bl, hd)
            counts = comm_counts()
            it = int(st_d.iterations)
            key = f"window C={C} L={L} O={O}"
            out[key] = {
                "lm_iterations": [it, int(st_s.iterations)],
                "cam_rel_gap": _rel(cam_d.cpu(), cam_s.cpu()),
                "line_rel_gap": _rel(line_d.cpu(), line_s.cpu()),
                "bytes_per_lm_iteration": (counts["bytes"] - 8) / max(it, 1),
                "collective_calls": counts["calls"],
                "collective_ms": counts["seconds"] * 1e3}
            checks[f"{key}: same LM iterations"] = it == int(st_s.iterations)
            checks[f"{key}: within {DIST_W1_RTOL}"] = max(
                out[key]["cam_rel_gap"], out[key]["line_rel_gap"]) \
                <= DIST_W1_RTOL
            checks[f"{key}: bytes per LM iteration == 8 (36 C^2 + 48 C + "
                   "5)"] = counts["bytes"] == 8 + it * per_iter and it > 0
        pgo = [f(a) for a in _ring_pgo()]
        p_s, s_s = pose_graph_opt(*pgo, max_iters=10)
        p_d, s_d = dist_pose_graph_opt(None, *pgo, max_iters=10)
        out["pgo ring V=32"] = {
            "iterations": [int(s_d.iterations), int(s_s.iterations)],
            "rel_gap": _rel(p_d.cpu(), p_s.cpu())}
        checks["PGO: same iterations"] = int(s_d.iterations) == int(
            s_s.iterations)
        checks[f"PGO: within {DIST_W1_RTOL}"] = \
            out["pgo ring V=32"]["rel_gap"] <= DIST_W1_RTOL
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize(dev)
    log({"phase": 10, "run": "(c) NCCL at world 1, f64: sharded window "
         "solves and PGO against the single solves", "backend": backend,
         **out})
    checks["the group ran NCCL"] = backend == "nccl"
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 10 (c) failed: {failed}")
    return dict(kernels.launch_shapes)


def phase10(dev, rec, checked, refs7):
    """P12, the distributed layer: (a) ``Slam(SlamConfig())`` over the
    house's DIST_FRAMES frames in f32 at world 2 (the slice's main path,
    counted),
    (b) f64 world 2 against phase 7 (c)'s single-process run on the card,
    (c) NCCL at world 1, (d) tools/torch_scaling_bench.py at world 1 and
    2; then (e) every kernel at every shape (a)-(d) launched it at that no
    earlier phase checked (role "dist").  Returns (a)'s launches, summed
    over its ranks."""
    import dataclasses
    import importlib
    import numpy as np
    from slslam_tpu_torch import bench
    from slslam_tpu_torch.config import SlamConfig
    t_phase = time.perf_counter()
    shapes10 = {}

    # (a) the house, DIST_FRAMES frames, f32, the reference gates, then
    # (b) f64 over PARITY_FRAMES, in one group of ranks
    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float32")
    cfg64 = dataclasses.replace(SlamConfig(), compute_dtype="float64")
    (res, res_b), wall = _dist_ranks([(cfg, DIST_FRAMES, False),
                                      (cfg64, PARITY_FRAMES, True)])
    a = res[0]
    _, poses = bench.workload(cfg, DIST_FRAMES, 4)
    ate = bench.ate(a["traj"], [poses[i] for i in a["kf"]])
    launches = _summed(res, "launches")
    for r in res + res_b:
        _merge_shapes(shapes10, r["shapes"])
        _merge_shapes(shapes10, r["pgo_shapes"])
    log({"phase": 10, "run": f"(a) house, {DIST_FRAMES} frames, "
         f"float32, reference gates, world {DIST_WORLD} on one card",
         "kf": len(a["kf"]), "landmarks": a["stats"]["num_landmarks"],
         "window_lm_iterations": a["iters"], "ate_kf_m": ate,
         "phase_7a": refs7["a"],
         f"after {INTERACTIVE_FRAMES} frames": a["at_phase_7a_frames"],
         "rank_walls_s": [r["wall_s"] for r in res],
         "spawned_group_s (a) and (b)": wall,
         "devices": [r["device"] for r in res],
         "dist_backend": a["stats"].get("dist_backend"),
         "collectives": [r["comm"] for r in res],
         "launches_by_rank": [r["launches"] for r in res],
         "sharded_pgo_launches_by_rank (not counted)": [
             r["pgo_launches"] for r in res]})
    checks = {
        "keyframe ATE <= 0.1 m": ate <= 0.1,
        ">= 10 keyframes": len(a["kf"]) >= 10,
        "ranks equal bit for bit (trajectory before and after the PGO, "
        "landmarks, keyframes, edges, LM iterations)": _ranks_equal(res),
        "one pose-graph solve": a["stats"]["num_pose_graph_runs"] == 1,
        "gloo on a shared card": a["stats"].get("dist_backend") == "gloo",
        "finite poses": all(np.all(np.isfinite(T.t)) for T in a["traj"]),
        "K2 full launches == window LM iterations on each rank": all(
            r["launches"]["fused_eval/full"] == r["iters"] > 0 for r in res),
        "K2 lines and cams, K1 and the plan launched": all(
            launches[k] > 0 for k in ("fused_eval/lines", "fused_eval/cams",
                                      "segment_sum", "segment_plan")),
        "no lm launch": launches["fused_eval/lm"] == 0,
        "the ranks loaded neither jax nor slslam_tpu": not any(
            r["foreign_modules"] for r in res),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 10 (a) failed: {failed}")

    # (b) f64, world 2 against the single-process run on the card
    res = res_b
    b, ref = res[0], refs7["b"]
    dtraj = max(float(np.linalg.norm(x.t - y.t))
                for x, y in zip(b["traj"], ref["traj"], strict=True))
    log({"phase": 10, "run": f"(b) f64, {PARITY_FRAMES} house frames, world "
         f"{DIST_WORLD} vs the single-process run on the card (phase 7 (c))",
         "kf": len(b["kf"]), "lm_iterations": [b["iters"], ref["iters"]],
         "edges": len(b["edges"]), "max_traj_diff_m": dtraj,
         "rank_walls_s": [r["wall_s"] for r in res]})
    checks = {"same keyframes, edges and LM iterations":
              b["kf"] == ref["kf"] and b["edges"] == ref["edges"]
              and b["iters"] == ref["iters"],
              f"trajectories within {DIST_TRAJ_TOL} m": dtraj
              <= DIST_TRAJ_TOL,
              "ranks equal bit for bit": _ranks_equal(res)}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 10 (b) failed: {failed}")

    # (c) NCCL at world 1, in this process
    tsb = importlib.import_module("tools.torch_scaling_bench")
    _merge_shapes(shapes10, phase10c(dev, tsb))

    # (d) the scaling tool at world 1 and 2 on the card
    t0 = time.perf_counter()
    rows, summary, shapes = tsb.run(max_world=DIST_WORLD, device="cuda",
                                    timeout_s=DIST_TIMEOUT_S)
    _merge_shapes(shapes10, shapes)
    log({"phase": 10, "run": "(d) tools/torch_scaling_bench.py, world 1 "
         f"and {DIST_WORLD} on the card", "rows": rows, "summary": summary,
         "run_s": time.perf_counter() - t0})
    if not summary["collective_bytes_per_lm_iteration_constant"]:
        raise AssertionError("phase 10 (d): the bytes per LM iteration "
                             "change with the world size")

    # (e) every kernel at every new shape
    new = {k: v for k, v in shapes10.items() if k not in checked}
    shape_kernels(dev, rec, {k: sum(v for (n, _), v in new.items()
                                    if n == k) for k in launches},
                  new, "dist", 10)
    log({"phase": 10, "phase_10_s": time.perf_counter() - t_phase,
         "new_shapes_checked": len(new), "shapes_launched": len(shapes10)})
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    from slslam_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    k2_line = "slslam_tpu/ops/pallas_kernels.py:385"
    rec = {name: {"name": name, "route": "cuda", "source": source,
                  "replaces": replaces}
           for name, source, replaces in (
               ("segment_plan", K1_SOURCE,
                "slslam_tpu/ops/pallas_kernels.py:64"),
               ("segment_sum", K1_SOURCE,
                "slslam_tpu/ops/pallas_kernels.py:64"),
               *((f"fused_eval/{v}", K2_SOURCE, k2_line)
                 for v in kernels.VARIANTS),
               *((name, K34_SOURCE, K34_REPLACES[name])
                 for name in kernels.SCHUR_KERNELS))}
    smi = phase0(dev)
    phase1(dev, rec)
    phase2(dev, rec)
    phase3(dev)
    phase5(dev, rec, phase4(dev))
    launches6, shapes6, refine_cl_o = phase6(dev)
    for name, n in launches6.items():
        rec[name]["launches"] += n
        rec[name]["launches_by_path"]["lc"] = n
    shape_kernels(dev, rec, launches6, shapes6, "lc", 6, refine_cl_o)
    launches7, shapes7, refs7 = phase7(dev)
    for name, n in launches7.items():
        rec[name]["launches"] += n
        rec[name]["launches_by_path"]["interactive"] = n
    shape_kernels(dev, rec, {k: sum(v for (n, _), v in shapes7.items()
                                    if n == k) for k in launches7},
                  shapes7, "interactive", 7)
    launches8, launches8b, shapes8 = phase8(dev)
    for name in launches8:
        rec[name]["launches"] += launches8[name] + launches8b[name]
        rec[name]["launches_by_path"]["track"] = launches8[name]
        rec[name]["launches_by_path"]["frontend_bench"] = launches8b[name]
    shape_kernels(dev, rec, {k: sum(v for (n, _), v in shapes8.items()
                                    if n == k) for k in launches8},
                  shapes8, "frontend", 8)
    from slslam_tpu_torch import kernel_checks as kc
    checked = ({("segment_plan", s) for s in kc.PLAN_SHAPES}
               | {("segment_sum", s) for s in kc.K1_SHAPES}
               | {(f"fused_eval/{v}", s) for v, s in kc.K2_SHAPES.items()}
               | {(name, s) for name in kernels.SCHUR_KERNELS
                  for s in kc.SCHUR_SHAPES.values()}
               | set(shapes6) | set(shapes7) | set(shapes8))
    paths9, shapes9 = phase9(dev, rec, checked)
    for path, launches9 in paths9.items():
        for name, n in launches9.items():
            rec[name]["launches"] += n
            rec[name]["launches_by_path"][path] = n
    launches10 = phase10(dev, rec, checked | shapes9, refs7)
    for name, n in launches10.items():
        rec[name]["launches"] += n
        rec[name]["launches_by_path"]["dist"] = n
    if "jax" in sys.modules or any(m == "slslam_tpu" or
                                   m.startswith("slslam_tpu.")
                                   for m in sys.modules):
        raise AssertionError("chip_smoke imported jax or slslam_tpu")
    print(smi)
    log({"kernels": list(rec.values())})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
