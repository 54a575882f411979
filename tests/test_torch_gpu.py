"""The CUDA kernels against their plain twins on the card (opt-in).

The checks of chip_smoke.py phases 1 and 2 (slslam_tpu_torch/
kernel_checks.py, tolerances stated there), as tests: the segment plan
(on every path that can take a shape, on adversarial keys, on either side
of each path's limit, at the large map's shapes and inside a CUDA graph),
K1 with and without a plan, and every K2 variant launched twice (the two
launches must agree bit for bit; ``lm``'s dropped Wb rows must come out
exactly zero; ``lm`` also at the large map's padding share), then on two
streams at once and from a CUDA graph (each launch keeps its own
last-block counter, so every result equals an eager launch's bit for
bit); the line-major plan's shapes; and a short global
refine on the card against the same refine on the CPU; and the gaps of
the prior-edge window solve and of a 1-round refine, card against CPU,
beside what rounding alone does to the CPU's result; K2 with aid and asd
lines through the chain rule; the interactive engine on the card
against the CPU; the image front-end's maps, descriptors and ``cli
track`` on the card against the CPU; and the large map's plans, K1 and
K2 ``lm`` at its map-scale shapes, and its f64 solve card against CPU;
K3 ``schur_matvec`` and K4 ``schur_jacobi`` at the refine's, the
loop-closure refine's and the map's shapes (twice bit for bit, on two
streams, from a CUDA graph, a wrong plan refused) and on the large map's
own blocks, and the refine PCG's launches of them; K3 ``schur_pcg`` at
the same shapes with and without the priors (twice and on two streams
bit for bit, a grid the card cannot keep resident refused, a whole PCG
step with no host read under ``torch.cuda.set_sync_debug_mode``);
and the line-sharded window solve at world 1 (NCCL) and world 2 (two
ranks sharing the card over gloo) against the single solve.  They run only
with SLSLAM_GPU_TESTS=1 on a machine with an NVIDIA GPU and nvcc, and skip
otherwise.  The file imports no jax, so on a machine without it run

    SLSLAM_GPU_TESTS=1 python -m pytest tests/test_torch_gpu.py \\
        --noconftest -o addopts= -q
"""

import json
import os

import pytest
import torch

from slslam_tpu_torch import kernel_checks
from slslam_tpu_torch.ops import kernels


@pytest.fixture
def cuda_device():
    if os.environ.get("SLSLAM_GPU_TESTS") != "1":
        pytest.skip("CUDA kernel test; set SLSLAM_GPU_TESTS=1 on a machine "
                    "with an NVIDIA GPU and nvcc")
    if not torch.cuda.is_available():
        pytest.fail("SLSLAM_GPU_TESTS=1 but torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


@pytest.mark.gpu
def test_segment_plan_kernel_on_gpu(cuda_device):
    before = kernels.launch_counts["segment_plan"]
    kernel_checks.check_plans(cuda_device)
    assert kernels.launch_counts["segment_plan"] > before


PLAN_CASES = kernel_checks.plan_adversarial_cases()


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(PLAN_CASES)),
                         ids=[name for name, _, _ in PLAN_CASES])
def test_segment_plan_adversarial_keys_on_gpu(cuda_device, case):
    """The plan on every path that can take the key's (O, P), each
    launched twice, equal to the twin bit for bit."""
    kernel_checks.check_plans(cuda_device, cases=[PLAN_CASES[case]])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", kernel_checks.PLAN_BOUNDARY_SHAPES)
def test_segment_plan_paths_at_their_boundary_on_gpu(cuda_device, shape):
    """Each path takes (O, P) up to its limits and no further; every path
    that can take a key gives the same bytes, the twin's."""
    O, P = shape
    assert kernels.plan_path(O, P) == kernel_checks.PLAN_BOUNDARY_PATHS[shape]
    paths = kernels.plan_paths(O, P)
    assert "tiles" in paths
    kernel_checks.check_plans(cuda_device, [shape])
    key = kernel_checks.plan_case(O, P, cuda_device)
    ref = kernels.segment_plan(key, P, path="tiles")
    for path in ("segment_blocks", "one_block"):
        if path in paths:
            got = kernels.segment_plan(key, P, path=path)
            assert torch.equal(got.perm, ref.perm)
            assert torch.equal(got.offsets, ref.offsets)
        else:
            with pytest.raises(ValueError):
                kernels.segment_plan(key, P, path=path)


@pytest.mark.gpu
def test_segment_plan_large_shapes_on_gpu(cuda_device):
    """The plan at the large map's, the scaling tool's, the interactive
    window's and the PGO's shapes, and inside a CUDA graph (the tiles'
    scratch comes from the caller), equal to the twin."""
    kernel_checks.check_plans(cuda_device, kernel_checks.PLAN_LARGE_SHAPES)
    O, P = kernel_checks.PLAN_LARGE_SHAPES[2]
    key = kernel_checks.plan_case(O, P, cuda_device)
    ref = kernels.segment_plan_twin(key.cpu(), P)
    kernels.segment_plan(key, P)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernels.segment_plan(key, P)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured.perm.cpu(), ref.perm)
    assert torch.equal(captured.offsets.cpu(), ref.offsets)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lm_at_map_padding_on_gpu(cuda_device, dtype):
    """K2 ``lm`` at the large map's padding share (kL = 32, ~73 % of the
    rows padding, whole padding buckets among them): within K2_TOL of its
    twin, bit for bit twice, exact zeros on the dropped rows."""
    C, L, kL = 512, 4096, 32
    kernel_checks.check_k2(dtype, cuda_device, "lm", (C, L, L * kL),
                           kernel_checks.MAP_PAD)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_kernel_on_gpu(cuda_device, dtype):
    before = kernels.launch_counts["segment_sum"]
    kernel_checks.check_k1(dtype, cuda_device)
    assert kernels.launch_counts["segment_sum"] > before


@pytest.mark.gpu
@pytest.mark.parametrize("variant", kernels.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_eval_kernel_on_gpu(cuda_device, dtype, variant):
    key = f"fused_eval/{variant}"
    before = kernels.launch_counts[key]
    kernel_checks.check_k2(dtype, cuda_device, variant)
    assert kernels.launch_counts[key] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("variant", kernels.VARIANTS)
def test_fused_eval_on_two_streams_and_in_a_graph(cuda_device, variant):
    """Launches in flight on two streams, and launches replayed from a CUDA
    graph, each keep their own last-block counter: every result equals an
    eager launch's bit for bit."""
    args, plan = kernel_checks.k2_variant_case(variant, torch.float32,
                                               cuda_device)

    def run():
        return kernels.fused_eval(**args, variant=variant, plan=plan)

    ref = run()
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    outs = []
    for _ in range(20):
        outs.append(run())
        with torch.cuda.stream(side):
            outs.append(run())
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(3):
        graph.replay()
        outs.append(run())
    torch.cuda.synchronize()
    for out in outs + [captured]:
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_lm_plan_shape_and_a_wrong_plan_refused(cuda_device):
    """The line-major evaluate's plan at the refine's shape: a camera plan
    of C + 1 offsets and a line plan of L + 1, no pair plan; a plan with
    the two swapped is refused before any launch."""
    args, plan = kernel_checks.k2_variant_case("lm", torch.float32,
                                               cuda_device)
    C, L, O = kernel_checks.K2_SHAPES["lm"]
    assert plan.pair is None
    assert tuple(plan.cam.perm.shape) == tuple(plan.line.perm.shape) == (O,)
    assert tuple(plan.cam.offsets.shape) == (C + 1,)
    assert tuple(plan.line.offsets.shape) == (L + 1,)
    kept = int(plan.cam.offsets[-1])
    assert kept == int(plan.line.offsets[-1]) == int(
        (args["w_valid"] > 0).sum()) < O
    before = kernels.launch_counts["fused_eval/lm"]
    with pytest.raises(ValueError):
        kernels.fused_eval(**args, variant="lm",
                           plan=plan._replace(cam=plan.line, line=plan.cam))
    assert kernels.launch_counts["fused_eval/lm"] == before


@pytest.mark.gpu
def test_refine_cg_on_gpu_matches_cpu(cuda_device):
    """global_refine's CG path on 20 house frames in float64, two rounds,
    on the card (K2 ``lm``, K1) and on the CPU (twins), from the same
    perturbed trajectory: the same LM iterations, poses within 1e-6 m."""
    import dataclasses

    import numpy as np

    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.engine.refine import global_refine
    from slslam_tpu_torch.hostgeom import Pose
    from slslam_tpu_torch.sim import (StereoLineRenderer, house_segments,
                                      wave_trajectory)
    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64")
    poses = wave_trajectory(num_frames=400)[:20]
    ren = StereoLineRenderer(house_segments(), cfg.camera, noise_px=0.2,
                             seed=4)
    frames = [ren.observe(T) for T in poses]
    rng = np.random.default_rng(0)
    traj = [Pose.from_wt((T @ poses[0].inv()).inv().wt()
                         + (rng.standard_normal(6) * 0.01 if k else 0.0))
            for k, T in enumerate(poses)]
    kw = dict(config=cfg, rounds=2, method="cg")
    before = kernels.launch_counts["fused_eval/lm"]
    gpu = global_refine(frames, np.ones(20, bool), traj, device=cuda_device,
                        **kw)
    assert kernels.launch_counts["fused_eval/lm"] > before
    cpu = global_refine(frames, np.ones(20, bool), traj, device="cpu", **kw)
    assert gpu.iterations == cpu.iterations
    d = max(float(np.linalg.norm(a.t - b.t))
            for a, b in zip(gpu.trajectory, cpu.trajectory))
    assert d <= 1e-6, d


def _ring(K=24, drift=0.5, seed=0):
    """A drifted odometry ring with a perfect loop edge (the graph of
    tests/test_batch_lc.py): (poses (K,6) world->cam, ei, ej, c, free)."""
    import numpy as np

    from slslam_tpu_torch.hostgeom import Pose
    rng = np.random.default_rng(seed)
    gt = []
    for i in range(K):
        a = 2 * np.pi * i / K
        gt.append(Pose(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                 [-np.sin(a), 0, np.cos(a)]]),
                       np.array([3 * np.sin(a), 0.0, 3 - 3 * np.cos(a)])))
    edges = []
    for g in range(K - 1):
        w = (gt[g + 1] @ gt[g].inv()).wt()
        w[3:] += drift * (rng.standard_normal(3) * 0.2 + 1.0) * 0.1
        edges.append(w)
    T = Pose()
    poses = [T.wt()]
    for g in range(K - 1):
        T = Pose.from_wt(edges[g]) @ T
        poses.append(T.wt())
    ei = np.concatenate([np.arange(K - 1), [0]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, K), [K - 1]]).astype(np.int32)
    c = np.concatenate([np.stack(edges), [(gt[-1] @ gt[0].inv()).wt()]])
    free = np.ones(K, bool)
    free[0] = False
    return np.stack(poses), ei, ej, c, free


@pytest.mark.gpu
@pytest.mark.parametrize("huber_delta", [None, 0.25])
def test_pose_graph_opt_on_gpu_matches_cpu(cuda_device, huber_delta):
    """The PGO on the card (edge blocks summed by K1) against the CPU in
    float64: the same LM iterations, poses within 1e-9, and a repeat on
    the card that agrees bit for bit."""
    from slslam_tpu_torch.ops.pose_graph import pose_graph_opt
    poses, ei, ej, c, free = _ring()

    def run(dev):
        t = lambda a: torch.as_tensor(a, device=dev)       # noqa: E731
        return pose_graph_opt(t(poses), t(ei), t(ej), t(c),
                              torch.ones(len(ei), dtype=torch.bool,
                                         device=dev), t(free),
                              huber_delta=huber_delta)

    before = kernels.launch_counts["segment_sum"]
    g, sg = run(cuda_device)
    assert kernels.launch_counts["segment_sum"] > before
    g2, _ = run(cuda_device)
    c_, sc = run("cpu")
    assert int(sg.iterations) == int(sc.iterations) > 1
    assert torch.equal(g, g2)
    assert float(torch.max(torch.abs(g.cpu() - c_))) <= 1e-9


def _prior_ba_run(dev, iters):
    """local_ba with prior_edges on kernel_checks.prior_ba_case's arrays,
    on ``dev``: (run(arrays) -> (cameras, lines) on the CPU, stats of the
    last run)."""
    from slslam_tpu_torch.ops.schur_ba import local_ba
    _, pe = kernel_checks.prior_ba_case()
    last = {}

    def run(arrays):
        t = [torch.as_tensor(a, device=dev) for a in arrays]
        c, l, last["stats"] = local_ba(
            *t, 0.12, 1.0 / 406.05, robust=True, max_iters=iters,
            prior_edges=tuple(torch.as_tensor(a, device=dev) for a in pe))
        return c.cpu(), l.cpu()
    return run, last


@pytest.mark.gpu
def test_local_ba_prior_edges_on_gpu_matches_cpu(cuda_device):
    """The joint polish's solve, local_ba with prior_edges, on the card
    (K2 ``full``, the priors' block sums and Hoff placement on K1) against
    the CPU twins in float64: the same LM iterations, cameras and lines
    within 1e-8, final cost within rtol 1e-9.  Four LM iterations: past
    them this random problem amplifies rounding beyond 1e-8 (on the CPU
    alone, inputs moved by a few units in the last place move its lines by
    7.7e-6 after 10 iterations: tests/test_torch_schur_ba.py), so 10
    iterations are held to that witness below."""
    arrays, _ = kernel_checks.prior_ba_case()
    gpu, g = _prior_ba_run(cuda_device, 4)
    cpu, c = _prior_ba_run("cpu", 4)
    before = kernels.launch_counts["fused_eval/full"]
    cg, lg = gpu(arrays)
    assert kernels.launch_counts["fused_eval/full"] == before + int(
        g["stats"].iterations)
    cc, lc = cpu(arrays)
    assert int(g["stats"].iterations) == int(c["stats"].iterations) == 4
    assert float(torch.max(torch.abs(cg - cc))) <= 1e-8
    assert float(torch.max(torch.abs(lg - lc))) <= 1e-8
    assert abs(float(g["stats"].final_cost) - float(
        c["stats"].final_cost)) <= 1e-9 * float(c["stats"].final_cost)


@pytest.mark.gpu
def test_local_ba_prior_edges_on_gpu_within_rounding(cuda_device):
    """The same solve at 10 LM iterations: the card's cameras and lines lie
    no farther from the CPU twins' than rounding alone moves the CPU's own
    result (kernel_checks.rounding_gaps: the twins' sums reversed, or the
    inputs moved by a few units in the last place), with the same LM
    iterations."""
    arrays, _ = kernel_checks.prior_ba_case()
    gpu, g = _prior_ba_run(cuda_device, 10)
    cpu, c = _prior_ba_run("cpu", 10)
    witness = kernel_checks.rounding_gaps(cpu, arrays)
    card = [float(torch.max(torch.abs(a - b)))
            for a, b in zip(gpu(arrays), cpu(arrays))]
    print(json.dumps({"local_ba_prior_edges_10_iters": {
        "card_vs_cpu": card, **witness}}))
    assert int(g["stats"].iterations) == int(c["stats"].iterations) == 10
    bound = [max(r, p) for r, p in zip(witness["reversed"],
                                       witness["perturbed"])]
    assert all(x <= b for x, b in zip(card, bound)), (card, witness)


@pytest.mark.gpu
def test_one_round_refine_gap_on_gpu_is_rounding(cuda_device):
    """chip_smoke.py phase 3's replay (60 house frames of render seed 4,
    float64, its Gumbel hook) and a 1-round CG refine of it, which stops
    at its 25-iteration cap short of convergence: the card's trajectory
    lies no farther from the CPU twins' than the CPU twins' own with every
    sum over rows reversed (kernel_checks.reversed_twin_sums), with the
    same LM iterations.  The CPU side of this witness is
    tests/test_torch_refine.py's."""
    import numpy as np

    from slslam_tpu_torch.bench import bench_config, workload
    from slslam_tpu_torch.engine.batch import BatchSlam
    from slslam_tpu_torch.engine.refine import global_refine
    from slslam_tpu_torch.ops.ransac import gumbel_noise
    cfg = bench_config("float64")
    frames, _ = workload(cfg, 60, 4)
    H = cfg.ransac_num_hypotheses

    def hook(fidx, Lp=81):
        g = torch.Generator().manual_seed(1000 + fidx)
        return gumbel_noise(g, (H, Lp), torch.float64, "cpu")

    res = BatchSlam(cfg, device=cuda_device, gumbel_hook=hook).run(frames)

    def refine(dev):
        return global_refine(frames, res.is_kf, res.trajectory, config=cfg,
                             rounds=1, method="cg", device=dev)

    def gap(a, b):
        return max(float(np.linalg.norm(x.t - y.t))
                   for x, y in zip(a.trajectory, b.trajectory))

    card, cpu = refine(cuda_device), refine("cpu")
    with kernel_checks.reversed_twin_sums():
        rev = refine("cpu")
    print(json.dumps({"refine_1_round_60_frames": {
        "iterations": [card.iterations, cpu.iterations, rev.iterations],
        "card_vs_cpu_m": gap(card, cpu), "cpu_vs_reversed_m": gap(cpu, rev)}}))
    assert card.iterations == cpu.iterations == rev.iterations
    assert gap(card, cpu) <= gap(cpu, rev), (gap(card, cpu), gap(cpu, rev))


@pytest.mark.gpu
def test_global_ba_cg_prior_c_on_gpu_matches_cpu(cuda_device):
    """global_ba_cg with the odometry-chain prior on 20 house frames:
    card (K2 ``lm``, K1 in the PCG and the prior sums) against the CPU in
    float64: the same LM iterations, cameras within 1e-6."""
    import numpy as np

    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.engine import refine
    from slslam_tpu_torch.hostgeom import Pose
    from slslam_tpu_torch.ops.schur_cg import global_ba_cg, pack_line_major
    from slslam_tpu_torch.sim import (StereoLineRenderer, house_segments,
                                      wave_trajectory)
    cfg = SlamConfig(compute_dtype="float64")
    poses = wave_trajectory(num_frames=400)[:20]
    ren = StereoLineRenderer(house_segments(), cfg.camera, noise_px=0.2,
                             seed=4)
    frames = [ren.observe(T) for T in poses]
    rng = np.random.default_rng(0)
    traj = [Pose.from_wt((T @ poses[0].inv()).inv().wt()
                         + (rng.standard_normal(6) * 0.01 if k else 0.0))
            for k, T in enumerate(poses)]
    s = refine.build_problem_structure(frames, np.ones(20, bool))
    cam0, line0 = refine.init_problem_values(s, traj, cfg, device="cpu")
    p = pack_line_major(s.obs, s.ocam, s.olin, 20, len(s.feat_ids))
    chain = np.stack([(traj[i + 1].inv() @ traj[i]).wt() for i in range(19)])
    cfree = np.ones(20, bool)
    cfree[0] = False

    def run(dev):
        t = lambda a: torch.as_tensor(a, device=dev)       # noqa: E731
        return global_ba_cg(t(cam0), t(line0), t(p.obs), t(p.obs_cam),
                            t(p.obs_valid), t(cfree),
                            torch.ones(len(line0), dtype=torch.bool,
                                       device=dev), cfg.camera.baseline,
                            cfg.huber_delta, max_iters=25, prior_c=t(chain),
                            prior_sigma_rot=0.2, prior_sigma_t=2.0)

    cg, _, sg = run(cuda_device)
    cc, _, sc = run("cpu")
    assert int(sg.iterations) == int(sc.iterations) > 2
    assert float(torch.max(torch.abs(cg.cpu() - cc))) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("line_param", ["aid", "asd"])
@pytest.mark.parametrize("variant", ["full", "lines", "lm", "cams"])
def test_fused_eval_chain_rule_on_gpu(cuda_device, variant, line_param):
    """K2 with aid / asd lines (decoded to orth, the line blocks mapped by
    d orth / d p) against the twin that differentiates in aid / asd, at
    the interactive window's shape, float64 and float32."""
    key = f"fused_eval/{variant}"
    for dtype in (torch.float64, torch.float32):
        before = kernels.launch_counts[key]
        kernel_checks.check_k2_chart(dtype, cuda_device, variant, line_param)
        assert kernels.launch_counts[key] == before + 1


@pytest.mark.gpu
def test_interactive_slam_on_gpu_matches_cpu(cuda_device):
    """40 house frames through the interactive engine in float64 on the
    card and on the CPU, fed one RANSAC noise stream: the same keyframes,
    edges, landmarks and window LM iterations, poses within 1e-6 m."""
    import dataclasses

    import numpy as np

    from slslam_tpu_torch import bench
    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.engine import Slam
    from slslam_tpu_torch.ops.ransac import gumbel_noise

    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64")
    frames, _ = bench.workload(cfg, 40, 4)

    def hook(i, H, Nb):
        g = torch.Generator().manual_seed(900 + i)
        return gumbel_noise(g, (H, Nb), torch.float64, "cpu")

    runs = []
    for dev in (cuda_device, "cpu"):
        s = Slam(cfg, device=dev, gumbel_hook=hook)
        kf = [i for i, fr in enumerate(frames) if s.process_frame(fr, i)]
        runs.append((s, kf))
    (g, kg), (c, kc) = runs
    assert kg == kc and len(kg) >= 3
    assert g.state.edge_set == c.state.edge_set
    assert sorted(g.state.lms) == sorted(c.state.lms)
    assert g.sum_num_iteration == c.sum_num_iteration
    for a, b in zip(g.trajectory(), c.trajectory(), strict=True):
        np.testing.assert_allclose(a.t, b.t, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.R, b.R, rtol=0, atol=1e-6)


def _house_images(n, stride=3):
    from slslam_tpu_torch.sim import (StereoImageRenderer, house_segments,
                                      wave_trajectory)
    ren = StereoImageRenderer(house_segments(), seed=0)
    return [ren.render(T)[:2] for T in wave_trajectory(400)[::stride][:n]]


@pytest.mark.gpu
def test_image_gradients_on_gpu_match_cpu(cuda_device):
    """The front-end's maps on the card against the CPU, on two rendered
    stereo frames: magnitude within 1e-4, the level-line angle within 1e-5
    rad where the magnitude reaches the detector's threshold."""
    import numpy as np

    from slslam_tpu_torch.frontend.detector import image_gradients

    for pair in _house_images(2):
        for img in pair:
            t = torch.as_tensor(img)
            mg, ag = (x.cpu().numpy() for x in image_gradients(t.cuda()))
            mc, ac = (x.numpy() for x in image_gradients(t))
            assert np.abs(mg - mc).max() <= 1e-4
            read = mc >= 5.0
            gap = np.abs(np.angle(np.exp(1j * (ag.astype(np.float64)
                                               - ac))))
            assert gap[read].max() <= 1e-5


@pytest.mark.gpu
def test_describe_on_gpu_matches_cpu(cuda_device):
    """The descriptors of one frame's segments on identical maps, card
    against CPU, within 1e-6 after normalization."""
    import numpy as np

    from slslam_tpu_torch.frontend.descriptor import describe
    from slslam_tpu_torch.frontend.detector import LineSegmentDetector

    img = _house_images(1)[0][0]
    segs, mag, ang = LineSegmentDetector(device="cpu").detect_with_gradients(
        img)
    assert len(segs) >= 40
    got = describe(mag.cuda(), ang.cuda(), segs)
    want = describe(mag, ang, segs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_track_on_gpu_matches_cpu(cuda_device, tmp_path):
    """``cli track`` over 10 rendered frames in float64 on the card and on
    the CPU, each ``Slam`` fed one RANSAC noise stream: the same keyframes
    and landmark count, trajectories within 1e-6 m."""
    import numpy as np

    from PIL import Image

    import slslam_tpu_torch.engine as engine
    from slslam_tpu_torch import cli
    from slslam_tpu_torch.ops.ransac import gumbel_noise

    for side in ("left", "right"):
        (tmp_path / side).mkdir()
    for i, pair in enumerate(_house_images(10)):
        for side, img in zip(("left", "right"), pair):
            Image.fromarray(np.clip(np.rint(img), 0, 255).astype(
                np.uint8)).save(str(tmp_path / side / f"{i:04d}.png"))

    def hook(i, H, Nb):
        g = torch.Generator().manual_seed(700 + i)
        return gumbel_noise(g, (H, Nb), torch.float64, "cpu")

    orig = engine.Slam
    engine.Slam = lambda cfg, device: orig(cfg, device=device,
                                           gumbel_hook=hook)
    try:
        stats = {d: cli.main(["track", "--left-dir", str(tmp_path / "left"),
                              "--right-dir", str(tmp_path / "right"),
                              "--device", d, "--dtype", "float64", "--out",
                              str(tmp_path / d)])
                 for d in ("cuda", "cpu")}
    finally:
        engine.Slam = orig
    assert stats["cuda"]["keyframe_frames"] == stats["cpu"]["keyframe_frames"]
    assert len(stats["cuda"]["keyframe_frames"]) >= 2
    assert stats["cuda"]["num_landmarks"] == stats["cpu"]["num_landmarks"]
    a = np.loadtxt(tmp_path / "cuda" / "trajectory.txt")
    b = np.loadtxt(tmp_path / "cpu" / "trajectory.txt")
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _large_map(argv, device, dtype):
    """tools/torch_large_map_bench.py's problem for ``argv`` on ``device``:
    (the tool module, its parsed arguments, host arrays, device tensors)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools", "torch_large_map_bench.py")
    spec = importlib.util.spec_from_file_location("torch_large_map_bench",
                                                  path)
    lmb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lmb)
    args = lmb.parser().parse_args(argv)
    host = lmb.build(args)
    return lmb, args, host, lmb.device_tensors(host, device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("where", list(kernel_checks.SCHUR_SHAPES))
def test_schur_kernels_on_gpu(cuda_device, where, dtype):
    """K3's line and camera passes (the matvec and the right-hand side)
    and K4 at the refine's (400, 74, 29,600), the loop-closure refine's
    (170, 453, 25,368) and the large map's (8192, 109,147, 3,492,704, ~73 %
    padding) shapes against their twins (kernel_checks.check_schur: 1e-12
    in float64, the float32 rounding witness), each launched twice bit for
    bit, on two streams and from a CUDA graph bit for bit, and a plan of
    the wrong segments refused before any launch."""
    shape = kernel_checks.SCHUR_SHAPES[where]
    before = {k: kernels.launch_counts[k] for k in kernel_checks.SCHUR_OUTPUTS}
    kernel_checks.check_schur(dtype, cuda_device, shape,
                              kernel_checks.SCHUR_PADS[where],
                              concurrency=True)
    assert all(kernels.launch_counts[k] > before[k]
               for k in kernel_checks.SCHUR_OUTPUTS)


@pytest.mark.gpu
def test_refine_pcg_runs_on_schur_kernels(cuda_device):
    """global_ba_cg on 20 house frames on the card, float64: each LM
    iteration launches K3's PCG once (the launches' counts summing to the
    solve's PCG iterations), K3's line pass (the back-substitution), its
    camera pass (the right-hand side) and K4 once, and K1 never (no
    priors); the result equals the CPU twins' within 1e-6 with the same
    iterations."""
    import numpy as np

    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.engine import refine
    from slslam_tpu_torch.hostgeom import Pose
    from slslam_tpu_torch.ops.schur_cg import global_ba_cg, pack_line_major
    from slslam_tpu_torch.sim import (StereoLineRenderer, house_segments,
                                      wave_trajectory)
    cfg = SlamConfig(compute_dtype="float64")
    poses = wave_trajectory(num_frames=400)[:20]
    ren = StereoLineRenderer(house_segments(), cfg.camera, noise_px=0.2,
                             seed=4)
    frames = [ren.observe(T) for T in poses]
    rng = np.random.default_rng(1)
    traj = [Pose.from_wt((T @ poses[0].inv()).inv().wt()
                         + (rng.standard_normal(6) * 0.01 if k else 0.0))
            for k, T in enumerate(poses)]
    s = refine.build_problem_structure(frames, np.ones(20, bool))
    cam0, line0 = refine.init_problem_values(s, traj, cfg, device="cpu")
    p = pack_line_major(s.obs, s.ocam, s.olin, 20, len(s.feat_ids))
    cfree = np.ones(20, bool)
    cfree[0] = False

    def run(dev):
        t = lambda a: torch.as_tensor(a, device=dev)       # noqa: E731
        return global_ba_cg(t(cam0), t(line0), t(p.obs), t(p.obs_cam),
                            t(p.obs_valid), t(cfree),
                            torch.ones(len(line0), dtype=torch.bool,
                                       device=dev), cfg.camera.baseline,
                            cfg.huber_delta, max_iters=25)

    from slslam_tpu_torch.ops import schur_cg
    counts = []
    launch = schur_cg.schur_pcg

    def counted(*a, **k):
        out = launch(*a, **k)
        counts.append(out[1])
        return out

    kernels.reset_launch_counts()
    schur_cg.schur_pcg = counted
    try:
        cg, _, sg = run(cuda_device)
    finally:
        schur_cg.schur_pcg = launch
    n = dict(kernels.launch_counts)
    cc, _, sc = run("cpu")
    lm, pcg = int(sg.iterations), int(sg.cg_iterations)
    assert lm == int(sc.iterations) > 2 and pcg == int(sc.cg_iterations) > 0
    assert (n["schur_pcg"] == n["schur_matvec/line"]
            == n["schur_matvec/cam"] == n["schur_jacobi"]
            == n["fused_eval/lm"] == lm == len(counts))
    assert sum(int(c) for c in counts) == pcg
    assert n["segment_sum"] == 0
    assert float(torch.max(torch.abs(cg.cpu() - cc))) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("priors", [False, True], ids=["no prior", "priors"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("where", list(kernel_checks.SCHUR_SHAPES))
def test_schur_pcg_on_gpu(cuda_device, where, dtype, priors):
    """K3's PCG at the refine's, the loop-closure refine's and the map's
    shapes on a real BA system (kernel_checks.pcg_case), with and without
    the priors' coupling: float64 the twin's iterations and x within
    PCG_TOL, float32 the rounding witness, two launches bit for bit."""
    before = kernels.launch_counts["schur_pcg"]
    out = kernel_checks.check_pcg(dtype, cuda_device,
                                  kernel_checks.SCHUR_SHAPES[where],
                                  kernel_checks.SCHUR_PADS[where], priors)
    assert out["iterations"] > 0
    assert kernels.launch_counts["schur_pcg"] == before + 2


@pytest.mark.gpu
def test_schur_pcg_two_streams_and_grid_on_gpu(cuda_device):
    """Launches on two streams at once give an eager launch's bits; a grid
    larger than the card keeps resident (set in the wrapper's grid cache)
    is refused, the cooperative launch's error raising, and counts no
    launch; the next launch runs."""
    case, plan = kernel_checks.pcg_case(
        torch.float32, cuda_device, kernel_checks.SCHUR_SHAPES["lc"],
        kernel_checks.SCHUR_PADS["lc"], priors=True)
    run = kernel_checks.pcg_call(case, plan)
    ref = run()
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    outs = []
    for _ in range(10):
        outs.append(run())
        with torch.cuda.stream(side):
            outs.append(run())
    main.wait_stream(side)
    torch.cuda.synchronize()
    for x, it in outs:
        assert torch.equal(x, ref[0]) and torch.equal(it, ref[1])
    C, L, O = kernel_checks.SCHUR_SHAPES["lc"]
    dev = case["Wb"].device
    blocks = kernels.schur_pcg_blocks(torch.float32, C, L, O, dev)
    key = (dev, torch.float32, C, L, O)
    before = kernels.launch_counts["schur_pcg"]
    kernels._pcg_blocks[key] = 100 * blocks
    try:
        with pytest.raises(RuntimeError, match="schur_pcg"):
            run()
    finally:
        kernels._pcg_blocks[key] = blocks
    assert kernels.launch_counts["schur_pcg"] == before
    assert torch.equal(run()[0], ref[0])


@pytest.mark.gpu
@pytest.mark.parametrize("priors", [False, True], ids=["no prior", "priors"])
def test_solve_step_cg_reads_no_host_on_gpu(cuda_device, priors):
    """A whole damped step (_solve_step_cg: damping, the right-hand side,
    K4, the PCG launch, the back-substitution) on the card under
    torch.cuda.set_sync_debug_mode("error"), which raises at any
    synchronizing call; its count stays a device tensor."""
    from slslam_tpu_torch.ops import schur_ba, schur_cg
    C, L, O = kernel_checks.SCHUR_SHAPES["refine"]
    a = kernel_checks.k2_lm_case(torch.float32, cuda_device, C=C, L=L,
                                 kL=O // L)
    plan = kernels.ba_plan(a["obs_cam"], a["obs_line"], a["w_valid"], C, L,
                           "lm")
    _, Hcc, Hll, gc, gl, Wb = kernels.fused_eval(**a, variant="lm",
                                                 plan=plan)
    Hoff = prior = None
    if priors:
        prior = schur_cg._prior_edges(
            C, torch.zeros(C - 1, 6, device=cuda_device), None, 0.02, 0.1,
            torch.float32, cuda_device)
        _, gc_e, Hcc_e, Hoff = schur_ba.prior_terms(prior, a["cam_wt"],
                                                    a["cam_free_f"])
        Hcc, gc = Hcc + Hcc_e, gc + gc_e
    lam = torch.tensor(1e-3, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = schur_cg._solve_step_cg(
            Hcc, Hll, gc, gl, Wb.reshape(L, O // L, 6, 4),
            a["obs_cam"].reshape(L, O // L), plan.cam, lam,
            a["cam_free_f"], a["line_free_f"], 100, 1e-2, Hoff, prior,
            line_plan=plan.line)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out[4].is_cuda and 0 < int(out[4]) <= 100
    assert all(bool(torch.all(torch.isfinite(t))) for t in out[:4])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_large_map_schur_kernels_on_gpu(cuda_device, dtype):
    """K3 and K4 on the large map's own blocks at 1024 cameras x 16 lines:
    K2 ``lm``'s output at the start, damped as a PCG step damps it, held
    to the twins (kernel_checks.check_schur_case: 1e-12 in float64; in
    float32, where the map's ~130 m coordinates cost digits, to the
    float64 twin within the float32 twin's rounding witness)."""
    from slslam_tpu_torch.ops.schur_cg import _eval_system_lm, lm_plan
    _, _, host, t = _large_map(["--cams", "1024", "--lines-per-cam", "16"],
                               cuda_device, dtype)
    C = t["cam_wt"].shape[0]
    w = t["obs_valid"].to(dtype)
    plan = lm_plan(t["obs_cam"], w, C)
    _, Hcc, Hll, gc, gl, Wb = _eval_system_lm(
        t["cam_wt"], t["line_orth"], t["obs"], t["obs_cam"], w,
        t["cam_free"].to(dtype), t["line_free"].to(dtype), 0.12,
        1.0 / 406.05, True, plan=plan)
    case, plan = kernel_checks.schur_step_case(
        Hcc, Hll, gc, gl, Wb, t["obs_cam"], w, t["cam_free"].to(dtype))
    kernel_checks.check_schur_case(case, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_large_map_kernels_on_gpu(cuda_device, dtype):
    """The plan, K1 and K2 ``lm`` at the large map's shapes at 1024
    cameras x 16 lines (the full map's density): the plans and K1 on
    kernel_checks' cases at the solve's (O, C), (O, L), (O, 6, C) and (O,
    36, C); K2 on the problem's own rows and start.  In float64 K2 is held
    to its twin at K2_TOL; in float32 the map's ~130 m world coordinates
    cost digits in both (K2 and its f32 twin part by ~2e-4 of Hcc's
    largest entry), so each is held to the float64 twin, K2 no further
    than twice the f32 twin (and K2_TOL)."""
    from slslam_tpu_torch.ops.schur_cg import _line_rows, lm_plan
    _, _, host, t = _large_map(["--cams", "1024", "--lines-per-cam", "16"],
                               cuda_device, dtype)
    C, L = t["cam_wt"].shape[0], t["line_orth"].shape[0]
    kL = t["obs_cam"].shape[1]
    O = L * kL
    assert O > 200_000
    kernel_checks.check_plans(cuda_device, [(O, C), (O, L)])
    kernel_checks.check_k1(dtype, cuda_device, [(O, 6, C), (O, 36, C)])
    w = t["obs_valid"].to(dtype).reshape(-1)
    args = dict(cam_wt=t["cam_wt"], line_orth=t["line_orth"],
                obs=t["obs"].reshape(O, 8),
                obs_cam=t["obs_cam"].reshape(-1).to(torch.int32),
                obs_line=_line_rows(L, kL, cuda_device), w_valid=w,
                cam_free_f=t["cam_free"].to(dtype),
                line_free_f=t["line_free"].to(dtype), baseline=0.12,
                huber_delta=1.0 / 406.05)
    plan = lm_plan(t["obs_cam"], t["obs_valid"].to(dtype), C)
    got = kernels.fused_eval(**args, variant="lm", plan=plan)
    twin = kernels.fused_eval_twin(**args, variant="lm")
    f64 = kernels.fused_eval_twin(**{k: v.double() if torch.is_tensor(v)
                                     and v.is_floating_point() else v
                                     for k, v in args.items()},
                                  variant="lm")
    for name, a, b, c in zip(kernel_checks.K2_VARIANT_OUTPUTS["lm"], got,
                             twin, f64):
        if dtype == torch.float64:
            err, _ = kernel_checks.errors(a, b)
            assert err <= kernel_checks.K2_TOL[dtype], (name, err)
        else:
            err, _ = kernel_checks.errors(a, c)
            twin_err, _ = kernel_checks.errors(b, c)
            assert err <= max(2 * twin_err, kernel_checks.K2_TOL[dtype]), (
                name, err, twin_err)


@pytest.mark.gpu
def test_large_map_f64_on_gpu_matches_cpu(cuda_device):
    """chip_smoke.py phase 9 (b): the large map at 256 cameras x 4 lines in
    float64 at 10 LM x 40 PCG iterations, the card against the CPU from
    one problem: the same LM and PCG iterations, cameras within 1e-6,
    final cost within 1e-9 relative (rounding alone moves the CPU's
    cameras 1.3e-10 there; at the tool's 30 x 100, ~6e-6)."""
    import numpy as np
    argv = ["--cams", "256", "--lines-per-cam", "4", "--dtype", "float64",
            "--warm-runs", "0", "--max-iters", "10", "--cg-iters", "40"]
    lmb, _, host, _ = _large_map(argv, "cpu", torch.float64)
    outg, camg = lmb.run(lmb.parser().parse_args(argv + ["--device",
                                                         "cuda"]), host)
    outc, camc = lmb.run(lmb.parser().parse_args(argv + ["--device", "cpu"]),
                         host)
    assert outg["iterations"] == outc["iterations"]
    assert outg["cg_iterations"] == outc["cg_iterations"]
    np.testing.assert_allclose(camg, camc, rtol=0, atol=1e-6)
    assert outg["final_cost"] == pytest.approx(outc["final_cost"], rel=1e-9,
                                               abs=0)
    assert outg["rpe_final_m"] < outg["rpe_init_m"]


@pytest.mark.gpu
@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_window_solve_on_gpu_matches_single(cuda_device, world,
                                                    backend):
    """The line-sharded window solve on the card (chip_smoke.py phase 10
    (c) at world 1; at world 2 two ranks share the card over gloo, as the
    backend rule says) against ``local_ba`` on the card, on
    tests/test_distributed.py's house window in float64: the same LM
    iterations, within the JAX package's tolerance for its sharded solve
    (rtol 1e-7, atol 1e-9); both ranks equal bit for bit."""
    import numpy as np

    import torch_mesh_ranks as ranks
    from slslam_tpu_torch.config import CameraConfig
    from slslam_tpu_torch.ops.schur_ba import local_ba
    from slslam_tpu_torch.parallel import run_local_ranks
    problem = ranks.house_window_problem()
    bl, hd = CameraConfig().baseline, 1.0 / CameraConfig().focal_length
    t = [torch.as_tensor(a, device=cuda_device) for a in problem]
    t = [x.double() if x.is_floating_point() else x for x in t]
    cam_s, line_s, st_s = local_ba(*t, bl, hd)
    res = run_local_ranks(ranks.ba_rank, world, args=(problem, bl, hd),
                          device="cuda", timeout_s=300.0)
    for r in res[1:]:
        np.testing.assert_array_equal(r[0], res[0][0])
        np.testing.assert_array_equal(r[1], res[0][1])
    cam, line, it, _, _, _, got_backend = res[0]
    assert got_backend == backend
    assert it == int(st_s.iterations)
    np.testing.assert_allclose(cam, cam_s.cpu().numpy(), rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(line, line_s.cpu().numpy(), rtol=1e-7,
                               atol=1e-9)
