"""The CUDA kernels against their plain twins on the card (opt-in).

The checks of chip_smoke.py phases 1 and 2 (slslam_tpu_torch/
kernel_checks.py, tolerances stated there), as tests: the segment plan,
K1 with and without a plan, and every K2 variant launched twice (the two
launches must agree bit for bit; ``lm``'s dropped Wb rows must come out
exactly zero), then on two streams at once and from a CUDA graph (each
launch keeps its own last-block counter, so every result equals an eager
launch's bit for bit); the line-major plan's shapes; and a short global
refine on the card against the same refine on the CPU.  They run only
with SLSLAM_GPU_TESTS=1 on a machine with an NVIDIA GPU and nvcc, and skip
otherwise.  The file imports no jax, so on a machine without it run

    SLSLAM_GPU_TESTS=1 python -m pytest tests/test_torch_gpu.py \\
        --noconftest -o addopts= -q
"""

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
