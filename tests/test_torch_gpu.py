"""The CUDA kernels against their plain twins on the card (opt-in).

The checks of chip_smoke.py phases 1 and 2 (slslam_tpu_torch/
kernel_checks.py, tolerances stated there), as tests: the segment plan,
K1 with and without a plan, and every K2 variant launched twice (the two
launches must agree bit for bit), then on two streams at once and from a
CUDA graph (each launch keeps its own last-block counter, so every result
equals an eager launch's bit for bit).  They run only with SLSLAM_GPU_TESTS=1
on a machine with an NVIDIA GPU and nvcc, and skip otherwise.  The file
imports no jax, so on a machine without it run

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
