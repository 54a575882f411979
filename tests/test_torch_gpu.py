"""The CUDA kernels against their plain twins on the card (opt-in).

The checks of chip_smoke.py phases 1 and 2 (slslam_tpu_torch/
kernel_checks.py, tolerances stated there), as tests.  They run only with
SLSLAM_GPU_TESTS=1 on a machine with an NVIDIA GPU and nvcc, and skip
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_kernel_on_gpu(cuda_device, dtype):
    before = kernels.launch_counts["segment_sum"]
    kernel_checks.check_k1(dtype, cuda_device)
    assert kernels.launch_counts["segment_sum"] > before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_eval_kernel_on_gpu(cuda_device, dtype):
    before = kernels.launch_counts["fused_eval"]
    kernel_checks.check_k2(dtype, cuda_device)
    assert kernels.launch_counts["fused_eval"] == before + 2
