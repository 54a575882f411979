"""The port's kernels (slslam_tpu_torch/ops/kernels.py) vs the Pallas ones.

On the CPU each wrapper takes its plain twin; these tests hold the twins
against the JAX package's Pallas functions run as tests/test_pallas.py runs
them (interpret=True), in float64, with test_pallas.py's tolerance for the
fused evaluate (rtol 1e-6, atol 1e-9).  The CUDA kernels themselves are
checked against the twins by tests/test_torch_gpu.py (opt-in,
SLSLAM_GPU_TESTS=1 on a CUDA machine) and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.ops import pallas_kernels as pk
from slslam_tpu.ops.schur_ba import _eval_system as j_eval_system
from slslam_tpu_torch import kernel_checks
from slslam_tpu_torch.ops import kernels

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-9)


def _seg_case(O, D, P, seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((O, D))
    idx = rng.integers(0, P, O).astype(np.int32)
    idx[::5] = P                             # padding rows
    return vals, idx


@pytest.mark.parametrize("O,D,P,chunk", [(1600, 21, 81, 320),
                                         (162, 42, 4, 162),
                                         (512, 1, 81, 256)])
def test_segment_sum_matches_pallas(O, D, P, chunk):
    vals, idx = _seg_case(O, D, P, O + D)
    ref = pk.segment_sum_pallas(jnp.asarray(vals), jnp.asarray(idx), P,
                                chunk=chunk, interpret=True)
    got = kernels.segment_sum(torch.as_tensor(vals), torch.as_tensor(idx), P)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_assemble_matches_pallas():
    rng = np.random.default_rng(3)
    O, C, L = 512, 8, 32
    parts = [rng.standard_normal((O,) + s)
             for s in ((6, 6), (4, 4), (6, 4), (6,), (4,))]
    oc = rng.integers(0, C, O).astype(np.int32)
    ol = rng.integers(0, L, O).astype(np.int32)
    ref = pk.assemble_pallas(*(jnp.asarray(p) for p in parts),
                             jnp.asarray(oc), jnp.asarray(ol), C, L,
                             interpret=True)
    got = kernels.assemble(*(torch.as_tensor(p) for p in parts),
                           torch.as_tensor(oc), torch.as_tensor(ol), C, L)
    for name, a, b in zip(("Hcc", "Hll", "gc", "gl", "W"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   rtol=1e-12, atol=1e-12)


def _fused_case(seed, repeat_pairs):
    rng = np.random.default_rng(seed)
    C, L, O = 12, 40, 512
    cam = rng.standard_normal((C, 6)) * 0.1
    line = rng.standard_normal((L, 4)) * 0.2
    line[:, 3] = 0.4 + 0.3 * rng.random(L)
    obs = rng.standard_normal((O, 8)) * 0.3
    oc = rng.integers(0, C, O).astype(np.int32)
    ol = rng.integers(0, L, O).astype(np.int32)
    if repeat_pairs:
        oc[1::2], ol[1::2] = oc[0::2], ol[0::2]
    valid = (rng.random(O) < 0.8).astype(np.float64)
    cfree = np.ones(C)
    cfree[0] = 0.0
    lfree = np.ones(L)
    lfree[5] = 0.0
    return (cam, line, obs, oc, ol, valid, cfree, lfree, 0.12, 1.0 / 406.05)


@pytest.mark.parametrize("repeat_pairs", [False, True])
def test_fused_eval_matches_pallas(repeat_pairs):
    """K2's twin against fused_eval_pallas (interpret mode): cost, Hcc,
    Hll, gc, gl and W, with invalid rows, a fixed camera and line, and
    (second case) every (cam, line) pair observed twice."""
    args = _fused_case(11, repeat_pairs)
    ref = pk.fused_eval_pallas(*(jnp.asarray(a) for a in args[:8]),
                               *args[8:], interpret=True)
    before = dict(kernels.launch_counts)
    got = kernels.fused_eval(*(torch.as_tensor(a) for a in args[:8]),
                             *args[8:])
    assert kernels.launch_counts == before    # CPU tensors: the twin ran
    for name, a, b in zip(kernel_checks.K2_OUTPUTS, ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)


def test_fused_eval_non_robust_matches_eval_system():
    args = _fused_case(12, False)
    ref = jax.jit(lambda *a: j_eval_system(*a, False, assembly="scatter"))(
        *(jnp.asarray(a) for a in args[:8]), *args[8:])
    got = kernels.fused_eval(*(torch.as_tensor(a) for a in args[:8]),
                             *args[8:], robust=False)
    for name, a, b in zip(kernel_checks.K2_OUTPUTS, ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)


def test_check_cases_run_on_cpu():
    """The chip's check cases are well-formed (on the CPU both sides are
    the twin, so the errors are exactly zero)."""
    for _, err, max_abs in kernel_checks.check_k1(torch.float64, "cpu"):
        assert err == max_abs == 0.0
    args = kernel_checks.k2_case(torch.float64, "cpu")
    assert args["obs"].shape == (1600, 8)
    assert kernel_checks.check_k2(torch.float64, "cpu")["W"] == (0.0, 0.0)


def test_wrappers_reject_other_devices():
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        kernels.segment_sum(x, torch.zeros(4, dtype=torch.int32,
                                           device="meta"), 2)


def test_cost_check_case_runs_on_cpu():
    """K2 ``cost``'s check case is well-formed: on the CPU both sides are
    the twin (the error is exactly zero), the case drops rows, and NaNs in
    them leave the cost as it was."""
    assert kernel_checks.check_k2_cost(torch.float64, "cpu") == (0.0, 0.0)


def test_cost_work_is_the_benchmark_yardstick():
    """kernel_checks.cost_work is the closed form that the benchmark froze
    (benchmark/frozen/kernel_work.py), at the map's and the refine's rows."""
    from benchmark.frozen import kernel_work as kw
    for e in (4, 8):
        assert kernel_checks.cost_work(8192, 109_147, 929_796, e) == \
            kw.cost_work(8192, 109_147, 929_796, e)
        assert kernel_checks.cost_work(400, 74, 29_363, e) == \
            kw.cost_work(400, 74, 29_363, e)


def _bad_cost_args(case, args, plan):
    """fused_cost's arguments and plan, broken as ``case`` says."""
    args = dict(args)
    if case == "obs shape":
        args["obs"] = args["obs"][:, :7]
    elif case == "camera shape":
        args["cam_wt"] = args["cam_wt"][:, :5]
    elif case == "index dtype":
        args["obs_cam"] = args["obs_cam"].long()
    elif case == "weight dtype":
        args["w_valid"] = args["w_valid"].float()
    elif case == "not contiguous":
        args["obs"] = args["obs"].t().contiguous().t()
    elif case == "plan of the cameras":
        plan = plan._replace(line=plan.cam)
    elif case == "no line plan":
        plan = plan._replace(line=None)
    return args, plan


COST_BAD = {"obs shape": ValueError, "camera shape": ValueError,
            "index dtype": TypeError, "weight dtype": TypeError,
            "not contiguous": ValueError, "plan of the cameras": ValueError,
            "no line plan": ValueError}


@pytest.mark.parametrize("case", [*COST_BAD, "sound"])
def test_fused_cost_checks_before_a_launch(monkeypatch, case):
    """fused_cost's card path refuses bad shapes, dtypes, layouts and plans
    before it reaches the kernel library, and counts no launch; sound
    arguments reach it.  (The tensors stay on the CPU: the card path is
    forced and the library replaced by a stub that records the call.)"""
    args, plan = kernel_checks.k2_cost_case(torch.float64, "cpu",
                                            shape=(40, 12, 12 * 16))
    args, plan = _bad_cost_args(case, args, plan)
    monkeypatch.setattr(kernels, "_device_kind", lambda name, t: "cuda")

    class Reached(Exception):
        pass

    def library():
        raise Reached

    monkeypatch.setattr(kernels, "load_library", library)
    before = dict(kernels.launch_counts)
    with pytest.raises(COST_BAD.get(case, Reached)):
        kernels.fused_cost(**args, plan=plan)
    assert kernels.launch_counts == before
