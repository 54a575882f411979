"""How far rounding alone moves the port's solvers, on the CPU in float64.

The card's kernels sum in another order than their CPU twins, so a
card-vs-CPU comparison can only be as tight as a change of that kind moves
the CPU's own result.  These tests measure that with
``kernel_checks.rounding_gaps`` and ``kernel_checks.order_draws`` (the
twins' sums over rows reversed, or in random orders; the inputs moved by
a few units in the last place) and hold the two cases that the GPU tests
(tests/test_torch_gpu.py) compare against them:

* the window solve with prior edges on kernel_checks.prior_ba_case: still
  within 1e-8 after 4 LM iterations, moved past 1e-7 after 10;
* chip_smoke.py phase 3's 60-frame replay refined in 1 round, which stops
  at its 25-iteration cap short of convergence and moves by more than 1e-5
  m in the farthest of order_draws' orders of its sums, while the 3-round
  refine converges and moves by less than 1e-9 m in every one.
"""

import numpy as np
import pytest
import torch

from slslam_tpu_torch import kernel_checks
from slslam_tpu_torch.ops.schur_ba import local_ba

torch.set_num_threads(2)


@pytest.mark.parametrize("iters, lines_moved", [(4, False), (10, True)])
def test_local_ba_prior_edges_rounding_witness(iters, lines_moved):
    arrays, pe = kernel_checks.prior_ba_case()

    def run(arrs):
        t = [torch.as_tensor(a) for a in arrs]
        c, l, s = local_ba(*t, 0.12, 1.0 / 406.05, robust=True,
                           max_iters=iters,
                           prior_edges=tuple(torch.as_tensor(a) for a in pe))
        assert int(s.iterations) == iters
        return c, l

    gaps = kernel_checks.rounding_gaps(run, arrays)
    cams = max(gaps["reversed"][0], gaps["perturbed"][0])
    lines = max(gaps["reversed"][1], gaps["perturbed"][1])
    assert cams <= 1e-8, gaps
    assert (lines > 1e-7) if lines_moved else (lines <= 1e-8), gaps


@pytest.fixture(scope="module")
def replay60():
    """chip_smoke.py phase 3's replay, on the CPU."""
    from slslam_tpu_torch.bench import bench_config, workload
    from slslam_tpu_torch.engine.batch import BatchSlam
    from slslam_tpu_torch.ops.ransac import gumbel_noise
    cfg = bench_config("float64")
    frames, _ = workload(cfg, 60, 4)
    H = cfg.ransac_num_hypotheses

    def hook(fidx, Lp=81):
        g = torch.Generator().manual_seed(1000 + fidx)
        return gumbel_noise(g, (H, Lp), torch.float64, "cpu")

    res = BatchSlam(cfg, device="cpu", gumbel_hook=hook).run(frames)
    return cfg, frames, res


@pytest.mark.parametrize("rounds, at_least, at_most",
                         [(1, 1e-5, np.inf), (3, 0.0, 1e-9)])
def test_refine_moves_with_the_order_of_its_sums(replay60, rounds, at_least,
                                                 at_most):
    from slslam_tpu_torch.engine.refine import global_refine
    cfg, frames, res = replay60

    def refine():
        return global_refine(frames, res.is_kf, res.trajectory, config=cfg,
                             rounds=rounds, method="cg", device="cpu")

    plain = refine()
    draws = kernel_checks.order_draws(refine)
    gap = max(float(np.linalg.norm(a.t - b.t))
              for d in draws for a, b in zip(plain.trajectory, d.trajectory))
    assert all(d.iterations == plain.iterations for d in draws)
    if rounds == 1:
        assert plain.iterations == 25
    assert at_least <= gap <= at_most, gap
