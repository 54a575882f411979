"""The benchmark's frozen copies agree with the port they were copied
from: the survey map generator, and the closed forms of kernel work with
the peaks."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from benchmark.frozen import kernel_work as kw
from benchmark.frozen import survey_map as sm
from benchmark.tests.conftest import ROOT


def _port_tool():
    import importlib.util
    path = os.path.join(ROOT, "tools", "torch_large_map_bench.py")
    spec = importlib.util.spec_from_file_location("torch_large_map_bench",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("C,A,seed,noise", [(128, 4, 0, 0.3),
                                            (256, 2, 5, 0.0)])
def test_survey_map_equals_port(C, A, seed, noise):
    from slslam_tpu_torch import hostgeom
    tool = _port_tool()
    a = sm.make_survey_problem(C=C, lines_per_anchor=A, noise_px=noise,
                               seed=seed)
    b = tool.make_survey_problem(C=C, lines_per_anchor=A, noise_px=noise,
                                 seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    pa = sm.perturb_lines_metric(a["lines_w"], 0.05, 0.005,
                                 np.random.default_rng(2))
    pb = tool.perturb_lines_metric(b["lines_w"], 0.05, 0.005,
                                   np.random.default_rng(2))
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(sm.av_to_orth_np(pa),
                                  hostgeom.av_to_orth_np(pb))
    assert (sm.HALF_W, sm.HALF_H) == (tool.HALF_W, tool.HALF_H)


def test_kernel_work_equals_port():
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops.schur_cg import lm_plan, pack_line_major
    assert (kw.HBM_BYTES_PER_S, kw.F32_FLOP_PER_S) == (kc.HBM_BYTES_PER_S,
                                                       kc.F32_FLOP_PER_S)
    for nb, fl in ((1e9, 1e6), (1e3, 1e12)):
        assert kw.bound(nb, fl) == kc.bound(nb, fl)
    assert kw.plan_work(3_492_704, 109_147) == kc.plan_work(3_492_704,
                                                            109_147)
    for v in ("full", "cams", "lines", "lm"):
        assert kw.k2_row_ops(v) == kc.k2_row_ops(v)
    for name in ("schur_pcg", "schur_matvec/line", "schur_matvec/cam",
                 "schur_jacobi"):
        for e in (4, 8):
            assert kw.schur_work(name, 8192, 109_147, 929_796, e) == \
                kc.schur_work(name, 8192, 109_147, 929_796, e)
    assert kw.schur_work("schur_matvec/cam", 400, 74, 29_000, 4, rhs=True) \
        == kc.schur_work("schur_matvec/cam", 400, 74, 29_000, 4, rhs=True)
    vals = torch.zeros(50, 6)
    idx = torch.tensor([0, 3, 9, -1, 2] * 10)
    assert kw.k1_work(vals, idx, 8) == kc.k1_work(vals, idx, 8)
    # k2_work over counts equals the port's k2_work on a packed problem
    prob = sm.make_survey_problem(C=64, lines_per_anchor=2)
    C, L = len(prob["cam_wt"]), len(prob["lines_w"])
    pk = pack_line_major(prob["obs"], prob["obs_cam"], prob["obs_line"], C, L)
    obs_cam = torch.as_tensor(pk.obs_cam)
    w_valid = torch.as_tensor(pk.obs_valid).float()
    plan = lm_plan(obs_cam, w_valid, C)
    args = {"cam_wt": torch.zeros(C, 6), "line_orth": torch.zeros(L, 4),
            "obs": torch.zeros(L * pk.kL, 8)}
    n = int(pk.obs_valid.sum())
    assert kw.k2_work_counts(C, L, L * pk.kL, n, 4, "lm",
                             (C + 1, L + 1)) == kc.k2_work(args, "lm", plan)
