"""The plain reference at a tiny size on the CPU: the survey reference
follows the port's solve in float64 iteration for iteration, its first
LM iterations included."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen import survey_map as sm
from benchmark.reference import survey_ba


def _survey(C=96, A=3):
    prob = sm.make_survey_problem(C=C, lines_per_anchor=A, seed=0)
    rng = np.random.default_rng(7)
    cam0 = prob["cam_wt"].copy()
    cam0[1:, :3] += rng.standard_normal((C - 1, 3)) * 0.005
    cam0[1:, 3:] += rng.standard_normal((C - 1, 3)) * 0.05
    orth0 = sm.av_to_orth_np(sm.perturb_lines_metric(prob["lines_w"], 0.05,
                                                     0.005, rng))
    return prob, cam0, orth0


def test_survey_reference_follows_the_port_in_float64():
    from slslam_tpu_torch.ops.schur_cg import global_ba_cg, pack_line_major
    prob, cam0, orth0 = _survey()
    C, L = len(prob["cam_wt"]), len(prob["lines_w"])
    f = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    pk = pack_line_major(prob["obs"], prob["obs_cam"], prob["obs_line"], C, L)
    free = torch.ones(C, dtype=torch.bool)
    free[0] = False

    def port(iters):
        return global_ba_cg(
            f(cam0), f(orth0), f(pk.obs), torch.as_tensor(pk.obs_cam),
            torch.as_tensor(pk.obs_valid), free,
            torch.ones(L, dtype=torch.bool), 0.12, 1 / 406.05, robust=True,
            max_iters=iters, cg_iters=40)
    cam, orth, st = port(10)
    P = survey_ba.Problem(prob["obs"], prob["obs_cam"], prob["obs_line"], C,
                          L, 0.12, 1 / 406.05, torch.float64, "cpu", rows=999)
    rec = []
    c2, o2, c0, c1, it, pcg = survey_ba.solve(P, f(cam0), f(orth0), 10, 40,
                                              1e-2, record=rec, keep=3)
    assert (it, pcg) == (int(st.iterations), int(st.cg_iterations))
    assert len(rec) == it and sum(r["pcg"] for r in rec) == pcg
    for k in (1, 2, 3):
        ck, ok, sk = port(k)
        assert int(sk.cg_iterations) == sum(r["pcg"] for r in rec[:k])
        assert abs(float(sk.final_cost) - rec[k - 1]["cost"]) <= \
            1e-7 * rec[k - 1]["cost"]
        assert float((ck - rec[k - 1]["cam"]).abs().max()) < 1e-6
        assert float((ok - rec[k - 1]["orth"]).abs().max()) < 1e-5
    assert "cam" not in rec[3]
    assert abs(c0 - float(st.initial_cost)) <= 1e-12 * c0
    assert abs(c1 - float(st.final_cost)) <= 1e-9 * c1
    assert float((cam - c2).abs().max()) < 1e-6
    assert float((orth - o2).abs().max()) < 1e-5
    assert c1 < 0.1 * c0


def test_survey_cost_is_blockwise_exact():
    prob, cam0, orth0 = _survey(C=48, A=2)
    C, L = len(prob["cam_wt"]), len(prob["lines_w"])
    f = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    costs = [float(survey_ba.Problem(prob["obs"], prob["obs_cam"],
                                     prob["obs_line"], C, L, 0.12,
                                     1 / 406.05, torch.float64, "cpu",
                                     rows=r).cost(f(cam0), f(orth0)))
             for r in (97, 10_000)]
    assert abs(costs[0] - costs[1]) <= 1e-12 * costs[1]
