"""tools/torch_param_study.py against tools/param_study.py on the CPU.

``run_one`` on 30 house frames, orth and aid, 0.2 px, window 10, float64,
the port fed JAX's RANSAC stream (``JaxGumbel``): identical average window
LM iterations, ATE and trajectory within 1e-8 m, average costs within
1e-8 relative for orth; for aid within AID_COST_RTOL, since rounding alone
moves them further (below); and the files both tools' mains write from
those results, line for line (the wall time set alike).
"""

import sys

import jax
import numpy as np
import pytest

from test_torch_slam import JaxGumbel
from tools import param_study as jps
from tools import torch_param_study as tps

# the port's own aid run with its twins' sums reversed (kernel_checks.
# reversed_twin_sums) moves the average initial cost by 2.1e-7 and the
# final by 7.7e-8 relative, with the same LM iterations and trajectories
# 1e-11 m apart: the aid windows' costs are that sensitive to rounding
# (the JAX gap on this run: 1.3e-7 and 4.6e-8)
AID_COST_RTOL = 5e-7


@pytest.mark.parametrize("param", ["orth", "aid"])
def test_param_study_run_one_matches_jax(param, tmp_path,
                                         monkeypatch):
    frames, err, basize = 30, 0.2, 10
    a = jps.run_one(param, err, basize, frames, "cpu")
    b = tps.run_one(param, err, basize, frames, "cpu",
                    gumbel_hook=JaxGumbel(jax.random.PRNGKey(4)))
    assert b["dtype"] == "float64" and b["keyframes"] >= 3
    assert b["avg_iters"] == a["avg_iters"] > 0
    rtol = AID_COST_RTOL if param == "aid" else 1e-8
    for k in ("avg_init_cost", "avg_final_cost"):
        assert b[k] == pytest.approx(a[k], rel=rtol, abs=0), k
    assert b["ate"] == pytest.approx(a["ate"], rel=0, abs=1e-8)
    np.testing.assert_allclose(b["est_rows"], a["est_rows"], rtol=0,
                               atol=1e-8)
    # the files of both tools' mains from these results, the wall time set
    # to the JAX side's
    b["total_time"] = a["total_time"]
    argv = ["--frames", str(frames), "--params", param, "--errors",
            str(err), "--basizes", str(basize)]
    monkeypatch.setattr(sys, "argv", ["param_study.py", "--out",
                                      str(tmp_path / "j")] + argv)
    monkeypatch.setattr(jps, "run_one", lambda *_: a)
    jps.main()
    monkeypatch.setattr(tps, "run_one", lambda *_: b)
    tps.main(["--out", str(tmp_path / "t"), "--device", "cpu"] + argv)
    tag = f"{param}_err{err:.1f}_basize{basize}"
    got = (tmp_path / "t" / f"ba_result_{tag}.txt").read_text().splitlines()
    want = (tmp_path / "j" / f"ba_result_{tag}.txt").read_text().splitlines()
    assert [x.split(" = ")[0] for x in got] == [
        "Average number of iterations", "Total time",
        "Average initial costs", "Average final costs"]
    assert got[:2] == want[:2]
    for x, y in zip(got[2:], want[2:]):
        assert float(x.split(" = ")[1]) == pytest.approx(
            float(y.split(" = ")[1]), rel=1e-5)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "t" / f"trajectory_{tag}.txt"),
        np.loadtxt(tmp_path / "j" / f"trajectory_{tag}.txt"), rtol=0,
        atol=1e-8)
