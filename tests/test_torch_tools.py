"""The port's tools against the JAX package's on the CPU.

* tools/torch_large_map_bench.py: the survey problem and the metric line
  perturbation bit for bit against tools/large_map_bench.py's; the solve
  (128 cameras x 4 lines, 10 LM x 40 PCG iterations, float64) against the
  JAX tool's ``global_ba_cg_impl`` call on the same problem: the same LM
  iterations, final cost within 1e-9 relative, cameras within 1e-8 m, the
  ground-truth cost within 1e-12 relative, without and with the odometry
  prior; the tool's JSON carries every key of the JAX tool's;
* tools/torch_scale_lc.py: the workload's frames, vocabulary, parameters
  and configuration identical to those tools/scale_lc.py builds (as
  tools/jax_scale_lc_reference.py copies it; 340
  frames, the orbits of the 1000-frame default), and the
  tool end to end on the CPU at 60 frames (one run) with the JAX tool's
  JSON keys.

tests/test_torch_param_study.py holds tools/torch_param_study.py.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu import geometry as jgeo
from slslam_tpu.ops import schur_cg as jcg
from tools import jax_scale_lc_reference as jref
from tools import large_map_bench as jlm
from tools import torch_large_map_bench as tlm
from tools import torch_scale_lc as tsl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool_keys(tool, func="main"):
    """The keys of the JSON record that the JAX tool's ``func`` prints:
    the keywords of its ``dict(...)`` call or the keys of its dict
    literal passed to json.dumps."""
    with open(os.path.join(REPO, "tools", tool)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "dict"):
            keys |= {k.arg for k in node.keywords}
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            keys |= {k.value for k in node.args[0].keys}
    assert len(keys) > 10
    return keys


# ---------------------------------------------------------------------------
# Large map
# ---------------------------------------------------------------------------

def test_survey_problem_identical_to_jax():
    a = jlm.make_survey_problem(C=64, lines_per_anchor=8)
    b = tlm.make_survey_problem(C=64, lines_per_anchor=8)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
        assert b[k].dtype == a[k].dtype
    assert len(a["obs"]) > 1000
    for seed in (0, 7):
        np.testing.assert_array_equal(
            tlm.perturb_lines_metric(a["lines_w"], 0.05, 0.005,
                                     np.random.default_rng(seed)),
            jlm.perturb_lines_metric(a["lines_w"], 0.05, 0.005,
                                     np.random.default_rng(seed)))


ARGS = ["--device", "cpu", "--cams", "128", "--lines-per-cam", "4",
        "--max-iters", "10", "--cg-iters", "40", "--warm-runs", "0"]


def _jax_solve(args):
    """The JAX tool's problem, start and ``global_ba_cg_impl`` call
    (large_map_bench.py:213-248, 282-288) in float64: (cameras, stats,
    cost at the ground truth)."""
    prob = jlm.make_survey_problem(C=args.cams,
                                   lines_per_anchor=args.lines_per_cam)
    C, L = len(prob["cam_wt"]), len(prob["lines_w"])
    packed = jcg.pack_line_major(prob["obs"], prob["obs_cam"],
                                 prob["obs_line"], C, L)
    rng = np.random.default_rng(7)
    cam0 = prob["cam_wt"].copy()
    cam0[1:, :3] += rng.standard_normal((C - 1, 3)) * args.cam_sigma_rot
    cam0[1:, 3:] += rng.standard_normal((C - 1, 3)) * args.cam_sigma_t
    lines0 = jlm.perturb_lines_metric(prob["lines_w"], args.line_sigma_cp_m,
                                      args.line_sigma_dir_rad, rng)
    orth0 = np.asarray(jgeo.av_to_orth(jnp.asarray(lines0)))
    cam_free = np.ones(C, bool)
    cam_free[0] = False
    prior_c = None
    if args.prior:
        from slslam_tpu.hostgeom import Pose
        chain = [Pose.from_wt(w) for w in cam0]
        prior_c = jnp.asarray(np.stack([(chain[i + 1] @ chain[i].inv()).wt()
                                        for i in range(C - 1)]))
    f64 = jnp.float64
    ba = (jnp.asarray(cam0, f64), jnp.asarray(orth0, f64),
          jnp.asarray(packed.obs, f64),
          jnp.asarray(packed.obs_cam, jnp.int32),
          jnp.asarray(packed.obs_valid),
          jnp.asarray(packed.cam_perm, jnp.int32),
          jnp.asarray(packed.cam_perm_valid), jnp.asarray(cam_free),
          jnp.ones(L, bool), jnp.asarray(0.12, f64),
          jnp.asarray(1.0 / 406.05, f64))
    cam1, _, stats = jax.jit(lambda *a: jcg.global_ba_cg_impl(
        *a, robust=True, max_iters=args.max_iters, cg_iters=args.cg_iters,
        prior_c=prior_c, prior_sigma_rot=0.2, prior_sigma_t=2.0))(*ba)
    orth_gt = np.asarray(jgeo.av_to_orth(jnp.asarray(prob["lines_w"])))
    gt_cost = float(jcg._eval_system_lm(
        jnp.asarray(prob["cam_wt"]), jnp.asarray(orth_gt), ba[2], ba[3],
        jnp.asarray(packed.obs_valid, f64), ba[5], ba[6], jnp.ones(C, f64),
        jnp.ones(L, f64), ba[9], ba[10], True, "orth")[0])
    return np.asarray(cam1), stats, gt_cost


@pytest.mark.parametrize("prior", [False, True])
def test_large_map_solve_matches_jax(prior):
    args = tlm.parser().parse_args(ARGS + (["--prior"] if prior else []))
    jcam, jstats, jgt = _jax_solve(args)
    out, cam = tlm.run(args)
    assert out["iterations"] == int(jstats.iterations) == args.max_iters
    assert out["cg_iterations"] > out["iterations"]
    assert out["final_cost"] == pytest.approx(float(jstats.final_cost),
                                              rel=1e-9, abs=0)
    assert out["initial_cost"] == pytest.approx(
        float(jstats.initial_cost), rel=1e-12, abs=0)
    assert out["cost_at_gt"] == pytest.approx(jgt, rel=1e-12, abs=0)
    np.testing.assert_allclose(cam, jcam, rtol=0, atol=1e-8)
    assert out["rpe_final_m"] < out["rpe_init_m"]
    assert set(out) >= _jax_tool_keys("large_map_bench.py")
    assert out["xla_flops_per_solve"] is None and out["platform"] == "cpu"
    assert out["dtype"] == "float64" and out["num_cams"] == 128


# ---------------------------------------------------------------------------
# Scale LC
# ---------------------------------------------------------------------------

def test_scale_lc_workload_identical_to_jax():
    j = jref.workload(340, 3.35, "float32")
    t = tsl.workload(340, 3.35, "float32")
    assert dataclasses.asdict(t[0]) == dataclasses.asdict(j[0])
    assert len(t[1]) == len(j[1]) == 340
    for a, b in zip(j[1], t[1], strict=True):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    for a, b in zip(j[2], t[2], strict=True):
        np.testing.assert_array_equal(b.R, a.R)
        np.testing.assert_array_equal(b.t, a.t)
    np.testing.assert_array_equal(t[3].base, j[3].base)
    np.testing.assert_array_equal(t[4], j[4])
    assert dataclasses.asdict(t[5]) == dataclasses.asdict(j[5])
    # the descriptor sources' noise streams, one frame each
    ids = sorted(j[1][5])
    np.testing.assert_array_equal(t[3](5, ids), j[3](5, ids))


def test_scale_lc_tool_runs_on_cpu():
    torch.manual_seed(0)
    out, res = tsl.run(60, prefixes=True, device="cpu", warm=False)
    assert set(out) >= _jax_tool_keys("scale_lc.py")
    assert set(out["wall_breakdown"]) == set(tsl.WALL_KEYS)
    assert out["platform"] == "cpu" and out["dtype"] == "float64"
    assert out["keyframes"] == 60 and out["warm_s"] is None
    assert out["num_loop_closures"] >= 1
    assert out["ate_final_m"] < out["ate_odometry_m"]
    assert sorted(out["recognition_scan_wall_by_K"]) == [15, 30, 60]
    assert all(np.isfinite(T.t).all() for T in res.trajectory)
