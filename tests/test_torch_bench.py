"""The port's bench entry (slslam_tpu_torch/bench.py) and the CLI's
``--refine`` on the CPU at a tiny size: the JSON contract of bench.py, and
the refine's stats and files.  The numbers here are CPU numbers and say
nothing of the card; they only show that the entry points run end to
end."""

import json
import math

import numpy as np
import pytest
import torch

from slslam_tpu_torch import bench
from slslam_tpu_torch.cli import main as cli_main

torch.set_num_threads(1)


def test_bench_prints_the_contract_on_cpu(capsys):
    value, extra = bench.bench_batch("cpu", num_frames=8, seeds=(4,),
                                     dtype="float64", budget_s=0.0)
    out, err = capsys.readouterr()
    head = json.loads(out.strip().splitlines()[-1])
    assert set(head) == {"metric", "value", "unit", "vs_baseline"}
    assert (head["metric"], head["unit"]) == ("keyframes_per_s", "kf/s")
    assert head["value"] == round(value, 3) > 0
    assert head["vs_baseline"] == round(value / bench.BASELINE_KF_PER_S, 3)
    rec = json.loads(err.strip().splitlines()[-1])
    assert rec == json.loads(json.dumps(extra))
    for key in ("worst_seed_ate_refined_m", "worst_seed_ate_raw_m",
                "per_seed", "avg_ba_iterations", "num_landmarks", "cold_s",
                "warm_walls_s"):
        assert key in rec, key
    assert rec["warm_walls_s"] == [] and rec["cold_s"] > 0
    seed = rec["per_seed"]["4"]
    assert seed["kf"] == 8 and seed["refine_iterations"] > 0
    assert math.isfinite(seed["ate_refined"])
    assert rec["worst_seed_ate_refined_m"] == seed["ate_refined"]
    assert "serial" in rec["mode"]


@pytest.mark.parametrize("as_extra", [False, True])
def test_bench_lc_prints_the_contract_on_cpu(capsys, as_extra):
    """BENCH_MODE=lc's record (bench.py:435-463) at 16 frames of the
    village orbit: too short to close a loop, long enough to run every
    stage of the post-pass that has input."""
    value, extra = bench.bench_lc("cpu", dtype="float64", budget_s=0.0,
                                  num_frames=16, arc=0.4, as_extra=as_extra)
    out, err = capsys.readouterr()
    rec = json.loads(err.strip().splitlines()[-1])
    if as_extra:
        assert out == ""
        assert (rec["metric"], rec["unit"]) == ("lc_keyframes_per_s", "kf/s")
        assert rec["value"] == round(value, 3) > 0
    else:
        head = json.loads(out.strip().splitlines()[-1])
        assert head["metric"] == "keyframes_per_s"
        assert head["value"] == round(value, 3) > 0
        assert rec == json.loads(json.dumps(extra))
    for key in ("keyframes", "cold_s", "warm_s", "num_loop_closures",
                "num_merged_tracks", "ate_odometry_m", "ate_final_m",
                "wall_breakdown", "wall_confirm_stages", "device",
                "refine_pick"):
        assert key in rec, key
    assert rec["mode"] == "lc" and rec["keyframes"] == 16
    assert set(rec["wall_breakdown"]) == set(bench.LC_WALLS)
    assert math.isfinite(rec["ate_final_m"])


@pytest.mark.parametrize("env,expected", [
    (dict(), ["batch", "lc extra"]),
    (dict(BENCH_LC="0"), ["batch"]),
    (dict(BENCH_BUDGET_S="150"), ["batch"]),
    (dict(BENCH_MODE="lc"), ["lc"]),
    (dict(BENCH_MODE="interactive"), ["interactive"])])
def test_main_runs_the_modes(monkeypatch, env, expected):
    """The batch mode appends the lc line when 200 s of the budget remain
    and BENCH_LC is not 0 (bench.py:555-566); BENCH_MODE=lc runs lc
    alone."""
    ran = []
    monkeypatch.setattr(bench, "bench_batch",
                        lambda *a, **k: ran.append("batch"))
    monkeypatch.setattr(bench, "bench_lc", lambda *a, **k: ran.append(
        "lc extra" if k.get("as_extra") else "lc"))
    monkeypatch.setattr(bench, "bench_interactive", lambda *a, **k: (
        ran.append("interactive"), (1.0, {}))[1])
    for key in ("BENCH_LC", "BENCH_BUDGET_S", "BENCH_MODE"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    bench.main()
    assert ran == expected


def test_bench_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.bench_batch(num_frames=2, seeds=(4,))


def test_cli_refine_on_cpu(tmp_path, capsys):
    cli_main(["sim", "--engine", "batch", "--frames", "12", "--device",
              "cpu", "--dtype", "float64", "--refine", "--out",
              str(tmp_path)])
    stats = json.loads((tmp_path / "stats.json").read_text())
    for key in ("refine_wall_s", "refine_iterations", "refine_initial_cost",
                "refine_final_cost", "refine_num_cams", "refine_num_obs",
                "refine_ate_m"):
        assert key in stats, key
    K = stats["num_keyframes"]
    assert stats["refine_num_cams"] == K >= 2
    assert stats["refine_num_obs"] > 0
    assert stats["refine_final_cost"] < stats["refine_initial_cost"]
    rows = np.loadtxt(tmp_path / "trajectory_refined.txt")
    assert rows.shape[0] == K and np.all(np.isfinite(rows))


def test_bench_interactive_on_cpu():
    """BENCH_MODE=interactive's workload at 8 frames (3 of warm-up) on the
    CPU: bench.py's keys (bench.py:510-522), every measured frame a
    keyframe."""
    kf_per_s, rec = bench.bench_interactive("cpu", dtype="float64",
                                            num_frames=8, warmup_frames=3)
    for key in ("mean_rate_kf_s", "median_frame_ms", "ba_mean_ms",
                "vo_mean_ms", "avg_ba_iterations", "keyframes",
                "measured_frames", "post_processing"):
        assert key in rec, key
    assert rec["mode"] == "interactive"
    assert rec["keyframes"] == rec["measured_frames"] == 5
    assert math.isclose(kf_per_s, 1e3 / rec["median_frame_ms"])
    assert rec == json.loads(json.dumps(rec))
    cfg = bench.interactive_config("float32")
    assert (cfg.obs_buckets, cfg.cam_buckets, cfg.line_buckets,
            cfg.corr_buckets) == ((2048,), (48,), (128,), (128,))
