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


def test_bench_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.bench_batch(num_frames=2, seeds=(4,))


def test_cli_refine_on_cpu(tmp_path, capsys):
    cli_main(["sim", "--frames", "12", "--device", "cpu", "--dtype",
              "float64", "--refine", "--out", str(tmp_path)])
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
