"""The port's ``Slam`` on its mesh path, and the CLI's multi-process runs,
on the CPU.

* ``Slam`` with ``mesh_devices=2`` (two gloo ranks, spawned) over
  tests/test_distributed.py's 14 house frames (0.3 px, render seed 1,
  float64), each rank fed the JAX engine's RANSAC noise (recorded from the
  port's single-process run with ``JaxGumbel``), against the JAX package's
  ``Slam`` with ``mesh_devices=8`` and with 0: the same keyframes and
  edges, trajectories within 1e-8 m (the JAX package's own tolerance for
  its mesh engine, test_distributed.py:234); both ranks equal bit for bit.
  Then one ``pose_optimization`` of each engine's graph (the run itself
  triggers none): the mesh engine's edge-sharded PGO, its edges padded to
  the world size, against the single-process engine's, 1e-8 m.
  Without a process group, ``mesh_devices=2`` raises.
* ``cli sim`` as two ranks, started by the explicit flags (``--multihost
  --coordinator 127.0.0.1:<free port> --num-processes 2 --process-id i``)
  and by torchrun: only rank 0 writes, and what it writes equals the
  single-process run's.

Each spawned group runs under a 120 s limit.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from slslam_tpu.config import SlamConfig as JaxConfig
from slslam_tpu.engine import Slam as JaxSlam
from slslam_tpu.evalio.writers import trajectory_rows as jax_rows
from slslam_tpu_torch.config import CameraConfig, SlamConfig
from slslam_tpu_torch.engine import Slam
from slslam_tpu_torch.parallel import run_local_ranks
from slslam_tpu_torch.sim import (StereoLineRenderer, house_segments,
                                  wave_trajectory)
from test_torch_slam import JaxGumbel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120.0


class Recording(JaxGumbel):
    """JaxGumbel that keeps every noise it hands out."""

    def __init__(self, key):
        super().__init__(key)
        self.noises = []

    def __call__(self, i, H, Nb):
        g = super().__call__(i, H, Nb)
        self.noises.append(g.numpy())
        return g


def _frames():
    ren = StereoLineRenderer(house_segments(), CameraConfig(), noise_px=0.3,
                             seed=1)
    return [ren.observe(T) for T in wave_trajectory(num_frames=14)]


def _jax_run(frames, mesh_devices):
    cfg = dataclasses.replace(JaxConfig(), compute_dtype="float64",
                              mesh_devices=mesh_devices)
    slam = JaxSlam(cfg)
    kf = [i for i, f in enumerate(frames) if slam.process_frame(f, i)]
    return kf, np.asarray(jax_rows(slam.trajectory())), sorted(
        slam.state.edge_set)


@pytest.fixture(scope="module")
def runs():
    frames = _frames()
    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64")
    rec = Recording(jax.random.PRNGKey(cfg.rseed))
    single = ranks.run_slam(Slam(cfg, device="cpu", gumbel_hook=rec), frames)
    mesh = run_local_ranks(ranks.slam_rank, 2,
                           args=(cfg, frames, rec.noises), device="cpu",
                           timeout_s=RANK_TIMEOUT_S)
    return {"jax0": _jax_run(frames, 0), "jax8": _jax_run(frames, 8),
            "single": single, "mesh": mesh}


@pytest.mark.parametrize("ref", ["jax8", "jax0"])
def test_slam_mesh2_matches_jax(runs, ref):
    kf_j, rows_j, edges_j = runs[ref]
    kf, rows, edges, lms, iters, stats, _ = runs["mesh"][0]
    assert len(kf) >= 3
    assert kf == kf_j
    assert [tuple(e) for e in edges] == [tuple(e) for e in edges_j]
    np.testing.assert_allclose(rows, rows_j, rtol=0, atol=1e-8)
    assert stats["mesh_devices"] == 2
    assert stats["dist_backend"] == "gloo"


def test_slam_mesh2_ranks_equal_bit_for_bit(runs):
    a, b = runs["mesh"]
    assert a[0] == b[0] and a[2:5] == b[2:5]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[6], b[6])


def test_slam_mesh2_pose_graph_matches_single(runs):
    single, mesh = runs["single"], runs["mesh"][0]
    # 13 edges: the sharded PGO pads them to 14, 7 a rank
    assert len(mesh[2]) % 2 == 1 and len(mesh[2]) >= 3
    assert mesh[5]["num_pose_graph_runs"] == 1
    assert single[5]["num_pose_graph_runs"] == 1
    np.testing.assert_allclose(mesh[6], single[6], rtol=0, atol=1e-8)


def test_slam_mesh_without_a_group_raises():
    cfg = dataclasses.replace(SlamConfig(), mesh_devices=2)
    with pytest.raises(RuntimeError, match="mesh_devices=2 needs an "
                       "initialized process group"):
        Slam(cfg, device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# tests/test_distributed.py:207-234's problem (0.3 px, render seed 1),
# where the JAX package holds its own mesh engine to 1e-8 m.  At the CLI's
# default 0.5 px and seed 4 the 14-frame run loses the track (ATE 14.4 m),
# and there the mesh and single runs part by 2.8e-6 m.
SIM = ["sim", "--frames", "14", "--noise-px", "0.3", "--rseed", "1",
       "--device", "cpu", "--dtype", "float64"]


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _run_all(cmds, timeout=RANK_TIMEOUT_S):
    """Start every command at once; wait for all (killing them past the
    limit); returns their outputs."""
    procs = [subprocess.Popen(c, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def _cli(*args):
    return [sys.executable, "-m", "slslam_tpu_torch.cli", *args]


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("single")
    _run_all([_cli(*SIM, "--out", str(out))])
    return out


def _rows(path):
    text = path.read_text()
    return np.loadtxt(path, ndmin=2) if text.strip() else np.zeros((0, 0))


def _assert_same_outputs(out, ref):
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref))
    for f in ("trajectory.txt", "landmarks.txt", "gt_trajectory.txt"):
        np.testing.assert_allclose(_rows(out / f), _rows(ref / f), rtol=0,
                                   atol=1e-8)
    a = json.loads((out / "stats.json").read_text())
    b = json.loads((ref / "stats.json").read_text())
    for k in ("keyframe_frames", "num_keyframes", "num_landmarks",
              "num_edges", "avg_num_iterations"):
        assert a[k] == b[k], k
    assert abs(a["ate_m"] - b["ate_m"]) <= 1e-8
    assert (a["mesh_devices"], a["dist_backend"]) == (2, "gloo")


def test_cli_multihost_flags_write_once(single_run, tmp_path):
    port = _free_port()
    outs = [tmp_path / f"rank{i}" for i in range(2)]
    _run_all([_cli(*SIM, "--mesh-devices", "2", "--multihost",
                   "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                   "2", "--process-id", str(i), "--out", str(outs[i]))
              for i in range(2)])
    assert not outs[1].exists()
    _assert_same_outputs(outs[0], single_run)


def test_cli_under_torchrun_writes_once(single_run, tmp_path):
    out = tmp_path / "run"
    logs = _run_all([[sys.executable, "-m", "torch.distributed.run",
                      "--nproc-per-node", "2", "--master-port",
                      str(_free_port()), "-m", "slslam_tpu_torch.cli", *SIM,
                      "--mesh-devices", "2", "--out", str(out)]])
    assert logs[0].count("'backend': 'gloo'") == 2
    _assert_same_outputs(out, single_run)
