"""The port's copies of the JAX package's jax-free modules vs the originals,
and the port's independence from the JAX package.

slslam_tpu_torch keeps cited copies of what it needs from slslam_tpu.config,
slslam_tpu.hostgeom, slslam_tpu.sim and slslam_tpu.evalio.writers.  These
tests hold each copy to its original on the same inputs (exact equality),
and check that importing every module of the port, chip_smoke and
profile_replay loads neither jax nor slslam_tpu."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import slslam_tpu_torch
from slslam_tpu import config as jconfig
from slslam_tpu import hostgeom as jhost
from slslam_tpu import sim as jsim
from slslam_tpu.evalio import writers as jwriters
from slslam_tpu_torch import config as tconfig
from slslam_tpu_torch import hostgeom as thost
from slslam_tpu_torch import sim as tsim
from slslam_tpu_torch.evalio import writers as twriters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_slam_config_fields_identical():
    j, t = jconfig.SlamConfig(), tconfig.SlamConfig()
    assert ([f.name for f in dataclasses.fields(j)]
            == [f.name for f in dataclasses.fields(t)])
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.error_thr, j.huber_delta) == (t.error_thr, t.huber_delta)
    jc, tc = jconfig.CameraConfig(), tconfig.CameraConfig()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (jc.fx, jc.fy) == (tc.fx, tc.fy)


@pytest.mark.parametrize("n", [0, 1, 80, 81, 2048, 5000])
def test_bucket_for_identical(n):
    buckets = jconfig.SlamConfig().line_buckets
    assert tconfig.bucket_for(n, buckets) == jconfig.bucket_for(n, buckets)


@pytest.mark.parametrize("shift", [True, False])
def test_house_segments_identical(shift):
    np.testing.assert_array_equal(tsim.house_segments(shift=shift),
                                  jsim.house_segments(shift=shift))


def test_wave_trajectory_identical():
    for a, b in zip(tsim.wave_trajectory(400), jsim.wave_trajectory(400),
                    strict=True):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
def test_renderer_identical(noise_px):
    poses = jsim.wave_trajectory(400)[::40]
    ren_j = jsim.StereoLineRenderer(jsim.house_segments(),
                                    jconfig.CameraConfig(),
                                    noise_px=noise_px, seed=3)
    ren_t = tsim.StereoLineRenderer(tsim.house_segments(),
                                    tconfig.CameraConfig(),
                                    noise_px=noise_px, seed=3)
    for T in poses:
        a = ren_j.observe(T)
        b = ren_t.observe(thost.Pose(T.R, T.t))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _rotations():
    rng = np.random.default_rng(5)
    ws = [rng.standard_normal(3) * s for s in (1e-9, 1e-3, 0.5, 2.0)]
    ws.append(np.array([np.pi - 1e-4, 0.0, 0.0]))   # so3_log's near-pi arm
    ws.append(np.zeros(3))
    return [jhost.rodrigues(w) for w in ws]


def test_hostgeom_identical():
    for R in _rotations():
        np.testing.assert_array_equal(thost.so3_log(R), jhost.so3_log(R))
        w = jhost.so3_log(R)
        np.testing.assert_array_equal(thost.rodrigues(w), jhost.rodrigues(w))
        t = np.array([0.3, -1.0, 2.0])
        a, b = jhost.Pose(R, t), thost.Pose(R, t)
        for x, y in ((a.inv(), b.inv()), (a @ a.inv(), b @ b.inv()),
                     (a.rel_to(a.inv()), b.rel_to(b.inv())),
                     (jhost.Pose.from_wt(a.wt()),
                      thost.Pose.from_wt(b.wt()))):
            np.testing.assert_array_equal(x.R, y.R)
            np.testing.assert_array_equal(x.t, y.t)


def test_trajectory_writers_identical(tmp_path):
    poses = [T.inv() for T in jsim.wave_trajectory(50)]
    jwriters.write_trajectory(tmp_path / "j.txt", poses)
    twriters.write_trajectory(tmp_path / "t.txt",
                              [thost.Pose(T.R, T.t) for T in poses])
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    np.testing.assert_array_equal(twriters.trajectory_rows(poses),
                                  jwriters.trajectory_rows(poses))


def _port_modules():
    mods = [slslam_tpu_torch.__name__]
    for info in pkgutil.walk_packages(slslam_tpu_torch.__path__,
                                      slslam_tpu_torch.__name__ + "."):
        mods.append(info.name)
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter imports every module of the port, chip_smoke
    and profile_replay: jax and slslam_tpu stay out of sys.modules."""
    mods = _port_modules() + ["chip_smoke", "profile_replay"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'slslam_tpu' or "
            "m.startswith('slslam_tpu.'))\n"
            "print(len(bad), bad[:10])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[0] == "0", proc.stdout
    assert len(mods) > 15


def _sources():
    root = os.path.join(REPO, "slslam_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "profile_replay.py")


def test_port_sources_name_no_jax_import():
    """No import statement of the port (including those inside functions)
    names jax or slslam_tpu."""
    found = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("jax", "slslam_tpu"):
                    found.append((os.path.relpath(path, REPO), n))
    assert found == []
