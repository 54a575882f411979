"""The port's CLI views and its last commands against the JAX CLI's, on the
CPU.

``gen`` writes files byte for byte equal to the JAX CLI's for the same
arguments; ``view`` builds the same ``map.html`` as the JAX CLI's from
one run directory; ``--plot``, ``--viz``, ``--live-dir`` /
``--live-every``, ``--profile-dir`` (a CPU trace) and ``sim --verbose``
write or print what they should on both engines (``track --live-dir``:
tests/test_torch_frontend_cli.py), and without matplotlib the views are
drawn with PIL.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from slslam_tpu import cli as jcli
from slslam_tpu_torch import cli

torch.set_num_threads(1)


def _files(d):
    return sorted(os.listdir(d))


def test_gen_files_identical_to_jax(tmp_path):
    argv = ["gen", "--frames", "7", "--noise-px", "0.3", "--rseed", "5"]
    jcli.main(argv + ["--out", str(tmp_path / "j")])
    cli.main(argv + ["--out", str(tmp_path / "t")])
    names = _files(tmp_path / "j")
    assert names == _files(tmp_path / "t")
    assert "gt_trajectory.txt" in names and "0006.txt" in names
    for name in names:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


def _embedded(html):
    start = html.index("const D = ") + len("const D = ")
    return json.loads(html[start:html.index(";\n", start)])


@pytest.fixture(scope="module")
def batch_run(tmp_path_factory):
    """``run`` of the batch engine with --refine, --plot and --viz over
    the first 16 frames of a ``gen`` sequence, on the CPU in float64."""
    root = tmp_path_factory.mktemp("batch")
    cli.main(["gen", "--frames", "400", "--out", str(root / "seq")])
    stats = cli.main(["run", "--obs-dir", str(root / "seq"), "--stopfrm",
                      "15", "--engine", "batch", "--refine", "--device",
                      "cpu", "--dtype",
                      "float64", "--plot", "--viz", "--out",
                      str(root / "run")])
    return root, stats


def test_view_identical_to_jax(batch_run, tmp_path):
    root, _ = batch_run
    run = root / "run"
    # the gen sequence's ground truth beside the run, as sim writes it
    np.savetxt(run / "gt_trajectory.txt",
               np.loadtxt(root / "seq" / "gt_trajectory.txt")[:16],
               delimiter="\t")
    for traj in ("trajectory.txt", "trajectory_refined.txt"):
        argv = ["view", "--run", str(run), "--trajectory", traj]
        jcli.main(argv + ["--out", str(tmp_path / "j.html")])
        out = cli.main(argv + ["--out", str(tmp_path / "t.html")])
        assert out == str(tmp_path / "t.html")
        a = (tmp_path / "j.html").read_text()
        b = (tmp_path / "t.html").read_text()
        assert b == a
        d = _embedded(b)
        assert len(d["traj"]) == len(np.loadtxt(run / traj)) > 1
        assert d["gt"] is not None and d["title"] == "run"
        assert len(d["segs"]) > 5
    os.remove(run / "gt_trajectory.txt")


def test_batch_plot_and_viz(batch_run):
    root, _ = batch_run
    run = root / "run"
    assert (run / "map.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    d = _embedded((run / "map.html").read_text())
    refined = np.loadtxt(run / "trajectory_refined.txt")
    # --viz shows the refined trajectory (slslam_tpu/cli.py:209-214)
    np.testing.assert_allclose(np.array(d["traj"])[:, 2], refined[:, 1],
                               rtol=0, atol=1e-12)
    assert len(d["traj"]) == len(refined) > 1 and len(d["segs"]) > 0


def test_sim_views_profile_and_verbose(tmp_path, capsys):
    out, live, prof = (tmp_path / n for n in ("out", "live", "prof"))
    stats = cli.main(["sim", "--frames", "40", "--stopfrm", "11",
                      "--device", "cpu", "--dtype", "float64", "--verbose",
                      "--plot", "--viz", "--live-dir", str(live),
                      "--live-every", "5", "--profile-dir", str(prof),
                      "--out", str(out)])
    err = capsys.readouterr().err
    assert "frame 0: kfs=1 lms=" in err and "frame 20" not in err
    assert _files(live) == ["tracking_00000.png", "tracking_00005.png",
                            "tracking_00010.png"]
    assert (out / "map.png").stat().st_size > 1000
    d = _embedded((out / "map.html").read_text())
    assert len(d["traj"]) == stats["num_keyframes"] >= 2
    assert d["gt"] is not None and len(d["gt"]) == len(d["traj"])
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(str(n).startswith("aten::") for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)  # CPU only


def test_views_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed the views are drawn with PIL: the
    map (the estimate in red, the ground truth in blue) and the tracking
    views over blank canvases or the images, each track in its colour."""
    from PIL import Image
    from slslam_tpu_torch import viz
    from slslam_tpu_torch.hostgeom import Pose
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    traj = [Pose(np.eye(3), np.array([0.3 * i, 0.0, 0.5 * i]))
            for i in range(6)]
    gt = np.zeros((6, 7))
    gt[:, 1], gt[:, 2] = 0.5 * np.arange(6) + 1.0, -0.3 * np.arange(6)
    segs = np.random.default_rng(1).standard_normal((10, 6)) * 3
    viz.plot_map(traj, segs, str(tmp_path / "map.png"), gt_trajectory=gt)
    img = np.asarray(Image.open(tmp_path / "map.png"))
    for colour in ((0xcc, 0x33, 0x11), (0x00, 0x77, 0xbb)):
        assert np.any(np.all(img == colour, axis=-1)), colour
    obs = {3: np.array([10.0, 20, 300, 200, 5, 20, 290, 200])}
    viz.plot_observations(None, None, obs, str(tmp_path / "o.png"),
                          image_size=(640, 480), title="frame 0")
    im = np.random.default_rng(2).integers(0, 255, (48, 64)).astype(np.uint8)
    viz.plot_observations(im, im, obs, str(tmp_path / "i.png"))
    o = np.asarray(Image.open(tmp_path / "o.png"))
    assert o.shape[1] == 1280 and o.shape[0] > 480
    colour = tuple(int(round(255 * c)) for c in
                   np.random.default_rng(3).random(3) * 0.7 + 0.15)
    assert np.any(np.all(o == colour, axis=-1))
    assert np.asarray(Image.open(tmp_path / "i.png")).shape == (48, 128, 3)

