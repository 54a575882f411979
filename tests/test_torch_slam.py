"""The port's interactive engine (slslam_tpu_torch/engine/slam.py) vs JAX's.

Both engines run on the CPU in float64 over the house world (render seed 4,
0.2 px), the port fed the JAX engine's RANSAC noise (its key split once per
RANSAC call, slam.py:288): identical keyframe frames, edge sets, landmark
ids and window LM iterations, trajectories within 1e-8 m; the metric
embedding's two walkers against JAX's on random graphs; and the options
that stay unported.  (tests/test_torch_slam_options.py holds aid lines,
window anchors, the BA init jitter and the gc_landmarks lifecycle.)"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.config import SlamConfig
from slslam_tpu.engine import Slam as JaxSlam
from slslam_tpu.engine import embedding as jemb
from slslam_tpu.engine import state as jstate
from slslam_tpu.hostgeom import Pose as JPose
from slslam_tpu.hostgeom import rodrigues
from slslam_tpu_torch import native
from slslam_tpu_torch.config import SlamConfig as PortConfig
from slslam_tpu_torch.engine import Slam
from slslam_tpu_torch.engine import embedding as temb
from slslam_tpu_torch.engine import state as tstate
from slslam_tpu_torch.hostgeom import Pose
from slslam_tpu_torch.sim import (StereoLineRenderer, house_segments,
                                  wave_trajectory)

torch.set_num_threads(1)


class JaxGumbel:
    """The JAX engine's RANSAC noise: key split once per call, then
    gumbel(sub, (H, Nb)) in float64 (slam.py:288, ransac.py:192)."""

    def __init__(self, key):
        self.key, self.calls = key, 0

    def __call__(self, i, H, Nb):
        assert i == self.calls
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        return torch.as_tensor(np.array(
            jax.random.gumbel(sub, (H, Nb), jnp.float64)))


def _frames(n):
    ren = StereoLineRenderer(house_segments(), PortConfig().camera,
                             noise_px=0.2, seed=4)
    return [ren.observe(T) for T in wave_trajectory(num_frames=400)[:n]]


def _both(frames, **over):
    """(JAX engine, port engine, keyframe frames of each) over ``frames``."""
    jcfg = dataclasses.replace(SlamConfig(), compute_dtype="float64", **over)
    tcfg = dataclasses.replace(PortConfig(), compute_dtype="float64", **over)
    j = JaxSlam(jcfg)
    kj = [i for i, f in enumerate(frames) if j.process_frame(f, i)]
    t = Slam(tcfg, device="cpu",
             gumbel_hook=JaxGumbel(jax.random.PRNGKey(jcfg.rseed)))
    kt = [i for i, f in enumerate(frames) if t.process_frame(f, i)]
    return j, t, kj, kt


def _assert_same_run(j, t, kj, kt, atol):
    assert kt == kj
    assert t.state.edge_set == j.state.edge_set
    assert sorted(t.state.lms) == sorted(j.state.lms)
    assert t.sum_num_iteration == j.sum_num_iteration
    assert t.lc_cnt == j.lc_cnt
    for a, b in zip(j.trajectory(), t.trajectory(), strict=True):
        np.testing.assert_allclose(b.t, a.t, rtol=0, atol=atol)
        np.testing.assert_allclose(b.R, a.R, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def house40():
    return _both(_frames(40))


def test_house_run_matches_jax(house40):
    j, t, kj, kt = house40
    assert len(kj) >= 3
    _assert_same_run(j, t, kj, kt, atol=1e-8)


def test_landmarks_match_jax(house40):
    j, t, _, _ = house40
    for fid, a in j.state.lms.items():
        b = t.state.lms[fid]
        assert (b.init_kfid, b.twice_observed) == (a.init_kfid,
                                                    a.twice_observed)
        assert [k for k, _ in b.obs_vec] == [k for k, _ in a.obs_vec]
        np.testing.assert_allclose(b.line, a.line, rtol=0, atol=1e-7)
        np.testing.assert_allclose(b.tt, a.tt, rtol=0, atol=1e-6)


def test_post_processing_keys_match_jax(house40):
    j, t, _, _ = house40
    a, b = j.post_processing(), t.post_processing()
    assert set(a) <= set(b)
    assert set(b) - set(a) == {"embedding_walker", "num_pose_graph_runs"}
    for k in ("num_keyframes", "num_landmarks", "num_edges",
              "num_loop_closures", "avg_num_iterations"):
        assert b[k] == a[k], k
    np.testing.assert_allclose(b["avg_final_cost"], a["avg_final_cost"],
                               rtol=1e-8)
    assert b["embedding_walker"] == ("native" if native.available()
                                     else "python")


def _graph(mod, n, seed, extra):
    """A keyframe chain with random loop edges, in module ``mod``'s map
    state (JAX's or the port's)."""
    rng = np.random.default_rng(seed)
    P = JPose if mod is jstate else Pose
    st = mod.MapState()
    for i in range(n):
        st.kfs[i] = mod.Keyframe(T=P())

    def add_edge(i, j):
        T = P(rodrigues(rng.standard_normal(3) * 0.2),
              rng.standard_normal(3))
        st.edges[(i, j)] = mod.Edge.from_pose(T)
        st.edges[(j, i)] = mod.Edge(T.inv(), T.inv())
        st.edge_set.add((i, j))
        st.kfs[i].neighbor_kfs.add(j)
        st.kfs[j].neighbor_kfs.add(i)

    for i in range(n - 1):
        add_edge(i, i + 1)
    for _ in range(extra):
        a, b = rng.choice(n, 2, replace=False)
        if (a, b) not in st.edges:
            add_edge(int(a), int(b))
    return st


@pytest.mark.parametrize("walker", ["native", "python"])
@pytest.mark.parametrize("n,seed,extra", [(3, 0, 0), (12, 1, 3),
                                          (40, 2, 10), (90, 3, 30)])
def test_embedding_walkers_match_jax(walker, n, seed, extra):
    """Random graphs: the port's native and Python walks give JAX's
    metric_embedding's order, distances and poses."""
    if walker == "native" and not native.available():
        pytest.fail(f"native walker unavailable: {native.build_error}")
    sj, st = _graph(jstate, n, seed, extra), _graph(tstate, n, seed, extra)
    root = (seed * 7) % n
    a = jemb.metric_embedding(sj, root)
    b = temb.metric_embedding(st, root, walker)
    assert [k for _, k in b] == [k for _, k in a]
    np.testing.assert_allclose([d for d, _ in b], [d for d, _ in a],
                               rtol=0, atol=1e-12)
    for k in sj.kfs:
        np.testing.assert_allclose(st.kfs[k].T.R, sj.kfs[k].T.R, atol=1e-12)
        np.testing.assert_allclose(st.kfs[k].T.t, sj.kfs[k].T.t, atol=1e-12)


def test_walker_choice_is_reported(monkeypatch):
    """Without the native library the engine warns and reports the Python
    walk; asked for the native walker, it raises."""
    assert temb.resolve_walker("python") == "python"
    with pytest.raises(ValueError):
        temb.resolve_walker("fortran")
    with pytest.raises(ValueError):
        temb.metric_embedding(_graph(tstate, 4, 0, 0), 0, "fortran")
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.warns(RuntimeWarning, match="Python walk"):
        s = Slam(PortConfig(), device="cpu")
    assert s.post_processing()["embedding_walker"] == "python"
    with pytest.raises(RuntimeError, match="native embedding walker"):
        temb.resolve_walker("native")


def test_unported_options_and_devices_raise():
    with pytest.raises(RuntimeError, match="process group"):
        Slam(dataclasses.replace(PortConfig(), mesh_devices=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Slam(PortConfig())
