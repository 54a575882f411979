"""The port's distributed layer (slslam_tpu_torch/parallel) vs the JAX
package's, on the CPU.

The ranks are spawned processes in a gloo process group
(``parallel.run_local_ranks``; their bodies are in tests/torch_mesh_ranks.py,
which imports no jax), each spawn under a 120 s limit.  In float64:

* the line-sharded window BA at world 1, 2 and 4 on
  tests/test_distributed.py's ``padded_ba_problem`` against JAX's
  ``local_ba``, and at world 2 against JAX's ``dist_local_ba_lines`` on 2 of
  the 8 CPU devices: the same LM iterations, rtol 1e-7 / atol 1e-9 (the JAX
  package's own tolerance for its sharded solve, test_distributed.py:
  198-202); every rank's result equal bit for bit;
* the edge-sharded PGO at world 2 on the ring problem against JAX's
  ``dist_pose_graph_opt`` and ``pose_graph_opt``, rtol 1e-8 / atol 1e-10
  (test_distributed.py:172-173);
* the collective bytes per LM iteration: equal at two map sizes and equal
  to the closed form 8 (36 C^2 + 48 C + 5);
* the copy of ``partition_by_line`` is held to the original in
  tests/test_torch_copies.py; here the startup rules: the backend rule
  with the ranks of each host counted (two hosts faked by host name), a
  missing group, a failing or hung rank.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as ranks
from slslam_tpu.ops.pose_graph import pose_graph_opt as jax_pgo
from slslam_tpu.ops.schur_ba import local_ba as jax_local_ba
from slslam_tpu.parallel import (dist_local_ba_lines as jax_dist_ba,
                                 dist_pose_graph_opt as jax_dist_pgo,
                                 make_mesh as jax_make_mesh,
                                 partition_by_line as jax_partition)
from slslam_tpu_torch.parallel import (initialize_multihost, make_mesh,
                                       run_local_ranks)
from slslam_tpu_torch.parallel.multihost import backend_for, host_ranks
from test_distributed import BL, CAM, padded_ba_problem, pgo_ring_problem

HD = 1.0 / CAM.focal_length
RANK_TIMEOUT_S = 120.0


def _np(args):
    return [np.array(a) for a in args]


@pytest.fixture(scope="module")
def ba_problem():
    args = padded_ba_problem()
    cam, line, stats = jax_local_ba(*args, BL, HD)
    return _np(args), (np.asarray(cam), np.asarray(line),
                       int(stats.iterations))


def _sharded(problem, world, **kw):
    res = run_local_ranks(ranks.ba_rank, world, args=(problem, BL, HD),
                          device="cpu", timeout_s=RANK_TIMEOUT_S, **kw)
    for r in res[1:]:
        # replicated results: the same bytes on every rank
        np.testing.assert_array_equal(r[0], res[0][0])
        np.testing.assert_array_equal(r[1], res[0][1])
        assert r[2:5] == res[0][2:5]
    return res[0]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_dist_local_ba_lines_matches_jax_local_ba(ba_problem, world):
    problem, (cam_j, line_j, it_j) = ba_problem
    cam, line, it, cost0, cost1, _, backend = _sharded(problem, world)
    assert backend == "gloo"
    assert it == it_j
    assert cost1 < cost0
    np.testing.assert_allclose(cam, cam_j, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(line, line_j[:len(line)], rtol=1e-7,
                               atol=1e-9)


def test_dist_local_ba_lines_matches_jax_dist_on_two_devices(ba_problem):
    problem, _ = ba_problem
    cam0, orth0, obs, oc, ol, ov, cf, lf = problem
    lo, lfs, ob, ocs, ols, ovs, perm = jax_partition(orth0, lf, obs, oc, ol,
                                                     ov, 2)
    mesh = jax_make_mesh(jax.devices()[:2])
    cam_j, line_j, stats_j = jax_dist_ba(
        mesh, jnp.asarray(cam0), jnp.asarray(lo), jnp.asarray(ob),
        jnp.asarray(ocs), jnp.asarray(ols), jnp.asarray(ovs),
        jnp.asarray(cf), jnp.asarray(lfs), BL, HD)
    line_j = np.asarray(line_j).reshape(-1, 4)[perm]
    cam, line, it, _, _, _, _ = _sharded(problem, 2)
    assert it == int(stats_j.iterations)
    np.testing.assert_allclose(cam, np.asarray(cam_j), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(line, line_j, rtol=1e-7, atol=1e-9)


def test_dist_pose_graph_opt_matches_jax():
    args, _ = pgo_ring_problem()
    out_s, _ = jax_pgo(*args, max_iters=10)
    out_d, _ = jax_dist_pgo(jax_make_mesh(jax.devices()[:2]), *args,
                            max_iters=10)
    res = run_local_ranks(ranks.pgo_rank, 2, args=(_np(args),),
                          device="cpu", timeout_s=RANK_TIMEOUT_S)
    np.testing.assert_array_equal(res[1][0], res[0][0])
    for ref in (out_d, out_s):
        np.testing.assert_allclose(res[0][0], np.asarray(ref), rtol=1e-8,
                                   atol=1e-10)


def test_comm_bytes_per_lm_iteration_independent_of_map_size():
    """The line-sharded layout's contract (tests/test_distributed.py:73-90,
    there read from compiled HLO): the bytes of the collectives per LM
    iteration do not grow with the lines and observations; per solve one
    all-reduce of the initial cost, then three per LM iteration of
    (36 C^2 + 48 C + 5) float64 elements in all."""
    C = 4
    per_iter = 8 * (36 * C * C + 48 * C + 5)
    seen = []
    for pad_obs, pad_lines in ((1024, None), (4096, 256)):
        problem = _np(padded_ba_problem(num_cams=C, pad_obs=pad_obs,
                                        pad_lines=pad_lines))
        _, _, it, _, _, counts, _ = _sharded(problem, 2)
        assert it > 0
        assert counts["calls"] == 1 + 3 * it
        assert counts["bytes"] == 8 + it * per_iter
        seen.append((counts["bytes"] - 8) / it)
    assert seen[0] == seen[1] == per_iter


def test_backend_rule():
    assert backend_for("cpu", 1) == "gloo"
    assert backend_for("cpu", 4) == "gloo"
    # ranks on the card: NCCL only with a card each (none here)
    n = torch.cuda.device_count()
    assert backend_for("cuda", n + 1) == "gloo"
    if n:
        assert backend_for("cuda", n) == "nccl"


@pytest.mark.parametrize("hosts, local, cards, backend", [
    # two hosts with one card each: NCCL, as the flags' multi-host run
    (["host0", "host1"], [(0, 1), (0, 1)], 1, "nccl"),
    (["host0", "host0", "host1", "host1"], [(0, 2), (1, 2)] * 2, 2, "nccl"),
    # two ranks on one host with one card share it: gloo
    (["host0", "host0"], [(0, 2), (1, 2)], 1, "gloo"),
])
def test_backend_rule_counts_the_ranks_of_each_host(monkeypatch, hosts,
                                                    local, cards, backend):
    """The explicit flags' ranks learn each host's rank count through the
    coordinator's store (here one in-process store, each rank a thread
    with its own host name), and the backend rule reads that count."""
    store = dist.HashStore()
    out = {}

    def rank(r):
        out[r] = host_ranks(store, len(hosts), r, hosts[r])

    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(len(hosts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert [out.get(r) for r in range(len(hosts))] == local
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert {backend_for("cuda", n) for _, n in local} == {backend}


def test_no_group_raises(monkeypatch):
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        initialize_multihost(device="cpu")
    with pytest.raises(ValueError, match="num-processes"):
        initialize_multihost("127.0.0.1:1", device="cpu")


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1"):
        run_local_ranks(ranks.failing_rank, 2, device="cpu",
                        timeout_s=RANK_TIMEOUT_S)


def test_a_dead_rank_fails_the_run_at_once():
    with pytest.raises(RuntimeError, match=r"ranks \[1\] exited with codes "
                       r"\[3\]"):
        run_local_ranks(ranks.dying_rank, 2, device="cpu",
                        timeout_s=RANK_TIMEOUT_S)


def test_a_hung_rank_times_out():
    """A rank that never reaches the collective: the other rank's wait is
    bounded by the group's timeout, and the run by its own."""
    with pytest.raises(TimeoutError, match="did not finish"):
        run_local_ranks(ranks.hung_rank, 2, device="cpu", timeout_s=20.0)


def test_scaling_tool_on_the_cpu():
    """tools/torch_scaling_bench.py at world 1 and 2 (float32): the bytes
    per LM iteration are the closed form at both world sizes, and the
    busiest rank's observation rows halve (this seeded problem: 1.98x)."""
    from tools.torch_scaling_bench import run
    C = 8
    rows, summary, shapes = run(max_world=2, device="cpu", obs=1024, cams=C,
                                lines=64, iters=3, timeout_s=RANK_TIMEOUT_S)
    assert [r["world"] for r in rows] == [1, 2]
    for r in rows:
        assert r["collective_bytes_per_lm_iteration"] == 4 * (
            36 * C * C + 48 * C + 5)
        assert r["collective_calls_per_solve"] == 1 + 3 * r["lm_iterations"]
    assert summary["collective_bytes_per_lm_iteration_constant"]
    assert 1.9 < summary["obs_rows_ratio_at_each_doubling"][0] < 2.1
    assert "not scaling evidence" in summary["note"]
    assert shapes == {}   # the CPU runs the twins: no kernel launched


def test_scaling_tool_help():
    """The tool's --help renders (its help strings hold a literal %)."""
    from tools.torch_scaling_bench import main
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0


def test_house_window_problem_is_test_distributed_problem():
    """tests/torch_mesh_ranks.py's jax-free window problem (for the GPU
    tests) is the JAX tests' padded_ba_problem."""
    for a, b in zip(ranks.house_window_problem(), _np(padded_ba_problem()),
                    strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
