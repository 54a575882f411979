"""Distributed scaling measurement of the port's line-sharded window BA.

The port's counterpart of tools/scaling_bench.py.  It solves one random BA
problem (a numpy copy of ``__graft_entry__._example_ba_problem``) with
``parallel.dist_local_ba_lines`` at world sizes 1, 2, 4, ... up to
--max-world, each world a group of spawned ranks (``parallel.
run_local_ranks``), and prints one JSON row per world size:

  * ``wall_ms_per_solve``: the slowest rank's host wall around a
    synchronized solve, median over REPS solves after one warm solve;
  * ``collective_bytes_per_solve`` and ``collective_calls_per_solve``: what
    one rank sends, from ``parallel.comm_counts()`` (the JAX tool reads its
    all-reduce bytes from compiled HLO), and
    ``collective_bytes_per_lm_iteration``: the same less the one-element
    all-reduce of the initial cost, over the LM iterations.  The
    line-sharded layout's contract is that it does not grow with the lines
    and observations, nor with the world size;
  * ``collective_ms_per_solve``: the slowest rank's time inside the
    collectives (``comm_counts()["seconds"]``);
  * ``obs_rows_per_rank``: the most valid observation rows on one rank (and
    ``obs_rows_padded``, the shard's padded length).  It takes the place of
    the JAX tool's per-device FLOPs from XLA's cost analysis: sharding must
    halve it at each doubling.

The JAX tool's modeled ICI / DCN efficiency is not carried over: its
bandwidths are a TPU's.  Each rank runs on ``cuda:{rank % card count}``
(NCCL when every rank has a card of its own, gloo when ranks share one;
``parallel/multihost.py``), or on the CPU with --device cpu.  On one card a
world of 2 or more is ranks sharing the card, so its wall efficiency is not
scaling evidence, as the JAX tool says of its virtual CPU mesh.

The problem is float32, as the JAX tool's.

Usage: python tools/torch_scaling_bench.py [--device cuda] [--max-world 2]
       [--obs 16384] [--cams 64] [--lines 512] [--iters 10]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NOT_EVIDENCE = ("ranks share one card (or the CPU): wall efficiency is not "
                "scaling evidence")
REPS = 5


def _example_ba_problem(C=8, L=64, O=256):
    """A numpy copy of ``__graft_entry__._example_ba_problem``
    (__graft_entry__.py:14-39), in float64: (cam_wt, line_orth, obs,
    obs_cam, obs_line, valid, cam_free, line_free, baseline,
    huber_delta)."""
    rng = np.random.default_rng(0)

    cam_wt = rng.standard_normal((C, 6)).astype(np.float64) * 0.1
    line_orth = rng.standard_normal((L, 4)).astype(np.float64) * 0.2
    line_orth[:, 3] = 0.3 + 0.1 * rng.random(L)  # safe theta
    obs = rng.standard_normal((O, 8)).astype(np.float64) * 0.2
    obs_cam = rng.integers(0, C, O)
    obs_line = rng.integers(0, L, O)
    # ensure unique (cam, line) pairs per obs (the engine's invariant)
    pair = obs_cam * L + obs_line
    _, first = np.unique(pair, return_index=True)
    valid = np.zeros(O, bool)
    valid[first] = True
    cam_free = np.ones(C, bool)
    cam_free[0] = False
    line_free = np.ones(L, bool)

    return (cam_wt, line_orth, obs, obs_cam.astype(np.int32),
            obs_line.astype(np.int32), valid, cam_free, line_free, 0.12,
            1.0 / 406.05)


def _rank(rank, world, dev, problem, iters):
    """One rank: its shard of ``problem`` in float32, one warm solve, then
    REPS timed solves, each with the comm counts from zero."""
    import torch

    from slslam_tpu_torch.ops import kernels
    from slslam_tpu_torch.parallel import (comm_counts, dist_local_ba_lines,
                                           partition_by_line,
                                           reset_comm_counts)
    dt = torch.float32
    cam0, orth0, obs, oc, ol, ov, cf, lf, bl, hd = problem
    lo, lfs, ob, ocs, ols, ovs, _ = partition_by_line(orth0, lf, obs, oc, ol,
                                                      ov, world)
    args = (torch.as_tensor(cam0, dtype=dt, device=dev),
            torch.as_tensor(lo[rank], dtype=dt, device=dev),
            torch.as_tensor(ob[rank], dtype=dt, device=dev),
            torch.as_tensor(ocs[rank], device=dev),
            torch.as_tensor(ols[rank], device=dev),
            torch.as_tensor(ovs[rank], device=dev),
            torch.as_tensor(cf, device=dev),
            torch.as_tensor(lfs[rank], device=dev))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def solve():
        return dist_local_ba_lines(None, *args, bl, hd, robust=True,
                                   max_iters=iters)

    kernels.reset_launch_counts()
    _, _, stats = solve()
    walls, comms = [], []
    for _ in range(REPS):
        sync()
        reset_comm_counts()
        t0 = time.perf_counter()
        _, _, stats = solve()
        sync()
        walls.append(time.perf_counter() - t0)
        comms.append(comm_counts())
    return {"walls": walls, "comms": comms,
            "iterations": int(stats.iterations),
            "final_cost": float(stats.final_cost),
            "itemsize": args[0].element_size(),
            "obs_rows": int(ovs[rank].sum()), "obs_rows_padded": ob.shape[1],
            "device": str(dev), "launch_shapes": dict(kernels.launch_shapes)}


def run(max_world=2, device="cuda", obs=16384, cams=64, lines=512, iters=10,
        timeout_s=600.0):
    """The rows of world sizes 1, 2, 4, ... <= ``max_world`` and a summary
    (the JSON lines ``main`` prints), and the kernels' launches by shape
    over every rank ({(kernel, shape): launches}, ``kernels.launch_shapes``'
    keys)."""
    from slslam_tpu_torch.parallel import run_local_ranks
    problem = _example_ba_problem(C=cams, L=lines, O=obs)
    rows, shapes = [], {}
    n = 1
    while n <= max_world:
        res = run_local_ranks(_rank, n, args=(problem, iters),
                              device=device, timeout_s=timeout_s)
        walls = np.max([r["walls"] for r in res], axis=0)
        comm_s = np.max([[c["seconds"] for c in r["comms"]] for r in res],
                        axis=0)
        c0 = res[0]["comms"][-1]
        for r in res:
            for k, v in r["launch_shapes"].items():
                shapes[k] = shapes.get(k, 0) + v
        row = {
            "world": n,
            "devices": sorted({r["device"] for r in res}),
            "wall_ms_per_solve": float(np.median(walls) * 1e3),
            "collective_bytes_per_solve": int(c0["bytes"]),
            "collective_calls_per_solve": int(c0["calls"]),
            "collective_bytes_per_lm_iteration": (
                (c0["bytes"] - res[0]["itemsize"]) / res[0]["iterations"]),
            "collective_ms_per_solve": float(np.median(comm_s) * 1e3),
            "obs_rows_per_rank": max(r["obs_rows"] for r in res),
            "obs_rows_padded": res[0]["obs_rows_padded"],
            "lm_iterations": res[0]["iterations"],
            "final_cost": res[0]["final_cost"],
        }
        if rows:
            row["wall_eff_vs_world_1"] = (rows[0]["wall_ms_per_solve"]
                                          / (row["wall_ms_per_solve"] * n))
        rows.append(row)
        n *= 2
    summary = {
        "obs_rows_ratio_at_each_doubling": [
            rows[i]["obs_rows_per_rank"] / rows[i + 1]["obs_rows_per_rank"]
            for i in range(len(rows) - 1)],
        "collective_bytes_per_lm_iteration_constant": len(
            {r["collective_bytes_per_lm_iteration"] for r in rows}) == 1,
        "problem": {"obs": obs, "cams": cams, "lines": lines,
                    "lm_iters": iters, "dtype": "float32", "device": device},
    }
    if len({d for r in rows for d in r["devices"]}) < max(
            r["world"] for r in rows):
        summary["note"] = NOT_EVIDENCE
    return rows, summary, shapes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (each rank on cuda:{rank %% card count}) or "
                         "cpu")
    ap.add_argument("--max-world", type=int, default=2)
    ap.add_argument("--obs", type=int, default=16384)
    ap.add_argument("--cams", type=int, default=64)
    ap.add_argument("--lines", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    rows, summary, _ = run(args.max_world, args.device, args.obs, args.cams,
                           args.lines, args.iters)
    for row in rows:
        print(json.dumps(row))
    print(json.dumps(summary))
    return rows, summary


if __name__ == "__main__":
    main()
