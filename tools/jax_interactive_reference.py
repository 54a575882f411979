"""The interactive engine's reference on the CPU: the JAX package's ``Slam``
on ``chip_smoke.py`` phase 7 (a)'s run, and the PyTorch port's ``Slam`` on
the same frames.

    python tools/jax_interactive_reference.py [--frames 400]
        [--jax-dtype float64] [--dtype float64] [--noise jax]

The run: the house world along the wave trajectory, render seed 4, 0.2 px
noise, the reference keyframe gates of ``SlamConfig()``.  JAX runs in
``--jax-dtype`` (float32 without JAX's x64 mode, as on its TPU).  The port
runs on the CPU (its kernels' plain twins) in ``--dtype``; its RANSAC takes
JAX's noise (``--noise jax``: the JAX engine's key split once per RANSAC
call, drawn in that dtype) or its own generator (``--noise port``, as on
the card).  Prints one JSON line: each engine's keyframes, window LM
iterations, keyframe ATE and wall, whether the keyframe frames and edge
sets agree, and the largest pose difference.  All of it is CPU work: the
walls say nothing of any accelerator.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


class JaxGumbel:
    """The JAX engine's RANSAC noise (slam.py:288, ransac.py:192): the key
    split once per call, gumbel(sub, (H, Nb)) in ``dtype``."""

    def __init__(self, key, dtype):
        self.key, self.dtype, self.calls = key, dtype, 0

    def __call__(self, i, H, Nb):
        if i != self.calls:
            raise ValueError(f"RANSAC call {i}, expected {self.calls}")
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        return torch.as_tensor(np.array(jax.random.gumbel(sub, (H, Nb),
                                                          self.dtype)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--jax-dtype", default="float64",
                    choices=("float32", "float64"))
    ap.add_argument("--dtype", default="float64",
                    choices=("float32", "float64"))
    ap.add_argument("--noise", default="jax", choices=("jax", "port"))
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.jax_dtype == "float64")
    torch.set_num_threads(1)

    from slslam_tpu.config import SlamConfig
    from slslam_tpu.engine import Slam as JaxSlam
    from slslam_tpu_torch import bench
    from slslam_tpu_torch.config import SlamConfig as PortConfig
    from slslam_tpu_torch.engine import Slam

    jcfg = dataclasses.replace(SlamConfig(), compute_dtype=args.jax_dtype)
    tcfg = dataclasses.replace(PortConfig(), compute_dtype=args.dtype)
    frames, poses = bench.workload(tcfg, args.frames, 4)

    def run(slam):
        t0 = time.perf_counter()
        kf = [i for i, fr in enumerate(frames) if slam.process_frame(fr, i)]
        wall = time.perf_counter() - t0
        traj = slam.trajectory()
        return kf, traj, {"kf": len(kf),
                          "window_lm_iterations": slam.sum_num_iteration,
                          "ate_kf_m": bench.ate(traj,
                                                [poses[i] for i in kf]),
                          "wall_cpu_s": wall}

    jslam = JaxSlam(jcfg)
    kf_j, traj_j, out_j = run(jslam)
    hook = None
    if args.noise == "jax":
        hook = JaxGumbel(jax.random.PRNGKey(jcfg.rseed),
                         {"float32": jnp.float32,
                          "float64": jnp.float64}[args.dtype])
    tslam = Slam(tcfg, device="cpu", gumbel_hook=hook)
    kf_t, traj_t, out_t = run(tslam)
    diff = max((float(np.linalg.norm(a.t - b.t))
                for a, b in zip(traj_j, traj_t)), default=0.0)
    print(json.dumps({
        "frames": args.frames, "jax_dtype": args.jax_dtype,
        "port_dtype": args.dtype, "port_noise": args.noise,
        "jax": out_j, "port": out_t, "same_keyframes": kf_j == kf_t,
        "same_edges": jslam.state.edge_set == tslam.state.edge_set,
        "max_traj_diff_m": diff}))


if __name__ == "__main__":
    main()
