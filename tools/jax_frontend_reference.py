"""Rounding bands on the CPU for the image slice and for ``Slam``'s PGO.

    python tools/jax_frontend_reference.py slice [--witnesses 3]
    python tools/jax_frontend_reference.py pgo [--witnesses 3]
    python tools/jax_frontend_reference.py track [--witnesses 3]

``slice``: tests/test_frontend.py's end-to-end run (25 rendered house
frames at stride 3, render seed 0 -> matcher -> BatchSlam with every frame
a keyframe -> the 2-round global refine, float64).  The JAX package's
chain runs on its own tracks and on ``--witnesses`` copies of them with
every observation scaled by 1 + 1e-15 N(0, 1); the port's chain runs on
its own matcher's tracks with JAX's RANSAC noise.  Prints each run's raw
and refined ATE and the first frame whose RANSAC score differs from JAX's
unchanged run.

``pgo``: tests/test_torch_slam_pgo.py's village run (80 frames, float64,
consistency thresholds 2 cm / 0.01 rad) on the port's CPU engine, with
RANSAC noise made on the CPU from (seed, call) as chip_smoke.py phase 8
(d) makes it, and ``--witnesses`` copies with every observation from
frame 0 on scaled by 1 + 1e-15 N(0, 1): each witness's PGO runs, window
LM iterations and largest keyframe position difference from the
unchanged run, the band that phase 8 (d)'s card-vs-CPU gap is read
against.

``track``: chip_smoke.py phase 8 (c)'s run (40 rendered house frames at
stride 3, render seed 0, written as 8-bit PNGs, ``cli track`` at
``SlamConfig()``'s gates).  The JAX package's ``cmd_track`` runs in
float64 and in float32 (x64 on, as its CPU tests run it) with the default
RANSAC seed, with ``--witnesses`` other RANSAC seeds, and with
``--witnesses`` copies of the tracked observations scaled by 1 + e N(0, 1)
(e = 1e-15 in float64, 2**-24 in float32, one rounding of the pixel
coordinates); the port's ``cli track`` runs on the CPU in both dtypes with its own
RANSAC stream, at the default seed and the other seeds.  Prints each run's keyframes,
keyframe ATE and window LM iterations: the band that phase 8 (c)'s card
run is read against.

One JSON line.  All of it is CPU work: the walls say nothing of any
accelerator.
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def _scaled(frames, seed):
    """Every observation times 1 + 1e-15 N(0, 1), a stream per frame."""
    out = []
    for i, f in enumerate(frames):
        rng = np.random.default_rng(seed * 1000 + i)
        out.append({k: v * (1.0 + 1e-15 * rng.standard_normal(8))
                    for k, v in f.items()})
    return out


def slice_band(witnesses):
    from slslam_tpu import native as jnative
    from slslam_tpu.config import SlamConfig, bucket_for
    from slslam_tpu.engine import batch as jb
    from slslam_tpu.engine.refine import global_refine as jax_refine
    from slslam_tpu.frontend.matcher import StereoLineMatcher as JaxMatcher
    from slslam_tpu.sim import house_segments, wave_trajectory
    from slslam_tpu.sim.images import StereoImageRenderer
    from slslam_tpu_torch.config import SlamConfig as PortConfig
    from slslam_tpu_torch.engine import batch as tb
    from slslam_tpu_torch.engine.refine import global_refine
    from slslam_tpu_torch.frontend.matcher import StereoLineMatcher

    jnative.available()     # loaded before the matcher's threads race on it
    over = dict(compute_dtype="float64", kf_rot_thr=1e-9, kf_tr_thr=1e-9)
    cfg = dataclasses.replace(SlamConfig(), **over)
    tcfg = dataclasses.replace(PortConfig(), **over)
    poses = wave_trajectory(num_frames=400)[::3][:25]
    ren = StereoImageRenderer(house_segments(), cfg.camera)
    images = [ren.render(T)[:2] for T in poses]

    def ate(traj):
        T0 = poses[0]
        return float(np.mean([np.linalg.norm(a.t - (g @ T0.inv()).inv().t)
                              for a, g in zip(traj, poses)]))

    jm = JaxMatcher(cfg.camera)
    fj = jb.normalize_frames([jm.process(i, *im)
                              for i, im in enumerate(images)], cfg.camera)
    runs = {}
    for name, frames in [("jax", fj)] + [
            (f"jax_witness_{s}", _scaled(fj, s))
            for s in range(1, witnesses + 1)]:
        r = jb.BatchSlam(cfg).run(frames)
        ref = jax_refine(frames, r.is_kf, r.trajectory, config=cfg)
        runs[name] = (r, ref)
    tm = StereoLineMatcher(tcfg.camera, device="cpu")
    ft = tb.normalize_frames([tm.process(i, *im)
                              for i, im in enumerate(images)], tcfg.camera)
    tm.close()
    Lp = bucket_for(jb.pack_frames(fj, window=cfg.ba_window_size).num_slots,
                    cfg.line_buckets) + 1
    base = jax.random.PRNGKey(cfg.rseed)

    def hook(fidx):
        return torch.as_tensor(np.array(jax.random.gumbel(
            jax.random.fold_in(base, fidx),
            (cfg.ransac_num_hypotheses, Lp), jnp.float64)))

    r = tb.BatchSlam(tcfg, device="cpu", gumbel_hook=hook).run(ft)
    runs["port"] = (r, global_refine(ft, r.is_kf, r.trajectory, config=tcfg,
                                     device="cpu"))
    score0 = runs["jax"][0].per_frame["ransac_score"]
    out = {}
    for name, (r, ref) in runs.items():
        differ = np.flatnonzero(r.per_frame["ransac_score"] != score0)
        out[name] = {"ate_raw_m": ate(r.trajectory),
                     "ate_refined_m": ate(ref.trajectory),
                     "refine_iterations": ref.iterations,
                     "first_ransac_difference": (int(differ[0]) if len(differ)
                                                 else None)}
    return out


def pgo_band(witnesses):
    from slslam_tpu_torch import bench
    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.engine import Slam
    from slslam_tpu_torch.loopclosure import (PlaceRecognizer, VocTree,
                                              VocTreeParams)
    from slslam_tpu_torch.ops.ransac import gumbel_noise
    from slslam_tpu_torch.sim import SegmentDescriptorSource

    cfg = dataclasses.replace(
        SlamConfig(), compute_dtype="float64", ransac_num_hypotheses=64,
        corr_buckets=(64, 128), obs_buckets=(512, 1024, 2048),
        line_buckets=(256, 512), pgo_consistency_tr_thr=0.02,
        pgo_consistency_rot_thr=0.01)
    frames, _, src, assigner, vocab, _ = bench.lc_workload(
        cfg, 80, 3.2 * 80 / 120, orbit_radius=3.5)
    params = VocTreeParams(non_consider_recent=8, consider_seq_length=3,
                           threshold=0.25, num_avg_words=30)

    def noise(i, H, Nb):     # chip_smoke.py's _cpu_gumbel
        g = torch.Generator().manual_seed((0x7A7 << 32) + int(i))
        return gumbel_noise(g, (H, Nb), torch.float64, "cpu")

    def run(fr):
        s = Slam(cfg, device="cpu", gumbel_hook=noise)
        s.place_recognizer = PlaceRecognizer(
            VocTree(vocab, params, device="cpu"), min_matches=8,
            min_similarity=0.8)
        s.descriptor_source = SegmentDescriptorSource(
            assigner, len(src.base), noise=0.01, seed=7)
        kf = [i for i, f in enumerate(fr) if s.process_frame(f, i)]
        return s, kf

    s0, k0 = run(frames)
    out = {"base": {"keyframes": len(k0), "pgo_runs": s0.pgo_runs,
                    "lm_iterations": s0.sum_num_iteration}}
    for seed in range(1, witnesses + 1):
        s, k = run(_scaled(frames, seed))
        out[f"witness_{seed}"] = {
            "same_keyframes": k == k0,
            "same_edges": s.state.edge_set == s0.state.edge_set,
            "pgo_runs": s.pgo_runs, "lm_iterations": s.sum_num_iteration,
            "max_traj_diff_m": max(float(np.linalg.norm(a.t - b.t))
                                   for a, b in zip(s.trajectory(),
                                                   s0.trajectory()))}
    return out


TRACK_FRAMES, TRACK_STRIDE = 40, 3      # chip_smoke.py phase 8 (c)


def track_band(witnesses):
    import tempfile
    from PIL import Image
    from slslam_tpu import cli as jcli
    from slslam_tpu import engine as jengine
    from slslam_tpu import native as jnative
    from slslam_tpu.sim import house_segments, wave_trajectory
    from slslam_tpu.sim.images import StereoImageRenderer
    from slslam_tpu_torch import cli as tcli
    from slslam_tpu_torch import engine as tengine

    jnative.available()     # loaded before the matcher's threads race on it
    poses = wave_trajectory(num_frames=400)[::TRACK_STRIDE][:TRACK_FRAMES]
    ren = StereoImageRenderer(house_segments(), seed=0)

    def ate(traj, kf):
        gt = [poses[i] for i in kf]
        T0 = gt[0]
        return float(np.mean([np.linalg.norm(a.t - (g @ T0.inv()).inv().t)
                              for a, g in zip(traj, gt)]))

    def jax_run(tmp, dtype, rseed, scale, seed):
        made = []

        class Recording(jengine.Slam):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.kf_frames = []
                made.append(self)

            def process_frame(self, obs, frame_id, normalized=True):
                if scale:
                    rng = np.random.default_rng(seed * 1000 + frame_id)
                    obs = {k: v * (1.0 + scale * rng.standard_normal(8))
                           for k, v in obs.items()}
                if super().process_frame(obs, frame_id, normalized):
                    self.kf_frames.append(frame_id)
                    return True
                return False

        saved, jengine.Slam = jengine.Slam, Recording
        try:
            jcli.main(["track", "--left-dir", os.path.join(tmp, "left"),
                       "--right-dir", os.path.join(tmp, "right"),
                       "--platform", "cpu", "--dtype", dtype, "--rseed",
                       str(rseed)])
        finally:
            jengine.Slam = saved
        s, = made
        return s.kf_frames, s.trajectory(), s.sum_num_iteration

    def port_run(tmp, dtype, rseed):
        made = []

        def keep(*a, _slam=tengine.Slam, **k):
            made.append(_slam(*a, **k))
            return made[-1]

        saved, tengine.Slam = tengine.Slam, keep
        try:
            stats = tcli.main(["track", "--left-dir",
                               os.path.join(tmp, "left"), "--right-dir",
                               os.path.join(tmp, "right"), "--device", "cpu",
                               "--dtype", dtype, "--rseed", str(rseed)])
        finally:
            tengine.Slam = saved
        s, = made
        return stats["keyframe_frames"], s.trajectory(), s.sum_num_iteration

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for side in ("left", "right"):
            os.makedirs(os.path.join(tmp, side))
        for i, T in enumerate(poses):
            for side, img in zip(("left", "right"), ren.render(T)[:2]):
                Image.fromarray(np.clip(np.rint(img), 0, 255).astype(
                    np.uint8)).save(os.path.join(tmp, side, f"{i:04d}.png"))
        for dtype, eps in (("float64", 1e-15), ("float32", 2.0 ** -24)):
            runs = [(f"jax_{dtype}", 4, 0.0, 0)]
            runs += [(f"jax_{dtype}_rseed_{r}", r, 0.0, 0)
                     for r in range(1, witnesses + 1)]
            runs += [(f"jax_{dtype}_witness_{w}", 4, eps, w)
                     for w in range(1, witnesses + 1)]
            for name, rseed, scale, seed in runs:
                kf, traj, it = jax_run(tmp, dtype, rseed, scale, seed)
                out[name] = {"keyframes": len(kf), "ate_kf_m": ate(traj, kf),
                             "lm_iterations": int(it)}
            for rseed in range(witnesses + 1):
                kf, traj, it = port_run(tmp, dtype, rseed or 4)
                name = f"port_cpu_{dtype}" + (f"_rseed_{rseed}" if rseed
                                              else "")
                out[name] = {"keyframes": len(kf), "ate_kf_m": ate(traj, kf),
                             "lm_iterations": int(it)}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=("slice", "pgo", "track"))
    ap.add_argument("--witnesses", type=int, default=3)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    band = {"slice": slice_band, "pgo": pgo_band,
            "track": track_band}[args.case]
    print(json.dumps({"case": args.case, **band(args.witnesses)}))


if __name__ == "__main__":
    main()
