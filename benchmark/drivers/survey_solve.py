"""Driver of the survey solves: warm global bundle adjustments of a pool
of maps, one after another.

The pool is the traffic's ``maps`` maps of one survey (the
configuration's sizes, geometry drawn once from ``map_seed``), each with
its own observation noise (``noise_px``) and perturbed start (the map
tool's sigmas), drawn from (``map_seed``, map).  Every run solves the
same pool, so every seed gives the same work; ``--seed`` draws the order
in which the window visits the maps and which of them the check compares.

Set-up builds the geometry on the host, packs it once
(``pack_line_major``: the line-major layout is the same for every map of
the pool), draws each map's noise on the card with a ``torch.Generator``
in the configuration's dtype and scatters it into the layout, uploads the
starts and solves the first map once to warm up.  The window solves the
maps in the seed's order, each solve ended by a synchronise, and closes
at the end of the round in progress once ``--seconds`` have passed, so
every map is solved as often.

After the window, for each of ``checked_maps`` maps drawn from the seed,
the program's entry also runs the first ``early_iters`` LM iterations
from the same start (the solve is deterministic, so these are the
window's own first iterations).  ``check`` then compares with the plain
reference (``benchmark/reference/survey_ba.py``), which solves the same
inputs in float64:

* ``early_cost_excess``: by how much the reference's cost at the
  program's cameras and lines after ``early_iters`` LM iterations
  exceeds the reference's own cost after as many (relative; negative
  where the program's is the better state): what K2 ``lm``, K4, K3's PCG
  and the trial cost decide before rounding has scattered the two solves;
* ``cost_excess``: by how much the reference's cost at the program's
  final cameras and lines exceeds the reference solve's final cost
  (relative; negative where the program's map is the better one);
* ``cost_report_gap``: the program's reported final cost against the
  reference's cost at the program's cameras and lines (relative);
* ``repeat_gap``: the maps whose solves, set-up's warm-up included, did
  not all end on the same final cost (the solve is deterministic).

``control`` puts the reference in the program's place, computed in
float32 with every matrix product as TF32 computes it; ``witness`` the
same in plain float32.  ``plant`` breaks the program's entry in one of
the ways the check has to catch.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np


def _dtype(cfg):
    import torch
    return {"float32": torch.float32, "float64": torch.float64}[cfg["dtype"]]


def _map_seed(cfg, m, stream):
    """The seed of map ``m``'s ``stream`` (0: noise, 1: start)."""
    return int(np.random.SeedSequence(
        [int(cfg["map_seed"]), m, stream]).generate_state(1)[0])


def start(cfg, base, m):
    """Map ``m``'s perturbed start: cameras (C, 6) and orthonormal lines
    (L, 4), float64 on the host; camera 0 stays at the truth."""
    from benchmark.frozen.survey_map import (av_to_orth_np,
                                             perturb_lines_metric)
    rng = np.random.default_rng(_map_seed(cfg, m, 1))
    C = len(base["cam_wt"])
    cam0 = base["cam_wt"].copy()
    cam0[1:, :3] += rng.standard_normal((C - 1, 3)) * cfg["cam_sigma_rot"]
    cam0[1:, 3:] += rng.standard_normal((C - 1, 3)) * cfg["cam_sigma_t"]
    lines0 = perturb_lines_metric(base["lines_w"], cfg["line_sigma_cp_m"],
                                  cfg["line_sigma_dir_rad"], rng)
    return cam0, av_to_orth_np(lines0)


def setup(ctx):
    import torch
    from benchmark.frozen.survey_map import make_survey_problem
    from slslam_tpu_torch.ops.schur_cg import pack_line_major
    cfg, dev = ctx.config, ctx.device
    dtype = _dtype(cfg)
    base = make_survey_problem(C=cfg["cams"],
                               lines_per_anchor=cfg["lines_per_cam"],
                               band_m=cfg["band_m"], noise_px=0.0,
                               spacing=cfg["spacing_m"],
                               seed=cfg["map_seed"])
    C, L = len(base["cam_wt"]), len(base["lines_w"])
    O = len(base["obs"])
    # the layout once: each slot's observation row (as a float64 value)
    rows = np.repeat(np.arange(O, dtype=np.float64)[:, None], 8, axis=1)
    pk = pack_line_major(rows, base["obs_cam"], base["obs_line"], C, L)
    valid = torch.as_tensor(pk.obs_valid.reshape(-1), device=dev)
    row_of = torch.as_tensor(pk.obs[..., 0].reshape(-1).astype(np.int64),
                             device=dev)[valid]
    exact = torch.as_tensor(base["obs"], dtype=dtype, device=dev)
    cam_free = torch.ones(C, dtype=torch.bool, device=dev)
    cam_free[0] = False
    shared = {"obs_cam": torch.as_tensor(pk.obs_cam, device=dev),
              "obs_valid": torch.as_tensor(pk.obs_valid, device=dev),
              "cam_free": cam_free,
              "line_free": torch.ones(L, dtype=torch.bool, device=dev)}
    sigma = cfg["noise_px"] / cfg["focal_px"]
    maps = []
    for m in range(int(ctx.traffic["maps"])):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_map_seed(cfg, m, 0))
        noisy = exact + sigma * torch.randn(exact.shape, generator=gen,
                                            dtype=dtype, device=dev)
        packed = torch.zeros(L * pk.kL, 8, dtype=dtype, device=dev)
        packed[valid] = noisy[row_of]
        cam0, orth0 = start(cfg, base, m)
        maps.append({"obs": packed.reshape(L, pk.kL, 8),
                     "cam": torch.as_tensor(cam0, dtype=dtype, device=dev),
                     "orth": torch.as_tensor(orth0, dtype=dtype,
                                             device=dev)})
        del noisy
    order = np.random.default_rng(ctx.seed).permutation(len(maps))
    state = {"base": base, "maps": maps, "shared": shared, "order": order,
             "valid": valid, "row_of": row_of, "kL": pk.kL, "C": C, "L": L,
             "last": {}, "costs": {m: [] for m in range(len(maps))},
             "stats": []}
    solve(state, cfg, int(order[0]))   # the warm-up: every shape of the window
    state["stats"].clear()
    return state


def _program(state, cfg, m, max_iters):
    """The program's solve of map ``m`` from its start."""
    from slslam_tpu_torch.ops import schur_cg
    t, s = state["maps"][m], state["shared"]
    return schur_cg.global_ba_cg(
        t["cam"], t["orth"], t["obs"], s["obs_cam"], s["obs_valid"],
        s["cam_free"], s["line_free"], cfg["baseline_m"],
        cfg["huber_px"] / cfg["focal_px"], robust=True,
        max_iters=max_iters, cg_iters=cfg["cg_iters"], eta=cfg["eta"])


def solve(state, cfg, m):
    """One solve of map ``m`` on the program; keeps its outputs."""
    cam, orth, stats = _program(state, cfg, m, cfg["max_iters"])
    state["last"][m] = (cam, orth, stats)
    state["costs"][m].append(stats.final_cost)
    state["stats"].append(stats)


def window(state, ctx, seconds):
    import torch
    cfg, dev = ctx.config, ctx.device
    cuda = dev.type == "cuda"
    walls = []
    t0 = time.perf_counter()
    while True:
        for m in state["order"]:
            t1 = time.perf_counter()
            solve(state, cfg, int(m))
            if cuda:
                torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t1)
        if time.perf_counter() - t0 >= seconds:
            break
    st = state["stats"]
    final = [float(s.final_cost) for s in st]
    return {"attempted": len(st),
            "failed": sum(not np.isfinite(c) for c in final),
            "solves": len(st), "walls_s": walls,
            "lm_iters": [int(s.iterations) for s in st],
            "pcg_iters": [int(s.cg_iterations) for s in st],
            "work": {"C": state["C"], "L": state["L"],
                     "O": state["L"] * state["kL"],
                     "valid": int(state["valid"].sum()),
                     "e": state["maps"][0]["obs"].element_size()}}


def checked(n, ctx):
    """The maps the check compares: ``checked_maps`` of the ``n``, drawn
    from the seed."""
    k = min(n, int(ctx.traffic.get("checked_maps", n)))
    return sorted(int(m) for m in np.random.default_rng(
        [int(ctx.seed), 1]).choice(n, k, replace=False))


def release(state, ctx):
    """Host copies of the checked maps' inputs, last solves and first
    ``early_iters`` LM iterations, and of every map's final costs."""
    base, cfg = state["base"], ctx.config
    out = {"base": base, "maps": {},
           "final_costs": [[float(c) for c in state["costs"][m]]
                           for m in range(len(state["maps"]))]}
    row_of = state["row_of"].cpu().numpy()
    for m in checked(len(state["maps"]), ctx):
        cam, orth, stats = state["last"][m]
        flat = np.empty((len(base["obs"]), 8))
        flat[row_of] = state["maps"][m]["obs"].reshape(-1, 8)[
            state["valid"]].double().cpu().numpy()
        cam0, orth0 = start(cfg, base, m)
        early = []
        for k in range(1, int(ctx.traffic["early_iters"]) + 1):
            c, o, st = _program(state, cfg, m, k)
            early.append({"cam": c.double().cpu().numpy(),
                          "orth": o.double().cpu().numpy(),
                          "pcg": int(st.cg_iterations)})
        out["maps"][m] = {"obs": flat, "cam0": cam0, "orth0": orth0,
                          "cam": cam.double().cpu().numpy(),
                          "orth": orth.double().cpu().numpy(),
                          "final_cost": float(stats.final_cost),
                          "early": early}
    state["maps"].clear()
    state["last"].clear()
    return out


def _problem(outputs, cfg, dtype, device, tf32=False):
    from benchmark.reference import survey_ba as ref
    b = outputs["base"]
    return lambda obs: ref.Problem(
        obs, b["obs_cam"], b["obs_line"], len(b["cam_wt"]),
        len(b["lines_w"]), cfg["baseline_m"],
        cfg["huber_px"] / cfg["focal_px"], dtype, device, tf32=tf32)


def check(outputs, ctx):
    import torch
    from benchmark.reference import survey_ba as ref
    cfg, dev = ctx.config, ctx.device
    make = _problem(outputs, cfg, torch.float64, dev)
    K = int(ctx.traffic["early_iters"])
    worst = {"early_cost_excess": -math.inf, "cost_excess": -math.inf,
             "cost_report_gap": 0.0}
    for m, mo in outputs["maps"].items():
        P = make(mo["obs"])
        f = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                      device=dev)
        rec = []
        _, _, c0, c1, it, pcg = ref.solve(
            P, f(mo["cam0"]), f(mo["orth0"]), cfg["max_iters"],
            cfg["cg_iters"], cfg["eta"], tol_dtype=_dtype(cfg), record=rec,
            keep=K)
        at_prog = float(P.cost(f(mo["cam"]), f(mo["orth"])))
        early = {}
        for k, (pe, re) in enumerate(zip(mo["early"], rec[:K]), 1):
            at_k = float(P.cost(f(pe["cam"]), f(pe["orth"])))
            early[k] = {"cost_excess": (at_k - re["cost"]) / re["cost"],
                        "pcg": [pe["pcg"], sum(r["pcg"] for r in rec[:k])]}
        got = {"early_cost_excess": early[K]["cost_excess"] if K in early
               else math.inf,
               "cost_excess": (at_prog - c1) / c1,
               "cost_report_gap": abs(mo["final_cost"] - at_prog) / at_prog}
        steps = [r["pcg"] for r in rec]
        ctx.log("survey check: " + json.dumps({
            "map": m, **got, "early": early,
            "start_excess": (c0 - c1) / c1, "reference": [c0, c1, it, pcg],
            "reference_pcg_steps": steps,
            "program": [at_prog, mo["final_cost"]]}))
        for k, v in got.items():
            worst[k] = max(worst[k], v if np.isfinite(v) else math.inf)
        del P, rec
    repeat = sum(len(set(c)) > 1 for c in outputs["final_costs"])
    return [*worst.items(), ("repeat_gap", float(repeat))]


def _in_place(outputs, ctx, tf32):
    """``outputs`` with the program's answers of the checked maps replaced
    by the reference's, solved in float32 (with TF32 products where
    ``tf32``)."""
    import torch
    from benchmark.reference import survey_ba as ref
    cfg = ctx.config
    K = int(ctx.traffic["early_iters"])
    make = _problem(outputs, cfg, torch.float32, ctx.device, tf32=tf32)
    for m, mo in outputs["maps"].items():
        P = make(mo["obs"])
        f = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                      device=ctx.device)
        rec = []
        cam, orth, _, c1, _, pcg = ref.solve(
            P, f(mo["cam0"]), f(mo["orth0"]), cfg["max_iters"],
            cfg["cg_iters"], cfg["eta"], record=rec, keep=K)
        ctx.log(f"survey {'control' if tf32 else 'witness'}: " + json.dumps(
            {"map": m, "pcg": pcg, "pcg_steps": [r["pcg"] for r in rec]}))
        mo.update(cam=cam.double().cpu().numpy(),
                  orth=orth.double().cpu().numpy(), final_cost=c1,
                  early=[{"cam": r["cam"].double().cpu().numpy(),
                          "orth": r["orth"].double().cpu().numpy(),
                          "pcg": sum(q["pcg"] for q in rec[:k + 1])}
                         for k, r in enumerate(rec[:K])])
        del P
    return outputs


def control(outputs, ctx):
    """The reference in the program's place, in float32 with TF32
    products: the control that has to come out as not correct."""
    return _in_place(outputs, ctx, tf32=True)


def witness(outputs, ctx):
    """The reference in the program's place in plain float32: a second
    float32 solve, to read what float32 alone does to the numbers."""
    return _in_place(outputs, ctx, tf32=False)


def plant(kind, setattr_):
    """Break the program's entry (``schur_cg.global_ba_cg``) with
    ``setattr_``: ``unchanged``, a solve that returns its start;
    ``half``, half of the lines' observations left out; ``altered``, a
    camera of the answer replaced by its neighbour; ``pcg_cut``, at most
    a quarter of ``cg_iters`` PCG iterations a step."""
    from slslam_tpu_torch.ops import schur_cg
    real = schur_cg.global_ba_cg

    def broken(cam, line, obs, obs_cam, obs_valid, *a, **k):
        if kind == "unchanged":
            k = dict(k, max_iters=0)
        if kind == "pcg_cut":
            k = dict(k, cg_iters=k["cg_iters"] // 4)
        if kind == "half":
            obs_valid = obs_valid.clone()
            obs_valid[::2] = False
        out = real(cam, line, obs, obs_cam, obs_valid, *a, **k)
        if kind == "altered":
            c = out[0].clone()
            c[5] = c[6]
            out = (c, *out[1:])
        return out
    if kind not in ("unchanged", "half", "altered", "pcg_cut"):
        raise ValueError(f"no fault {kind!r}")
    setattr_(schur_cg, "global_ba_cg", broken)
