"""Kernel-vs-twin check cases at the shapes of the slice's main path, and
the least time the card could take for each kernel's work.

Shared by ``chip_smoke.py`` (phases 1 and 2) and the opt-in GPU tests
(``tests/test_torch_gpu.py``, ``SLSLAM_GPU_TESTS=1``).  Inputs are made
from a numpy seed.

Tolerances are on the normalized error max|kernel - twin| / max(1,
max|twin|), per output:

* segment plans: exact (integers);
* K1 (deterministic, fixed-order sums): 1e-12 in float64, 1e-5 in float32;
* K2, every variant (deterministic, fixed-order sums; dual-number vs
  torch.func derivatives): 1e-10 in float64, 1e-5 in float32.

Bounds (``bound``) follow the H100 SXM data sheet: 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores, each input read once and
each output written once, counting only the rows that this input keeps.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import kernels

# (O, D, P) of K1's calls: first the main path's, lines-GN's trial cost
# (2W x Om rows, 1 lane, Lp lines) with its line plan; then the assembly's
# widths (lines Hll|gl|cost and the 4-camera Hcc|gc of the VO window)
K1_SHAPES = ((1600, 1, 81), (1600, 21, 81), (162, 42, 4))
# (O, P) of the plans a frame builds: the window's lines and (cam, line)
# pairs, the VO polish's cameras
PLAN_SHAPES = ((1600, 81), (1600, 20 * 81), (162, 4))
# (C, L, O) of each K2 variant on the main path: the window BA, the VO
# polish (2 frames x Lp rows over 4 cameras), lines-GN over the window
K2_SHAPES = {"full": (20, 81, 1600), "cams": (4, 81, 162),
             "lines": (20, 81, 1600)}
K1_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
K2_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
K2_OUTPUTS = ("cost", "Hcc", "Hll", "gc", "gl", "W")
K2_VARIANT_OUTPUTS = {"full": K2_OUTPUTS, "cams": ("cost", "Hcc", "gc"),
                      "lines": ("Hll", "gl", "cost_l")}

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def errors(a, b):
    """(normalized error, max abs error) of ``a`` against ``b``."""
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    if a.numel() == 0:
        return 0.0, 0.0
    max_abs = float(torch.max(torch.abs(a - b)))
    return max_abs / max(1.0, float(torch.max(torch.abs(b)))), max_abs


def k1_case(O, D, P, dtype, device, seed=0):
    """values (O, D), int32 idx (O,): repeated indices, and every 7th row
    padding (idx = P)."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((O, D))
    idx = rng.integers(0, P, O).astype(np.int32)
    idx[::7] = P
    return (torch.as_tensor(vals, dtype=dtype, device=device),
            torch.as_tensor(idx, device=device))


def k2_case(dtype, device, C=20, L=81, O=1600, seed=0):
    """Arguments of fused_eval: window-like random problem with invalid
    rows, a fixed camera, a fixed line, repeated (cam, line) pairs, a
    camera with no valid row and a line with no row."""
    rng = np.random.default_rng(seed)
    cam = rng.standard_normal((C, 6)) * 0.1
    cam[1 % C, :3] = 0.0                      # rodrigues' Taylor branch
    line = rng.standard_normal((L, 4)) * 0.2
    line[:, 3] = 0.3 + 0.5 * rng.random(L)
    obs = rng.standard_normal((O, 8)) * 0.2
    oc = np.repeat(np.arange(C), O // C)[:O]  # camera-major, as the engine
    oc = np.concatenate([oc, np.zeros(O - oc.size, int)])
    ol = rng.integers(0, L, O)
    ol[1::2] = ol[0::2]                       # repeated pairs
    ol[ol == L - 1] = 0                       # line L-1 unobserved
    valid = rng.random(O) < 0.8
    valid[oc == C - 1] = False                # camera C-1: no valid row
    obs[~valid] = 0.0
    cfree = np.ones(C)
    cfree[0] = 0.0
    lfree = np.ones(L)
    lfree[5 % L] = 0.0

    def f(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return dict(cam_wt=f(cam), line_orth=f(line), obs=f(obs), obs_cam=i(oc),
                obs_line=i(ol), w_valid=f(valid.astype(np.float64)),
                cam_free_f=f(cfree), line_free_f=f(lfree), baseline=0.12,
                huber_delta=1.0 / 406.05)


def k2_variant_case(variant, dtype, device):
    """k2_case at the variant's main-path shape, and its plan."""
    C, L, O = K2_SHAPES[variant]
    args = k2_case(dtype, device, C=C, L=L, O=O)
    plan = kernels.ba_plan(args["obs_cam"], args["obs_line"],
                           args["w_valid"], C, L, variant)
    return args, plan


def plan_case(O, P, device, seed=1):
    """An int32 key (O,) over P segments with padding rows (key = P and
    key = -1)."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, P, O).astype(np.int32)
    key[::9] = P
    key[4::13] = -1
    return torch.as_tensor(key, device=device)


def check_plans(device):
    """segment_plan on ``device`` against its twin on CPU copies at
    PLAN_SHAPES.  Returns [((O, P), max abs difference)]; raises unless
    perm and offsets are identical."""
    out = []
    for (O, P) in PLAN_SHAPES:
        key = plan_case(O, P, device)
        got = kernels.segment_plan(key, P)
        ref = kernels.segment_plan_twin(key.cpu(), P)
        diff = 0
        for name in ("perm", "offsets"):
            a, b = getattr(got, name).cpu(), getattr(ref, name)
            if not torch.equal(a, b):
                raise AssertionError(f"segment_plan {(O, P)}: {name} differs "
                                     "from the twin")
            diff = max(diff, int(torch.max(torch.abs(a - b))))
        out.append(((O, P), diff))
    return out


def check_k1(dtype, device):
    """K1 on ``device`` against the twin on CPU copies, at K1_SHAPES, with
    and without a plan.  Returns [((O, D, P, with_plan), normalized error,
    max abs error)]; raises if an error exceeds K1_TOL."""
    out = []
    for (O, D, P) in K1_SHAPES:
        vals, idx = k1_case(O, D, P, dtype, device)
        ref = kernels.segment_sum_twin(vals.cpu(), idx.cpu(), P)
        for with_plan in (True, False):
            plan = kernels.segment_plan(idx, P) if with_plan else None
            got = kernels.segment_sum(vals, idx, P, plan=plan)
            err, max_abs = errors(got, ref)
            if not err <= K1_TOL[dtype]:
                raise AssertionError(
                    f"segment_sum {dtype} {(O, D, P)} plan={with_plan}: "
                    f"error {err} > {K1_TOL[dtype]}")
            out.append(((O, D, P, with_plan), err, max_abs))
    return out


def check_k2(dtype, device, variant="full"):
    """K2's ``variant`` on ``device`` against its twin on the same device,
    launched twice with the variant's plan, at the variant's main-path
    shape.  Returns {output: (normalized error, max abs error)}; raises if
    an error exceeds K2_TOL or if the two launches differ in any bit."""
    args, plan = k2_variant_case(variant, dtype, device)
    got = kernels.fused_eval(**args, variant=variant, plan=plan)
    again = kernels.fused_eval(**args, variant=variant, plan=plan)
    ref = kernels.fused_eval_twin(**args, variant=variant)
    errs = {}
    for name, a, a2, b in zip(K2_VARIANT_OUTPUTS[variant], got, again, ref):
        if not torch.equal(a, a2):
            raise AssertionError(f"fused_eval/{variant} {dtype} {name}: two "
                                 "launches on the same input differ")
        errs[name] = errors(a, b)
        if not errs[name][0] <= K2_TOL[dtype]:
            raise AssertionError(f"fused_eval/{variant} {dtype} {name}: "
                                 f"error {errs[name][0]} > {K2_TOL[dtype]}")
    return errs


# ---------------------------------------------------------------------------
# Bounds: the least time for the work of one call on these inputs
# ---------------------------------------------------------------------------

def bound(nbytes, flops):
    """(bound in ms, what bounds it) on the H100's float32 peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def plan_work(O, P):
    """(bytes, operations) of segment_plan: the key read, perm and offsets
    written; integer compares only."""
    return 4 * O + 4 * O + 4 * (P + 1), 0


def k1_work(vals, idx, P):
    """(bytes, operations) of segment_sum with a plan: the kept rows'
    values and plan entries, the offsets, the (P, D) output; one add per
    kept value."""
    D = vals.shape[1]
    e = vals.element_size()
    kept = int(((idx >= 0) & (idx < P)).sum())
    return kept * D * e + 4 * kept + 4 * (P + 1) + P * D * e, kept * D


# Operations per valid row that K2's function needs, counted in closed form
# through _resid_soa (slslam_tpu/ops/pallas_kernels.py:141-207) and the chain
# rule, not the kernel's own work (it carries the residual on dual numbers,
# once per tangent pass, and full's camera blocks repeat the line pass).
# q = (pc, dc) is the line's point and direction in the camera frame.
_K2_OPS = {
    "residual": 164,       # the 4 residuals' values
    "dr_dq": 104,          # d r / d q, 4 x 6
    "cam_cols": 314,       # d(R v)/dw = -R [v]x J_r(w) for v = cp, dv, and
    #                        the chain for w; t's columns are d r / d pc
    "line_cols": 307,      # the orth decode's derivatives, R times them,
    #                        the chain
    "huber": 15,           # the Huber weight and cost
    "weigh_r": 4,
    "weigh_cam": 25,       # 24 camera columns times weight x free flag
    "weigh_line": 17,
    "cam_out": 147 + 42 + 28,   # Hcc (21 distinct), gc, and one add per
    #                             distinct value into its camera
    "line_out": 70 + 28 + 14,   # Hll (10 distinct), gl, the adds
    "line_cost": 1,             # the per-line cost's add
    "pair_out": 168 + 24,       # W and its adds
}
_K2_PARTS = {
    "full": ("residual", "dr_dq", "cam_cols", "line_cols", "huber",
             "weigh_r", "weigh_cam", "weigh_line", "cam_out", "line_out",
             "pair_out"),
    "cams": ("residual", "dr_dq", "cam_cols", "huber", "weigh_r",
             "weigh_cam", "cam_out"),
    "lines": ("residual", "dr_dq", "line_cols", "huber", "weigh_r",
              "weigh_line", "line_out", "line_cost"),
}


def k2_row_ops(variant):
    """Operations per valid row of K2's ``variant`` (_K2_OPS)."""
    return sum(_K2_OPS[k] for k in _K2_PARTS[variant])


def k2_work(args, variant, plan):
    """(bytes, operations) of one K2 call: parameters, the valid rows'
    observations, indices and weights, the plans it reads, the outputs."""
    C, L = args["cam_wt"].shape[0], args["line_orth"].shape[0]
    e = args["cam_wt"].element_size()
    rows = plan.line if variant != "cams" else plan.cam
    n = int(rows.offsets[-1])
    read = C * 6 * e + L * 4 * e + n * (8 * e + 4 + 4 + e)
    read += (C * e if variant != "lines" else 0) + (L * e if variant != "cams"
                                                    else 0)
    for p in plan:
        if p is not None:
            read += 4 * n + 4 * p.offsets.numel()
    write = {"full": 1 + C * 42 + L * 20 + C * L * 24, "cams": 1 + C * 42,
             "lines": L * 21}[variant] * e
    return read + write, n * k2_row_ops(variant)
