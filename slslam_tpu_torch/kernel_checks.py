"""Kernel-vs-twin check cases at the shapes of the slice's main path (or
at any shape a path launched a kernel at), and the least time the card
could take for each kernel's work.

Shared by ``chip_smoke.py`` (phases 1 and 2 at the house shapes below,
K3 (its passes and its PCG) and K4 at the refine's, the loop-closure
refine's and the map's,
phases 6 and 7 at every shape ``kernels.launch_shapes`` recorded in the
loop-closure and interactive runs) and the tests (``tests/test_torch_gpu.py``,
``SLSLAM_GPU_TESTS=1``; the rounding witnesses on the CPU).  Inputs are
made from a numpy seed.

Tolerances are on the normalized error max|kernel - twin| / max(1,
max|twin|), per output:

* segment plans: exact (integers);
* K1 (deterministic, fixed-order sums): 1e-12 in float64, 1e-5 in float32;
* K2, every variant (deterministic, fixed-order sums; dual-number vs
  torch.func derivatives): 1e-10 in float64, 1e-5 in float32; ``lm``'s
  Wb rows that its plan drops must be exactly zero, and NaNs in the rows
  that ``cost``'s plan drops must leave its cost as it was, bit for bit;
* K3 and K4 (deterministic, fixed-order sums of the same products): 1e-12
  in float64, of the largest sum of absolute terms an output adds; in
  float32 held to the float64 twin, at most twice as far as the float32
  twin plus 1e-6 (a rounding witness);
* K3's PCG (100 iterations, eta 1e-2, on a real BA system): in float64
  the twin's iteration count and x within 1e-10 of max |x|; in float32
  held to the float64 twin, at most twice as far as the larger of the
  float32 twin's error and how far rounding alone moves the float32 twin
  (``rounding_gaps``), plus 1e-6.

Bounds (``bound``) follow the H100 SXM data sheet: 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores, each input read once and
each output written once, counting only the rows that this input keeps.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .ops import kernels

# The global refine's line-major problem on the bench's workload (the
# house, render seed 4, 400 keyframes): C cameras, L lines, kL rows a line,
# so L kL flat rows of which 0.8 % are padding
REFINE_C, REFINE_L, REFINE_KL = 400, 74, 400
REFINE_O = REFINE_L * REFINE_KL
# The loop-closure workload's merged refine on the card (bench.lc_workload,
# 170 village frames: 170 cameras, 453 lines of kL = 56 rows), and its
# share of padding rows (the same workload on the CPU packs 10,409 valid
# rows into 454 x 56)
LC_REFINE_C, LC_REFINE_L, LC_REFINE_O = 170, 453, 25_368
LC_REFINE_PAD = 0.59
# (O, D, P) of K1's calls: first the main path's, lines-GN's trial cost
# (2W x Om rows, 1 lane, Lp lines) with its line plan; then the assembly's
# widths (lines Hll|gl|cost and the 4-camera Hcc|gc of the VO window); then
# the refine's rows summed by camera at 6 and 36 lanes, K1's widest
# checks (on no path: the refine PCG's camera sums are K3's and K4's)
K1_SHAPES = ((1600, 1, 81), (1600, 21, 81), (162, 42, 4),
             (REFINE_O, 6, REFINE_C), (REFINE_O, 36, REFINE_C))
# (O, P) of the plans the main path builds: a frame's window lines and
# (cam, line) pairs and its VO polish's cameras; a refine solve's cameras
# and lines
PLAN_SHAPES = ((1600, 81), (1600, 20 * 81), (162, 4),
               (REFINE_O, REFINE_C), (REFINE_O, REFINE_L))
# The large map's line-major problem at full width
# (tools/torch_large_map_bench.py --cams 8192 --lines-per-cam 16, phase 9
# (a)): C cameras, L lines of kL = 32 rows, 929,796 valid rows, so ~73 %
# of the flat rows are padding
MAP_C, MAP_L, MAP_O, MAP_VALID = 8192, 109_147, 3_492_704, 929_796
MAP_PAD = 1.0 - MAP_VALID / MAP_O
# (O, P) of the larger plans the paths build: the large map's lines and
# cameras, the scaling tool's (cam, line) pairs (phase 10 (d)), the
# interactive bench window's pairs (phase 7) and the loop-closure PGO's
# largest V^2 plan (phase 6: 128 edges x 4 blocks over 32 poses)
PLAN_LARGE_SHAPES = ((MAP_O, MAP_L), (MAP_O, MAP_C), (16_384, 32_768),
                     (2048, 6144), (512, 32 * 32))
PLAN_LARGE_ROLES = ("map lines", "map cameras", "scaling tool pairs",
                    "interactive window pairs", "LC PGO V^2 blocks")
# (O, P) -> the plan's path there, on either side of each path's limit
# (csrc/segment_sum.cu: kSegmentBlocksWork = 2^21 >= (P + 1) O for one
# block a segment, kSmallMaxRows = 8192 >= O and kSmallMaxSegments =
# 65,535 >= P for one block)
PLAN_BOUNDARY_PATHS = {(2048, 1023): "segment_blocks",
                       (2048, 1024): "one_block",
                       (30_000, 68): "segment_blocks",
                       (30_000, 69): "tiles",
                       (8192, 65_535): "one_block",
                       (8193, 65_535): "tiles",
                       (8192, 65_536): "tiles"}
PLAN_BOUNDARY_SHAPES = tuple(PLAN_BOUNDARY_PATHS)
# (C, L, O) of each K2 variant on the main path: the window BA, the VO
# polish (2 frames x Lp rows over 4 cameras), lines-GN over the window,
# the refine's line-major evaluate
K2_SHAPES = {"full": (20, 81, 1600), "cams": (4, 81, 162),
             "lines": (20, 81, 1600), "lm": (REFINE_C, REFINE_L, REFINE_O)}
# k2_lm_case draws each line's cameras as a permutation up to this many
# (lines x cameras); the map-scale cases past it take a band
LM_CASE_PERMUTED = 10_000_000
K1_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
K2_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
K2_OUTPUTS = ("cost", "Hcc", "Hll", "gc", "gl", "W")
K2_VARIANT_OUTPUTS = {"full": K2_OUTPUTS, "cams": ("cost", "Hcc", "gc"),
                      "lines": ("Hll", "gl", "cost_l"),
                      "lm": ("cost", "Hcc", "Hll", "gc", "gl", "Wb")}

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
    if C > 2:                                 # (camera 0 is fixed)
        valid[oc == C - 1] = False            # camera C-1: no valid row
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


def k2_lm_case(dtype, device, C=REFINE_C, L=REFINE_L, kL=REFINE_KL,
               pad_frac=0.008, seed=0):
    """Arguments of fused_eval on a line-major problem: L buckets of kL
    rows (rows of line l at [l kL, (l + 1) kL), obs_line = l), each
    observed by distinct cameras in random order (by random cameras where
    kL > C; past LM_CASE_PERMUTED L C, as a map's band visibility, kL
    consecutive cameras from a random start, so that the case builds in
    seconds), ``pad_frac`` of the rows (one at least) padding (w_valid 0,
    zero observations, camera 0) at the end of their buckets; a fixed
    camera and a fixed line."""
    rng = np.random.default_rng(seed)
    cam = rng.standard_normal((C, 6)) * 0.1
    cam[1 % C, :3] = 0.0
    line = rng.standard_normal((L, 4)) * 0.2
    line[:, 3] = 0.3 + 0.5 * rng.random(L)
    oc, valid = _line_major_rows(rng, C, L, kL, pad_frac)
    obs = rng.standard_normal((L, kL, 8)) * 0.2
    obs[~valid] = 0.0
    cfree = np.ones(C)
    cfree[0] = 0.0
    lfree = np.ones(L)
    lfree[5 % L] = 0.0

    def f(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int32).reshape(-1),
                               device=device)

    return dict(cam_wt=f(cam), line_orth=f(line), obs=f(obs.reshape(-1, 8)),
                obs_cam=i(oc), obs_line=i(np.repeat(np.arange(L), kL)),
                w_valid=f(valid.reshape(-1).astype(np.float64)),
                cam_free_f=f(cfree), line_free_f=f(lfree), baseline=0.12,
                huber_delta=1.0 / 406.05)


def _line_major_rows(rng, C, L, kL, pad_frac):
    """k2_lm_case's rows: (L, kL) cameras, each line's distinct and in
    random order (random where kL > C; kL consecutive from a random start
    past LM_CASE_PERMUTED L C), and the (L, kL) validity, ``pad_frac`` of
    the rows (one at least) padding at the end of their buckets, camera 0
    there."""
    if kL > C or L * C <= LM_CASE_PERMUTED:
        oc = np.stack([rng.permutation(C)[:kL] if kL <= C
                       else rng.integers(0, C, kL) for _ in range(L)])
    else:
        band = (rng.integers(0, C, L)[:, None] + np.arange(kL)) % C
        oc = np.take_along_axis(band, np.argsort(rng.random((L, kL)),
                                                 axis=1), axis=1)
    n_pad = rng.multinomial(max(1, int(round(pad_frac * L * kL))),
                            np.ones(L) / L)
    valid = np.arange(kL)[None, :] < (kL - n_pad)[:, None]
    oc[~valid] = 0
    return oc, valid


def k2_variant_case(variant, dtype, device, shape=None, pad_frac=0.008):
    """The variant's case at ``shape`` (C, L, O), by default its main-path
    shape (k2_lm_case with kL = O / L and ``pad_frac`` for ``lm``, k2_case
    otherwise), and its plan."""
    C, L, O = shape or K2_SHAPES[variant]
    if variant == "lm":
        if O % L:
            raise ValueError(f"fused_eval/lm: O = {O} is not L = {L} buckets")
        args = k2_lm_case(dtype, device, C=C, L=L, kL=O // L,
                          pad_frac=pad_frac)
    else:
        args = k2_case(dtype, device, C=C, L=L, O=O)
    plan = kernels.ba_plan(args["obs_cam"], args["obs_line"],
                           args["w_valid"], C, L, variant)
    return args, plan


def assemble_case(C, L, O, dtype, device, seed=3):
    """Arguments of kernels.assemble: random per-row blocks A (O,6,6),
    B (O,4,4), Wb (O,6,4), gc_o (O,6), gl_o (O,4) and int32 camera and line
    indices, then C and L."""
    rng = np.random.default_rng(seed)
    parts = [torch.as_tensor(rng.standard_normal((O,) + shape), dtype=dtype,
                             device=device)
             for shape in ((6, 6), (4, 4), (6, 4), (6,), (4,))]
    idx = [torch.as_tensor(rng.integers(0, n, O).astype(np.int32),
                           device=device) for n in (C, L)]
    return (*parts, *idx, C, L)


def assemble_plain(A, B, Wb, gc_o, gl_o, obs_cam, obs_line, C, L):
    """kernels.assemble's function on the plain twin of K1."""
    O = A.shape[0]
    cam = kernels.segment_sum_twin(torch.cat([A.reshape(O, 36), gc_o], 1),
                                   obs_cam, C)
    line = kernels.segment_sum_twin(torch.cat([B.reshape(O, 16), gl_o], 1),
                                    obs_line, L)
    W = kernels.segment_sum_twin(Wb.reshape(O, 24), obs_cam * L + obs_line,
                                 C * L)
    return (cam[:, :36].reshape(C, 6, 6), line[:, :16].reshape(L, 4, 4),
            cam[:, 36:], line[:, 16:], W.reshape(C, L, 6, 4))


def check_assemble(dtype, device, C=20, L=81, O=1600):
    """kernels.assemble on ``device`` against assemble_plain on CPU copies.
    Returns the max abs error; raises if a normalized error exceeds
    K1_TOL."""
    args = assemble_case(C, L, O, dtype, device)
    got = kernels.assemble(*args)
    ref = assemble_plain(*(a.cpu() if torch.is_tensor(a) else a
                           for a in args))
    worst = 0.0
    for name, a, b in zip(("Hcc", "Hll", "gc", "gl", "W"), got, ref):
        err, max_abs = errors(a, b)
        if not err <= K1_TOL[dtype]:
            raise AssertionError(f"assemble {dtype} {name}: error {err} > "
                                 f"{K1_TOL[dtype]}")
        worst = max(worst, max_abs)
    return worst


def plan_case(O, P, device, seed=1):
    """An int32 key (O,) over P segments with padding rows (key = P and
    key = -1)."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, P, O).astype(np.int32)
    key[::9] = P
    key[4::13] = -1
    return torch.as_tensor(key, device=device)


def plan_adversarial_cases(seed=7):
    """[(name, int32 key (O,) as numpy, P)]: keys a plan must survive --
    negative keys and keys >= P, every row dropped, one segment, P = 1,
    P >> O (the PGO's V^2 plans), trailing empty segments, sorted and
    reversed keys, no rows, and O a multiple of no tile or warp."""
    rng = np.random.default_rng(seed)

    def keys(lo, hi, O):
        return rng.integers(lo, hi, O).astype(np.int32)

    return [
        ("negative and past P", keys(-40, 340, 5000), 300),
        ("every row dropped", np.where(rng.random(3000) < 0.5, -1,
                                       77).astype(np.int32), 77),
        ("one segment", np.full(2999, 5, np.int32), 9),
        ("P = 1", keys(-1, 3, 4097), 1),
        ("P >> O", keys(0, 40 * 40, 44), 40 * 40),
        ("P >> O, large", keys(-2, 200_000, 700), 200_000),
        ("trailing empty segments", keys(0, 50, 12_345), 4000),
        ("sorted", np.sort(keys(-3, 90, 9001)), 88),
        ("reversed", np.sort(keys(0, 1000, 20_001))[::-1].copy(), 1000),
        ("no rows", np.zeros(0, np.int32), 6),
        ("odd sizes", keys(-1, 130, 33_333), 129),
    ]


def check_plans(device, shapes=PLAN_SHAPES, cases=None):
    """segment_plan on ``device`` against its twin on CPU copies: on
    plan_case's key at each of ``shapes`` (O, P), or on ``cases`` [(name,
    key, P)].  On the card the plan runs on the path that (O, P) picks and
    on every path that can take (O, P) (kernels.plan_paths), each launched
    twice.  Returns [(name or (O, P), max abs difference)]; raises unless
    every launch's perm and offsets are identical to the twin's."""
    if cases is None:
        cases = [((O, P), plan_case(O, P, device), P) for O, P in shapes]
    out = []
    for name, key, P in cases:
        key = torch.as_tensor(key, device=device)
        ref = kernels.segment_plan_twin(key.cpu(), P)
        paths = (kernels.plan_paths(key.shape[0], P) if key.is_cuda
                 else [None])
        diff = 0
        for path in paths:
            for _ in range(2):
                got = kernels.segment_plan(key, P, path=path)
                for field in ("perm", "offsets"):
                    a, b = getattr(got, field).cpu(), getattr(ref, field)
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"segment_plan {name} path={path}: {field} "
                            "differs from the twin")
                    if a.numel():
                        diff = max(diff, int(torch.max(torch.abs(a - b))))
        out.append((name, diff))
    return out


def check_k1(dtype, device, shapes=K1_SHAPES):
    """K1 on ``device`` against the twin on CPU copies, at ``shapes`` (O, D,
    P), with and without a plan.  Returns [((O, D, P, with_plan),
    normalized error, max abs error)]; raises if an error exceeds
    K1_TOL."""
    out = []
    for (O, D, P) in shapes:
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


def check_k2(dtype, device, variant="full", shape=None, pad_frac=0.008):
    """K2's ``variant`` on ``device`` against its twin on the same device,
    launched twice with the variant's plan, at ``shape`` (C, L, O), by
    default the variant's main-path shape (``pad_frac``: k2_variant_case).
    Returns {output: (normalized error, max abs error)}; raises if
    an error exceeds K2_TOL or if the two launches differ in any bit.  For
    ``lm`` on the card the first launch's output must land in memory that
    held NaNs (the caching allocator hands the freed block back; the check
    raises if it handed back another), and every Wb row that the plan drops
    must come out exactly zero."""
    args, plan = k2_variant_case(variant, dtype, device, shape, pad_frac)
    nan_ptr = None
    if variant == "lm" and args["obs"].is_cuda:
        C, L, O = (args["cam_wt"].shape[0], args["line_orth"].shape[0],
                   args["obs"].shape[0])
        n = kernels.fused_eval_numel("lm", C, L, O)
        torch.cuda.empty_cache()            # the NaN block: the only free one
        nan_ptr = torch.full((n,), float("nan"), dtype=dtype,
                             device=device).data_ptr()
    got = kernels.fused_eval(**args, variant=variant, plan=plan)
    if (nan_ptr is not None
            and got[0].untyped_storage().data_ptr() != nan_ptr):
        raise AssertionError(f"fused_eval/lm {dtype}: the output did not land "
                             "in the NaN-filled block, so the zero-row check "
                             "would prove nothing")
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
    if variant == "lm":
        dropped = dropped_rows(plan.cam)
        if dropped.numel() == 0 or torch.any(got[5][dropped] != 0):
            raise AssertionError(f"fused_eval/lm {dtype}: a dropped row of "
                                 "Wb is not exactly zero")
    return errs


# (C, L, O) of K2 ``cost`` on the paths, and the share of padding rows at
# each: the refine's trial points, and the large map's (``survey.solve``)
K2_COST_SHAPES = {"refine": K2_SHAPES["lm"], "map": (MAP_C, MAP_L, MAP_O)}
K2_COST_PADS = {"refine": 0.008, "map": MAP_PAD}
# the shapes each K2 launch (kernels.K2_KERNELS) is checked at by default
K2_CHECKED_SHAPES = {**{v: (s,) for v, s in K2_SHAPES.items()},
                     "cost": tuple(K2_COST_SHAPES.values())}


def k2_cost_case(dtype, device, shape=K2_SHAPES["lm"], pad_frac=0.008):
    """Arguments of fused_cost at ``shape`` (C, L, O): k2_lm_case's
    line-major problem with ``pad_frac`` padding, and the solve's plan
    (``ba_plan(..., "lm")``)."""
    args, plan = k2_variant_case("lm", dtype, device, shape, pad_frac)
    del args["cam_free_f"], args["line_free_f"]
    return args, plan


def check_k2_cost(dtype, device, shape=K2_SHAPES["lm"], pad_frac=0.008):
    """K2 ``cost`` on ``device`` against its twin on the same device,
    launched twice with the solve's plan at ``shape`` (k2_cost_case), then
    again with NaNs in the observations of every row the plan drops.
    Returns (normalized error, max abs error); raises past K2_TOL, if the
    two launches differ in any bit, or if the NaNs move the cost or the
    twin's."""
    args, plan = k2_cost_case(dtype, device, shape, pad_frac)
    got = kernels.fused_cost(**args, plan=plan)
    if not torch.equal(got, kernels.fused_cost(**args, plan=plan)):
        raise AssertionError(f"fused_eval/cost {dtype}: two launches on the "
                             "same input differ")
    ref = kernels.fused_cost_twin(**args)
    err = errors(got, ref)
    if not err[0] <= K2_TOL[dtype]:
        raise AssertionError(f"fused_eval/cost {dtype}: error {err[0]} > "
                             f"{K2_TOL[dtype]}")
    dropped = dropped_rows(plan.line)
    if dropped.numel() == 0:
        raise AssertionError("fused_eval/cost: the case drops no row")
    obs = args["obs"].clone()
    obs[dropped] = float("nan")
    nan_args = dict(args, obs=obs)
    if not (torch.equal(kernels.fused_cost(**nan_args, plan=plan), got)
            and torch.equal(kernels.fused_cost_twin(**nan_args), ref)):
        raise AssertionError(f"fused_eval/cost {dtype}: NaNs in the dropped "
                             "rows moved the cost")
    return err


# ---------------------------------------------------------------------------
# K3 schur_matvec and K4 schur_jacobi
# ---------------------------------------------------------------------------

# (C, L, O) of the refine PCG's kernels on the paths (the bench's refine,
# the loop-closure workload's merged refine, the large map) and the share
# of padding rows at each
SCHUR_SHAPES = {"refine": (REFINE_C, REFINE_L, REFINE_O),
                "lc": (LC_REFINE_C, LC_REFINE_L, LC_REFINE_O),
                "map": (MAP_C, MAP_L, MAP_O)}
SCHUR_PADS = {"refine": 0.008, "lc": LC_REFINE_PAD, "map": MAP_PAD}
# f64: max abs error against the twin over the largest sum of the
# absolute terms an output adds (schur_term_scales: a sum's rounding
# scales with its terms, and K4's Hcc_d - sum T or the matvec's Hcc_d x -
# v cancel to far less than their terms on a real solve's blocks); f32:
# against the float64 twin on the same (upcast) inputs, at most
# SCHUR_F32_WITNESS x the float32 twin's own error there plus
# SCHUR_F32_FLOOR (rounding alone: each sums in its own order)
SCHUR_TOL = {torch.float64: 1e-12}
SCHUR_F32_WITNESS = 2.0
SCHUR_F32_FLOOR = 1e-6
SCHUR_OUTPUTS = {"schur_matvec/line": ("w", "z"),
                 "schur_matvec/cam": ("Sx", "rhs"),
                 "schur_jacobi": ("P",)}


def schur_case(dtype, device, shape=SCHUR_SHAPES["refine"], pad_frac=0.008,
               seed=0):
    """Inputs of K3 and K4 on a line-major problem of ``shape`` (C, L, O =
    L kL): k2_lm_case's rows (``pad_frac`` padding at the ends of the
    buckets), then camera C - 1 without a valid row and line L - 1 without
    one (C, L > 2), camera 0 fixed; random Wb (L, kL, 6, 4), zero on every
    invalid row (as K2 ``lm`` writes it), x, gc (C, 6), Hcc_d (C, 6, 6),
    Binv (L, 4, 4) symmetric positive definite, w (L, 4); and the plans
    (``ba_plan(..., "lm")``).  Made in float64 with numpy, then cast."""
    C, L, O = shape
    if O % L:
        raise ValueError(f"schur_case: O = {O} is not L = {L} buckets")
    kL = O // L
    rng = np.random.default_rng(seed)
    oc, valid = _line_major_rows(rng, C, L, kL, pad_frac)
    if C > 2 and L > 2:
        valid &= oc != C - 1
        valid[L - 1] = False
    Wb = np.zeros((L, kL, 6, 4))
    Wb[valid] = rng.standard_normal((int(valid.sum()), 6, 4)) * 0.5
    A = rng.standard_normal((L, 4, 4))
    Binv = A @ A.transpose(0, 2, 1) / 4 + 0.2 * np.eye(4)
    H = rng.standard_normal((C, 6, 6))
    Hcc_d = H @ H.transpose(0, 2, 1) + 6 * np.eye(6)
    cfree = np.ones(C)
    cfree[0] = 0.0

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    obs_cam = torch.as_tensor(oc.astype(np.int32), device=device)
    w_valid = f(valid.astype(np.float64))
    plan = kernels.ba_plan(obs_cam.reshape(-1), torch.arange(
        L, dtype=torch.int32, device=device).repeat_interleave(kL),
        w_valid.reshape(-1), C, L, "lm")
    return dict(Wb=f(Wb), obs_cam=obs_cam, w_valid=w_valid,
                cam_free_f=f(cfree), x=f(rng.standard_normal((C, 6))),
                gc=f(rng.standard_normal((C, 6))), Hcc_d=f(Hcc_d),
                Binv=f(Binv), w=f(rng.standard_normal((L, 4)))), plan


def schur_calls(case, plan, twin=False):
    """{kernel: a function of no arguments returning its outputs
    (SCHUR_OUTPUTS)} on ``case``: the wrappers, or with ``twin`` the plain
    twins on the case's device."""
    a = case
    if twin:
        key = plan.cam.key
        return {
            "schur_matvec/line": lambda: kernels.schur_matvec_line_twin(
                a["Wb"], a["obs_cam"], a["x"], a["cam_free_f"], a["Binv"]),
            "schur_matvec/cam": lambda: (
                kernels.schur_matvec_cam_twin(
                    a["Wb"], a["w"], a["cam_free_f"], key, Hcc_d=a["Hcc_d"],
                    x=a["x"]),
                kernels.schur_matvec_cam_twin(a["Wb"], a["w"],
                                              a["cam_free_f"], key,
                                              gc=a["gc"])),
            "schur_jacobi": lambda: (kernels.schur_jacobi_twin(
                a["Wb"], a["Binv"], a["Hcc_d"], a["cam_free_f"], key),)}
    return {
        "schur_matvec/line": lambda: kernels.schur_matvec_line(
            a["Wb"], a["obs_cam"], a["x"], a["cam_free_f"], a["Binv"],
            plan.line),
        "schur_matvec/cam": lambda: (
            kernels.schur_matvec_cam(a["Wb"], a["w"], a["cam_free_f"],
                                     plan.cam, Hcc_d=a["Hcc_d"], x=a["x"]),
            kernels.schur_matvec_cam(a["Wb"], a["w"], a["cam_free_f"],
                                     plan.cam, gc=a["gc"])),
        "schur_jacobi": lambda: (kernels.schur_jacobi(
            a["Wb"], a["Binv"], a["Hcc_d"], a["cam_free_f"], plan.cam),)}


def check_schur(dtype, device, shape=SCHUR_SHAPES["refine"], pad_frac=0.008,
                concurrency=False):
    """K3's two passes (the camera pass as the matvec and as the
    right-hand side) and K4 on ``device`` at ``shape`` against their twins
    on the same device, each launched twice (the launches must agree bit
    for bit).  float64: error <= SCHUR_TOL of the terms' scale
    (schur_term_scales); float32: against
    the float64 twin on the same inputs, within SCHUR_F32_WITNESS x the
    float32 twin's error plus SCHUR_F32_FLOOR.  With ``concurrency`` (on
    the card): launches on two streams at once and replayed from a CUDA
    graph equal an eager launch bit for bit, and a plan of the wrong
    segments (the line plan for the camera plan and back) is refused
    before any launch.  Returns {kernel output: (error against the
    same-dtype twin, max abs error)}, the error normalized by the terms'
    scale in float64 and by the output's (``errors``) in float32; raises
    on any failure."""
    case, plan = schur_case(dtype, device, shape, pad_frac)
    return check_schur_case(case, plan, concurrency)


def schur_step_case(Hcc, Hll, gc, gl, Wb, obs_cam, w_valid, cam_free_f,
                    lam=1e-3, seed=0):
    """K3 and K4's inputs from a solve's blocks (K2 ``lm``'s, say) as
    ``_solve_step_cg`` forms them at damping ``lam`` (Binv and Hcc_d by
    ``schur_cg.damped_blocks``, w = Binv gl), with a random x: (case,
    plan) for check_schur_case."""
    from .ops.schur_cg import damped_blocks, lm_plan
    _, _, Binv, Hcc_d = damped_blocks(Hcc, Hll, lam)
    C = Hcc.shape[0]
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((C, 6)), dtype=Hcc.dtype,
                        device=Hcc.device)
    case = dict(Wb=Wb.contiguous(), obs_cam=obs_cam.to(torch.int32)
                .contiguous(), w_valid=w_valid, cam_free_f=cam_free_f
                .contiguous(), x=x, gc=gc.contiguous(), Hcc_d=Hcc_d,
                Binv=Binv, w=torch.einsum("lab,lb->la", Binv, gl)
                .contiguous())
    return case, lm_plan(case["obs_cam"], w_valid, C)


def schur_term_scales(case, plan):
    """{kernel output: the largest over its entries of the sum of the
    absolute values of the terms the entry adds} on ``case``: |Wb|^T |x_m|
    summed over a line's rows (z), |Binv| times that (w), |Hcc_d| |x_m|
    plus the camera's sum of |Wb| |w| (the matvec; |x| for a fixed
    camera), |gc| plus that sum (the right-hand side), |Hcc_d| plus the
    camera's sum of |Wb| |Binv| |Wb|^T (K4)."""
    a = {k: (v.abs() if v.is_floating_point() else v) for k, v in
         case.items()}
    L, kL = a["Wb"].shape[:2]
    C = a["cam_free_f"].shape[0]
    key = plan.cam.key
    w_abs, z_abs = kernels.schur_matvec_line_twin(
        a["Wb"], a["obs_cam"], a["x"], a["cam_free_f"], a["Binv"])
    v_abs = kernels.segment_sum_twin(torch.einsum(
        "lkab,lb->lka", a["Wb"], a["w"]).reshape(L * kL, 6), key, C)
    xm = a["x"] * a["cam_free_f"][:, None]
    Sx = torch.where(a["cam_free_f"][:, None] > 0, torch.einsum(
        "cab,cb->ca", a["Hcc_d"], xm) + v_abs, a["x"])
    T = torch.einsum("lkab,lbc,lkdc->lkad", a["Wb"], a["Binv"], a["Wb"])
    P = a["Hcc_d"] + kernels.segment_sum_twin(
        T.reshape(L * kL, 36), key, C).reshape(C, 6, 6)
    return {k: float(v.max()) if v.numel() else 0.0 for k, v in {
        "schur_matvec/line w": w_abs, "schur_matvec/line z": z_abs,
        "schur_matvec/cam Sx": Sx, "schur_matvec/cam rhs": a["gc"] + v_abs,
        "schur_jacobi P": P}.items()}


def check_schur_case(case, plan, concurrency=False):
    """check_schur's checks on a schur_case-like ``case`` and its plan."""
    dtype = case["Wb"].dtype
    calls = schur_calls(case, plan)
    ref = {k: f() for k, f in schur_calls(case, plan, twin=True).items()}
    if dtype == torch.float64:
        scales = schur_term_scales(case, plan)
    if dtype == torch.float32:
        case64 = {k: (v.double() if v.is_floating_point() else v)
                  for k, v in case.items()}
        ref64 = {k: f() for k, f in schur_calls(case64, plan,
                                                 twin=True).items()}
    errs = {}
    for name, call in calls.items():
        got, again = call(), call()
        for out, a, a2, b in zip(SCHUR_OUTPUTS[name], got, again, ref[name]):
            if not torch.equal(a, a2):
                raise AssertionError(f"{name} {dtype} {out}: two launches "
                                     "on the same input differ")
            key = f"{name} {out}"
            errs[key] = errors(a, b)
            if dtype == torch.float64:
                err = errs[key][1] / max(1.0, scales[key])
                errs[key] = (err, errs[key][1])
                if not err <= SCHUR_TOL[dtype]:
                    raise AssertionError(
                        f"{name} {dtype} {out}: error {err} (of the terms' "
                        f"scale {scales[key]}) > {SCHUR_TOL[dtype]}")
        if dtype == torch.float32:
            for out, a, b, c in zip(SCHUR_OUTPUTS[name], got, ref[name],
                                    ref64[name]):
                err, twin_err = errors(a, c)[0], errors(b, c)[0]
                lim = SCHUR_F32_WITNESS * twin_err + SCHUR_F32_FLOOR
                if not err <= lim:
                    raise AssertionError(
                        f"{name} float32 {out}: error {err} against the "
                        f"float64 twin > {lim} (the float32 twin's "
                        f"{twin_err})")
        if concurrency:
            _schur_concurrency(name, call, got, case, plan)
    return errs


def _schur_concurrency(name, call, ref, case, plan):
    """check_schur's launches on two streams, from a CUDA graph, and with
    a wrong plan (the caller's case at a shape where C != L)."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    outs = []
    for _ in range(10):
        outs.append(call())
        with torch.cuda.stream(side):
            outs.append(call())
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(3):
        graph.replay()
        outs.append(call())
    torch.cuda.synchronize()
    for out in outs + [captured]:
        for a, b in zip(out, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: a launch on a second stream "
                                     "or from a CUDA graph differs")
    before = kernels.launch_counts[name]
    swapped = plan._replace(cam=plan.line, line=plan.cam)
    try:
        schur_calls(case, swapped)[name]()
    except ValueError:
        pass
    else:
        raise AssertionError(f"{name}: a plan of the wrong segments was "
                             "taken")
    if kernels.launch_counts[name] != before:
        raise AssertionError(f"{name}: launched with a wrong plan")


# K3's PCG: the refine's settings (global_ba_cg's defaults); f64 against
# the f64 twin: the same iterations, x within PCG_TOL of max |x|; f32
# against the f64 twin on the same (upcast) inputs, within PCG_F32_WITNESS
# x the larger of the f32 twin's own error and how far rounding alone
# moves the f32 twin (rounding_gaps at PCG_WITNESS_SCALE, a few f32
# units in the last place), plus SCHUR_F32_FLOOR, all of max |x|
PCG_ITERS = 100
PCG_ETA = 1e-2
PCG_TOL = 1e-10
PCG_F32_WITNESS = 2.0
PCG_WITNESS_SCALE = 3e-7


def pcg_case(dtype, device, shape=SCHUR_SHAPES["refine"], pad_frac=0.008,
             priors=False, lam=1e-3, seed=0):
    """K3 PCG's inputs on a real BA system at ``shape`` (C, L, O = L kL):
    K2 ``lm``'s blocks of k2_lm_case's problem (camera 0 and a line fixed),
    with ``priors`` a chain over the cameras and two loop edges (their
    Hcc and gc terms added, their coupling Hoff), damped at ``lam`` as
    ``_solve_step_cg`` damps them; the right-hand side (a K3 camera pass)
    and Minv (K4's blocks inverted).  (schur_case's random blocks give an
    indefinite S, on which PCG means nothing.)  Made in float64 on
    ``device``, then cast: (case, plan)."""
    from .ops.schur_ba import _inv4_equilibrated, prior_terms
    from .ops.schur_cg import _prior_edges, damped_blocks
    C, L, O = shape
    if O % L:
        raise ValueError(f"pcg_case: O = {O} is not L = {L} buckets")
    kL = O // L
    f64 = torch.float64
    a = k2_lm_case(f64, device, C=C, L=L, kL=kL, pad_frac=pad_frac,
                   seed=seed)
    plan = kernels.ba_plan(a["obs_cam"], a["obs_line"], a["w_valid"], C, L,
                           "lm")
    _, Hcc, Hll, gc, gl, Wb = kernels.fused_eval(**a, variant="lm",
                                                 plan=plan)
    Wb = Wb.reshape(L, kL, 6, 4).contiguous()
    mf = a["cam_free_f"]
    Hoff = prior = None
    if priors:
        rng = np.random.default_rng(seed + 1)
        edges = (np.array([0, 1]), np.array([C - 1, C // 2]),
                 rng.standard_normal((2, 6)) * 0.05)
        prior = _prior_edges(C, rng.standard_normal((C - 1, 6)) * 0.05,
                             edges, 0.02, 0.1, f64, device)
        _, gc_e, Hcc_e, Hoff = prior_terms(prior, a["cam_wt"], mf)
        Hcc, gc = Hcc + Hcc_e, gc + gc_e
    _, _, Binv, Hcc_d = damped_blocks(Hcc, Hll, lam)
    w0 = torch.einsum("lab,lb->la", Binv, gl).contiguous()
    rhs = kernels.schur_matvec_cam(Wb, w0, mf, plan.cam, gc=gc.contiguous())
    Minv = _inv4_equilibrated(kernels.schur_jacobi(Wb, Binv, Hcc_d, mf,
                                                   plan.cam))

    def f(t):
        return None if t is None else t.to(dtype).contiguous()

    return dict(rhs=f(rhs), Minv=f(Minv), Wb=f(Wb),
                obs_cam=a["obs_cam"].reshape(L, kL).contiguous(),
                cam_free_f=f(mf), Binv=f(Binv), Hcc_d=f(Hcc_d), Hoff=f(Hoff),
                prior_plan=None if prior is None else prior.plan), plan


def pcg_call(case, plan, cg_iters=PCG_ITERS, eta=PCG_ETA, twin=False):
    """A function of no arguments running K3's PCG on ``case`` (the wrapper,
    or with ``twin`` the plain twin on the case's device): (x, it)."""
    a = case
    pp = a["prior_plan"]
    if twin:
        return lambda: kernels.schur_pcg_twin(
            a["rhs"], a["Minv"], a["Wb"], a["obs_cam"], a["cam_free_f"],
            a["Binv"], a["Hcc_d"], plan.cam.key, cg_iters, eta, a["Hoff"],
            None if pp is None else pp.gkey)
    return lambda: kernels.schur_pcg(
        a["rhs"], a["Minv"], a["Wb"], a["obs_cam"], a["cam_free_f"],
        a["Binv"], a["Hcc_d"], plan.cam, plan.line, cg_iters, eta,
        a["Hoff"], pp)


_PCG_FLOATS = ("rhs", "Minv", "Wb", "Binv", "Hcc_d", "Hoff")


def check_pcg_case(case, plan, cg_iters=PCG_ITERS, eta=PCG_ETA):
    """K3's PCG on ``case`` (pcg_case) against its twin: launched twice (x
    and the count bit for bit); float64: the twin's iterations, x within
    PCG_TOL of max |x|; float32: against the float64 twin on the upcast
    inputs, within the rounding witness (PCG_F32_WITNESS, above).  Returns
    {"iterations", "twin_iterations", "err" (of max |x|), "max_abs_err",
    and in float32 "limit", "twin_err", "witness"}; raises on any
    failure."""
    dtype = case["Wb"].dtype
    run = pcg_call(case, plan, cg_iters, eta)
    (x, it), (x2, it2) = run(), run()
    if not (torch.equal(x, x2) and torch.equal(it, it2)):
        raise AssertionError(f"schur_pcg {dtype}: two launches on the same "
                             "input differ")
    it = int(it)
    if not 0 < it <= cg_iters:
        raise AssertionError(f"schur_pcg {dtype}: {it} iterations")
    if dtype == torch.float64:
        xt, itt = pcg_call(case, plan, cg_iters, eta, twin=True)()
        max_abs = float(torch.max(torch.abs(x - xt)))
        out = {"iterations": it, "twin_iterations": int(itt),
               "err": max_abs / float(torch.max(torch.abs(xt))),
               "max_abs_err": max_abs}
        if it != int(itt) or not out["err"] <= PCG_TOL:
            raise AssertionError(f"schur_pcg float64: {out} (tolerance "
                                 f"{PCG_TOL}, the twin's iterations)")
        return out
    case64 = {k: (v.double() if isinstance(v, torch.Tensor)
                  and v.is_floating_point() else v) for k, v in case.items()}
    x64, _ = pcg_call(case64, plan, cg_iters, eta, twin=True)()
    scale = float(torch.max(torch.abs(x64)))
    xt, itt = pcg_call(case, plan, cg_iters, eta, twin=True)()

    def twin_on(arrays):
        moved = dict(case, **dict(zip(_PCG_FLOATS, arrays)))
        return (pcg_call(moved, plan, cg_iters, eta, twin=True)()[0],)

    gaps = rounding_gaps(twin_on, [case[k] for k in _PCG_FLOATS],
                         scale=PCG_WITNESS_SCALE)
    max_abs = float(torch.max(torch.abs(x.double() - x64)))
    twin_err = float(torch.max(torch.abs(xt.double() - x64))) / scale
    witness = max(gaps["reversed"] + gaps["perturbed"]) / scale
    out = {"iterations": it, "twin_iterations": int(itt),
           "err": max_abs / scale, "max_abs_err": max_abs,
           "twin_err": twin_err, "witness": witness,
           "limit": PCG_F32_WITNESS * max(twin_err, witness)
           + SCHUR_F32_FLOOR}
    if not out["err"] <= out["limit"]:
        raise AssertionError(f"schur_pcg float32: {out}")
    return out


def check_pcg(dtype, device, shape=SCHUR_SHAPES["refine"], pad_frac=0.008,
              priors=False):
    """check_pcg_case on pcg_case(dtype, device, shape, pad_frac,
    priors)."""
    return check_pcg_case(*pcg_case(dtype, device, shape, pad_frac, priors))


# (C, L, O) of the interactive engine's window at the bench's buckets
# (obs 2048, cams 48, lines 128; bench.interactive_config)
INTERACTIVE_WINDOW = (48, 128, 2048)


def check_k2_chart(dtype, device, variant="full", line_param="aid",
                   shape=INTERACTIVE_WINDOW):
    """K2 through the chain rule (``kernels.fused_eval`` with aid or asd
    lines) against the twin that differentiates in that parameterization,
    on the same device, at ``shape``; the case's lines are k2_case's orth
    lines re-encoded.  Returns {output: (normalized error, max abs
    error)}; raises past K2_TOL."""
    from . import geometry as geo
    args, plan = k2_variant_case(variant, dtype, device, shape)
    av = geo.orth_to_av(args["line_orth"].double())
    args["line_orth"] = geo.LINE_ENCODERS[line_param](av).to(dtype)
    got = kernels.fused_eval(**args, line_param=line_param, variant=variant,
                             plan=plan)
    ref = kernels.fused_eval_twin(**args, line_param=line_param,
                                  variant=variant)
    errs = {}
    for name, a, b in zip(K2_VARIANT_OUTPUTS[variant], got, ref):
        errs[name] = errors(a, b)
        if not errs[name][0] <= K2_TOL[dtype]:
            raise AssertionError(f"fused_eval/{variant} {line_param} {dtype} "
                                 f"{name}: error {errs[name][0]} > "
                                 f"{K2_TOL[dtype]}")
    return errs


def dropped_rows(plan):
    """The rows a segment plan drops: perm[offsets[P]:]."""
    return plan.perm[int(plan.offsets[-1]):].long()


def prior_ba_case(C=8, L=64, O=256):
    """A random window BA problem in the camera-major blocked layout (the
    recipe of __graft_entry__._example_ba_problem, in numpy), float64, and
    prior edges: a strong chain, a weak loop edge, zero-weight padding."""
    from .hostgeom import Pose
    rng = np.random.default_rng(0)
    cam = rng.standard_normal((C, 6)) * 0.1
    line = rng.standard_normal((L, 4)) * 0.2
    line[:, 3] = 0.3 + 0.1 * rng.random(L)
    obs = rng.standard_normal((O, 8)) * 0.2
    oc = rng.integers(0, C, O)
    ol = rng.integers(0, L, O)
    _, first = np.unique(oc * L + ol, return_index=True)
    OmC = max(8, -(-int(np.bincount(oc[first], minlength=C).max()) // 8) * 8)
    ob_b = np.zeros((C * OmC, 8))
    ol_b = np.zeros(C * OmC, np.int32)
    ov_b = np.zeros(C * OmC, bool)
    fill = np.zeros(C, int)
    for o in sorted(first):
        k = oc[o] * OmC + fill[oc[o]]
        fill[oc[o]] += 1
        ob_b[k], ol_b[k], ov_b[k] = obs[o], ol[o], True
    cfree = np.ones(C, bool)
    cfree[0] = False
    ei = np.array([0, 1, 2, 3, 4, 5, 7, 0], np.int32)
    ej = np.array([1, 2, 3, 4, 5, 6, 2, 0], np.int32)
    ec = np.stack([(Pose.from_wt(cam[b]) @ Pose.from_wt(cam[a]).inv()).wt()
                   + rng.standard_normal(6) * 0.02 for a, b in zip(ei, ej)])
    ec[-1] = 0.0
    sig = np.array([[0.01, 0.05]] * 6 + [[0.2, 1.0], [1e9, 1e9]])
    arrays = (cam, line, ob_b, np.repeat(np.arange(C, dtype=np.int32), OmC),
              ol_b, ov_b, cfree, np.ones(L, bool))
    return arrays, (ei, ej, ec, sig)


def rounding_gaps(run, arrays, seeds=(0, 1, 2), scale=1e-15):
    """How far rounding alone moves ``run(arrays)`` (a tuple of tensors) on
    the CPU: {"reversed": the largest difference of each output from the
    plain run's with the twins' sums reversed (reversed_twin_sums),
    "perturbed": the largest over ``seeds`` with every float array of
    ``arrays`` scaled by 1 + ``scale`` N(0, 1), a few units in the last
    place}."""
    ref = run(arrays)

    def gaps(out):
        return [float(torch.max(torch.abs(a - b))) for a, b in zip(out, ref)]

    with reversed_twin_sums():
        rev = gaps(run(arrays))
    pert = [0.0] * len(ref)
    for seed in seeds:
        rng = np.random.default_rng(seed)
        moved = [_moved(a, rng, scale) for a in arrays]
        pert = [max(x, y) for x, y in zip(pert, gaps(run(moved)))]
    return {"reversed": rev, "perturbed": pert}


def _moved(a, rng, scale):
    """A float array or tensor scaled by 1 + ``scale`` N(0, 1) elementwise
    (a tensor keeps its dtype and device); anything else as it is."""
    if isinstance(a, torch.Tensor):
        if not a.is_floating_point():
            return a
        noise = torch.as_tensor(rng.standard_normal(tuple(a.shape)),
                                device=a.device)
        return (a.double() * (1 + scale * noise)).to(a.dtype)
    if a is None or not np.issubdtype(np.asarray(a).dtype, np.floating):
        return a
    return a * (1 + scale * rng.standard_normal(a.shape))


@contextlib.contextmanager
def reordered_twin_sums(seed=None):
    """The kernels' plain twins with every sum over rows (K1's and K2's
    ``index_add_`` reductions, and the sum of K2 ``cost``'s kept rows)
    taken in another row order: reversed, or with ``seed`` an order drawn
    at random for each sum.  The same function with its float additions
    in another order, as the card's kernels take them: a witness of how far
    rounding alone moves a solver."""
    gen = None if seed is None else torch.Generator().manual_seed(seed)

    def order(n, device):
        if gen is None:
            return torch.arange(n - 1, -1, -1, device=device)
        return torch.randperm(n, generator=gen).to(device)

    def acc(shape, index, vals):
        o = order(index.shape[0], index.device)
        return torch.zeros(shape, dtype=vals.dtype,
                           device=vals.device).index_add_(0, index[o],
                                                          vals[o])

    def seg_sum(values, idx, num_segments):
        keep = (idx >= 0) & (idx < num_segments)
        idx, values = idx[keep].long(), values[keep]
        o = order(idx.shape[0], idx.device)
        out = torch.zeros((num_segments,) + values.shape[1:],
                          dtype=values.dtype, device=values.device)
        return out.index_add_(0, idx[o], values[o])

    def total(vals):
        return torch.sum(vals[order(vals.shape[0], vals.device)])

    saved = kernels._acc, kernels.segment_sum_twin, kernels._total
    kernels._acc, kernels.segment_sum_twin, kernels._total = (acc, seg_sum,
                                                              total)
    try:
        yield
    finally:
        kernels._acc, kernels.segment_sum_twin, kernels._total = saved


def reversed_twin_sums():
    """reordered_twin_sums in reversed row order."""
    return reordered_twin_sums()


# the random orders of the twins' sums that order_draws takes beside the
# reversed one: 19 draws in all, so that a result of rounding alone lies
# beyond every draw with a chance of 1 in 20
ORDER_SEEDS = tuple(range(18))


def order_draws(run, seeds=ORDER_SEEDS):
    """``run()`` on the CPU with the twins' sums reversed, then in the
    random order of each of ``seeds`` (reordered_twin_sums): a result of
    rounding alone for each draw.  Where a solver is chaotic (one that
    stops at its cap short of convergence), one draw says little: these
    spread over branches that lie orders of magnitude apart."""
    with reversed_twin_sums():
        draws = [run()]
    for seed in seeds:
        with reordered_twin_sums(seed):
            draws.append(run())
    return draws


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


def assemble_work(C, L, O, e):
    """(bytes, operations) of assemble: its three K1 sums (each with its
    plan), every row kept."""
    b = o = 0
    for D, P in ((42, C), (20, L), (24, C * L)):
        plan_b, _ = plan_work(O, P)
        b += plan_b + O * D * e + 4 * O + 4 * (P + 1) + P * D * e
        o += O * D
    return b, o


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
    "row_out": 168,             # Wb per row, no reduction
}
_K2_PARTS = {
    "full": ("residual", "dr_dq", "cam_cols", "line_cols", "huber",
             "weigh_r", "weigh_cam", "weigh_line", "cam_out", "line_out",
             "pair_out"),
    "cams": ("residual", "dr_dq", "cam_cols", "huber", "weigh_r",
             "weigh_cam", "cam_out"),
    "lines": ("residual", "dr_dq", "line_cols", "huber", "weigh_r",
              "weigh_line", "line_out", "line_cost"),
    "lm": ("residual", "dr_dq", "cam_cols", "line_cols", "huber", "weigh_r",
           "weigh_cam", "weigh_line", "cam_out", "line_out", "row_out"),
}


def schur_work(name, C, L, kept, e, rhs=False, E=0):
    """(bytes, operations) of one K3 pass or K4 launch (``name`` as in
    SCHUR_OUTPUTS; ``rhs``: the camera pass as the right-hand side), or of
    one iteration of K3's PCG (``"schur_pcg"``, with ``E`` prior edges),
    over ``kept`` valid rows with e-byte floats: each valid row's Wb and
    plan entry (the line pass also its camera index), the per-camera and
    per-line blocks and the plan's offsets read once, the outputs written
    once.  Padding rows count nothing: the function does not need them."""
    if name == "schur_pcg":
        # the matvec's line and camera passes; the update's Minv, x, r, z,
        # p and Ap a camera, C (36 + 5 6) values: z = Minv r (72), x, r and
        # p (36), the dot products (24); the priors' 2E rows: Hoff once an
        # edge, the rows' keys and plan entries, the gathered p_m, the
        # plan's offsets, a 6 x 6 product a row (72) and its adds
        b, o = (sum(t) for t in zip(
            schur_work("schur_matvec/line", C, L, kept, e),
            schur_work("schur_matvec/cam", C, L, kept, e)))
        b += C * (36 + 5 * 6) * e
        o += C * (72 + 36 + 24)
        if E:
            b += E * 36 * e + 2 * E * (4 + 4 + 6 * e) + 4 * (C + 1)
            o += 2 * E * (72 + 6) + C * 12
        return b, o
    row = kept * (24 * e + 4)
    if name == "schur_matvec/line":
        # z = sum of Wb^T x_m (48 + 4 a row), w = Binv z (32 a line)
        return (row + 4 * kept + C * 7 * e + L * 16 * e + 4 * (L + 1)
                + 2 * L * 4 * e, kept * 52 + L * 32 + 6 * C)
    if name == "schur_matvec/cam":
        # v = sum of Wb w (48 + 6 a row); a camera's Hcc_d x_m (72) and
        # masks (36) in the matvec, (-gc + v) m (12) in the right-hand side
        blocks = C * (6 + 1) * e if rhs else C * (36 + 6 + 1) * e
        return (row + L * 4 * e + 4 * (C + 1) + blocks + C * 6 * e,
                kept * 54 + C * (12 if rhs else 108))
    if name == "schur_jacobi":
        # Wb Binv (192 a row), times Wb^T (288), the sum (36)
        return (row + L * 16 * e + 4 * (C + 1) + C * 37 * e + C * 36 * e,
                kept * 516 + C * 36)
    raise ValueError(f"unknown kernel {name!r}")


def schur_case_work(name, case, plan, rhs=False):
    """schur_work on a schur_case (or a solve's tensors: Wb, cam_free_f)
    and its plan: its kept rows are the plan's."""
    L = case["Wb"].shape[0]
    return schur_work(name, case["cam_free_f"].shape[0], L,
                      int(plan.cam.offsets[-1]), case["Wb"].element_size(),
                      rhs)


def pcg_work(case, plan, iterations):
    """(bytes, operations) of one K3 PCG launch on a pcg_case that ran
    ``iterations`` PCG iterations: schur_work's iteration that many times
    (the set-up's rhs and Minv reads, once a launch, are below one
    iteration's)."""
    Hoff = case["Hoff"]
    b, o = schur_work("schur_pcg", case["cam_free_f"].shape[0],
                      case["Wb"].shape[0], int(plan.cam.offsets[-1]),
                      case["Wb"].element_size(),
                      E=0 if Hoff is None else Hoff.shape[0])
    return b * iterations, o * iterations


def k2_row_ops(variant):
    """Operations per valid row of K2's ``variant`` (_K2_OPS)."""
    return sum(_K2_OPS[k] for k in _K2_PARTS[variant])


def cost_work(C, L, n, e):
    """(bytes, operations) of K2 ``cost`` over ``n`` valid rows with
    ``e``-byte floats: the parameters, each valid row's observation,
    camera index and weight read once, one value written; the residual and
    the Huber cost a row (_K2_OPS)."""
    return (C * 6 * e + L * 4 * e + n * (8 * e + 4 + e) + e,
            n * (_K2_OPS["residual"] + _K2_OPS["huber"]))


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
    O = args["obs"].shape[0]
    write = {"full": 1 + C * 42 + L * 20 + C * L * 24, "cams": 1 + C * 42,
             "lines": L * 21, "lm": 1 + C * 42 + L * 20 + O * 24}[variant] * e
    return read + write, n * k2_row_ops(variant)
