"""The port's hand-written CUDA kernels, their wrappers and plain twins.

K1 ``segment_sum`` — per-segment row sums (O, D) x idx (O,) -> (P, D),
rows with idx outside [0, P) dropped.  Replaces ``segment_sum_pallas``
(slslam_tpu/ops/pallas_kernels.py:49-81).  Its source also holds the
segment plan, ``segment_plan``: the rows grouped stably by index (a
permutation plus offsets), which a BA solve builds once and hands to K1 and
K2 in every LM iteration.  On the main path K1 sums lines-GN's trial cost
and the pose priors' blocks (the refine PCG's per-camera rows are K3's and
K4's).
Source: ``csrc/segment_sum.cu``.

K2 ``fused_eval`` — the BA evaluate in one launch (``lm``: two): gather,
residual, forward-mode Jacobian columns, Huber weights, NaN-proof masks,
and the reductions, in four variants (``VARIANTS``):

* ``full``: cost, Hcc, Hll, gc, gl and the cam-line coupling W (the window
  BA, ``schur_ba._eval_system``);
* ``cams``: cost, Hcc, gc — ``full`` with every line fixed (the pose-only
  VO polish, ``schur_ba._eval_pose_system``);
* ``lines``: Hll, gl and the per-line cost — ``full`` with every camera
  fixed (lines-GN's evaluate);
* ``lm``: cost, Hcc, Hll, gc, gl and the cam-line coupling per row, Wb
  (O,6,4) — the global refine's line-major evaluate
  (``schur_cg._eval_system_lm``): a row pass over the line plan (Wb,
  Hll, gl; zeros on the dropped rows), then a camera pass (Hcc, gc, cost).

Replaces ``fused_eval_pallas`` with its two kernels
(pallas_kernels.py:278-428).  Source: ``csrc/fused_eval.cu``.  K2 decodes
orth lines; the aid and asd parameterizations go through it by the chain
rule (``fused_eval_chart``): each line is decoded to orth, K2 evaluates,
and the line blocks are mapped by M = d orth / d p, one 4x4 per line.

K3 ``schur_matvec`` and ``schur_pcg``, K4 ``schur_jacobi`` — the global
refine's PCG on the reduced camera system S = Hcc_d - W Binv W^T over the
line-major layout (``schur_cg._solve_step_cg``), which the JAX package
left to XLA einsums and a ``lax.while_loop`` (slslam_tpu/ops/
schur_cg.py:173-279):

* K3's line pass (``schur_matvec_line``): w = Binv z, z = sum over each
  line's valid rows of Wb^T x_m[cam] (the back-substitution's coupling z);
* K3's camera pass (``schur_matvec_cam``): the per-camera sums of Wb
  w[line] and S x with fixed cameras as the identity, or the right-hand
  side (-gc + W Binv gl) m;
* K3's PCG (``schur_pcg``): the whole PCG loop of one damped LM step in
  one cooperative launch (the passes' device functions on the search
  direction, the preconditioner, the dot products, the pose priors'
  coupling over their node plan and the stop test), with no host read;
* K4 (``schur_jacobi``): the SCHUR_JACOBI blocks Hcc_d - sum of Wb Binv
  Wb^T over each camera's rows, the identity for a fixed camera.

Each reads only the valid rows, through the solve's line or camera plan,
with no (rows, ...) intermediate in memory.  Source: ``csrc/schur_cg.cu``;
``schur_pcg``'s grid barriers (``cooperative_groups::this_grid().sync()``)
need no relocatable device code (``-rdc``) on this toolkit.

Each wrapper takes its plain-PyTorch twin for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  The kernels are built with
``nvcc`` for ``sm_90a`` from ``slslam_tpu_torch/csrc`` at first use into
``build/kernels/`` beside the package (git-ignored), one library per source,
all sources compiled at once, and bound with ctypes.  ``launch_counts``
counts the launches of each kernel and K2 variant; ``ptxas_log`` keeps each
build's ``-Xptxas -v`` report (registers, spills).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from typing import Dict, NamedTuple, Optional

import torch

from .. import geometry as geo
from .residuals import (lba_residual_jac_batch, lba_residual_jac_cam_batch,
                        lba_residual_jac_line_batch, robust_weights)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("segment_sum.cu", "fused_eval.cu", "schur_cg.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
VARIANTS = ("full", "cams", "lines", "lm")

# launches of each kernel since the last reset_launch_counts(), and the
# same launches by shape: (kernel, shape) -> launches, the shape (O, P) for
# the plan, (O, D, P) for K1 and (C, L, O) for K2, K3 and K4
SCHUR_KERNELS = ("schur_matvec/line", "schur_matvec/cam", "schur_pcg",
                 "schur_jacobi")
launch_counts: Dict[str, int] = {
    "segment_plan": 0, "segment_sum": 0,
    **{f"fused_eval/{v}": 0 for v in VARIANTS},
    **dict.fromkeys(SCHUR_KERNELS, 0)}
launch_shapes: Dict[tuple, int] = {}
# wall seconds of the nvcc builds in this process (None until built)
build_seconds = None
# source -> nvcc's -Xptxas -v report of its build
ptxas_log: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_tickets: Dict[tuple, torch.Tensor] = {}  # (device, stream) -> counter
# device -> [zeroed counters for captured launches, how many are taken]
_graph_tickets: Dict[torch.device, list] = {}
_GRAPH_TICKETS = 4096
# (device, dtype, C, L, O) -> schur_pcg's grid
_pcg_blocks: Dict[tuple, int] = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0
    launch_shapes.clear()


def _count(name, shape):
    launch_counts[name] += 1
    launch_shapes[name, shape] = launch_shapes.get((name, shape), 0) + 1


def _find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _bind(libs):
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    k1, k2 = libs["segment_sum"], libs["fused_eval"]
    for suf in ("f32", "f64"):
        fn = getattr(k1, f"seg_sum_{suf}")
        fn.argtypes = [p, p, p, p, i, i, p]
        fn.restype = i
        fn = getattr(k2, f"fused_eval_{suf}")
        fn.argtypes = [i, p, p, p, p, p, p, p, p, d, d, i, i, i, p, p, i, p,
                       p, p, p, p]
        fn.restype = i
    k1.seg_plan.argtypes = [p, i, i, p, p, p, i, p]
    k1.seg_plan.restype = i
    k1.seg_plan_path.argtypes = [i, i, i]
    k1.seg_plan_path.restype = i
    k1.seg_plan_scratch.argtypes = [i, i, i]
    k1.seg_plan_scratch.restype = ctypes.c_longlong
    k2.fused_eval_scratch.argtypes = [i, i, i, i]
    k2.fused_eval_scratch.restype = ctypes.c_longlong
    k3 = libs["schur_cg"]
    for suf in ("f32", "f64"):
        fn = getattr(k3, f"schur_line_{suf}")
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p, p]
        fn.restype = i
        fn = getattr(k3, f"schur_cam_{suf}")
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, p, p]
        fn.restype = i
        fn = getattr(k3, f"schur_jacobi_{suf}")
        fn.argtypes = [p, p, p, p, p, p, i, i, i, p, p]
        fn.restype = i
        fn = getattr(k3, f"schur_pcg_{suf}")
        fn.argtypes = [p] * 13 + [i, i, i, i, p, p, d, i, i, p, p, p, p]
        fn.restype = i
    k3.schur_pcg_blocks.argtypes = [i, i, i, i]
    k3.schur_pcg_blocks.restype = i


def load_library():
    """Build (once per source content; the sources compile in parallel)
    and load the kernel libraries: {source stem: ctypes.CDLL}."""
    global build_seconds
    if _libs:
        return _libs
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    targets, procs = {}, {}
    for src in SOURCES:
        path = os.path.join(CSRC_DIR, src)
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        with open(path, "rb") as f:
            h.update(f.read())
        stem = src[:-3]
        so = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
        targets[stem] = so
        if not os.path.isfile(so):
            cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", f"{so}.{os.getpid()}.tmp",
                   path]
            procs[stem] = (cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed = []
    for stem, (cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + log)
            continue
        so = targets[stem]
        with open(f"{so}.ptxas.txt", "w") as f:
            f.write(log)
        os.replace(f"{so}.{os.getpid()}.tmp", so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    libs = {}
    for stem, so in targets.items():
        libs[stem] = ctypes.CDLL(so)
        report = f"{so}.ptxas.txt"
        if os.path.isfile(report):
            with open(report) as f:
                ptxas_log[stem] = f.read()
    _bind(libs)
    build_seconds = time.perf_counter() - t0
    _libs.update(libs)
    return _libs


def _suffix(dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"kernels take float32 or float64, not {dtype}")


def _check_cuda(name, dev, **tensors):
    for k, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {k} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _device_kind(name, t):
    if t.device.type == "cpu":
        return "cpu"
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return "cuda"


# ---------------------------------------------------------------------------
# Segment plans
# ---------------------------------------------------------------------------

class SegmentPlan(NamedTuple):
    """The rows grouped stably by key (``segment_plan``)."""

    key: torch.Tensor      # (O,) int32 the index it was built from
    perm: torch.Tensor     # (O,) int32 rows of segment 0, 1, ... in
    #                        observation order, then the dropped rows
    offsets: torch.Tensor  # (P + 1,) int32 segment starts; [P] = kept rows


def _check_plan(name, plan, O, P, dev):
    """Raises unless ``plan`` groups O rows into P segments on ``dev``: a
    plan of another shape would make a kernel read out of bounds."""
    if (tuple(plan.perm.shape) != (O,)
            or tuple(plan.offsets.shape) != (P + 1,)):
        raise ValueError(f"{name}: plan of {tuple(plan.perm.shape)} rows and "
                         f"{tuple(plan.offsets.shape)} offsets, expected "
                         f"({O},) and ({P + 1},)")
    for k in ("perm", "offsets"):
        if getattr(plan, k).dtype != torch.int32:
            raise TypeError(f"{name}: plan {k} must be int32")
    _check_cuda(name, dev, perm=plan.perm, offsets=plan.offsets)


def segment_plan_twin(key, num_segments):
    """Plain version of the plan: a stable argsort of the key (rows outside
    [0, P) last) and the cumulative segment counts."""
    P = num_segments
    keep = (key >= 0) & (key < P)
    k = torch.where(keep, key, torch.full_like(key, P))
    perm = torch.argsort(k, stable=True).to(torch.int32)
    counts = torch.bincount(k[keep].long(), minlength=P)
    offsets = torch.zeros(P + 1, dtype=torch.int32, device=key.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return SegmentPlan(key, perm, offsets)


PLAN_PATHS = {None: 0, "one_block": 1, "tiles": 2, "segment_blocks": 3}


def segment_plan(key, num_segments, path=None):
    """The plan of an (O,) int32 key over P segments.  CPU tensors take the
    twin; CUDA tensors launch K1's plan on one of three paths
    (csrc/segment_sum.cu): one block a segment for small (P + 1) O, a
    stable LSD radix sort in one block in shared memory for small (O, P),
    else the sort in tiles (three launches a pass and one for the offsets,
    with a scratch of its own).  Integer work only, the same bytes on every
    path.  ``path``: None picks by (O, P) alone; "segment_blocks",
    "one_block" or "tiles" forces one (tests compare them; a path raises
    where it cannot take (O, P))."""
    if _device_kind("segment_plan", key) == "cpu":
        return segment_plan_twin(key, num_segments)
    if key.dim() != 1 or key.dtype != torch.int32:
        raise TypeError("segment_plan: key must be a 1-D int32 tensor")
    if path not in PLAN_PATHS:
        raise ValueError(f"segment_plan: unknown path {path!r}")
    _check_cuda("segment_plan", key.device, key=key)
    O, P = key.shape[0], num_segments
    lib = load_library()["segment_sum"]
    if lib.seg_plan_path(O, P, PLAN_PATHS[path]) < 0:
        raise ValueError(f"segment_plan: the {path} path cannot take "
                         f"(O, P) = {(O, P)}")
    perm = torch.empty(O, dtype=torch.int32, device=key.device)
    offsets = torch.empty(P + 1, dtype=torch.int32, device=key.device)
    n = lib.seg_plan_scratch(O, P, PLAN_PATHS[path])
    scratch = (torch.empty(n, dtype=torch.int32, device=key.device) if n
               else None)
    err = lib.seg_plan(key.data_ptr(), O, P, perm.data_ptr(),
                       offsets.data_ptr(),
                       None if scratch is None else scratch.data_ptr(),
                       PLAN_PATHS[path], _stream(key.device))
    _raise_on("segment_plan", err)
    _count("segment_plan", (O, P))
    return SegmentPlan(key, perm, offsets)


def plan_paths(O, P):
    """The paths ``segment_plan`` can take at (O, P) on the card: None (the
    one (O, P) picks), then each forced path that can."""
    lib = load_library()["segment_sum"]
    return [None] + [p for p in ("segment_blocks", "one_block", "tiles")
                     if lib.seg_plan_path(O, P, PLAN_PATHS[p]) > 0]


def plan_path(O, P):
    """The path ``segment_plan`` picks at (O, P) on the card."""
    lib = load_library()["segment_sum"]
    names = {v: k for k, v in PLAN_PATHS.items() if k is not None}
    return names[lib.seg_plan_path(O, P, 0)]


class BAPlan(NamedTuple):
    """Segment plans of one BA solve's rows (valid rows only): by camera
    (``cams``, ``lm``), by line (``full``, ``lines``, ``lm``) and by (cam,
    line) pair (``full``).  The rows never change inside a solve."""

    cam: Optional[SegmentPlan]
    line: Optional[SegmentPlan]
    pair: Optional[SegmentPlan]


def ba_plan(obs_cam, obs_line, w_valid, C, L, variant):
    """The plans that K2's ``variant`` reads.  A row is kept where
    w_valid > 0 and both indices are in range."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown fused_eval variant {variant!r}")
    ok = ((w_valid > 0) & (obs_cam >= 0) & (obs_cam < C) & (obs_line >= 0)
          & (obs_line < L))

    def plan(key, P):
        key = torch.where(ok, key, torch.full_like(key, P))
        return segment_plan(key.to(torch.int32).contiguous(), P)

    return BAPlan(
        cam=plan(obs_cam, C) if variant in ("cams", "lm") else None,
        line=plan(obs_line, L) if variant != "cams" else None,
        pair=plan(obs_cam * L + obs_line, C * L) if variant == "full"
        else None)


# ---------------------------------------------------------------------------
# K1: segment_sum
# ---------------------------------------------------------------------------

def segment_sum_twin(values, idx, num_segments):
    """Plain version of K1: ``index_add_`` of the rows with 0 <= idx < P."""
    keep = (idx >= 0) & (idx < num_segments)
    out = torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, idx[keep].long(), values[keep])


def segment_sum(values, idx, num_segments, plan=None):
    """Per-segment sums (O, D), (O,) int32 -> (P, D); rows with idx outside
    [0, P) dropped.  ``plan``: ``segment_plan(idx, P)``, reused across
    calls; without one the wrapper builds it first (one more launch).

    CPU tensors take the twin; CUDA tensors launch K1 (deterministic: one
    block per segment, row slots summed in a fixed tree)."""
    if _device_kind("segment_sum", values) == "cpu":
        return segment_sum_twin(values, idx, num_segments)
    if values.dim() != 2 or idx.shape != values.shape[:1]:
        raise ValueError(f"segment_sum: shapes {tuple(values.shape)}, "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError("segment_sum: idx must be int32")
    _check_cuda("segment_sum", values.device, values=values, idx=idx)
    O, D = values.shape
    P = num_segments
    out = torch.empty((P, D), dtype=values.dtype, device=values.device)
    if P == 0 or D == 0:
        return out
    if plan is None:
        plan = segment_plan(idx, P)
    _check_plan("segment_sum", plan, O, P, values.device)
    lib = load_library()["segment_sum"]
    fn = getattr(lib, f"seg_sum_{_suffix(values.dtype)}")
    err = fn(values.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
             out.data_ptr(), D, P, _stream(values.device))
    _raise_on("segment_sum", err)
    _count("segment_sum", (O, D, P))
    return out


def assemble(A, B, Wb, gc_o, gl_o, obs_cam, obs_line, C, L):
    """Full BA assembly over K1 (port of assemble_pallas,
    pallas_kernels.py:92-126, without its TPU-only scatter cut-over):
    (O,6,6),(O,4,4),(O,6,4),(O,6),(O,4) -> Hcc, Hll, gc, gl, W."""
    O = A.shape[0]
    cam_out = segment_sum(torch.cat([A.reshape(O, 36), gc_o], dim=1),
                          obs_cam, C)
    line_out = segment_sum(torch.cat([B.reshape(O, 16), gl_o], dim=1),
                           obs_line, L)
    pair = (obs_cam * L + obs_line).to(torch.int32)
    W = segment_sum(Wb.reshape(O, 24), pair, C * L).reshape(C, L, 6, 4)
    return (cam_out[:, :36].reshape(C, 6, 6), line_out[:, :16].reshape(L, 4, 4),
            cam_out[:, 36:], line_out[:, 16:], W)


# ---------------------------------------------------------------------------
# K2: fused_eval
# ---------------------------------------------------------------------------

def _acc(shape, index, vals):
    return torch.zeros(shape, dtype=vals.dtype,
                       device=vals.device).index_add_(0, index, vals)


def fused_eval_twin(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                    cam_free_f, line_free_f, baseline, huber_delta,
                    robust=True, line_param="orth", variant="full"):
    """Plain version of K2: torch.func Jacobians, then ``index_add_``
    reductions.  ``full`` is ``_eval_system`` (schur_ba.py:93-176), ``cams``
    ``_eval_pose_system`` (:179-209), ``lines`` lines_gn_impl's
    ``eval_lines`` (:269-291), ``lm`` schur_cg.py's ``_eval_system_lm``
    (:118-166) on flat rows."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown fused_eval variant {variant!r}")
    C = cam_wt.shape[0]
    L = line_orth.shape[0]
    oc = obs_cam.long()
    ol = obs_line.long()
    cw, lo = cam_wt[oc], line_orth[ol]
    if variant in ("full", "lm"):
        r, Jc, Jl = lba_residual_jac_batch(cw, lo, obs, baseline,
                                           line_param=line_param)
    elif variant == "cams":
        r, Jc = lba_residual_jac_cam_batch(cw, lo, obs, baseline,
                                           line_param=line_param)
    else:
        r, Jl = lba_residual_jac_line_batch(cw, lo, obs, baseline,
                                            line_param=line_param)
    w_r, cost_i = robust_weights(r, huber_delta, robust)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    cost_o = torch.where(w_valid > 0, cost_i, zero)

    # NaN-proof masking: select-zero, never multiply (0 * NaN = NaN)
    valid = w_valid[:, None] > 0
    scale = w_r[:, None]
    r = torch.where(valid, r * scale, zero)
    if variant != "lines":
        Jc = torch.where(valid[..., None],
                         Jc * scale[..., None] * cam_free_f[oc][:, None, None],
                         zero)
        Hcc = _acc((C, 6, 6), oc, torch.einsum("oki,okj->oij", Jc, Jc))
        gc = _acc((C, 6), oc, torch.einsum("oki,ok->oi", Jc, r))
        if variant == "cams":
            return torch.sum(cost_o), Hcc, gc
    Jl = torch.where(valid[..., None],
                     Jl * scale[..., None] * line_free_f[ol][:, None, None],
                     zero)
    Hll = _acc((L, 4, 4), ol, torch.einsum("oki,okj->oij", Jl, Jl))
    gl = _acc((L, 4), ol, torch.einsum("oki,ok->oi", Jl, r))
    if variant == "lines":
        return Hll, gl, _acc((L,), ol, cost_o)
    Wb = torch.einsum("oki,okj->oij", Jc, Jl)
    if variant == "lm":
        return torch.sum(cost_o), Hcc, Hll, gc, gl, Wb
    W = _acc((C * L, 6, 4), oc * L + ol, Wb).reshape(C, L, 6, 4)
    return torch.sum(cost_o), Hcc, Hll, gc, gl, W


def _ticket_for(dev, stream):
    """The one-int counter of K2's last-block combine for a launch on
    ``stream``: zero before the launch, and zero again after it (the last
    block resets it).  Launches on one stream run in order, so each stream
    keeps its own counter, and two streams never share one.  A launch
    captured into a CUDA graph takes a counter of its own, a slot zeroed
    before the capture, so a replay never shares a counter with an eager
    launch or with another graph; past _GRAPH_TICKETS captured launches
    on a device, the graph zeroes the launch's counter itself before the
    kernel."""
    if torch.cuda.is_current_stream_capturing():
        pool = _graph_tickets.get(dev)
        if pool is not None and pool[1] < pool[0].numel():
            pool[1] += 1
            return pool[0][pool[1] - 1:pool[1]]
        return torch.zeros(1, dtype=torch.int32, device=dev)
    if dev not in _graph_tickets:
        _graph_tickets[dev] = [torch.zeros(_GRAPH_TICKETS, dtype=torch.int32,
                                           device=dev), 0]
    key = (dev, stream.cuda_stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def line_chart_jacobian(line_p, line_param):
    """Orth lines of (L, 4) ``line_p`` in ``line_param`` and M = d orth /
    d p (L, 4, 4): ``torch.func.jacfwd`` of geometry's orth encoder after
    the parameterization's decoder, one 4x4 per line."""
    def chart(p):
        out = geo.av_to_orth(geo.LINE_DECODERS[line_param](p))
        return out, out
    M, lo = torch.func.vmap(torch.func.jacfwd(chart, has_aux=True))(line_p)
    return lo, M


def fused_eval_chart(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                     cam_free_f, line_free_f, baseline, huber_delta,
                     robust=True, line_param="aid", variant="full", plan=None,
                     evaluate=None):
    """The evaluate of lines ``line_orth`` (L, 4) given in ``line_param``
    (the argument keeps ``fused_eval``'s name) through an orth evaluate
    ``evaluate`` (default: the orth K2 path of ``fused_eval``) by the chain
    rule: the residual depends on the line only, not on the scale of its
    Plücker vector, so r(p) = r_orth(orth(p)) and each line Jacobian is
    J_orth M.  Hll <- M^T Hll M, gl <- M^T gl, W <- W M (``lm``: Wb <- Wb M
    per row); cost and the camera blocks are unchanged.  ``cams`` fixes the
    lines and needs no M."""
    evaluate = evaluate or _fused_eval_orth
    line_p = line_orth
    if variant == "cams":
        lo = geo.av_to_orth(geo.LINE_DECODERS[line_param](line_p))
        return evaluate(cam_wt, lo.contiguous(), obs, obs_cam, obs_line,
                        w_valid, cam_free_f, line_free_f, baseline,
                        huber_delta, robust, "orth", variant, plan)
    lo, M = line_chart_jacobian(line_p, line_param)
    # a fixed line's blocks are zero: keep them zero where its chart is not
    # finite (0 * NaN); a free line's NaN propagates as in the direct twin
    M = torch.where((line_free_f[:, None, None] > 0) | torch.isfinite(M), M,
                    torch.zeros_like(M))
    out = evaluate(cam_wt, lo.contiguous(), obs, obs_cam, obs_line, w_valid,
                   cam_free_f, line_free_f, baseline, huber_delta, robust,
                   "orth", variant, plan)
    Mt = M.transpose(1, 2)
    if variant == "lines":
        Hll, gl, cost_l = out
        return Mt @ Hll @ M, (Mt @ gl[..., None])[..., 0], cost_l
    cost, Hcc, Hll, gc, gl, W = out
    Hll = Mt @ Hll @ M
    gl = (Mt @ gl[..., None])[..., 0]
    if variant == "lm":
        ol = torch.clamp(obs_line.long(), 0, line_p.shape[0] - 1)
        return cost, Hcc, Hll, gc, gl, W @ M[ol]
    return cost, Hcc, Hll, gc, gl, torch.einsum("clab,lbd->clad", W, M)


def fused_eval(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
               cam_free_f, line_free_f, baseline, huber_delta,
               robust=True, line_param="orth", variant="full", plan=None):
    """Fused BA evaluate: (C,6),(L,4),(O,8), int32 indices, (O,) validity
    weights, (C,)/(L,) free flags (``line_free_f`` may be None for
    ``cams``, ``cam_free_f`` for ``lines``) ->

    * ``full``: cost (), Hcc (C,6,6), Hll (L,4,4), gc (C,6), gl (L,4),
      W (C,L,6,4);
    * ``cams``: cost, Hcc, gc;
    * ``lines``: Hll, gl, per-line cost (L,);
    * ``lm``: cost, Hcc, Hll, gc, gl, Wb (O,6,4) per row, zero on the rows
      the plan drops.

    ``plan``: ``ba_plan(obs_cam, obs_line, w_valid, C, L, variant)``, built
    once per solve; without one the wrapper builds it.  CPU tensors take
    the twin; CUDA tensors launch K2 (Huber or plain least squares), one
    launch per call (``lm``: a row pass and a camera pass), deterministic:
    orth lines directly, aid and asd lines through ``fused_eval_chart``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown fused_eval variant {variant!r}")
    if _device_kind("fused_eval", cam_wt) == "cpu":
        return fused_eval_twin(cam_wt, line_orth, obs, obs_cam, obs_line,
                               w_valid, cam_free_f, line_free_f, baseline,
                               huber_delta, robust, line_param, variant)
    if line_param != "orth":
        return fused_eval_chart(cam_wt, line_orth, obs, obs_cam, obs_line,
                                w_valid, cam_free_f, line_free_f, baseline,
                                huber_delta, robust, line_param, variant,
                                plan)
    return _fused_eval_orth(cam_wt, line_orth, obs, obs_cam, obs_line,
                            w_valid, cam_free_f, line_free_f, baseline,
                            huber_delta, robust, line_param, variant, plan)


def _k2_parts(variant, C, L, O):
    """{part: (shape)} of K2's output buffer in its order (csrc/
    fused_eval.cu, above fused_eval_f32): the outputs and the partial
    costs."""
    cams = {"cost": (), "Hcc": (C, 6, 6), "gc": (C, 6)}
    lines = {"Hll": (L, 4, 4), "gl": (L, 4)}
    return {"full": {**cams, **lines, "W": (C, L, 6, 4), "partial": (C,)},
            "cams": {**cams, "partial": (C,)},
            "lines": {**lines, "cost_l": (L,)},
            "lm": {"W": (O, 6, 4), **cams, **lines,
                   "partial": (C,)}}[variant]


def fused_eval_numel(variant, C, L, O):
    """Elements of the buffer one K2 launch of ``variant`` writes into:
    its parts and the kernel's scratch past them (``lm``'s line
    partials)."""
    lib = load_library()["fused_eval"]
    return (sum(map(math.prod, _k2_parts(variant, C, L, O).values()))
            + lib.fused_eval_scratch(VARIANTS.index(variant), C, L, O))


def _fused_eval_orth(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                     cam_free_f, line_free_f, baseline, huber_delta, robust,
                     line_param, variant, plan):
    """K2's launch on CUDA tensors of orth lines."""
    if _device_kind("fused_eval", cam_wt) != "cuda" or line_param != "orth":
        raise ValueError("K2 takes CUDA tensors of orth lines")
    C, L, O = cam_wt.shape[0], line_orth.shape[0], obs.shape[0]
    if C < 1 or L < 1:
        raise ValueError("fused_eval: needs at least one camera and line")
    args = {"cam_wt": (cam_wt, (C, 6)), "line_orth": (line_orth, (L, 4)),
            "obs": (obs, (O, 8)), "obs_cam": (obs_cam, (O,)),
            "obs_line": (obs_line, (O,)), "w_valid": (w_valid, (O,))}
    if variant != "lines":
        args["cam_free_f"] = (cam_free_f, (C,))
    if variant != "cams":
        args["line_free_f"] = (line_free_f, (L,))
    for k, (t, shape) in args.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_eval: {k} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        want = torch.int32 if k in ("obs_cam", "obs_line") else cam_wt.dtype
        if t.dtype != want:
            raise TypeError(f"fused_eval: {k} is {t.dtype}, expected {want}")
    dev = cam_wt.device
    _check_cuda("fused_eval", dev, **{k: t for k, (t, _) in args.items()})
    if plan is None:
        plan = ba_plan(obs_cam, obs_line, w_valid, C, L, variant)
    rows, stride = (plan.pair, L) if variant == "full" else (plan.cam, 1)
    if ((variant != "lines" and rows is None)
            or (variant != "cams" and plan.line is None)):
        raise ValueError(f"fused_eval: the plan lacks what {variant!r} reads")
    if variant != "lines":
        _check_plan("fused_eval", rows, O, C * stride, dev)
    if variant != "cams":
        _check_plan("fused_eval", plan.line, O, L, dev)

    def ptrs(p):
        return (None, None) if p is None else (p.perm.data_ptr(),
                                               p.offsets.data_ptr())

    shapes = _k2_parts(variant, C, L, O)
    sizes = [math.prod(shape) for shape in shapes.values()]
    buf = torch.empty(fused_eval_numel(variant, C, L, O),
                      dtype=cam_wt.dtype, device=dev)
    huber = float(huber_delta) if robust else -1.0
    lib = load_library()["fused_eval"]
    fn = getattr(lib, f"fused_eval_{_suffix(cam_wt.dtype)}")
    cfree = None if variant == "lines" else cam_free_f.data_ptr()
    lfree = None if variant == "cams" else line_free_f.data_ptr()
    stream = torch.cuda.current_stream(dev)
    ticket = _ticket_for(dev, stream)
    err = fn(VARIANTS.index(variant), cam_wt.data_ptr(), line_orth.data_ptr(),
             obs.data_ptr(), obs_cam.data_ptr(), obs_line.data_ptr(),
             w_valid.data_ptr(), cfree, lfree, float(baseline), huber, C, L,
             O, *ptrs(rows), stride, *ptrs(plan.line), buf.data_ptr(),
             ticket.data_ptr(), ctypes.c_void_p(stream.cuda_stream))
    _raise_on("fused_eval", err)
    _count(f"fused_eval/{variant}", (C, L, O))
    parts = {name: part.view(shape) for (name, shape), part in zip(
        shapes.items(), torch.split(buf[:sum(sizes)], sizes))}
    names = {"lines": ("Hll", "gl", "cost_l"), "cams": ("cost", "Hcc", "gc")
             }.get(variant, ("cost", "Hcc", "Hll", "gc", "gl", "W"))
    return tuple(parts[name] for name in names)


# ---------------------------------------------------------------------------
# K3: schur_matvec (line pass, camera pass) and K4: schur_jacobi
# ---------------------------------------------------------------------------

def schur_matvec_line_twin(Wb, obs_cam, x, cam_free_f, Binv):
    """Plain version of K3's line pass (the einsums of slslam_tpu/ops/
    schur_cg.py:202-205 and of the back-substitution, :270-271): Wb (L,kL,6,4), obs_cam (L,kL), x (C,6), cam_free_f
    (C,), Binv (L,4,4) -> w = Binv z (L,4) and z (L,4), z_l the sum over
    line l's rows of Wb^T (x m)[cam]."""
    xm = x * cam_free_f[:, None]
    y = torch.einsum("lkab,lka->lkb", Wb, xm[obs_cam.long()])  # (L,kL,4)
    z = torch.sum(y, dim=1)                                     # (L,4)
    w = torch.einsum("lab,lb->la", Binv, z)                     # (L,4)
    return w, z


def schur_matvec_cam_twin(Wb, w, cam_free_f, cam_key, Hcc_d=None, x=None,
                          gc=None):
    """Plain version of K3's camera pass (schur_cg.py:206-208 and 214
    without the priors, and the right-hand side, :217-219):
    v = the per-camera sums (``segment_sum_twin`` over ``cam_key``, the
    camera plan's key) of Wb w[line] (L,kL,6); then (Hcc_d x_m - v) m +
    x (1 - m), or with ``gc`` the right-hand side (-gc + v) m."""
    L, kL = Wb.shape[:2]
    C = cam_free_f.shape[0]
    m = cam_free_f[:, None]
    u = torch.einsum("lkab,lb->lka", Wb, w)                     # (L,kL,6)
    v = segment_sum_twin(u.reshape(L * kL, 6).contiguous(), cam_key, C)
    if gc is not None:
        return (-gc + v) * m
    Sx = torch.einsum("cab,cb->ca", Hcc_d, x * m) - v
    return Sx * m + x * (1.0 - m)


def schur_jacobi_twin(Wb, Binv, Hcc_d, cam_free_f, cam_key):
    """Plain version of K4 (schur_cg.py:223-227): Hcc_d minus the
    per-camera sums of Wb Binv Wb^T (the (L,kL,6,6) T), the identity for
    a fixed camera."""
    L, kL = Wb.shape[:2]
    C = Hcc_d.shape[0]
    T = torch.einsum("lkab,lbc,lkdc->lkad", Wb, Binv, Wb)      # (L,kL,6,6)
    P = Hcc_d - segment_sum_twin(T.reshape(L * kL, 36).contiguous(),
                                 cam_key, C).reshape(C, 6, 6)
    eye6 = torch.eye(6, dtype=Hcc_d.dtype, device=Hcc_d.device)
    return torch.where(cam_free_f[:, None, None] > 0, P, eye6)


def _check_schur(name, Wb, plan, P, **blocks):
    """Raises unless a K3 / K4 launch can take its arguments: Wb (L, kL,
    6, 4) contiguous and 16-byte aligned (the kernels' vector loads), each
    of ``blocks`` ({name: (tensor, shape)}) of its shape, of Wb's dtype
    (int32 ``obs_cam``) and contiguous on Wb's device, and ``plan`` a plan
    of the L kL rows into P segments."""
    if Wb.dim() != 4 or tuple(Wb.shape[2:]) != (6, 4):
        raise ValueError(f"{name}: Wb has shape {tuple(Wb.shape)}, "
                         "expected (L, kL, 6, 4)")
    _suffix(Wb.dtype)
    dev = Wb.device
    _check_cuda(name, dev, Wb=Wb, **{k: t for k, (t, _) in blocks.items()})
    if Wb.data_ptr() % 16:
        raise ValueError(f"{name}: Wb must be 16-byte aligned")
    for k, (t, shape) in blocks.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        want = torch.int32 if k == "obs_cam" else Wb.dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {k} is {t.dtype}, expected {want}")
    if plan is None:
        raise ValueError(f"{name}: needs the solve's segment plan")
    L, kL = Wb.shape[:2]
    _check_plan(name, plan, L * kL, P, dev)
    if L < 1 or P < 1:
        raise ValueError(f"{name}: needs at least one line and segment")


def schur_matvec_line(Wb, obs_cam, x, cam_free_f, Binv, line_plan):
    """K3's line pass: (w, z), each (L, 4): z_l = sum over line l's rows
    of Wb^T (x m)[obs_cam], w_l = Binv_l z_l.  ``line_plan``: the solve's
    line plan (``ba_plan(..., "lm").line``); Wb must be zero on the rows
    it drops.  CPU tensors take the twin; CUDA tensors launch K3's line
    pass (int32 ``obs_cam``)."""
    if _device_kind("schur_matvec_line", Wb) == "cpu":
        return schur_matvec_line_twin(Wb, obs_cam, x, cam_free_f, Binv)
    L, kL = Wb.shape[:2]
    C = cam_free_f.shape[0]
    _check_schur("schur_matvec_line", Wb, line_plan, L,
                 obs_cam=(obs_cam, (L, kL)), x=(x, (C, 6)),
                 cam_free_f=(cam_free_f, (C,)), Binv=(Binv, (L, 4, 4)))
    w = torch.empty((L, 4), dtype=Wb.dtype, device=Wb.device)
    z = torch.empty_like(w)
    fn = getattr(load_library()["schur_cg"],
                 f"schur_line_{_suffix(Wb.dtype)}")
    err = fn(Wb.data_ptr(), obs_cam.data_ptr(), x.data_ptr(),
             cam_free_f.data_ptr(), Binv.data_ptr(),
             line_plan.perm.data_ptr(), line_plan.offsets.data_ptr(), C, L,
             L * kL, w.data_ptr(), z.data_ptr(), _stream(Wb.device))
    _raise_on("schur_matvec_line", err)
    _count("schur_matvec/line", (C, L, L * kL))
    return w, z


def schur_matvec_cam(Wb, w, cam_free_f, cam_plan, Hcc_d=None, x=None,
                     gc=None):
    """K3's camera pass (C, 6): v_c = sum over camera c's rows of Wb
    w[line]; (Hcc_d x_m - v) m + x (1 - m) (the matvec, given Hcc_d and
    x), or with ``gc`` the right-hand side (-gc + v) m.  ``cam_plan``: the
    solve's camera plan.  CPU tensors take the twin; CUDA tensors launch
    K3's camera pass."""
    rhs = gc is not None
    if rhs == (Hcc_d is not None or x is not None):
        raise ValueError("schur_matvec_cam: pass Hcc_d and x, or gc")
    if _device_kind("schur_matvec_cam", Wb) == "cpu":
        return schur_matvec_cam_twin(Wb, w, cam_free_f, cam_plan.key,
                                     Hcc_d, x, gc)
    L, kL = Wb.shape[:2]
    C = cam_free_f.shape[0]
    blocks = {"w": (w, (L, 4)), "cam_free_f": (cam_free_f, (C,))}
    if rhs:
        blocks["gc"] = (gc, (C, 6))
    else:
        blocks.update(Hcc_d=(Hcc_d, (C, 6, 6)), x=(x, (C, 6)))
    _check_schur("schur_matvec_cam", Wb, cam_plan, C, **blocks)
    out = torch.empty((C, 6), dtype=Wb.dtype, device=Wb.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = getattr(load_library()["schur_cg"], f"schur_cam_{_suffix(Wb.dtype)}")
    err = fn(int(rhs), Wb.data_ptr(), w.data_ptr(), cam_plan.perm.data_ptr(),
             cam_plan.offsets.data_ptr(), cam_free_f.data_ptr(), ptr(Hcc_d),
             ptr(x), ptr(gc), C, kL, L * kL, out.data_ptr(),
             _stream(Wb.device))
    _raise_on("schur_matvec_cam", err)
    _count("schur_matvec/cam", (C, L, L * kL))
    return out


def schur_jacobi(Wb, Binv, Hcc_d, cam_free_f, cam_plan):
    """K4: the SCHUR_JACOBI blocks (C, 6, 6), Hcc_d minus the sum over each
    camera's rows of Wb Binv[line] Wb^T, the identity for a fixed camera.
    CPU tensors take the twin; CUDA tensors launch K4."""
    if _device_kind("schur_jacobi", Wb) == "cpu":
        return schur_jacobi_twin(Wb, Binv, Hcc_d, cam_free_f, cam_plan.key)
    L, kL = Wb.shape[:2]
    C = cam_free_f.shape[0]
    _check_schur("schur_jacobi", Wb, cam_plan, C, Binv=(Binv, (L, 4, 4)),
                 Hcc_d=(Hcc_d, (C, 6, 6)), cam_free_f=(cam_free_f, (C,)))
    P = torch.empty((C, 6, 6), dtype=Wb.dtype, device=Wb.device)
    fn = getattr(load_library()["schur_cg"],
                 f"schur_jacobi_{_suffix(Wb.dtype)}")
    err = fn(Wb.data_ptr(), Binv.data_ptr(), cam_plan.perm.data_ptr(),
             cam_plan.offsets.data_ptr(), cam_free_f.data_ptr(),
             Hcc_d.data_ptr(), C, kL, L * kL, P.data_ptr(),
             _stream(Wb.device))
    _raise_on("schur_jacobi", err)
    _count("schur_jacobi", (C, L, L * kL))
    return P


def schur_matvec_twin(x, Wb, obs_cam, cam_free_f, Binv, Hcc_d, cam_key,
                      Hoff=None, gkey=None):
    """Plain version of the PCG's matvec S x (slslam_tpu/ops/schur_cg.py:
    198-214): K3's line and camera passes' twins, then the priors'
    coupling: rows Hoff_e x_m[ej] keyed by camera ei and Hoff_e^T x_m[ei]
    keyed by ej (``gkey`` = cat(ei, ej), the edges' node rows), summed per
    camera (``segment_sum_twin``) and masked."""
    w, _ = schur_matvec_line_twin(Wb, obs_cam, x, cam_free_f, Binv)
    Sx = schur_matvec_cam_twin(Wb, w, cam_free_f, cam_key, Hcc_d=Hcc_d, x=x)
    if Hoff is None:
        return Sx
    E = Hoff.shape[0]
    ei, ej = gkey[:E].long(), gkey[E:].long()
    m = cam_free_f[:, None]
    xm = x * m
    rows = torch.cat([torch.einsum("eab,eb->ea", Hoff, xm[ej]),
                      torch.einsum("eba,eb->ea", Hoff, xm[ei])])
    return Sx + segment_sum_twin(rows.contiguous(), gkey,
                                 Hcc_d.shape[0]) * m


def schur_pcg_twin(rhs, Minv, Wb, obs_cam, cam_free_f, Binv, Hcc_d, cam_key,
                   cg_iters, eta, Hoff=None, gkey=None):
    """Plain version of K3's PCG (slslam_tpu/ops/schur_cg.py:233-266):
    Ceres's eta forcing, x = 0, r = rhs, z = Minv r, p = z, then while it
    < cg_iters and r.r > eta^2 rhs.rhs: Ap = S p (``schur_matvec_twin``),
    alpha = rz / p.Ap (0 unless p.Ap > 0), x += alpha p, r -= alpha Ap, z
    = Minv r, beta = r.z / rz (1 where rz = 0), p = z + beta p.  The loop
    reads its condition from the tensors' device each iteration.  Returns
    x (C, 6) and the iterations run, a 0-d int32 tensor."""
    dtype, dev = rhs.dtype, rhs.device

    def matvec(x):
        return schur_matvec_twin(x, Wb, obs_cam, cam_free_f, Binv, Hcc_d,
                                 cam_key, Hoff, gkey)

    def precond(r):
        return torch.einsum("cab,cb->ca", Minv, r)

    tol2 = (eta * eta) * torch.sum(rhs * rhs)
    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    it = 0
    while it < cg_iters and bool(torch.sum(r * r) > tol2):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, one), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(rz != 0, rz, one)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, torch.tensor(it, dtype=torch.int32, device=dev)


def schur_pcg_blocks(dtype, C, L, O, device):
    """The grid of K3's PCG at (C, L, O) on the card ``device`` (a tensor's
    device): the blocks it keeps resident, capped by the widest phase's
    work.  Raises where the card takes no cooperative launch of the
    kernel."""
    key = (device, dtype, C, L, O)
    if key not in _pcg_blocks:
        with torch.cuda.device(device):
            n = load_library()["schur_cg"].schur_pcg_blocks(
                int(dtype == torch.float64), C, L, O)
        if n <= 0:
            raise RuntimeError(f"schur_pcg: the card cannot co-schedule a "
                               f"grid of the kernel (error {-n})")
        _pcg_blocks[key] = n
    return _pcg_blocks[key]


def schur_pcg(rhs, Minv, Wb, obs_cam, cam_free_f, Binv, Hcc_d, cam_plan,
              line_plan, cg_iters, eta, Hoff=None, prior_plan=None):
    """The PCG of one damped step on S x = rhs (K3): x (C, 6) and the
    iterations run (a 0-d int32 tensor on rhs's device).  ``Minv`` (C, 6,
    6): the inverted SCHUR_JACOBI blocks; ``cam_plan`` and ``line_plan``:
    the solve's plans; ``Hoff`` (E, 6, 6) and ``prior_plan`` (the edges'
    ``pose_graph.BlockPlan``: ``gkey`` = cat(ei, ej) and its node plan
    ``gplan``): the pose priors' coupling, or None.

    CPU tensors take the twin (the Python loop); CUDA tensors launch K3's
    PCG once, a cooperative grid of ``schur_pcg_blocks`` blocks (a grid
    the card cannot keep resident raises), and the host reads nothing."""
    if (Hoff is None) != (prior_plan is None):
        raise ValueError("schur_pcg: pass Hoff and prior_plan together")
    gkey = None if prior_plan is None else prior_plan.gkey
    if _device_kind("schur_pcg", Wb) == "cpu":
        return schur_pcg_twin(rhs, Minv, Wb, obs_cam, cam_free_f, Binv,
                              Hcc_d, cam_plan.key, cg_iters, eta, Hoff, gkey)
    L, kL = Wb.shape[:2]
    C = cam_free_f.shape[0]
    dev = Wb.device
    _check_schur("schur_pcg", Wb, line_plan, L, obs_cam=(obs_cam, (L, kL)),
                 cam_free_f=(cam_free_f, (C,)), Binv=(Binv, (L, 4, 4)),
                 Hcc_d=(Hcc_d, (C, 6, 6)), rhs=(rhs, (C, 6)),
                 Minv=(Minv, (C, 6, 6)))
    if cam_plan is None:
        raise ValueError("schur_pcg: needs the solve's camera plan")
    _check_plan("schur_pcg", cam_plan, L * kL, C, dev)
    E = 0
    prior_ptrs = [None] * 4
    if Hoff is not None:
        E = Hoff.shape[0]
        gplan = prior_plan.gplan
        if tuple(Hoff.shape) != (E, 6, 6) or Hoff.dtype != Wb.dtype:
            raise ValueError(f"schur_pcg: Hoff is {tuple(Hoff.shape)} "
                             f"{Hoff.dtype}, expected ({E}, 6, 6) {Wb.dtype}")
        if tuple(gkey.shape) != (2 * E,) or gkey.dtype != torch.int32:
            raise ValueError("schur_pcg: gkey must be (2 E,) int32")
        _check_cuda("schur_pcg", dev, Hoff=Hoff, gkey=gkey)
        _check_plan("schur_pcg", gplan, 2 * E, C, dev)
        prior_ptrs = [Hoff.data_ptr(), gkey.data_ptr(),
                      gplan.perm.data_ptr(), gplan.offsets.data_ptr()]
    blocks = schur_pcg_blocks(Wb.dtype, C, L, L * kL, dev)
    scratch = torch.empty(30 * C + 4 * L + 3 * blocks, dtype=Wb.dtype,
                          device=dev)
    x = torch.empty((C, 6), dtype=Wb.dtype, device=dev)
    it = torch.empty((), dtype=torch.int32, device=dev)
    fn = getattr(load_library()["schur_cg"], f"schur_pcg_{_suffix(Wb.dtype)}")
    err = fn(Wb.data_ptr(), obs_cam.data_ptr(), cam_free_f.data_ptr(),
             Binv.data_ptr(), Hcc_d.data_ptr(), line_plan.perm.data_ptr(),
             line_plan.offsets.data_ptr(), cam_plan.perm.data_ptr(),
             cam_plan.offsets.data_ptr(), *prior_ptrs, C, L, kL, E,
             rhs.data_ptr(), Minv.data_ptr(), float(eta), int(cg_iters),
             int(blocks), scratch.data_ptr(), x.data_ptr(), it.data_ptr(),
             _stream(dev))
    _raise_on("schur_pcg", err)
    _count("schur_pcg", (C, L, L * kL))
    return x, it
