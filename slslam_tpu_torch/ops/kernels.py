"""The port's two hand-written CUDA kernels, their wrappers and plain twins.

K1 ``segment_sum`` — per-segment row sums (O, D) x idx (O,) -> (P, D),
rows with idx outside [0, P) dropped.  Replaces ``segment_sum_pallas``
(slslam_tpu/ops/pallas_kernels.py:49-81).  Its source also holds the
segment plan, ``segment_plan``: the rows grouped stably by index (a
permutation plus offsets), which a BA solve builds once and hands to K1 and
K2 in every LM iteration.  On the main path K1 sums lines-GN's trial cost.
Source: ``csrc/segment_sum.cu``.

K2 ``fused_eval`` — the BA evaluate in one launch: gather, residual,
forward-mode Jacobian columns, Huber weights, NaN-proof masks, and the
reductions, in three variants (``VARIANTS``):

* ``full``: cost, Hcc, Hll, gc, gl and the cam-line coupling W (the window
  BA, ``schur_ba._eval_system``);
* ``cams``: cost, Hcc, gc — ``full`` with every line fixed (the pose-only
  VO polish, ``schur_ba._eval_pose_system``);
* ``lines``: Hll, gl and the per-line cost — ``full`` with every camera
  fixed (lines-GN's evaluate).

Replaces ``fused_eval_pallas`` with its two kernels
(pallas_kernels.py:278-428).  Source: ``csrc/fused_eval.cu``.

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
import os
import shutil
import subprocess
import time
from typing import Dict, NamedTuple, Optional

import torch

from .residuals import (lba_residual_jac_batch, lba_residual_jac_cam_batch,
                        lba_residual_jac_line_batch, robust_weights)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("segment_sum.cu", "fused_eval.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
VARIANTS = ("full", "cams", "lines")

# launches of each kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {
    "segment_plan": 0, "segment_sum": 0,
    **{f"fused_eval/{v}": 0 for v in VARIANTS}}
# wall seconds of the nvcc builds in this process (None until built)
build_seconds = None
# source -> nvcc's -Xptxas -v report of its build
ptxas_log: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_tickets: Dict[tuple, torch.Tensor] = {}  # (device, stream) -> counter
# device -> [zeroed counters for captured launches, how many are taken]
_graph_tickets: Dict[torch.device, list] = {}
_GRAPH_TICKETS = 4096


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


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
        fn.argtypes = [i, p, p, p, p, p, p, p, p, d, d, i, i, p, p, i, p, p,
                       p, p, p]
        fn.restype = i
    k1.seg_plan.argtypes = [p, i, i, p, p, p]
    k1.seg_plan.restype = i


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


def segment_plan(key, num_segments):
    """The plan of an (O,) int32 key over P segments.  CPU tensors take the
    twin; CUDA tensors launch K1's plan kernel (one block per segment,
    integer-only, deterministic)."""
    if _device_kind("segment_plan", key) == "cpu":
        return segment_plan_twin(key, num_segments)
    if key.dim() != 1 or key.dtype != torch.int32:
        raise TypeError("segment_plan: key must be a 1-D int32 tensor")
    _check_cuda("segment_plan", key.device, key=key)
    O, P = key.shape[0], num_segments
    perm = torch.empty(O, dtype=torch.int32, device=key.device)
    offsets = torch.empty(P + 1, dtype=torch.int32, device=key.device)
    lib = load_library()["segment_sum"]
    err = lib.seg_plan(key.data_ptr(), O, P, perm.data_ptr(),
                       offsets.data_ptr(), _stream(key.device))
    _raise_on("segment_plan", err)
    launch_counts["segment_plan"] += 1
    return SegmentPlan(key, perm, offsets)


class BAPlan(NamedTuple):
    """Segment plans of one BA solve's rows (valid rows only): by camera
    (``cams``), by line (``full``, ``lines``) and by (cam, line) pair
    (``full``).  The rows never change inside a solve."""

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
        cam=plan(obs_cam, C) if variant == "cams" else None,
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
    launch_counts["segment_sum"] += 1
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
    ``eval_lines`` (:269-291)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown fused_eval variant {variant!r}")
    C = cam_wt.shape[0]
    L = line_orth.shape[0]
    oc = obs_cam.long()
    ol = obs_line.long()
    cw, lo = cam_wt[oc], line_orth[ol]
    if variant == "full":
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


def fused_eval(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
               cam_free_f, line_free_f, baseline, huber_delta,
               robust=True, line_param="orth", variant="full", plan=None):
    """Fused BA evaluate: (C,6),(L,4),(O,8), int32 indices, (O,) validity
    weights, (C,)/(L,) free flags (``line_free_f`` may be None for
    ``cams``, ``cam_free_f`` for ``lines``) ->

    * ``full``: cost (), Hcc (C,6,6), Hll (L,4,4), gc (C,6), gl (L,4),
      W (C,L,6,4);
    * ``cams``: cost, Hcc, gc;
    * ``lines``: Hll, gl, per-line cost (L,).

    ``plan``: ``ba_plan(obs_cam, obs_line, w_valid, C, L, variant)``, built
    once per solve; without one the wrapper builds it.  CPU tensors take
    the twin; CUDA tensors launch K2 (orth lines, Huber or plain least
    squares), one launch per call, deterministic."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown fused_eval variant {variant!r}")
    if _device_kind("fused_eval", cam_wt) == "cpu":
        return fused_eval_twin(cam_wt, line_orth, obs, obs_cam, obs_line,
                               w_valid, cam_free_f, line_free_f, baseline,
                               huber_delta, robust, line_param, variant)
    if line_param != "orth":
        raise NotImplementedError(
            f"line_param={line_param!r} on the CUDA path: the kernel decodes "
            "orth lines only (ROADMAP Queue 1, P4 open items: aid/asd on the "
            "kernel path)")
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

    cams_part = (1, C * 36, C * 6)
    lines_part = (L * 16, L * 4)
    sizes = {"full": cams_part + lines_part + (C * L * 24, C),
             "cams": cams_part + (C,),
             "lines": lines_part + (L,)}[variant]
    buf = torch.empty(sum(sizes), dtype=cam_wt.dtype, device=dev)
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
             *ptrs(rows), stride, *ptrs(plan.line), buf.data_ptr(),
             ticket.data_ptr(), ctypes.c_void_p(stream.cuda_stream))
    _raise_on("fused_eval", err)
    launch_counts[f"fused_eval/{variant}"] += 1
    parts = torch.split(buf, sizes)
    if variant == "lines":
        Hll, gl, cost_l = parts
        return Hll.view(L, 4, 4), gl.view(L, 4), cost_l
    cost, Hcc, gc = parts[0][0], parts[1].view(C, 6, 6), parts[2].view(C, 6)
    if variant == "cams":
        return cost, Hcc, gc
    Hll, gl, W = parts[3].view(L, 4, 4), parts[4].view(L, 4), parts[5]
    return cost, Hcc, Hll, gc, gl, W.view(C, L, 6, 4)
