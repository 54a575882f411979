"""The port's two hand-written CUDA kernels, their wrappers and plain twins.

K1 ``segment_sum`` — per-segment row sums (O, D) x idx (O,) -> (P, D),
rows with idx >= P dropped.  Replaces ``segment_sum_pallas``
(slslam_tpu/ops/pallas_kernels.py:49-81).  On CUDA it carries every index
reduction of the BA path outside K2 (pose-only Hcc|gc, lines-GN Hll|gl and
per-line cost).  Source: ``csrc/segment_sum.cu``.

K2 ``fused_eval`` — the whole window-BA evaluate in one kernel: gather,
residual, 10 forward-mode Jacobian columns, Huber weights, NaN-proof masks,
and the reductions into cost, Hcc, Hll, gc, gl and the cam-line coupling W.
Replaces ``fused_eval_pallas`` with its two kernels
(pallas_kernels.py:278-428).  Source: ``csrc/fused_eval.cu``.

Each wrapper takes its plain-PyTorch twin for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  The kernels are built with
``nvcc`` for ``sm_90a`` from ``slslam_tpu_torch/csrc`` at first use into
``build/kernels/`` beside the package (git-ignored) and bound with ctypes.
``launch_counts`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

import torch

from .residuals import lba_residual_jac_batch, robust_weights

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("segment_sum.cu", "fused_eval.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {"segment_sum": 0, "fused_eval": 0}
# wall seconds of the nvcc build in this process (None until built)
build_seconds = None

_lib = None


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


def load_library():
    """Build (once per source content) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    srcs = [os.path.join(CSRC_DIR, s) for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libslslam_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    if not os.path.isfile(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for suf in ("f32", "f64"):
        fn = getattr(lib, f"seg_sum_{suf}")
        fn.argtypes = [p, p, p, i, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"fused_eval_{suf}")
        fn.argtypes = [p, p, p, p, p, p, p, p, d, d, i, i, i, p, p, p]
        fn.restype = i
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


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


# ---------------------------------------------------------------------------
# K1: segment_sum
# ---------------------------------------------------------------------------

def segment_sum_twin(values, idx, num_segments):
    """Plain version of K1: ``index_add_`` of the rows with idx < P."""
    keep = idx < num_segments
    out = torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, idx[keep].long(), values[keep])


def segment_sum(values, idx, num_segments):
    """Per-segment sums (O, D), (O,) int32 -> (P, D); idx >= P dropped.

    CPU tensors take the twin; CUDA tensors launch K1 (deterministic: one
    block per segment and 32-column tile, fixed-order partials)."""
    if values.device.type == "cpu":
        return segment_sum_twin(values, idx, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {values.device}")
    if values.dim() != 2 or idx.shape != values.shape[:1]:
        raise ValueError(f"segment_sum: shapes {tuple(values.shape)}, "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError("segment_sum: idx must be int32")
    _check_cuda("segment_sum", values.device, values=values, idx=idx)
    O, D = values.shape
    out = torch.empty((num_segments, D), dtype=values.dtype,
                      device=values.device)
    if num_segments == 0 or D == 0:
        return out
    lib = load_library()
    fn = getattr(lib, f"seg_sum_{_suffix(values.dtype)}")
    err = fn(values.data_ptr(), idx.data_ptr(), out.data_ptr(), O, D,
             num_segments, _stream(values.device))
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

def fused_eval_twin(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                    cam_free_f, line_free_f, baseline, huber_delta,
                    robust=True, line_param="orth"):
    """Plain version of K2 = ``_eval_system`` (schur_ba.py:93-176):
    torch.func Jacobians, then ``index_add_`` reductions."""
    C = cam_wt.shape[0]
    L = line_orth.shape[0]
    oc = obs_cam.long()
    ol = obs_line.long()
    r, Jc, Jl = lba_residual_jac_batch(cam_wt[oc], line_orth[ol], obs,
                                       baseline, line_param=line_param)
    w_r, cost_i = robust_weights(r, huber_delta, robust)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    cost = torch.sum(torch.where(w_valid > 0, cost_i, zero))

    # NaN-proof masking: select-zero, never multiply (0 * NaN = NaN)
    valid = w_valid[:, None] > 0
    scale = w_r[:, None]
    r = torch.where(valid, r * scale, zero)
    Jc = torch.where(valid[..., None],
                     Jc * scale[..., None] * cam_free_f[oc][:, None, None],
                     zero)
    Jl = torch.where(valid[..., None],
                     Jl * scale[..., None] * line_free_f[ol][:, None, None],
                     zero)
    A = torch.einsum("oki,okj->oij", Jc, Jc)
    B = torch.einsum("oki,okj->oij", Jl, Jl)
    Wb = torch.einsum("oki,okj->oij", Jc, Jl)
    gc_o = torch.einsum("oki,ok->oi", Jc, r)
    gl_o = torch.einsum("oki,ok->oi", Jl, r)

    def acc(shape, index, vals):
        return torch.zeros(shape, dtype=r.dtype,
                           device=r.device).index_add_(0, index, vals)

    Hcc = acc((C, 6, 6), oc, A)
    Hll = acc((L, 4, 4), ol, B)
    gc = acc((C, 6), oc, gc_o)
    gl = acc((L, 4), ol, gl_o)
    W = acc((C * L, 6, 4), oc * L + ol, Wb).reshape(C, L, 6, 4)
    return cost, Hcc, Hll, gc, gl, W


def fused_eval(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
               cam_free_f, line_free_f, baseline, huber_delta,
               robust=True, line_param="orth"):
    """Fused BA evaluate: (C,6),(L,4),(O,8), int32 indices, (O,) validity
    weights, (C,)/(L,) free flags -> cost (), Hcc (C,6,6), Hll (L,4,4),
    gc (C,6), gl (L,4), W (C,L,6,4).  Semantics of ``_eval_system``.

    CPU tensors take the twin; CUDA tensors launch K2 (orth lines, Huber or
    plain least squares).  Deterministic: per-observation blocks go to a
    scratch buffer, then each segment sums its rows in observation order."""
    if cam_wt.device.type == "cpu":
        return fused_eval_twin(cam_wt, line_orth, obs, obs_cam, obs_line,
                               w_valid, cam_free_f, line_free_f, baseline,
                               huber_delta, robust, line_param)
    if cam_wt.device.type != "cuda":
        raise ValueError(f"fused_eval: unsupported device {cam_wt.device}")
    if line_param != "orth":
        raise NotImplementedError(
            f"line_param={line_param!r} on the CUDA path: the kernel decodes "
            "orth lines only (ROADMAP Queue 1, P4 open items: aid/asd on the "
            "kernel path)")
    C, L, O = cam_wt.shape[0], line_orth.shape[0], obs.shape[0]
    expect = {"cam_wt": (C, 6), "line_orth": (L, 4), "obs": (O, 8),
              "obs_cam": (O,), "obs_line": (O,), "w_valid": (O,),
              "cam_free_f": (C,), "line_free_f": (L,)}
    args = {"cam_wt": cam_wt, "line_orth": line_orth, "obs": obs,
            "obs_cam": obs_cam, "obs_line": obs_line, "w_valid": w_valid,
            "cam_free_f": cam_free_f, "line_free_f": line_free_f}
    for k, shape in expect.items():
        if tuple(args[k].shape) != shape:
            raise ValueError(f"fused_eval: {k} has shape "
                             f"{tuple(args[k].shape)}, expected {shape}")
        want = torch.int32 if k in ("obs_cam", "obs_line") else cam_wt.dtype
        if args[k].dtype != want:
            raise TypeError(f"fused_eval: {k} is {args[k].dtype}, "
                            f"expected {want}")
    _check_cuda("fused_eval", cam_wt.device, **args)
    sizes = (1, C * 36, L * 16, C * 6, L * 4, C * L * 24)
    buf = torch.zeros(sum(sizes), dtype=cam_wt.dtype, device=cam_wt.device)
    cost, Hcc, Hll, gc, gl, W = torch.split(buf, sizes)
    # per observation: cost | Hcc|gc (42) | Hll|gl (20) | W (24)
    scratch = torch.empty(87 * O, dtype=cam_wt.dtype, device=cam_wt.device)
    huber = float(huber_delta) if robust else -1.0
    lib = load_library()
    fn = getattr(lib, f"fused_eval_{_suffix(cam_wt.dtype)}")
    err = fn(cam_wt.data_ptr(), line_orth.data_ptr(), obs.data_ptr(),
             obs_cam.data_ptr(), obs_line.data_ptr(), w_valid.data_ptr(),
             cam_free_f.data_ptr(), line_free_f.data_ptr(), float(baseline),
             huber, C, L, O, buf.data_ptr(), scratch.data_ptr(),
             _stream(cam_wt.device))
    _raise_on("fused_eval", err)
    launch_counts["fused_eval"] += 1
    return (cost[0], Hcc.view(C, 6, 6), Hll.view(L, 4, 4), gc.view(C, 6),
            gl.view(L, 4), W.view(C, L, 6, 4))
