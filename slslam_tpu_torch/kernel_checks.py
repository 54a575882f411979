"""Kernel-vs-twin check cases at the shapes of the slice's main path.

Shared by ``chip_smoke.py`` (phases 1 and 2) and the opt-in GPU tests
(``tests/test_torch_kernels.py``, ``SLSLAM_GPU_TESTS=1``).  Inputs are made
from a numpy seed.

Tolerances are on the normalized error max|kernel - twin| / max(1,
max|twin|), per output:

* K1 (deterministic, fixed-order sums): 1e-12 in float64, 1e-5 in float32;
* K2 (deterministic, fixed-order sums; dual-number vs torch.func
  derivatives): 1e-10 in float64, 1e-5 in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import kernels

# (O, D, P) of K1's calls on the main path: lines-GN Hll|gl|cost over the
# window (2W x Om rows, Lp lines) and the pose-only Hcc|gc of the VO polish
# (2 x Lp rows, 4 cameras)
K1_SHAPES = ((1600, 21, 81), (162, 42, 4))
# (C, L, O) of K2's call in the window BA
K2_SHAPE = (20, 81, 1600)
K1_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
K2_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
K2_OUTPUTS = ("cost", "Hcc", "Hll", "gc", "gl", "W")


def errors(a, b):
    """(normalized error, max abs error) of ``a`` against ``b``."""
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
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
    rows, a fixed camera, a fixed line and repeated (cam, line) pairs."""
    rng = np.random.default_rng(seed)
    cam = rng.standard_normal((C, 6)) * 0.1
    cam[1, :3] = 0.0                          # rodrigues' Taylor branch
    line = rng.standard_normal((L, 4)) * 0.2
    line[:, 3] = 0.3 + 0.5 * rng.random(L)
    obs = rng.standard_normal((O, 8)) * 0.2
    oc = np.repeat(np.arange(C), O // C)[:O]  # camera-major, as the engine
    oc = np.concatenate([oc, np.zeros(O - oc.size, int)])
    ol = rng.integers(0, L, O)
    ol[1::2] = ol[0::2]                       # repeated pairs
    valid = rng.random(O) < 0.8
    obs[~valid] = 0.0
    cfree = np.ones(C)
    cfree[0] = 0.0
    lfree = np.ones(L)
    lfree[5] = 0.0

    def f(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return dict(cam_wt=f(cam), line_orth=f(line), obs=f(obs), obs_cam=i(oc),
                obs_line=i(ol), w_valid=f(valid.astype(np.float64)),
                cam_free_f=f(cfree), line_free_f=f(lfree), baseline=0.12,
                huber_delta=1.0 / 406.05)


def check_k1(dtype, device):
    """K1 on ``device`` against the twin on CPU copies, at K1_SHAPES.
    Returns [(shape, normalized error, max abs error)]; raises if an
    error exceeds K1_TOL."""
    out = []
    for (O, D, P) in K1_SHAPES:
        vals, idx = k1_case(O, D, P, dtype, device)
        got = kernels.segment_sum(vals, idx, P)
        ref = kernels.segment_sum_twin(vals.cpu(), idx.cpu(), P)
        err, max_abs = errors(got, ref)
        if not err <= K1_TOL[dtype]:
            raise AssertionError(f"segment_sum {dtype} {(O, D, P)}: "
                                 f"error {err} > {K1_TOL[dtype]}")
        out.append(((O, D, P), err, max_abs))
    return out


def check_k2(dtype, device):
    """K2 on ``device`` against its twin on the same device, launched twice.
    Returns {output: (normalized error, max abs error)}; raises if an error
    exceeds K2_TOL or if the two launches differ in any bit."""
    args = k2_case(dtype, device)
    got = kernels.fused_eval(**args)
    again = kernels.fused_eval(**args)
    ref = kernels.fused_eval_twin(**args)
    errs = {}
    for name, a, a2, b in zip(K2_OUTPUTS, got, again, ref):
        if not torch.equal(a, a2):
            raise AssertionError(f"fused_eval {dtype} {name}: two launches "
                                 "on the same input differ")
        errs[name] = errors(a, b)
        if not errs[name][0] <= K2_TOL[dtype]:
            raise AssertionError(f"fused_eval {dtype} {name}: error "
                                 f"{errs[name][0]} > {K2_TOL[dtype]}")
    return errs
