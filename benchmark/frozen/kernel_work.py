"""Frozen copy of the port's closed forms of kernel work, and the peaks.

Copied verbatim from ``slslam_tpu_torch/kernel_checks.py`` at the commit
that added the benchmark: the H100's data-sheet peaks (SXM, 3.35 TB/s of
HBM, 67 TFLOP/s float32 outside the tensor cores, both at the card's
700 W limit), ``bound``, ``plan_work``, ``k1_work``, K2's operations per
valid row (``_K2_OPS``, ``_K2_PARTS``, ``k2_row_ops``), ``schur_work``
(K3's passes, one PCG iteration, K4) and ``k2_work``.  The work comes
from shapes, each input byte read once and each output byte written
once, whatever kernels implement it.  ``benchmark/tests/
test_bench_frozen.py`` holds them equal to the port's.

``k2_work_counts`` and ``cost_work`` below are the benchmark's own: the
first is ``k2_work`` written over counts (no tensors or plans), the second
the residual-only cost of an LM trial point, the K2 parts it needs.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


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
    O = args["obs"].shape[0]
    write = {"full": 1 + C * 42 + L * 20 + C * L * 24, "cams": 1 + C * 42,
             "lines": L * 21, "lm": 1 + C * 42 + L * 20 + O * 24}[variant] * e
    return read + write, n * k2_row_ops(variant)


def k2_work_counts(C, L, O, n, e, variant, plan_offsets):
    """``k2_work`` over counts: ``C`` cameras, ``L`` lines, ``O`` rows of
    the layout, ``n`` valid rows, ``e``-byte floats, ``plan_offsets`` the
    lengths of the offsets of the plans the call reads ((C + 1, L + 1)
    for ``lm``)."""
    read = C * 6 * e + L * 4 * e + n * (8 * e + 4 + 4 + e)
    read += (C * e if variant != "lines" else 0) + (L * e if variant != "cams"
                                                    else 0)
    for k in plan_offsets:
        read += 4 * n + 4 * k
    write = {"full": 1 + C * 42 + L * 20 + C * L * 24, "cams": 1 + C * 42,
             "lines": L * 21, "lm": 1 + C * 42 + L * 20 + O * 24}[variant] * e
    return read + write, n * k2_row_ops(variant)


def cost_work(C, L, n, e):
    """(bytes, operations) of the robust cost alone at an LM trial point:
    the parameters, each valid row's observation, camera index and
    validity read once, one value written; the residual and the Huber
    cost a row (``_K2_OPS``)."""
    return (C * 6 * e + L * 4 * e + n * (8 * e + 4 + e) + e,
            n * (_K2_OPS["residual"] + _K2_OPS["huber"]))
