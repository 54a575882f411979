"""solve_roofline.solve: the least time of the window's solves' work on
the H100's data-sheet peaks, over the window's wall, in %.

The work of one solve comes from the frozen closed forms
(``benchmark/frozen/kernel_work.py``) at the map's shapes: the camera
and line plans once a solve; K2 ``lm``, K4 ``schur_jacobi``, K3's
right-hand side (camera pass) and back-substitution (line pass) and the
residual-only cost of the trial point once an LM iteration; one K3 PCG
iteration's work times the solve's own PCG iterations; and the cost of
the start.  Each part's least time is the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s (float32), whatever
kernels implement it."""

from benchmark.frozen import kernel_work as kw


def _ms(work):
    return kw.bound(*work)[0]


def least_ms(work, lm_iters, pcg_iters):
    C, L, O, n, e = (work[k] for k in ("C", "L", "O", "valid", "e"))
    plans = _ms(kw.plan_work(O, C)) + _ms(kw.plan_work(O, L))
    per_lm = (_ms(kw.k2_work_counts(C, L, O, n, e, "lm", (C + 1, L + 1)))
              + _ms(kw.schur_work("schur_jacobi", C, L, n, e))
              + _ms(kw.schur_work("schur_matvec/cam", C, L, n, e, rhs=True))
              + _ms(kw.schur_work("schur_matvec/line", C, L, n, e))
              + _ms(kw.cost_work(C, L, n, e)))
    return (plans + _ms(kw.cost_work(C, L, n, e)) + lm_iters * per_lm
            + pcg_iters * _ms(kw.schur_work("schur_pcg", C, L, n, e)))


def read(data):
    w = data["window"]
    if not w.get("solves") or "work" not in w:
        return None
    total = sum(least_ms(w["work"], lm, pcg)
                for lm, pcg in zip(w["lm_iters"], w["pcg_iters"]))
    return 100.0 * total * 1e-3 / data["window_s"]
