"""K2's variants and the segment plans (slslam_tpu_torch/ops/kernels.py)
against the JAX package, on the CPU.

On the CPU each wrapper takes its plain twin.  The ``cams`` twin is held
to JAX's ``_eval_pose_system`` and to ``fused_eval_pallas`` (interpret
mode) with every line fixed; the ``lines`` twin to ``fused_eval_pallas``
with every camera fixed (Hll, gl) and to a numpy segment sum of JAX's
per-row robust costs.  Tolerances are tests/test_pallas.py's for the fused
evaluate (rtol 1e-6, atol 1e-9), in float64.  The plans are held to
``np.argsort(key, kind="stable")`` and ``np.bincount`` offsets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.ops import pallas_kernels as pk
from slslam_tpu.ops import residuals as jres
from slslam_tpu.ops import schur_ba as jba
from slslam_tpu_torch import kernel_checks
from slslam_tpu_torch.ops import kernels

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-9)


def _case(seed, C=12, L=40, O=512, repeat_pairs=True):
    rng = np.random.default_rng(seed)
    cam = rng.standard_normal((C, 6)) * 0.1
    line = rng.standard_normal((L, 4)) * 0.2
    line[:, 3] = 0.4 + 0.3 * rng.random(L)
    obs = rng.standard_normal((O, 8)) * 0.3
    oc = rng.integers(0, C, O).astype(np.int32)
    ol = rng.integers(0, L, O).astype(np.int32)
    if repeat_pairs:
        oc[1::2], ol[1::2] = oc[0::2], ol[0::2]
    valid = (rng.random(O) < 0.8).astype(np.float64)
    cfree = np.ones(C)
    cfree[0] = 0.0
    lfree = np.ones(L)
    lfree[5] = 0.0
    return (cam, line, obs, oc, ol, valid, cfree, lfree, 0.12, 1.0 / 406.05)


def _pallas(args, cfree, lfree):
    a = [jnp.asarray(x) for x in args[:6]]
    return pk.fused_eval_pallas(*a, jnp.asarray(cfree), jnp.asarray(lfree),
                                *args[8:], interpret=True)


def _torch(args):
    return [torch.as_tensor(a) for a in args[:8]] + list(args[8:])


@pytest.mark.parametrize("seed", [21, 22])
def test_cams_twin_matches_pose_system_and_pallas(seed):
    args = _case(seed)
    cam, line, obs, oc, ol, wv, cfree, lfree, bl, hd = args
    ref_pose = jax.jit(lambda *a: jba._eval_pose_system(*a, bl, hd, True))(
        *(jnp.asarray(x) for x in (cam, line, obs, oc, ol, wv, cfree)))
    ref_pallas = _pallas(args, cfree, np.zeros_like(lfree))
    t = _torch(args)
    before = dict(kernels.launch_counts)
    got = kernels.fused_eval(*t[:7], None, bl, hd, variant="cams")
    assert kernels.launch_counts == before     # CPU tensors: the twin ran
    for name, g, a, b in zip(("cost", "Hcc", "gc"), got, ref_pose,
                             (ref_pallas[0], ref_pallas[1], ref_pallas[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("robust", [True, False])
def test_lines_twin_matches_pallas_and_segment_cost(robust):
    args = _case(23)
    cam, line, obs, oc, ol, wv, cfree, lfree, bl, hd = args
    L = line.shape[0]
    t = _torch(args)
    Hll, gl, cost_l = kernels.fused_eval(*t[:6], None, t[7], bl, hd,
                                         robust=robust, variant="lines")
    if robust:
        ref = _pallas(args, np.zeros_like(cfree), lfree)
        np.testing.assert_allclose(Hll.numpy(), np.asarray(ref[2]), **TOL)
        np.testing.assert_allclose(gl.numpy(), np.asarray(ref[4]), **TOL)
    r = jres.lba_residual_batch(jnp.asarray(cam[oc]), jnp.asarray(line[ol]),
                                jnp.asarray(obs), bl)
    _, cost_i = jba._robust_weights(r, hd, robust)
    cost_ref = np.zeros(L)
    np.add.at(cost_ref, ol, np.where(wv > 0, np.asarray(cost_i), 0.0))
    np.testing.assert_allclose(cost_l.numpy(), cost_ref, **TOL)


def test_lines_twin_matches_full_with_fixed_cameras():
    """``lines`` is ``full`` with cam_free_f = 0: same Hll and gl."""
    args = _case(24, repeat_pairs=False)
    t = _torch(args)
    full = kernels.fused_eval(*t[:6], torch.zeros_like(t[6]), *t[7:])
    Hll, gl, _ = kernels.fused_eval(*t[:6], None, *t[7:], variant="lines")
    np.testing.assert_allclose(Hll.numpy(), full[2].numpy(), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(gl.numpy(), full[4].numpy(), rtol=1e-12,
                               atol=1e-15)


def test_unknown_variant_raises():
    t = _torch(_case(25, C=2, L=8, O=8))
    with pytest.raises(ValueError, match="variant"):
        kernels.fused_eval(*t, variant="pose")


def _plan_ref(key, P):
    keep = (key >= 0) & (key < P)
    k = np.where(keep, key, P)
    perm = np.argsort(k, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(k[keep],
                                                         minlength=P))])
    return perm, offsets


@pytest.mark.parametrize("O,P", [(1600, 81), (1600, 1620), (162, 4),
                                 (7, 1), (0, 3)])
def test_segment_plan_matches_argsort(O, P):
    rng = np.random.default_rng(O + P)
    key = rng.integers(0, P, O).astype(np.int32)
    key[::5] = P                       # padding rows
    key[2::11] = -1
    plan = kernels.segment_plan(torch.as_tensor(key), P)
    perm, offsets = _plan_ref(key, P)
    np.testing.assert_array_equal(plan.perm.numpy(), perm)
    np.testing.assert_array_equal(plan.offsets.numpy(), offsets)
    kept = int(offsets[-1])
    assert kept == int(np.sum((key >= 0) & (key < P)))
    assert not np.isin(plan.perm.numpy()[:kept],
                       np.flatnonzero((key < 0) | (key >= P))).any()


def test_ba_plan_groups_valid_rows():
    args = _case(26)
    t = _torch(args)
    oc, ol, wv = args[3], args[4], args[5]
    C, L = args[0].shape[0], args[1].shape[0]
    full = kernels.ba_plan(t[3], t[4], t[5], C, L, "full")
    assert full.cam is None
    ok = wv > 0
    for plan, key, P in ((full.line, ol, L), (full.pair, oc * L + ol, C * L)):
        perm, offsets = _plan_ref(np.where(ok, key, P), P)
        np.testing.assert_array_equal(plan.perm.numpy(), perm)
        np.testing.assert_array_equal(plan.offsets.numpy(), offsets)
    cams = kernels.ba_plan(t[3], t[4], t[5], C, L, "cams")
    assert cams.line is None and cams.pair is None
    perm, offsets = _plan_ref(np.where(ok, oc, C), C)
    np.testing.assert_array_equal(cams.cam.perm.numpy(), perm)
    # camera c of the pair plan = its rows, grouped by line
    c = 3
    start, end = full.pair.offsets[c * L], full.pair.offsets[(c + 1) * L]
    rows = full.pair.perm[start:end].numpy()
    sel = np.flatnonzero(ok & (oc == c))
    np.testing.assert_array_equal(rows, sel[np.argsort(ol[sel],
                                                       kind="stable")])


@pytest.mark.parametrize("O,D,P", [(1600, 1, 81), (162, 42, 4)])
def test_segment_sum_with_plan_matches_numpy(O, D, P):
    rng = np.random.default_rng(O * D)
    vals = rng.standard_normal((O, D))
    idx = rng.integers(0, P, O).astype(np.int32)
    idx[::6] = P
    ref = np.zeros((P, D))
    keep = idx < P
    np.add.at(ref, idx[keep], vals[keep])
    v, i = torch.as_tensor(vals), torch.as_tensor(idx)
    got = kernels.segment_sum(v, i, P, plan=kernels.segment_plan(i, P))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("perm_len,offsets_len,dtype", [
    (1599, 82, torch.int32), (1600, 81, torch.int32),
    (1600, 82, torch.int64)])
def test_a_plan_of_another_shape_is_refused(perm_len, offsets_len, dtype):
    """A kernel reads a plan's rows and offsets unchecked: the wrappers
    refuse a plan built for another row count, segment count or dtype."""
    plan = kernels.SegmentPlan(torch.zeros(perm_len, dtype=torch.int32),
                               torch.zeros(perm_len, dtype=dtype),
                               torch.zeros(offsets_len, dtype=dtype))
    err = TypeError if dtype != torch.int32 else ValueError
    with pytest.raises(err):
        kernels._check_plan("segment_sum", plan, 1600, 81,
                            torch.device("cpu"))
    good = kernels.segment_plan(torch.zeros(1600, dtype=torch.int32), 81)
    kernels._check_plan("segment_sum", good, 1600, 81, torch.device("cpu"))


def test_lm_twin_matches_full():
    """``lm`` is ``full`` with the coupling kept per row: the same cost,
    Hcc, Hll, gc and gl, and W is the pair sum of Wb; Wb is zero on the
    invalid rows."""
    args = _case(27)
    t = _torch(args)
    oc, ol, wv = args[3], args[4], args[5]
    C, L = args[0].shape[0], args[1].shape[0]
    full = kernels.fused_eval(*t)
    lm = kernels.fused_eval(*t, variant="lm")
    assert lm[5].shape == (len(oc), 6, 4)
    for name, a, b in zip(("cost", "Hcc", "Hll", "gc", "gl"), full, lm):
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)
    W = np.zeros((C * L, 6, 4))
    np.add.at(W, oc * L + ol, lm[5].numpy())
    np.testing.assert_allclose(W.reshape(C, L, 6, 4), full[5].numpy(),
                               rtol=1e-12, atol=1e-15)
    assert np.all(lm[5].numpy()[wv <= 0] == 0.0)


def test_lm_plan_and_check_case():
    """``ba_plan(..., "lm")`` groups the valid rows by camera and by line,
    and the chip's line-major check case has padding rows at the end of
    its buckets, which the camera plan drops."""
    args = _case(28)
    t = _torch(args)
    oc, ol, wv = args[3], args[4], args[5]
    C, L = args[0].shape[0], args[1].shape[0]
    plan = kernels.ba_plan(t[3], t[4], t[5], C, L, "lm")
    assert plan.pair is None
    ok = wv > 0
    for p, key, P in ((plan.cam, oc, C), (plan.line, ol, L)):
        perm, offsets = _plan_ref(np.where(ok, key, P), P)
        np.testing.assert_array_equal(p.perm.numpy(), perm)
        np.testing.assert_array_equal(p.offsets.numpy(), offsets)

    case = kernel_checks.k2_lm_case(torch.float64, "cpu", C=40, L=6, kL=32,
                                    pad_frac=0.05)
    wv = case["w_valid"].numpy().reshape(6, 32)
    assert 0 < np.sum(wv == 0) and np.all(np.diff(wv, axis=1) <= 0)
    oc = case["obs_cam"].numpy().reshape(6, 32)
    for l in range(6):
        cams = oc[l][wv[l] > 0]
        assert len(set(cams)) == len(cams)         # one row per pair
    np.testing.assert_array_equal(case["obs_line"].numpy(),
                                  np.repeat(np.arange(6), 32))
    plan = kernels.ba_plan(case["obs_cam"], case["obs_line"],
                           case["w_valid"], 40, 6, "lm")
    dropped = kernel_checks.dropped_rows(plan.cam).numpy()
    np.testing.assert_array_equal(np.sort(dropped),
                                  np.flatnonzero(wv.reshape(-1) == 0))
