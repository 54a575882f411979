"""The segment plan and K2 ``lm``'s twin against numpy and the JAX package,
on the keys and paddings their CUDA kernels are redesigned around.

On the CPU the wrappers take their plain twins: ``segment_plan_twin``
(a stable argsort) is held bit for bit to numpy's stable argsort on
adversarial keys (kernel_checks.plan_adversarial_cases), and a segment
sum driven by that plan (each segment's rows in plan order, as K1 reads
them) to the JAX package's ``segment_sum_pallas`` in interpret mode (as
tests/test_pallas.py runs it on the CPU), float64, within 1e-12.  K2
``lm``'s twin is held to the JAX package's ``_eval_system_lm`` in float64
within 1e-10 (normalized, as tests/test_torch_schur_cg.py) at the large
map's padding share (~73 % of the line-major rows), with whole padding
buckets, a fixed camera and a fixed line, and its padded rows' Wb must be
exactly zero.  The kernels themselves are held to the twins on the card
by tests/test_torch_gpu.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu.ops import pallas_kernels as pk
from slslam_tpu.ops import schur_cg as jcg
from slslam_tpu_torch import kernel_checks
from slslam_tpu_torch.ops import kernels
from slslam_tpu_torch.ops import schur_cg as tcg

torch.set_num_threads(1)

CASES = kernel_checks.plan_adversarial_cases()
CASE_IDS = [name for name, _, _ in CASES]
PALLAS_CHUNK = 512


def _numpy_plan(key, P):
    k = np.where((key >= 0) & (key < P), key, P)
    perm = np.argsort(k, kind="stable")
    offsets = np.searchsorted(np.sort(k, kind="stable"), np.arange(P + 1))
    return perm, offsets


@pytest.mark.parametrize("name,key,P", CASES, ids=CASE_IDS)
def test_plan_twin_matches_numpy_stable_argsort(name, key, P):
    plan = kernels.segment_plan(torch.as_tensor(key), P)
    perm, offsets = _numpy_plan(key, P)
    assert plan.perm.dtype == plan.offsets.dtype == torch.int32
    np.testing.assert_array_equal(plan.perm.numpy(), perm, err_msg=name)
    np.testing.assert_array_equal(plan.offsets.numpy(), offsets,
                                  err_msg=name)
    # the plan's own invariants: a permutation, kept rows first, in order
    assert sorted(plan.perm.tolist()) == list(range(key.size))
    kept = int(plan.offsets[-1])
    assert kept == int(((key >= 0) & (key < P)).sum())
    dropped = plan.perm[kept:].numpy()
    assert np.all(np.diff(dropped) > 0)


def _plan_sum(values, plan, P):
    """A segment sum that reads the plan as K1 does: segment p is the rows
    perm[offsets[p]:offsets[p + 1]], summed in that order."""
    counts = (plan.offsets[1:] - plan.offsets[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(P), counts)
    kept = int(plan.offsets[-1])
    rows = plan.perm[:kept].long()
    return torch.zeros((P, values.shape[1]), dtype=values.dtype).index_add_(
        0, seg, values[rows])


@pytest.mark.parametrize("name,key,P", [c for c in CASES if c[2] <= 4096],
                         ids=[c[0] for c in CASES if c[2] <= 4096])
def test_segment_sum_through_the_plan_matches_pallas(name, key, P):
    rng = np.random.default_rng(key.size + P)
    D = 3
    vals = rng.standard_normal((key.size, D))
    # segment_sum_pallas takes whole chunks: pad with dropped rows
    pad = -key.size % PALLAS_CHUNK or (PALLAS_CHUNK if key.size == 0 else 0)
    jkey = np.concatenate([key, np.full(pad, P, np.int32)])
    jvals = np.concatenate([vals, np.zeros((pad, D))])
    ref = pk.segment_sum_pallas(jnp.asarray(jvals), jnp.asarray(jkey), P,
                                chunk=PALLAS_CHUNK, interpret=True)
    plan = kernels.segment_plan(torch.as_tensor(key), P)
    got = _plan_sum(torch.as_tensor(vals), plan, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12, err_msg=name)
    twin = kernels.segment_sum(torch.as_tensor(vals), torch.as_tensor(key),
                               P, plan=plan)
    np.testing.assert_allclose(twin.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12, err_msg=name)


def _cam_perm(obs_cam, valid, C):
    """The JAX layout's camera permutation of the flat line-major rows:
    each camera's valid rows in row order, padded (pack_line_major's
    cam_perm / cam_perm_valid)."""
    oc, ok = obs_cam.reshape(-1), valid.reshape(-1)
    rows = [np.flatnonzero(ok & (oc == c)) for c in range(C)]
    kC = max(1, max(len(r) for r in rows))
    perm = np.zeros((C, kC), np.int32)
    pv = np.zeros((C, kC), bool)
    for c, r in enumerate(rows):
        perm[c, :len(r)] = r
        pv[c, :len(r)] = True
    return perm, pv


# (C, L, kL, padding share, lines whose whole bucket is padding): the
# large map's layout (kL = 32, ~73 % padding) cut to a few lines; the
# same with whole padding buckets; the refine's (kL > C, 0.8 %)
LM_CASES = [(48, 60, 32, kernel_checks.MAP_PAD, ()),
            (48, 60, 32, kernel_checks.MAP_PAD, (0, 7, 8, 59)),
            (20, 12, 40, 0.008, (3,))]


@pytest.mark.parametrize("C,L,kL,pad,empty", LM_CASES,
                         ids=["map padding", "whole padding buckets",
                              "refine padding"])
def test_lm_twin_matches_jax_at_map_padding(C, L, kL, pad, empty):
    args = kernel_checks.k2_lm_case(torch.float64, "cpu", C=C, L=L, kL=kL,
                                    pad_frac=pad, seed=3)
    obs = args["obs"].numpy().reshape(L, kL, 8)
    oc = args["obs_cam"].numpy().reshape(L, kL)
    wv = args["w_valid"].numpy().reshape(L, kL)
    for l in empty:
        obs[l], oc[l], wv[l] = 0.0, 0, 0.0
    valid = wv > 0
    assert 0.6 < 1 - valid.mean() < 0.85 if pad > 0.5 else valid.mean() > 0.9
    cf, lf = args["cam_free_f"].numpy(), args["line_free_f"].numpy()
    assert cf[0] == 0 and lf[5] == 0           # a fixed camera and line
    cam, line = args["cam_wt"].numpy(), args["line_orth"].numpy()
    perm, pv = _cam_perm(oc, valid, C)
    bl, hd = args["baseline"], args["huber_delta"]
    ref = jax.jit(lambda *a: jcg._eval_system_lm(*a, True, "orth"))(
        *(jnp.asarray(x) for x in (cam, line, obs, oc, wv, perm, pv, cf, lf,
                                   bl, hd)))
    before = dict(kernels.launch_counts)
    got = tcg._eval_system_lm(*(torch.as_tensor(x) for x in (
        cam, line, obs, oc, wv, cf, lf)), bl, hd, True)
    assert kernels.launch_counts == before     # CPU tensors: the twin ran
    assert torch.all(got[5][torch.as_tensor(~valid)] == 0)
    for l in empty:
        assert torch.all(got[2][l] == 0) and torch.all(got[4][l] == 0)
    for name, a, b in zip(("cost", "Hcc", "Hll", "gc", "gl", "Wb"), ref,
                          got):
        a = np.asarray(a)
        err = np.max(np.abs(b.numpy() - a)) / max(1.0, np.max(np.abs(a)))
        assert err <= 1e-10, (name, err)


def test_check_plans_on_cpu_covers_the_large_shapes():
    """kernel_checks' plan cases are well-formed at every shape the chip
    checks them at (on the CPU both sides are the twin)."""
    small = [(O, P) for O, P in kernel_checks.PLAN_LARGE_SHAPES
             + kernel_checks.PLAN_BOUNDARY_SHAPES if O < 100_000]
    for name, diff in kernel_checks.check_plans("cpu", small):
        assert diff == 0, name
    for name, diff in kernel_checks.check_plans("cpu", cases=CASES):
        assert diff == 0, name
