"""The port's tracer (slslam_tpu_torch/utils/trace.py) in the global BA
solver (ops/schur_cg.py), on the CPU, without and with pose priors.

* Off: ``global_ba_cg``'s outputs and ``CGStats`` are bitwise those of a
  traced solve, and no span is made.
* On: one ``ba.solve`` a call, as many ``ba.iter`` as LM iterations, each
  child inside its parent's interval and after its elder sibling, the
  children in the solver's order; two solves carry distinct ids.
* The counter: ``ba.pcg_iters`` holds each step's PCG count as the PCG
  returned it, summing to ``CGStats.cg_iterations``.
* The clock: a profiler event opened inside a span starts inside it.
"""

import numpy as np
import pytest
import torch

from slslam_tpu_torch.ops import schur_cg as tcg
from slslam_tpu_torch.utils import trace

from test_schur_cg import BL, HD, _perturbed
from test_torch_schur_cg import _priors, _t

# (max_iters, cg_iters) without and with priors: the first solve ends at
# max_iters, the second where the loop's condition ends it; each has steps
# that stop at eta and steps that stop at the cap
SETTINGS = {False: (12, 20), True: (40, 6)}

STEP = ["ba.step.blocks", "ba.step.precond", "ba.step.pcg",
        "ba.step.backsub"]
ITER = ["ba.evaluate", "ba.step", "ba.trial_cost", "ba.update"]


@pytest.fixture(scope="module")
def problem():
    cam0, orth0, obs, obs_cam, obs_line, cam_free, _ = _perturbed()
    p = tcg.pack_line_major(obs, obs_cam, obs_line, len(cam0), len(orth0))
    return cam0, orth0, cam_free, p


@pytest.fixture
def tracer():
    trace.disable()
    yield trace
    trace.disable()


def _solve(problem, priors, **kw):
    cam0, orth0, cam_free, p = problem
    max_iters, cg_iters = SETTINGS[priors]
    if priors:
        chain, e3, _ = _priors(cam0)
        kw = dict(kw, prior_c=chain, prior_edges=e3)
    return tcg.global_ba_cg(
        _t(cam0), _t(orth0), _t(p.obs), _t(p.obs_cam), _t(p.obs_valid),
        _t(cam_free), _t(np.ones(len(orth0), bool)), BL, HD, robust=True,
        max_iters=max_iters, cg_iters=cg_iters, **kw)


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


@pytest.mark.parametrize("priors", [False, True], ids=["no prior",
                                                       "priors"])
def test_tracer_off_leaves_the_solve_bitwise(problem, priors, tracer,
                                             monkeypatch):
    def no_span(*a, **k):
        raise AssertionError("a span was made with the tracer off")

    with monkeypatch.context() as m:
        m.setattr(trace, "_Span", no_span)
        off = _solve(problem, priors)
    trace.enable()
    on = _solve(problem, priors)
    spans, counters = trace.take()
    assert spans and counters
    trace.disable()
    assert trace.take() == ([], [])
    for a, b in zip((off[0], off[1], *off[2]), (on[0], on[1], *on[2])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("priors", [False, True], ids=["no prior",
                                                       "priors"])
def test_span_tree_of_two_solves(problem, priors, tracer):
    trace.enable()
    stats = [_solve(problem, priors)[2] for _ in range(2)]
    spans, _ = trace.take()
    assert trace.take() == ([], [])
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["ba.solve", "ba.solve"]
    assert roots[0]["id"] != roots[1]["id"]
    assert roots[0]["end_ns"] <= roots[1]["start_ns"]
    C, L, kL = problem[0].shape[0], *problem[3].obs.shape[:2]
    max_iters, cg_iters = SETTINGS[priors]
    for root, st in zip(roots, stats):
        assert root["attrs"] == {"C": C, "L": L, "O": L * kL,
                                 "max_iters": max_iters,
                                 "cg_iters": cg_iters}
        mine = [s for s in spans if s["root"] == root["id"]]
        n = int(st.iterations)
        kids = [s["name"] for s in _children(spans, root)]
        # a read before each iteration, and one more where the loop's
        # condition, not max_iters, ended it
        assert kids == (["ba.start"] + ["ba.read", "ba.iter"] * n
                        + ["ba.read"] * (n < max_iters))
        iters = [s for s in mine if s["name"] == "ba.iter"]
        assert [s["attrs"]["k"] for s in iters] == list(range(n))
        for it in iters:
            assert [s["name"] for s in _children(spans, it)] == ITER
        for step in (s for s in mine if s["name"] == "ba.step"):
            assert [s["name"] for s in _children(spans, step)] == STEP
        for s in mine:
            assert s["start_ns"] <= s["end_ns"]
            if s["parent"] is not None:
                up = by_id[s["parent"]]
                assert up["start_ns"] <= s["start_ns"]
                assert s["end_ns"] <= up["end_ns"]
        for parent in mine:
            kids = _children(spans, parent)
            for a, b in zip(kids, kids[1:]):
                assert a["end_ns"] <= b["start_ns"]


@pytest.mark.parametrize("priors", [False, True], ids=["no prior",
                                                       "priors"])
def test_pcg_counter_holds_each_step(problem, priors, tracer, monkeypatch):
    direct = []
    pcg = tcg.schur_pcg

    def counted(*a, **k):
        x, it = pcg(*a, **k)
        direct.append(int(it))
        return x, it

    monkeypatch.setattr(tcg, "schur_pcg", counted)
    trace.enable()
    _, _, st = _solve(problem, priors)
    spans, counters = trace.take()
    (root,) = [s for s in spans if s["name"] == "ba.solve"]
    assert [(c["name"], c["root"]) for c in counters] == [
        ("ba.pcg_iters", root["id"])]
    values = counters[0]["values"]
    assert values == direct and len(values) == int(st.iterations)
    assert sum(values) == int(st.cg_iterations)
    cap = root["attrs"]["cg_iters"]
    capped = sum(v == cap for v in values)
    assert capped == sum(d >= SETTINGS[priors][1] for d in direct)
    assert 0 < capped < len(values)


def test_span_clock_holds_a_profiler_event(tracer):
    trace.enable()
    with trace.span("probe"):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("probe.inner"):
                torch.ones(4).sum()
    trace.count("outside", torch.tensor(3))
    (sp,), counters = trace.take()
    assert counters == [{"name": "outside", "root": None, "values": [3]}]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe.inner"]
    assert sp["start_ns"] <= ev.start_ns() <= ev.end_ns() <= sp["end_ns"]
