"""The join of a profile's device operations to the program's spans
(``harness/spans.py``), on synthetic operations, launches and spans: the
device time of each span, each operation counted once, the idle gaps cut
at span boundaries and named by them, ``harness/trace.py``'s names where
no span is open, and the launch records read from a profile's events."""

from __future__ import annotations

import pytest

from benchmark.harness import spans as sp
from benchmark.harness.trace import DeviceTrace


def _span(i, name, start, end, parent=None, root=None):
    return {"id": i, "name": name, "start_ns": start, "end_ns": end,
            "parent": parent, "root": i if root is None else root,
            "attrs": {}}


# two solves: 0 [0, 100) holds an iteration [10, 90) with a step [20, 50)
# (its PCG [30, 45)) and a trial cost [50, 80); 5 [200, 300) holds a read
# [210, 220)
SPANS = [_span(0, "ba.solve", 0, 100),
         _span(1, "ba.iter", 10, 90, 0, 0),
         _span(2, "ba.step", 20, 50, 1, 0),
         _span(3, "ba.step.pcg", 30, 45, 2, 0),
         _span(4, "ba.trial_cost", 50, 80, 1, 0),
         _span(5, "ba.solve", 200, 300),
         _span(6, "ba.read", 210, 220, 5, 5)]

# (start, end, name, launch): device intervals and the host's launches
OPS = [(12, 25, "k_eval", 11),       # launched in ba.iter
       (40, 60, "k_pcg", 35),        # in ba.step.pcg, runs past its span
       (60, 62, "k_inv", 48),        # in ba.step
       (95, 98, "k_cost", 79),       # in ba.trial_cost
       (99, 110, "k_late", 5),       # in ba.solve itself
       (150, 151, "k_out", 120),     # outside every span
       (160, 161, "k_lost", None),   # no launch record
       (230, 240, "k_read", 215)]    # in ba.read


def test_each_op_counted_once_in_its_innermost_span():
    j = sp.join(OPS, SPANS)
    assert j["ops_ns"] == sum(e - s for s, e, _, _ in OPS) == 61
    assert j["busy_ns"] == 61
    assert j["self_ns"] == {"ba.iter": 13, "ba.step.pcg": 20, "ba.step": 2,
                            "ba.trial_cost": 3, "ba.solve": 11, None: 2,
                            "ba.read": 10}
    assert sum(j["self_ns"].values()) == j["ops_ns"]
    assert j["unlaunched"] == 1
    assert j["roots"] == {"ba.solve": 2}


def test_device_time_of_a_span_holds_its_children():
    d = sp.join(OPS, SPANS)["device_ns"]
    assert d["ba.step.pcg"] == 20
    assert d["ba.step"] == 22
    assert d["ba.trial_cost"] == 3
    assert d["ba.iter"] == 13 + 22 + 3
    assert d["ba.solve"] == 13 + 22 + 3 + 11 + 10
    assert d["ba.read"] == 10


def test_gaps_are_cut_at_span_boundaries():
    j = sp.join(OPS, SPANS)
    assert j["gaps_ns"] == {
        # [25, 40): ba.step [20, 50) open, then its PCG [30, 45) too
        "host in ba.step": 5, "host in ba.step.pcg": 10,
        # [62, 95): ba.trial_cost to 80, ba.iter to 90, then ba.solve;
        # [98, 99) ba.solve; [200, 210) and [220, 230) the second solve
        "host in ba.trial_cost": 18, "host in ba.iter": 10,
        "host in ba.solve": 5 + 1 + 10 + 10,
        # [110, 150), [151, 160) and [161, 200): no span open
        "host before k_out": 40, "host before k_lost": 9,
        "host before k_read": 39,
        "host in ba.read": 10}             # [210, 220)
    assert j["idle_in_ns"] == {"ba.solve": 15 + 18 + 10 + 26 + 10}
    total = sum(j["gaps_ns"].values())
    assert total == (OPS[-1][1] - OPS[0][0]) - j["busy_ns"]


def test_without_spans_gaps_keep_the_trace_names():
    j = sp.join(OPS, [])
    assert j["self_ns"] == {None: j["ops_ns"]}
    assert j["device_ns"] == {} and j["idle_in_ns"] == {}
    tr = DeviceTrace(True)
    tr.ops = [(s, e, n) for s, e, n, _ in OPS]
    want = dict(tr.summary(1.0, top=len(OPS))["idle_gaps"])
    got = {k: v * 1e-9 for k, v in j["gaps_ns"].items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)


def test_timeline_of_adjacent_and_nested_spans():
    spans = [_span(0, "a", 0, 10), _span(1, "b", 10, 20),
             _span(2, "c", 10, 15, 1, 1)]
    line = sp.Timeline(spans)
    assert [line.at(t) for t in (-1, 0, 9, 10, 14, 15, 19, 20)] == [
        None, 0, 0, 2, 2, 1, 1, None]
    assert line.pieces(5, 25) == [(5, 10, 0), (10, 15, 2), (15, 20, 1),
                                  (20, 25, None)]
    assert sp.Timeline([]).pieces(3, 7) == [(3, 7, None)]


class _Event:
    def __init__(self, device, name, start, dur, corr, annotation=False):
        self.d, self.n, self.s, self.t, self.c = device, name, start, dur, corr
        self.a = annotation

    def device_type(self):
        return self.d

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.t

    def correlation_id(self):
        return self.c

    def is_user_annotation(self):
        return self.a


def test_launched_ops_ties_each_op_to_its_launch():
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_Event(cpu, "cudaLaunchKernel", 100, 5, 7),
              _Event(cpu, "aten::add", 90, 30, 7),
              _Event(cpu, "cudaMemcpyAsync", 130, 4, 8),
              _Event(cuda, "k_add", 140, 10, 7),
              _Event(cuda, "Memcpy DtoH", 150, 2, 8),
              _Event(cuda, "k_graph", 160, 3, 9),
              _Event(cuda, "gpu_user_annotation", 140, 20, 0, True)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    assert sp.launched_ops(Prof) == [(140, 150, "k_add", 100),
                                     (150, 152, "Memcpy DtoH", 130),
                                     (160, 163, "k_graph", None)]
