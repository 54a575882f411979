"""Spans and counters of the port, kept in memory: the one tracer.

Off by default.  Off, ``span(name, **attrs)`` is one module-level check
that returns a shared no-op context manager and ``count(name, value)``
returns at once: nothing is recorded, allocated or launched.

On (``enable()``), each span keeps its name, its start and end in ns, its
parent, the id of its root (the outermost span open when it started: a
``ba.solve`` for the solver's spans, so spans of one solve share it) and
its attributes.  ``count`` keeps a 0-d device tensor (such as a step's
PCG count) under its name and the open root, without reading it; the
host reads them all at once, in ``take()``, so a traced solve reads the
device no more often than an untraced one.  ``take()`` hands over
the finished spans and the counters and clears them; ``disable()`` turns
the tracer off and drops what it holds.

Timestamps are Unix-epoch ns (``time.time_ns()``), the clock of the
events ``torch.profiler`` (Kineto) records, so a span's host interval can
be matched with the launch records and device intervals of a profile of
the same run (``benchmark/harness/spans.py``).

Spans and counters, and what reads them: ``ops/schur_cg.py``'s module
docstring.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import torch

_NOOP = nullcontext()
_rec = None       # the _Recorder while on


class _Recorder:
    def __init__(self):
        self.spans = []     # finished spans, in the order they ended
        self.open = []      # the open spans, outermost first
        self.counts = {}    # (root id, name) -> [0-d tensors]
        self.next_id = 0


class _Span:
    __slots__ = ("rec", "r")

    def __init__(self, rec, name, attrs):
        self.rec = rec
        self.r = {"id": None, "name": name, "start_ns": None,
                  "end_ns": None, "parent": None, "root": None,
                  "attrs": attrs}

    def __enter__(self):
        rec, r = self.rec, self.r
        r["id"] = rec.next_id
        rec.next_id += 1
        if rec.open:
            r["parent"] = rec.open[-1]["id"]
            r["root"] = rec.open[0]["id"]
        else:
            r["root"] = r["id"]
        rec.open.append(r)
        r["start_ns"] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.r["end_ns"] = time.time_ns()
        self.rec.open.pop()
        self.rec.spans.append(self.r)
        return False


def span(name, **attrs):
    """A context manager that records ``name`` over its body while the
    tracer is on; the shared no-op while it is off."""
    if _rec is None:
        return _NOOP
    return _Span(_rec, name, attrs)


def count(name, value):
    """Keep ``value`` (a 0-d tensor, read in ``take()``) as the next
    entry of counter ``name`` of the open root span, while on."""
    if _rec is None:
        return
    root = _rec.open[0]["id"] if _rec.open else None
    _rec.counts.setdefault((root, name), []).append(value)


def enable():
    """Turn the tracer on, with nothing recorded."""
    global _rec
    _rec = _Recorder()


def disable():
    """Turn the tracer off and drop what it holds."""
    global _rec
    _rec = None


def take():
    """(spans, counters) recorded since ``enable()`` or the last
    ``take()``, which are then cleared; the tracer stays as it was.

    spans: dicts ``id``, ``name``, ``start_ns``, ``end_ns``, ``parent``
    (an id or None), ``root`` (an id) and ``attrs``, in the order they
    started; counters: dicts ``name``, ``root`` (the id of the root span
    open at each ``count``, or None) and ``values`` (ints), in the order
    the roots started.  Reads all values from the device at once (they
    are on one device)."""
    if _rec is None:
        return [], []
    spans = sorted(_rec.spans, key=lambda r: r["id"])
    counts, _rec.spans, _rec.counts = _rec.counts, [], {}
    keys = sorted(counts, key=lambda k: (k[0] is None, k[0] or 0))
    flat = (torch.stack([v for k in keys for v in counts[k]]).tolist()
            if keys else [])
    counters, at = [], 0
    for root, name in keys:
        n = len(counts[root, name])
        counters.append({"name": name, "root": root,
                         "values": flat[at:at + n]})
        at += n
    return spans, counters
