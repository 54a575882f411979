"""The program's spans joined to a profile of the card.

A ``torch.profiler`` profile with CUDA activity records, beside each
kernel, copy and fill the card ran, the CUDA runtime or driver call that
launched it, on the host's clock, tied to the device operation by a
correlation id.  The program's tracer (``slslam_tpu_torch/utils/trace.py``)
records its spans on the same clock (Unix-epoch ns).  So:

* ``launched_ops(prof)``: each device operation with its launch time;
* ``join(ops, spans)``: each operation counted in exactly one place, the
  innermost span whose host interval holds its launch (or none), and the
  device's idle gaps split at span boundaries, each piece named by the
  innermost span open on the host during it (``host in ba.evaluate``);
  a piece outside every span keeps ``harness/trace.py``'s name,
  ``host before <next operation>``, so a profile without spans names its
  gaps as that module does.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def launched_ops(prof):
    """[(start_ns, end_ns, name, launch_ns or None)] of the device's
    operations in a finished profile, each with the start of the runtime
    or driver call (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) of the
    same correlation id, from the profiler's raw events."""
    from torch.autograd import DeviceType
    launch, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                s = e.start_ns()
                ops.append((s, s + e.duration_ns(), e.name(),
                            e.correlation_id()))
        elif e.name().startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    return [(s, t, n, launch.get(c)) for s, t, n, c in ops]


class Timeline:
    """The innermost span open on the host at each instant, from the
    tracer's span records (a span holds [start_ns, end_ns))."""

    def __init__(self, spans):
        edges = sorted([(s["start_ns"], 1, s["id"]) for s in spans]
                       + [(s["end_ns"], 0, s["id"]) for s in spans])
        self.times, self.owner, open_ = [], [], []
        for t, starts, sid in edges:
            if starts:
                open_.append(sid)
            else:
                open_.remove(sid)
            top = open_[-1] if open_ else None
            if self.times and self.times[-1] == t:
                self.owner[-1] = top
            else:
                self.times.append(t)
                self.owner.append(top)

    def at(self, t):
        """The id of the innermost span open at ``t``, or None."""
        i = bisect.bisect_right(self.times, t) - 1
        return self.owner[i] if i >= 0 else None

    def pieces(self, t0, t1):
        """[(a, b, id or None)]: [t0, t1) cut at span boundaries, each
        piece with the innermost span open over it."""
        i = bisect.bisect_right(self.times, t0) - 1
        out = []
        while t0 < t1:
            nxt = self.times[i + 1] if i + 1 < len(self.times) else t1
            b = min(nxt, t1)
            out.append((t0, b, self.owner[i] if i >= 0 else None))
            t0, i = b, i + 1
        return out


def join(ops, spans):
    """The device time of ``ops`` (``launched_ops``) put down to the
    tracer's ``spans``, in ns:

    * ``ops_ns``: all operations' device time; ``busy_ns``: the union of
      their intervals;
    * ``self_ns`` {span name or None: ns}: each operation once, in the
      innermost span open at its launch (None: outside every span, or no
      launch record, counted in ``unlaunched``);
    * ``device_ns`` {span name: ns}: each operation in its innermost span
      and in every enclosing span of another name;
    * ``gaps_ns`` {name: ns}: the idle gaps between operations, each cut
      at span boundaries and named ``host in <span>``, or ``host before
      <next operation>`` where no span is open;
    * ``idle_in_ns`` {root name: ns}: the gaps' pieces inside a root span
      of that name (for the solver, idle time inside a ``ba.solve``);
    * ``roots`` {name: count}: the root spans (for the solver, solves)."""
    by_id = {s["id"]: s for s in spans}
    names = {}

    def chain(sid):
        """The distinct names of span ``sid`` and its ancestors."""
        if sid not in names:
            s = by_id[sid]
            up = () if s["parent"] is None else chain(s["parent"])
            names[sid] = up if s["name"] in up else up + (s["name"],)
        return names[sid]

    line = Timeline(spans)
    self_ns, device_ns = defaultdict(int), defaultdict(int)
    gaps, idle_in = defaultdict(int), defaultdict(int)
    total = busy = unlaunched = 0
    end = None
    for s, e, name, launch in sorted(ops):
        total += e - s
        sid = None if launch is None else line.at(launch)
        unlaunched += launch is None
        self_ns[None if sid is None else by_id[sid]["name"]] += e - s
        for n in () if sid is None else chain(sid):
            device_ns[n] += e - s
        if end is not None and s > end:
            for a, b, g in line.pieces(end, s):
                if g is None:
                    gaps["host before " + name] += b - a
                else:
                    gaps["host in " + by_id[g]["name"]] += b - a
                    idle_in[by_id[by_id[g]["root"]]["name"]] += b - a
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    roots = defaultdict(int)
    for s in spans:
        if s["parent"] is None:
            roots[s["name"]] += 1
    return {"ops_ns": total, "busy_ns": busy, "self_ns": dict(self_ns),
            "device_ns": dict(device_ns), "unlaunched": unlaunched,
            "gaps_ns": dict(gaps), "idle_in_ns": dict(idle_in),
            "roots": dict(roots)}
