"""Device time of a window, from ``torch.profiler`` with CUDA activity
only: no CPU operations, stacks, shapes or memory events, so that the
profiler records each kernel, copy and fill the card runs and adds
little to the host's work.

``DeviceTrace`` starts the profiler before the window opens and stops it
after the window closes; ``summary(window_s)`` then gives the busy
seconds (the union of the device intervals), the device operations that
took most time and the longest idle gaps, grouped by the operation the
card waited for.
"""

from __future__ import annotations

import time
from collections import defaultdict


class DeviceTrace:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.ops = []          # (start_ns, end_ns, name)
        self.stop_s = self.read_s = 0.0

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            kw = {}
            try:
                from torch._C._profiler import _ExperimentalConfig
                # no links from device operations to CPU operations: none
                # are recorded
                kw["experimental_config"] = _ExperimentalConfig(
                    disable_external_correlation=True)
            except (ImportError, TypeError):
                pass
            self.prof = profile(activities=[ProfilerActivity.CUDA],
                                record_shapes=False, with_stack=False,
                                profile_memory=False, with_flops=False,
                                **kw)
            self.prof.__enter__()
            torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.prof.__exit__(*exc)
            t1 = time.perf_counter()
            self.ops = device_ops(self.prof)
            self.stop_s, self.read_s = t1 - t0, time.perf_counter() - t1
        return False

    def summary(self, window_s: float, top: int = 10):
        """busy_s, ops (count), device_ops [[name, s]] and idle_gaps
        [[name, s]], or None where nothing was traced."""
        if not self.enabled:
            return None
        ops = sorted(self.ops)
        busy = 0.0
        gaps = defaultdict(float)
        by_name = defaultdict(float)
        end = None
        for s, e, name in ops:
            by_name[name] += (e - s) * 1e-9
            if end is None:
                busy += e - s
                end = e
                continue
            if s > end:
                gaps["host before " + name] += (s - end) * 1e-9
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gap_rank = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"busy_s": busy * 1e-9, "window_s": window_s,
                "ops": len(ops),
                "device_ops": [[_short(n), s] for n, s in rank],
                "idle_gaps": [[_short(n), s] for n, s in gap_rank]}


def _short(name, n=64):
    return name if len(name) <= n else name[:n]


def device_ops(prof):
    """[(start_ns, end_ns, name)] of the device's operations in a finished
    profile, read from the profiler's raw events (its event list would
    build a Python object for each of up to millions of operations)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        s = e.start_ns()
        out.append((s, s + e.duration_ns(), e.name()))
    return out
