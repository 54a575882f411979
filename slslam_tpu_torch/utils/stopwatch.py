"""Profiling stopwatch with named accumulator channels.

A copy of ``slslam_tpu/utils/stopwatch.py`` (the reference's StopWatch,
src/stopwatch.h; channels used at slam.cpp:245,316,1237,1312,1384-1386).
The interactive engine reads each device stage's result to the host before
it stops the stage's channel, so a channel holds the stage's device time.
``tests/test_torch_copies.py`` checks the copy against the original.
"""

from __future__ import annotations

import time
from typing import Dict


class ChannelStats:
    __slots__ = ("total", "count")

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class StopWatch:
    def __init__(self):
        self._start = time.perf_counter()
        self._channels: Dict[str, ChannelStats] = {}
        self._open: Dict[str, float] = {}

    def tick(self, channel: str):
        self._open[channel] = time.perf_counter()

    def tock(self, channel: str):
        t0 = self._open.pop(channel, None)
        if t0 is None:
            return
        st = self._channels.setdefault(channel, ChannelStats())
        st.total += time.perf_counter() - t0
        st.count += 1

    def stats(self, channel: str) -> ChannelStats:
        return self._channels.get(channel, ChannelStats())

    def elapsed(self) -> float:
        return time.perf_counter() - self._start
