"""tic/toc timer with running average (reference ``lib/utils/timer.py``;
the port's copy of ``lfb_tpu/utils/timer.py``)."""

from __future__ import annotations

import time


class Timer:

    def __init__(self):
        self.reset()

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self) -> float:
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.diff

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0
