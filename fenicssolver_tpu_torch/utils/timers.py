"""Phase timers.

Port of ``fenicssolver_tpu/utils/timers.py`` (``PhaseTimers``; the
reference's profiler hook is not ported).  Device work is queued
asynchronously, so a timer given a ``device`` synchronizes it before each
clock read: a phase's time then includes the device work it queued.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class PhaseTimers:
    """Accumulates wall-clock per named phase (assembly, solve, ...)."""

    def __init__(self, device=None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.last = {}  # name -> seconds of its latest call
        self.device = device

    def _sync(self):
        if self.device is not None:
            from .. import config

            config.synchronize(self.device)

    @contextmanager
    def phase(self, name):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def report(self, logger=None):
        lines = [
            f"{name}: {tot:.3f}s over {self.counts[name]} calls"
            for name, tot in sorted(self.totals.items())
        ]
        msg = "phase timings: " + "; ".join(lines) if lines else "no phases timed"
        if logger:
            logger.info(msg)
        return msg
