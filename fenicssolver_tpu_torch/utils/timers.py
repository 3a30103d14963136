"""Phase timers.

Port of ``fenicssolver_tpu/utils/timers.py``: ``PhaseTimers`` and the
profiler hook ``maybe_profile``.  Device work is queued asynchronously, so
a timer given a ``device`` synchronizes it before each clock read: a
phase's time then includes the device work it queued.
"""

from __future__ import annotations

import os
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


@contextmanager
def maybe_profile(name="trace"):
    """A ``torch.profiler`` trace of the block (the host's operators and,
    with a card, its kernels) written as a Chrome trace
    ``<FST_PROFILE_DIR>/<name>.json`` when ``FST_PROFILE_DIR`` is set (the
    reference's ``jax.profiler.trace``); otherwise nothing.  Yields the
    profiler, or None."""
    trace_dir = os.environ.get("FST_PROFILE_DIR")
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
