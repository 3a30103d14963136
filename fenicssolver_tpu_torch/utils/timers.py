"""Phase timers and the program's spans and counters.

Port of ``fenicssolver_tpu/utils/timers.py``: ``PhaseTimers`` and the
profiler hook ``maybe_profile``.  Device work is queued asynchronously, so
a timer given a ``device`` synchronizes it before each clock read: a
phase's time then includes the device work it queued.

The recorder (``span``, ``count``, ``records``, ``clear_records``) is on
exactly while a ``torch.profiler`` session is active in the process, as
``torch.autograd._profiler_enabled()`` reports; otherwise ``span`` returns
one shared null context and ``count`` returns, each after that one check.
When on, a span records ``SpanRecord(start_ns, end_ns, name, parent, root,
id)`` on ``time.time_ns()``, the clock the profiler stamps its device
activities in, and opens ``record_function(name)`` so that a Chrome trace
shows it over the kernels; ``parent`` is the id of the span that was
innermost when it opened, ``root`` that of the outermost one (its own for a
root span: a request's identifier).  A count records ``CountRecord(t_ns,
name, n, span)`` against the innermost open span.  Nothing here
synchronizes the device except ``PhaseTimers``' phase edges.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import NamedTuple, Optional

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function


class SpanRecord(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    parent: Optional[int]  # id of the enclosing span, None for a root
    root: int  # id of the outermost enclosing span (its own for a root)
    id: int


class CountRecord(NamedTuple):
    t_ns: int
    name: str
    n: int
    span: Optional[int]  # id of the innermost open span


class Records(NamedTuple):
    spans: list
    counts: list


# a process's first record_function takes ~2 ms (its operator's first
# dispatch): taken here, outside any trace, so that a span and its
# annotation start together
with record_function("fenicssolver_tpu_torch.utils.timers"):
    pass

_NULL = nullcontext()
_LOCAL = threading.local()
_SPANS = []
_COUNTS = []
_IDS = itertools.count()


def _stack():
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "annotation")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = None if top is None else top.id
        self.root = self.id if top is None else top.root
        stack.append(self)
        # the clock is read before the annotation opens and after it
        # closes: the annotation's own cost (tens of us under a CUDA
        # profiler) is the span's, not its parent's
        self.start = time.time_ns()
        self.annotation = record_function(self.name)
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        _SPANS.append(SpanRecord(self.start, end, self.name, self.parent,
                                 self.root, self.id))
        return False


def span(name):
    """A context that records ``name`` while a profiler is active (see the
    module's docstring); it never synchronizes the device."""
    if not _profiler_enabled():
        return _NULL
    return _Span(name)


def count(name, n=1):
    """Add ``n`` (an int) to the counter ``name`` under the innermost open
    span, while a profiler is active."""
    if not _profiler_enabled():
        return
    stack = _stack()
    _COUNTS.append(CountRecord(time.time_ns(), name, n,
                               stack[-1].id if stack else None))


def records():
    """The spans and counts recorded since the last ``clear_records()``."""
    return Records(list(_SPANS), list(_COUNTS))


def clear_records():
    _SPANS.clear()
    _COUNTS.clear()


class PhaseTimers:
    """Accumulates wall-clock per named phase (assembly, solve, ...); each
    phase is also a span, from after its first synchronize to after its
    last, so it bounds the device work it queued."""

    def __init__(self, device=None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.last = {}  # name -> seconds of its latest call
        self.device = device

    def _sync(self):
        if self.device is not None:
            from .. import config

            count("host_sync")
            config.synchronize(self.device)

    @contextmanager
    def phase(self, name):
        self._sync()
        t0 = time.perf_counter()
        with span(name):
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
    """A ``torch.profiler`` trace of the block (the host's operators and the
    program's spans and, with a card, its kernels) written as a Chrome trace
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
