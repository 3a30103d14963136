"""Reduction of one ``torch.profiler`` trace of the device to the numbers
the per-layer metrics read: the device's busy time in the traced window,
the device time of each kernel by name and by request, and the idle gaps
named by the benchmark's span that was open when each fell.

The profiler records the device's activities alone (no host operators, so
that tracing adds little host time).  The benchmark keeps its own spans on
the host, on ``time.time_ns()``, the clock the profiler's timestamps are
given in (nanoseconds since the epoch).  The traced window is the span
``window``; each request is a span ``request``.
"""

from __future__ import annotations

import bisect
import re
import time
from contextlib import contextmanager, nullcontext

WINDOW_SPAN = "window"
REQUEST_SPAN = "request"


class Spans:
    """The benchmark's spans on the host: (start_ns, end_ns, name), kept
    while ``active``."""

    def __init__(self):
        self.records = []
        self.active = False
        self.requests = 0  # request spans opened while active

    def span(self, name):
        if not self.active:
            return nullcontext()
        if name == REQUEST_SPAN:
            self.requests += 1
        return self._span(name)

    @contextmanager
    def _span(self, name):
        start = time.time_ns()
        try:
            yield
        finally:
            self.records.append((start, time.time_ns(), name))


def _on_device(event):
    return "cuda" in str(event.device_type()).lower()


def _is_annotation(event):
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def short_name(name, width=160):
    """A kernel's name without its argument list and anonymous namespace,
    cut to ``width``."""
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    name = name[:cut].strip()
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """The device activities and the benchmark's spans of one trace, in ns
    on the profiler's clock."""

    def __init__(self, events, spans):
        """``events``: the profiler's events; ``spans``: the benchmark's
        (start_ns, end_ns, name) on the same clock."""
        self.device = []  # (start, end, name): kernels, copies and fills
        outside = 0
        self.spans = sorted(spans)
        windows = [(s, e) for s, e, n in self.spans if n == WINDOW_SPAN]
        if len(windows) != 1:
            raise ValueError(f"expected one {WINDOW_SPAN} span, found {len(windows)}")
        self.t0, self.t1 = windows[0]
        for ev in events:
            if not _on_device(ev) or _is_annotation(ev):
                continue
            start = int(ev.start_ns())
            end = start + int(ev.duration_ns())
            if end <= self.t0 or start >= self.t1:
                outside += 1
                continue
            self.device.append((max(start, self.t0), min(end, self.t1), ev.name()))
        #: device activities that fell outside the window (the profiler
        #: starts before it and stops after it)
        self.outside = outside
        self.device.sort()
        self._starts = [s for s, _, _ in self.spans]
        self._busy = _merge((s, e) for s, e, _ in self.device)
        self.requests = [(s, e) for s, e, n in self.spans if n == REQUEST_SPAN]

    @classmethod
    def from_profiler(cls, prof, spans):
        return cls(prof.profiler.kineto_results.events(), spans)

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self):
        return sum(e - s for s, e in self._busy) * 1e-9

    def kernels_by_request(self, match):
        """[(launches, seconds)] of the matching activities that started
        inside each request span, in request order (each request ends in a
        device synchronise, so its work lies inside its span)."""
        starts = [s for s, _, _ in self.device]
        out = []
        for r0, r1 in self.requests:
            i, j = bisect.bisect_left(starts, r0), bisect.bisect_left(starts, r1)
            hits = [e - s for s, e, n in self.device[i:j] if match(n)]
            out.append((len(hits), sum(hits) * 1e-9))
        return out

    def device_ops(self, top=10):
        by = {}
        for s, e, n in self.device:
            key = short_name(n)
            by[key] = by.get(key, 0) + (e - s)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns * 1e-9] for name, ns in ranked]

    def _innermost(self, t):
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0:
            s, e, n = self.spans[i]
            if s <= t < e:
                return n
            i -= 1
        return "outside spans"

    def idle_gaps(self, top=10):
        """The device's idle time in the window, summed by the innermost
        benchmark span open while it lasted (a gap that outlasts a span is
        split at the span's ends), largest first."""
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        cuts = sorted({t for s, e, _ in self.spans for t in (s, e)})
        by = {}
        for k in range(0, len(edges), 2):
            g0, g1 = edges[k], edges[k + 1]
            if g1 <= g0:
                continue
            i, j = bisect.bisect_right(cuts, g0), bisect.bisect_left(cuts, g1)
            points = [g0, *cuts[i:j], g1]
            for a, b in zip(points, points[1:]):
                name = self._innermost((a + b) / 2)
                by[name] = by.get(name, 0) + (b - a)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns * 1e-9] for name, ns in ranked]


def template_matcher(kernel, args):
    """A matcher for the kernel ``kernel<args...>`` by its demangled name,
    each entry of ``args`` a regular expression for one template argument,
    or by its Itanium-mangled name (``_Z<len><kernel>I...E``)."""
    demangled = re.compile(
        re.escape(kernel) + r"<\s*" + r"\s*,\s*".join(args) + r"\s*>")
    mangled_args = {"float": "f", "double": "d", "true": "Lb1E", "false": "Lb0E"}

    def mangle(arg):
        options = [mangled_args[a] for a in re.findall(r"[a-z]+", arg)
                   if a in mangled_args]
        return "(?:" + "|".join(options) + ")" if options else ".*?"

    mangled = re.compile(
        rf"_Z\d+{re.escape(kernel)}I" + "".join(mangle(a) for a in args) + "E")

    def match(name):
        return bool(demangled.search(name) or mangled.search(name))

    return match
