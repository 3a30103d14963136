"""The program's own spans and counts in the traced window, set against the
device's trace.

The port records them itself (``fenicssolver_tpu_torch.utils.timers``:
``records()``) while a profiler is active, on ``time.time_ns()``, the
clock of the profiler's device activities and of the benchmark's spans.
A span has an id, a parent (the span innermost when it opened) and a root
(the outermost: the request).  Here they are cut to the window, and the
window is split into pieces each under one innermost program span (or
under none), as ``Trace.idle_gaps`` splits it by the benchmark's spans.

``read(run)`` is None where there is no trace, where the program keeps no
records (a tree before the recorder) or where no program span fell in the
window; the metric readers return None then.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict

#: the name the idle split gives time under no program span
OUTSIDE = "outside program spans"


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _program_records():
    try:
        from fenicssolver_tpu_torch.utils import timers

        return timers.records()
    except (ImportError, AttributeError):
        return None


class ProgramSpans:
    def __init__(self, records, trace):
        t0, t1 = trace.t0, trace.t1
        self.trace, self.t0, self.t1 = trace, t0, t1
        self.by_id = {s.id: s for s in records.spans}
        self.spans = sorted((s for s in records.spans if t0 <= s.start_ns < t1),
                            key=lambda s: (s.start_ns, s.id))
        self.counts = [c for c in records.counts if t0 <= c.t_ns < t1]
        self.segments = self._segments()
        self.busy = trace._busy  # the device's activities, merged
        self._busy_starts = [s for s, _ in self.busy]

    def _segments(self):
        """[(start, end, span or None, after)]: the window cut where a
        program span opens or closes, each piece with the innermost span
        open over it and the name of that span's child that closed last
        before it (None for none)."""
        inside = {s.id for s in self.spans}
        children = defaultdict(list)
        roots = []
        for s in self.spans:
            (children[s.parent] if s.parent in inside else roots).append(s)
        out = []

        def walk(s):
            at, after = s.start_ns, None
            for c in children[s.id]:
                out.append((at, c.start_ns, s, after))
                walk(c)
                at, after = c.end_ns, c.name
            out.append((at, min(s.end_ns, self.t1), s, after))

        at, after = self.t0, None
        for r in roots:
            out.append((at, r.start_ns, None, after))
            walk(r)
            at, after = r.end_ns, r.name
        out.append((at, self.t1, None, after))
        return [seg for seg in out if seg[1] > seg[0]]

    def named(self, name):
        return [s for s in self.spans if s.name == name]

    def _busy_in(self, a, b):
        """ns of device activity within [a, b)."""
        i = max(bisect.bisect_right(self._busy_starts, a) - 1, 0)
        total = 0
        while i < len(self.busy) and self.busy[i][0] < b:
            s, e = self.busy[i]
            total += max(0, min(e, b) - max(s, a))
            i += 1
        return total

    def busy_share(self, name):
        """(ns of device activity inside the spans ``name``, their wall in
        ns)."""
        spans = self.named(name)
        ends = [(s.start_ns, min(s.end_ns, self.t1)) for s in spans]
        return sum(self._busy_in(a, b) for a, b in ends), sum(b - a for a, b in ends)

    def idle_by_span(self):
        """{innermost program span's name: ns of the device's idle time while
        it was the innermost open}; ``OUTSIDE`` where none was open."""
        by = defaultdict(int)
        for a, b, s, _ in self.segments:
            by[OUTSIDE if s is None else s.name] += (b - a) - self._busy_in(a, b)
        return dict(by)

    def own_ns(self, name):
        """{the child that closed last before (None: the span's start): ns
        of the window in which ``name`` was the innermost open span}."""
        by = defaultdict(int)
        for a, b, s, after in self.segments:
            if s is not None and s.name == name:
                by[after] += b - a
        return dict(by)

    def counted_under(self, count, root):
        """The sum of the counts ``count`` recorded under a span whose root
        is named ``root``."""
        total = 0
        for c in self.counts:
            s = self.by_id.get(c.span)
            if c.name == count and s is not None and self.by_id[s.root].name == root:
                total += c.n
        return total


def read(run, device=False):
    """The run's ``ProgramSpans``, or None (see the module's docstring);
    ``device``: None too where the trace holds no device activity (the
    CPU)."""
    trace = run.trace
    if trace is None or (device and not trace.device):
        return None
    cached = getattr(run, "_program_spans", None)
    if cached is None:
        records = _program_records()
        cached = ProgramSpans(records, trace) if records is not None else False
        run._program_spans = cached
    return cached if cached and cached.spans else None


def idle_split(ps, kind, prefix, per):
    """ms of device idle a ``kind`` by innermost program span, logged in
    full, and the ms a ``kind`` under the spans named ``prefix`` or
    ``prefix.*``."""
    idle = ps.idle_by_span()
    total = sum(idle.values())
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])
    log(f"program idle by innermost span, ms a {kind} over {per}: "
        + ", ".join(f"{n} {1e-6 * v / per:.4f}" for n, v in ranked)
        + f"; {100.0 * idle.get(OUTSIDE, 0) / total if total else 0.0:.2f}% of the "
        f"window's idle under no program span")
    own = sorted(ps.own_ns(prefix).items(), key=lambda kv: -kv[1])
    log(f"{prefix} own time, ms a {kind}: {1e-6 * sum(v for _, v in own) / per:.4f}, "
        "by the child it follows: "
        + ", ".join(f"{n or 'its start'} {1e-6 * v / per:.4f}" for n, v in own))
    mine = sum(v for n, v in idle.items() if n == prefix or n.startswith(prefix + "."))
    return 1e-6 * mine / per
