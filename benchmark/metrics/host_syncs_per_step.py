"""The program's ``host_sync`` counts (each a point where the host waits
for the device: a phase edge, a norm or a Hessenberg column read, an
upload or a download of the solution) recorded under the time loop's
``step`` spans, their children included, a ``step`` span of the traced
window."""

from harness import program_spans


def read(run):
    ps = program_spans.read(run)
    steps = ps.named("step") if ps is not None else None
    if not steps:
        return None
    return ps.counted_under("host_sync", "step") / len(steps)
