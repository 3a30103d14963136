"""The device's idle time while the host's innermost program span was the
time loop's ``step`` or one of its ``step.*`` children (the phases, such as
``assembly`` and ``krylov``, are not), in ms a ``step`` span of the traced
window; the idle time's split by every program span goes to stderr."""

from harness import program_spans


def read(run):
    ps = program_spans.read(run, device=True)
    steps = ps.named("step") if ps is not None else None
    if not steps:
        return None
    return program_spans.idle_split(ps, "step", "step", len(steps))
