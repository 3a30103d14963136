"""The device's idle time while the host's innermost program span was the
GMG V-cycle's ``vcycle`` or one of its levels (``vcycle.L<i>``,
``vcycle.coarse``), in ms a ``vcycle`` span of the traced window; the
idle time's split by every program span, the levels among them, goes to
stderr."""

from harness import program_spans


def read(run):
    ps = program_spans.read(run, device=True)
    cycles = ps.named("vcycle") if ps is not None else None
    if not cycles:
        return None
    return program_spans.idle_split(ps, "V-cycle", "vcycle", len(cycles))
