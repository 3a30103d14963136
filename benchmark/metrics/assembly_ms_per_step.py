"""The program's "assembly" phase (``solver.timers``, ``ops/assembly``)
over the window's steps, in ms a step."""


def read(run):
    values = run.counter("assembly_s")
    return None if values is None else 1e3 * sum(values) / len(values)
