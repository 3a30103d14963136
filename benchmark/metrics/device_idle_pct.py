"""100 x (1 - the union of the device's activities / the traced window),
from the profiler's trace."""


def read(run):
    trace = run.trace
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
