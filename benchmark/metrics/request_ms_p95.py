"""The 95th percentile of every request's time in the window, each timed on
the host clock from its start to the device synchronise that ends it
(nearest rank)."""

import math


def read(run):
    times = sorted(t for t, _ in run.requests)
    if not times:
        return None
    return 1e3 * times[max(math.ceil(0.95 * len(times)) - 1, 0)]
