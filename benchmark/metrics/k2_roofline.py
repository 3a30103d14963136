"""K2's share of its roofline over its launches in the traced window
(``kernels/k2.py``'s bytes model, the device times of the trace)."""


def read(run):
    return run.roofline_pct("k2")
