"""K1's share of its roofline over its launches in the traced window
(``kernels/k1.py``'s bytes model, the device times of the trace)."""


def read(run):
    return run.roofline_pct("k1")
