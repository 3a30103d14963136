"""The unknowns of one linear solve times the solves completed in the
window (CN steps or steady solves), over the window's seconds."""


def read(run):
    if not run.requests or not run.window_s:
        return None
    return run.ndof * len(run.requests) / run.window_s
