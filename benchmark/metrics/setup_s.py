"""Process start to the first timed request: imports, the build of the case,
kernel builds where the checkout has none yet, and the warm-up requests."""


def read(run):
    return run.setup_s
