"""A step's wall less the phases the program times (``solver.timers``: form,
refresh, assembly, GMG set-up, Krylov): the time loop's own work in
``solvers/solver_base``, in ms a step."""


def read(run):
    phases = run.counter("phases_s")
    if phases is None:
        return None
    walls = [t for t, _ in run.requests]
    return 1e3 * (sum(walls) - sum(phases)) / len(walls)
